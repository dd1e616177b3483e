"""Token sources: deterministic synthetic streams + memmapped corpora.

Both expose the same protocol:
  batch(step) -> dict of np arrays     (pure function of the step index)
so the pipeline is resumable from a bare step counter (checkpointable
cursor) and every host can slice out its own shard deterministically —
the multi-host story needs no coordination traffic at all.
"""
from __future__ import annotations

import pathlib

import numpy as np


class SyntheticTokens:
    """Deterministic pseudo-corpus with a learnable n-gram-ish structure.

    Markov-style sequences (next token = affine function of previous plus
    noise) so small models show decreasing loss — pure-uniform tokens have
    no learnable signal and make smoke training vacuous.
    """

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        *,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
    ) -> None:
        assert global_batch % num_hosts == 0
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, self.host_id, step))
        B, S, V = self.local_batch, self.seq_len, self.vocab_size
        x = np.empty((B, S + 1), np.uint64)
        x[:, 0] = rng.integers(0, V, B).astype(np.uint64)
        mult = np.uint64(6364136223846793005)
        inc = np.uint64(1442695040888963407)
        noise = rng.integers(0, 7, (B, S)).astype(np.uint64)
        with np.errstate(over="ignore"):  # uint64 wraparound is the point
            for t in range(S):
                x[:, t + 1] = (x[:, t] * mult + inc + noise[:, t]) % np.uint64(V)
        x = x.astype(np.int32)
        return {"tokens": x[:, :-1], "targets": x[:, 1:]}


class MemmapTokens:
    """File-backed token stream (one flat int32 file), deterministic slices."""

    def __init__(
        self,
        path: str | pathlib.Path,
        seq_len: int,
        global_batch: int,
        *,
        host_id: int = 0,
        num_hosts: int = 1,
    ) -> None:
        assert global_batch % num_hosts == 0
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.local_batch = global_batch // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.global_batch = global_batch
        n_windows = (len(self.data) - 1) // seq_len
        assert n_windows >= global_batch, "corpus too small for one batch"
        self.n_windows = n_windows

    def batch(self, step: int) -> dict:
        B, S = self.local_batch, self.seq_len
        base = (step * self.global_batch + self.host_id * B) % self.n_windows
        idx = (base + np.arange(B)) % self.n_windows
        tok = np.stack([self.data[i * S : i * S + S + 1] for i in idx])
        return {"tokens": tok[:, :-1].astype(np.int32), "targets": tok[:, 1:].astype(np.int32)}


def write_token_file(path: str | pathlib.Path, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.int32).tofile(path)
