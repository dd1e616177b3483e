"""The single-device train step as one graph (``repro_torch.runtime.graph``)
on the CPU, where nothing is captured: ``Trainer.run`` goes through the
graph's path (one eager warm-up step, then the "capture" and replays of the
same body through the same static buffers), one reduced model a family in
float32. Held here: N steps of ``Trainer.run`` against N eager
``train_step``s bit for bit (metrics, every param, master and moment, the
counter); three steps against the reference's ``Trainer`` and its jitted
step (``jax.jit(step_fn)``) at ``tests/test_torch_train.py``'s tolerance; a
``fail_at_step`` restart against an uninterrupted run bit for bit; a moved
param, master, moment, counter or static input raising before a replay; the
static inputs' checks; and the launch tally of a capture stream, which
counts the launches of every thread (autograd's backward runs on its own).
The capture itself runs on the card only (``tests/test_torch_gpu.py``,
``chip_smoke.py``)."""
import dataclasses
import importlib.util
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.optim import adamw_init as jax_adamw_init
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticTokens, to_device
from repro_torch.kernels import build
from repro_torch.models.lm import encoder_plan, stack_plan
from repro_torch.optim import adamw_init
from repro_torch.runtime import GraphError, TrainGraph, Trainer, TrainerConfig
from repro_torch.runtime import graph as graph_mod
from repro_torch.tree import tree_leaves, tree_map

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# tests/test_torch_train.py::test_train_steps_match_reference's tolerance
TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = {
    "dense": "tinyllama-1.1b", "ssm": "mamba2-1.3b", "hybrid": "hymba-1.5b",
    "moe": "granite-moe-1b-a400m", "mla": "deepseek-v2-236b", "encdec": "whisper-medium",
    "vlm": "paligemma-3b",
}
S, B = 16, 2  # positions (text tokens for the enc-dec and VLM models) and rows a batch


def _cfg(family):
    return get_reduced(FAMILIES[family]).replace(dtype="float32")


def _source(cfg, seed=0):
    """The train cells' data source: frames or patches beside the tokens
    for the enc-dec and VLM families (``chip_smoke.EncDecVLMTokens``)."""
    if cfg.is_encdec or cfg.family == "vlm":
        return chip_smoke.EncDecVLMTokens(cfg, S, B, seed=seed)
    return SyntheticTokens(cfg.vocab_size, S, B, seed=seed)


def _trainer(cfg, path, **kw):
    base = dict(num_steps=4, checkpoint_every=100, log_every=1, seq_len=S, global_batch=B,
                lr=1e-3, warmup=1, seed=0)
    base.update(kw)
    return Trainer(cfg, TrainerConfig(**base), str(path), device="cpu",
                   data_source=_source(cfg, base["seed"]))


def _state_leaves(params, opt):
    return tree_leaves({"params": params.tree(), "opt": opt})


def _metrics(rows):
    return [{k: v for k, v in r.items() if k not in ("step", "step_s")} for r in rows]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_through_the_graph_equals_eager_steps_bit_for_bit(family, tmp_path):
    """Four steps of ``Trainer.run`` (the warm-up, the captured step, two
    replays) against four eager ``train_step``s of a fresh state on the
    same batches."""
    cfg = _cfg(family)
    with _trainer(cfg, tmp_path) as tr:
        out = tr.run(resume=False)
        stats = tr.graph.stats()
        assert set(tr.graph.inputs) == set(tr.data.batch(0))
        state = tr.init_state()
        rows = []
        for step in range(4):
            met = tr.train_step(state, to_device(tr.data.batch(step), tr.device), step)
            rows.append({k: float(v) for k, v in met.items()})
    assert stats["eager_steps"] == TrainGraph.WARMUP == 1 and stats["replays"] == 3
    assert stats["captured_launches"] == {} and stats["pool_reserved_bytes"] is None
    assert _metrics(out["metrics"]) == rows
    graph, eager = _state_leaves(out["params"], out["opt"]), _state_leaves(
        state["params"], state["opt"])
    assert len(graph) == len(eager) > 10
    for a, b in zip(graph, eager):
        assert torch.equal(a, b)
    assert int(out["opt"]["count"]) == 4


def _stacked(cfg, tree):
    """The port's per-layer lists stacked back into the reference's layout."""
    out = dict(tree)
    for key, plan in (("layers", stack_plan(cfg)), ("enc_layers", encoder_plan(cfg))):
        if plan is None:
            continue
        out[key] = dict(tree[key])
        for grp in plan:
            if grp.kind == "scan":
                out[key][grp.name] = tree_map(lambda *xs: np.stack(xs), *tree[key][grp.name])
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_matches_the_reference_trainers_jitted_steps(family, tmp_path):
    """Three steps of ``Trainer.run`` from the reference's initial params
    against three steps of the reference ``Trainer``'s ``jax.jit(step_fn)``
    on the same batches and schedule: the losses, grad norms, and every
    param, moment and master within 1e-4."""
    cfg = _cfg(family)
    jcfg = jax_get_reduced(FAMILIES[family]).replace(dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    kw = dict(num_steps=3, checkpoint_every=100, log_every=1, seq_len=S, global_batch=B,
              lr=1e-3, warmup=1, seed=0)
    with JaxTrainer(jcfg, JaxTrainerConfig(**kw), str(tmp_path / "jax"),
                    data_source=_source(cfg)) as jtr:
        jp = jtr.init_state()["params"]
        jopt = jax_adamw_init(jtr.ocfg, jp)
        step_fn = jtr._build_step()
        jrows = []
        for step in range(3):
            batch = {k: jnp.asarray(v) for k, v in jtr.data.batch(step).items()}
            jp_next, jopt, met = step_fn(jp if step == 0 else jp_next, jopt, batch,
                                         jnp.asarray(step))
            jrows.append({k: float(v) for k, v in met.items()})
    init = jax.tree.map(np.asarray, jtr.init_state()["params"])

    class FromReference(Trainer):
        def init_state(self):
            params = params_from_jax(self.model_cfg, init, device="cpu")
            return {"params": params, "opt": adamw_init(self.ocfg, params.tree()), "step": 0}

    with FromReference(cfg, TrainerConfig(**kw), str(tmp_path / "port"), device="cpu",
                       data_source=_source(cfg)) as tr:
        out = tr.run(resume=False)
        assert tr.graph.stats()["replays"] == 2
    for row, jrow in zip(out["metrics"], jrows):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(row[key], jrow[key], **TOL, err_msg=key)
    port = tree_map(lambda t: t.detach().numpy(), {"params": out["params"].tree(), **out["opt"]})
    ref = jax.tree.map(np.asarray, {"params": jp_next, "m": jopt["m"], "v": jopt["v"],
                                    "master": jopt["master"]})
    for part in ("params", "m", "v", "master"):
        leaves = jax.tree_util.tree_flatten_with_path(ref[part])[0]
        assert leaves
        mine = _stacked(cfg, port[part])
        for path, want in leaves:
            node = mine
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(np.asarray(node), want, **TOL,
                                       err_msg=f"{part} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fail_at_step_restart_equals_an_uninterrupted_run(family, tmp_path):
    """A run crashed at step 3 restarts from the step-2 checkpoint with a
    graph of its own (its own warm-up and capture, the first run's graph
    released): its final params and AdamW state equal an uninterrupted
    run's bit for bit."""
    cfg = _cfg(family)
    kw = dict(num_steps=6, checkpoint_every=2)
    with _trainer(cfg, tmp_path / "a", **kw) as tr:
        ref = tr.run(resume=False)
    with _trainer(cfg, tmp_path / "b", fail_at_step=3, **kw) as tr:
        out = tr.run_with_restarts(max_restarts=1)
        stats = tr.graph.stats()
    assert stats["eager_steps"] == 1 and stats["replays"] == 6 - 2 - 1
    for a, b in zip(_state_leaves(ref["params"], ref["opt"]),
                    _state_leaves(out["params"], out["opt"])):
        assert torch.equal(a, b)


def _tiny():
    return get_reduced("tinyllama-1.1b").replace(dtype="float32", num_layers=2)


def _move(state, graph, part):
    """Rebind one tensor the graph holds to a copy at another address."""
    if part == "params":
        leaf = tree_leaves(state["params"].tree())[0]
        leaf.data = leaf.data.clone()
    elif part == "count":
        state["opt"]["count"] = state["opt"]["count"].clone()
    elif part == "input":
        graph.inputs["targets"] = graph.inputs["targets"].clone()
    else:  # a master or a moment, rebound in its tree as a restore would
        tree = state["opt"][part]
        key = next(iter(tree))
        tree[key] = tree_map(torch.clone, tree[key])


@pytest.mark.parametrize("part", ["params", "master", "m", "v", "count", "input"])
def test_a_moved_address_raises_before_the_replay(part, tmp_path):
    cfg = _tiny()
    with _trainer(cfg, tmp_path) as tr:
        state = tr.init_state()
        graph = tr.step_graph(state)
        batches = [to_device(tr.data.batch(step), tr.device) for step in range(3)]
        graph(batches[0], 0)  # the warm-up
        graph(batches[1], 1)  # the capture, and its replay
        _move(state, graph, part)
        with pytest.raises(GraphError, match="moved since the capture"):
            graph(batches[2], 2)
        assert graph.stats()["replays"] == 1


def test_a_failed_capture_escapes_the_restart_loop(monkeypatch, tmp_path):
    """A capture that fails raises :class:`GraphError` from the run, and
    ``run_with_restarts`` lets it through at once: no restart from the
    checkpoint and no further eager step, as it would for a preemption."""

    class FailingGraph:
        def __init__(self, *a, **kw):
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graph_mod, "Graph", FailingGraph)
    with _trainer(_tiny(), tmp_path, checkpoint_every=1) as tr:
        with pytest.raises(GraphError, match="capture failed"):
            tr.run_with_restarts(max_restarts=3)
        assert tr.graph.eager_steps == 1 and len(tr.metrics_log) == 1


def test_static_inputs_and_outputs_stay_put(tmp_path):
    """The batch and lr are copied into static inputs made from the first
    batch, whose addresses hold from step to step; a batch of another
    shape or key raises; once captured, every step returns the same static
    outputs, overwritten in place."""
    cfg = _tiny()
    with _trainer(cfg, tmp_path) as tr:
        state = tr.init_state()
        graph = tr.step_graph(state)
        batch = to_device(tr.data.batch(0), tr.device)
        graph(batch, 0)
        where = {k: v.data_ptr() for k, v in graph.inputs.items()}
        first = graph(to_device(tr.data.batch(1), tr.device), 1)
        loss = float(first["loss"])
        again = graph(to_device(tr.data.batch(2), tr.device), 2)
        assert again is first and float(first["loss"]) != loss
        assert float(first["lr"]) == float(tr.lr_fn(2))
        assert {k: v.data_ptr() for k, v in graph.inputs.items()} == where
        torch.testing.assert_close(graph.inputs["tokens"], batch["tokens"].new_tensor(
            tr.data.batch(2)["tokens"]), rtol=0, atol=0)
        with pytest.raises(ValueError, match="static inputs"):
            graph({k: v[:1] for k, v in batch.items()}, 3)
        with pytest.raises(ValueError, match="static inputs"):
            graph({**batch, "loss_mask": torch.ones(batch["tokens"].shape)}, 3)
        # a new graph releases the last one
        assert tr.step_graph(state) is tr.graph is not graph and graph.state is None


def test_capture_stream_tally_counts_every_threads_launches(monkeypatch):
    """While a stream captures, ``launch_tally(stream)`` counts the launches
    recorded into it by any thread (a captured backward launches from
    autograd's thread), and the wrappers' counts stay for launches that
    run."""

    class Stream:
        cuda_stream = 1234

    def wrapper():
        pass

    wrapper.launches = 0
    capturing = {"on": True}
    monkeypatch.setattr(build, "capturing", lambda: capturing["on"])
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    with build.launch_tally(Stream()) as tally:
        build.count_launch(wrapper, "k")
        other = threading.Thread(target=build.count_launch, args=(wrapper, "k_bwd"))
        other.start()
        other.join(10)
        assert not other.is_alive()
        capturing["on"] = False
        build.count_launch(wrapper, "k")  # runs now: not captured
    assert tally == {"k": 1, "k_bwd": 1}
    assert wrapper.launches == 1
    capturing["on"] = True
    build.count_launch(wrapper, "k")  # no tally open for the stream
    assert tally == {"k": 1, "k_bwd": 1} and build._stream_tallies == {}
