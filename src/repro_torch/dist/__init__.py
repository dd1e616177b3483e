"""repro_torch.dist — multi-process and multi-host execution backends
(DESIGN.md §11, §16).

The paper's scheduler stays in one address space; this package lets task
*bodies* escape the GIL into worker processes — on this host or across a
fleet — while the parent keeps every scheduling decision:

* :class:`ProcessPool` — a :class:`~repro_torch.core.ThreadPool` whose
  dispatcher threads proxy wired bodies to paired worker processes over
  pipes (``Executor(backend="process")`` is the usual front door);
* :class:`SocketPool` — the same scheduler-in-parent shape over TCP:
  workers connect (locally forked, or from other hosts via ``python -m
  repro_torch.dist.remote_worker --connect host:port``) and bodies ship as
  length-prefixed frames (``Executor(backend="socket")``);
* :class:`ShmArena` / :class:`ArrayRef` — the shared-memory data plane
  for large numpy/jax edge values on the single-host backend;
* :class:`TransferCache` / :class:`CacheRef` — its cross-host
  counterpart: per-connection content-hashed array transfer (bytes cross
  a connection once, repeats ship as digests);
* :func:`spawn_workers` — fork-and-connect local socket workers (needs
  the pool's :attr:`~SocketPool.authkey`: every connection passes a
  mutual HMAC challenge before anything is unpickled);
  :class:`AuthenticationError` — a peer that failed that challenge;
* :class:`UnpicklableTaskError` — submit-time verdict for a body that
  cannot ship; :func:`picklability_error` — the same verdict as a
  non-raising probe (the ``repro_torch.analysis`` linter's static check);
  :class:`WorkerDiedError` — a worker death surfaced as a task failure
  (never a hang), on either backend.
"""
from .process_pool import ProcessPool, WorkerDiedError
from .remote_worker import AuthenticationError, spawn_workers
from .shm_arena import (
    DEFAULT_THRESHOLD,
    ArrayRef,
    CacheRef,
    ShmArena,
    TransferCache,
)
from .socket_pool import SocketPool
from .wire import UnpicklableTaskError, picklability_error

__all__ = [
    "ProcessPool",
    "SocketPool",
    "WorkerDiedError",
    "ShmArena",
    "ArrayRef",
    "TransferCache",
    "CacheRef",
    "DEFAULT_THRESHOLD",
    "spawn_workers",
    "AuthenticationError",
    "UnpicklableTaskError",
    "picklability_error",
]
