"""Worker-process entry point for the process backend (DESIGN.md §11).

Each worker is a plain loop over one duplex pipe to its dispatcher thread
in the parent — the scheduler never crosses the boundary, only task
*bodies* do. Job protocol (one in-flight job per worker, by construction —
the dispatcher thread blocks on the reply):

    parent -> worker   (job_id, fn_wire, args_wire)      run this body
    parent -> worker   None                              shut down
    worker -> parent   (job_id, True,  result_wire)      body returned
    worker -> parent   (job_id, False, exception_bytes)  body raised

``fn_wire``/``args_wire``/``result_wire`` are ``repro_torch.dist.wire`` payloads;
arrays at/above the arena threshold ride shared memory (arguments via the
parent's pooled segments, results via per-send ephemeral segments — see
``shm_arena.py`` for the lifetime rules).

A worker catches *everything* a body raises — including ``SystemExit`` /
``KeyboardInterrupt`` — and reports it as a task failure; only pipe loss
(parent gone) or the shutdown sentinel ends the loop. A worker that dies
anyway (``os._exit``, OOM kill, segfault) surfaces in the parent as
``WorkerDiedError`` on the in-flight task, never as a hang.
"""
from __future__ import annotations

from typing import Any

from .shm_arena import ShmArena
from .wire import (
    dumps_exception,
    dumps_value,
    loads_args,
    loads_fn,
    shm_refs,
)

__all__ = ["worker_main"]


def worker_main(conn: Any, threshold: int) -> None:
    """Run jobs from ``conn`` until the shutdown sentinel or pipe loss.

    ``threshold`` is the arena cut-over (bytes): result arrays at or above
    it ship through ephemeral shared-memory segments.
    """
    arena = ShmArena(threshold, attach_only=True)
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):  # parent died or closed the pipe
                return
            if msg is None:  # orderly shutdown
                return
            job_id, fn_wire, args_wire = msg
            try:
                fn = loads_fn(fn_wire, arena)
                args = loads_args(args_wire, arena)
                result = fn(*args)
                reply = (job_id, True, dumps_value(result, arena))
            except BaseException as exc:  # noqa: BLE001 - body verdicts travel home
                reply = (job_id, False, dumps_exception(exc))
            try:
                conn.send(reply)
            except (BrokenPipeError, OSError):
                # parent went away mid-reply: an undelivered result's
                # ephemeral segments would outlive both processes —
                # unlink them before exiting
                if reply[1]:
                    for ref in shm_refs(reply[2]):
                        arena.recycle(ref)
                return
    finally:
        arena.close()
        try:
            conn.close()
        except Exception:
            pass
