"""Static schedule generation from dependency-counted task graphs.

This is the TPU-native adaptation of the paper's runtime (DESIGN.md §2): XLA
programs are statically scheduled, so the paper's *dynamic* execution policy
— dependency counting, continuation passing (run one newly-ready successor
inline), LIFO own-queue / FIFO steal — is executed here as a **deterministic
discrete-event simulation** at trace time. The simulator's per-worker
timelines become static schedules that `repro_torch.parallel.pipeline` lowers to
``shard_map`` + ``ppermute`` steppers.

Applied to the (microbatch × stage) grid of pipeline parallelism, with
activation-buffer capacity expressed as *anti-dependency edges* (stage ``s``
may hold at most ``S - s`` in-flight activations, encoded as
``B(m, s) → F(m + S - s, s)``), the paper's B-before-F continuation priority
makes list scheduling reproduce the classic 1F1B schedule — the memory bound
becomes just more dependency edges for the paper's counter machinery.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Optional, Sequence

__all__ = [
    "SimTask",
    "SimResult",
    "simulate",
    "PipelineOp",
    "pipeline_task_graph",
    "pipeline_schedule",
    "gpipe_schedule",
    "schedule_to_table",
    "peak_activation_buffers",
]


@dataclass
class SimTask:
    """A node in the simulated graph.

    ``worker``: pin to a worker index (a pipeline stage / device), or None
    for stealable CPU-style tasks. ``priority``: larger runs first among
    ready tasks (the paper's successor order generalized to a key).
    """

    name: str
    cost: float = 1.0
    worker: Optional[int] = None
    priority: float = 0.0
    successors: list[int] = field(default_factory=list)
    num_predecessors: int = 0
    payload: object = None


@dataclass
class SimResult:
    timelines: list[list[tuple[int, float, float]]]  # per worker: (task, start, end)
    makespan: float
    start: dict[int, float]
    end: dict[int, float]


def _ready_push(
    queues: list[list[tuple[float, int, int]]],
    tasks: Sequence[SimTask],
    tid: int,
    home: int,
    seq: int,
) -> None:
    w = tasks[tid].worker
    target = w if w is not None else home
    # max-heap on (priority, recency): continuation passing is LIFO-biased,
    # so among equal priorities the most recently readied task runs first.
    heapq.heappush(queues[target], (-tasks[tid].priority, -seq, tid))


def simulate(
    tasks: Sequence[SimTask],
    num_workers: int,
    *,
    allow_steal: bool = True,
) -> SimResult:
    """Deterministic discrete-event simulation of the pool's policy.

    Each worker owns a priority-LIFO queue (models the paper's own-deque pop
    plus the inline-continuation rule, which together execute the newest
    ready successor first). Pinned tasks only ever enter their own worker's
    queue and are never stolen; unpinned tasks are stolen FIFO-by-readiness
    from the most loaded victim when a worker idles, like the top end of a
    Chase-Lev deque.
    """
    pending = [t.num_predecessors for t in tasks]
    queues: list[list[tuple[float, int, int]]] = [[] for _ in range(num_workers)]
    seq = 0
    for tid, t in enumerate(tasks):
        if pending[tid] == 0:
            _ready_push(queues, tasks, tid, tid % num_workers, seq)
            seq += 1

    timelines: list[list[tuple[int, float, float]]] = [[] for _ in range(num_workers)]
    start: dict[int, float] = {}
    end: dict[int, float] = {}
    busy = [False] * num_workers
    # completion-event heap: (time, order, task, worker). Successor counters
    # are decremented when the *completion event fires*, never earlier — the
    # exact analogue of the pool's end-of-body fan-out (paper §2.2).
    events: list[tuple[float, int, int, int]] = []
    counter = 0
    n_done = 0

    def _steal(w: int) -> Optional[int]:
        if not allow_steal:
            return None
        victims = sorted(range(num_workers), key=lambda v: -len(queues[v]))
        for v in victims:
            if v == w or not queues[v]:
                continue
            # steal the *oldest* ready unpinned task (FIFO end of the deque)
            cand = None
            for item in queues[v]:
                tid = item[2]
                if tasks[tid].worker is None:
                    if cand is None or item[1] > cand[1]:  # -seq larger == older
                        cand = item
            if cand is not None:
                queues[v].remove(cand)
                heapq.heapify(queues[v])
                return cand[2]
        return None

    def _dispatch(w: int, now: float) -> None:
        nonlocal counter
        if busy[w]:
            return
        tid = heapq.heappop(queues[w])[2] if queues[w] else _steal(w)
        if tid is None:
            return  # parks; re-dispatched at the next completion (notify)
        busy[w] = True
        t = tasks[tid]
        timelines[w].append((tid, now, now + t.cost))
        start[tid], end[tid] = now, now + t.cost
        heapq.heappush(events, (now + t.cost, counter, tid, w))
        counter += 1

    for w in range(num_workers):
        _dispatch(w, 0.0)

    total = len(tasks)
    while events:
        now, _, tid, w = heapq.heappop(events)
        busy[w] = False
        n_done += 1
        for succ in tasks[tid].successors:
            pending[succ] -= 1
            if pending[succ] == 0:
                _ready_push(queues, tasks, succ, w, seq)
                seq += 1
        # The finishing worker dispatches first: with priority-LIFO queues the
        # newest-readied successor runs inline on it (continuation passing).
        _dispatch(w, now)
        for v in range(num_workers):
            if v != w:
                _dispatch(v, now)

    if n_done < total:
        raise RuntimeError(
            "deadlock in schedule simulation: "
            f"{total - n_done} task(s) never became runnable"
        )
    return SimResult(
        timelines=timelines,
        makespan=max(end.values(), default=0.0),
        start=start,
        end=end,
    )


# ---------------------------------------------------------------------------
# Pipeline-parallel schedules from the task-graph machinery
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PipelineOp:
    kind: str  # 'F' or 'B'
    microbatch: int
    stage: int


def pipeline_task_graph(
    num_stages: int,
    num_microbatches: int,
    *,
    memory_limited: bool = True,
) -> list[SimTask]:
    """Build the (microbatch × stage) forward/backward dependency graph.

    Edges:
      F(m, s-1) → F(m, s)            activations flow down the pipe
      F(m, S-1) → B(m, S-1)          loss turns the microbatch around
      B(m, s+1) → B(m, s)            gradients flow back up
      B(m, s)   → F(m + S - s, s)    [memory_limited] stage s buffers at most
                                     S - s activations (anti-dependency) —
                                     with B-priority this yields 1F1B.
    Backward tasks get higher priority: the paper's continuation rule picks
    them as the inline successor, draining activations eagerly.
    """
    S, M = num_stages, num_microbatches
    tasks: list[SimTask] = []
    fid: dict[tuple[int, int], int] = {}
    bid: dict[tuple[int, int], int] = {}
    # Priorities: every backward beats every forward (the paper's
    # continuation rule drains completed microbatches first), and earlier
    # microbatches beat later ones within a kind (canonical pipeline order).
    for m in range(M):
        for s in range(S):
            fid[(m, s)] = len(tasks)
            tasks.append(
                SimTask(
                    name=f"F{m}.{s}",
                    worker=s,
                    priority=-float(m),
                    payload=PipelineOp("F", m, s),
                )
            )
    for m in range(M):
        for s in range(S):
            bid[(m, s)] = len(tasks)
            tasks.append(
                SimTask(
                    name=f"B{m}.{s}",
                    worker=s,
                    priority=1e6 - float(m),
                    payload=PipelineOp("B", m, s),
                )
            )

    def edge(a: int, b: int) -> None:
        tasks[a].successors.append(b)
        tasks[b].num_predecessors += 1

    for m in range(M):
        for s in range(S):
            if s > 0:
                edge(fid[(m, s - 1)], fid[(m, s)])
            if s < S - 1:
                edge(bid[(m, s + 1)], bid[(m, s)])
        edge(fid[(m, S - 1)], bid[(m, S - 1)])
    if memory_limited:
        for s in range(S):
            cap = S - s
            for m in range(M):
                if m + cap < M:
                    edge(bid[(m, s)], fid[(m + cap, s)])
    return tasks


def pipeline_schedule(num_stages: int, num_microbatches: int) -> SimResult:
    """1F1B-family schedule derived by simulating the paper's policy."""
    tasks = pipeline_task_graph(num_stages, num_microbatches, memory_limited=True)
    return simulate(tasks, num_stages, allow_steal=False)


def gpipe_schedule(num_stages: int, num_microbatches: int) -> SimResult:
    """GPipe (all-forward-then-all-backward): no anti-dependency edges and
    forward-priority — the memory-hungry baseline the paper's policy beats."""
    tasks = pipeline_task_graph(num_stages, num_microbatches, memory_limited=False)
    for t in tasks:
        m = t.payload.microbatch
        t.priority = (1e6 - m) if t.payload.kind == "F" else -float(m)
    return simulate(tasks, num_stages, allow_steal=False)


def schedule_to_table(
    tasks: Sequence[SimTask], result: SimResult, num_stages: int
) -> list[list[Optional[PipelineOp]]]:
    """Flatten a pipeline SimResult into a dense tick table.

    ``table[tick][stage]`` is the PipelineOp that stage executes at that tick
    (or None = bubble). Unit costs ⇒ integer ticks. This is what the
    shard_map executor consumes: every tick is one fwd or bwd step plus a
    ``ppermute`` halo exchange at the boundary.
    """
    ticks = int(round(result.makespan))
    table: list[list[Optional[PipelineOp]]] = [[None] * num_stages for _ in range(ticks)]
    for w, tl in enumerate(result.timelines):
        for tid, s0, _s1 in tl:
            op = tasks[tid].payload
            if isinstance(op, PipelineOp):
                table[int(round(s0))][w] = op
    return table


def peak_activation_buffers(
    tasks: Sequence[SimTask], result: SimResult, num_stages: int
) -> list[int]:
    """Max simultaneously-buffered forward activations per stage.

    An activation for microbatch m lives at stage s from end(F(m,s)) until
    end(B(m,s)). 1F1B caps this at S - s; GPipe reaches M.
    """
    peaks = [0] * num_stages
    f_end: dict[tuple[int, int], float] = {}
    b_end: dict[tuple[int, int], float] = {}
    for tid, t in enumerate(tasks):
        op = t.payload
        if isinstance(op, PipelineOp):
            (f_end if op.kind == "F" else b_end)[(op.microbatch, op.stage)] = result.end[tid]
    for s in range(num_stages):
        times = sorted(
            [(f_end[k], +1) for k in f_end if k[1] == s]
            + [(b_end[k], -1) for k in b_end if k[1] == s]
        )
        cur = 0
        for _t, d in times:
            cur += d
            peaks[s] = max(peaks[s], cur)
    return peaks
