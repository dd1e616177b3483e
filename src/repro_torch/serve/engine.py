"""Continuous-batching inference engine on the work-stealing pool, ported
from the reference's ``repro/serve/engine.py`` onto ``repro_torch.core``.

The reference touches JAX in three places: the jits built in ``__init__``,
the prefill task body and the decode tick. Here the jits are CUDA graphs
(``serve/graphs.py``): the decode tick and one prefill per prompt bucket,
captured in ``__init__``, and one prefill per exact prompt length (no
buckets, or a resume after preemption), captured on the length's second
prefill, as the reference compiles one program per length on its first
use (the first runs eagerly). All run on the model's device under
``torch.inference_mode`` entered inside each task body (it is thread-local,
and the bodies run on pool worker threads). The rest — admission heap,
deadline bands, preemption, breaker, streaming and ``submit_async`` — is
the reference's code unchanged.

The serving path is expressed as prioritized tasks on the paper's thread
pool (DESIGN.md §7):

* **prefill** tasks run at LOW priority — they are pure (compute a batch-1
  cache + first token, touch no shared buffers) and arbitrarily parallel, so
  they soak up idle workers without ever delaying a decode step;
* **decode ticks** run at HIGH priority — the same B-before-F idea that
  makes the schedule simulator reproduce 1F1B: drain work that frees
  resources (finishing sequences release cache pages) before admitting more.

Under load the gap between those two bands is graded (DESIGN.md §13):
requests carry an optional **deadline**, and waiting prefills are promoted
through the §9 priority bands as their headroom shrinks —
``PREFILL_PRIORITY`` (fresh) < ``PREFILL_SOON`` (half the budget gone) <
``PREFILL_URGENT`` (three quarters gone) — so a near-deadline prefill
outranks fresh arrivals without ever outranking the decode tick. The admit
queue is a deadline-ordered heap bounded by ``max_waiting``
(:class:`QueueFull` backpressure instead of unbounded growth), and a
request whose deadline lapses before its prefill starts fails fast with
:class:`DeadlineExceeded` rather than occupying a slot it can no longer
use.

The engine batches at *iteration level*: between two decode ticks it joins
freshly prefilled sequences into free cache slots and retires finished ones,
so the padded decode batch tracks live traffic instead of a static batch
running to the longest member. One tick is one ``model.decode_step`` over
the slot axis with a per-slot write index — sequences of different lengths
share one decode computation.

KV storage defaults to the **paged** layout (:class:`~repro_torch.serve.kv.
PagedKVCache`): each tick gathers the resident sequences' pages into the
logical slot batch, decodes, and scatters back only the single page each
lane wrote. Admission holds pages for the prefilled prompt only; decode
growth claims pages one at a time, and on page pressure the engine
**preempts the youngest resident** — its pages are freed and the request
re-enters the admit queue (at its original deadline/arrival key) to resume
later by re-prefilling its prompt + generated prefix. Preemption moves
work, it never drops it. ``kv_layout="flat"`` keeps the original
whole-slot :class:`~repro_torch.serve.kv.SlotKVCache` for comparison.

Tokens are **streamed**: every decode tick pushes each lane's new token to
its :class:`RequestHandle`, which exposes a blocking iterator
(``for tok in handle``) and an ``async for`` surface over the §10 asyncio
bridge, plus per-request latency marks (``submit_t``, ``first_token_t``,
``token_times`` — TTFT and inter-token gaps fall out).

Ticks form a **condition-cycle graph** (DESIGN.md §10) submitted through
the :class:`~repro_torch.core.Executor` facade:

    entry -> decode-tick -> more? (condition)
                 ^______________|   (weak back-edge while work remains)

The loop serializes all mutation of the shared KV pools exactly as the
old self-rescheduling chain did, but the steady-state hop from tick to
tick is a weak-edge trigger inside a worker — no per-tick task allocation,
no external submission, no inbox lock. The graph is (re)started only when
work arrives on an idle engine, handed off through the run future's done
callback so a restart can never overlap a draining run. Admission and
queue bookkeeping stay lock-protected and may run from any thread.

Because the tick graph never changes shape, every restart after the first
dispatches from its captured :class:`~repro_torch.core.ReplayPlan` (DESIGN.md
§12): the ``[decode-tick, more?]`` pair runs as one fused segment whose
weak back-edge loops without re-walking the live graph, and re-starting a
drained run costs a plan re-arm instead of a full reset + re-wire.
``stats()["tick_replays"]`` counts how many restarts took the replay path.

``submit_async`` rides the same facade's asyncio bridge: an async server
can ``tokens = await engine.submit_async(prompt, n)`` without blocking its
event loop, or stream with ``async for tok in engine.submit(...)``.
"""
from __future__ import annotations

import heapq
import itertools
import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch

from ..core import (
    ChromeTraceObserver,
    Executor,
    Future,
    RetryPolicy,
    Task,
    TaskGraph,
    ThreadPool,
)

from ..models.common import resolve_device
from .graphs import DecodeGraph, ExactPrefillGraphs, PrefillGraphs
from .kv import PagedKVCache, SlotKVCache

__all__ = [
    "ServeEngine",
    "GenRequest",
    "RequestHandle",
    "QueueFull",
    "DeadlineExceeded",
    "PREFILL_PRIORITY",
    "PREFILL_SOON",
    "PREFILL_URGENT",
    "DECODE_PRIORITY",
]

# §9 priority bands for the serve path: decode always outranks admission
# work; within admission, deadline headroom grades the prefill band.
PREFILL_PRIORITY = -1.0  # fresh prefill / no deadline
PREFILL_SOON = -0.5  # more than half the deadline budget consumed
PREFILL_URGENT = 0.0  # more than three quarters consumed, or a resume
DECODE_PRIORITY = 1.0


class QueueFull(RuntimeError):
    """Backpressure: the bounded admit queue is at ``max_waiting``."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline lapsed before its prefill started."""


class _PrefillRetry(RetryPolicy):
    """§14 policy for prefill tasks: transient failures retry (the compute
    is pure — params + prompt in, logits out — so a retried prefill is
    bit-identical), but a lapsed TTFT deadline is not transient and is
    surfaced immediately. Each retry attempt re-checks the deadline, so
    backoff can never extend a request past its TTFT budget."""

    def matches(self, exc: BaseException) -> bool:
        return not isinstance(exc, DeadlineExceeded) and super().matches(exc)


@dataclass(frozen=True)
class GenRequest:
    """One generation request: prompt token ids + greedy-decode budget.

    ``deadline`` (seconds from submission, optional) bounds time-to-first-
    token: it grades the prefill's §9 priority band as it ages and fails
    the request with :class:`DeadlineExceeded` if the prefill has not
    started when it lapses. It never interrupts a resident sequence.
    """

    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    deadline: Optional[float] = None


class RequestHandle:
    """Client-side handle: a cancellable future over the generated tokens,
    plus a streaming surface and per-request latency marks.

    ``result()`` returns the generated token ids as a 1-D int32 array (the
    prompt is not echoed). ``cancel()`` succeeds only while the request has
    not yet joined the decode batch (cooperative semantics — resident
    work runs to completion); a successful cancel releases anything the
    request held and the future resolves with ``CancelledError``.
    ``truncated`` is set when the sequence was evicted at cache capacity
    before reaching its token budget.

    Streaming: tokens are pushed per decode tick. ``for tok in handle``
    blocks the calling thread per token; ``async for tok in handle`` rides
    the §10 asyncio bridge and never blocks the event loop. Both raise the
    request's failure (including ``CancelledError``) at the point of
    failure and end cleanly on completion.

    Latency marks (``time.monotonic`` seconds): ``submit_t`` at submission,
    ``first_token_t`` when the first token is delivered (TTFT =
    ``first_token_t - submit_t``, also exposed as ``.ttft``), and
    ``token_times`` for every delivered token (inter-token gaps). Between
    the two, ``prefill_start_t`` and ``prefill_done_t`` bracket the prompt's
    prefill (its last attempt; a resume after preemption leaves them), so
    TTFT splits into the admission wait, the prefill, and the wait for a
    slot (the first token is delivered when the sequence joins the batch).
    """

    def __init__(
        self,
        rid: int,
        prompt_len: int,
        canceller,
        deadline: Optional[float] = None,
    ) -> None:
        self.rid = rid
        self.prompt_len = prompt_len
        self.deadline = deadline
        self.truncated = False
        self.submit_t = time.monotonic()
        self.prefill_start_t: Optional[float] = None
        self.prefill_done_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.token_times: list[float] = []
        self._cv = threading.Condition()
        self._streamed: list[int] = []
        self._listeners: list = []
        self.future = Future(canceller=canceller)
        # resolution (result, error or cancel) must wake stream consumers;
        # done callbacks fire on the resolving thread after first-write-wins
        self.future.add_done_callback(lambda _f: self._wake())

    # -- results ------------------------------------------------------------

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        return self.future.result(timeout)

    def cancel(self) -> bool:
        return self.future.cancel()

    def done(self) -> bool:
        return self.future.done()

    @property
    def ttft(self) -> Optional[float]:
        """Seconds from submission to first delivered token (None until)."""
        t = self.first_token_t
        return None if t is None else t - self.submit_t

    # -- streaming ----------------------------------------------------------

    def _push(self, tok: int) -> None:
        now = time.monotonic()
        with self._cv:
            if self.first_token_t is None:
                self.first_token_t = now
            self._streamed.append(int(tok))
            self.token_times.append(now)
            self._cv.notify_all()
            listeners = list(self._listeners)
        for cb in listeners:
            cb()

    def _wake(self) -> None:
        with self._cv:
            self._cv.notify_all()
            listeners = list(self._listeners)
        for cb in listeners:
            cb()

    def iter_tokens(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Yield tokens as they are generated; ``timeout`` bounds each wait.

        Ends when the request completes; raises its failure (including
        ``CancelledError``) once all delivered tokens have been yielded.
        """
        i = 0
        while True:
            with self._cv:
                if not self._cv.wait_for(
                    lambda: len(self._streamed) > i or self.future.done(), timeout
                ):
                    raise TimeoutError("no token within timeout")
                # tokens are pushed strictly before the future resolves, so
                # a done future with no pending tokens is final
                have, fin = len(self._streamed), self.future.done()
            while i < have:
                yield self._streamed[i]
                i += 1
            if fin:
                self.future.result(0)  # surface error / cancellation
                return

    def __iter__(self) -> Iterator[int]:
        return self.iter_tokens()

    async def stream(self):
        """``async for tok in handle.stream()`` (also ``async for ... in
        handle``): per-token delivery without blocking the event loop."""
        import asyncio

        loop = asyncio.get_running_loop()
        evt = asyncio.Event()

        def poke() -> None:
            try:
                loop.call_soon_threadsafe(evt.set)
            except RuntimeError:  # loop already closed
                pass

        with self._cv:
            self._listeners.append(poke)
        i = 0
        try:
            while True:
                evt.clear()  # before the snapshot: a wake after it re-sets
                with self._cv:
                    have, fin = len(self._streamed), self.future.done()
                while i < have:
                    yield self._streamed[i]
                    i += 1
                if fin:
                    self.future.result(0)
                    return
                await evt.wait()
        finally:
            with self._cv:
                if poke in self._listeners:
                    self._listeners.remove(poke)

    def __aiter__(self):
        return self.stream()


class _Pending:
    """A request between submission and residency (admit queue / prefill /
    join queue). ``tokens`` is non-empty iff this is a preempted sequence
    awaiting resume. Heap key: (deadline or +inf, arrival order)."""

    __slots__ = (
        "handle", "req", "deadline", "order", "tokens", "cancelled", "stage", "joined",
    )

    def __init__(
        self, handle: RequestHandle, req: GenRequest, deadline: Optional[float], order: int
    ) -> None:
        self.handle = handle
        self.req = req
        self.deadline = deadline  # absolute monotonic, or None
        self.order = order
        self.tokens: list[int] = []
        self.cancelled = False
        self.stage = "waiting"  # waiting -> prefill -> join -> (active)
        self.joined: Optional[tuple] = None  # (cache, first_token, pad)

    @property
    def key(self) -> tuple:
        return (self.deadline if self.deadline is not None else math.inf, self.order)


class _Seq:
    """A live sequence occupying one cache slot."""

    __slots__ = ("p", "tokens", "feed_index", "remaining", "slot")

    def __init__(
        self, p: _Pending, tokens: list, feed_index: int, remaining: int, slot: int
    ) -> None:
        self.p = p
        self.tokens = tokens
        self.feed_index = feed_index  # position of the token fed next tick
        self.remaining = remaining
        self.slot = slot

    @property
    def handle(self) -> RequestHandle:
        return self.p.handle


class ServeEngine:
    """Continuous-batching greedy-decode engine.

    Parameters
    ----------
    model, params:
        A ``repro_torch.models.Model`` and its parameter tree, on the
        engine's device. Encoder-decoder and VLM families are not supported
        (their prefill inputs are not plain token prompts).
    max_slots:
        Decode batch width = number of resident sequences.
    max_len:
        Per-sequence cache capacity (prompt + generated). Sequences reaching
        it are evicted (``handle.truncated``).
    kv_layout:
        ``"paged"`` (default) stores growable cache leaves in fixed-size
        pages with per-sequence page tables (DESIGN.md §13) — admission
        holds pages for the prompt only, growth is O(1) page claims, and
        page pressure preempts the youngest resident to the admit queue
        instead of refusing work. ``"flat"`` keeps the whole-slot layout.
    page_size, num_pages:
        Paged layout knobs: tokens per page, and the usable page-pool size.
        ``num_pages`` defaults to ``max_slots * ceil(max_len / page_size)``
        (every resident can reach ``max_len`` — no preemption); smaller
        values oversubscribe memory and rely on preemption.
    max_waiting:
        Bound on the admit queue. ``submit`` raises :class:`QueueFull` when
        this many requests are already waiting (None = unbounded).
        Preemption re-entries bypass the bound — they were already admitted.
    pool:
        Shared :class:`ThreadPool`; the engine owns a 2-worker pool if None.
    prefill_buckets:
        Optional ascending prompt-length buckets. Prompts are right-padded to
        the smallest fitting bucket so prefill is captured once per bucket
        (one CUDA graph each) instead of once per prompt length. Only valid for
        full-attention families (pad tokens are causally invisible and
        masked by ``valid_len`` during decode); SSM/hybrid state and
        sliding-window rings would absorb the pad tokens, so bucketing is
        rejected there.
    prefill_lookahead:
        How many prefills may run/wait beyond free slot capacity (default:
        ``max_slots``). Speculative prefills keep the join queue warm so a
        retiring sequence is replaced at the very next tick; each waiting
        join holds one batch-1 cache of bucket length, which bounds the
        extra memory.
    trace_path:
        When set, a :class:`~repro_torch.core.ChromeTraceObserver` is attached to
        the pool for the engine's lifetime and the trace (every prefill
        task, decode tick and steal, per worker lane) is written there on
        ``close()`` — load it in ``chrome://tracing``. Exposed as
        ``self.tracer`` for mid-run snapshots (``tracer.to_trace()``). On a
        shared pool the trace includes the other users' tasks too, which is
        usually what you want when diagnosing interference.
    device:
        Where prefill and decode run: ``cuda:0`` by default, which raises
        when no GPU is present (pass ``"cpu"`` to run on the CPU).
    """

    def __init__(
        self,
        model,
        params,
        *,
        max_slots: int = 8,
        max_len: int = 256,
        kv_layout: str = "paged",
        page_size: int = 64,
        num_pages: Optional[int] = None,
        max_waiting: Optional[int] = None,
        pool: Optional[ThreadPool] = None,
        prefill_buckets: Optional[Sequence[int]] = None,
        prefill_lookahead: Optional[int] = None,
        trace_path: Optional[str] = None,
        prefill_retries: int = 2,
        breaker_threshold: int = 5,
        breaker_cooldown: float = 1.0,
        device=None,
    ) -> None:
        cfg = model.cfg
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        if cfg.is_encdec or cfg.family == "vlm":
            raise NotImplementedError(
                f"ServeEngine supports text-prompt families only, got {cfg.family!r}"
            )
        if prefill_buckets is not None and not self.supports_prefill_buckets(cfg):
            raise ValueError(
                "prefill_buckets requires a full-attention family (no SSM state, "
                f"no sliding window); {cfg.name} would absorb pad tokens"
            )
        self.model = model
        self.params = params
        self.pool = pool or ThreadPool(2, name="serve")
        self._own_pool = pool is None
        self._trace_path = trace_path
        self.tracer: Optional[ChromeTraceObserver] = None
        if trace_path is not None:
            self.tracer = ChromeTraceObserver()
            self.pool.add_observer(self.tracer)
        self._buckets = tuple(sorted(prefill_buckets)) if prefill_buckets else None
        self._lookahead = max_slots if prefill_lookahead is None else prefill_lookahead
        self._max_waiting = max_waiting
        # §14 graceful degradation: transient prefill failures retry under
        # the TTFT deadline; sustained failure trips a circuit breaker that
        # sheds load fast (QueueFull) instead of queueing doomed requests.
        self._prefill_retry = (
            _PrefillRetry(max_attempts=1 + prefill_retries, backoff=0.005, factor=2.0)
            if prefill_retries > 0
            else None
        )
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown = breaker_cooldown
        self._breaker_fails = 0  # consecutive exhausted prefill failures
        self._breaker_until = 0.0  # monotonic time the breaker re-closes
        self._breaker_trips = 0
        if kv_layout == "paged":
            self.kv = PagedKVCache(
                model, max_slots, max_len, page_size=page_size, num_pages=num_pages
            )
        elif kv_layout == "flat":
            self.kv = SlotKVCache(model, max_slots, max_len)
        else:
            raise ValueError(f"kv_layout must be 'paged' or 'flat', got {kv_layout!r}")
        # the tick and the bucketed prefills as CUDA graphs, the reference's
        # jits: captured here, while no slot is live and before ``submit``
        # can start a prefill of this engine on another pool thread (on the
        # CPU the same bodies run through the same static buffers). A failed
        # capture raises; nothing falls back to eager decode
        self._decode_graph = DecodeGraph(model, params, self.kv)
        self._prefill_graphs = (
            PrefillGraphs(model, params, self._buckets) if self._buckets else None
        )
        # every other prefill by its length's graph, made on first use
        self._exact_graphs = ExactPrefillGraphs(model, params)

        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._waiting: list = []  # heap of (key, _Pending)
        self._nwaiting = 0  # non-cancelled heap entries
        self._pending_by_rid: dict[int, _Pending] = {}
        self._inflight = 0  # prefill tasks in flight
        self._joinq: deque = deque()  # (_Pending, cache, first_token, pad_len)
        self._active: dict[int, _Seq] = {}
        # -- the condition-cycle tick graph (module docs): built once,
        # looped by its weak back-edge, restarted only from idle.
        self._exec = Executor(pool=self.pool)
        tg = TaskGraph("serve-tick")
        entry = tg.add(None, name="tick-entry", priority=DECODE_PRIORITY)
        tick = tg.add(self._tick, name="decode-tick", priority=DECODE_PRIORITY)
        tick.after(entry)
        more = tg.add(
            self._tick_more, name="more?", kind="condition", priority=DECODE_PRIORITY
        )
        more.after(tick)
        more.precede(tick)  # branch 0: weak back-edge -> next tick
        for t in tg.tasks:
            t.propagate_errors = False
        self._tick_graph = tg
        self._tick_live = False  # a run of the tick graph is in flight
        self._closed = False
        self._broken: Optional[BaseException] = None
        self._rid = itertools.count()
        self._order = itertools.count()
        self._requests = 0
        self._completed = 0
        self._truncations = 0
        self._preemptions = 0
        self._rejected = 0
        self._deadline_misses = 0
        self._tokens_out = 0
        self._ticks = 0
        self._occupancy_sum = 0

    # -- client API -----------------------------------------------------------

    @staticmethod
    def supports_prefill_buckets(cfg) -> bool:
        """Whether ``prefill_buckets`` is legal for this config: pad tokens
        must be causally invisible (full-attention families only — SSM
        state and sliding-window rings would absorb them)."""
        return (
            cfg.window is None
            and cfg.family in ("dense", "moe")
            and cfg.attention in ("gqa", "mla")
        )

    def _bucket(self, prompt_len: int) -> int:
        if self._buckets is None:
            return prompt_len
        for b in self._buckets:
            if b >= prompt_len:
                return b
        raise ValueError(f"prompt length {prompt_len} exceeds largest bucket {self._buckets[-1]}")

    def submit(
        self,
        prompt: Union[np.ndarray, Sequence[int]],
        max_new_tokens: int,
        *,
        deadline: Optional[float] = None,
    ) -> RequestHandle:
        """Queue one request; returns immediately with a handle.

        Raises :class:`QueueFull` when ``max_waiting`` requests are already
        queued (backpressure — retry later or shed load upstream).
        ``deadline`` (seconds) bounds time-to-first-token (module docs).
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline is not None and deadline <= 0:
            raise ValueError("deadline must be positive seconds")
        pad = self._bucket(int(prompt.size))
        if pad >= self.kv.max_len:
            raise ValueError(
                f"padded prompt ({pad}) leaves no decode room in max_len={self.kv.max_len}"
            )
        rid = next(self._rid)
        handle = RequestHandle(
            rid, int(prompt.size), canceller=lambda: self._cancel(rid), deadline=deadline
        )
        req = GenRequest(prompt, int(max_new_tokens), deadline)
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._breaker_until:
                now = time.monotonic()
                if now < self._breaker_until:
                    self._rejected += 1
                    raise QueueFull(
                        "circuit breaker open for another "
                        f"{self._breaker_until - now:.2f}s "
                        f"({self._breaker_threshold} consecutive prefill failures)"
                    )
                # half-open: admit trial requests, but one more exhausted
                # failure re-trips immediately; a success fully closes it
                self._breaker_until = 0.0
                self._breaker_fails = self._breaker_threshold - 1
            if self._max_waiting is not None and self._nwaiting >= self._max_waiting:
                self._rejected += 1
                raise QueueFull(
                    f"admit queue full ({self._nwaiting} waiting >= max_waiting="
                    f"{self._max_waiting})"
                )
            p = _Pending(
                handle,
                req,
                None if deadline is None else handle.submit_t + deadline,
                next(self._order),
            )
            self._requests += 1
            self._pending_by_rid[rid] = p
            heapq.heappush(self._waiting, (p.key, p))
            self._nwaiting += 1
            self._pump_locked()
        return handle

    async def submit_async(
        self,
        prompt: Union[np.ndarray, Sequence[int]],
        max_new_tokens: int,
        *,
        deadline: Optional[float] = None,
    ) -> np.ndarray:
        """Asyncio-native submission: queue one request and ``await`` its
        generated ids without blocking the event loop (DESIGN.md §10 —
        completion transfers onto the loop via ``Future.__await__``)::

            tokens = await engine.submit_async(prompt, 32)

        For per-token delivery, ``submit`` + ``async for tok in handle``.
        Validation errors raise synchronously-in-await, generation errors
        resolve the awaitable, exactly like :meth:`submit` + ``result``.

        Cancelling the awaiting task propagates: a request that has not yet
        joined the decode batch is withdrawn (its queue entry, in-flight
        prefill result and any held pages are released) and its handle
        resolves with ``CancelledError`` — it never resolves with tokens.
        """
        import asyncio

        handle = self.submit(prompt, max_new_tokens, deadline=deadline)
        try:
            return await handle.future
        except asyncio.CancelledError:
            handle.cancel()  # best-effort: no-op once resident
            raise

    def generate(self, prompts, max_new_tokens, timeout: float = 300.0) -> list:
        """Submit many prompts and wait: returns per-prompt generated ids."""
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * len(prompts)
        handles = [self.submit(p, n) for p, n in zip(prompts, max_new_tokens)]
        return [h.result(timeout) for h in handles]

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request has completed."""
        with self._idle:
            if not self._idle.wait_for(
                lambda: not (
                    self._nwaiting or self._inflight or self._joinq or self._active
                ),
                timeout,
            ):
                raise TimeoutError("engine did not drain within timeout")

    def close(self, drain: bool = True) -> None:
        # reject new submissions *before* draining: a submit landing in the
        # window between drain() returning and shutdown would be handed to a
        # pool about to abandon its queue, stranding the handle forever
        # (the close/prefill race — see tests/serve/test_engine.py)
        with self._lock:
            self._closed = True
        if drain:
            self.drain()
            # let the in-flight tick run wind down before pool teardown so
            # its condition task is not abandoned mid-cycle
            with self._idle:
                self._idle.wait_for(lambda: not self._tick_live, 60.0)
        if self.tracer is not None:
            tracer, self.tracer = self.tracer, None  # idempotent close
            self.pool.remove_observer(tracer)
            tracer.save(self._trace_path, num_workers=self.pool.num_threads)
        if self._own_pool:
            self.pool.close()
        self._exact_graphs.close()  # gives their pools back

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close(drain=not any(exc))

    def stats(self) -> dict:
        """Engine + KV + pool statistics.

        ``pool`` now includes the §9 scheduler counters: ``parked``/
        ``wakeups`` expose how often engine workers actually slept between
        decode ticks versus being recruited by a targeted wakeup — the
        serving-side view of the spin-then-park protocol. The engine's
        prioritized tasks (decode > prefill) promote the pool's deques to
        banded mode on first use. §13 adds ``preemptions`` (page-pressure
        evictions to the admit queue), ``rejected`` (``QueueFull``
        backpressure), ``deadline_misses`` and the live ``waiting`` depth.
        ``graphs`` has, for the decode graph, each bucket's prefill graph
        (``prefill_<bucket>``) and each held prompt length's
        (``exact_<length>``), its ``replays``, the ``captured_launches`` of
        the port's kernels by name (each replay runs them again without their
        wrappers, which count eager launches only) and ``capture_s``; a
        length's also its ``eager_steps`` (its first prefill) and
        ``pool_bytes``. ``exact_graph_evictions`` counts the lengths given
        back to keep within ``graphs.EXACT_PREFILL_BYTES``.
        """
        graphs = {"decode": self._decode_graph.stats()}
        if self._prefill_graphs is not None:
            graphs.update(self._prefill_graphs.stats())
        graphs.update(self._exact_graphs.stats())
        with self._lock:
            occ = self._occupancy_sum / self._ticks if self._ticks else 0.0
            plan = self._tick_graph.replay_plan
            return {
                "requests": self._requests,
                "completed": self._completed,
                "truncations": self._truncations,
                "preemptions": self._preemptions,
                "rejected": self._rejected,
                "deadline_misses": self._deadline_misses,
                "breaker_trips": self._breaker_trips,
                "waiting": self._nwaiting,
                "tokens_out": self._tokens_out,
                "ticks": self._ticks,
                "tick_replays": plan.replays if plan is not None else 0,
                "graphs": graphs,
                "exact_graph_evictions": self._exact_graphs.evictions,
                "mean_occupancy": occ,
                "kv": self.kv.stats(),
                "pool": self.pool.stats(),
            }

    # -- scheduling internals ---------------------------------------------------

    def _cancel(self, rid: int) -> bool:
        """Canceller: True iff the request had not yet joined the batch.

        A cancelled request releases whatever it held (heap entry, in-flight
        prefill result, join-queue cache) — it never reaches a slot, so no
        pages are ever allocated for it.
        """
        with self._lock:
            p = self._pending_by_rid.get(rid)
            if p is None or p.cancelled:
                return False
            p.cancelled = True
            del self._pending_by_rid[rid]
            if p.stage == "waiting":
                self._nwaiting -= 1  # heap entry is skipped lazily at pump
            elif p.stage == "join":
                self._joinq = deque(e for e in self._joinq if e[0] is not p)
            # stage "prefill": _prefill_done sees p.cancelled on completion
            self._requests -= 1
            self._pump_locked()
            self._idle.notify_all()
            return True

    def _band(self, p: _Pending, now: float) -> float:
        """§13 deadline -> §9 priority band mapping (module docs)."""
        if p.tokens:
            return PREFILL_URGENT  # resumes block a mid-stream consumer
        if p.deadline is None or p.req.deadline is None:
            return PREFILL_PRIORITY
        frac = (p.deadline - now) / p.req.deadline  # headroom fraction
        if frac <= 0.25:
            return PREFILL_URGENT
        if frac <= 0.5:
            return PREFILL_SOON
        return PREFILL_PRIORITY

    def _pump_locked(self) -> None:
        """Admission: start prefills while capacity (+ lookahead) allows,
        in deadline order (earliest deadline first, then arrival)."""
        now = time.monotonic()
        while self._waiting and (
            self.kv.num_live + self._inflight + len(self._joinq)
            < self.kv.max_slots + self._lookahead
        ):
            _key, p = heapq.heappop(self._waiting)
            if p.cancelled:
                continue
            self._nwaiting -= 1
            p.stage = "prefill"
            self._inflight += 1
            name = ("resume" if p.tokens else "prefill") + f":{p.handle.rid}"
            t = Task(
                lambda p=p: self._prefill_one(p),
                name=name,
                priority=self._band(p, now),
                retry=self._prefill_retry,
            )
            t.propagate_errors = False
            t.on_done = lambda t, p=p: self._prefill_done(p, t)
            self.pool.submit(t)

    def _prefill_one(self, p: _Pending) -> None:
        """Prefill task *body*: deadline fail-fast + the pure prefill compute.

        Exceptions raise out so the task's §14 retry policy sees them —
        transient failures re-run (every attempt re-checks the deadline),
        ``DeadlineExceeded`` never retries. All terminal bookkeeping lives
        in :meth:`_prefill_done` (the task's ``on_done``), which fires
        exactly once per task — never for a retried attempt.
        """
        handle, req = p.handle, p.req
        if not p.tokens and p.deadline is not None and time.monotonic() >= p.deadline:
            raise DeadlineExceeded(
                f"request {handle.rid} missed its {req.deadline:.3f}s deadline "
                "before prefill started"
            )
        if p.tokens:
            # resume a preempted sequence: re-prefill prompt + generated
            # prefix except the last token (it is the next decode feed).
            # Exact length, no bucketing — the length is feed_index and
            # is < max_len by the retire invariant.
            seq_toks = np.concatenate(
                [req.prompt, np.asarray(p.tokens[:-1], np.int32)]
            )
            plen = pad = int(seq_toks.size)
        else:
            seq_toks = req.prompt
            plen = int(req.prompt.size)
            pad = self._bucket(plen)
            handle.prefill_start_t = time.monotonic()
        toks = np.zeros((1, pad), np.int32)
        toks[0, :plen] = seq_toks
        if self._prefill_graphs is not None and not p.tokens:
            cache, first = self._prefill_graphs.run(toks, plen - 1)
        else:  # an exact length (no buckets, or a resume): its length's graph
            cache, first = self._exact_graphs.run(toks)
        if not p.tokens:
            handle.prefill_done_t = time.monotonic()
        p.joined = (cache, first, pad)

    def _prefill_done(self, p: _Pending, task: Task) -> None:
        """Terminal prefill outcome (task ``on_done``): deliver failure or
        hand the result to the join queue, and feed the circuit breaker."""
        handle = p.handle
        exc = task.exception
        if exc is not None:
            with self._lock:
                self._inflight -= 1
                self._pending_by_rid.pop(handle.rid, None)
                if isinstance(exc, DeadlineExceeded):
                    self._deadline_misses += 1
                else:
                    # sustained non-deadline failure (model/runtime fault,
                    # retries exhausted): trip the breaker so submit()
                    # sheds load fast instead of queueing doomed requests
                    self._breaker_fails += 1
                    if self._breaker_fails >= self._breaker_threshold:
                        self._breaker_trips += 1
                        self._breaker_until = (
                            time.monotonic() + self._breaker_cooldown
                        )
                        self._breaker_fails = 0
                self._pump_locked()  # freed admission capacity: re-admit waiters
                self._idle.notify_all()
            if not handle.future.done():
                handle.future.set_exception(exc)
            return
        cache, first, pad = p.joined
        p.joined = None
        with self._lock:
            self._breaker_fails = 0  # a healthy prefill closes the streak
            self._inflight -= 1
            if p.cancelled:  # cancelled mid-prefill: drop the result
                self._pump_locked()
                self._idle.notify_all()
                return
            if self._broken is not None:  # engine died while we prefilled
                self._idle.notify_all()
                exc = self._broken
            else:
                p.stage = "join"
                self._joinq.append((p, cache, first, pad))
                self._schedule_tick_locked()
                return
        handle.future.set_exception(exc)

    def _schedule_tick_locked(self) -> None:
        """(Re)start the tick graph if no run is in flight.

        ``_tick_live`` flips False only in the run future's done callback,
        so a restart can never overlap a draining run (resetting a graph
        whose condition task is still completing would race its fan-out).
        """
        if self._tick_live or self._broken is not None:
            return
        self._tick_live = True
        # counted submission (the graph holds a condition) re-arms every
        # task; from the second restart on this is a §12 plan re-arm
        fut = self._exec.run(self._tick_graph)
        fut.add_done_callback(self._tick_run_done)

    def _tick_run_done(self, _fut: Future) -> None:
        """Run drained: mark idle, and restart if work raced the exit."""
        with self._lock:
            self._tick_live = False
            if self._active or self._joinq:
                self._schedule_tick_locked()
            else:
                self._idle.notify_all()  # close() waits for the run to land

    def _tick_more(self) -> int:
        """Condition body: loop (branch 0 -> tick) while work remains."""
        with self._lock:
            return 0 if self._broken is None and (self._active or self._joinq) else 1

    def _tick(self) -> None:
        try:
            self._tick_body()
        except BaseException as exc:  # noqa: BLE001 - fail every request and
            # brick the engine: the kv pools may be half-written now
            with self._lock:
                self._broken = exc
                self._closed = True  # reject new submissions
                victims = [s.handle for s in self._active.values()]
                victims += [e[0].handle for e in self._joinq]
                victims += [
                    p.handle for _k, p in self._waiting if not p.cancelled
                ]
                for s in self._active.values():
                    self.kv.free(s.slot)
                self._active.clear()
                self._joinq.clear()
                self._waiting.clear()
                self._pending_by_rid.clear()
                self._nwaiting = 0
                self._idle.notify_all()
            # the condition task sees _broken and exits the cycle; the run
            # future's callback then clears _tick_live
            for h in victims:
                h.future.set_exception(exc)

    def _preempt_locked(self, victim: _Seq) -> None:
        """Page pressure: move the victim back to the admit queue.

        Its pages and slot are freed; the request re-enters the heap at its
        original (deadline, arrival) key carrying the generated prefix, to
        resume via an exact-length re-prefill. Work moves, never drops.
        """
        del self._active[victim.slot]
        self.kv.free(victim.slot)
        p = victim.p
        p.tokens = list(victim.tokens)
        p.stage = "waiting"
        self._pending_by_rid[p.handle.rid] = p
        heapq.heappush(self._waiting, (p.key, p))
        self._nwaiting += 1
        self._preemptions += 1

    def _tick_body(self) -> None:
        # 1. join freshly prefilled sequences into free slots (paged: the
        #    join claims pages for the prefilled prompt only)
        with self._lock:
            joins = []
            while self._joinq:
                p, cache, first, pad = self._joinq[0]
                slot = self.kv.alloc(self.kv.pages_for(pad))
                if slot is None:  # lookahead prefills wait for slot/pages
                    break
                self._joinq.popleft()
                self._pending_by_rid.pop(p.handle.rid, None)
                p.stage = "active"
                if p.tokens:  # resumed sequence: prefix already delivered
                    seq = _Seq(
                        p,
                        list(p.tokens),
                        p.handle.prompt_len + len(p.tokens) - 1,
                        p.req.max_new_tokens - len(p.tokens),
                        slot,
                    )
                else:
                    seq = _Seq(p, [first], p.handle.prompt_len, p.req.max_new_tokens - 1, slot)
                    self._tokens_out += 1  # the prefill-produced first token
                    p.handle._push(first)
                self._active[slot] = seq
                joins.append((slot, cache, pad))
        with torch.inference_mode():
            for slot, cache, pad in joins:
                self.kv.write(slot, cache, pad)  # tick chain serializes buffers

        retired: list = []
        with self._lock:
            self._retire_locked(retired)  # max_new_tokens == 1 finishes at join
            # 1b. back every lane's write position with a physical page;
            #     on page pressure preempt the youngest resident (oldest
            #     sequences grow first, so the victim order is stable)
            for seq in sorted(self._active.values(), key=lambda s: s.p.order):
                while seq.slot in self._active and not self.kv.grow_to(
                    seq.slot, seq.feed_index + 1
                ):
                    victim = max(self._active.values(), key=lambda s: s.p.order)
                    self._preempt_locked(victim)
            if not self._active:
                # nothing to decode this pass; the condition task loops if
                # the join queue refilled, else the cycle drains
                self._pump_locked()
                self._idle.notify_all()
                self._resolve(retired)
                return
            tok_np = np.zeros((self.kv.max_slots, 1), np.int32)
            idx_np = np.zeros((self.kv.max_slots,), np.int32)
            feeds: dict[int, int] = {}
            for slot, seq in self._active.items():
                tok_np[slot, 0] = seq.tokens[-1]
                idx_np[slot] = seq.feed_index
                feeds[slot] = seq.feed_index
            self._ticks += 1
            self._occupancy_sum += len(self._active)

        # 2. one decode step over the padded slot batch (outside the lock)
        next_np = self._decode(tok_np, idx_np, feeds)  # (slots, 1)

        # 3. apply results, retire finished/evicted, admit more work
        pushes = []
        with self._lock:
            for slot, seq in list(self._active.items()):
                tok = int(next_np[slot, 0])
                seq.tokens.append(tok)
                seq.feed_index += 1
                seq.remaining -= 1
                self._tokens_out += 1
                pushes.append((seq.handle, tok))
            self._retire_locked(retired)
            self._pump_locked()
            self._idle.notify_all()  # the condition task decides the loop
        for handle, tok in pushes:
            handle._push(tok)
        self._resolve(retired)

    def _decode(self, tok_np: np.ndarray, idx_np: np.ndarray, feeds: dict) -> np.ndarray:
        """One greedy decode step over every slot lane, a replay of the
        decode graph; idle lanes decode garbage that is never read (flat:
        their own free slot; paged: the scratch page). Returns the next
        token of each lane, ``(slots, 1)``."""
        return self._decode_graph.run(tok_np, idx_np, feeds)

    def _retire_locked(self, retired: list) -> None:
        for slot, seq in list(self._active.items()):
            finished = seq.remaining <= 0
            evicted = not finished and seq.feed_index >= self.kv.max_len
            if finished or evicted:
                del self._active[slot]
                if evicted:
                    self.kv.evict(slot)
                    self._truncations += 1
                else:
                    self.kv.free(slot)
                self._completed += 1
                retired.append((seq, evicted))

    def _resolve(self, retired: list) -> None:
        for seq, evicted in retired:
            seq.handle.truncated = evicted
            seq.handle.future.set_result(np.asarray(seq.tokens, np.int32))
