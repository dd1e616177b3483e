"""repro_torch.core — the port's own copy of the paper's work-stealing thread
pool and task graphs (Puyda 2024), plus the schedule simulator whose
timelines the pipeline (:mod:`repro_torch.parallel.pipeline`) runs as its
static tick table. Every module here is the reference package's
``repro/core`` module with its imports rewritten.

The public front door is the :class:`Executor` facade (DESIGN.md §10):
condition tasks, dynamic subflows, futures and the asyncio bridge all hang
off it, on the serial, thread, process and socket backends, with the
optional pre-submission verifier (``verify=``, :mod:`repro_torch.analysis`)
and the seeded fault injector (:class:`FaultInjector`). The lower layers
remain importable for drop-in paper fidelity."""
from .baseline import NaiveThreadPool, SerialExecutor, SerialPool
from .chaos import ChaosError, FaultInjector
from .deque import EMPTY, ChaseLevDeque, FastDeque, PriorityDeque
from .executor import Executor
from .graph import CycleError, Module, Runtime, TaskGraph
from .observer import ChromeTraceObserver, PoolObserver, StatsObserver
from .pool import Future, RunContext, ThreadPool, checkpoint
from .replay import ReplayPlan
from .schedule import (
    PipelineOp,
    SimResult,
    SimTask,
    gpipe_schedule,
    peak_activation_buffers,
    pipeline_schedule,
    pipeline_task_graph,
    schedule_to_table,
    simulate,
)
from .task import CancelledError, RetryPolicy, Task, TaskTimeoutError, iter_graph

__all__ = [
    "NaiveThreadPool",
    "SerialExecutor",
    "SerialPool",
    "ChaosError",
    "FaultInjector",
    "RetryPolicy",
    "TaskTimeoutError",
    "checkpoint",
    "EMPTY",
    "ChaseLevDeque",
    "FastDeque",
    "PriorityDeque",
    "CycleError",
    "Module",
    "Runtime",
    "TaskGraph",
    "Executor",
    "Future",
    "RunContext",
    "ThreadPool",
    "ReplayPlan",
    "PoolObserver",
    "StatsObserver",
    "ChromeTraceObserver",
    "CancelledError",
    "Task",
    "iter_graph",
    "PipelineOp",
    "SimResult",
    "SimTask",
    "simulate",
    "pipeline_task_graph",
    "pipeline_schedule",
    "gpipe_schedule",
    "schedule_to_table",
    "peak_activation_buffers",
]
