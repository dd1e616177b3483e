"""repro_torch.core — the port's own copy of the paper's work-stealing thread
pool and task graphs (Puyda 2024), taken from the reference package's
``repro/core`` with imports made relative.

The copy carries the scheduler modules the serving engine reaches: tasks,
deques, graphs, the pool, replay, the executor facade, the serial
baselines and the observers. ``chaos.py`` and ``schedule.py`` stay behind
(the engine uses neither), and the executor's process/socket backends and
graph verifier raise ``NotImplementedError`` until later slices port them.
"""
from .baseline import NaiveThreadPool, SerialExecutor, SerialPool
from .deque import EMPTY, ChaseLevDeque, FastDeque, PriorityDeque
from .executor import Executor
from .graph import CycleError, Module, Runtime, TaskGraph
from .observer import ChromeTraceObserver, PoolObserver, StatsObserver
from .pool import Future, RunContext, ThreadPool, checkpoint
from .replay import ReplayPlan
from .task import CancelledError, RetryPolicy, Task, TaskTimeoutError, iter_graph

__all__ = [
    "NaiveThreadPool",
    "SerialExecutor",
    "SerialPool",
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
]
