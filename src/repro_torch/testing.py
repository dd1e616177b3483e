"""Minimal property-testing fallback for environments without ``hypothesis``.

The test suite prefers the real `hypothesis <https://hypothesis.works>`_
(pinned in ``requirements-dev.txt``); when it is not installed the test
modules fall back to this shim::

    try:
        from hypothesis import given, settings
        from hypothesis import strategies as st
    except ImportError:
        from repro_torch.testing import given, settings, st

The shim implements just the surface the suite uses — ``given`` (positional
and keyword strategies), ``settings(max_examples=, deadline=)``,
``st.integers/booleans/lists/sampled_from/floats/composite`` — drawing
deterministic pseudo-random examples from a seed derived from the test's
qualified name, so failures reproduce across runs and machines. It does no
shrinking and no coverage-guided search; it is a stand-in, not a
replacement.
"""
from __future__ import annotations

import inspect
import random
from typing import Any, Callable, Optional, Sequence

__all__ = ["given", "settings", "st"]

_DEFAULT_MAX_EXAMPLES = 20


class Strategy:
    """A draw function ``rng -> value`` with hypothesis-like spelling."""

    def __init__(self, draw_fn: Callable[[random.Random], Any]) -> None:
        self._draw_fn = draw_fn

    def example(self, rng: random.Random) -> Any:
        return self._draw_fn(rng)


class _Strategies:
    @staticmethod
    def integers(min_value: Optional[int] = None, max_value: Optional[int] = None) -> Strategy:
        lo = -(2**16) if min_value is None else min_value
        hi = 2**16 if max_value is None else max_value
        return Strategy(lambda rng: rng.randint(lo, hi))

    @staticmethod
    def booleans() -> Strategy:
        return Strategy(lambda rng: rng.random() < 0.5)

    @staticmethod
    def floats(min_value: float = 0.0, max_value: float = 1.0, **_kw: Any) -> Strategy:
        return Strategy(lambda rng: rng.uniform(min_value, max_value))

    @staticmethod
    def sampled_from(elements: Sequence[Any]) -> Strategy:
        elements = list(elements)
        return Strategy(lambda rng: rng.choice(elements))

    @staticmethod
    def lists(elem: Strategy, *, min_size: int = 0, max_size: Optional[int] = None) -> Strategy:
        hi = max_size if max_size is not None else min_size + 10

        def draw(rng: random.Random) -> list:
            return [elem.example(rng) for _ in range(rng.randint(min_size, hi))]

        return Strategy(draw)

    @staticmethod
    def composite(fn: Callable) -> Callable[..., Strategy]:
        def strategy_of(*args: Any, **kw: Any) -> Strategy:
            def draw_value(rng: random.Random) -> Any:
                def draw(strategy: Strategy) -> Any:
                    return strategy.example(rng)

                return fn(draw, *args, **kw)

            return Strategy(draw_value)

        return strategy_of


st = _Strategies()


def given(*arg_strats: Strategy, **kw_strats: Strategy):
    """Run the test once per drawn example (rightmost params, like hypothesis)."""

    def deco(test: Callable) -> Callable:
        sig = inspect.signature(test)
        params = list(sig.parameters.values())
        n = len(arg_strats)
        target_names = [p.name for p in params[len(params) - n :]] if n else []
        drawn = set(target_names) | set(kw_strats)

        def wrapper(*args: Any, **kwargs: Any) -> None:
            for i in range(getattr(wrapper, "_max_examples", _DEFAULT_MAX_EXAMPLES)):
                rng = random.Random(f"{test.__module__}.{test.__qualname__}:{i}")
                call_kw = dict(kwargs)
                for name, strat in zip(target_names, arg_strats):
                    call_kw[name] = strat.example(rng)
                for name, strat in kw_strats.items():
                    call_kw[name] = strat.example(rng)
                test(*args, **call_kw)

        wrapper.__name__ = test.__name__
        wrapper.__qualname__ = test.__qualname__
        wrapper.__module__ = test.__module__
        wrapper.__doc__ = test.__doc__
        # hide the drawn params from pytest's fixture resolution
        wrapper.__signature__ = sig.replace(
            parameters=[p for p in params if p.name not in drawn]
        )
        wrapper._max_examples = _DEFAULT_MAX_EXAMPLES
        return wrapper

    return deco


def settings(max_examples: Optional[int] = None, deadline: Any = None, **_kw: Any):
    """Configure a ``given``-wrapped test (only max_examples is honored)."""

    def deco(fn: Callable) -> Callable:
        if max_examples is not None and hasattr(fn, "_max_examples"):
            fn._max_examples = max_examples
        return fn

    return deco
