"""Bounded retry with jittered exponential backoff — the port's copy of
``opensim_tpu/resilience/retry.py``.

:func:`retry_call` wraps calls to something that can transiently fail (the
apiserver snapshot fetch). Attempt ``k`` (0-based) sleeps a uniform sample
from ``[0, min(max_delay, base_delay * 2**k)]`` (full jitter), which
decorrelates retry storms across clients while keeping the expected
backoff exponential. ``sleep`` and ``rng`` are injectable, so tests assert
exact schedules without wall-clock time. The attempt bound is a hard
parameter, never unlimited.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")

__all__ = ["retry_call"]


def retry_call(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay: float = 0.1,
    max_delay: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    trace_name: str = "retry.backoff",
) -> T:
    """Call ``fn`` up to ``attempts`` times; re-raise the last failure.

    Only exceptions matching ``retry_on`` are retried — anything else
    propagates immediately (an auth misconfiguration must not be hammered
    three times). ``on_retry(attempt_index, exc, delay_s)`` fires before each
    backoff sleep (metrics/log hook). Each retried failure also lands in the
    ambient request trace as one instant event named ``trace_name`` — pass a
    site-specific name (the snapshot fetch uses ``snapshot.retry``) so the
    span tree attributes the backoff; callers must NOT emit their own event
    from ``on_retry`` on top of it."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    rng = rng if rng is not None else random.Random()
    for k in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if k == attempts - 1:
                raise
            delay = rng.uniform(0.0, min(max_delay, base_delay * (2.0**k)))
            # retries land in the ambient request trace: each backed-off
            # attempt is ONE instant event naming the failure
            from ..obs import trace as _obs

            _obs.event(
                trace_name, status="error", attempt=k + 1,
                error=f"{type(e).__name__}: {e}", delay_s=round(delay, 6),
            )
            if on_retry is not None:
                on_retry(k, e, delay)
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
