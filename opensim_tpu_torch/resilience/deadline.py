"""Request-scoped deadlines, enforced at phase boundaries — the port's copy
of ``opensim_tpu/resilience/deadline.py``.

A :class:`Deadline` is created once per request (``server/rest.py`` reads
the ``X-Simon-Timeout-S`` header, falling back to
``OPENSIM_REQUEST_TIMEOUT_S``) and carried through the serving path in a
:mod:`contextvars` variable — the HTTP server handles each request on its
own thread, so scopes never bleed between concurrent requests. Deep layers
call :func:`check_deadline` at the points where work can be abandoned
cleanly:

    snapshot → prepare → encode → schedule → decode

The kernel launch itself cannot be interrupted mid-flight; the contract is
*phase-boundary* enforcement — an exhausted deadline raises
:class:`DeadlineExceeded` naming the phase it was caught at, which the REST
layer maps to a typed 504 JSON error.

``check_deadline`` with no ambient deadline is a no-op (one contextvar
read), so library callers that never set a scope pay nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Iterator, Optional

__all__ = [
    "Deadline",
    "DeadlineExceeded",
    "check_deadline",
    "current_deadline",
    "deadline_scope",
]


class DeadlineExceeded(RuntimeError):
    """The request's time budget ran out. ``phase`` names the boundary the
    exhaustion was caught at (snapshot/prepare/encode/schedule/decode)."""

    def __init__(self, message: str, phase: str = "") -> None:
        super().__init__(message)
        self.phase = phase


class Deadline:
    """A monotonic-clock expiry point. ``clock`` is injectable so tests can
    drive expiry deterministically instead of sleeping."""

    def __init__(
        self,
        expires_at: float,
        budget_s: float,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.expires_at = expires_at
        self.budget_s = budget_s
        self.clock = clock

    @classmethod
    def after(cls, seconds: float, clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + seconds, seconds, clock=clock)

    def remaining(self) -> float:
        return self.expires_at - self.clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, phase: str) -> None:
        rem = self.remaining()
        if rem <= 0.0:
            # the exhaustion lands in the request's span tree as an instant event naming the phase; the enclosing
            # phase span is marked deadline-exceeded by its own __exit__
            from ..obs import trace as _obs

            _obs.event(
                "deadline.exceeded", status="deadline-exceeded",
                phase=phase, budget_s=round(self.budget_s, 6),
                over_by_s=round(-rem, 6),
            )
            raise DeadlineExceeded(
                f"request deadline exceeded at the {phase!r} phase "
                f"(budget {self.budget_s:.3f}s, over by {-rem:.3f}s)",
                phase=phase,
            )

    def __repr__(self) -> str:  # debugging / log lines
        return f"Deadline(budget={self.budget_s:.3f}s, remaining={self.remaining():.3f}s)"


_CURRENT: contextvars.ContextVar[Optional[Deadline]] = contextvars.ContextVar(
    "opensim_deadline", default=None
)


def current_deadline() -> Optional[Deadline]:
    return _CURRENT.get()


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]) -> Iterator[Optional[Deadline]]:
    """Install ``deadline`` as the ambient request deadline for the body.
    ``deadline_scope(None)`` keeps whatever scope is already ambient (so
    ``simulate(deadline=None)`` composes with a server-installed scope)."""
    if deadline is None:
        yield current_deadline()
        return
    token = _CURRENT.set(deadline)
    try:
        yield deadline
    finally:
        _CURRENT.reset(token)


def check_deadline(phase: str) -> None:
    """Raise :class:`DeadlineExceeded` if the ambient deadline (if any) is
    exhausted. The per-phase hook the engine layers call."""
    dl = _CURRENT.get()
    if dl is not None:
        dl.check(phase)
