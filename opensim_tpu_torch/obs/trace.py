"""Request-scoped tracing: contextvar-carried span trees — the port's
copy of ``opensim_tpu/obs/trace.py``.

One :class:`TraceContext` per served request carries a tree of
:class:`Span` objects through the serving path (snapshot fetch, the encode
cache's work, the simulation) plus instant *events* for what the
resilience layer does on the way: snapshot retries,
prep-cache invalidations, fault injections, an exhausted deadline.
``PREP_STATS`` host-prepare timings attach as child spans.

- Spans are plain host-side objects timed with ``time.monotonic``.
- The ambient trace travels in ONE :mod:`contextvars` variable. With no
  active trace (library callers, ``OPENSIM_TRACE=0``), every
  instrumentation point — :func:`span`, :func:`event`,
  :func:`record_span` — is a single contextvar read returning a shared
  no-op.
- One trace == one thread (the HTTP server handles each request on its own
  thread), so the span stack needs no lock; finished traces are immutable
  and safe to read from the flight-recorder endpoints on other threads.

Exporters: :meth:`TraceContext.tree` (the ``/api/debug/requests/<id>``
span-tree JSON) and :meth:`TraceContext.to_chrome` (Chrome-trace JSON,
written by ``simon apply --trace``).
"""

from __future__ import annotations

import contextvars
import re
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

from ..utils import envknobs

__all__ = [
    "PHASES",
    "Span",
    "TraceContext",
    "current_span",
    "current_trace",
    "enabled",
    "event",
    "new_request_id",
    "record_span",
    "sanitize_request_id",
    "span",
    "start_trace",
    "trace_scope",
    "write_chrome",
]

# the Deadline layer's phase names — spans with these names feed the
# /metrics latency histograms (obs/metrics.py). ``prepare`` contains
# ``encode`` as a child by design: the histograms measure each boundary the
# deadline layer can abandon work at, not disjoint partitions of the wall.
PHASES = ("snapshot", "prepare", "encode", "schedule", "decode")

_STATUSES = ("ok", "error", "deadline-exceeded", "demoted")


class Span:
    """One timed phase. ``status`` is ok / error / deadline-exceeded /
    demoted; ``attrs`` is a small flat dict of typed attributes."""

    __slots__ = ("name", "start", "end", "status", "attrs", "children", "_lay")

    def __init__(self, name: str, start: float, attrs: Optional[dict] = None) -> None:
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.status = "ok"
        self.attrs: Dict[str, Any] = attrs or {}
        self.children: List[Span] = []
        self._lay = start  # cursor for synthetic sequential children

    @property
    def duration_s(self) -> float:
        return (self.end if self.end is not None else time.monotonic()) - self.start

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def mark(self, status: str, **attrs: Any) -> None:
        if status not in _STATUSES:
            raise ValueError(f"unknown span status {status!r}; known: {_STATUSES}")
        self.status = status
        self.attrs.update(attrs)

    def child_from_seconds(self, name: str, seconds: float, status: str = "ok",
                           **attrs: Any) -> "Span":
        """Attach a synthetic completed child of ``seconds`` duration, laid
        out sequentially from this span's start — for phase timings measured
        elsewhere (no start timestamps)."""
        child = Span(name, self._lay, attrs or None)
        child.end = self._lay + seconds
        child.status = status
        self._lay = child.end
        self.children.append(child)
        return child

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {self.duration_s * 1000:.2f}ms, {self.status})"


class _NoopSpan:
    """Shared do-nothing span: what instrumentation points get when no
    trace is ambient. Also its own context manager, so ``with span(...)``
    costs no allocation when tracing is dormant."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass

    def mark(self, status: str, **attrs: Any) -> None:
        pass

    def child_from_seconds(self, name: str, seconds: float, status: str = "ok",
                           **attrs: Any) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class _SpanScope:
    """Context manager opening a real span on the ambient trace's stack."""

    __slots__ = ("trace", "span")

    def __init__(self, trace: "TraceContext", name: str, attrs: Optional[dict]) -> None:
        self.trace = trace
        self.span = Span(name, time.monotonic(), attrs)

    def __enter__(self) -> Span:
        stack = self.trace._stack
        stack[-1].children.append(self.span)
        stack.append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self.span
        stack = self.trace._stack
        if stack and stack[-1] is sp:
            stack.pop()
        sp.end = time.monotonic()
        if exc_type is not None and sp.status == "ok":
            # DeadlineExceeded is matched by name, not import: obs must not
            # depend on the resilience layer (it is imported beneath it)
            sp.status = (
                "deadline-exceeded" if exc_type.__name__ == "DeadlineExceeded" else "error"
            )
            sp.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        return False


class TraceContext:
    """One request's span tree plus its identity and clock anchors."""

    def __init__(self, endpoint: str, request_id: Optional[str] = None) -> None:
        self.request_id = sanitize_request_id(request_id) or new_request_id()
        self.endpoint = endpoint
        self.started_unix = time.time()
        self.root = Span(endpoint, time.monotonic())
        self.http_status: Optional[int] = None
        self._stack: List[Span] = [self.root]

    # -- recording ----------------------------------------------------------

    def span(self, name: str, attrs: Optional[dict] = None) -> _SpanScope:
        return _SpanScope(self, name, attrs)

    def current_span(self) -> Span:
        return self._stack[-1]

    def finish(self, status: str = "ok", http_status: Optional[int] = None) -> None:
        """Close the root (and any span an escaped exception left open —
        they inherit the final status so a crash never yields a tree that
        claims its interrupted phases succeeded)."""
        now = time.monotonic()
        while len(self._stack) > 1:
            sp = self._stack.pop()
            sp.end = now
            if sp.status == "ok" and status != "ok":
                sp.status = status
        self.root.end = now
        if self.root.status == "ok":
            self.root.status = status
        self.http_status = http_status
        self._stack = [self.root]

    @property
    def finished(self) -> bool:
        return self.root.end is not None

    def walk(self) -> Iterator[Span]:
        return self.root.walk()

    # -- exporters ----------------------------------------------------------

    def summary(self) -> dict:
        out = {
            "request_id": self.request_id,
            "endpoint": self.endpoint,
            "status": self.root.status,
            "http_status": self.http_status,
            "started_unix": round(self.started_unix, 3),
            "duration_s": round(self.root.duration_s, 6),
            "spans": sum(1 for _ in self.walk()) - 1,
        }
        if "engine" in self.root.attrs:
            out["engine"] = self.root.attrs["engine"]
        return out

    def tree(self) -> dict:
        """Full span tree for ``/api/debug/requests/<id>``."""

        def node(sp: Span) -> dict:
            d: dict = {
                "name": sp.name,
                "status": sp.status,
                "start_s": round(sp.start - self.root.start, 6),
                "duration_s": round(sp.duration_s, 6),
            }
            if sp.attrs:
                d["attrs"] = {k: _jsonable(v) for k, v in sp.attrs.items()}
            if sp.children:
                d["children"] = [node(c) for c in sp.children]
            return d

        out = self.summary()
        out["spans"] = node(self.root)
        return out

    def to_chrome(self) -> dict:
        """Chrome-trace JSON (chrome://tracing, Perfetto UI): one complete
        ("X") event per span, timestamps in microseconds from trace start."""
        events: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": 1, "args": {"name": f"simon {self.endpoint}"}},
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1, "args": {"name": f"request {self.request_id}"}},
        ]
        for sp in self.walk():
            events.append({
                "name": sp.name,
                "cat": "simon",
                "ph": "X",
                "pid": 1,
                "tid": 1,
                "ts": round((sp.start - self.root.start) * 1e6, 3),
                "dur": round(sp.duration_s * 1e6, 3),
                "args": {"status": sp.status, **{k: _jsonable(v) for k, v in sp.attrs.items()}},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def _jsonable(v: Any) -> Any:
    return v if isinstance(v, (str, int, float, bool, type(None))) else str(v)


# ---------------------------------------------------------------------------
# ambient trace (contextvar) + module-level recording API
# ---------------------------------------------------------------------------

_CURRENT: contextvars.ContextVar[Optional[TraceContext]] = contextvars.ContextVar(
    "opensim_trace", default=None
)

_REQUEST_ID_OK = re.compile(r"[^A-Za-z0-9._:\-]")


def enabled() -> bool:
    """Tracing is on unless ``OPENSIM_TRACE=0`` (the dormant mode whose whole
    cost is one contextvar read per instrumentation point)."""
    return envknobs.raw("OPENSIM_TRACE", "1") != "0"


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


def sanitize_request_id(raw: Optional[str]) -> str:
    """A client-supplied ``X-Simon-Request-Id`` is echoed into a response
    header and a URL path segment: strip anything that could smuggle header
    or path structure, and bound the length."""
    if not raw:
        return ""
    return _REQUEST_ID_OK.sub("", raw)[:64]


def start_trace(
    endpoint: str, request_id: Optional[str] = None, force: bool = False
) -> Optional[TraceContext]:
    """New TraceContext, or None when tracing is disabled (``force=True``
    overrides the env — an explicit ``--trace out.json`` flag wins)."""
    if not force and not enabled():
        return None
    return TraceContext(endpoint, request_id=request_id)


class _TraceScope:
    """Install a trace as the ambient one for a ``with`` body; ``None`` is a
    no-op scope so call sites never need to branch."""

    __slots__ = ("trace", "_token")

    def __init__(self, trace: Optional[TraceContext]) -> None:
        self.trace = trace
        self._token = None

    def __enter__(self) -> Optional[TraceContext]:
        if self.trace is not None:
            self._token = _CURRENT.set(self.trace)
        return self.trace

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        return False


def trace_scope(trace: Optional[TraceContext]) -> _TraceScope:
    return _TraceScope(trace)


def current_trace() -> Optional[TraceContext]:
    return _CURRENT.get()


def current_span():
    tr = _CURRENT.get()
    return NOOP_SPAN if tr is None else tr.current_span()


def span(name: str, **attrs: Any):
    """``with span("schedule", pods=n) as sp:`` — a real span when a trace
    is ambient, the shared no-op otherwise (one contextvar read)."""
    tr = _CURRENT.get()
    if tr is None:
        return NOOP_SPAN
    return tr.span(name, attrs or None)


def event(name: str, status: str = "ok", **attrs: Any) -> None:
    """Instant (zero-duration) span under the current span: retries,
    demotions, cache invalidations, fault injections."""
    tr = _CURRENT.get()
    if tr is None:
        return
    now = time.monotonic()
    sp = Span(name, now, attrs or None)
    sp.end = now
    sp.status = status
    tr.current_span().children.append(sp)


def record_span(name: str, seconds: float, status: str = "ok", **attrs: Any) -> None:
    """Append a completed span that ended *now* and lasted ``seconds`` —
    for code that measured a duration itself (``PREP_STATS.record``)."""
    tr = _CURRENT.get()
    if tr is None:
        return
    now = time.monotonic()
    sp = Span(name, now - seconds, attrs or None)
    sp.end = now
    sp.status = status
    tr.current_span().children.append(sp)


def write_chrome(trace: TraceContext, path: str) -> None:
    import json

    with open(path, "w") as f:
        json.dump(trace.to_chrome(), f)
