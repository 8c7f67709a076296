"""In-process flight recorder: the last N request traces — the port's copy
of ``opensim_tpu/obs/recorder.py``.

A bounded ring buffer of finished :class:`~opensim_tpu_torch.obs.trace.TraceContext`
objects, served by the REST layer at

- ``GET /api/debug/requests``        — newest-first summary list
- ``GET /api/debug/requests/<id>``   — one request's full span tree
- ``GET /api/debug/placements/<id>`` — an ``explain=1`` request's audit

Capacity comes from ``OPENSIM_FLIGHT_RECORDER_N`` (default 64); traces are
recorded only after ``finish()``, so everything the endpoints read is
immutable. Each recorded trace is also folded into the cumulative phase
profiles (``obs/profile.py``).
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Dict, List, Optional

from ..utils import envknobs

__all__ = ["FlightRecorder", "FLIGHT_RECORDER"]


def _default_capacity() -> int:
    # a typo'd debug knob degrades to the default with a warning, never
    # taking down library use
    raw = envknobs.raw("OPENSIM_FLIGHT_RECORDER_N")
    try:
        return max(1, int(raw)) if raw else 64
    except ValueError:
        logging.getLogger("opensim_tpu_torch.obs").warning(
            "ignoring unparseable OPENSIM_FLIGHT_RECORDER_N=%r (using 64)", raw
        )
        return 64


class FlightRecorder:
    """Thread-safe bounded ring of finished traces, indexed by request id
    (a client that reuses an id sees its most recent trace)."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = capacity if capacity is not None else _default_capacity()
        self._lock = threading.Lock()
        self._ring: deque = deque()  # guarded-by: _lock
        self._by_id: Dict[str, object] = {}  # guarded-by: _lock

    def record(self, trace) -> None:
        if not trace.finished:
            raise ValueError("only finished traces are recordable (call finish() first)")
        # one sink for the ring and the cumulative profiles, outside this
        # ring's lock (PROFILE locks itself)
        from .profile import PROFILE

        PROFILE.observe_trace(trace)
        with self._lock:
            self._ring.append(trace)
            self._by_id[trace.request_id] = trace
            while len(self._ring) > self.capacity:
                old = self._ring.popleft()
                if self._by_id.get(old.request_id) is old:
                    del self._by_id[old.request_id]

    def get(self, request_id: str):
        with self._lock:
            return self._by_id.get(request_id)

    def summaries(self) -> List[dict]:
        with self._lock:
            traces = list(self._ring)
        return [t.summary() for t in reversed(traces)]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_id.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


FLIGHT_RECORDER = FlightRecorder()
