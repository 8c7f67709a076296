"""Event ids and the event-to-servable freshness histogram — the part of
``opensim_tpu/obs/fleetobs.py`` the live twin and its journal use.

The watch supervisor stamps every ACCEPTED watch event with a 12-hex
**event id** and its wall-clock acceptance time (``WatchSupervisor._apply``);
the id rides the journal record (``{"eid": ...}``), and the journal writer
observes the ``journaled`` stage of ``simon_fleet_freshness_seconds`` once
the record is written, measured from the acceptance time. A
single-process server's pipeline ends there: the ``published``,
``attached`` and ``served`` stages, and the trace stitching across
processes, belong to the serving fleet, which the port does not have yet.

Everything here mutates under the one recorder lock
(``obs.metrics.RECORDER.lock``).
"""

from __future__ import annotations

import time
import uuid
from typing import List, Optional

from .metrics import FRESHNESS_BUCKETS, RECORDER, HistogramVec, family_header

__all__ = ["FRESHNESS", "FreshnessTracker", "new_event_id"]


def new_event_id() -> str:
    """A 12-hex id for one accepted event — the shape of a request id."""
    return uuid.uuid4().hex[:12]


class FreshnessTracker:
    """The owner side of the freshness pipeline: the journaled stage."""

    def __init__(self) -> None:
        self.lock = RECORDER.lock  # the one metrics lock (an RLock)
        self.hist = HistogramVec("simon_fleet_freshness_seconds", ("stage",), buckets=FRESHNESS_BUCKETS)

    def event_journaled(self, ts_accepted: float, now: Optional[float] = None) -> None:
        """The journal writer wrote the record of an event accepted at
        `ts_accepted`."""
        with self.lock:
            self.hist.observe((now or time.time()) - ts_accepted, ("journaled",))

    def metrics_lines(self) -> List[str]:
        """``simon_fleet_freshness_seconds`` (header only until a stage
        has observations)."""
        with self.lock:
            lines = self.hist.render_lines()
        return lines or family_header("simon_fleet_freshness_seconds")


#: the per-process tracker
FRESHNESS = FreshnessTracker()
