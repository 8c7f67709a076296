"""Fleet-wide trace stitching and the event-to-servable freshness pipeline
— the port's copy of ``opensim_tpu/obs/fleetobs.py``.

A request served by the fleet has a story that spans three processes: the
twin owner accepts a watch event, journals it, and publishes generation
*g* over shared memory; a worker attaches *g* and serves requests from it.
The acts are stitched together with plain data:

- the owner stamps every ACCEPTED watch event with a 12-hex **event id**
  and its wall-clock acceptance time (``WatchSupervisor._apply``); the id
  rides the journal record (``{"eid": ...}``) and, once the event's
  generation is published, the seqlock control-block payload
  (``payload["trace"]``) together with a fresh **publication span id**;
- workers record the carried ids on attach and hand them to every request
  trace via ``FleetTwinClient.stitch_info``, so the flight recorder can
  graft the owner-side publication under the worker-side tree
  (:func:`publication_tree`);
- each milestone observes ``simon_fleet_freshness_seconds{stage=}``:
  ``journaled`` and ``published`` (owner), ``attached`` and ``served``
  (worker), each measured from the event's acceptance time. Owner and
  workers share a host, so wall clocks compare.

Everything here mutates under the one recorder lock
(``obs.metrics.RECORDER.lock``) and is bounded.
"""

from __future__ import annotations

import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .metrics import FRESHNESS_BUCKETS, RECORDER, HistogramVec, family_header

__all__ = [
    "FRESHNESS",
    "FreshnessTracker",
    "PUB_EVENTS_MAX",
    "STAGES",
    "new_event_id",
    "publication_tree",
]

#: the fixed stage vocabulary (cardinality contract for the histogram)
STAGES = ("journaled", "published", "attached", "served")

#: event ids carried per publication payload — the payload rides the
#: seqlock control block, and a rebase folding thousands of events must
#: not balloon it past the block's fixed size
PUB_EVENTS_MAX = 32

#: accepted-but-unpublished events remembered on the owner (a fleet
#: publishes every OPENSIM_FLEET_PUBLISH_MS, so this only fills when
#: there is no publisher — the single-process server — and then it is
#: simply a bounded no-op)
PENDING_MAX = 4096

#: publications remembered per process for stitching (mirrors the flight
#: recorder's bounded-ring philosophy)
PUBS_MAX = 256


def new_event_id() -> str:
    """A 12-hex id for one accepted event or one publication span —
    the same shape as request ids (uuid4 hex prefix), distinguishable
    by context."""
    return uuid.uuid4().hex[:12]


class FreshnessTracker:
    """The per-process half of the freshness pipeline. The owner calls
    :meth:`event_accepted` / :meth:`event_journaled` / :meth:`publication`;
    workers call :meth:`attached` / :meth:`note_served`. One process never
    calls both sides (the single-process server is "owner side only", and
    its pipeline ends at the journal stage)."""

    def __init__(self) -> None:
        self.lock = RECORDER.lock  # the one metrics lock (an RLock)
        self.hist = HistogramVec("simon_fleet_freshness_seconds", ("stage",), buckets=FRESHNESS_BUCKETS)
        # eid -> (generation, ts_accepted)   # guarded-by: lock
        self._pending: "OrderedDict[str, Tuple[int, float]]" = OrderedDict()
        # generation -> publication info     # guarded-by: lock
        self._pubs: "OrderedDict[int, dict]" = OrderedDict()
        self._served: set = set()  # generations already first-served  # guarded-by: lock

    # -- owner side ----------------------------------------------------------

    def event_accepted(self, eid: str, generation: int, ts: float) -> None:
        """An accepted watch event (``apply_event`` returned a change),
        stamped at its wall-clock acceptance time."""
        with self.lock:
            self._pending[eid] = (generation, ts)
            while len(self._pending) > PENDING_MAX:
                self._pending.popitem(last=False)

    def event_journaled(self, ts_accepted: float, now: Optional[float] = None) -> None:
        """The journal writer durably wrote the event's record."""
        with self.lock:
            self.hist.observe((now or time.time()) - ts_accepted, ("journaled",))

    def publication(self, generation: int, now: Optional[float] = None) -> dict:
        """Fold every pending event with generation ≤ ``generation`` into
        a publication stamp: observes the ``published`` stage per event
        and returns the trace dict the publisher embeds in the control-
        block payload (span id, publish wall time, carried event ids)."""
        now = now or time.time()
        with self.lock:
            events: List[Tuple[str, float]] = []
            for eid in [
                e for e, (g, _) in self._pending.items() if g <= generation
            ]:
                _, ts = self._pending.pop(eid)
                self.hist.observe(now - ts, ("published",))
                events.append((eid, ts))
            events = events[-PUB_EVENTS_MAX:]
            info = {
                "span": new_event_id(),
                "pub_ts": round(now, 6),
                "events": [[eid, round(ts, 6)] for eid, ts in events],
            }
            self._remember_locked(generation, info)
            return info

    # -- worker side ---------------------------------------------------------

    def attached(self, generation: int, info: Optional[dict],
                 now: Optional[float] = None) -> None:
        """A worker attached (or re-attached) the publication carrying
        ``info`` (the payload's ``trace`` dict). First sight of a
        generation observes the ``attached`` stage per carried event."""
        if not isinstance(info, dict):
            return
        now = now or time.time()
        with self.lock:
            first = generation not in self._pubs
            rec = dict(info)
            rec.setdefault("attached_ts", round(now, 6))
            self._remember_locked(generation, rec)
            if first:
                for _eid, ts in rec.get("events") or []:
                    self.hist.observe(now - float(ts), ("attached",))

    def note_served(self, generation: int,
                    now: Optional[float] = None) -> Optional[dict]:
        """A request is being served at ``generation``: the FIRST such
        request per generation closes the pipeline (``served`` stage per
        carried event). Returns the remembered publication info (for
        request-trace stitching) or None when this generation's
        publication was never seen."""
        with self.lock:
            info = self._pubs.get(generation)
            if generation not in self._served:
                self._served.add(generation)
                now = now or time.time()
                if info is not None:
                    info.setdefault("served_ts", round(now, 6))
                    for _eid, ts in info.get("events") or []:
                        self.hist.observe(now - float(ts), ("served",))
            return info

    # -- shared --------------------------------------------------------------

    def _remember_locked(self, generation: int, info: dict) -> None:
        self._pubs[generation] = info
        while len(self._pubs) > PUBS_MAX:
            old, _ = self._pubs.popitem(last=False)
            self._served.discard(old)

    def pub_info(self, generation: int) -> Optional[dict]:
        with self.lock:
            info = self._pubs.get(generation)
            return dict(info) if info is not None else None

    def metrics_lines(self) -> List[str]:
        """``simon_fleet_freshness_seconds`` exposition lines (header-only
        until a stage has observations, like every sparse family)."""
        with self.lock:
            lines = self.hist.render_lines()
        return lines or family_header("simon_fleet_freshness_seconds")

    def reset(self) -> None:
        """Test isolation (mirrors ``RECORDER.reset``)."""
        with self.lock:
            self.hist.reset()
            self._pending.clear()
            self._pubs.clear()
            self._served.clear()


#: THE per-process tracker (owner-side stages in the twin-owner process,
#: worker-side stages in each worker; the single-process server uses the
#: owner side and stops at the journal stage)
FRESHNESS = FreshnessTracker()


def publication_tree(generation) -> Optional[dict]:
    """The owner-side publication rendered as one synthetic span subtree,
    graftable under a worker-side request trace (``GET
    /api/debug/requests/<id>`` adds it as the ``fleet`` section): the
    publication span plus one child per carried watch event, with the
    per-stage latencies the freshness pipeline measured."""
    try:
        gen = int(generation)
    except (TypeError, ValueError):
        return None
    info = FRESHNESS.pub_info(gen)
    if info is None:
        return None
    pub_ts = float(info.get("pub_ts") or 0.0)
    attached_ts = info.get("attached_ts")
    served_ts = info.get("served_ts")
    events = []
    for eid, ts in info.get("events") or []:
        ev = {
            "event_id": eid,
            "accepted_unix": float(ts),
            "accept_to_publish_s": round(pub_ts - float(ts), 6),
        }
        if attached_ts is not None:
            ev["accept_to_attach_s"] = round(float(attached_ts) - float(ts), 6)
        if served_ts is not None:
            ev["accept_to_serve_s"] = round(float(served_ts) - float(ts), 6)
        events.append(ev)
    node = {
        "name": "fleet.publication",
        "span": info.get("span"),
        "generation": gen,
        "published_unix": pub_ts,
        "events": events,
    }
    if attached_ts is not None:
        node["attached_unix"] = float(attached_ts)
    if served_ts is not None:
        node["first_served_unix"] = float(served_ts)
    return node
