"""Capacity timeline — a fixed-size ring of per-generation samples (the
port's copy of ``opensim_tpu/obs/timeline.py``).

The capacity engine (``obs/capacity.py``) derives one :class:`Sample` per
observed twin generation; this module keeps the last N of them so
``GET /api/debug/capacity`` can serve a trend window (utilization climbing,
headroom draining, fragmentation building) without a time-series database
in the loop. The ring is generation-keyed: a generation is sampled at most
once, so an idle cluster does not flood the ring with identical rows, and a
busy one is naturally downsampled to the cadence of whoever looks (samples
are taken when someone looks — a scrape, a report — never per event).

Bounded like the flight recorder (``obs/recorder.py``):
``OPENSIM_CAPACITY_TIMELINE_N`` caps retained samples (default 512).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..utils import envknobs

log = logging.getLogger("opensim_tpu_torch.obs")

__all__ = ["Sample", "Timeline", "timeline_capacity"]


def timeline_capacity() -> int:
    """``OPENSIM_CAPACITY_TIMELINE_N`` (default 512). A typo degrades to
    the default with a warning — same contract as
    ``OPENSIM_FLIGHT_RECORDER_N``, never a startup crash."""
    raw = envknobs.raw("OPENSIM_CAPACITY_TIMELINE_N")
    try:
        return max(1, int(raw)) if raw else 512
    except ValueError:
        log.warning("ignoring unparseable OPENSIM_CAPACITY_TIMELINE_N=%r (using 512)", raw)
        return 512


@dataclass
class Sample:
    """One generation's derived capacity view (all floats are ratios in
    [0, 1+] unless named otherwise). ``utilization``/``spread``/
    ``fragmentation`` are keyed by resource name (cpu/memory/pods);
    ``headroom`` by registered profile name (absent until first probed);
    ``hottest`` is the top-K ``(node, {resource: util})`` list."""

    generation: int
    ts: float = field(default_factory=time.time)
    nodes: int = 0
    pods_bound: int = 0
    pods_pending: int = 0
    allocatable: Dict[str, float] = field(default_factory=dict)
    requested: Dict[str, float] = field(default_factory=dict)
    utilization: Dict[str, float] = field(default_factory=dict)
    spread: Dict[str, float] = field(default_factory=dict)
    fragmentation: Dict[str, float] = field(default_factory=dict)
    headroom: Dict[str, int] = field(default_factory=dict)
    hottest: List[Tuple[str, Dict[str, float]]] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "generation": self.generation,
            "ts": round(self.ts, 3),
            "nodes": self.nodes,
            "pods_bound": self.pods_bound,
            "pods_pending": self.pods_pending,
            "allocatable": {k: round(v, 6) for k, v in sorted(self.allocatable.items())},
            "requested": {k: round(v, 6) for k, v in sorted(self.requested.items())},
            "utilization": {k: round(v, 6) for k, v in sorted(self.utilization.items())},
            "spread": {k: round(v, 6) for k, v in sorted(self.spread.items())},
            "fragmentation": {k: round(v, 6) for k, v in sorted(self.fragmentation.items())},
            "headroom": dict(sorted(self.headroom.items())),
            "hottest": [
                {"node": n, "utilization": {k: round(v, 6) for k, v in sorted(u.items())}}
                for n, u in self.hottest
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Sample":
        """Inverse of :meth:`to_dict` (the journal's checkpoint restore,
        ``server/journal.py``, ROADMAP Queue 1 item 10). Unknown/malformed fields degrade to the
        dataclass defaults — a checkpoint written by an older build must
        still restore the samples it does carry."""
        s = cls(generation=int(d.get("generation") or 0))
        s.ts = float(d.get("ts") or 0.0)
        s.nodes = int(d.get("nodes") or 0)
        s.pods_bound = int(d.get("pods_bound") or 0)
        s.pods_pending = int(d.get("pods_pending") or 0)
        for attr in ("allocatable", "requested", "utilization", "spread", "fragmentation"):
            val = d.get(attr)
            if isinstance(val, dict):
                setattr(s, attr, {str(k): float(v) for k, v in val.items()})
        if isinstance(d.get("headroom"), dict):
            s.headroom = {str(k): int(v) for k, v in d["headroom"].items()}
        if isinstance(d.get("hottest"), list):
            s.hottest = [
                (str(h.get("node") or ""), {str(k): float(v) for k, v in (h.get("utilization") or {}).items()})
                for h in d["hottest"]
                if isinstance(h, dict)
            ]
        return s


class Timeline:
    """The bounded, generation-keyed sample ring. Appends under its own
    lock (samples arrive from concurrent request threads); a
    repeat generation replaces the newest entry in place rather than
    appending (headroom probes enrich an existing generation's sample)."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = timeline_capacity() if capacity is None else max(1, capacity)
        self._lock = threading.Lock()
        self._ring: "collections.deque[Sample]" = collections.deque(maxlen=self.capacity)  # guarded-by: _lock

    def append(self, sample: Sample) -> None:
        with self._lock:
            if self._ring and self._ring[-1].generation == sample.generation:
                self._ring[-1] = sample
                return
            self._ring.append(sample)

    def latest(self) -> Optional[Sample]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def snapshot(self) -> List[Sample]:
        """Oldest-first copy (the debug endpoint serializes it)."""
        with self._lock:
            return list(self._ring)

    def restore(self, samples: List[Sample]) -> None:
        """Seed the ring from a journal checkpoint (oldest first) — only
        samples strictly newer than the current tail append, so a restore
        can never rewind a ring that already has fresher generations."""
        with self._lock:
            for s in samples:
                if self._ring and s.generation <= self._ring[-1].generation:
                    continue
                self._ring.append(s)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
