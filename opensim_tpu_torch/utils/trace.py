"""Host-side prepare attribution — the ``PREP_STATS`` of
``opensim_tpu/utils/trace.py``. The profiler hook there
(``start_profiler``, the JAX profiler) is ROADMAP Queue 1 item 10."""

from __future__ import annotations

import threading
from typing import Optional, Tuple


class PrepStats:
    """Every way a simulation can obtain its ``Prepared`` records here:

      ``full``        — a cold expand+encode of the whole cluster
      ``delta_apps``  — delta re-encode: pods appended to a cached base
      ``delta_nodes`` — delta re-encode: nodes added to a cached base
      ``hit``         — encode-cache hit (fingerprint + bind-state restore)

    The REST server exports the total as ``simon_prepare_seconds_total``;
    tests and the smoke run read ``counts`` and ``last`` to see whether a
    request re-encoded."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.seconds: dict = {}
            self.counts: dict = {}
            self.last: Optional[Tuple[str, float]] = None

    def record(self, kind: str, seconds: float) -> None:
        with self._lock:
            self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.last = (kind, seconds)
        # every way a simulation obtained its Prepared appears in the
        # request's span tree (no-op without an ambient trace)
        from ..obs import trace as _obs

        _obs.record_span(f"prep.{kind}", seconds, kind=kind)

    def total_seconds(self) -> float:
        with self._lock:
            return sum(self.seconds.values())

    def snapshot(self) -> dict:
        with self._lock:
            return {"seconds": dict(self.seconds), "counts": dict(self.counts), "last": self.last}


PREP_STATS = PrepStats()
