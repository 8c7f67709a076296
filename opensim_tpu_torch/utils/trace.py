"""Host-side prepare attribution and the profiler hook — the
``PREP_STATS`` and ``start_profiler`` of ``opensim_tpu/utils/trace.py``.
The reference's hook starts the JAX profiler's server; the port's starts a
``torch.profiler`` session over every thread of the process (the CPU's
activities and, on the card, CUDA's) and exports it as a Chrome trace
when stopped (``GET /debug/profiler``, ``?stop=1``)."""

from __future__ import annotations

import os
import threading
import time
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


class Profiler:
    """One ``torch.profiler`` session at a time in the process (the
    profiler itself is process-wide). :meth:`start` is idempotent: a
    second start while a session runs answers the running session."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._prof = None  # guarded-by: _lock
        self._info: Optional[dict] = None  # guarded-by: _lock

    def start(self, trace_dir: str, cuda: bool) -> dict:
        """Start a session recording every thread's operators (with
        `cuda`, the card's kernels too), whose trace :meth:`stop` writes
        under `trace_dir`. Returns the running session's description."""
        with self._lock:
            if self._prof is None:
                from torch._C._profiler import _ExperimentalConfig
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
                # requests run on handler and pool threads, not the one
                # that starts the session
                prof = profile(activities=activities,
                               experimental_config=_ExperimentalConfig(profile_all_threads=True))
                prof.start()
                self._prof = prof
                self._info = {"profiler": "running", "activities": ["cpu"] + (["cuda"] if cuda else []),
                              "trace_dir": trace_dir, "started_unix": round(time.time(), 3)}
            return dict(self._info)

    def stop(self) -> Optional[dict]:
        """Stop the running session and write its Chrome trace; None when
        no session runs."""
        with self._lock:
            prof, info = self._prof, self._info
            self._prof = self._info = None
            if prof is None:
                return None
            prof.stop()
            os.makedirs(info["trace_dir"], exist_ok=True)
            path = os.path.join(info["trace_dir"], f"simon-profile-{time.time_ns()}.json")
            prof.export_chrome_trace(path)
        return {**info, "profiler": "stopped", "trace": path, "seconds": round(time.time() - info["started_unix"], 3)}


PROFILER = Profiler()


def start_profiler(trace_dir: str, cuda: bool = False) -> dict:
    """Start (or join) the process's profiler session (:class:`Profiler`)."""
    return PROFILER.start(trace_dir, cuda)


def stop_profiler() -> Optional[dict]:
    """Stop the process's profiler session and export its trace."""
    return PROFILER.stop()
