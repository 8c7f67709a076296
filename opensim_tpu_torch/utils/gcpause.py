"""Pause the cyclic collector across bulk allocate-and-retain phases — the
port's copy of ``opensim_tpu/utils/gcpause.py``.

Workload expansion and encoding materialise about ten container objects a
pod and keep them all, so the generational collector re-scans a growing
heap several times a phase, and a full collection walks every object the
process holds (a server's snapshot, its encode cache). These objects are
acyclic and nothing is freed mid-phase, so pausing loses nothing:
refcounting still reclaims the non-cyclic garbage at once.

:class:`CollectorWatch` counts and times the collections a process does
run, by generation, for the fleet owner's status.
"""

from __future__ import annotations

import gc
import time
from contextlib import contextmanager


@contextmanager
def gc_paused():
    """Disable cyclic collection for the duration; nestable and exception
    safe. No-op when collection is already disabled (an outer pause wins)."""
    if not gc.isenabled():
        yield
        return
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


class CollectorWatch:
    """The cyclic collector's runs in this process, by generation: count,
    seconds in all and the longest, through ``gc.callbacks`` (a
    collection holds the GIL, so its length is a stall of every other
    thread); and the objects ``gc.freeze`` moved out of its reach."""

    def __init__(self) -> None:
        self.collections = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self.max_s = [0.0, 0.0, 0.0]
        self._t0 = None

    def _callback(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        if self._t0 is None:
            return
        dt, self._t0 = time.perf_counter() - self._t0, None
        g = info["generation"]
        self.collections[g] += 1
        self.seconds[g] += dt
        self.max_s[g] = max(self.max_s[g], dt)

    def install(self) -> "CollectorWatch":
        gc.callbacks.append(self._callback)
        return self

    def uninstall(self) -> None:
        if self._callback in gc.callbacks:
            gc.callbacks.remove(self._callback)

    def snapshot(self) -> dict:
        return {"collections": list(self.collections), "seconds": [round(s, 6) for s in self.seconds],
                "max_s": [round(s, 6) for s in self.max_s], "frozen": gc.get_freeze_count()}
