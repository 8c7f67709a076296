"""Pause the cyclic collector across bulk allocate-and-retain phases — the
port's copy of ``opensim_tpu/utils/gcpause.py``.

Workload expansion and encoding materialise about ten container objects a
pod and keep them all, so the generational collector re-scans a growing
heap several times a phase, and a full collection walks every object the
process holds (a server's snapshot, its encode cache). These objects are
acyclic and nothing is freed mid-phase, so pausing loses nothing:
refcounting still reclaims the non-cyclic garbage at once.
"""

from __future__ import annotations

import gc
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
