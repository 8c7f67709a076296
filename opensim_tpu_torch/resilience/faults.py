"""Deterministic fault injection at named points in the serving path — the
port's copy of ``opensim_tpu/resilience/faults.py``, with the points the
port's modules fire:

=====================  ======================================================
point                  fires inside
=====================  ======================================================
``snapshot.http``      ``SimonServer._refresh_snapshot``'s apiserver fetch
                       (inside the retry loop — N injections consume N
                       attempts)
``prep.encode``        ``engine/simulator.prepare`` before the encoder build
``cache.stale``        ``PrepareCache.check_fresh`` (raises
                       ``StaleFingerprintError`` like a mid-flight touch)
``watch.disconnect``   the watch event read loop (``server/watch.py``) — the
                       stream drops mid-flight and must reconnect
``watch.gone``         the watch event read loop — the apiserver expires the
                       resourceVersion (``410 Gone``) and the consumer must
                       relist and rebase
``watch.drop_event``   watch event dispatch — the event is LOST (the consumer
                       skips it), so only the anti-entropy pass can notice
``watch.reorder``      watch event dispatch — the event is delivered AFTER
                       its successor (an out-of-order stream)
``journal.write``      the journal writer thread's record write
                       (``server/journal.py``) — the twin keeps serving,
                       recording degrades loudly
``journal.fsync``      the journal writer's fsync — as ``journal.write``
``journal.corrupt``    ``Journal.recover`` — recovery from a poisoned journal
                       degrades to a full relist with a typed warning
=====================  ======================================================

Activation, either route:

- environment: ``OPENSIM_FAULTS=point:count:exc[,point:count:exc...]`` —
  re-read whenever the variable's raw value changes;
- test API: ``inject(point, count, exc)`` / ``clear_faults()``.

``count`` is the number of times the point fires before going inert;
``exc`` names the exception class per ``_EXCEPTIONS`` below. Unknown
points or exception names fail loudly at parse time.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ..utils import envknobs

__all__ = [
    "FAULT_POINTS",
    "FaultError",
    "clear_faults",
    "fault_point",
    "fault_stats",
    "inject",
]

FAULT_POINTS = (
    "snapshot.http",
    "prep.encode",
    "cache.stale",
    "watch.disconnect",
    "watch.gone",
    "watch.drop_event",
    "watch.reorder",
    "journal.write",
    "journal.fsync",
    "journal.corrupt",
)


class FaultError(RuntimeError):
    """Default injected exception (``exc`` name ``fault``/``runtime``)."""


def _stale_exc(message: str) -> BaseException:
    # lazy: faults must stay import-light (the simulator imports it) and
    # prepcache imports the simulator
    from ..engine.prepcache import StaleFingerprintError

    return StaleFingerprintError(message)


def _fetch_exc(message: str) -> BaseException:
    from ..server.snapshot import SnapshotFetchError

    return SnapshotFetchError(message)


def _url_exc(message: str) -> BaseException:
    import urllib.error

    return urllib.error.URLError(message)


_EXCEPTIONS: Dict[str, Callable[[str], BaseException]] = {
    "fault": FaultError,
    "runtime": RuntimeError,
    "oserror": OSError,
    "timeout": TimeoutError,
    "urlerror": _url_exc,
    "fetch": _fetch_exc,
    "stale": _stale_exc,
}


class _FaultSpec:
    def __init__(self, point: str, count: int, exc: str) -> None:
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}; known: {FAULT_POINTS}")
        if exc not in _EXCEPTIONS:
            raise ValueError(f"unknown fault exception {exc!r}; known: {sorted(_EXCEPTIONS)}")
        if count < 1:
            raise ValueError(f"fault count must be >= 1, got {count}")
        self.point = point
        self.remaining = count
        self.exc = exc


_LOCK = threading.RLock()
_ACTIVE: Dict[str, _FaultSpec] = {}
_FIRED: Dict[str, int] = {}
_ENV_RAW: Optional[str] = None  # last OPENSIM_FAULTS value parsed


def parse_spec(raw: str) -> Dict[str, _FaultSpec]:
    """``point:count:exc,...`` → specs. Count and exc are optional
    (``point`` alone means fire once with FaultError)."""
    specs: Dict[str, _FaultSpec] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) > 3:
            raise ValueError(f"bad fault spec {part!r}: want point[:count[:exc]]")
        point = bits[0].strip()
        try:
            count = int(bits[1]) if len(bits) > 1 and bits[1].strip() else 1
        except ValueError:
            raise ValueError(f"bad fault count in {part!r}") from None
        exc = bits[2].strip().lower() if len(bits) > 2 and bits[2].strip() else "fault"
        specs[point] = _FaultSpec(point, count, exc)
    return specs


def _sync_env_locked() -> None:
    global _ENV_RAW
    raw = envknobs.raw("OPENSIM_FAULTS")
    if raw == _ENV_RAW:
        return
    _ENV_RAW = raw
    _ACTIVE.clear()
    _ACTIVE.update(parse_spec(raw))


def inject(point: str, count: int = 1, exc: str = "fault") -> None:
    """Test API: arm ``point`` to fire ``count`` times raising ``exc``."""
    with _LOCK:
        _sync_env_locked()
        _ACTIVE[point] = _FaultSpec(point, count, exc)


def clear_faults() -> None:
    """Disarm every injection (env-armed ones stay cleared until the env
    value changes) and zero the fired counters."""
    global _ENV_RAW
    with _LOCK:
        _ACTIVE.clear()
        _FIRED.clear()
        _ENV_RAW = envknobs.raw("OPENSIM_FAULTS")


def fault_stats() -> Dict[str, int]:
    """{point: times fired} — exported at /metrics so a chaos run can assert
    its faults actually landed."""
    with _LOCK:
        return dict(_FIRED)


def fault_point(name: str) -> None:
    """The per-site hook. Inert (one env read + dict lookup) unless armed."""
    if _ENV_RAW == "" and not _ACTIVE and not envknobs.raw("OPENSIM_FAULTS"):
        return  # fast path: nothing armed, nothing in the environment
    with _LOCK:
        _sync_env_locked()
        spec = _ACTIVE.get(name)
        if spec is None or spec.remaining <= 0:
            return
        spec.remaining -= 1
        if spec.remaining == 0:
            del _ACTIVE[name]
        _FIRED[name] = _FIRED.get(name, 0) + 1
        factory = _EXCEPTIONS[spec.exc]
    # injections are trace events too: a request's span tree shows where
    # each fault landed, next to the recovery it forced
    from ..obs import trace as _obs

    _obs.event("fault.injected", status="error", point=name, exc=spec.exc)
    raise factory(f"injected fault at {name}")
