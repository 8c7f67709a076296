"""Build telemetry and cumulative phase profiles — the port's copy of
``opensim_tpu/obs/profile.py``.

**Build telemetry.** What compiles in the port is the ``nvcc`` build of a
kernel variant (``ops/fast_scan.py``: one shared object per variant, a
variant being a set of compile-time flags). :class:`CompileWatch` counts
them with the reference's vocabulary: a *boundary* is a variant name, a
*compile* one ``nvcc`` run, its cause ``first`` for the first variant built
in the process and ``static`` for each later new variant; ``backend`` sums
every ``nvcc`` build in the process; ``cache_events`` counts ``hit`` (the
variant's library was already in the build directory) and ``miss`` (``nvcc``
ran); ``persistent_cache`` is the build directory's file count and bytes
(``utils/jitcache.cache_stats``, None before the directory exists).

**Cumulative phase profiles.** :class:`PhaseProfile` folds every recorded
trace's span tree into per-span-name accumulators: call count, inclusive
seconds, exclusive seconds (children subtracted, so ``prepare`` minus its
``encode`` child is visible) and a fixed-bucket histogram that serves
p50/p99, fed from the same :meth:`FlightRecorder.record` sink the debug
endpoints read.

Surfaces: ``GET /api/debug/profile``, ``simon profile``, and the
``simon_compile_*`` / ``simon_backend_compile_*`` / ``simon_jitcache_*`` /
``simon_phase_profile_*`` ``/metrics`` families (``obs/metrics.py``
FAMILIES). Framework-free: nothing here imports torch.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Tuple

from ..utils import jitcache
from .metrics import DEFAULT_BUCKETS, escape_label_value, family_header

__all__ = [
    "COMPILES",
    "PROFILE",
    "CompileWatch",
    "PhaseProfile",
    "debug_payload",
]

_BUCKETS: Tuple[float, ...] = tuple(DEFAULT_BUCKETS) + (math.inf,)


def _quantile(counts: List[int], total: int, q: float) -> float:
    """histogram_quantile-style linear interpolation over the fixed
    buckets (the same math ``server/loadgen.py`` applies to scrapes)."""
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0
    lo = 0.0
    for count, hi in zip(counts, _BUCKETS):
        if count:
            if cum + count >= rank:
                if math.isinf(hi):
                    return lo
                frac = (rank - cum) / count
                return lo + (hi - lo) * frac
            cum += count
        lo = 0.0 if math.isinf(hi) else hi
    return lo


# ---------------------------------------------------------------------------
# build telemetry
# ---------------------------------------------------------------------------


class CompileWatch:
    """Per-variant ``nvcc`` build accounting, process-wide."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> {"compiles", "seconds", "causes": {cause: n}}
        self._fns: Dict[str, dict] = {}  # guarded-by: _lock
        self._backend_compiles = 0  # guarded-by: _lock
        self._backend_seconds = 0.0  # guarded-by: _lock
        self._cache_events: Dict[str, int] = {}  # guarded-by: _lock

    def record_build(self, name: str, seconds: float) -> None:
        """One ``nvcc`` run of variant `name` into the build directory."""
        with self._lock:
            cause = "first" if not self._fns else "static"
            fn = self._fns.setdefault(name, {"compiles": 0, "seconds": 0.0, "causes": {}})
            fn["compiles"] += 1
            fn["seconds"] += seconds
            fn["causes"][cause] = fn["causes"].get(cause, 0) + 1
            self._backend_compiles += 1
            self._backend_seconds += seconds
            self._cache_events["miss"] = self._cache_events.get("miss", 0) + 1

    def record_hit(self) -> None:
        """A variant loaded from a library already in the build directory."""
        with self._lock:
            self._cache_events["hit"] = self._cache_events.get("hit", 0) + 1

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            fns = {
                name: {
                    "compiles": fn["compiles"],
                    "seconds": round(fn["seconds"], 6),
                    "causes": dict(fn["causes"]),
                    # a variant is one signature: its set of flags
                    "distinct_signatures": 1,
                }
                for name, fn in sorted(self._fns.items())
            }
            out = {
                "boundaries": fns,
                "backend": {"compiles": self._backend_compiles, "seconds": round(self._backend_seconds, 6)},
                "cache_events": dict(sorted(self._cache_events.items())),
            }
        out["persistent_cache"] = jitcache.cache_stats()
        return out

    def metrics_lines(self) -> List[str]:
        esc = escape_label_value
        lines: List[str] = []
        with self._lock:
            if self._fns:
                lines += family_header("simon_compile_total")
                lines += [f'simon_compile_total{{fn="{esc(n)}"}} {fn["compiles"]}'
                          for n, fn in sorted(self._fns.items())]
                lines += family_header("simon_compile_seconds_total")
                lines += [f'simon_compile_seconds_total{{fn="{esc(n)}"}} {fn["seconds"]:.6f}'
                          for n, fn in sorted(self._fns.items())]
                lines += family_header("simon_compile_cause_total")
                lines += [f'simon_compile_cause_total{{cause="{esc(c)}",fn="{esc(n)}"}} {k}'
                          for n, fn in sorted(self._fns.items()) for c, k in sorted(fn["causes"].items())]
            lines += [
                *family_header("simon_backend_compile_total"),
                f"simon_backend_compile_total {self._backend_compiles}",
                *family_header("simon_backend_compile_seconds_total"),
                f"simon_backend_compile_seconds_total {self._backend_seconds:.6f}",
            ]
            if self._cache_events:
                lines += family_header("simon_jitcache_events_total")
                lines += [f'simon_jitcache_events_total{{event="{esc(ev)}"}} {n}'
                          for ev, n in sorted(self._cache_events.items())]
        stats = jitcache.cache_stats()
        if stats is not None:
            lines += [
                *family_header("simon_jitcache_persistent_files"),
                f"simon_jitcache_persistent_files {stats['files']}",
                *family_header("simon_jitcache_persistent_bytes"),
                f"simon_jitcache_persistent_bytes {stats['bytes']}",
            ]
        return lines

    def reset(self) -> None:
        with self._lock:
            self._fns.clear()
            self._backend_compiles = 0
            self._backend_seconds = 0.0
            self._cache_events.clear()


COMPILES = CompileWatch()


# ---------------------------------------------------------------------------
# cumulative phase profiles
# ---------------------------------------------------------------------------


class _Agg:
    __slots__ = ("count", "incl", "excl", "max_s", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.incl = 0.0
        self.excl = 0.0
        self.max_s = 0.0
        self.buckets = [0] * len(_BUCKETS)

    def add(self, incl: float, excl: float) -> None:
        self.count += 1
        self.incl += incl
        self.excl += excl
        self.max_s = max(self.max_s, incl)
        for i, hi in enumerate(_BUCKETS):
            if incl <= hi:
                self.buckets[i] += 1
                break

    def clone(self) -> "_Agg":
        """Copy taken under the profile lock: snapshot() reads fields after
        releasing it, and a concurrent add() must not tear count vs buckets
        (a mismatch would push _quantile's rank past the histogram)."""
        out = _Agg()
        out.count = self.count
        out.incl = self.incl
        out.excl = self.excl
        out.max_s = self.max_s
        out.buckets = list(self.buckets)
        return out

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "seconds": round(self.incl, 6),
            "exclusive_seconds": round(self.excl, 6),
            "mean_s": round(self.incl / self.count, 6) if self.count else 0.0,
            "p50_s": round(_quantile(self.buckets, self.count, 0.50), 6),
            "p99_s": round(_quantile(self.buckets, self.count, 0.99), 6),
            "max_s": round(self.max_s, 6),
        }


class PhaseProfile:
    """Cumulative span profiles keyed ``(endpoint, span name)``, fed from
    the flight-recorder sink (every finished request trace)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._agg: Dict[Tuple[str, str], _Agg] = {}  # guarded-by: _lock
        self._traces = 0  # guarded-by: _lock

    def observe_trace(self, trace) -> None:
        rows: List[Tuple[str, float, float]] = []
        endpoint = trace.endpoint
        for sp in trace.walk():
            incl = sp.duration_s
            excl = incl - sum(c.duration_s for c in sp.children)
            rows.append((sp.name, incl, max(0.0, excl)))
        with self._lock:
            self._traces += 1
            for name, incl, excl in rows:
                agg = self._agg.get((endpoint, name))
                if agg is None:
                    agg = self._agg[(endpoint, name)] = _Agg()
                agg.add(incl, excl)

    def snapshot(self) -> dict:
        """The ``/api/debug/profile`` phases body: per span name (summed
        over endpoints) and the per-endpoint breakdown."""
        with self._lock:
            items = [(ep, name, agg.clone()) for (ep, name), agg in self._agg.items()]
            traces = self._traces
        by_span: Dict[str, _Agg] = {}
        for _ep, name, agg in items:
            tot = by_span.get(name)
            if tot is None:
                tot = by_span[name] = _Agg()
            tot.count += agg.count
            tot.incl += agg.incl
            tot.excl += agg.excl
            tot.max_s = max(tot.max_s, agg.max_s)
            tot.buckets = [a + b for a, b in zip(tot.buckets, agg.buckets)]
        return {
            "traces": traces,
            "spans": {
                name: agg.to_dict()
                for name, agg in sorted(by_span.items(), key=lambda kv: -kv[1].incl)
            },
            "endpoints": {
                ep: {
                    name: agg.to_dict()
                    for (e2, name, agg) in sorted(items, key=lambda r: -r[2].incl)
                    if e2 == ep
                }
                for ep in sorted({ep for ep, _n, _a in items})
            },
        }

    def metrics_lines(self) -> List[str]:
        esc = escape_label_value
        snap = self.snapshot()
        if not snap["spans"]:
            return []
        lines = [*family_header("simon_phase_profile_calls_total")]
        lines += [
            f'simon_phase_profile_calls_total{{span="{esc(name)}"}} {d["count"]}'
            for name, d in sorted(snap["spans"].items())
        ]
        lines += family_header("simon_phase_profile_seconds_total")
        lines += [
            f'simon_phase_profile_seconds_total{{span="{esc(name)}"}} {d["seconds"]:.6f}'
            for name, d in sorted(snap["spans"].items())
        ]
        lines += family_header("simon_phase_profile_exclusive_seconds_total")
        lines += [
            f'simon_phase_profile_exclusive_seconds_total{{span="{esc(name)}"}} '
            f'{d["exclusive_seconds"]:.6f}'
            for name, d in sorted(snap["spans"].items())
        ]
        return lines

    def reset(self) -> None:
        with self._lock:
            self._agg.clear()
            self._traces = 0


PROFILE = PhaseProfile()


def debug_payload() -> dict:
    """The ``GET /api/debug/profile`` body (also what ``simon profile``
    renders): the cumulative phase profiles plus the build telemetry."""
    return {
        "generated_unix": round(time.time(), 3),
        "phases": PROFILE.snapshot(),
        "compiles": COMPILES.snapshot(),
    }
