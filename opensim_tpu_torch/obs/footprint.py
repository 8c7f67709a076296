"""Memory observatory — what the simulator's own hot state costs: the
port's copy of ``opensim_tpu/obs/footprint.py``.

- **arena accounting** — per-entry byte attribution over the host numpy
  arenas of a cached :class:`~opensim_tpu_torch.engine.prepcache.CacheEntry`
  (every ``EncodedCluster`` field plus the stream-side arrays), grouped by
  the encoder dtype policy (``encoding/dtypes.py``), with lineage depth
  (``CacheEntry.lineage_depth``) and drop-mask density per entry. Shared
  leaves (delta entries alias their base's unchanged arrays) are counted
  ONCE in totals: each leaf is credited to the first entry that holds it,
  so cache totals reconcile exactly with the sum of per-entry
  ``unique_bytes``. The tensors on the card are accounted only through
  :func:`device_memory`.
- **ring occupancy** — the flight recorder, the capacity timeline and the
  journal writer queue report len/capacity through one view.
- **process + device watermarks** — RSS/VmHWM from ``/proc/self/status``
  (portable fallback: ``resource.getrusage``) and the card's allocator
  statistics (``torch.cuda.memory_stats``), sampled on a low-rate ticker
  (``OPENSIM_MEM_TICKER_S``) so peaks between scrapes are not lost.

Surfaces: ``GET /api/debug/memory``, ``simon mem``, the ``simon_mem_*``
``/metrics`` families (``obs/metrics.py`` FAMILIES) and the ``simon top
--mem`` block. Imports no torch: a fleet's reader processes import this
module without it.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import envknobs
from .metrics import escape_label_value, family_header

log = logging.getLogger("opensim_tpu_torch.obs")

__all__ = [
    "MemoryObservatory",
    "device_memory",
    "entry_host_leaves",
    "fmt_bytes",
    "memory_rows",
    "prepcache_footprint",
    "process_memory",
]

#: the encoder dtype policy vocabulary (encoding/dtypes.py) — the fixed
#: label set for simon_mem_arena_bytes{dtype=}; anything else is a policy
#: leak worth seeing ("other")
_POLICY_DTYPES = ("float32", "int32", "int64", "bool")


def _dtype_class(dtype: np.dtype) -> str:
    name = str(dtype)
    return name if name in _POLICY_DTYPES else "other"


# ---------------------------------------------------------------------------
# process + device watermarks
# ---------------------------------------------------------------------------


def process_memory() -> Dict[str, int]:
    """``{"rss_bytes", "rss_peak_bytes"}`` for this process. Linux reads
    ``/proc/self/status`` (VmRSS/VmHWM); elsewhere ``getrusage`` supplies
    the peak and stands in for the current value too."""
    rss = peak = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    if rss == 0:
        try:
            import resource

            peak = peak or resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
            rss = peak
        except (ImportError, OSError, ValueError):
            pass  # exotic platform: report zeros rather than fail a debug read
    return {"rss_bytes": rss, "rss_peak_bytes": max(rss, peak)}


def device_memory() -> Dict[str, Dict[str, int]]:
    """Per-card allocator statistics, ``{index: {"in_use", "peak"}}`` in
    bytes (``allocated_bytes.all.current`` / ``.peak`` of
    ``torch.cuda.memory_stats``); none on the CPU. Read only in a process
    whose CUDA context already exists: a scrape or the ticker must never
    create one (nor import torch into a process that has none)."""
    out: Dict[str, Dict[str, int]] = {}
    torch = sys.modules.get("torch")
    if torch is None:
        return out
    try:
        if not torch.cuda.is_initialized():
            return out
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            cur = int(stats.get("allocated_bytes.all.current", 0))
            out[str(i)] = {"in_use": cur, "peak": int(stats.get("allocated_bytes.all.peak", cur))}
    except Exception as e:
        # a debug read never fails on the device's account; the gap is logged
        log.debug("device memory stats unavailable: %s: %s", type(e).__name__, e)
    return out


# ---------------------------------------------------------------------------
# arena accounting
# ---------------------------------------------------------------------------


def entry_host_leaves(entry) -> List[Tuple[str, np.ndarray]]:
    """``(field name, host numpy array)`` pairs an entry's prep pins: the
    ``EncodedCluster`` arenas plus the stream-side tensors (template ids,
    forced mask, the twin's drop mask). Device tensors are accounted
    separately — on CPU they typically alias these same buffers."""
    prep = entry.prep
    if prep is None or prep.ec_np is None:
        return []
    leaves: List[Tuple[str, np.ndarray]] = []
    for name, arr in zip(type(prep.ec_np)._fields, prep.ec_np):
        if isinstance(arr, np.ndarray):
            leaves.append((name, arr))
    for name in ("tmpl_ids", "forced"):
        arr = getattr(prep, name, None)
        if isinstance(arr, np.ndarray):
            leaves.append((name, arr))
    if entry.base_drop is not None:
        leaves.append(("base_drop", entry.base_drop))
    return leaves


def entry_footprint(entry, seen_ids: Optional[set] = None) -> dict:
    """One entry's attribution. With ``seen_ids`` (a cache-walk accumulator
    of leaf ``id()``s), ``unique_bytes`` credits each shared leaf to the
    FIRST entry that held it — summing ``unique_bytes`` over a walk equals
    the cache total exactly (the ``simon mem`` reconciliation contract)."""
    leaves = entry_host_leaves(entry)
    fields: Dict[str, dict] = {}
    dtypes = {k: 0 for k in _POLICY_DTYPES + ("other",)}
    total = unique = 0
    off_policy: List[str] = []
    for name, arr in leaves:
        nbytes = int(arr.nbytes)
        total += nbytes
        cls = _dtype_class(arr.dtype)
        dtypes[cls] += nbytes
        if cls == "other":
            off_policy.append(name)
        if seen_ids is not None:
            if id(arr) not in seen_ids:
                seen_ids.add(id(arr))
                unique += nbytes
        else:
            unique += nbytes
        fields[name] = {
            "bytes": nbytes,
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
        }
    prep = entry.prep
    drop = entry.base_drop
    out = {
        "key": entry.key,
        "bytes": total,
        "unique_bytes": unique,
        "lineage_depth": entry.lineage_depth,
        "pods": len(prep.ordered) if prep is not None else 0,
        "drop_density": (
            round(float(drop.sum()) / max(1, len(drop)), 6) if drop is not None else 0.0
        ),
        "dtypes": {k: v for k, v in dtypes.items() if v},
        "fields": fields,
    }
    if off_policy:
        out["off_policy_fields"] = sorted(off_policy)
    return out


def prepcache_footprint(cache, include_fields: bool = False) -> dict:
    """The whole cache's memory view: entries newest-LRU-last, per-dtype
    totals over DISTINCT leaves, and the cache stats (hits/misses/
    evictions/invalidations plus the twin-delta compaction counter)."""
    from ..engine import prepcache as prepcache_mod

    out: dict = {
        "entries": [],
        "total_bytes": 0,
        "shared_bytes": 0,
        "dtypes": {},
        "stats": {},
        "compactions": prepcache_mod.compactions_total(),
    }
    if cache is None:
        return out
    entries = cache.entries_snapshot()
    out["stats"] = cache.stats.as_dict()
    seen: set = set()
    uniq_dtypes: Dict[str, int] = {}
    walked = []
    for entry in entries:
        # per-entry accounting under the entry lock (a concurrent twin
        # flush swaps base_drop/prep under it) — but BOUNDED: the entry
        # lock deliberately spans multi-second derive/encode work, and a
        # scrape must not stall behind an engine run. A busy entry is
        # reported as such and skipped; totals stay internally consistent
        # (they cover exactly the walked entries).
        if not entry.lock.acquire(timeout=0.5):
            # zero-valued stub: consumers of the total==Σ unique_bytes
            # contract (simon mem, the smoke run) must not KeyError or skew
            # when an engine run holds the entry mid-walk
            out["entries"].append(
                {
                    "key": entry.key, "busy": True, "bytes": 0,
                    "unique_bytes": 0, "lineage_depth": 0, "pods": 0,
                    "drop_density": 0.0, "dtypes": {},
                }
            )
            continue
        try:
            fp = entry_footprint(entry, seen_ids=seen)
            walked.append((entry, fp))
            # dtype totals over DISTINCT leaves, folded in the same walk
            for _name, arr in entry_host_leaves(entry):
                mark = ("dt", id(arr))
                if mark in seen:
                    continue
                seen.add(mark)
                cls = _dtype_class(arr.dtype)
                uniq_dtypes[cls] = uniq_dtypes.get(cls, 0) + int(arr.nbytes)
        finally:
            entry.lock.release()
        out["total_bytes"] += fp["unique_bytes"]
        if not include_fields:
            fp = dict(fp)
            fp.pop("fields", None)
        out["entries"].append(fp)
    out["dtypes"] = uniq_dtypes
    out["shared_bytes"] = (
        sum(fp["bytes"] for _e, fp in walked) - out["total_bytes"]
    )
    return out


# ---------------------------------------------------------------------------
# the observatory (server wiring + /metrics renderer)
# ---------------------------------------------------------------------------


def mem_ticker_s() -> float:
    """``OPENSIM_MEM_TICKER_S`` (default 10, 0 disables): the watermark
    sampling cadence. A typo degrades to the default with a warning."""
    try:
        return float(envknobs.value("OPENSIM_MEM_TICKER_S"))
    except ValueError as e:
        default = float(envknobs.KNOBS["OPENSIM_MEM_TICKER_S"].default)
        log.warning("ignoring OPENSIM_MEM_TICKER_S=%r (%s); using %g", envknobs.raw("OPENSIM_MEM_TICKER_S"), e,
                    default)
        return default


class MemoryObservatory:
    """The server's memory view: holds references to the structures it
    accounts (prep cache, rings, journal), keeps RSS/device watermarks
    fresh on a low-rate ticker, and renders the ``simon_mem_*`` families.

    All derived numbers are computed on demand (a scrape walks the cache's
    numpy headers — O(entries × fields) pointer work, no array reads);
    only the watermark peaks are stateful."""

    def __init__(self, prep_cache=None, timeline=None, journal=None, recorder=None) -> None:
        from .recorder import FLIGHT_RECORDER

        self.prep_cache = prep_cache
        self.timeline = timeline
        self.journal = journal
        self.recorder = recorder if recorder is not None else FLIGHT_RECORDER
        self._lock = threading.Lock()
        self._peak_rss = 0  # guarded-by: _lock
        self._last_process: Dict[str, int] = {}  # guarded-by: _lock
        self._device_peaks: Dict[str, int] = {}  # guarded-by: _lock
        self._ticker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- sampling ------------------------------------------------------------

    def sample_process(self) -> Dict[str, int]:
        """One watermark sample (ticker tick, scrape, or debug read)."""
        proc, _devices = self._sample()
        return proc

    def _sample(self) -> Tuple[Dict[str, int], Dict[str, Dict[str, int]]]:
        """One combined process + device sample with the watermarks folded
        in: one device read per scrape. The /proc and device reads happen
        outside the lock (no blocking I/O under a lock)."""
        proc = process_memory()
        devices = device_memory()
        with self._lock:
            self._peak_rss = max(self._peak_rss, proc["rss_peak_bytes"])
            proc["rss_peak_bytes"] = self._peak_rss
            self._last_process = proc
            for dev, stats in devices.items():
                self._device_peaks[dev] = max(
                    self._device_peaks.get(dev, 0), stats["peak"]
                )
                stats["peak"] = self._device_peaks[dev]
            for dev, peak in self._device_peaks.items():
                # a device that reported nothing this sample (backend blip)
                # keeps its remembered watermark visible
                devices.setdefault(dev, {"in_use": 0, "peak": peak})
        return proc, devices

    def start_ticker(self) -> None:
        """Start the low-rate watermark sampler (idempotent; no-op when
        ``OPENSIM_MEM_TICKER_S`` is 0)."""
        interval = mem_ticker_s()
        if interval <= 0 or self._ticker is not None:
            return

        def loop() -> None:
            # the first sample runs on the ticker thread, not inline at
            # startup: serve() reaches its listener whatever the device
            # read costs
            self.sample_process()
            while not self._stop.wait(interval):
                self.sample_process()

        self._ticker = threading.Thread(
            target=loop, name="simon-mem-ticker", daemon=True
        )
        self._ticker.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._ticker = self._ticker, None
        if t is not None:
            t.join(timeout=2.0)

    # -- views ---------------------------------------------------------------

    def ring_occupancy(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {
            "flight_recorder": {
                "entries": len(self.recorder),
                "capacity": int(self.recorder.capacity),
            }
        }
        if self.timeline is not None:
            out["capacity_timeline"] = {
                "entries": len(self.timeline),
                "capacity": int(self.timeline.capacity),
            }
        if self.journal is not None:
            depth, bound = self.journal.queue_occupancy()
            out["journal_queue"] = {"entries": depth, "capacity": bound}
        return out

    def debug_payload(self, include_fields: bool = True) -> dict:
        """The ``GET /api/debug/memory`` body (also what ``simon mem``
        renders): process + device watermarks, the full prep-cache arena
        attribution, and ring occupancy."""
        proc, devices = self._sample()
        return {
            "generated_unix": round(time.time(), 3),
            "process": proc,
            "devices": devices,
            "prepcache": prepcache_footprint(self.prep_cache, include_fields=include_fields),
            "rings": self.ring_occupancy(),
        }

    def summary(self) -> dict:
        """The compact block ``/api/cluster/report?mem=1`` embeds (and
        ``simon top --mem`` renders via :func:`memory_rows`)."""
        proc = self.sample_process()
        cache = prepcache_footprint(self.prep_cache)
        return {
            "rss_bytes": proc["rss_bytes"],
            "rss_peak_bytes": proc["rss_peak_bytes"],
            "prepcache_bytes": cache["total_bytes"],
            "prepcache_entries": len(cache["entries"]),
            "rings": self.ring_occupancy(),
        }

    # -- /metrics ------------------------------------------------------------

    def metrics_lines(self) -> List[str]:
        esc = escape_label_value
        proc, devices = self._sample()
        cache = prepcache_footprint(self.prep_cache)
        rings = self.ring_occupancy()
        lines: List[str] = [
            *family_header("simon_mem_rss_bytes"),
            f"simon_mem_rss_bytes {proc['rss_bytes']}",
            *family_header("simon_mem_rss_peak_bytes"),
            f"simon_mem_rss_peak_bytes {proc['rss_peak_bytes']}",
            *family_header("simon_mem_prepcache_bytes"),
            f"simon_mem_prepcache_bytes {cache['total_bytes']}",
            *family_header("simon_mem_prepcache_entries"),
            f"simon_mem_prepcache_entries {len(cache['entries'])}",
            *family_header("simon_mem_prepcache_evictions_total"),
            f"simon_mem_prepcache_evictions_total {cache['stats'].get('evictions', 0)}",
            *family_header("simon_mem_prepcache_compactions_total"),
            f"simon_mem_prepcache_compactions_total {cache['compactions']}",
        ]
        if cache["dtypes"]:
            lines += family_header("simon_mem_arena_bytes")
            lines += [
                f'simon_mem_arena_bytes{{dtype="{esc(cls)}"}} {nbytes}'
                for cls, nbytes in sorted(cache["dtypes"].items())
            ]
        lines += family_header("simon_mem_ring_entries")
        lines += [
            f'simon_mem_ring_entries{{ring="{esc(ring)}"}} {occ["entries"]}'
            for ring, occ in sorted(rings.items())
        ]
        lines += family_header("simon_mem_ring_capacity")
        lines += [
            f'simon_mem_ring_capacity{{ring="{esc(ring)}"}} {occ["capacity"]}'
            for ring, occ in sorted(rings.items())
        ]
        if devices:
            # _sample() already folded the remembered per-device watermarks in
            lines += family_header("simon_mem_device_bytes")
            for dev, stats in sorted(devices.items()):
                lines += [
                    f'simon_mem_device_bytes{{device="{esc(dev)}",kind="in_use"}} {stats["in_use"]}',
                    f'simon_mem_device_bytes{{device="{esc(dev)}",kind="peak"}} {stats["peak"]}',
                ]
        return lines


# ---------------------------------------------------------------------------
# shared rows builder (simon top --mem / report parity)
# ---------------------------------------------------------------------------


def fmt_bytes(n: int) -> str:
    value = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if value < 1024.0 or unit == "TiB":
            return f"{value:.1f}{unit}" if unit != "B" else f"{int(value)}B"
        value /= 1024.0
    return f"{int(n)}B"


def memory_rows(summary: dict) -> List[List[str]]:
    """The memory table rows — ONE builder serving both the
    ``/api/cluster/report?mem=1`` JSON and the ``simon top --mem`` text
    renderer, so the two stay byte-equal (the report-parity contract)."""
    rows = [["Memory", "Value"]]
    rows.append(["process RSS", fmt_bytes(int(summary.get("rss_bytes", 0)))])
    rows.append(["process RSS peak", fmt_bytes(int(summary.get("rss_peak_bytes", 0)))])
    rows.append(
        [
            "prep cache",
            f"{fmt_bytes(int(summary.get('prepcache_bytes', 0)))} "
            f"in {int(summary.get('prepcache_entries', 0))} entr"
            + ("y" if int(summary.get("prepcache_entries", 0)) == 1 else "ies"),
        ]
    )
    for ring, occ in sorted((summary.get("rings") or {}).items()):
        rows.append(
            [f"ring {ring}", f"{occ.get('entries', 0)}/{occ.get('capacity', 0)}"]
        )
    return rows
