"""Bounded on-disk time-series ring over the metric registry — the port's
copy of ``opensim_tpu/obs/timeseries.py`` (framework-free there and here).

A :class:`TimeSeriesSampler` thread scrapes the process's own exposition
text every ``OPENSIM_TS_INTERVAL_S`` seconds, parses it with the shared
reader (``obs.metrics.parse_metrics``) and appends the sample to a
:class:`TimeSeriesRing`: a fixed number of **windows**
(``OPENSIM_TS_WINDOWS``), each holding a fixed number of samples
(``OPENSIM_TS_WINDOW_SAMPLES``). Only the newest window lives in memory;
a full window is **sealed** to disk as one delta-encoded JSON file and
the oldest file is unlinked when the ring wraps — the on-disk footprint
is bounded by construction, never by a cleanup job.

Delta encoding is exact, not approximate: a sample stores, per series,
either a float delta ``d`` against the previous sample — only when
``prev + d == value`` reproduces the value bit-for-bit (IEEE addition is
not guaranteed to invert subtraction) — or the absolute value in ``set``
(new series, counter resets, and the rare non-invertible float). The
round-trip test in tests/test_torch_fleetobs.py holds this to equality,
not tolerance.

Queries (``GET /api/debug/timeseries?family=&range=``, the SLO engine) read memory for the open window and decode sealed files
for history; series keys travel as exposition-format sample keys
(``simon_request_seconds_bucket{le="0.1"}``) so every consumer reuses
``parse_metrics`` instead of inventing a second key grammar.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .metrics import (
    RECORDER,
    MetricKey,
    escape_label_value,
    family_header,
    CounterVec,
    parse_metrics,
)
from ..utils import envknobs

log = logging.getLogger("opensim_tpu_torch.timeseries")

__all__ = [
    "TimeSeriesRing",
    "TimeSeriesSampler",
    "decode_window",
    "parse_duration_s",
    "render_series_key",
    "sample_interval_s",
]

_FORMAT_VERSION = 1


def sample_interval_s() -> float:
    return float(envknobs.value("OPENSIM_TS_INTERVAL_S"))


def parse_duration_s(spec: Optional[str]) -> Optional[float]:
    """``?range=`` grammar: bare seconds (``300``) or suffixed
    (``5m``/``1h``/``2d``). Empty/None → None (no cutoff). Raises
    ``ValueError`` on garbage — a silently ignored range is a dashboard
    quietly showing the wrong window."""
    spec = (spec or "").strip()
    if not spec:
        return None
    units = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
    if spec[-1] in units:
        return float(spec[:-1]) * units[spec[-1]]
    return float(spec)


def render_series_key(key: MetricKey) -> str:
    """``(name, labels)`` → the exposition sample key (``name{...}``) —
    the inverse of ``parse_metrics`` for a single sample line."""
    name, labels = key
    if not labels:
        return name
    body = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels)
    return f"{name}{{{body}}}"


def parse_series_key(key: str) -> Optional[MetricKey]:
    """One rendered series key back to ``(name, sorted labels)``."""
    parsed = parse_metrics(f"{key} 0")
    for k in parsed:
        return k
    return None


def _encode_samples(samples: List[Tuple[float, Dict[str, float]]]) -> List[dict]:
    """Delta-encode a window's samples (keys are rendered series keys).
    The first sample is stored whole; each later one stores float deltas
    where exactly invertible, absolute values otherwise, and the keys
    that disappeared."""
    out: List[dict] = []
    prev: Dict[str, float] = {}
    for ts, series in samples:
        if not out:
            out.append({"ts": ts, "full": dict(series)})
        else:
            deltas: Dict[str, float] = {}
            absolutes: Dict[str, float] = {}
            for k, v in series.items():
                if k in prev:
                    d = v - prev[k]
                    if prev[k] + d == v:
                        deltas[k] = d
                        continue
                absolutes[k] = v
            rec: dict = {"ts": ts}
            if deltas:
                rec["d"] = deltas
            if absolutes:
                rec["set"] = absolutes
            gone = [k for k in prev if k not in series]
            if gone:
                rec["gone"] = gone
            out.append(rec)
        prev = series
    return out


def _decode_samples(encoded: List[dict]) -> List[Tuple[float, Dict[str, float]]]:
    samples: List[Tuple[float, Dict[str, float]]] = []
    prev: Dict[str, float] = {}
    for rec in encoded:
        if "full" in rec:
            series = dict(rec["full"])
        else:
            series = dict(prev)
            for k in rec.get("gone") or []:
                series.pop(k, None)
            for k, d in (rec.get("d") or {}).items():
                series[k] = series.get(k, 0.0) + d
            for k, v in (rec.get("set") or {}).items():
                series[k] = v
        samples.append((float(rec["ts"]), series))
        prev = series
    return samples


def decode_window(path: str) -> List[Tuple[float, Dict[str, float]]]:
    """Decode one sealed window file → ``[(ts, {series key: value})]``.
    Raises on a malformed file (callers treat that window as lost)."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("v") != _FORMAT_VERSION:
        raise ValueError(f"unsupported timeseries window version {doc.get('v')!r}")
    return _decode_samples(doc.get("samples") or [])


class TimeSeriesRing:
    """The bounded ring. ``directory=None`` creates (and owns — removed
    on :meth:`close`) a private tempdir; an explicit directory (the
    ``OPENSIM_TS_DIR`` knob) persists across restarts for post-mortems."""

    def __init__(
        self,
        directory: Optional[str] = None,
        windows: Optional[int] = None,
        window_samples: Optional[int] = None,
    ) -> None:
        self.windows = int(windows or envknobs.value("OPENSIM_TS_WINDOWS"))
        self.window_samples = int(
            window_samples or envknobs.value("OPENSIM_TS_WINDOW_SAMPLES")
        )
        self._owns_dir = directory is None
        self.directory = directory or tempfile.mkdtemp(prefix="simon-ts-")
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        # the open window, newest last            # guarded-by: _lock
        self._open: List[Tuple[float, Dict[str, float]]] = []
        self._sealed: List[str] = []  # sealed file paths, oldest first  # guarded-by: _lock
        self._seq = 0  # monotonic window file index  # guarded-by: _lock
        self._bytes = 0  # on-disk bytes across sealed files  # guarded-by: _lock
        self.samples_total = CounterVec("simon_ts_samples_total", ())
        self._closed = False
        with self._lock:
            self._adopt_existing_locked()

    # -- write side ----------------------------------------------------------

    def _adopt_existing_locked(self) -> None:
        """An explicit directory may hold windows from a previous run:
        adopt them into the ring (oldest first) so the bound keeps
        holding across restarts."""
        try:
            names = sorted(
                n for n in os.listdir(self.directory)
                if n.startswith("win-") and n.endswith(".json")
            )
        except OSError:
            return
        for name in names:
            path = os.path.join(self.directory, name)
            self._sealed.append(path)
            try:
                self._bytes += os.path.getsize(path)
                self._seq = max(self._seq, int(name[4:-5]) + 1)
            except (OSError, ValueError):
                pass
        self._enforce_bound_locked()

    def append(self, ts: float, series: Dict[MetricKey, float]) -> None:
        """One sample: parsed scrape → rendered series keys → the open
        window, sealing to disk when full. The seal's file write happens
        OUTSIDE the ring lock — a slow disk must not stall queries."""
        rendered = {render_series_key(k): v for k, v in series.items()}
        doc = path = None
        with self._lock:
            if self._closed:
                return
            self._open.append((ts, rendered))
            if len(self._open) >= self.window_samples:
                doc = {
                    "v": _FORMAT_VERSION,
                    "t0": self._open[0][0],
                    "t1": self._open[-1][0],
                    "samples": _encode_samples(self._open),
                }
                path = os.path.join(self.directory, f"win-{self._seq:08d}.json")
                self._seq += 1
                self._open = []
        if doc is not None and path is not None:
            self._write_window(doc, path)
        with RECORDER.lock:
            self.samples_total.inc(())

    def _write_window(self, doc: dict, path: str) -> None:
        """One sealed window to disk (single-writer: only the sampler
        thread seals). Adopted into the ring under the lock after the
        atomic rename; a failed write drops the window — observability
        must not take the server down, and the bound still holds."""
        try:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, separators=(",", ":"))
            os.replace(tmp, path)  # a reader never sees a torn window
            size = os.path.getsize(path)
        except OSError as e:
            log.warning("timeseries window seal failed (%s): window dropped", e)
            return
        with self._lock:
            self._sealed.append(path)
            self._bytes += size
            self._enforce_bound_locked()

    def _enforce_bound_locked(self) -> None:
        while len(self._sealed) > max(1, self.windows - 1):
            path = self._sealed.pop(0)
            try:
                self._bytes -= os.path.getsize(path)
                os.unlink(path)
            except OSError:
                pass

    # -- read side -----------------------------------------------------------

    def query(
        self,
        family: str = "",
        range_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> List[Tuple[float, Dict[str, float]]]:
        """Samples (oldest first) within ``range_s`` seconds of ``now``,
        filtered to ``family`` (comma-separated family names; a family
        matches its own samples plus ``_bucket``/``_sum``/``_count``
        children; empty = everything)."""
        cutoff = None
        if range_s is not None:
            cutoff = (now or time.time()) - max(0.0, float(range_s))
        with self._lock:
            sealed = list(self._sealed)
            out = list(self._open)
        for path in reversed(sealed):
            if out and cutoff is not None and out[0][0] <= cutoff:
                break  # older files cannot contribute in-range samples
            try:
                out = decode_window(path) + out
            except (OSError, ValueError) as e:
                log.warning("timeseries window %s unreadable (%s); skipped", path, e)
        if cutoff is not None:
            out = [(ts, s) for ts, s in out if ts >= cutoff]
        fams = [f for f in family.split(",") if f]
        if fams:
            def keep(key: str) -> bool:
                name = key.split("{", 1)[0]
                for f in fams:
                    if name == f or (
                        name.startswith(f + "_")
                        and name[len(f):] in ("_bucket", "_sum", "_count")
                    ):
                        return True
                return False

            out = [
                (ts, {k: v for k, v in s.items() if keep(k)}) for ts, s in out
            ]
        return out

    def query_parsed(
        self,
        family: str = "",
        range_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> List[Tuple[float, Dict[MetricKey, float]]]:
        """:meth:`query` with series keys decoded back to ``MetricKey`` —
        the shape ``histogram_quantile``/``counter_delta`` consume."""
        out = []
        for ts, series in self.query(family, range_s, now):
            out.append(
                (ts, parse_metrics("\n".join(f"{k} {v!r}" for k, v in series.items())))
            )
        return out

    # -- telemetry / lifecycle -----------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "windows": len(self._sealed) + (1 if self._open else 0),
                "window_capacity": self.windows,
                "window_samples": self.window_samples,
                "open_samples": len(self._open),
                "bytes": self._bytes,
                "directory": self.directory,
            }

    def metrics_lines(self) -> List[str]:
        st = self.stats()
        with RECORDER.lock:
            lines = self.samples_total.render_lines()
        lines = lines or family_header("simon_ts_samples_total")
        for name, value in (
            ("simon_ts_window_bytes", st["bytes"]),
            ("simon_ts_windows", st["windows"]),
        ):
            lines += family_header(name)
            lines.append(f"{name} {value}")
        return lines

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            sealed = list(self._sealed)
        if self._owns_dir:
            for path in sealed:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            try:
                os.rmdir(self.directory)
            except OSError:
                pass


class TimeSeriesSampler:
    """The sampling thread: ``scrape_fn() → parse → ring.append`` every
    interval. One per serving process that owns a scrape surface (the
    single-process server and the fleet owner; workers are sampled
    through the owner's aggregation)."""

    def __init__(
        self,
        ring: TimeSeriesRing,
        scrape_fn: Callable[[], str],
        interval_s: Optional[float] = None,
    ) -> None:
        self.ring = ring
        self.scrape_fn = scrape_fn
        self.interval_s = max(0.05, interval_s or sample_interval_s())
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self, now: Optional[float] = None) -> None:
        self.ring.append(now or time.time(), parse_metrics(self.scrape_fn()))

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception as e:
                # a failed scrape (worker roll mid-aggregation) skips one
                # sample; the ring and the server keep going
                log.warning("timeseries sample failed: %s: %s", type(e).__name__, e)

    def start(self) -> "TimeSeriesSampler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="simon-timeseries", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
