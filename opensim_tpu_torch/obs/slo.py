"""Declarative SLOs evaluated as multi-window burn rates over the
time-series ring — the port's copy of ``opensim_tpu/obs/slo.py``
(framework-free there and here).

An objective is ``name:target_pct[:threshold_s]`` (the ``OPENSIM_SLO``
knob; comma-separated). Three objective kinds are built in:

- ``availability`` — the good fraction of requests, from
  ``simon_request_seconds_count{status=}`` (good = ``status="ok"``);
- ``latency_p99`` — requests completing under ``threshold_s``, from the
  ``simon_request_seconds`` bucket ladder (the threshold must sit on a
  bucket bound to be measurable; the evaluator uses the smallest bound
  ≥ threshold and says which it used);
- ``freshness`` — watch events reaching the ``served`` stage of the
  fleet pipeline under ``threshold_s``, from
  ``simon_fleet_freshness_seconds`` (``obs/fleetobs.py``).

Each objective is evaluated over every window in ``OPENSIM_SLO_WINDOWS``
(multi-window burn-rate alerting, the Prometheus/SRE-workbook shape):

    burn_rate = (bad / total) / (1 - target)

1.0 means the error budget burns exactly at the sustainable rate; a
classic page is "burn > 14.4 on the short window AND > 6 on the long
one". The engine computes the rates; paging policy belongs to the
operator. Burn rates surface at ``GET /api/fleet/slo`` and as
``simon_slo_burn_rate{slo=,window=}``.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, List, Optional, Tuple

from .metrics import MetricKey, escape_label_value, family_header
from ..utils import envknobs

log = logging.getLogger("opensim_tpu_torch.slo")

__all__ = [
    "Objective",
    "SLOEngine",
    "parse_objectives",
    "parse_windows",
]

_KINDS = ("availability", "latency_p99", "freshness")


class Objective:
    """One declarative objective: ``kind``, ``target_pct`` (e.g. 99.9),
    optional ``threshold_s`` (latency/freshness kinds)."""

    def __init__(self, kind: str, target_pct: float,
                 threshold_s: Optional[float] = None) -> None:
        if kind not in _KINDS:
            raise ValueError(
                f"unknown SLO kind {kind!r} (known: {', '.join(_KINDS)})"
            )
        if not 0.0 < target_pct < 100.0:
            raise ValueError(f"SLO target must be in (0, 100), got {target_pct!r}")
        if kind in ("latency_p99", "freshness") and not threshold_s:
            raise ValueError(f"SLO {kind!r} needs a threshold: {kind}:<pct>:<seconds>")
        self.kind = kind
        self.target_pct = target_pct
        self.threshold_s = threshold_s

    @property
    def budget(self) -> float:
        """The error budget as a fraction (99.9% → 0.001)."""
        return 1.0 - self.target_pct / 100.0

    def to_dict(self) -> dict:
        return {
            "name": self.kind,
            "target_pct": self.target_pct,
            "threshold_s": self.threshold_s,
            "budget": round(self.budget, 9),
        }


def parse_objectives(spec: Optional[str] = None) -> List[Objective]:
    """``OPENSIM_SLO`` → objectives. Malformed entries fail loudly — a
    silently dropped objective is an SLO that never pages."""
    spec = spec if spec is not None else str(envknobs.value("OPENSIM_SLO"))
    out: List[Objective] = []
    for part in (p.strip() for p in spec.split(",")):
        if not part:
            continue
        bits = part.split(":")
        if len(bits) not in (2, 3):
            raise ValueError(
                f"bad SLO entry {part!r}: want name:target_pct[:threshold_s]"
            )
        threshold = float(bits[2]) if len(bits) == 3 else None
        out.append(Objective(bits[0], float(bits[1]), threshold))
    return out


def parse_windows(spec: Optional[str] = None) -> List[Tuple[str, float]]:
    """``OPENSIM_SLO_WINDOWS`` (e.g. ``5m,1h``) → ``[(label, seconds)]``."""
    spec = spec if spec is not None else str(envknobs.value("OPENSIM_SLO_WINDOWS"))
    units = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
    out: List[Tuple[str, float]] = []
    for part in (p.strip() for p in spec.split(",")):
        if not part:
            continue
        if part[-1] not in units:
            raise ValueError(f"bad SLO window {part!r}: want <number><s|m|h|d>")
        out.append((part, float(part[:-1]) * units[part[-1]]))
    if not out:
        raise ValueError("OPENSIM_SLO_WINDOWS resolved to no windows")
    return out


def _cum_below(series: Dict[MetricKey, float], family: str,
               threshold: float) -> Tuple[float, float, Optional[float]]:
    """(cumulative count ≤ bound, total count, bound used) for one
    histogram family at one sample, summing across series (shared bucket
    ladder). The bound is the smallest ``le`` ≥ threshold."""
    buckets: Dict[float, float] = {}
    total = 0.0
    for (name, labels), v in series.items():
        if name == f"{family}_count":
            total += v
        elif name == f"{family}_bucket":
            ld = dict(labels)
            le = math.inf if ld.get("le") == "+Inf" else float(ld.get("le", "inf"))
            buckets[le] = buckets.get(le, 0.0) + v
    bound = None
    for le in sorted(buckets):
        if le >= threshold:
            bound = le
            break
    if bound is None:
        return 0.0, total, None
    return buckets[bound], total, bound


class SLOEngine:
    """Evaluates objectives over a :class:`TimeSeriesRing`. Stateless
    between calls — every evaluation re-reads the ring, so a takeover's
    adopted ring (or an empty one) needs no migration."""

    #: ring families the evaluator needs (dash prefetches the same set)
    FAMILIES_NEEDED = ("simon_request_seconds", "simon_fleet_freshness_seconds")

    def __init__(self, ring, objectives: Optional[List[Objective]] = None,
                 windows: Optional[List[Tuple[str, float]]] = None) -> None:
        self.ring = ring
        self.objectives = objectives if objectives is not None else parse_objectives()
        self.windows = windows if windows is not None else parse_windows()

    # -- counting ------------------------------------------------------------

    def _bad_total(self, obj: Objective,
                   first: Dict[MetricKey, float],
                   last: Dict[MetricKey, float]) -> Tuple[float, float, dict]:
        """(bad, total, detail) over the window delta ``first → last``.
        Counter resets surface as a larger-than-life delta at worst for
        one window span; the ring is append-only so this is rare and
        self-heals."""
        detail: dict = {}
        if obj.kind == "availability":
            total = bad = 0.0
            for (name, labels), v in last.items():
                if name != "simon_request_seconds_count":
                    continue
                d = max(0.0, v - first.get((name, labels), 0.0))
                total += d
                if dict(labels).get("status") != "ok":
                    bad += d
            return bad, total, detail
        family = (
            "simon_request_seconds" if obj.kind == "latency_p99"
            else "simon_fleet_freshness_seconds"
        )
        good1, total1, bound = _cum_below(last, family, obj.threshold_s or 0.0)
        good0, total0, _ = _cum_below(first, family, obj.threshold_s or 0.0)
        total = max(0.0, total1 - total0)
        good = max(0.0, good1 - good0)
        detail["bucket_bound_s"] = bound
        return max(0.0, total - good), total, detail

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> dict:
        now = now or time.time()
        longest = max(s for _, s in self.windows)
        samples = self.ring.query_parsed(
            family=",".join(self.FAMILIES_NEEDED), range_s=longest, now=now
        )
        out = {"generated_unix": round(now, 3), "objectives": []}
        for obj in self.objectives:
            row = obj.to_dict()
            row["windows"] = {}
            for label, seconds in self.windows:
                in_win = [s for s in samples if s[0] >= now - seconds]
                if len(in_win) < 2:
                    row["windows"][label] = {
                        "burn_rate": 0.0, "bad": 0.0, "total": 0.0,
                        "samples": len(in_win), "no_data": True,
                    }
                    continue
                bad, total, detail = self._bad_total(obj, in_win[0][1], in_win[-1][1])
                burn = (bad / total) / obj.budget if total > 0 else 0.0
                win = {
                    "burn_rate": round(burn, 6),
                    "bad": bad,
                    "total": total,
                    "samples": len(in_win),
                    "span_s": round(in_win[-1][0] - in_win[0][0], 3),
                }
                win.update(detail)
                row["windows"][label] = win
            out["objectives"].append(row)
        return out

    def metrics_lines(self, now: Optional[float] = None) -> List[str]:
        """``simon_slo_burn_rate{slo=,window=}`` gauge lines. The gauge is
        recomputed per scrape from the ring (recording-rule style), not
        accumulated, so it needs no lock beyond the ring's own."""
        try:
            payload = self.evaluate(now=now)
        except Exception as e:  # a torn ring file mid-read
            log.warning("SLO evaluation failed: %s: %s", type(e).__name__, e)
            return family_header("simon_slo_burn_rate")
        lines = family_header("simon_slo_burn_rate")
        for row in payload["objectives"]:
            for label, win in sorted(row["windows"].items()):
                lines.append(
                    "simon_slo_burn_rate{"
                    f'slo="{escape_label_value(row["name"])}",'
                    f'window="{escape_label_value(label)}"'
                    f"}} {win['burn_rate']:.6g}"
                )
        return lines
