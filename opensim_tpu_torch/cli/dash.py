"""``simon dash``: the fleet's live terminal view — the port's copy of
``opensim_tpu/cli/dash.py``.

The dashboard is a PURE function of one fetched payload bundle — fetch
and render are strictly separated so ``--once --json`` output is
byte-stable for a given payload (rendering the same payload twice yields
the same bytes). Every number comes from the
time-series ring (``GET /api/debug/timeseries``) and the SLO engine
(``GET /api/fleet/slo``); nothing here re-derives state the server
doesn't already expose.

Rows rendered:

- fleet QPS + p50/p99 request latency over the queried range, from
  ``simon_requests_total`` / ``simon_request_seconds`` deltas between the
  oldest and newest in-range ring samples (per-worker ``worker=``-labeled
  copies are dropped first — the summed series already counts them);
- event-to-servable freshness per pipeline stage, from
  ``simon_fleet_freshness_seconds`` (mean + p99 per stage);
- admission lane depths (``simon_lane_depth``, newest sample);
- takeover markers: every ring sample where
  ``simon_fleet_takeovers_total`` stepped, with its reason;
- SLO burn rates per objective per window (``/api/fleet/slo``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from ..obs.metrics import MetricKey, counter_delta, histogram_quantile

__all__ = [
    "dash_payload",
    "dash_rows",
    "fetch_dash",
    "format_dash",
]


def _drop_worker(sample: Dict[MetricKey, float]) -> Dict[MetricKey, float]:
    """Remove per-worker labeled copies: the aggregated endpoint exposes
    both the summed series and ``{worker="i"}`` breakdowns; deltas and
    quantiles must count each request once."""
    return {
        (name, labels): v
        for (name, labels), v in sample.items()
        if "worker" not in dict(labels)
    }


def _parse_samples(raw: List[list]) -> List[Tuple[float, Dict[MetricKey, float]]]:
    """``/api/debug/timeseries`` samples (JSON: ``[ts, {key: value}]``)
    → parsed ``(ts, {MetricKey: value})``, worker copies dropped."""
    from ..obs.metrics import parse_metrics

    out = []
    for ts, series in raw:
        text = "\n".join(f"{k} {v!r}" for k, v in series.items())
        out.append((float(ts), _drop_worker(parse_metrics(text))))
    return out


def _takeover_markers(samples) -> List[dict]:
    """Ring samples where ``simon_fleet_takeovers_total`` stepped —
    rendered as timeline markers so a failover is visible next to the
    latency it caused."""
    markers: List[dict] = []
    prev: Dict[tuple, float] = {}
    for ts, sample in samples:
        for (name, labels), v in sample.items():
            if name != "simon_fleet_takeovers_total":
                continue
            if v > prev.get(labels, 0.0):
                markers.append({
                    "unix": round(ts, 3),
                    "reason": dict(labels).get("reason", ""),
                    "count": v,
                })
            prev[labels] = v
    return markers


def _freshness_rows(first, last) -> List[dict]:
    rows: List[dict] = []
    for stage in ("journaled", "published", "attached", "served"):
        match = {"stage": stage}
        count = counter_delta(
            first, last, "simon_fleet_freshness_seconds_count", match
        )
        if count <= 0:
            continue
        total_s = counter_delta(
            first, last, "simon_fleet_freshness_seconds_sum", match
        )
        p99 = histogram_quantile(
            first, last, "simon_fleet_freshness_seconds", 0.99, match
        )
        rows.append({
            "stage": stage,
            "events": count,
            "mean_s": round(total_s / count, 6),
            "p99_s": round(p99, 6) if p99 is not None else None,
        })
    return rows


def dash_rows(payload: dict) -> dict:
    """The dashboard's structured rows — a pure function of the fetched
    payload (no clocks, no I/O): rendering the same payload twice yields
    identical rows, which is what makes ``--once --json`` byte-stable."""
    ts_doc = payload.get("timeseries") or {}
    samples = _parse_samples(ts_doc.get("samples") or [])
    out: dict = {
        "ring": ts_doc.get("stats") or {},
        "samples": len(samples),
    }
    if len(samples) >= 2:
        (t0, first), (t1, last) = samples[0], samples[-1]
        span = max(1e-9, t1 - t0)
        requests = counter_delta(first, last, "simon_requests_total")
        out["window_s"] = round(span, 3)
        out["qps"] = round(requests / span, 3)
        out["latency"] = {
            q: (round(v, 6) if v is not None else None)
            for q, v in (
                ("p50", histogram_quantile(first, last, "simon_request_seconds", 0.5)),
                ("p99", histogram_quantile(first, last, "simon_request_seconds", 0.99)),
            )
        }
        out["freshness"] = _freshness_rows(first, last)
        out["takeovers"] = _takeover_markers(samples)
        out["lanes"] = {
            dict(labels).get("lane", ""): v
            for (name, labels), v in sorted(samples[-1][1].items())
            if name == "simon_lane_depth"
        }
    slo_doc = payload.get("slo")
    if isinstance(slo_doc, dict):
        out["slo"] = [
            {
                "name": row.get("name"),
                "target_pct": row.get("target_pct"),
                "windows": {
                    label: {
                        "burn_rate": win.get("burn_rate"),
                        "no_data": bool(win.get("no_data")),
                    }
                    for label, win in sorted((row.get("windows") or {}).items())
                },
            }
            for row in slo_doc.get("objectives") or []
        ]
    for key in ("timeseries_error", "slo_error"):
        if payload.get(key):
            out[key] = payload[key]
    return out


def format_dash(payload: dict) -> str:
    """Human rendering of :func:`dash_rows` (same data, fixed layout)."""
    rows = dash_rows(payload)
    lines: List[str] = []
    ring = rows.get("ring") or {}
    lines.append(
        f"fleet dash — ring {ring.get('windows', 0)}/{ring.get('window_capacity', '?')} "
        f"windows, {rows['samples']} samples"
        + (f", {rows['window_s']}s span" if "window_s" in rows else "")
    )
    if "qps" in rows:
        lat = rows.get("latency") or {}

        def ms(v: Optional[float]) -> str:
            return f"{v * 1000:.1f}ms" if v is not None else "-"

        lines.append(
            f"traffic   qps={rows['qps']:g}  "
            f"p50={ms(lat.get('p50'))}  p99={ms(lat.get('p99'))}"
        )
    for f in rows.get("freshness") or []:
        lines.append(
            f"freshness {f['stage']:<10} events={f['events']:g}  "
            f"mean={f['mean_s'] * 1000:.1f}ms  "
            + (f"p99={f['p99_s'] * 1000:.1f}ms" if f["p99_s"] is not None else "p99=-")
        )
    lanes = rows.get("lanes") or {}
    if lanes:
        lines.append(
            "lanes     " + "  ".join(f"{k}={v:g}" for k, v in sorted(lanes.items()))
        )
    for m in rows.get("takeovers") or []:
        lines.append(
            f"takeover  reason={m['reason']}  count={m['count']:g}  at={m['unix']}"
        )
    for row in rows.get("slo") or []:
        burns = "  ".join(
            f"{label}={'-' if win['no_data'] else format(win['burn_rate'], 'g')}"
            for label, win in row["windows"].items()
        )
        lines.append(f"slo       {row['name']:<12} target={row['target_pct']:g}%  {burns}")
    for key in ("timeseries_error", "slo_error"):
        if rows.get(key):
            lines.append(f"[{key.split('_')[0]} unavailable: {rows[key]}]")
    return "\n".join(lines)


def fetch_dash(url: str, range_spec: str = "", timeout_s: float = 10.0) -> dict:
    """One payload bundle from a live server/fleet-admin endpoint. Each
    surface degrades independently (a standby answers 503 on the ring but
    may still be worth watching), so errors land IN the payload instead
    of raising."""
    import urllib.error
    import urllib.parse
    import urllib.request

    base = url.rstrip("/")
    payload: dict = {}

    def get(path: str) -> dict:
        with urllib.request.urlopen(base + path, timeout=timeout_s) as resp:
            return json.load(resp)

    qs = "?" + urllib.parse.urlencode({"range": range_spec}) if range_spec else ""
    try:
        payload["timeseries"] = get("/api/debug/timeseries" + qs)
    except (urllib.error.URLError, OSError, ValueError) as e:
        payload["timeseries_error"] = str(e)
    try:
        payload["slo"] = get("/api/fleet/slo")
    except (urllib.error.URLError, OSError, ValueError) as e:
        payload["slo_error"] = str(e)
    return payload


def dash_payload(url: str, range_spec: str = "", timeout_s: float = 10.0) -> dict:
    """Fetch + rows in one call (what ``simon dash --once --json`` prints,
    via ``json.dumps(..., sort_keys=True)``)."""
    return dash_rows(fetch_dash(url, range_spec, timeout_s))
