"""``simon dash`` of the port against the JAX package's: ``dash_rows`` and
``format_dash`` byte-equal on the same payloads (takeover markers, the
per-worker copies dropped, freshness rows, lanes, SLO burn rates and the
per-surface degradation), the reference's dash cases of
``tests/test_fleetobs.py`` through the port, ``simon dash --once --json``
against a ``--device cpu`` port server with its time-series ring, and the
``loadgen``/``dash`` parsers' options against the reference CLI's."""

import argparse
import io
import json
import threading
import time
import urllib.request
from contextlib import redirect_stdout

import pytest

from opensim_tpu.cli import dash as ref_dash
from opensim_tpu.cli import main as ref_cli
from opensim_tpu_torch.cli import dash as port_dash
from opensim_tpu_torch.cli import main as port_cli
from opensim_tpu_torch.obs.timeseries import render_series_key


def _slo_scrape(ok, err, under_100ms, fresh_under_30, fresh_total):
    total = ok + err
    return {
        ("simon_request_seconds_count", (("endpoint", "deploy-apps"), ("status", "ok"))): float(ok),
        ("simon_request_seconds_count", (("endpoint", "deploy-apps"), ("status", "error"))): float(err),
        ("simon_request_seconds_bucket", (("endpoint", "deploy-apps"), ("le", "0.1"), ("status", "ok"))):
            float(under_100ms),
        ("simon_request_seconds_bucket", (("endpoint", "deploy-apps"), ("le", "+Inf"), ("status", "ok"))):
            float(total),
        ("simon_fleet_freshness_seconds_bucket", (("le", "30"), ("stage", "served"))): float(fresh_under_30),
        ("simon_fleet_freshness_seconds_bucket", (("le", "+Inf"), ("stage", "served"))): float(fresh_total),
        ("simon_fleet_freshness_seconds_count", (("stage", "served"),)): float(fresh_total),
        ("simon_fleet_freshness_seconds_sum", (("stage", "served"),)): 2.5 * fresh_total,
    }


def _enc(series):
    return {render_series_key(k): v for k, v in series.items()}


def _dash_payload():
    s0 = dict(_slo_scrape(ok=100, err=0, under_100ms=100, fresh_under_30=0, fresh_total=0))
    s0[("simon_requests_total", ())] = 100.0
    s0[("simon_fleet_takeovers_total", (("reason", "expired"),))] = 0.0
    s1 = dict(_slo_scrape(ok=190, err=10, under_100ms=190, fresh_under_30=95, fresh_total=100))
    s1[("simon_requests_total", ())] = 200.0
    s1[("simon_fleet_takeovers_total", (("reason", "expired"),))] = 1.0
    s1[("simon_lane_depth", (("lane", "interactive"),))] = 2.0
    # a worker-labeled copy of the summed counter: dash must NOT double-count
    s1[("simon_requests_total", (("worker", "0"),))] = 200.0
    return {
        "timeseries": {
            "stats": {"windows": 1, "window_capacity": 4},
            "samples": [[900.0, _enc(s0)], [950.0, _enc(s1)]],
        },
        "slo": {
            "objectives": [{
                "name": "availability", "target_pct": 99.0,
                "windows": {"5m": {"burn_rate": 10.0, "no_data": False}},
            }],
        },
    }


def _handover_then_expiry():
    """Three samples: a handover, then an expiry; two lanes; an SLO with a
    window that has no data."""
    samples = []
    for i, (handover, expired) in enumerate([(0, 0), (1, 0), (1, 1)]):
        s = dict(_slo_scrape(ok=50 * (i + 1), err=i, under_100ms=40 * (i + 1), fresh_under_30=10 * i,
                             fresh_total=12 * i))
        s[("simon_requests_total", ())] = 60.0 * (i + 1)
        s[("simon_fleet_takeovers_total", (("reason", "handover"),))] = float(handover)
        s[("simon_fleet_takeovers_total", (("reason", "expired"),))] = float(expired)
        s[("simon_lane_depth", (("lane", "interactive"),))] = float(i)
        s[("simon_lane_depth", (("lane", "batch"),))] = 3.0 - i
        samples.append([1000.0 + 7.5 * i, _enc(s)])
    return {
        "timeseries": {"stats": {"windows": 2, "window_capacity": 48}, "samples": samples},
        "slo": {"objectives": [
            {"name": "availability", "target_pct": 99.9,
             "windows": {"5m": {"burn_rate": 0.5, "no_data": False}, "1h": {"burn_rate": None, "no_data": True}}},
            {"name": "latency_p99", "target_pct": 99.0,
             "windows": {"5m": {"burn_rate": 2.25, "no_data": False}}},
        ]},
    }


PAYLOADS = {
    "takeover": _dash_payload,
    "takeover-json-roundtrip": lambda: json.loads(json.dumps(_dash_payload())),
    "handover-then-expiry": _handover_then_expiry,
    "both-surfaces-down": lambda: {"timeseries_error": "503: standby", "slo_error": "503: standby"},
    "ring-down": lambda: {"timeseries_error": "HTTP Error 503", "slo": _dash_payload()["slo"]},
    "slo-down": lambda: {"timeseries": _dash_payload()["timeseries"], "slo_error": "timed out"},
    "one-sample": lambda: {"timeseries": {"stats": {"windows": 0, "window_capacity": 48},
                                          "samples": _dash_payload()["timeseries"]["samples"][:1]},
                           "slo": {"objectives": []}},
    "empty": dict,
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_dash_rows_and_format_byte_equal_to_reference(name):
    payload = PAYLOADS[name]()
    assert json.dumps(port_dash.dash_rows(payload), sort_keys=True) == \
        json.dumps(ref_dash.dash_rows(payload), sort_keys=True)
    assert port_dash.format_dash(payload) == ref_dash.format_dash(payload)


def test_dash_rows_takeover_marker_and_single_counting():
    rows = port_dash.dash_rows(_dash_payload())
    assert rows["qps"] == pytest.approx(100.0 / 50.0)  # 100 new requests / 50 s
    assert rows["takeovers"] == [{"unix": 950.0, "reason": "expired", "count": 1.0}]
    assert rows["lanes"] == {"interactive": 2.0}
    assert rows["slo"][0]["windows"]["5m"]["burn_rate"] == 10.0
    text = port_dash.format_dash(_dash_payload())
    assert "takeover  reason=expired" in text
    assert "slo       availability" in text


def test_dash_rows_are_byte_stable():
    payload = _dash_payload()
    a = json.dumps(port_dash.dash_rows(payload), sort_keys=True)
    b = json.dumps(port_dash.dash_rows(json.loads(json.dumps(payload))), sort_keys=True)
    assert a == b


def test_dash_degrades_per_surface():
    payload = {"timeseries_error": "503: standby", "slo_error": "503: standby"}
    rows = port_dash.dash_rows(payload)
    assert rows["samples"] == 0 and "qps" not in rows
    assert "timeseries unavailable" in port_dash.format_dash(payload)


def test_dash_once_json_against_cpu_server(monkeypatch):
    """``simon dash --once --json`` against a ``--device cpu`` port server
    whose time-series ring samples every 0.2 s: the rows carry the ring's
    samples, a QPS above 0 after a few requests, the SLO objectives, and
    equal the JAX package's rows on the same fetched payload; exit 0. A
    dead URL: both surfaces down, exit 1."""
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.server import rest

    monkeypatch.setenv("OPENSIM_TS_INTERVAL_S", "0.2")
    cluster = fx.synthetic_cluster(4)
    server = rest.SimonServer(base_cluster=cluster, admission=False, device="cpu")
    server.start_timeseries()
    httpd = rest.SimonHTTPServer(("127.0.0.1", 0), rest.make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        body = json.dumps({"deployments": [fx.make_fake_deployment("web", 2, "500m", "1Gi").raw]}).encode()
        for _ in range(3):
            req = urllib.request.Request(f"{url}/api/deploy-apps", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
            time.sleep(0.25)
        deadline = time.monotonic() + 20.0
        while True:
            out = io.StringIO()
            with redirect_stdout(out):
                rc = port_cli.main(["dash", "--url", url, "--once", "--json"])
            rows = json.loads(out.getvalue())
            if rows.get("qps", 0) > 0 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert rc == 0
        assert rows["samples"] >= 2 and rows["qps"] > 0
        assert {r["name"] for r in rows["slo"]} == {"availability", "latency_p99", "freshness"}
        assert "timeseries_error" not in rows and "slo_error" not in rows
        payload = port_dash.fetch_dash(url)
        assert json.dumps(port_dash.dash_rows(payload), sort_keys=True) == \
            json.dumps(ref_dash.dash_rows(payload), sort_keys=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    out = io.StringIO()
    with redirect_stdout(out):
        assert port_cli.main(["dash", "--url", url, "--once", "--json", "--timeout", "2"]) == 1
    rows = json.loads(out.getvalue())
    assert rows["samples"] == 0 and "timeseries_error" in rows and "slo_error" in rows


def _options(build_parser, command):
    """{dest: (option strings, default, choices, required, type name)} of
    one subcommand's parser."""
    sub = next(a for a in build_parser()._actions if isinstance(a, argparse._SubParsersAction))
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.required,
                     getattr(a.type, "__name__", None), type(a).__name__)
            for a in sub.choices[command]._actions if a.dest != "help"}


CLI_OPTIONS = [(cmd, dest) for cmd in ("loadgen", "dash") for dest in sorted(_options(ref_cli.build_parser, cmd))]


@pytest.mark.parametrize("command,dest", CLI_OPTIONS)
def test_cli_options_match_reference(command, dest):
    port = _options(port_cli.build_parser, command)
    ref = _options(ref_cli.build_parser, command)
    assert set(port) == set(ref)
    assert port[dest] == ref[dest]
