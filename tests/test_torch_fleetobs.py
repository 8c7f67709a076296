"""The port's fleet observability on the CPU: the cases of
tests/test_fleetobs.py that need no ``cli/dash.py`` — merged-histogram
reader edge cases, quantiles, duration parsing, the two-worker stitched
trace, the freshness pipeline, publication caps, the on-disk time-series
ring and the SLO burn rates. Where a case computes numbers from fixed
inputs, the port's equal the JAX package's on the same inputs."""

import math
import os
import time

import pytest

from opensim_tpu.obs import metrics as ref_metrics
from opensim_tpu.obs import slo as ref_slo
from opensim_tpu.obs import timeseries as ref_ts
from opensim_tpu_torch.engine import prepcache
from opensim_tpu_torch.engine.simulator import prepare
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.models.objects import ResourceTypes
from opensim_tpu_torch.obs import metrics as port_metrics
from opensim_tpu_torch.obs.fleetobs import FRESHNESS, PUB_EVENTS_MAX, new_event_id, publication_tree
from opensim_tpu_torch.obs.metrics import (
    RECORDER,
    bucket_deltas,
    counter_delta,
    histogram_quantile,
    parse_metrics,
)
from opensim_tpu_torch.obs.recorder import FLIGHT_RECORDER
from opensim_tpu_torch.obs.slo import Objective, SLOEngine, parse_objectives, parse_windows
from opensim_tpu_torch.obs.timeseries import TimeSeriesRing, parse_duration_s, render_series_key
from opensim_tpu_torch.server.fleet import FleetTwinClient, TwinPublisher


@pytest.fixture(autouse=True)
def _clean_obs_state():
    RECORDER.reset()
    FRESHNESS.reset()
    FLIGHT_RECORDER.clear()
    yield
    RECORDER.reset()
    FRESHNESS.reset()
    FLIGHT_RECORDER.clear()


def _cluster(n_nodes=6):
    rt = ResourceTypes()
    for i in range(n_nodes):
        rt.nodes.append(fx.make_fake_node(f"n{i:03d}", "16", "64Gi", "110",
                                          fx.with_labels({"topology.kubernetes.io/zone": f"z{i % 3}"})))
    rt.pods.append(fx.make_fake_pod("pinned", "100m", "128Mi", fx.with_node_name("n000")))
    return rt


def _publication_parts(cluster):
    base = prepcache.CacheEntry("t|base", prepare(cluster, [], device="cpu"))
    with base.lock:
        base.restore()
        return prepcache.publication_parts(base)


# ---------------------------------------------------------------------------
# the merged-histogram reader (obs/metrics.py), against the JAX package's
# ---------------------------------------------------------------------------

_LADDER = """\
simon_request_seconds_bucket{{le="0.1",worker="{w}"}} {a}
simon_request_seconds_bucket{{le="1",worker="{w}"}} {b}
simon_request_seconds_bucket{{le="+Inf",worker="{w}"}} {c}
simon_request_seconds_count{{worker="{w}"}} {c}
"""


def _both(fn_name, *args, **kw):
    """The port's reader function and the JAX package's on the same
    inputs; they must agree. Returns the port's result."""
    got = getattr(port_metrics, fn_name)(*args, **kw)
    assert got == getattr(ref_metrics, fn_name)(*args, **kw)
    return got


def test_bucket_merge_empty_worker_contributes_full_after_value():
    """A worker that joined mid-measurement (absent from ``before``)
    contributes its full ``after`` value."""
    text_before = _LADDER.format(w="0", a=10, b=20, c=20)
    text_after = _LADDER.format(w="0", a=30, b=60, c=60) + _LADDER.format(w="1", a=5, b=40, c=40)
    assert parse_metrics(text_after) == ref_metrics.parse_metrics(text_after)
    before, after = parse_metrics(text_before), parse_metrics(text_after)
    deltas = dict(_both("bucket_deltas", before, after, "simon_request_seconds", {}))
    assert deltas[0.1] == (30 - 10) + 5
    assert deltas[1.0] == (60 - 20) + 40
    assert deltas[math.inf] == (60 - 20) + 40
    assert _both("counter_delta", before, after, "simon_request_seconds_count") == 40 + 40


def test_bucket_merge_counter_reset_uses_post_reset_value():
    """A decreased cumulative series means the worker restarted: the
    post-reset value IS the delta (the PromQL convention)."""
    before = parse_metrics(_LADDER.format(w="0", a=100, b=200, c=200))
    after = parse_metrics(_LADDER.format(w="0", a=3, b=7, c=7))
    deltas = dict(bucket_deltas(before, after, "simon_request_seconds", {}))
    assert deltas[0.1] == 3 and deltas[1.0] == 7 and deltas[math.inf] == 7
    assert counter_delta(before, after, "simon_request_seconds_count") == 7
    q = _both("histogram_quantile", before, after, "simon_request_seconds", 0.5)
    assert q is not None and 0.0 <= q <= 1.0


def test_quantile_in_inf_tail_returns_last_finite_bound():
    after = parse_metrics(_LADDER.format(w="0", a=0, b=1, c=100))
    assert _both("histogram_quantile", {}, after, "simon_request_seconds", 0.99) == 1.0


def test_quantile_none_on_empty_delta_and_superset_match():
    scrape = parse_metrics(_LADDER.format(w="0", a=4, b=8, c=8))
    assert histogram_quantile(scrape, scrape, "simon_request_seconds", 0.5) is None  # no traffic → None
    assert histogram_quantile({}, scrape, "simon_request_seconds", 0.5, match={"worker": "7"}) is None
    q = _both("histogram_quantile", {}, scrape, "simon_request_seconds", 0.5, match={"worker": "0"})
    assert q is not None


def test_parse_duration_grammar():
    for text in ("300", "5m", "1h", "2d", "", None):
        assert parse_duration_s(text) == ref_ts.parse_duration_s(text)
    assert parse_duration_s("5m") == 300.0 and parse_duration_s("2d") == 172800.0
    assert parse_duration_s("") is None and parse_duration_s(None) is None
    with pytest.raises(ValueError):
        parse_duration_s("five minutes")


# ---------------------------------------------------------------------------
# cross-process trace stitching across a real publisher/client pair
# ---------------------------------------------------------------------------


def test_stitched_trace_across_two_worker_fleet():
    """Owner accepts an event → publishes generation 1 → two workers
    attach → a request served from the twin carries the owner's event id
    and publication span, and the flight-recorder tree grafts the
    owner-side ``fleet.publication`` subtree under the request."""
    from opensim_tpu_torch.server import rest

    cluster = _cluster()
    parts = _publication_parts(cluster)
    eid = new_event_id()
    FRESHNESS.event_accepted(eid, 1, time.time())
    pub = TwinPublisher()
    clients = []
    server = None
    try:
        pub.publish(1, cluster, parts, state="live", stale=False)
        info = FRESHNESS.pub_info(1)
        assert info is not None and [e for e, _ in info["events"]] == [eid]
        for _ in range(2):  # a two-worker fleet: both attach the same publication
            c = FleetTwinClient(pub.control.name, prep_cache=prepcache.PrepareCache(), device="cpu")
            assert c.start(wait_s=10.0)
            clients.append(c)
        server = rest.SimonServer(watch=clients[0], device="cpu")
        clients[0].prep_cache = server.prep_cache
        rid = "stitch-e2e-000001"
        code, _body = server.deploy_apps({"deployments": [fx.make_fake_deployment("web", 3, "500m", "1Gi").raw]},
                                         request_id=rid)
        assert code == 200
        tr = FLIGHT_RECORDER.get(rid)
        assert tr is not None
        assert tr.serving_generation == 1
        assert tr.root.attrs["fleet_publication"] == info["span"]
        assert eid in tr.root.attrs["fleet_events"].split(",")
        span_names = {sp.name for sp in tr.walk()}
        assert "snapshot" in span_names and "fleet.attach" in span_names
        (attach,) = [sp for sp in tr.walk() if sp.name == "fleet.attach"]
        assert attach.attrs["attach_s"] >= 0.0 and attach.attrs["upload_s"] >= 0.0
        node = publication_tree(tr.serving_generation)
        assert node is not None and node["name"] == "fleet.publication"
        assert node["span"] == info["span"]
        (ev,) = node["events"]
        assert ev["event_id"] == eid
        assert ev["accept_to_publish_s"] >= 0.0
        assert ev["accept_to_attach_s"] >= ev["accept_to_publish_s"] - 1e-6
        assert ev["accept_to_serve_s"] >= ev["accept_to_attach_s"] - 1e-6
        assert node["first_served_unix"] >= node["published_unix"] - 1e-6
    finally:
        if server is not None:
            server.close()
        for c in clients:
            c.stop()
        pub.close()


def test_freshness_histogram_moves_under_twin_storm():
    """A publish storm moves the owner-side ``published`` stage once per
    accepted event; an attaching worker then moves ``attached`` and
    ``served`` for the carried ids (FRESHNESS is per process in a real
    fleet: the reset between the halves recreates the split)."""
    cluster = _cluster(3)
    pub = TwinPublisher()
    client = None
    try:
        accepted = 0
        for gen in range(1, 6):
            for _ in range(3):
                FRESHNESS.event_accepted(new_event_id(), gen, time.time())
                accepted += 1
            pub.publish(gen, cluster, None)
        scrape = parse_metrics("\n".join(FRESHNESS.metrics_lines()))
        assert counter_delta({}, scrape, "simon_fleet_freshness_seconds_count", {"stage": "published"}) == accepted

        FRESHNESS.reset()  # now play the worker process
        client = FleetTwinClient(pub.control.name, prep_cache=prepcache.PrepareCache(), device="cpu")
        assert client.start(wait_s=10.0)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if client.serving_snapshot()[1] == "fleet|5":
                break
            time.sleep(0.01)
        gen, info = client.stitch_info()  # the first service closes the pipeline
        assert gen == 5 and isinstance(info, dict)
        scrape = parse_metrics("\n".join(FRESHNESS.metrics_lines()))
        counts = {stage: counter_delta({}, scrape, "simon_fleet_freshness_seconds_count", {"stage": stage})
                  for stage in ("attached", "served")}
        assert 0 < counts["attached"] <= PUB_EVENTS_MAX
        assert 0 < counts["served"] <= counts["attached"]
    finally:
        if client is not None:
            client.stop()
        pub.close()


def test_publication_caps_carried_event_ids():
    for _ in range(PUB_EVENTS_MAX * 3):
        FRESHNESS.event_accepted(new_event_id(), 1, time.time())
    info = FRESHNESS.publication(1)
    assert len(info["events"]) == PUB_EVENTS_MAX
    scrape = parse_metrics("\n".join(FRESHNESS.metrics_lines()))
    # every folded event was still observed; only the carried ids are capped
    assert counter_delta({}, scrape, "simon_fleet_freshness_seconds_count",
                         {"stage": "published"}) == PUB_EVENTS_MAX * 3


def test_journal_record_carries_event_id_and_journaled_stage(tmp_path):
    from opensim_tpu_torch.server.journal import Journal, iter_records

    jd = str(tmp_path / "journal")
    journal = Journal(jd, policy={"fsync": "always"})
    try:
        journal.record_event("pods", "ADDED",
                             {"metadata": {"name": "p", "namespace": "default", "resourceVersion": "2"}},
                             2, eid="abc123def456", ts=time.time())
        assert journal.flush(timeout=10.0)
    finally:
        journal.close()
    assert [r.get("eid") for r in iter_records(jd) if r["t"] == "ev"] == ["abc123def456"]
    scrape = parse_metrics("\n".join(FRESHNESS.metrics_lines()))
    assert counter_delta({}, scrape, "simon_fleet_freshness_seconds_count", {"stage": "journaled"}) == 1


def test_watch_dispatch_stamps_accepted_events_for_the_publication(tmp_path):
    """An event the live twin accepts is pending for the next publication:
    its id rides the journal record and the publication stamp alike."""
    from opensim_tpu_torch.server.journal import Journal, iter_records
    from opensim_tpu_torch.server.watch import WatchSupervisor

    class _NoSource:
        def list_all(self):
            raise AssertionError("not listed")

    sup = WatchSupervisor(_NoSource(), policy={"stale_s": 5.0, "resync_s": 0.0, "reconnects": 1,
                                               "backoff_s": 0.01})
    jd = str(tmp_path / "journal")
    journal = Journal(jd, policy={"fsync": "always"})
    sup.attach_journal(journal)
    try:
        sup.dispatch("pods", "ADDED", {"metadata": {"name": "p", "namespace": "default", "resourceVersion": "3"},
                                       "spec": {}, "status": {"phase": "Pending"}})
        assert journal.flush(timeout=10.0)
    finally:
        journal.close()
    (eid,) = [r["eid"] for r in iter_records(jd) if r["t"] == "ev"]
    info = FRESHNESS.publication(sup.twin.generation)
    assert [e for e, _ts in info["events"]] == [eid]


# ---------------------------------------------------------------------------
# the time-series ring: bounded by construction, exact round trip, and the
# JAX package's ring on the same samples
# ---------------------------------------------------------------------------


def _sample(i: int):
    """A scrape with delta-unfriendly floats (0.1 steps do NOT invert
    exactly in IEEE754: the encoder must fall back to absolutes)."""
    return {
        ("simon_requests_total", ()): float(i * 7),
        ("simon_request_seconds_sum", ()): i * 0.1,
        ("simon_request_seconds_bucket", (("le", "+Inf"),)): float(i),
        ("simon_lane_depth", (("lane", "interactive"),)): float(i % 3),
    }


def test_ring_is_bounded_and_roundtrips_exactly(tmp_path):
    d = str(tmp_path / "ring")
    ring = TimeSeriesRing(directory=d, windows=3, window_samples=4)
    ref = ref_ts.TimeSeriesRing(directory=str(tmp_path / "ref"), windows=3, window_samples=4)
    appended = []
    for i in range(20):  # 5 full windows through a 3-window ring
        ts = 1000.0 + i
        series = _sample(i)
        ring.append(ts, series)
        ref.append(ts, series)
        appended.append((ts, {render_series_key(k): v for k, v in series.items()}))
    files = [n for n in os.listdir(d) if n.startswith("win-") and n.endswith(".json")]
    assert len(files) <= 2  # windows-1 sealed files + the in-memory open window
    st = ring.stats()
    assert st["windows"] <= 3 and st["bytes"] > 0
    got = ring.query()
    assert 4 <= len(got) <= 12
    assert got == appended[-len(got):]  # equality, not tolerance
    assert got == ref.query() and st == {**ref.stats(), "directory": st["directory"]}
    ring.close()
    ref.close()
    assert sorted(os.listdir(d)) == sorted(files)  # an explicit directory outlives close()


def test_ring_adopts_existing_directory_and_keeps_bound(tmp_path):
    d = str(tmp_path / "ring")
    ring = TimeSeriesRing(directory=d, windows=3, window_samples=2)
    for i in range(8):
        ring.append(1000.0 + i, _sample(i))
    ring.close()
    reborn = TimeSeriesRing(directory=d, windows=3, window_samples=2)
    assert reborn.stats()["windows"] == 2  # the previous run's sealed files adopted
    assert reborn.query()[-1][0] == 1007.0
    for i in range(8, 12):
        reborn.append(1000.0 + i, _sample(i))
    assert len([n for n in os.listdir(d) if n.startswith("win-")]) <= 2
    reborn.close()


def test_ring_query_family_and_range_filters(tmp_path):
    ring = TimeSeriesRing(directory=str(tmp_path / "r"), windows=4, window_samples=3)
    ref = ref_ts.TimeSeriesRing(directory=str(tmp_path / "ref"), windows=4, window_samples=3)
    for i in range(7):
        ring.append(1000.0 + i * 10, _sample(i))
        ref.append(1000.0 + i * 10, _sample(i))
    fam = ring.query(family="simon_request_seconds")
    assert fam and all(k.split("{", 1)[0] in ("simon_request_seconds_sum", "simon_request_seconds_bucket")
                       for _ts, s in fam for k in s)
    assert fam == ref.query(family="simon_request_seconds")
    recent = ring.query(range_s=25.0, now=1060.0)
    assert [ts for ts, _ in recent] == [1040.0, 1050.0, 1060.0]
    assert recent == ref.query(range_s=25.0, now=1060.0)
    with pytest.raises(ValueError):
        parse_duration_s("1w")
    ring.close()
    ref.close()


# ---------------------------------------------------------------------------
# the SLO engine: burn rates vs hand-computed windows and the JAX package's
# ---------------------------------------------------------------------------


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
    }


def test_slo_burn_rates_match_hand_computed_windows(tmp_path):
    payloads, texts = [], []
    for ring_mod, slo_mod, name in ((None, None, "port"), (ref_ts, ref_slo, "ref")):
        ring = (ring_mod.TimeSeriesRing if ring_mod else TimeSeriesRing)(
            directory=str(tmp_path / name), windows=4, window_samples=64)
        ring.append(900.0, _slo_scrape(ok=100, err=0, under_100ms=100, fresh_under_30=0, fresh_total=0))
        ring.append(1000.0, _slo_scrape(ok=190, err=10, under_100ms=190, fresh_under_30=95, fresh_total=100))
        obj = slo_mod.Objective if slo_mod else Objective
        engine = (slo_mod.SLOEngine if slo_mod else SLOEngine)(
            ring, objectives=[obj("availability", 99.0), obj("latency_p99", 99.0, 0.1), obj("freshness", 99.0, 30.0)],
            windows=[("5m", 300.0), ("30s", 30.0)])
        payloads.append(engine.evaluate(now=1000.0))
        texts.append(engine.metrics_lines(now=1000.0))
        ring.close()
    assert payloads[0] == payloads[1] and texts[0] == texts[1]
    rows = {r["name"]: r for r in payloads[0]["objectives"]}
    # availability: 10 bad of 100 new requests; budget 1% → burn 10×
    win = rows["availability"]["windows"]["5m"]
    assert (win["bad"], win["total"], win["burn_rate"]) == (10.0, 100.0, 10.0)
    win = rows["latency_p99"]["windows"]["5m"]
    assert (win["bad"], win["total"], win["burn_rate"]) == (10.0, 100.0, 10.0)
    assert win["bucket_bound_s"] == 0.1
    win = rows["freshness"]["windows"]["5m"]
    assert (win["bad"], win["total"], win["burn_rate"]) == (5.0, 100.0, 5.0)
    assert win["bucket_bound_s"] == 30.0
    # the 30 s window holds ONE sample → no_data, burn pinned to 0.0
    for name in rows:
        short = rows[name]["windows"]["30s"]
        assert short["no_data"] is True and short["burn_rate"] == 0.0
    assert 'simon_slo_burn_rate{slo="availability",window="5m"} 10' in texts[0]
    assert 'simon_slo_burn_rate{slo="freshness",window="30s"} 0' in texts[0]


def test_slo_and_window_parsers_fail_loudly():
    spec = "availability:99.9,latency_p99:99:2.5,freshness:99:30"
    objs = parse_objectives(spec)
    assert [(o.kind, o.target_pct, o.threshold_s) for o in objs] == [
        (o.kind, o.target_pct, o.threshold_s) for o in ref_slo.parse_objectives(spec)]
    assert [(o.kind, o.target_pct, o.threshold_s) for o in objs] == [
        ("availability", 99.9, None), ("latency_p99", 99.0, 2.5), ("freshness", 99.0, 30.0)]
    assert abs(objs[0].budget - 0.001) < 1e-12
    for bad in ("latency_p99:99", "uptime:99", "availability:100"):
        with pytest.raises(ValueError):
            parse_objectives(bad)
    assert parse_windows("5m,1h") == ref_slo.parse_windows("5m,1h") == [("5m", 300.0), ("1h", 3600.0)]
    with pytest.raises(ValueError):
        parse_windows("5x")
