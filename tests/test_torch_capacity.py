"""The port's capacity observatory (``obs/capacity.py``, ``obs/timeline.py``)
on the CPU against the JAX package's: the engine's samples, the headroom
probes (against the JAX probe and a fresh port ``simulate()``: the full
cluster, a warm base entry, a ladder regrown past a low bound, the smoke
run's profile fixture), the report body byte for byte, the REST report,
timeline and ``/metrics`` families against the JAX server's, and ``simon
top`` one-shot against the JAX CLI's rendering; the engine fed event by
event through the live twin's supervisor against a fresh bootstrap and
the JAX supervisor's engine, and a headroom probe through a twin entry's
masked rows. The lint cases of tests/test_capacity.py belong to a later
slice (ROADMAP Queue 1 item 11)."""

import copy
import dataclasses
import json
import threading
import urllib.request
from contextlib import contextmanager

import pytest

from opensim_tpu.cli import main as ref_cli
from opensim_tpu.models import expand as ref_expand
from opensim_tpu.obs import capacity as ref_cap
from opensim_tpu.server import rest as ref_rest
from opensim_tpu_torch.cli import main as cli
from opensim_tpu_torch.engine import fastpath, prepcache
from opensim_tpu_torch.engine.simulator import AppResource, prepare, simulate
from opensim_tpu_torch.models import ResourceTypes, fixtures as fx
from opensim_tpu_torch.models.objects import Pod
from opensim_tpu_torch.obs import capacity as cap
from opensim_tpu_torch.obs.metrics import RECORDER, parse_metrics
from opensim_tpu_torch.obs.timeline import Sample, Timeline
from opensim_tpu_torch.server import rest
from opensim_tpu_torch.utils.trace import PREP_STATS


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for name in ("OPENSIM_HEADROOM_PROFILES", "OPENSIM_CAPACITY_TOPK"):
        monkeypatch.delenv(name, raising=False)
    RECORDER.reset()
    yield
    RECORDER.reset()


def _reference_copy(rt):
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def _cluster(n_nodes=4, n_pods=6, pending=0, labelled=False, succeeded=False):
    """tests/test_capacity.py's cluster in the port's objects, with
    `pending` unbound pods besides; `labelled`: the first pod carries an
    app label, `succeeded`: the first pod has finished."""
    rt = ResourceTypes()
    for i in range(n_nodes):
        rt.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi"))
    for i in range(n_pods):
        opts = [fx.with_labels({"simon/app-name": "demo"})] if labelled and i == 0 else []
        pod = fx.make_fake_pod(f"p{i}", "500m", "1Gi", fx.with_node_name(f"n{i % n_nodes}"), *opts)
        if succeeded and i == 0:
            pod = Pod.from_dict(dict(pod.raw, status={"phase": "Succeeded"}))
        rt.pods.append(pod)
    for i in range(pending):
        rt.pods.append(fx.make_fake_pod(f"q{i}", "250m", "512Mi"))
    return rt


def _no_ts(obj):
    """A report body or sample without its wall-clock timestamp."""
    out = json.loads(json.dumps(obj))
    for holder in (out, out.get("capacity") or {}):
        holder.pop("ts", None)
    return out


@pytest.mark.parametrize("topk", [0, 2, 10])
def test_sample_equals_reference(topk):
    cluster = _cluster(n_nodes=5, n_pods=9, pending=2, succeeded=True)
    assert cluster.pods[0].phase == "Succeeded"
    mine, theirs = cap.CapacityEngine(topk=topk), ref_cap.CapacityEngine(topk=topk)
    mine.bootstrap(cluster, 3)
    theirs.bootstrap(_reference_copy(cluster), 3)
    assert _no_ts(mine.sample().to_dict()) == _no_ts(theirs.sample().to_dict())
    assert mine.metrics_lines() == theirs.metrics_lines()
    profile = cap.WorkloadProfile("t", "1500m", "3Gi")
    assert mine.fit_upper_bound(profile) == theirs.fit_upper_bound(ref_cap.WorkloadProfile("t", "1500m", "3Gi"))


def _fits(cluster, profile, n) -> bool:
    rt = ResourceTypes()
    rt.add(fx.make_fake_deployment("probe", n, profile.cpu, profile.memory))
    return not simulate(cluster, [AppResource("probe", rt)], device="cpu").unscheduled_pods


@pytest.mark.parametrize("case", ["frontier", "full", "regrow"])
def test_headroom_equals_reference_and_simulate(case):
    """The probe's k equals the JAX probe's, and a fresh port simulate()
    places k replicas and not k + 1: a frontier inside the ladder, a full
    cluster (0) and a bound below the truth, which regrows the ladder."""
    if case == "full":
        cluster = _cluster(n_nodes=1, n_pods=0)
        cluster.pods.append(fx.make_fake_pod("hog", "7500m", "12Gi", fx.with_node_name("n0")))
        spec = ("big", "2", "4Gi", 16)
    else:
        cluster = _cluster(n_nodes=3 if case == "frontier" else 2, n_pods=4 if case == "frontier" else 0)
        spec = ("t", "1500m", "3Gi", 64)
    profile, ref_profile = cap.WorkloadProfile(*spec), ref_cap.WorkloadProfile(*spec)
    engine = cap.CapacityEngine()
    engine.bootstrap(cluster, 1)
    kmax = 2 if case == "regrow" else engine.fit_upper_bound(profile)
    k = cap.headroom_probe(cluster, profile, kmax=kmax, device="cpu")
    assert k == ref_cap.headroom_probe(_reference_copy(cluster), ref_profile, kmax=kmax)
    if case == "full":
        assert engine.fit_upper_bound(profile) == 0 and k == 0
        return
    assert 0 < k < profile.max_replicas
    assert _fits(cluster, profile, k) and not _fits(cluster, profile, k + 1)


def test_headroom_launches_one_ladder_and_one_per_bisection_step(monkeypatch):
    """Each probe scan is one grid call (one launch on a card): the ladder
    in one, each bisection step at S = 1."""
    cluster = _cluster(n_nodes=3, n_pods=4)
    profile = cap.WorkloadProfile("t", "1500m", "3Gi", max_replicas=64)
    scans, grids = [], []
    real_scan, real_grid = cap._probe_scan, fastpath.fast_scan_sweep
    monkeypatch.setattr(cap, "_probe_scan", lambda prep, sl, drop, ks: scans.append(list(ks)) or real_scan(
        prep, sl, drop, ks))
    monkeypatch.setattr(fastpath, "fast_scan_sweep", lambda fi, tmpl, valid, *a, **kw: grids.append(
        valid.shape[0]) or real_grid(fi, tmpl, valid, *a, **kw))
    engine = cap.CapacityEngine()
    engine.bootstrap(cluster, 1)
    k = cap.headroom_probe(cluster, profile, kmax=engine.fit_upper_bound(profile), device="cpu")
    assert grids == [len(ks) for ks in scans]
    # ladders (a second one when the resource bound fit whole), then the
    # bisection's S = 1 steps
    ladders = [ks for ks in scans if len(ks) > 1]
    assert scans[: len(ladders)] == ladders and len(scans) > len(ladders)
    assert k in sum(scans, [])


def test_headroom_through_warm_base_entry_skips_full_prepare():
    cluster = _cluster()
    profile = cap.WorkloadProfile("t", "1", "2Gi", max_replicas=32)
    base = prepcache.CacheEntry("test|base", prepare(cluster, [], device="cpu"),
                                watch=prepcache.watch_snapshot(cluster, []))
    cold = cap.headroom_probe(cluster, profile, kmax=32, device="cpu")
    full_before = PREP_STATS.counts.get("full", 0)
    assert cap.headroom_probe(cluster, profile, base=base, kmax=32) == cold
    assert PREP_STATS.counts.get("full", 0) == full_before
    assert cold == ref_cap.headroom_probe(_reference_copy(cluster), ref_cap.WorkloadProfile("t", "1", "2Gi", 32),
                                          kmax=32)


def test_headroom_through_a_twin_entry_drops_its_deleted_pods():
    """A live-twin base entry whose watch-deleted pods are masked rows
    (``base_drop``): the probe drops them in every launch, so its k is the
    k of the cluster without them (a fresh probe and a fresh simulate())."""
    cluster = _cluster(n_nodes=2, n_pods=6)
    profile = cap.WorkloadProfile("t", "1500m", "3Gi", max_replicas=64)
    base = prepcache.CacheEntry("twin|1|3|base", prepare(cluster, [], device="cpu"))
    gone = {("default", "p0"), ("default", "p2"), ("default", "p4")}  # the pods on n0
    with base.lock:
        entry = prepcache.twin_pod_delta(base, "twin|1|4|base", [], gone)
    assert int(entry.base_drop.sum()) == 3
    after = _cluster(n_nodes=2, n_pods=6)
    after.pods = [p for p in after.pods if (p.metadata.namespace, p.metadata.name) not in gone]
    k = cap.headroom_probe(after, profile, base=entry, kmax=64)
    assert k == cap.headroom_probe(after, profile, kmax=64, device="cpu")
    assert k > cap.headroom_probe(cluster, profile, kmax=64, device="cpu")
    assert _fits(after, profile, k) and not _fits(after, profile, k + 1)


def _ev_pod(name, node="", cpu="500m", mem="1Gi", phase="Running", rv=None):
    d = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": "default"},
         "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": cpu, "memory": mem}}}]},
         "status": {"phase": phase}}
    if node:
        d["spec"]["nodeName"] = node
    if rv is not None:
        d["metadata"]["resourceVersion"] = str(rv)
    return d


def _ev_node(name, cpu, mem, rv=None):
    d = json.loads(json.dumps(fx.make_fake_node(name, cpu, mem).raw))
    if rv is not None:
        d["metadata"]["resourceVersion"] = str(rv)
    return d


_STORMS = {
    # adds, a rebind, a delete, a node add, a terminal pod, a duplicate
    "pods": ([_ev_node(f"n{i}", "8", "16Gi") for i in range(3)],
             [_ev_pod("a", node="n0", rv=1), _ev_pod("b", node="n1", cpu="2", mem="4Gi", rv=2),
              _ev_pod("pending", rv=3)],
             [("pods", "ADDED", _ev_pod("c", node="n2", cpu="1", rv=10)),
              ("pods", "ADDED", _ev_pod("d", rv=11)),
              ("pods", "MODIFIED", _ev_pod("pending", node="n1", rv=12)),
              ("pods", "DELETED", _ev_pod("a", node="n0", rv=13)),
              ("nodes", "ADDED", _ev_node("n3", "4", "8Gi")),
              ("pods", "MODIFIED", _ev_pod("b", node="n1", cpu="2", mem="4Gi", phase="Succeeded", rv=14)),
              ("pods", "ADDED", _ev_pod("c", node="n2", cpu="1", rv=10))]),
    # a node resized, a node deleted and re-added
    "node-flap": ([_ev_node(f"n{i}", "8", "16Gi") for i in range(2)], [_ev_pod("a", node="n0", rv=1)],
                  [("nodes", "MODIFIED", _ev_node("n0", "32", "64Gi", rv=20)),
                   ("nodes", "DELETED", _ev_node("n1", "8", "16Gi", rv=21)),
                   ("nodes", "ADDED", _ev_node("n1", "8", "16Gi", rv=22))]),
}


@pytest.mark.parametrize("storm", sorted(_STORMS))
def test_event_fed_engine_matches_fresh_bootstrap_and_the_reference(storm):
    """A storm of pod and node events through the port's watch supervisor
    dispatch (the capacity engine fed event by event): its aggregates equal
    a fresh O(cluster) bootstrap of the final twin, and its sample and
    /metrics lines equal the JAX supervisor's engine fed the same events;
    the watch-apply histogram counts every applied dispatch."""
    from opensim_tpu.server.watch import WatchSupervisor as RefSupervisor
    from opensim_tpu_torch.server.watch import WatchSupervisor

    nodes, pods, events = _STORMS[storm]
    policy = {"stale_s": 30.0, "resync_s": 0.0, "reconnects": 1, "backoff_s": 0.0}
    sups = (WatchSupervisor(source=None, policy=policy), RefSupervisor(source=None, policy=policy))
    engines = (cap.CapacityEngine(topk=5), ref_cap.CapacityEngine(topk=5))
    for sup, engine in zip(sups, engines):
        sup.capacity = engine
        sup.twin.rebase("nodes", copy.deepcopy(nodes))
        sup.twin.rebase("pods", copy.deepcopy(pods))
        sup._capacity_rebase()
        assert engine.event_fed
        for field, kind, obj in events:
            sup.dispatch(field, kind, copy.deepcopy(obj))
    ours, theirs = engines
    fresh = cap.CapacityEngine(topk=5)
    fresh.bootstrap(sups[0].twin.materialize(), sups[0].twin.generation)
    assert ours.generation == sups[0].twin.generation == sups[1].twin.generation
    assert _no_ts(ours.sample().to_dict()) == _no_ts(fresh.sample().to_dict())
    assert ours._dist == fresh._dist
    assert _no_ts(ours.sample().to_dict()) == _no_ts(theirs.sample().to_dict())
    assert ours.metrics_lines() == theirs.metrics_lines()
    applied = len(events) if storm == "pods" else 3
    assert f"simon_watch_apply_seconds_count {applied}" in "\n".join(RECORDER.render_lines())


def test_headroom_profile_fixture_frontier_inside_its_ladder():
    """The smoke run's profile on a small bound fleet: its headroom is the
    JAX probe's, the number of nodes that tie for the most free resources,
    and inside its ladder."""
    cluster = fx.synthetic_cluster(24)
    res = simulate(cluster, [AppResource("seed", fx.server_apps(240, 0, fx.SERVER_BOUND))], device="cpu")
    bound = fx.synthetic_cluster(24)
    bound.pods = [Pod.from_dict(fx.snapshot_pod(p)) for ns in res.node_status for p in ns.pods]
    spec = fx.headroom_profile(bound)
    name, _, rest_ = spec.partition("=")
    cpu, mem, max_r = rest_.split(":")
    profile = cap.WorkloadProfile(name, cpu, mem, int(max_r))
    engine = cap.CapacityEngine()
    engine.bootstrap(bound, 1)
    k = cap.headroom_probe(bound, profile, kmax=engine.fit_upper_bound(profile), device="cpu")
    ref_bound = _reference_copy(bound)
    assert k == ref_cap.headroom_probe(ref_bound, ref_cap.WorkloadProfile(name, cpu, mem, int(max_r)),
                                       kmax=engine.fit_upper_bound(profile))
    # one replica on each node that ties for the most free
    assert 0 < k == profile.max_replicas // 4 < profile.max_replicas


def test_headroom_profiles_env_parsing(monkeypatch):
    monkeypatch.setenv("OPENSIM_HEADROOM_PROFILES", "web=250m:512Mi,batch=2:4Gi:128")
    assert [(p.name, p.max_replicas) for p in cap.headroom_profiles()] == [("web", 256), ("batch", 128)]
    for bad in ("oops", "a=1", "a=0:0", "a=1:1Gi:x", "a=1:1Gi,a=2:2Gi", "b ad=1:1Gi", "a=1:1Gi:0"):
        monkeypatch.setenv("OPENSIM_HEADROOM_PROFILES", bad)
        with pytest.raises(ValueError):
            cap.headroom_profiles()


def test_build_report_equals_reference_byte_for_byte():
    cluster = _cluster(pending=1, labelled=True)
    cluster.pods.append(fx.make_fake_pod("ghost", "1", "1Gi", fx.with_node_name("gone-node")))
    mine, theirs = cap.CapacityEngine(), ref_cap.CapacityEngine()
    mine.bootstrap(cluster, 1)
    theirs.bootstrap(_reference_copy(cluster), 1)
    for extended in ([], ["gpu", "open-local"]):
        got = cap.build_report(mine, cluster, extended_resources=extended, state="t")
        want = ref_cap.build_report(theirs, _reference_copy(cluster), extended_resources=extended, state="t")
        assert json.dumps(_no_ts(got), sort_keys=True) == json.dumps(_no_ts(want), sort_keys=True)
        assert cap.format_top(got) == ref_cap.format_top(got)
    assert got["orphaned"] == ["default/ghost (on gone-node)"] and got["pending"] == ["default/q0"]


def test_timeline_ring_and_generation_keyed_samples():
    tl = Timeline(capacity=4)
    for g in range(10):
        tl.append(Sample(generation=g))
    assert [s.generation for s in tl.snapshot()] == [6, 7, 8, 9]
    enriched = Sample(generation=9)
    enriched.headroom = {"small": 3}
    tl.append(enriched)
    assert len(tl) == 4 and tl.latest().headroom == {"small": 3}
    assert Sample.from_dict(enriched.to_dict()).to_dict() == enriched.to_dict()
    engine = cap.CapacityEngine()
    engine.ensure_bootstrap(_cluster(), "fp1")
    s1 = engine.sample()
    engine.ensure_bootstrap(_cluster(), "fp1")
    assert engine.sample() is s1 and len(engine.timeline) == 1
    engine.ensure_bootstrap(_cluster(), "fp2")
    assert engine.sample().generation == s1.generation + 1 and len(engine.timeline) == 2


@contextmanager
def _serving(server, handler):
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        body = resp.read().decode()
    return json.loads(body) if body.startswith("{") else body


def test_rest_report_timeline_and_metrics_equal_reference(monkeypatch):
    """The port's server (on the CPU) and the JAX package's on one fixed
    cluster: the same report (headroom probed, then ``?headroom=0`` and
    ``?extended=``), the same timeline and the same ``simon_cluster_*``
    lines in ``/metrics``."""
    monkeypatch.setenv("OPENSIM_HEADROOM_PROFILES", "small=500m:1Gi,large=4:8Gi,t=1500m:3Gi:64")
    cluster = _cluster(pending=1)
    port = rest.SimonServer(base_cluster=cluster, device="cpu")
    ref = ref_rest.SimonServer(base_cluster=_reference_copy(cluster), admission=False)
    try:
        with _serving(port, rest.make_handler) as mine, _serving(ref, ref_rest.make_handler) as theirs:
            for path in ("/api/cluster/report", "/api/cluster/report?headroom=0",
                         "/api/cluster/report?extended=gpu,open-local"):
                got, want = _get(mine + path), _get(theirs + path)
                assert _no_ts(got) == _no_ts(want), path
            assert set(got["capacity"]["headroom"]) == {"large", "small", "t"}
            tl_got, tl_want = _get(mine + "/api/debug/capacity"), _get(theirs + "/api/debug/capacity")
            assert [_no_ts(s) for s in tl_got["samples"]] == [_no_ts(s) for s in tl_want["samples"]]
            assert tl_got["samples"][-1]["generation"] == got["capacity"]["generation"]
            cluster_lines = lambda text: [ln for ln in text.splitlines() if "simon_cluster_" in ln]
            m_got, m_want = _get(mine + "/metrics"), _get(theirs + "/metrics")
            assert cluster_lines(m_got) == cluster_lines(m_want)
            metrics = parse_metrics(m_got)
            for name in ("small", "large", "t"):
                assert metrics[("simon_cluster_headroom", (("profile", name),))] == got["capacity"]["headroom"][name]
    finally:
        ref.close()


def test_simon_top_one_shot_equals_reference(capsys):
    cluster = _cluster()
    port = rest.SimonServer(base_cluster=cluster, device="cpu")
    with _serving(port, rest.make_handler) as url:
        assert cli.main(["top", "--url", url, "--json"]) == 0
        body = json.loads(capsys.readouterr().out)
        assert body == _get(url + "/api/cluster/report")
        assert cli.main(["top", "--url", url]) == 0
        text = capsys.readouterr().out
        assert ref_cli.main(["top", "--url", url]) == 0
        assert text == capsys.readouterr().out
        assert "Headroom" in text and "Resource" in text
        assert cli.main(["top", "--url", url, "--no-headroom", "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["capacity"]["nodes"] == 4
    assert cli.main(["top", "--url", "http://127.0.0.1:9", "--timeout", "2"]) == 1


def test_only_item_10_routes_answer_501():
    """Item 10's memory and profile routes answer 501; the fleet's
    time-series and SLO routes are served (503 until serve() starts the
    ring)."""
    assert set(rest.NOT_PORTED.values()) == {10}
    assert set(rest.NOT_PORTED) == {"/api/debug/memory", "/api/debug/profile", "/debug/profiler"}
    server = rest.SimonServer(base_cluster=_cluster(), device="cpu", capacity=False)
    with _serving(server, rest.make_handler) as url:
        for path, code in (("/api/debug/memory", 501), ("/api/debug/profile", 501), ("/debug/profiler", 501),
                           ("/api/fleet/slo", 503), ("/api/debug/timeseries", 503)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(url + path)
            assert ei.value.code == code, path
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(url + "/api/debug/capacity")
        assert ei.value.code == 404
