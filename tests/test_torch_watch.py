"""The port's live twin (``server/watch.py``) on the CPU, the cases of
tests/test_watch.py: rv-monotonic event application, admissibility
transitions, node events, rv-aware reconcile, ``twin_pod_delta`` and mixed
node and pod waves against a fresh prepare by index, the compaction
refusal, the warm path (deltas, no full prepare), staleness and bookmarks,
stale-tagged answers, the four watch faults converging, 410 at the source,
the fallback to polling, ``--watch on`` without a kubeconfig and the
policy validation — all end to end against the port's stub apiserver
(``server/stubapi.py``) over the stdlib REST watch source. Against the JAX
package: the same event sequence through both ``ClusterTwin``s gives equal
fingerprints; both ``twin_pod_delta``s on the same cluster and events
place equally by index (the port's plain scan, the JAX XLA scan); a deploy
served by the port's twin server equals the JAX twin server's on the same
stub and events. Stub waits use short bookmark and stale intervals, and
every wait has a deadline."""

import copy
import dataclasses
import json
import re
import threading
import time
import urllib.request
from contextlib import contextmanager

import pytest

from opensim_tpu.engine import prepcache as ref_prepcache
from opensim_tpu.engine import simulator as ref_sim
from opensim_tpu.models import expand as ref_expand
from opensim_tpu.server import rest as ref_rest
from opensim_tpu.server import watch as ref_watch
from opensim_tpu_torch.cli import main as cli
from opensim_tpu_torch.engine import prepcache
from opensim_tpu_torch.engine.prepcache import fingerprint_cluster
from opensim_tpu_torch.engine.simulator import prepare, simulate
from opensim_tpu_torch.models import ResourceTypes, fixtures as fx
from opensim_tpu_torch.models.objects import Node, Pod
from opensim_tpu_torch.obs.recorder import FLIGHT_RECORDER
from opensim_tpu_torch.resilience import faults
from opensim_tpu_torch.server import rest
from opensim_tpu_torch.server.snapshot import _cluster_via_rest
from opensim_tpu_torch.server.stubapi import StubApiServer
from opensim_tpu_torch.server.watch import ClusterTwin, GoneError, RestWatchSource, WatchSupervisor, watch_policy
from opensim_tpu_torch.utils.trace import PREP_STATS

# small knobs so failure paths resolve in tens of milliseconds, not minutes
FAST = {"stale_s": 3.0, "resync_s": 0.0, "reconnects": 3, "backoff_s": 0.01}

LIST_PATHS = (
    "/api/v1/nodes",
    "/api/v1/pods",
    "/apis/apps/v1/daemonsets",
    "/apis/policy/v1/poddisruptionbudgets",
    "/api/v1/services",
    "/apis/storage.k8s.io/v1/storageclasses",
    "/api/v1/persistentvolumeclaims",
    "/api/v1/configmaps",
)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("OPENSIM_FAULTS", raising=False)
    faults.clear_faults()
    yield
    faults.clear_faults()


def _pod_dict(name, phase="Pending", node="", cpu="100m", rv=None):
    d = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": cpu, "memory": "64Mi"}}}]},
        "status": {"phase": phase},
    }
    if node:
        d["spec"]["nodeName"] = node
    if rv is not None:
        d["metadata"]["resourceVersion"] = str(rv)
    return d


def _wait(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _seed(stub, n_nodes=4, pods=()):
    stub.seed("/api/v1/nodes", [fx.make_fake_node(f"n{i}", "8", "16Gi").raw for i in range(n_nodes)])
    stub.seed("/api/v1/pods", list(pods))
    for p in LIST_PATHS[2:]:
        stub.seed(p, [])


@contextmanager
def _twin_server(tmp_path, policy=None, bookmark_s=0.1, pods=(), wire_server=True):
    """The port's stub apiserver, a synced supervisor and (optionally) a
    port SimonServer on the CPU whose encode cache the supervisor keeps."""
    stub = StubApiServer(bookmark_interval_s=bookmark_s).start()
    _seed(stub, pods=pods)
    kc = stub.kubeconfig(tmp_path)
    pol = dict(FAST, **(policy or {}))
    sup = WatchSupervisor(RestWatchSource(kc, read_timeout_s=max(pol["stale_s"], 3.0)), policy=pol)
    server = rest.SimonServer(kubeconfig=kc, watch=sup, device="cpu", admission=False) if wire_server else None
    try:
        assert sup.start(wait_s=15.0), "twin failed to sync against the stub"
        yield stub, sup, server, kc
    finally:
        if server is not None:
            server.close()
        sup.stop()
        stub.stop()


def _payload():
    return {"deployments": [fx.make_fake_deployment("web", 5, "500m", "1Gi").raw]}


def _names(obj) -> str:
    """`obj` as JSON without the process counters in pod names."""
    return re.sub(r"-[0-9a-f]{10}\b", "-#", json.dumps(obj, sort_keys=True))


def _reference_copy(rt):
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


# ---------------------------------------------------------------------------
# ClusterTwin: duplicates, reordering, tombstones
# ---------------------------------------------------------------------------


def test_twin_event_application_is_rv_monotonic():
    twin = ClusterTwin()
    twin.rebase("pods", [_pod_dict("a", rv=5)])
    gen0 = twin.generation
    assert twin.apply_event("pods", "ADDED", _pod_dict("a", rv=5)) is None  # duplicate
    assert twin.generation == gen0
    assert twin.apply_event("pods", "MODIFIED", _pod_dict("a", rv=4)) is None  # reordered stale
    assert twin.apply_event("pods", "MODIFIED", _pod_dict("a", rv=9))[0] == "rebuild"
    change = twin.apply_event("pods", "ADDED", _pod_dict("b", rv=10))
    assert change[0] == "pod_add" and change[1].metadata.name == "b"
    assert twin.apply_event("pods", "DELETED", _pod_dict("a", rv=12)) == ("pod_del", ("default", "a"))
    # the tombstone: a reordered stale MODIFIED cannot resurrect the pod
    assert twin.apply_event("pods", "MODIFIED", _pod_dict("a", rv=11)) is None
    assert [p.metadata.name for p in twin.materialize().pods] == ["b"]
    assert twin.apply_event("pods", "DELETED", _pod_dict("a", rv=12)) is None


def test_twin_admissibility_transition_is_a_delete():
    twin = ClusterTwin()
    twin.rebase("pods", [_pod_dict("run", phase="Running", node="n1", rv=3)])
    change = twin.apply_event("pods", "MODIFIED", _pod_dict("run", phase="Succeeded", node="n1", rv=7))
    assert change == ("pod_del", ("default", "run"))
    assert twin.materialize().pods == []
    assert twin.apply_event("pods", "ADDED", _pod_dict("done", phase="Failed", rv=9)) is None


def test_twin_node_events():
    twin = ClusterTwin()
    twin.rebase("nodes", [fx.make_fake_node("n0", "8", "16Gi").raw])
    n1 = fx.make_fake_node("n1", "8", "16Gi").raw
    n1["metadata"]["resourceVersion"] = "20"
    change = twin.apply_event("nodes", "ADDED", n1)
    assert change[0] == "node_add" and change[1].metadata.name == "n1"
    n1b = json.loads(json.dumps(n1))
    n1b["metadata"]["resourceVersion"] = "21"
    n1b["spec"] = {"unschedulable": True}
    assert twin.apply_event("nodes", "MODIFIED", n1b)[0] == "rebuild"
    assert twin.apply_event("nodes", "DELETED", n1b)[0] == "rebuild"
    assert [n.metadata.name for n in twin.materialize().nodes] == ["n0"]


def test_twin_fingerprint_matches_equivalent_list():
    twin = ClusterTwin()
    nodes = [fx.make_fake_node(f"n{i}", "4", "8Gi").raw for i in range(3)]
    twin.rebase("nodes", nodes)
    twin.rebase("pods", [_pod_dict("a", rv=1), _pod_dict("b", rv=2)])
    twin.apply_event("pods", "ADDED", _pod_dict("c", rv=9))
    twin.apply_event("pods", "DELETED", _pod_dict("a", rv=10))
    ref = ResourceTypes()
    ref.nodes.extend(Node.from_dict(d) for d in nodes)
    ref.pods.append(Pod.from_dict(_pod_dict("b", rv=2)))
    ref.pods.append(Pod.from_dict(_pod_dict("c", rv=9)))
    assert twin.fingerprint() == fingerprint_cluster(ref)


def _node_dict(name, cpu, memory, rv):
    d = json.loads(json.dumps(fx.make_fake_node(name, cpu, memory).raw))
    d["metadata"]["resourceVersion"] = str(rv)
    return d


_EVENTS = [
    ("nodes", "ADDED", lambda: _node_dict("n7", "8", "16Gi", 40)),
    ("pods", "ADDED", lambda: _pod_dict("c", rv=41)),
    ("pods", "ADDED", lambda: _pod_dict("c", rv=41)),  # a duplicate delivery
    ("pods", "DELETED", lambda: _pod_dict("a", rv=42)),
    ("pods", "MODIFIED", lambda: _pod_dict("a", rv=40)),  # stale: the tombstone holds
    ("pods", "MODIFIED", lambda: _pod_dict("b", phase="Running", node="n1", rv=43)),
    ("pods", "MODIFIED", lambda: _pod_dict("b", phase="Succeeded", node="n1", rv=44)),  # leaves the set
    ("pods", "ADDED", lambda: _pod_dict("d", phase="Running", node="n7", cpu="300m", rv=45)),
    ("nodes", "MODIFIED", lambda: _node_dict("n0", "16", "32Gi", 46)),
]


def test_twins_of_both_packages_apply_one_sequence_to_equal_fingerprints():
    """The same listing and event sequence through the port's and the JAX
    package's ClusterTwin: equal change verdicts, generations and content
    fingerprints after every event."""
    ours, theirs = ClusterTwin(), ref_watch.ClusterTwin()
    nodes = [fx.make_fake_node(f"n{i}", "8", "16Gi").raw for i in range(3)]
    pods = [_pod_dict("a", rv=1), _pod_dict("b", rv=2)]
    for twin in (ours, theirs):
        twin.rebase("nodes", copy.deepcopy(nodes))
        twin.rebase("pods", copy.deepcopy(pods))
    assert ours.fingerprint() == theirs.fingerprint()
    for field, kind, make in _EVENTS:
        a = ours.apply_event(field, kind, make())
        b = theirs.apply_event(field, kind, make())
        assert (a is None) == (b is None) and (a is None or a[0] == b[0]), (field, kind, a, b)
        assert ours.generation == theirs.generation
        assert ours.fingerprint() == theirs.fingerprint(), (field, kind)
    listing = {"pods": ([_pod_dict("c", rv=41), _pod_dict("lost", rv=47)], "48")}
    assert ours.reconcile(copy.deepcopy(listing)) == theirs.reconcile(copy.deepcopy(listing)) == 2
    assert ours.fingerprint() == theirs.fingerprint()


def test_reconcile_never_reverts_twin_ahead_of_listing():
    twin = ClusterTwin()
    twin.rebase("pods", [_pod_dict("stay", rv=5), _pod_dict("victim", rv=6)])
    assert twin.apply_event("pods", "MODIFIED", _pod_dict("stay", rv=12))
    assert twin.apply_event("pods", "ADDED", _pod_dict("young", rv=13))
    assert twin.apply_event("pods", "DELETED", _pod_dict("victim", rv=14))
    listing = {"pods": ([_pod_dict("stay", rv=5), _pod_dict("victim", rv=6), _pod_dict("lost", rv=9)], "10")}
    assert twin.reconcile(listing) == 1  # the one ADDED the stream never delivered
    assert {p.metadata.name for p in twin.materialize().pods} == {"stay", "young", "lost"}
    stay = next(p for p in twin.materialize().pods if p.metadata.name == "stay")
    assert stay.raw["metadata"]["resourceVersion"] == "12"
    again = {"pods": ([_pod_dict("stay", rv=12), _pod_dict("young", rv=13), _pod_dict("lost", rv=9)], "15")}
    assert twin.reconcile(again) == 0


def test_reconcile_repairs_lost_delete_and_lost_modify():
    twin = ClusterTwin()
    twin.rebase("pods", [_pod_dict("phantom", rv=3), _pod_dict("behind", rv=4)])
    assert twin.reconcile({"pods": ([_pod_dict("behind", rv=8)], "9")}) == 2
    pods = twin.materialize().pods
    assert [p.metadata.name for p in pods] == ["behind"]
    assert pods[0].raw["metadata"]["resourceVersion"] == "8"


# ---------------------------------------------------------------------------
# twin_pod_delta: placements equal to a fresh prepare, by index
# ---------------------------------------------------------------------------


def _wave_cluster(with_new=False, without_dead=False, node_added=False):
    rt = ResourceTypes()
    for i in range(4):
        rt.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi"))
    if node_added:
        rt.nodes.append(fx.make_fake_node("n9", "8", "16Gi"))
    if not without_dead:
        rt.pods.append(Pod.from_dict(_pod_dict("dead", phase="Running", node="n0", cpu="300m")))
    rt.pods.append(Pod.from_dict(_pod_dict("keep", phase="Pending", cpu="200m")))
    rt.pods.append(Pod.from_dict(_pod_dict("bound", phase="Running", node="n2", cpu="2")))
    if with_new:
        rt.pods.append(Pod.from_dict(_pod_dict("new-a", cpu="450m")))
        rt.pods.append(Pod.from_dict(_pod_dict("new-b", phase="Running", node="n1", cpu="150m")))
    return rt


def _by_index(prep, res):
    """The node each pod of the stream landed on, by stream index ("" for
    a dropped or unplaced pod), with its name."""
    node_of = {id(p): ns.node.metadata.name for ns in res.node_status for p in ns.pods}
    return [(p.metadata.name, node_of.get(id(p), "")) for p in prep.ordered]


@pytest.mark.parametrize("wave", ["delete-only", "add-and-delete", "nodes-then-pods"])
def test_twin_pod_delta_places_as_a_fresh_prepare_by_index(wave):
    """A delete-only wave (the base's Prepared shared, the drop a mask), an
    add-and-delete wave (pods inserted at the bare region's end: every
    later row moves, the kernel inputs are rebuilt) and a node wave then a
    pod wave (``flush_pending``'s decomposition) each place, index by
    index, as a fresh prepare of the post-wave cluster — the dropped pod
    nowhere."""
    base = prepcache.CacheEntry("t|base", prepare(_wave_cluster(), [], device="cpu"))
    # a request before the wave fills the base's kernel-input memo
    simulate(_wave_cluster(), [], prep=base.prep)
    base.restore()
    added = [] if wave == "delete-only" else [Pod.from_dict(_pod_dict("new-a", cpu="450m")),
                                              Pod.from_dict(_pod_dict("new-b", phase="Running", node="n1",
                                                                      cpu="150m"))]
    post = _wave_cluster(with_new=bool(added), without_dead=True, node_added=wave == "nodes-then-pods")
    with base.lock:
        base.restore()
        mid = base
        if wave == "nodes-then-pods":
            new_prep = prepcache.extend_with_nodes(base.prep, [n for n in post.nodes if n.metadata.name == "n9"],
                                                   post, [], base_entry=base)
            assert new_prep is not None, "a node wave extends, it does not rebuild"
            mid = prepcache.CacheEntry("t1|base", new_prep, base=base)
            mid.base_drop = prepcache.pad_drop_mask(base.base_drop, len(new_prep.ordered))
        entry = prepcache.twin_pod_delta(mid, "t2|base", added, {("default", "dead")})
    assert entry is not None and int(entry.base_drop.sum()) == 1
    if wave == "delete-only":
        assert entry.prep is base.prep  # the kernel inputs shared: drops travel as validity
    else:
        assert entry.prep.inputs_memo == {}  # rows moved: nothing of the old stream's inputs
        assert len(entry.prep.ordered) == len(mid.prep.ordered) + 2
    res_delta = simulate(post, [], prep=entry.prep, drop_pods=entry.base_drop)
    fresh = prepare(post, [], device="cpu")
    res_fresh = simulate(post, [], prep=fresh)
    got = [x for x in _by_index(entry.prep, res_delta) if x[0] != "dead"]
    assert got == _by_index(fresh, res_fresh)
    assert ("dead", "") in _by_index(entry.prep, res_delta)


def test_twin_pod_delta_places_as_the_jax_delta_by_index(monkeypatch):
    """Both packages' twin_pod_delta on the same cluster and events: the
    same stream, pod for pod, and the same placements by index (the port's
    plain scan against the JAX XLA scan)."""
    monkeypatch.setenv("OPENSIM_DISABLE_NATIVE", "1")
    added = [_pod_dict("new-a", cpu="450m"), _pod_dict("new-b", phase="Running", node="n1", cpu="150m")]
    post = _wave_cluster(with_new=True, without_dead=True)
    ours = prepcache.CacheEntry("t|base", prepare(_wave_cluster(), [], device="cpu"))
    theirs = ref_prepcache.CacheEntry("t|base", ref_sim.prepare(_reference_copy(_wave_cluster()), []))
    with ours.lock:
        e1 = prepcache.twin_pod_delta(ours, "t2|base", [Pod.from_dict(d) for d in added], {("default", "dead")})
    ref_pod = ref_expand.resources_from_dicts
    with theirs.lock:
        e2 = ref_prepcache.twin_pod_delta(theirs, "t2|base", ref_pod(copy.deepcopy(added))[0].pods,
                                          {("default", "dead")})
    assert e1.base_drop.tolist() == e2.base_drop.tolist()
    r1 = simulate(post, [], prep=e1.prep, drop_pods=e1.base_drop)
    r2 = ref_sim.simulate(_reference_copy(post), [], prep=e2.prep, drop_pods=e2.base_drop)
    assert _by_index(e1.prep, r1) == _by_index(e2.prep, r2)


def test_a_twin_lineage_keeps_no_old_generation_alive():
    """Each generation's base entry is derived from the last: once the
    cache drops the old one, nothing keeps it (its Prepared, its tensors)
    alive — a twin serving for hours folds thousands of generations."""
    import gc
    import weakref

    base = prepcache.CacheEntry("t|1|base", prepare(_wave_cluster(), [], device="cpu"))
    entry = base
    refs = []
    for gen in range(2, 6):
        with entry.lock:
            nxt = prepcache.twin_pod_delta(entry, f"t|{gen}|base", [Pod.from_dict(_pod_dict(f"g{gen}", cpu="50m"))],
                                           set())
        refs.append(weakref.ref(entry.prep))
        entry = nxt
    del base, nxt
    gc.collect()
    assert [r() is None for r in refs] == [True] * 4
    assert entry.lock is not None and len(entry.prep.ordered) == len(_wave_cluster().pods) + 4


def test_twin_pod_delta_refuses_past_compaction_threshold():
    rt = ResourceTypes()
    rt.nodes.append(fx.make_fake_node("n0", "64", "256Gi"))
    for i in range(100):
        rt.pods.append(Pod.from_dict(_pod_dict(f"churn-{i}", phase="Running", node="n0")))
    base = prepcache.CacheEntry("c|base", prepare(rt, [], device="cpu"))
    n0 = prepcache.compactions_total()
    with base.lock:
        base.restore()
        # 65 of 100 bare pods: past max(64, P // 4) masked rows, as the reference refuses
        assert prepcache.twin_pod_delta(base, "c2|base", [], {("default", f"churn-{i}") for i in range(65)}) is None
        assert prepcache.compactions_total() == n0 + 1
        ref_base = ref_prepcache.CacheEntry("c|base", ref_sim.prepare(_reference_copy(rt), []))
        assert ref_prepcache.twin_pod_delta(ref_base, "c2|base", [],
                                            {("default", f"churn-{i}") for i in range(65)}) is None
        assert ref_prepcache.twin_pod_delta(ref_base, "c2|base", [],
                                            {("default", f"churn-{i}") for i in range(64)}) is not None
        entry = prepcache.twin_pod_delta(base, "c3|base", [], {("default", f"churn-{i}") for i in range(64)})
        assert entry is not None and int(entry.base_drop.sum()) == 64
        # a deletion outside the bare region cannot be a delta
        assert prepcache.twin_pod_delta(base, "c4|base", [], {("default", "no-such-pod")}) is None


# ---------------------------------------------------------------------------
# end to end against the stub apiserver
# ---------------------------------------------------------------------------


def test_event_convergence_fingerprint_matches_full_relist(tmp_path):
    with _twin_server(tmp_path, pods=[_pod_dict("p1", phase="Running", node="n0")], wire_server=False) as (
            stub, sup, _server, kc):
        stub.upsert("/api/v1/pods", _pod_dict("p2"))
        stub.upsert("/api/v1/pods", _pod_dict("p3", cpu="200m"))
        stub.delete("/api/v1/pods", "p1")
        _wait(lambda: sorted(p.metadata.name for p in sup.twin.materialize().pods) == ["p2", "p3"],
              msg="twin to apply ADDED+DELETED")
        fresh, rvs = _cluster_via_rest(kc, None)
        assert sup.twin.fingerprint() == fingerprint_cluster(fresh)
        assert rvs and all(v for v in rvs.values())


def test_warm_path_waves_are_deltas_not_full_prepares(tmp_path):
    """After the first request builds the base, a pod ADDED, a mixed node
    and pod batch and a pod DELETED each cost a delta (``twin_delta``, the
    node wave ``delta_nodes``), never a second full prepare; each request
    then pays its own app delta, carries the twin's generation key in its
    trace, and answers as a polling server that relists."""
    with _twin_server(tmp_path, pods=[_pod_dict("p1", phase="Running", node="n0")]) as (stub, sup, server, kc):
        assert server.deploy_apps(_payload())[0] == 200
        c0 = dict(PREP_STATS.counts)
        stub.upsert("/api/v1/pods", _pod_dict("p2"))
        _wait(lambda: len(sup.twin.materialize().pods) == 2, msg="ADDED applied")
        sup.flush_pending()
        stub.upsert("/api/v1/nodes", fx.make_fake_node("n9", "8", "16Gi").raw)
        stub.upsert("/api/v1/pods", _pod_dict("p3", cpu="250m"))
        stub.delete("/api/v1/pods", "p1")
        _wait(lambda: len(sup.twin.materialize().nodes) == 5
              and sorted(p.metadata.name for p in sup.twin.materialize().pods) == ["p2", "p3"],
              msg="mixed batch applied")
        sup.flush_pending()
        code, body = server.deploy_apps(_payload(), request_id="after-waves")
        assert code == 200
        moved = {k: PREP_STATS.counts.get(k, 0) - c0.get(k, 0) for k in ("full", "twin_delta", "delta_nodes",
                                                                          "delta_apps")}
        assert moved == {"full": 0, "twin_delta": 2, "delta_nodes": 1, "delta_apps": 1}, moved
        tr = FLIGHT_RECORDER.get("after-waves")
        assert tr is not None and tr.root.attrs["twin_key"] == f"{sup.key_prefix}{sup.twin.generation}"
        polling = rest.SimonServer(kubeconfig=kc, device="cpu", admission=False)
        code, ref = polling.deploy_apps(_payload())
        assert code == 200 and _names(body) == _names(ref)


def test_bookmark_keepalive_resets_staleness_deadline(tmp_path):
    with _twin_server(tmp_path, policy={"stale_s": 0.4}, bookmark_s=0.05, wire_server=False) as (
            stub, sup, _server, kc):
        time.sleep(1.0)  # several staleness windows of bookmark traffic only
        assert sup.state() == "live"
        assert sum(n for (k, _res), n in sup.events_total.items() if k == "BOOKMARK") > 0
        stub.bookmark_interval_s = 30.0
        _wait(lambda: sup.state() == "degraded", msg="staleness degradation")
        assert sup.is_stale()
        stub.upsert("/api/v1/pods", _pod_dict("wake"))
        _wait(lambda: sup.state() == "live", msg="event-driven revival")


def test_degraded_twin_tags_answers_stale(tmp_path):
    with _twin_server(tmp_path, policy={"stale_s": 0.4}, bookmark_s=0.05) as (stub, sup, server, kc):
        httpd = rest.SimonHTTPServer(("127.0.0.1", 0), rest.make_handler(server))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            body = json.dumps(_payload()).encode()

            def post():
                return urllib.request.urlopen(urllib.request.Request(f"{url}/api/deploy-apps", data=body,
                                                                     method="POST"), timeout=60)

            with post() as r:
                assert r.headers.get("X-Simon-Snapshot") is None
            stub.bookmark_interval_s = 30.0
            _wait(lambda: sup.state() == "degraded", msg="staleness degradation")
            with post() as r:
                assert r.headers.get("X-Simon-Snapshot") == "stale"
            with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
                text = r.read().decode()
            assert 'simon_watch_state{state="degraded"} 1' in text
            assert "simon_watch_events_total" in text and "simon_snapshot_stale_served_total 1" in text
        finally:
            httpd.shutdown()
            httpd.server_close()


@pytest.mark.parametrize("fault", ["watch.disconnect", "watch.gone", "watch.drop_event", "watch.reorder"])
def test_watch_faults_converge_to_the_relist(tmp_path, fault):
    """Each watch fault, fired on the events after a first one: a dropped
    stream reconnects, an expired rv relists and rebases, a lost event is
    found and repaired by anti-entropy (drift counted by resource, the
    cycle in the flight recorder), a reordered delivery converges by rv
    (anti-entropy finds no drift). The twin then holds the relist's pods,
    and — where the stream kept its order — its fingerprint equals the
    relist's."""
    with _twin_server(tmp_path, wire_server=False) as (stub, sup, _server, kc):
        stub.upsert("/api/v1/pods", _pod_dict("first"))
        _wait(lambda: "first" in {p.metadata.name for p in sup.twin.materialize().pods}, msg="first applied")
        faults.inject(fault, count=1, exc="fault")
        stub.upsert("/api/v1/pods", _pod_dict("second", cpu="250m"))
        if fault == "watch.reorder":
            stub.upsert("/api/v1/pods", _pod_dict("third", cpu="50m"))  # releases the held event
        _wait(lambda: faults.fault_stats().get(fault) == 1, msg=f"{fault} fired")
        want = {"first", "second"} | ({"third"} if fault == "watch.reorder" else set())
        if fault == "watch.drop_event":
            time.sleep(0.2)
            assert "second" not in {p.metadata.name for p in sup.twin.materialize().pods}
            assert sup.anti_entropy() >= 1
            assert sup.drift_by_resource.get("pods", 0) >= 1
            assert (f'simon_twin_drift_total{{resource="pods"}} {sup.drift_by_resource["pods"]}'
                    in "\n".join(sup.metrics_lines()))
            assert any(s["request_id"].startswith("watch-anti-entropy-") for s in FLIGHT_RECORDER.summaries())
        _wait(lambda: {p.metadata.name for p in sup.twin.materialize().pods} == want, msg="convergence")
        if fault == "watch.disconnect":
            _wait(lambda: sup.reconnects_total >= 1, msg="reconnect counted")
        if fault == "watch.gone":
            _wait(lambda: sup.gone_total >= 1 and sup.relists_total >= 1, msg="410 noted and relisted")
        _wait(lambda: sup.state() == "live", msg="live again")
        if fault == "watch.reorder":
            assert sup.anti_entropy() == 0  # converged by rv: nothing drifted
            return
        fresh, _ = _cluster_via_rest(kc, None)
        assert sup.twin.fingerprint() == fingerprint_cluster(fresh)


def test_watch_410_at_the_source_raises_gone(tmp_path):
    stub = StubApiServer().start()
    _seed(stub)
    try:
        old_rv = stub.rv()
        for i in range(3):
            stub.upsert("/api/v1/pods", _pod_dict(f"fill-{i}"))
        stub.compact()
        stub.upsert("/api/v1/pods", _pod_dict("past-compaction"))
        src = RestWatchSource(stub.kubeconfig(tmp_path), read_timeout_s=2.0)
        with pytest.raises(GoneError):
            for _ev in src.watch("pods", str(old_rv)):
                pytest.fail("events must not be delivered across a compaction gap")
    finally:
        stub.stop()


def test_bootstrap_failure_falls_back_to_polling(tmp_path, monkeypatch):
    stub = StubApiServer().start()
    _seed(stub)
    kc = stub.kubeconfig(tmp_path)
    stub.stop()  # the apiserver gone before the twin ever syncs
    sup = WatchSupervisor(RestWatchSource(kc, read_timeout_s=1.0), policy=dict(FAST, stale_s=1.0))
    try:
        assert sup.start(wait_s=0.5) is False
        assert not sup.has_synced()
        fetches = []

        def fake_fetch(kubeconfig, master=None):
            fetches.append(kubeconfig)
            rt = ResourceTypes()
            for i in range(3):
                rt.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi"))
            return rt

        monkeypatch.setattr(rest, "cluster_from_kubeconfig", fake_fetch)
        server = rest.SimonServer(kubeconfig="/tmp/kc", watch=sup, device="cpu", admission=False)
        code, body = server.deploy_apps(_payload())
        assert code == 200 and body["nodeStatus"]
        assert fetches  # served by the polling path
    finally:
        sup.stop()


def test_watch_on_requires_kubeconfig():
    """``--watch on`` with no kubeconfig fails loudly (the CLI exits 1), not
    a polling server the operator believes is a synced twin; so does a
    journal without the twin."""
    assert cli.main(["server", "--watch", "on", "--device", "cpu", "--port", "0"]) == 1
    with pytest.raises(ValueError, match="--watch on requires --kubeconfig"):
        rest.start_server(port=0, host="127.0.0.1", watch="on", device="cpu")
    with pytest.raises(ValueError, match="--journal requires the live twin"):
        rest.start_server(port=0, host="127.0.0.1", watch="auto", journal="/tmp/j", device="cpu")


def test_watch_policy_validation(monkeypatch):
    assert watch_policy() == ref_watch.watch_policy()
    assert watch_policy()["stale_s"] == 30.0
    monkeypatch.setenv("OPENSIM_WATCH_STALE_S", "soon")
    with pytest.raises(ValueError, match="OPENSIM_WATCH_STALE_S"):
        watch_policy()
    monkeypatch.setenv("OPENSIM_WATCH_STALE_S", "0")
    with pytest.raises(ValueError, match="positive"):
        watch_policy()
    monkeypatch.setenv("OPENSIM_WATCH_STALE_S", "5")
    monkeypatch.setenv("OPENSIM_WATCH_RECONNECTS", "0")
    with pytest.raises(ValueError, match="OPENSIM_WATCH_RECONNECTS"):
        watch_policy()


def test_chaos_twin_server_answers_as_a_polling_server(tmp_path):
    """A disconnect, a 410 and a dropped event mid-stream while the cluster
    changes: after anti-entropy the twin server's next answer equals a
    polling server's after a fresh relist, and /metrics shows the storm."""
    with _twin_server(tmp_path, pods=[_pod_dict("seed", phase="Running", node="n0")]) as (stub, sup, server, kc):
        assert server.deploy_apps(_payload())[0] == 200
        for fault, name in (("watch.disconnect", "storm-a"), ("watch.gone", "storm-b"),
                            ("watch.drop_event", "storm-c")):
            faults.inject(fault, count=1, exc="fault")
            stub.upsert("/api/v1/pods", _pod_dict(name, cpu="150m"))
            _wait(lambda: faults.fault_stats().get(fault) == 1, msg=f"{fault} fired")
        assert sup.anti_entropy() >= 0
        _wait(lambda: {"storm-a", "storm-b", "storm-c"} <= {p.metadata.name for p in sup.twin.materialize().pods},
              msg="twin reconverged")
        fresh, _ = _cluster_via_rest(kc, None)
        assert sup.twin.fingerprint() == fingerprint_cluster(fresh)
        code, twin_body = server.deploy_apps(_payload())
        assert code == 200
        code, relist_body = rest.SimonServer(kubeconfig=kc, device="cpu", admission=False).deploy_apps(_payload())
        assert code == 200 and _names(twin_body) == _names(relist_body)
        text = server.metrics_text()
        assert "simon_watch_reconnects_total" in text and "simon_twin_drift_total" in text
        assert 'simon_faults_injected_total{point="watch.disconnect"}' in text


def test_deploy_from_the_twin_equals_the_jax_twin_server(tmp_path):
    """The port's twin server and the JAX package's, each with its own
    supervisor watching one stub through the same events (pods ADDED and
    DELETED, a node ADDED): equal twin fingerprints and equal deploy
    answers, pod names' counters aside."""
    stub = StubApiServer(bookmark_interval_s=0.1).start()
    _seed(stub, pods=[_pod_dict("p1", phase="Running", node="n0", cpu="2"),
                      _pod_dict("p2", phase="Running", node="n1", cpu="3")])
    kc = stub.kubeconfig(tmp_path)
    ours = WatchSupervisor(RestWatchSource(kc, read_timeout_s=3.0), policy=FAST)
    theirs = ref_watch.WatchSupervisor(ref_watch.RestWatchSource(kc, read_timeout_s=3.0), policy=FAST)
    port = rest.SimonServer(kubeconfig=kc, watch=ours, device="cpu", admission=False)
    ref = ref_rest.SimonServer(kubeconfig=kc, watch=theirs, admission=False, capacity=False)
    theirs.prep_cache = ref.prep_cache
    try:
        assert ours.start(wait_s=15.0) and theirs.start(wait_s=15.0)
        assert port.deploy_apps(_payload())[0] == 200 and ref.deploy_apps(_payload())[0] == 200
        stub.upsert("/api/v1/pods", _pod_dict("p3", phase="Running", node="n2", cpu="1"))
        stub.upsert("/api/v1/nodes", fx.make_fake_node("n9", "8", "16Gi").raw)
        stub.delete("/api/v1/pods", "p1")
        want = ["p2", "p3"]
        for sup in (ours, theirs):
            _wait(lambda: sorted(p.metadata.name for p in sup.twin.materialize().pods) == want
                  and len(sup.twin.materialize().nodes) == 5, msg="both twins applied the wave")
        assert ours.twin.fingerprint() == theirs.twin.fingerprint()
        ours.flush_pending()
        theirs.flush_pending()
        code, a = port.deploy_apps(_payload())
        code_ref, b = ref.deploy_apps(_payload())
        assert code == code_ref == 200
        assert _names(a) == _names(b)
    finally:
        port.close()
        ref.close()
        theirs.stop()
        stub.stop()
