"""`simon server` of the port on the CPU (plain versions) against the JAX
package's server (single-flight, no capacity observatory), both listing the
same cluster from their own stub apiservers through
``cluster_from_kubeconfig``'s stdlib REST lister: deploy-apps (cold, then
a full-key hit), scale-apps (the drop mask, also against the uncached
path), ``newnodes``, ``explain=1``; the busy 503, the deadline 504,
``/healthz``, ``/metrics``, the debug routes (the time-series and SLO
routes' 503 without a running ring; the memory, profile and profiler
routes against the JAX server's answers);
the fleet's operator errors ``serve()`` refuses; the kernel build's lock; the
snapshot lister against the JAX package's, and ``simon apply`` in
kubeConfig mode against the JAX ``Applier``; ``--watch on`` serving from
the live twin and ``--journal`` restoring it. Responses are compared after
the process counters in pod (``-<10 hex>``) and fake-node
(``simon-<8 hex>``) names are normalized; otherwise exactly."""

import json
import os
import re
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from contextlib import contextmanager

import pytest

from opensim_tpu.planner import apply as ref_apply
from opensim_tpu.server import rest as ref_rest
from opensim_tpu.server import snapshot as ref_snapshot
from opensim_tpu.server.stubapi import StubApiServer as RefStub
from opensim_tpu_torch.cli import main as cli
from opensim_tpu_torch.engine.simulator import AppResource, simulate
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.obs.metrics import FAMILIES, parse_metrics
from opensim_tpu_torch.ops import fast_scan as fs
from opensim_tpu_torch.planner import apply
from opensim_tpu_torch.server import rest, snapshot
from opensim_tpu_torch.server.stubapi import StubApiServer
from opensim_tpu_torch.utils import jitcache
from opensim_tpu_torch.utils.trace import PREP_STATS

N_NODES, N_PODS = 24, 240  # the capacity plan cut to 24 nodes: 10 Deployments bound, 10 requested


def _norm(text: str) -> str:
    """`text` without the process counters in pod and new-node names."""
    return re.sub(r"-[0-9a-f]{10}\b", "-#", re.sub(r"simon-[0-9a-f]{8}\b", "simon-#", text))


def _names(obj) -> str:
    return _norm(json.dumps(obj, sort_keys=True))


def _snapshot_pods():
    """The server plan's snapshot pods at small size: bench-0 ... bench-9,
    bound where the port placed them."""
    cluster = fx.synthetic_cluster(N_NODES)
    res = simulate(cluster, [AppResource("seed", fx.server_apps(N_PODS, 0, fx.SERVER_BOUND))], device="cpu")
    assert not res.unscheduled_pods
    return [fx.snapshot_pod(p) for ns in res.node_status for p in ns.pods]


@pytest.fixture(scope="module")
def stubs(tmp_path_factory):
    """(port kubeconfig, JAX kubeconfig): two stub apiservers listing the
    same nodes and bound pods."""
    pods = _snapshot_pods()
    cluster = fx.synthetic_cluster(N_NODES)
    out = []
    for cls in (StubApiServer, RefStub):
        stub = cls().start()
        fx.seed_stub(stub, cluster, pods)
        out.append(stub)
    d = tmp_path_factory.mktemp("kube")
    (d / "port").mkdir()
    (d / "jax").mkdir()
    yield out[0].kubeconfig(d / "port"), out[1].kubeconfig(d / "jax")
    for stub in out:
        stub.stop()


@pytest.fixture(scope="module")
def servers(stubs):
    """(port server, JAX server) over the two stubs, snapshot cached for
    the module."""
    port = rest.SimonServer(kubeconfig=stubs[0], snapshot_ttl_s=3600.0, admission=False, device="cpu")
    ref = ref_rest.SimonServer(kubeconfig=stubs[1], snapshot_ttl_s=3600.0, admission=False, capacity=False)
    return port, ref


@contextmanager
def _serve(server):
    httpd = rest.SimonHTTPServer(("127.0.0.1", 0), rest.make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def _call(url, path, body=None, headers=None):
    """(status, headers, JSON or text body) of one request."""
    req = urllib.request.Request(url + path, data=None if body is None else json.dumps(body).encode(),
                                 method="GET" if body is None else "POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            code, hdrs, data = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        code, hdrs, data = e.code, dict(e.headers), e.read()
    try:
        return code, hdrs, json.loads(data)
    except ValueError:
        return code, hdrs, data.decode()


REQUESTS = fx.server_requests(N_NODES, N_PODS, 4)


@pytest.mark.parametrize("case", ["deploy", "scale", "newnodes", "explain"])
def test_response_equals_jax_server(servers, case):
    port, ref = servers
    body = REQUESTS["deploy" if case == "explain" else case]
    endpoint = "scale_apps" if case == "scale" else "deploy_apps"
    explain = case == "explain"
    code, got = getattr(port, endpoint)(json.loads(json.dumps(body)), explain=explain)
    ref_code, want = getattr(ref, endpoint)(json.loads(json.dumps(body)), explain=explain)
    assert code == ref_code == 200, got
    assert _names(got) == _names(want)
    placed = sum(len(ns["pods"]) for ns in got["nodeStatus"])
    if case == "scale":  # bench-0's bound pods left the stream; its new replicas all placed
        assert placed == 2 * N_PODS // 20 and not got["unscheduledPods"]
    else:
        assert placed + len(got["unscheduledPods"]) == N_PODS // 2
    if case == "newnodes":
        assert sum(ns["node"].startswith("simon-") for ns in got["nodeStatus"]) > 0
    if explain:
        assert "filterRejects" in got


def test_repeated_deploy_is_a_full_key_hit(servers):
    port, _ref = servers
    body = REQUESTS["deploy"]
    _code, first = port.deploy_apps(json.loads(json.dumps(body)))
    hits = port.prep_cache.stats.hits
    _code, again = port.deploy_apps(json.loads(json.dumps(body)))
    assert PREP_STATS.last[0] == "hit"
    assert port.prep_cache.stats.hits == hits + 1
    assert again == first  # verbatim: the same pods, names included


@pytest.mark.parametrize("case", ["deploy", "scale", "newnodes"])
def test_cached_equals_uncached(stubs, servers, case):
    """The encode cache's answer (delta re-encode, drop mask, node
    extension) equals the uncached path's full prepare of the same
    request."""
    port, _ref = servers
    legacy = rest.SimonServer(kubeconfig=stubs[0], prep_cache=False, device="cpu")
    assert legacy.prep_cache is None
    endpoint = "scale_apps" if case == "scale" else "deploy_apps"
    code, got = getattr(port, endpoint)(json.loads(json.dumps(REQUESTS[case])))
    code2, want = getattr(legacy, endpoint)(json.loads(json.dumps(REQUESTS[case])))
    assert code == code2 == 200
    assert _names(got) == _names(want)
    if case == "scale":  # the cached scale entry masks bench-0's bound pods out of the snapshot's stream
        (entry,) = [e for e in port.prep_cache.entries_snapshot() if "|scale|" in e.key]
        assert entry.drop_mask.sum() == N_PODS // 20
        assert entry.drop_mask[entry.prep.n_bare:].sum() == 0


def test_concurrent_deploy_and_scale_answer_as_alone(servers):
    """The two endpoints run at once (their locks differ) over one cached
    base entry: under a short thread switch interval, every answer equals
    the one the request gets alone."""
    port, _ref = servers
    alone = {"deploy": port.deploy_apps(json.loads(json.dumps(REQUESTS["deploy"])))[1],
             "scale": port.scale_apps(json.loads(json.dumps(REQUESTS["scale"])))[1]}
    got = {"deploy": [], "scale": []}

    def run(kind, call):
        for _ in range(4):
            got[kind].append(call(json.loads(json.dumps(REQUESTS[kind]))))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=("deploy", port.deploy_apps)),
                   threading.Thread(target=run, args=("scale", port.scale_apps))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for kind, answers in got.items():
        assert len(answers) == 4 and all(code == 200 and body == alone[kind] for code, body in answers)


def test_http_routes(servers):
    """healthz, metrics, the debug routes and the placements of an
    explain=1 request, the deadline 504, the busy 503, 404 and 400."""
    port, _ref = servers
    with _serve(port) as url:
        assert _call(url, "/healthz")[::2] == (200, {"status": "ok"})
        code, hdrs, body = _call(url, "/api/deploy-apps?explain=1", REQUESTS["deploy"])
        assert code == 200 and "filterRejects" in body
        rid = hdrs["X-Simon-Request-Id"]
        code, _h, placements = _call(url, f"/api/debug/placements/{rid}")
        assert code == 200 and placements["request_id"] == rid and placements["pods_total"] > 0
        code, _h, tree = _call(url, f"/api/debug/requests/{rid}")
        assert code == 200 and tree["request_id"] == rid
        assert tree["spans"]["attrs"]["rung"] in ("hit", "delta", "cold")
        assert "kernel_s" in tree["spans"]["attrs"]
        code, _h, listing = _call(url, "/api/debug/requests")
        assert code == 200 and listing["requests"][0]["request_id"] == rid
        assert _call(url, "/api/debug/requests/nope")[0] == 404
        assert _call(url, "/api/debug/placements/nope")[0] == 404
        code, _h, body = _call(url, "/api/deploy-apps", REQUESTS["deploy"], {"X-Simon-Timeout-S": "0.000001"})
        assert code == 504 and body["phase"] in ("snapshot", "prepare", "encode", "schedule", "decode")
        assert port._deploy_lock.acquire(blocking=False)  # a request in flight
        try:
            code, _h, body = _call(url, "/api/deploy-apps", {})
            assert code == 503 and "busy" in body["error"]
        finally:
            port._deploy_lock.release()
        assert _call(url, "/nope")[0] == 404
        req = urllib.request.Request(url + "/api/deploy-apps", data=b"{nope", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400
        code, _h, text = _call(url, "/metrics")
    assert code == 200
    metrics = parse_metrics(text)
    assert metrics[("simon_request_timeouts_total", ())] >= 1
    assert metrics[("simon_request_seconds_count", (("endpoint", "deploy-apps"), ("status", "deadline-exceeded")))] >= 1
    assert metrics[("simon_request_seconds_count", (("endpoint", "deploy-apps"), ("status", "busy")))] >= 1
    assert metrics[("simon_prep_cache_hits_total", ())] >= 1


def test_metrics_families_are_the_reference_families(servers):
    """Every family the port renders is one the JAX server renders, with its
    type; the port's own counters are rendered."""
    from opensim_tpu.obs.metrics import FAMILIES as REF_FAMILIES

    port, _ref = servers
    port.deploy_apps(json.loads(json.dumps(REQUESTS["deploy"])))
    text = port.metrics_text()
    types_ = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    assert set(types_) <= set(FAMILIES)
    for name, kind in types_.items():
        assert REF_FAMILIES[name][1] == kind
    for name in ("simon_requests_total", "simon_prep_cache_hits_total", "simon_prepare_seconds_total",
                 "simon_request_seconds", "simon_phase_seconds"):
        assert name in types_


@pytest.mark.parametrize("method,path,item", [
    ("GET", "/api/cluster/report", 7), ("GET", "/api/debug/capacity", 7), ("POST", "/api/campaign", 7),
    ("GET", "/api/debug/memory?fields=0", 10), ("GET", "/api/debug/timeseries", 0), ("GET", "/api/fleet/slo", 0),
    ("GET", "/debug/profiler", 10), ("GET", "/api/debug/profile", 10),
])
def test_later_routes_answer_501(servers, method, path, item, tmp_path, monkeypatch):
    """The routes the JAX server serves and the port once answered 501 for:
    each answers now, as the JAX server does."""
    import opensim_tpu.utils.trace as ref_trace

    port, ref = servers
    # the JAX route starts jax.profiler's server on a fixed TCP port that
    # stays bound for the process's lifetime: its answer is compared with
    # the start stubbed, so that no port is bound
    monkeypatch.setattr(ref_trace, "start_profiler", lambda port=9999: port)
    port.profile_dir = str(tmp_path)
    with _serve(port) as url:
        code, _h, body = _call(url, path, {} if method == "POST" else None)
        if path == "/debug/profiler":
            # a running session would profile every later test here
            stopped = _call(url, "/debug/profiler?stop=1")
    if item == 10:
        # the memory observatory, the phase profiles and the profiler
        want = _ref_answer(ref, path)
        assert code == want[0] == 200, body
        if path == "/debug/profiler":
            assert body["profiler"] == want[2]["profiler"] == "running"
            assert stopped[0] == 200 and os.path.isfile(stopped[2]["trace"])
        else:
            # the JAX server's "native" block reports its C++ engine, which
            # the port does not have
            assert set(body) == set(want[2]) - {"native"}
        return
    if item == 7:
        # item 7's routes are served now (the capacity observatory and the
        # campaign planner): the report and the timeline answer, an empty
        # campaign is a typed 400 naming its field
        assert code == (400 if method == "POST" else 200), body
        assert body.get("field") == "steps" if method == "POST" else "roadmap" not in body
        return
    if item == 0:
        # served now (the time-series ring and the SLO engine): a server
        # that serve() did not start runs neither, and answers the JAX
        # package's typed 503
        want = _ref_answer(ref, path)
        assert (code, body) == (want[0], want[2]) == (503, body) and "roadmap" not in body


def _ref_answer(ref, path):
    """The JAX server's (status, headers, body) for GET `path`."""
    ref_httpd = ref_rest.SimonHTTPServer(("127.0.0.1", 0), ref_rest.make_handler(ref))
    threading.Thread(target=ref_httpd.serve_forever, daemon=True).start()
    try:
        return _call(f"http://127.0.0.1:{ref_httpd.server_address[1]}", path)
    finally:
        ref_httpd.shutdown()
        ref_httpd.server_close()


@pytest.mark.parametrize("kwargs,env,message", [
    ({"workers": 2}, {}, "--workers needs the live twin"),
    ({"workers": 2, "kubeconfig": "/kube", "watch": "off"}, {}, "--workers needs the live twin"),
    ({"workers": 2, "kubeconfig": "/kube"}, {"OPENSIM_HA": "1"}, "OPENSIM_HA=1 needs --journal"),
])
def test_serve_refuses_later_modes(kwargs, env, message, monkeypatch, capsys):
    """The fleet's operator errors, refused as the JAX package's serve()
    refuses them (exit 1, a message naming the missing piece) before
    anything starts: ``--workers`` without the live twin, and the HA lease
    without a journal to live beside."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert rest.serve(port=0, device="cpu", **kwargs) == 1
    out = capsys.readouterr().out
    assert message in out
    assert ref_rest.serve(port=0, **kwargs) == 1
    assert message in capsys.readouterr().out


def test_serve_watch_on_answers_from_the_twin(stubs, servers):
    """``--watch on``: start_server waits for the live twin to sync, and
    a request is served from it (its generation key in the trace, the
    state machine live in /metrics) with the polling server's answer."""
    server, httpd = rest.start_server(kubeconfig=stubs[0], watch="on", port=0, host="127.0.0.1", device="cpu")
    try:
        assert server.watch is not None and server.watch.has_synced() and server.watch.state() == "live"
        body = REQUESTS["deploy"]
        code, got = server.deploy_apps(json.loads(json.dumps(body)), request_id="twin-served")
        _code, want = servers[0].deploy_apps(json.loads(json.dumps(body)))
        assert code == 200 and _names(got) == _names(want)
        from opensim_tpu_torch.obs.recorder import FLIGHT_RECORDER

        key = FLIGHT_RECORDER.get("twin-served").root.attrs["twin_key"]
        assert key == f"{server.watch.key_prefix}{server.watch.twin.generation}"
        assert 'simon_watch_state{state="live"} 1' in server.metrics_text()
    finally:
        httpd.server_close()
        server.close()


def test_serve_with_a_journal_records_and_restores(stubs, tmp_path):
    """``--journal``: the first start relists and checkpoints the twin;
    a second start on the same directory restores it from the journal
    (``simon_journal_recoveries_total{outcome="restored"}``) with the
    first twin's fingerprint, and close() leaves the history recoverable."""
    from opensim_tpu_torch.server.journal import Journal, iter_records

    jd = str(tmp_path / "journal")
    fps = []
    for run in range(2):
        server, httpd = rest.start_server(kubeconfig=stubs[0], watch="on", journal=jd, port=0, host="127.0.0.1",
                                          device="cpu")
        try:
            fps.append(server.watch.twin.fingerprint())
            text = server.metrics_text()
            if run:
                assert 'simon_journal_recoveries_total{outcome="restored"} 1' in text
                assert "simon_watch_relists_total 0" in text
        finally:
            httpd.server_close()
            server.close()
    assert fps[0] == fps[1]
    assert [r["why"] for r in iter_records(jd) if r["t"] == "ck"][:2] == ["bootstrap", "recovered"]
    assert Journal(jd, readonly=True).recover().outcome == "restored"


def test_serve_without_a_card_raises_before_listening(monkeypatch):
    """No card and no --device cpu: the server raises at start, before it
    binds a port; the CLI reports it and exits 1."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bound = []
    monkeypatch.setattr(rest, "SimonHTTPServer", lambda *a, **k: bound.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rest.start_server(port=0, host="127.0.0.1")
    assert not bound
    assert cli.main(["server", "--port", "0"]) == 1
    assert cli.main(["server", "--watch", "on", "--device", "cpu"]) == 1
    assert not bound


def test_start_server_on_cpu_binds_and_answers():
    server, httpd = rest.start_server(port=0, host="127.0.0.1", device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert _call(url, "/healthz")[0] == 200
        code, _h, body = _call(url, "/api/deploy-apps",
                               {"newnodes": [fx.make_fake_node("t", "8", "16Gi").raw],
                                "deployments": [fx.make_fake_deployment("w", 2, "100m", "128Mi").raw]})
        assert code == 200 and body["nodeStatus"][0]["node"].startswith("simon-")
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert server.device.type == "cpu"


def test_build_compiles_each_variant_once_under_two_threads(monkeypatch, tmp_path):
    """Two endpoints launching the same variants at once: build's lock lets
    one thread compile and the other find the libraries loaded (a stubbed
    compiler counts the compiles)."""
    compiles = []

    class FakeProc:
        def __init__(self, cmd, **_kw):
            compiles.append(cmd)
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            time.sleep(0.05)  # widen the window two unlocked builds would race in
            with open(self.out, "w") as f:
                f.write("lib")
            return "", "ptxas info    : Used 32 registers"

    lib = types.SimpleNamespace(fast_scan_launch=types.SimpleNamespace(), fast_scan_sweep_launch=types.SimpleNamespace())
    monkeypatch.setattr(jitcache, "_DIR", tmp_path)
    monkeypatch.setattr(fs, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(fs.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(fs.ctypes, "CDLL", lambda path: lib)
    monkeypatch.setattr(fs, "_LIBS", {})
    monkeypatch.setattr(fs, "_PTXAS", {})
    names = ["fast_scan", "fast_scan[explain]"]
    threads = [threading.Thread(target=fs.build, args=(names,)) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(compiles) == 2 and sorted(fs._LIBS) == sorted(names)


# ---------------------------------------------------------------------------
# the snapshot lister and simon apply in kubeConfig mode
# ---------------------------------------------------------------------------


def _pod(name, phase="Running", owners=None, deleting=False, node=""):
    d = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": "default"},
         "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "100m"}}}]},
         "status": {"phase": phase}}
    if node:
        d["spec"]["nodeName"] = node
    if owners:
        d["metadata"]["ownerReferences"] = owners
    if deleting:
        d["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    return d


_LISTED = {
    "/api/v1/nodes": [fx.make_fake_node("n1", "8", "16Gi").raw, fx.make_fake_node("n2", "8", "16Gi").raw],
    "/api/v1/pods": [
        _pod("keep-running", "Running", node="n1"),
        _pod("keep-pending", "Pending"),
        _pod("skip-succeeded", "Succeeded"),
        _pod("skip-ds-owned", "Running", owners=[{"kind": "DaemonSet", "name": "agent", "controller": True}]),
        _pod("keep-rs-owned", "Running", owners=[{"kind": "ReplicaSet", "name": "web-abc", "controller": True}]),
        _pod("skip-deleting", "Running", deleting=True),
    ],
    "/apis/apps/v1/daemonsets": [fx.make_fake_daemon_set("agent", "50m", "64Mi").raw],
    "/apis/policy/v1/poddisruptionbudgets": [{"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                                              "metadata": {"name": "pdb-1", "namespace": "default"},
                                              "spec": {"minAvailable": 1,
                                                       "selector": {"matchLabels": {"app": "web"}}}}],
    "/api/v1/services": [{"kind": "Service", "metadata": {"name": "svc"}}],
    "/apis/storage.k8s.io/v1/storageclasses": [{"kind": "StorageClass", "metadata": {"name": "open-local-lvm"}}],
    "/api/v1/persistentvolumeclaims": [{"kind": "PersistentVolumeClaim", "metadata": {"name": "pvc-1"}}],
    "/api/v1/configmaps": [{"kind": "ConfigMap", "metadata": {"name": "cm-1"}}],
}


@contextmanager
def _listing_stubs(tmp_path, forbidden=()):
    """Port and JAX stubs listing _LISTED, with `forbidden` paths 403."""
    made = []
    for cls, sub in ((StubApiServer, "port"), (RefStub, "jax")):
        stub = cls().start()
        for path, objs in _LISTED.items():
            stub.seed(path, objs)
        stub.forbidden_paths.update(forbidden)
        (tmp_path / sub).mkdir(exist_ok=True)
        made.append((stub, stub.kubeconfig(tmp_path / sub)))
    try:
        yield made
    finally:
        for stub, _kc in made:
            stub.stop()


def _listing(rt):
    return {f: [(o.kind, o.metadata.namespace, o.metadata.name, json.dumps(o.raw, sort_keys=True)) for o in getattr(rt, f)]
            for f in ("nodes", "pods", "daemon_sets", "pdbs", "services", "storage_classes", "pvcs", "config_maps")}


@pytest.mark.parametrize("forbidden", [(), ("/api/v1/services", "/api/v1/configmaps",
                                            "/apis/policy/v1/poddisruptionbudgets",
                                            "/apis/storage.k8s.io/v1/storageclasses",
                                            "/api/v1/persistentvolumeclaims")])
def test_rest_lister_equals_jax(tmp_path, forbidden):
    """The port's lister against its stub equals the JAX package's against
    its own: the pod filter (Running and Pending, not deleting, not
    DaemonSet-owned), the optional endpoints a minimal-RBAC cluster 403s,
    resourceVersion=0 on every list."""
    with _listing_stubs(tmp_path, forbidden) as ((stub, kc), (ref_stub, ref_kc)):
        rt, rvs = snapshot._cluster_via_rest(kc, None)
        ref_rt, ref_rvs = ref_snapshot._cluster_via_rest(ref_kc, None)
        assert _listing(rt) == _listing(ref_rt)
        assert sorted(p.metadata.name for p in rt.pods) == ["keep-pending", "keep-rs-owned", "keep-running"]
        assert set(rvs) == set(ref_rvs) == {s.field for s in snapshot.RESOURCES if s.path not in forbidden}
        lists = [q for _p, q in stub.requests_seen]
        assert lists and all(q.get("resourceVersion") == ["0"] for q in lists)
        assert _listing(snapshot.cluster_from_kubeconfig(kc)) == _listing(rt)


def test_required_endpoint_403_fails(tmp_path):
    with _listing_stubs(tmp_path, ("/api/v1/pods",)) as ((_stub, kc), _ref):
        with pytest.raises(RuntimeError, match="HTTP 403"):
            snapshot._cluster_via_rest(kc, None)
    empty = tmp_path / "empty"
    empty.write_text("apiVersion: v1\nkind: Config\n")
    with pytest.raises(RuntimeError, match="no cluster server"):
        snapshot.cluster_from_kubeconfig(str(empty))


def test_client_path_filters_like_jax(monkeypatch):
    """With the kubernetes package (a fake module here) the client path
    lists every endpoint with resourceVersion=0 and filters the pods as
    the REST lister does — as the JAX package's client path."""
    calls = {}

    def lister(field):
        def call(self, resource_version=None):
            calls[field] = resource_version
            return types.SimpleNamespace(items=[json.loads(json.dumps(o)) for o in _LISTED[path_of[field]]])
        return call

    path_of = {s.field: s.path for s in snapshot.RESOURCES}
    core = type("CoreV1Api", (), {"list_node": lister("nodes"), "list_pod_for_all_namespaces": lister("pods"),
                                  "list_service_for_all_namespaces": lister("services"),
                                  "list_persistent_volume_claim_for_all_namespaces": lister("pvcs"),
                                  "list_config_map_for_all_namespaces": lister("config_maps")})
    client = types.ModuleType("kubernetes.client")
    client.CoreV1Api = core
    client.AppsV1Api = type("AppsV1Api", (), {"list_daemon_set_for_all_namespaces": lister("daemon_sets")})
    client.PolicyV1Api = type("PolicyV1Api", (), {
        "list_pod_disruption_budget_for_all_namespaces": lister("pdbs")})
    client.StorageV1Api = type("StorageV1Api", (), {"list_storage_class": lister("storage_classes")})
    client.ApiClient = type("ApiClient", (), {"sanitize_for_serialization": lambda self, o: o})
    config = types.ModuleType("kubernetes.config")
    config.load_kube_config = lambda config_file=None: calls.setdefault("kubeconfig", config_file)
    kubernetes = types.ModuleType("kubernetes")
    kubernetes.client, kubernetes.config = client, config
    for name, mod in (("kubernetes", kubernetes), ("kubernetes.client", client), ("kubernetes.config", config)):
        monkeypatch.setitem(sys.modules, name, mod)
    rt = snapshot.cluster_from_kubeconfig("/tmp/kubeconfig")
    calls_port = dict(calls)
    calls.clear()
    ref_rt = ref_snapshot.cluster_from_kubeconfig("/tmp/kubeconfig")
    assert calls_port == calls and calls["kubeconfig"] == "/tmp/kubeconfig"
    assert all(v == "0" for k, v in calls.items() if k != "kubeconfig")
    assert _listing(rt) == _listing(ref_rt)


def test_apply_against_stub_apiserver_equals_jax(tmp_path):
    """``simon apply`` with a kubeConfig cluster: both Appliers list their
    stub (a bound pod replayed as forced, the filtered ones left out, the
    DaemonSet re-expanded) and report the same, but for the engine footer
    and the counters in names."""
    import yaml

    appdir = tmp_path / "app"
    appdir.mkdir()
    (appdir / "deploy.yaml").write_text(yaml.safe_dump(fx.make_fake_deployment("web", 3, "500m", "512Mi").raw))
    with _listing_stubs(tmp_path) as ((_stub, kc), (_ref_stub, ref_kc)):
        reports = []
        for name, mod, kubeconfig, extra in (("port", apply, kc, {"device": "cpu"}),
                                             ("jax", ref_apply, ref_kc, {})):
            cfg = tmp_path / f"{name}-config.yaml"
            cfg.write_text("apiVersion: simon/v1alpha1\nkind: Config\nmetadata: {name: live}\nspec:\n"
                           f"  cluster: {{kubeConfig: '{kubeconfig}'}}\n"
                           f"  appList:\n    - {{name: webapp, path: '{appdir}'}}\n")
            out = tmp_path / f"{name}.txt"
            rc = mod.Applier(mod.Options(simon_config=str(cfg), output_file=str(out), **extra)).run()
            reports.append((rc, out.read_text()))
    (rc, text), (ref_rc, ref_text) = reports
    strip = lambda t: "\n".join(line for line in _norm(t).splitlines() if not line.startswith("Scheduling engine"))
    assert rc == ref_rc == 0
    assert strip(text) == strip(ref_text)
    assert "Simulation success!" in text and "webapp" in text and "n1" in text
