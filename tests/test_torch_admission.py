"""The port's admission queue (``server/admission.py``) and request batching
(``engine/reqbatch.py``) on the CPU, the cases of tests/test_admission.py:
concurrent deploy/scale/explain requests through
the port's server, coalesced into one request batch (the plain sweep on
the CPU), answer what the JAX package's single-flight server
(``admission=False``) answers to each request alone; the worker pool, the
queue's typed sheds (503 + Retry-After, 504 in the queue and before the
launch), shutdown, the priority lanes, the pipeline and its off knob, the
``/metrics`` families, and batches over the live twin while its watch
events land mid-storm. Pod names carry the process's expansion
counters, so answers are compared with each pod name cut to its
workload's (:func:`_canon`, the reference test's canonical form); all
else (nodes, counts, reasons, explain audits) exactly."""

import copy
import dataclasses
import re
import threading
import time

import pytest

from opensim_tpu.models import expand as ref_expand
from opensim_tpu.server import rest as ref_rest
from opensim_tpu_torch.engine import prepcache, reqbatch
from opensim_tpu_torch.engine.simulator import AppResource, prepare
from opensim_tpu_torch.models import ResourceTypes, fixtures as fx
from opensim_tpu_torch.obs.metrics import RECORDER
from opensim_tpu_torch.obs.recorder import FLIGHT_RECORDER
from opensim_tpu_torch.resilience import faults
from opensim_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from opensim_tpu_torch.server import admission as admission_mod
from opensim_tpu_torch.server import rest
from opensim_tpu_torch.server.pool import WorkerPool


@pytest.fixture(autouse=True)
def _clean_recorders():
    FLIGHT_RECORDER.clear()
    RECORDER.reset()
    yield
    FLIGHT_RECORDER.clear()
    RECORDER.reset()


def _reference_copy(rt):
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def _workloads_of(payloads) -> list:
    return [d["metadata"]["name"] for p in payloads for d in p.get("deployments") or []]


def _canon_pod(ref: str, workloads) -> str:
    """``ns/name`` → ``ns/<owning workload>`` (longest prefix wins)."""
    ns, _, name = ref.partition("/")
    best = ""
    for w in workloads:
        if name.startswith(w) and len(w) > len(best):
            best = w
    return f"{ns}/{best or name}"


def _canon(body: dict, workloads):
    return (
        sorted((_canon_pod(u["pod"], workloads), u["reason"]) for u in body["unscheduledPods"]),
        sorted((e["node"], sorted(_canon_pod(p, workloads) for p in e["pods"])) for e in body["nodeStatus"]),
    )


def _explanations(body: dict, workloads) -> dict:
    strip = lambda e: {k: v for k, v in e.items() if k != "pod"} if isinstance(e, dict) else e
    return {_canon_pod(u["pod"], workloads): strip(u.get("explanation")) for u in body["unscheduledPods"]}


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX package's single-flight server's answer to each request of
    the mixed storm alone, and to each explain request alone."""
    server = ref_rest.SimonServer(base_cluster=_reference_copy(fx.admission_cluster()), admission=False,
                                  capacity=False)
    plain = [(server.deploy_apps if k == "deploy" else server.scale_apps)(p) for k, p in fx.admission_requests()]
    explain = [server.deploy_apps(p, explain=True) for p in _explain_payloads()]
    for code, body in plain + explain:
        assert code == 200, body
    return [b for _c, b in plain], [b for _c, b in explain]


def _explain_payloads():
    payloads = [{"deployments": [fx.make_fake_deployment(f"xp-{i}", 2, "500m", "1Gi").raw]} for i in range(3)]
    payloads.append({"deployments": [fx.make_fake_deployment("xhuge", 1, "640", "1Gi").raw]})
    return payloads


def _make_server(window_s=None, pipelined=True, **kwargs):
    server = rest.SimonServer(base_cluster=fx.admission_cluster(), device="cpu", **kwargs)
    if window_s is not None and server.admission is not None:
        server.admission.stop()
        stage_fns = (dict(prep_fn=server._batch_prep, dispatch_fn=server._batch_dispatch,
                          decode_fn=server._batch_decode) if pipelined else {})
        server.admission = admission_mod.AdmissionController(
            solo_fn=server._admitted_solo, batch_fn=server._admitted_batch, window_s=window_s, **stage_fns)
    return server


def _storm(server, reqs, explain=False):
    results = [None] * len(reqs)

    def run(i, kind, payload):
        results[i] = (server.deploy_apps if kind == "deploy" else server.scale_apps)(payload, explain=explain)

    threads = [threading.Thread(target=run, args=(i, k, p)) for i, (k, p) in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


# ---------------------------------------------------------------------------
# a batch answers what each request gets alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pipelined", [True, False])
def test_concurrent_batched_equals_jax_serial(jax_answers, pipelined):
    """The mixed storm (deploys, a scale, an unschedulable deploy) through
    the queue with a wide window coalesces into a batch whose answers
    equal the JAX server's single-flight answers; the staged pipeline and
    the serial batch path alike (tests/test_admission.py:136, :713)."""
    reqs = fx.admission_requests()
    wl = _workloads_of([p for _, p in reqs])
    server = _make_server(window_s=0.25, pipelined=pipelined)
    try:
        assert server.admission.pipelined is pipelined
        results = _storm(server, reqs)
        for i, (code, body) in enumerate(results):
            assert code == 200, (i, body)
            assert _canon(body, wl) == _canon(jax_answers[0][i], wl), f"request {i} diverged"
        assert server.admission.batches_total >= 1
        if pipelined:
            snap = server.admission.pipeline_snapshot()
            for stage in ("prep", "dispatch", "decode"):
                assert snap["stages"].get(stage, {}).get("count", 0) >= 1, stage
    finally:
        server.close()


def test_explain_requests_batch_and_match_solo_audit(jax_answers):
    """``explain=1`` deploys ride one batch (the grid's [explain] variant on
    the card, the plain sweep counting every step here) and each answer,
    its reject totals and the unschedulable rider's explanations, equals
    the JAX server's solo explain answer (tests/test_admission.py:571)."""
    payloads = _explain_payloads()
    wl = _workloads_of(payloads)
    server = _make_server(window_s=0.25)
    try:
        results = _storm(server, [("deploy", p) for p in payloads], explain=True)
        for i, (code, body) in enumerate(results):
            want = jax_answers[1][i]
            assert code == 200, (i, body)
            assert _canon(body, wl) == _canon(want, wl)
            assert body.get("filterRejects") == want.get("filterRejects"), i
            assert _explanations(body, wl) == _explanations(want, wl), i
        assert server.admission.batches_total >= 1, "explain traffic never batched"
    finally:
        server.close()


def test_batch_sheds_expired_riders_before_the_launch():
    """A rider whose deadline died before the launch gets the typed 504
    (phase schedule) and its lane schedules nothing; the live riders'
    results are untouched (tests/test_admission.py:632)."""
    cluster = fx.admission_cluster()
    base = prepcache.CacheEntry("b|base", prepare(cluster, [], device="cpu"))
    apps = []
    for i in range(3):
        rt = ResourceTypes()
        rt.add(fx.make_fake_deployment(f"dl-{i}", 2, "500m", "1Gi"))
        apps.append(AppResource("deploy", rt))

    def run(deadlines):
        with base.lock:
            base.restore()
            derived, slices = prepcache.derive_with_app_slices(base.prep, cluster, apps, base_entry=base)
            items = [reqbatch.BatchItem(cluster=cluster, apps=[apps[s]], lo=slices[s][0], hi=slices[s][1],
                                        deadline=deadlines[s]) for s in range(len(apps))]
            try:
                return reqbatch.run_request_batch(derived, items)
            finally:
                base.restore()

    clean = run([None, None, None])
    dead = Deadline.after(0.0)
    assert dead.expired()
    mixed = run([None, dead, None])
    assert isinstance(mixed[1], DeadlineExceeded) and mixed[1].phase == "schedule"
    for s in (0, 2):
        assert not isinstance(mixed[s], BaseException)
        placed = lambda r: sorted((ns.node.metadata.name, len(ns.pods)) for ns in r.node_status if ns.pods)
        assert placed(mixed[s]) == placed(clean[s]), f"live rider {s} perturbed by the shed rider"


@pytest.mark.parametrize("engine", ["xla", "native"])
def test_batch_engine_names_the_ports_one_rung(monkeypatch, engine):
    monkeypatch.setenv("OPENSIM_BATCH_ENGINE", engine)
    with pytest.raises(ValueError, match="one engine"):
        reqbatch.batch_engine_mode()


def test_unbatchable_newnodes_rides_worker_pool_alongside_batch():
    """A newnodes request runs solo on the pool beside a batch and binds
    its pods onto its fresh simon-* node (tests/test_admission.py:180)."""
    server = _make_server(window_s=0.25)
    new_node_payload = {
        "deployments": [fx.make_fake_deployment("nn", 2, "500m", "1Gi",
                                                fx.with_node_selector({"simon/new-node": ""})).raw],
        "newnodes": [fx.make_fake_node("template", "8", "16Gi").raw],
    }
    plain = {"deployments": [fx.make_fake_deployment("plain-a", 2, "250m", "512Mi").raw]}
    plain2 = {"deployments": [fx.make_fake_deployment("plain-b", 2, "250m", "512Mi").raw]}
    try:
        results = _storm(server, [("deploy", p) for p in (new_node_payload, plain, plain2)])
        for code, body in results:
            assert code == 200, body
        assert any(e["node"].startswith("simon-") for e in results[0][1]["nodeStatus"])
    finally:
        server.close()


def test_malformed_payload_fails_only_its_own_batch_rider():
    """One undecodable payload 500s alone; the batch's other riders answer
    (tests/test_admission.py:477)."""
    server = _make_server(window_s=0.25)
    payloads = [{"deployments": [fx.make_fake_deployment(f"ok-{i}", 2, "250m", "256Mi").raw]} for i in range(3)]
    payloads.append({"deployments": ["garbage - not an object"]})
    try:
        results = _storm(server, [("deploy", p) for p in payloads])
        for code, body in results[:3]:
            assert code == 200, body
        code, body = results[3]
        assert code == 500 and "error" in body and "type" in body
    finally:
        server.close()


def test_generation_swap_mid_prep_retries_once_equal_to_jax(jax_answers):
    """A stale fingerprint at the prep stage (the ``cache.stale`` fault
    point) retries once inside prep; the storm still answers the JAX
    server's single-flight answers."""
    reqs = fx.admission_requests()
    wl = _workloads_of([p for _, p in reqs])
    server = _make_server(window_s=0.25)
    faults.inject("cache.stale", count=1, exc="stale")
    try:
        results = _storm(server, reqs)
        for i, (code, body) in enumerate(results):
            assert code == 200, (i, body)
            assert _canon(body, wl) == _canon(jax_answers[0][i], wl), f"request {i} diverged"
        assert server.metrics.stale_prep_retries >= 1
    finally:
        faults.clear_faults()
        server.close()


# ---------------------------------------------------------------------------
# sheds and deadlines: typed errors, never partial results
# ---------------------------------------------------------------------------


def test_queue_full_sheds_typed_503_with_retry_after():
    """Past the bound a request sheds at once with a typed 503 carrying
    Retry-After; the shed's real latency is recorded
    (tests/test_admission.py:264)."""
    server = rest.SimonServer(base_cluster=fx.admission_cluster(), device="cpu")
    server.admission.stop()
    server.admission = admission_mod.AdmissionController(
        solo_fn=server._admitted_solo, batch_fn=server._admitted_batch, window_s=0.6, bound=1)
    try:
        first = {}

        def hold():
            first["resp"] = server.deploy_apps(
                {"deployments": [fx.make_fake_deployment("hold", 2, "250m", "256Mi").raw]})

        t = threading.Thread(target=hold)
        t.start()
        time.sleep(0.1)
        code, body = server.deploy_apps({"deployments": [fx.make_fake_deployment("shed-me", 2, "250m", "256Mi").raw]})
        assert code == 503
        assert body["reason"] == "queue_full" and body["retryable"] is True
        assert "Retry-After" in rest.response_extra_headers()
        t.join()
        assert first["resp"][0] == 200
        text = server.metrics_text()
        assert 'simon_shed_total{reason="queue_full"} 1' in text
        assert 'status="shed"' in text
    finally:
        server.close()


def test_deadline_expiring_in_queue_sheds_504_queue_phase():
    server = rest.SimonServer(base_cluster=fx.admission_cluster(), device="cpu")
    server.admission.stop()
    server.admission = admission_mod.AdmissionController(
        solo_fn=server._admitted_solo, batch_fn=server._admitted_batch, window_s=0.5)
    try:
        dl = Deadline.after(0.1)  # alive at admission, dead when the window closes
        code, body = server.deploy_apps(
            {"deployments": [fx.make_fake_deployment("late", 2, "250m", "256Mi").raw]}, deadline=dl)
        assert code == 504 and body["phase"] == "queue"
        assert 'simon_shed_total{reason="deadline"} 1' in server.metrics_text()
    finally:
        server.close()


def _pre_expired() -> Deadline:
    dl = Deadline.after(1e-9)
    time.sleep(0.01)
    return dl


@pytest.mark.parametrize("storm", [False, True])
def test_pre_expired_deadline_keeps_legacy_phase_contract(storm):
    """A deadline already dead at admission runs solo and 504s at its first
    phase boundary, alone and beside batchable traffic
    (tests/test_admission.py:333, :504)."""
    server = _make_server(window_s=0.25) if storm else rest.SimonServer(base_cluster=fx.admission_cluster(),
                                                                       device="cpu")
    results = {}

    def ok_run(i):
        results[i] = server.deploy_apps({"deployments": [fx.make_fake_deployment(f"live-{i}", 2, "250m",
                                                                                 "256Mi").raw]})

    def dead_run():
        results["dead"] = server.deploy_apps(
            {"deployments": [fx.make_fake_deployment("dead", 2, "250m", "256Mi").raw]}, deadline=_pre_expired())

    threads = [threading.Thread(target=ok_run, args=(i,)) for i in range(3 if storm else 0)]
    threads.append(threading.Thread(target=dead_run))
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(3 if storm else 0):
            assert results[i][0] == 200
        code, body = results["dead"]
        assert code == 504 and body["phase"] in ("snapshot", "prepare", "encode", "schedule", "decode")
    finally:
        server.close()


def test_shutdown_resolves_queued_tickets_with_typed_shed():
    # the window outlasts the stop, which joins the dispatcher sleeping in it
    ctrl = admission_mod.AdmissionController(solo_fn=lambda t: None, batch_fn=lambda ts: None, window_s=1.0)
    t1 = admission_mod.Ticket(kind="deploy", payload={})
    ctrl.submit(t1)
    ctrl.stop()
    with pytest.raises(admission_mod.QueueFull):
        ctrl.wait(t1)
    with pytest.raises(admission_mod.QueueFull):  # after stop, a submission sheds at once
        ctrl.submit(admission_mod.Ticket(kind="deploy", payload={}))


def test_process_pool_runs_unpicklable_tasks_on_threads():
    """Process mode never hangs admission work: unpicklable tasks run on
    the thread fallback (tests/test_admission.py:540)."""
    pool = WorkerPool(workers=2, mode="process")
    try:
        ev = threading.Event()

        class Holder:
            def poke(self, e):
                e.set()
                return "threaded"

        assert pool.submit(Holder().poke, ev).result(timeout=10) == "threaded"
        assert ev.is_set()
        if pool.mode == "process":
            assert pool.submit(len, (1, 2, 3)).result(timeout=30) == 3
    finally:
        pool.shutdown()


# ---------------------------------------------------------------------------
# metrics, lanes and the pipeline's knob
# ---------------------------------------------------------------------------


def test_batched_and_solo_paths_expose_queue_metrics():
    """(tests/test_admission.py:221, with the pipeline's and lanes' families
    of :713.)"""
    server = _make_server(window_s=0.15)
    try:
        payloads = [{"deployments": [fx.make_fake_deployment(f"m-{i}", 2, "250m", "256Mi").raw]} for i in range(4)]
        results = _storm(server, [("deploy", p) for p in payloads])
        assert all(code == 200 for code, _ in results)
        text = server.metrics_text()
        for needle in (
            "# TYPE simon_admission_queue_depth gauge", "# TYPE simon_batch_size histogram",
            "# TYPE simon_shed_total counter", "# TYPE simon_queue_wait_seconds histogram", "simon_batches_total",
            "# TYPE simon_pipeline_stage_seconds histogram", "# TYPE simon_pipeline_prep_overlap_seconds_total counter",
            "# TYPE simon_pipeline_overlapped_batches_total counter", "# TYPE simon_lane_depth gauge",
            "# TYPE simon_lane_admitted_total counter", "# TYPE simon_lane_shed_total counter",
            "# TYPE simon_lane_starvation_promotions_total counter", 'simon_pipeline_stage_seconds_count{stage="prep"}',
        ):
            assert needle in text, needle
        m = re.search(r"simon_queue_wait_seconds_count (\d+)", text)
        assert m and int(m.group(1)) >= 4
        m = re.search(r"simon_batch_size_count (\d+)", text)
        assert m and int(m.group(1)) >= 1
    finally:
        server.close()


def _lane_ticket(name, reps, explain=False):
    return admission_mod.Ticket(kind="deploy", explain=explain,
                                payload={"deployments": [fx.make_fake_deployment(name, reps, "100m", "128Mi").raw]})


def _lane_controller(batch_fn, window_s=0.4, **kwargs):
    return admission_mod.AdmissionController(solo_fn=lambda t: t.resolve(result=None), batch_fn=batch_fn,
                                             window_s=window_s, **kwargs)


def test_interactive_lane_overtakes_bulk_within_weight(monkeypatch):
    """Small requests submitted after large ones are drained first, FIFO
    within each lane (tests/test_admission.py:814)."""
    monkeypatch.setenv("OPENSIM_LANE_STARVATION_S", "30")  # isolate the weight
    order, done = [], threading.Event()

    def batch_fn(tickets):
        order.extend((t.lane, t.payload["deployments"][0]["metadata"]["name"]) for t in tickets)
        for t in tickets:
            t.resolve(result=None)
        done.set()

    ctrl = _lane_controller(batch_fn)
    try:
        tickets = [ctrl.submit(_lane_ticket("big-0", 50)), ctrl.submit(_lane_ticket("big-1", 50)),
                   ctrl.submit(_lane_ticket("small-0", 1)), ctrl.submit(_lane_ticket("small-1", 1, explain=True))]
        assert done.wait(timeout=30)
        for t in tickets:
            ctrl.wait(t)
        assert order == [("interactive", "small-0"), ("interactive", "small-1"), ("bulk", "big-0"),
                         ("bulk", "big-1")]
        assert ctrl.lane_admitted == {"interactive": 2, "bulk": 2}
    finally:
        ctrl.stop()


def test_bulk_starvation_bound_promotes_past_weight(monkeypatch):
    """(tests/test_admission.py:848.)"""
    monkeypatch.setenv("OPENSIM_LANE_STARVATION_S", "0")
    order, done = [], threading.Event()

    def batch_fn(tickets):
        order.extend(t.lane for t in tickets)
        for t in tickets:
            t.resolve(result=None)
        done.set()

    ctrl = _lane_controller(batch_fn, window_s=0.3)
    try:
        tickets = [ctrl.submit(_lane_ticket("big", 50)), ctrl.submit(_lane_ticket("small-0", 1)),
                   ctrl.submit(_lane_ticket("small-1", 1))]
        assert done.wait(timeout=30)
        for t in tickets:
            ctrl.wait(t)
        assert order[0] == "bulk", order
        assert ctrl.starvation_promotions >= 1
        text = rest._Metrics().render(admission=ctrl)
        assert re.search(r"simon_lane_starvation_promotions_total [1-9]", text)
    finally:
        ctrl.stop()


def test_queue_full_shed_is_lane_attributed():
    """(tests/test_admission.py:880.)"""
    ctrl = _lane_controller(lambda ts: None, window_s=5.0, bound=1)
    try:
        assert ctrl.submit(_lane_ticket("held", 1)) is not None  # parks in the window
        with pytest.raises(admission_mod.QueueFull):
            ctrl.submit(_lane_ticket("shed-bulk", 50))
        text = rest._Metrics().render(admission=ctrl)
        assert 'simon_lane_shed_total{lane="bulk",reason="queue_full"} 1' in text
        assert 'simon_shed_total{reason="queue_full"} 1' in text
        assert 'simon_lane_admitted_total{lane="interactive"} 1' in text
    finally:
        ctrl.stop()


def test_pipeline_off_knob_restores_serial_batch_path(monkeypatch):
    """(tests/test_admission.py:901.)"""
    monkeypatch.setenv("OPENSIM_PIPELINE", "off")
    server = _make_server(window_s=0.2)
    try:
        assert server.admission.pipelined is False
        for code, body in _storm(server, fx.admission_requests()[:3]):
            assert code == 200, body
        assert server.admission.pipeline_snapshot()["enabled"] is False
    finally:
        server.close()


def test_batched_requests_with_twin_events_mid_storm(tmp_path):
    """Concurrent batched requests while the live twin absorbs watch events
    (a pod ADDED and a pod DELETED mid-storm) all answer 200 with both
    keys; once the twin has settled, a request equals what a polling server
    that relists the same cluster answers (tests/test_admission.py:380's
    contract), and the deleted pod's row is masked in the batch's stream."""
    from opensim_tpu_torch.server.stubapi import StubApiServer
    from opensim_tpu_torch.server.watch import RestWatchSource, WatchSupervisor

    def pod(name, node, cpu):
        return {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": "default"},
                "spec": {"nodeName": node, "containers": [{"name": "c", "resources": {"requests": {"cpu": cpu}}}]},
                "status": {"phase": "Running"}}

    stub = StubApiServer(bookmark_interval_s=0.1).start()
    stub.seed("/api/v1/nodes", [fx.make_fake_node(f"n{i}", "8", "16Gi").raw for i in range(4)])
    stub.seed("/api/v1/pods", [pod("seed-0", "n0", "100m"), pod("seed-1", "n2", "3")])
    for p in ("/apis/apps/v1/daemonsets", "/apis/policy/v1/poddisruptionbudgets", "/api/v1/services",
              "/apis/storage.k8s.io/v1/storageclasses", "/api/v1/persistentvolumeclaims", "/api/v1/configmaps"):
        stub.seed(p, [])
    kc = stub.kubeconfig(str(tmp_path))
    sup = WatchSupervisor(RestWatchSource(kc, read_timeout_s=5.0),
                          policy={"stale_s": 5.0, "resync_s": 0.0, "reconnects": 3, "backoff_s": 0.02})
    server = rest.SimonServer(kubeconfig=kc, watch=sup, device="cpu")
    server.admission.stop()
    server.admission = admission_mod.AdmissionController(
        solo_fn=server._admitted_solo, batch_fn=server._admitted_batch, window_s=0.25,
        prep_fn=server._batch_prep, dispatch_fn=server._batch_dispatch, decode_fn=server._batch_decode)
    batches = []
    real = reqbatch.dispatch_request_batch
    try:
        assert sup.start(wait_s=15.0)
        assert server.deploy_apps({"deployments": [fx.make_fake_deployment("warm", 1, "100m", "128Mi").raw]})[0] == 200
        reqbatch.dispatch_request_batch = lambda prep, items: batches.append(items) or real(prep, items)
        reqs = [("deploy", {"deployments": [fx.make_fake_deployment(f"storm-{i}", 2, "500m", "1Gi").raw]})
                for i in range(6)]
        results = [None] * len(reqs)

        def run(i, payload):
            results[i] = server.deploy_apps(payload)

        threads = [threading.Thread(target=run, args=(i, p)) for i, (_k, p) in enumerate(reqs)]
        for t in threads:
            t.start()
        stub.upsert("/api/v1/pods", pod("mid-storm", "n1", "200m"))  # twin events land mid-storm
        stub.delete("/api/v1/pods", "seed-1")
        for t in threads:
            t.join()
        for code, body in results:
            assert code == 200, body
            assert set(body) >= {"unscheduledPods", "nodeStatus"}
        deadline = time.monotonic() + 10.0
        settled = lambda: {p.metadata.name for p in sup.twin.materialize().pods} == {"seed-0", "mid-storm"}
        while time.monotonic() < deadline and not settled():
            time.sleep(0.05)
        assert settled()
        after = [("deploy", {"deployments": [fx.make_fake_deployment("after", 9, "1", "1Gi").raw]}),
                 ("deploy", {"deployments": [fx.make_fake_deployment("after-b", 3, "500m", "1Gi").raw]})]
        n_batches = len(batches)
        twin_bodies = _storm(server, after)
        assert len(batches) == n_batches + 1, "the settled pair rides one batch"
        polling = rest.SimonServer(kubeconfig=kc, admission=False, device="cpu")
        for (kind, payload), (code, body) in zip(after, twin_bodies):
            assert code == 200
            code2, poll_body = polling.deploy_apps(copy.deepcopy(payload))
            assert code2 == 200
            names = [payload["deployments"][0]["metadata"]["name"]]
            assert _canon(body, names) == _canon(poll_body, names)
        assert all(len(it.drops) == 1 for it in batches[-1])  # seed-1's row, masked in every lane
    finally:
        reqbatch.dispatch_request_batch = real
        server.close()
        stub.stop()


def test_default_server_runs_the_admission_queue(monkeypatch):
    """``SimonServer()`` with the default settings runs the queue, as the
    reference's does; ``OPENSIM_ADMISSION=off`` serves single-flight."""
    server = rest.SimonServer(base_cluster=fx.admission_cluster(), device="cpu")
    try:
        assert isinstance(server.admission, admission_mod.AdmissionController)
        assert server.admission.pipelined
    finally:
        server.close()
    monkeypatch.setenv("OPENSIM_ADMISSION", "off")
    assert rest.SimonServer(base_cluster=fx.admission_cluster(), device="cpu").admission is None
