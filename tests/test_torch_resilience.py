"""The port's resilience layer and knob registry (opensim_tpu_torch/resilience,
utils/envknobs.py) through the cases of tests/test_resilience.py —
deadlines, jittered-backoff retry, fault injection —
and, through the port's server on the CPU, the recovery paths of
tests/test_chaos.py that the port has: a transient snapshot fetch fault
recovered by the retry, a down apiserver served from the stale snapshot
or failed closed with a typed 503, a stale cache entry recovered by one
internal retry, an encode fault failing closed then recovering, and an
exhausted deadline answering 504 with its phase. A recovered answer
equals the uninjected one."""

import random

import pytest

from opensim_tpu_torch.engine.simulator import AppResource, simulate
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.models.objects import ResourceTypes
from opensim_tpu_torch.resilience import faults
from opensim_tpu_torch.resilience.deadline import (
    Deadline,
    DeadlineExceeded,
    check_deadline,
    current_deadline,
    deadline_scope,
)
from opensim_tpu_torch.resilience.retry import retry_call
from opensim_tpu_torch.server import rest
from opensim_tpu_torch.utils import envknobs


@pytest.fixture(autouse=True)
def _clean_resilience_state(monkeypatch):
    monkeypatch.delenv("OPENSIM_FAULTS", raising=False)
    monkeypatch.setenv("OPENSIM_SNAPSHOT_BACKOFF_S", "0.001")
    faults.clear_faults()
    yield
    faults.clear_faults()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# deadline
# ---------------------------------------------------------------------------


def test_deadline_expiry_and_phase():
    clock = FakeClock()
    dl = Deadline.after(5.0, clock=clock)
    assert dl.remaining() == 5.0 and not dl.expired()
    dl.check("prepare")
    clock.t = 6.0
    assert dl.expired()
    with pytest.raises(DeadlineExceeded) as ei:
        dl.check("schedule")
    assert ei.value.phase == "schedule"
    assert "schedule" in str(ei.value) and "budget 5.000s" in str(ei.value)


def test_deadline_scope_is_ambient_and_restores():
    assert current_deadline() is None
    check_deadline("anything")  # no ambient deadline: no-op
    clock = FakeClock()
    dl = Deadline.after(1.0, clock=clock)
    with deadline_scope(dl):
        assert current_deadline() is dl
        clock.t = 2.0
        with pytest.raises(DeadlineExceeded) as ei:
            check_deadline("encode")
        assert ei.value.phase == "encode"
        with deadline_scope(None):  # keeps the ambient scope
            assert current_deadline() is dl
    assert current_deadline() is None


def test_simulate_honors_deadline_at_prepare_boundary():
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n1", "8", "16Gi"))
    app = ResourceTypes()
    app.pods.append(fx.make_fake_pod("p1", "500m", "1Gi"))
    clock = FakeClock()
    expired = Deadline.after(1.0, clock=clock)
    clock.t = 2.0
    with pytest.raises(DeadlineExceeded) as ei:
        simulate(cluster, [AppResource("a", app)], device="cpu", deadline=expired)
    assert ei.value.phase == "prepare"
    res = simulate(cluster, [AppResource("a", app)], device="cpu", deadline=Deadline.after(3600.0))
    assert not res.unscheduled_pods


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------


def test_retry_recovers_within_attempts():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    out = retry_call(flaky, attempts=3, base_delay=0.1, max_delay=2.0, retry_on=(OSError,), sleep=sleeps.append,
                     rng=random.Random(0))
    assert out == "ok" and len(calls) == 3
    assert len(sleeps) == 2  # full jitter: attempt k sleeps uniform[0, min(max, base * 2^k)]
    assert 0.0 <= sleeps[0] <= 0.1 and 0.0 <= sleeps[1] <= 0.2


def test_retry_exhaustion_reraises_last_error():
    sleeps = []
    with pytest.raises(OSError, match="always"):
        retry_call(lambda: (_ for _ in ()).throw(OSError("always")), attempts=4, base_delay=0.05,
                   retry_on=(OSError,), sleep=sleeps.append, rng=random.Random(1))
    assert len(sleeps) == 3


def test_retry_does_not_retry_foreign_exceptions():
    calls = []

    def auth_error():
        calls.append(1)
        raise ValueError("bad kubeconfig")

    with pytest.raises(ValueError):
        retry_call(auth_error, attempts=5, retry_on=(OSError,), sleep=lambda s: None)
    assert len(calls) == 1
    with pytest.raises(ValueError, match="attempts"):
        retry_call(lambda: 1, attempts=0)


# ---------------------------------------------------------------------------
# fault injection and the knob registry
# ---------------------------------------------------------------------------


def test_fault_point_fires_count_times_then_goes_inert():
    faults.inject("prep.encode", count=2, exc="runtime")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="injected fault at prep.encode"):
            faults.fault_point("prep.encode")
    faults.fault_point("prep.encode")
    assert faults.fault_stats() == {"prep.encode": 2}


def test_fault_env_activation_and_reparse(monkeypatch):
    monkeypatch.setenv("OPENSIM_FAULTS", "snapshot.http:1:oserror")
    with pytest.raises(OSError):
        faults.fault_point("snapshot.http")
    faults.fault_point("snapshot.http")  # consumed
    monkeypatch.setenv("OPENSIM_FAULTS", "snapshot.http:1:timeout")
    with pytest.raises(TimeoutError):
        faults.fault_point("snapshot.http")


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.inject("engine.compile")  # no engine ladder in the port
    with pytest.raises(ValueError, match="unknown fault exception"):
        faults.inject("cache.stale", exc="nonsense")
    with pytest.raises(ValueError, match="bad fault count"):
        faults.parse_spec("cache.stale:xyz")


def test_fault_exceptions_are_the_ports_types():
    from opensim_tpu_torch.engine.prepcache import StaleFingerprintError
    from opensim_tpu_torch.server.snapshot import SnapshotFetchError

    faults.inject("cache.stale", exc="stale")
    with pytest.raises(StaleFingerprintError):
        faults.fault_point("cache.stale")
    faults.inject("snapshot.http", exc="fetch")
    with pytest.raises(SnapshotFetchError):
        faults.fault_point("snapshot.http")


def test_knob_registry_reads_registered_names_only(monkeypatch):
    for name, knob in envknobs.KNOBS.items():
        assert name.startswith("OPENSIM_") and knob.doc
    with pytest.raises(KeyError, match="not registered"):
        envknobs.raw("OPENSIM_NO_SUCH_KNOB")
    monkeypatch.setenv("OPENSIM_TRACE", "0")
    assert envknobs.raw("OPENSIM_TRACE", "1") == "0"
    monkeypatch.delenv("OPENSIM_TRACE")
    assert envknobs.raw("OPENSIM_TRACE", "1") == "1"
    with pytest.raises(ValueError, match="registered twice"):
        envknobs.register(envknobs.KNOBS["OPENSIM_TRACE"])


# ---------------------------------------------------------------------------
# recovery through the server (the port's points of tests/test_chaos.py)
# ---------------------------------------------------------------------------


def _cluster(n_nodes=6):
    rt = ResourceTypes()
    for i in range(n_nodes):
        rt.nodes.append(fx.make_fake_node(f"n{i:03d}", "16", "64Gi", "110",
                                          fx.with_labels({"topology.kubernetes.io/zone": f"z{i % 3}"})))
    # a bound snapshot pod: the base entry is cached only for a snapshot
    # with pods, which the cache.stale path needs
    rt.pods.append(fx.make_fake_pod("pinned", "100m", "128Mi", fx.with_node_name("n000")))
    return rt


def _payload():
    return {"deployments": [fx.make_fake_deployment("web", 6, "500m", "1Gi").raw]}


def _shape(resp):
    return (sorted((e["node"], len(e["pods"])) for e in resp["nodeStatus"]),
            sorted(u["reason"] for u in resp["unscheduledPods"]))


def _baseline():
    code, body = rest.SimonServer(base_cluster=_cluster(), device="cpu").deploy_apps(_payload())
    assert code == 200
    return body


def _kubeconfig_server(monkeypatch, ttl=3600.0):
    fetches = []

    def fake_fetch(kubeconfig, master=None):
        fetches.append(kubeconfig)
        return _cluster()

    monkeypatch.setattr(rest, "cluster_from_kubeconfig", fake_fetch)
    return rest.SimonServer(kubeconfig="/tmp/kc", snapshot_ttl_s=ttl, device="cpu"), fetches


def test_snapshot_transient_fault_recovers_via_retry(monkeypatch):
    server, fetches = _kubeconfig_server(monkeypatch)
    faults.inject("snapshot.http", count=2, exc="fetch")  # 2 failures < 3 attempts
    code, body = server.deploy_apps(_payload())
    assert code == 200 and _shape(body) == _shape(_baseline())
    assert len(fetches) == 1 and server.metrics.snapshot_retries == 2
    assert faults.fault_stats() == {"snapshot.http": 2}


def test_snapshot_down_serves_stale_then_cold_fails_closed(monkeypatch):
    server, _fetches = _kubeconfig_server(monkeypatch, ttl=0.0)  # re-list every request
    assert server.deploy_apps(_payload())[0] == 200
    faults.inject("snapshot.http", count=3, exc="timeout")
    code, body = server.deploy_apps(_payload())
    assert rest.request_served_stale() and server.snapshot_stale
    assert code == 200 and _shape(body) == _shape(_baseline())
    assert server.metrics.snapshot_stale_served == 1
    cold, _f = _kubeconfig_server(monkeypatch)
    faults.inject("snapshot.http", count=3, exc="fetch")
    code, body = cold.deploy_apps(_payload())
    assert code == 503 and body["retryable"] is True
    assert "simon_requests_total" in cold.metrics_text()


def test_cache_stale_fault_recovers_by_one_internal_retry():
    server = rest.SimonServer(base_cluster=_cluster(), device="cpu")
    assert server.deploy_apps(_payload())[0] == 200
    faults.inject("cache.stale", count=1, exc="stale")
    code, body = server.deploy_apps(_payload())
    assert code == 200 and _shape(body) == _shape(_baseline())
    assert server.metrics.stale_prep_retries == 1
    faults.inject("cache.stale", count=2, exc="stale")  # the retry stale too: a typed 500
    code, body = server.deploy_apps(_payload())
    assert code == 500 and body["type"] == "StaleFingerprintError"
    assert server.deploy_apps(_payload())[0] == 200  # and the next request recovers


def test_encode_fault_fails_closed_then_recovers():
    server = rest.SimonServer(base_cluster=_cluster(), device="cpu")
    faults.inject("prep.encode", count=1, exc="runtime")
    code, body = server.deploy_apps(_payload())
    assert code == 500 and body["type"] == "RuntimeError" and "prep.encode" in body["error"]
    code, body = server.deploy_apps(_payload())
    assert code == 200 and _shape(body) == _shape(_baseline())


def test_deadline_returns_504_with_phase_and_env_default(monkeypatch):
    server = rest.SimonServer(base_cluster=_cluster(), device="cpu")
    code, body = server.deploy_apps(_payload(), deadline=Deadline.after(-1.0))
    assert code == 504 and body["phase"] == "prepare"
    assert server.metrics.request_timeouts == 1
    monkeypatch.setenv("OPENSIM_REQUEST_TIMEOUT_S", "0.5")
    assert rest.request_deadline({}).budget_s == 0.5
    assert rest.request_deadline({"X-Simon-Timeout-S": "2"}).budget_s == 2.0
    monkeypatch.setenv("OPENSIM_REQUEST_TIMEOUT_S", "0")
    assert rest.request_deadline({}) is None and rest.request_deadline({"X-Simon-Timeout-S": "x"}) is None
