"""What a served request reuses and what the server builds before it
listens, on the CPU: a cache entry keeps its stream's kernel inputs, so a
full-key hit builds none (the reference keeps them on its Prepared,
``opensim_tpu/engine/fastpath.py:190``); a Prepared outside the cache, or
a node mask, builds them anew; and the kernel variants a server builds at
start, read from one pod per owner of its snapshot, are those of a full
prepare of the snapshot, on every small bind-scan case and on the server
plan's bound snapshot."""

import copy
import json

import numpy as np
import pytest

from opensim_tpu_torch.engine import fastpath, prepcache
from opensim_tpu_torch.engine.schedconfig import SchedulerConfig
from opensim_tpu_torch.engine.simulator import AppResource, prepare, simulate
from opensim_tpu_torch.models import expand
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.models.objects import Pod
from opensim_tpu_torch.ops import fast_scan as fs
from opensim_tpu_torch.ops import kernels
from opensim_tpu_torch.server import rest

N_NODES, N_PODS = 24, 240


def _full_variants(cluster) -> set:
    prep = prepare(cluster, [], device="cpu")
    if prep is None:
        return set()
    fi, _ = fastpath.build_inputs(prep)
    return {fs.variant_name(fi), fs.variant_name(fi, explain=True), fs.variant_name(fi, count=True)}


@pytest.fixture(scope="module")
def snapshot():
    """The server plan's snapshot at small size: bench-0 ... bench-9 bound
    where the port placed them, owned by their ReplicaSets."""
    cluster = fx.synthetic_cluster(N_NODES)
    res = simulate(cluster, [AppResource("seed", fx.server_apps(N_PODS, 0, fx.SERVER_BOUND))], device="cpu")
    out = fx.synthetic_cluster(N_NODES)
    out.pods = [Pod.from_dict(fx.snapshot_pod(p)) for ns in res.node_status for p in ns.pods]
    return out


def _count_builds(monkeypatch) -> list:
    calls = []
    real = kernels.precompute_core_np
    monkeypatch.setattr(kernels, "precompute_core_np", lambda ec: calls.append(1) or real(ec))
    return calls


def test_a_full_key_hit_builds_no_kernel_inputs(snapshot, monkeypatch):
    server = rest.SimonServer(base_cluster=snapshot, device="cpu")
    body = fx.server_requests(N_NODES, N_PODS, 4)["deploy"]
    calls = _count_builds(monkeypatch)
    code, first = server.deploy_apps(json.loads(json.dumps(body)))
    assert code == 200 and len(calls) == 1
    code, again = server.deploy_apps(json.loads(json.dumps(body)))
    assert code == 200 and len(calls) == 1
    assert again == first


@pytest.mark.parametrize("case", ["plain", "entry", "node_mask", "config"])
def test_build_inputs_memo(case):
    """Kept only on a cache entry's Prepared, only for the whole node axis,
    one per config; what is kept equals a fresh build."""
    cluster, app, node_pad = fx.scan_case("scores")
    prep = prepare(cluster, [AppResource("a", app)], node_pad=node_pad, device="cpu")
    fresh, fresh_meta = fastpath.build_inputs(prep)
    if case != "plain":
        prepcache.CacheEntry("k", prep)
    nv = np.asarray(prep.ec_np.node_valid, dtype=bool) if case == "node_mask" else None
    cfg = SchedulerConfig(w_least=2.0) if case == "config" else None
    a, b = fastpath.build_inputs(prep, nv, cfg), fastpath.build_inputs(prep, nv, cfg)
    assert (a[0] is b[0]) == (case in ("entry", "config"))
    if case == "config":
        assert fastpath.build_inputs(prep)[0] is not a[0] and len(prep.inputs_memo) == 2
        return
    for name, t in fresh._asdict().items():
        got = getattr(a[0], name)
        if hasattr(t, "shape"):
            np.testing.assert_array_equal(got.numpy(), t.numpy(), err_msg=name)
        else:
            assert got == t, name
    np.testing.assert_array_equal(a[1]["static_fail"], fresh_meta["static_fail"])


@pytest.mark.parametrize("case", [name for name, _n, _pad in fx.SCAN_CASES])
def test_snapshot_variants_equal_a_full_prepare(case):
    cluster, app, _pad = fx.scan_case(case)
    snap = copy.copy(cluster)
    snap.pods = list(cluster.pods) + expand.generate_pods_from_resources(app, cluster.nodes)
    assert rest.snapshot_variants(snap) == _full_variants(snap)


def test_server_start_variants_read_one_pod_per_owner(snapshot):
    assert len(rest._template_pods(snapshot.pods)) == fx.SERVER_BOUND
    server = rest.SimonServer(base_cluster=snapshot, device="cpu")
    assert server.kernel_variants() == sorted(_full_variants(snapshot) | {"fast_scan", "fast_scan[explain]"})
