"""Slice parity: the port's simulate() against the JAX package's on small
plans, placements compared by stream index, node annotations by content,
an unscheduled pod's reason string, plus the ways the slice refuses to run
(outside the envelope, no card and no explicit device)."""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from opensim_tpu.engine import simulator as ref_sim
from opensim_tpu.models import expand as ref_expand
from opensim_tpu_torch.engine import fastpath, simulator as sim
from opensim_tpu_torch.models import expand, fixtures as fx
from opensim_tpu_torch.models.objects import ANNO_GPU_INDEX, ANNO_NODE_GPU_SHARE, ANNO_NODE_LOCAL_STORAGE


def _plan(n_nodes=32, n_pods=256):
    return fx.synthetic_cluster(n_nodes), fx.synthetic_apps(n_pods)


def _reference_copy(rt):
    """The same objects in the JAX package's object model, rebuilt from
    their manifests: only plain dicts cross between the packages."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def test_simulate_matches_reference_on_a_small_plan():
    c, a = _plan()
    c_ref, a_ref = _reference_copy(c), _reference_copy(a)
    ref_apps = [ref_sim.AppResource("plan", a_ref)]
    prep = ref_sim.prepare(c_ref, ref_apps)
    ref_res = ref_sim.simulate(c_ref, ref_apps, prep=prep)
    assert not ref_res.unscheduled_pods
    names = list(prep.meta.node_names)
    want = np.array([names.index(p.spec.node_name) for p in prep.ordered], np.int32)
    # per-node usage the reference's binds add up to, in stream order
    ec = prep.ec_np
    want_used = np.array(np.asarray(prep.st0.used), copy=True)
    np.add.at(want_used, want, np.asarray(ec.req)[prep.tmpl_ids])
    want_used = want_used[: len(c.nodes)]  # the reference pads the node axis to 128

    res = sim.simulate(c, [sim.AppResource("plan", a)], device="cpu")
    np.testing.assert_array_equal(res.placements, want)
    np.testing.assert_allclose(res.used, want_used, rtol=0, atol=0)
    assert not res.unscheduled_pods
    assert sum(len(ns.pods) for ns in res.node_status) == len(want) == 20 * (256 // 20)
    ref_counts = [len(ns.pods) for ns in ref_res.node_status]
    assert [len(ns.pods) for ns in res.node_status] == ref_counts
    assert [ns.node.metadata.name for ns in res.node_status] == [n.metadata.name for n in c.nodes]
    for ns in res.node_status:
        assert all(p.spec.node_name == ns.node.metadata.name and p.phase == "Running" for p in ns.pods)
    assert set(res.timings) == {"prepare", "inputs", "kernel", "decode"}


def test_simulate_raises_outside_the_envelope():
    cluster = fx.synthetic_cluster(4)
    app = expand.ResourceTypes()
    keys = ["topology.kubernetes.io/zone", "topology.kubernetes.io/region", "topology.rack", "topology.row",
            "topology.cell"]
    app.pods.append(fx.make_fake_pod("p", "1", "1Gi", fx.with_topology_spread([
        {"maxSkew": 1, "topologyKey": k, "whenUnsatisfiable": "ScheduleAnyway",
         "labelSelector": {"matchLabels": {"x": "y"}}} for k in keys])))
    with pytest.raises(NotImplementedError, match="5 non-hostname topology keys"):
        sim.simulate(cluster, [sim.AppResource("k", app)], device="cpu")


def _storage_view(node_status):
    """Node name → its simon/node-local-storage JSON, parsed."""
    return {ns.node.metadata.name: json.loads(ns.node.metadata.annotations[ANNO_NODE_LOCAL_STORAGE])
            for ns in node_status if ANNO_NODE_LOCAL_STORAGE in ns.node.metadata.annotations}


@pytest.mark.parametrize("plan", ["local_pv", "local"])
def test_simulate_matches_reference_on_local_storage(plan):
    """Open-Local pods (LVM volumes; exclusive SSD and HDD devices): the
    all-local-PV plan at 40 nodes, and the JAX package's local fixture."""
    def make():
        if plan == "local_pv":
            return fx.local_pv_cluster(40), fx.local_pv_apps(400)
        return fx.scan_case("local")[:2]

    c, a = make()
    c_ref, a_ref = _reference_copy(c), _reference_copy(a)
    ref_apps = [ref_sim.AppResource("l", a_ref)]
    prep_ref = ref_sim.prepare(c_ref, ref_apps)
    ref_res = ref_sim.simulate(c_ref, ref_apps, prep=prep_ref)
    res = sim.simulate(c, [sim.AppResource("l", a)], device="cpu")
    assert not ref_res.unscheduled_pods and not res.unscheduled_pods
    names = list(prep_ref.meta.node_names)
    want = np.array([names.index(p.spec.node_name) for p in prep_ref.ordered], np.int32)
    np.testing.assert_array_equal(res.placements, want)
    ours, theirs = _storage_view(res.node_status), _storage_view(ref_res.node_status)
    assert ours == theirs and len(ours) == len(c.nodes)
    requested = sum(vg["requested"] for node in ours.values() for vg in node["vgs"])
    taken = sum(d["isAllocated"] for node in ours.values() for d in node["devices"])
    assert requested > 0 and taken > 0
    assert res.vg_free.shape == prep_ref.meta.node_vg_cap[: len(c.nodes)].shape


def _gpu_view(placements, node_names, node_status):
    """Stream index → (node, gpu-index annotation), and node → its
    gpu-share JSON with pod names replaced by stream indices (names embed a
    process-global counter). A node's pods are its bucket in stream order."""
    pods, names, nodes = {}, {}, {}
    for ns in node_status:
        idx = np.flatnonzero(placements == node_names.index(ns.node.metadata.name)).tolist()
        assert len(idx) == len(ns.pods)
        for i, p in zip(idx, ns.pods):
            names[p.metadata.name] = i
            pods[i] = (ns.node.metadata.name, p.metadata.annotations.get(ANNO_GPU_INDEX))
    for ns in node_status:
        share = json.loads(ns.node.metadata.annotations[ANNO_NODE_GPU_SHARE])
        for dev in share["DevsBrief"].values():
            dev["PodList"] = [names[n] for n in dev["PodList"]]
        nodes[ns.node.metadata.name] = share
    return pods, nodes


def test_simulate_matches_reference_on_gpushare_example():
    def load(pkg):
        cluster = pkg.load_cluster_from_dir("example/cluster/gpushare")
        app, _ = pkg.resources_from_dicts(pkg.load_yaml_objects("example/application/gpushare"))
        return cluster, app

    c_ref, a_ref = load(ref_expand)
    ref_apps = [ref_sim.AppResource("g", a_ref)]
    prep_ref = ref_sim.prepare(c_ref, ref_apps)
    ref_res = ref_sim.simulate(c_ref, ref_apps, prep=prep_ref)
    c, a = load(expand)
    res = sim.simulate(c, [sim.AppResource("g", a)], device="cpu")
    assert not ref_res.unscheduled_pods and not res.unscheduled_pods
    names = list(prep_ref.meta.node_names)
    want = np.array([names.index(p.spec.node_name) for p in prep_ref.ordered], np.int32)
    np.testing.assert_array_equal(res.placements, want)
    ours = _gpu_view(res.placements, names, res.node_status)
    assert ours == _gpu_view(want, names, ref_res.node_status)
    gpu_index = [v[1] for v in ours[0].values()]
    assert len(gpu_index) == 7 and all(gpu_index)  # every pod took a GPU
    assert any("-" in g for g in gpu_index)  # one across two GPUs
    assert res.gpu_take.shape == (7, 4) and res.gpu_free.shape == (len(names), 4)


def test_simulate_matches_reference_on_mixed_example():
    """Host ports, required and preferred inter-pod terms and hard and soft
    spread together (example/cluster/demo + example/application/mixed)."""
    def load(pkg):
        cluster = pkg.load_cluster_from_dir("example/cluster/demo")
        app, _ = pkg.resources_from_dicts(pkg.load_yaml_objects("example/application/mixed"))
        return cluster, app

    c_ref, a_ref = load(ref_expand)
    ref_apps = [ref_sim.AppResource("m", a_ref)]
    prep_ref = ref_sim.prepare(c_ref, ref_apps)
    ref_res = ref_sim.simulate(c_ref, ref_apps, prep=prep_ref)
    c, a = load(expand)
    prep = sim.prepare(c, [sim.AppResource("m", a)], device="cpu")
    f = prep.features
    assert f.ports and f.interpod and f.prefg and f.spread_hard and f.spread_soft
    assert fastpath.why_not(prep) is None
    res = sim.simulate(c, [sim.AppResource("m", a)], device="cpu")
    assert not ref_res.unscheduled_pods and not res.unscheduled_pods
    names = list(prep_ref.meta.node_names)
    want = np.array([names.index(p.spec.node_name) for p in prep_ref.ordered], np.int32)
    np.testing.assert_array_equal(res.placements, want)
    assert len(want) == 19 and [len(ns.pods) for ns in res.node_status] == [len(ns.pods) for ns in ref_res.node_status]


def test_why_not_refuses_inter_pod_weights_past_exact_floats(monkeypatch):
    c, a = fx.synthetic_cluster(8), fx.affinity_apps(40)
    prep = sim.prepare(c, [sim.AppResource("aff", a)], device="cpu")
    bound = fastpath.interpod_weight_bound(prep.ec_np, prep.tmpl_ids)
    # 40 pods × weight 100 under a preferred term; 20 pods carry 100, 20 carry 1
    assert bound == 40 * 100 + 20 * 100 + 20 * 1
    assert fastpath.why_not(prep) is None
    monkeypatch.setattr(fastpath, "EXACT_INT", bound)
    assert "2^24" in fastpath.why_not(prep)


def test_simulate_raises_on_an_unscheduled_pod():
    """The slice once raised on a pod that ends unscheduled; now such a pod
    is reported with the reference's reason string, as the JAX simulate()
    gives it, and lands in no node's bucket."""
    def make():
        cluster = fx.synthetic_cluster(4)
        app = expand.ResourceTypes()
        app.deployments.append(fx.make_fake_deployment("huge", 2, "100", "1Gi"))
        return cluster, app

    c, a = make()
    res = sim.simulate(c, [sim.AppResource("h", a)], device="cpu")
    c_ref, a_ref = (_reference_copy(x) for x in make())
    ref_res = ref_sim.simulate(c_ref, [ref_sim.AppResource("h", a_ref)])
    want = ["0/4 nodes are available: 4 Insufficient cpu."] * 2
    assert [u.reason for u in res.unscheduled_pods] == [u.reason for u in ref_res.unscheduled_pods] == want
    assert (res.placements == -1).all() and not any(ns.pods for ns in res.node_status)


def test_simulate_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c, a = _plan(4, 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.simulate(c, [sim.AppResource("plan", a)])


def test_simulate_with_no_pods_reports_empty_nodes():
    c, _ = _plan(4, 20)
    res = sim.simulate(c, [], device="cpu")
    assert [len(ns.pods) for ns in res.node_status] == [0, 0, 0, 0]


def test_why_not_takes_a_thousand_templates():
    cluster = fx.synthetic_cluster(1100)
    prep = sim.prepare(cluster, [sim.AppResource("t", fx.bigu_apps(1000))], device="cpu")
    U, N = prep.ec_np.req.shape[0], len(cluster.nodes)
    assert U >= 1000 and 3 * U * N * 4 > 4 * 1024 * 1024  # past the TPU kernel's resident-table cap
    assert fastpath.why_not(prep) is None


def test_why_not_refuses_more_than_eight_gpus_per_node():
    cluster = expand.ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("big", "64", "256Gi", "110", fx.with_allocatable({
        "alibabacloud.com/gpu-mem": "144Gi", "alibabacloud.com/gpu-count": "9",
    })))
    app = expand.ResourceTypes()
    app.pods.append(fx.make_fake_pod("p", "1", "1Gi", fx.with_annotations({
        "alibabacloud.com/gpu-mem": "4Gi", "alibabacloud.com/gpu-count": "1",
    })))
    prep = sim.prepare(cluster, [sim.AppResource("g", app)], device="cpu")
    assert prep.features.gpu
    assert fastpath.why_not(prep) == "9 GPUs per node exceed the kernel's 8"
    with pytest.raises(NotImplementedError, match="9 GPUs per node"):
        sim.simulate(cluster, [sim.AppResource("g", app)], device="cpu")
