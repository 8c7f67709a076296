"""Failure attribution: the port's plain bind scan counts, for each pod that
finds no node, the nodes each dynamic filter rejects first and the nodes
short of each resource, exactly as the JAX package's XLA scan does
(``kernels.pod_step``'s ``count_fails``) on the same prepared input; and
the port's ``simulate()`` reports the unscheduled pods with the JAX
``simulate()``'s reason strings. Counts are integers: compared exactly."""

import copy
import dataclasses
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from opensim_tpu.engine import reasons as ref_reasons, simulator as ref_sim
from opensim_tpu.engine.scheduler import pad_pod_stream, schedule_pods
from opensim_tpu.models import expand as ref_expand
from opensim_tpu.ops import kernels as ref_kernels
from opensim_tpu_torch.engine import fastpath, reasons, simulator as sim
from opensim_tpu_torch.models import expand, fixtures as fx
from opensim_tpu_torch.ops import fast_scan as fs, kernels

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_fast_scan import _port_prep, _ref_prep, _reference_inputs, _stream  # noqa: E402

CASES = [c[0] for c in fx.SCAN_CASES]
#: The filter each failure case puts first on some node of a failing pod.
DECIDES = {"fail_ports": kernels.F_PORTS, "fail_fit": kernels.F_FIT, "fail_spread": kernels.F_SPREAD,
           "fail_interpod": kernels.F_INTERPOD, "fail_gpu": kernels.F_GPU, "fail_local": kernels.F_LOCAL,
           "fail_mixed": kernels.F_FIT}


def _reference_copy(rt):
    """The same objects in the JAX package's object model, rebuilt from
    their manifests: only plain dicts cross between the packages."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def test_filter_ids_and_reason_codes_match_the_reference():
    names = [n for n in dir(ref_kernels) if re.fullmatch(r"F_[A-Z_]+|NUM_FILTERS", n)]
    assert len(names) == 12 and all(getattr(kernels, n) == getattr(ref_kernels, n) for n in names)
    assert fs.N_FAIL == kernels.NUM_FILTERS - kernels.F_PORTS == 7
    assert reasons.FILTER_MESSAGES == ref_reasons.FILTER_MESSAGES
    assert [(r.name, r.value, r.message) for r in reasons.Reason] == [
        (r.name, r.value, r.message) for r in ref_reasons.Reason]
    assert reasons.node_not_found("n9") == ref_reasons.node_not_found("n9") == 'node "n9" not found'


def test_count_slots_match_the_cuda_source():
    """The kernel's slot count, and its verdict bits in the order of
    attribution: the dynamic filters F_PORTS..F_LOCAL."""
    src = (pathlib.Path(fs.__file__).parent / "csrc" / "fast_scan.cu").read_text()
    assert int(re.search(r"#define N_FAIL (\d+)", src).group(1)) == fs.N_FAIL
    bits = re.search(r"enum \{ (V_\w+) = 0, ([^}]*)\};", src)
    order = [bits.group(1)] + [b.strip() for b in bits.group(2).split(",") if b.strip()]
    assert order == ["V_" + n for n in ("PORTS", "FIT", "SPREAD", "INTERPOD", "GPU", "LOCAL")]
    assert [getattr(kernels, "F" + v[1:]) - kernels.F_PORTS for v in order] == list(range(6))


@pytest.mark.parametrize("name", CASES)
def test_plain_counts_match_xla_scan(name):
    """Every pod's row, failing or not, forced or not, equals the XLA
    scan's on the same prepared input; failures in mid-stream with binds
    after them included."""
    ref = _ref_prep(name)
    P = len(ref.ordered)
    t, v, f = pad_pod_stream(ref.tmpl_ids, np.ones(P, bool), ref.forced)
    out = schedule_pods(ref.ec, ref.st0, t, v, f, features=ref.features)
    fi, _ = _reference_inputs(ref)
    got = fs.fast_scan_reference(fi, *_stream(ref))
    chosen = np.asarray(out.chosen)[:P]
    np.testing.assert_array_equal(got.chosen.numpy(), chosen)
    R = got.insufficient.shape[1]
    want_fc, want_in = np.asarray(out.fail_counts)[:P], np.asarray(out.insufficient)[:P]
    assert got.fail_counts.dtype == got.insufficient.dtype == torch.int32
    np.testing.assert_array_equal(got.fail_counts.numpy(), want_fc)
    np.testing.assert_array_equal(got.insufficient.numpy(), want_in[:, :R])
    assert not want_in[:, R:].any()
    failing = (chosen < 0) & ~ref.forced
    assert not got.fail_counts.numpy()[~failing].any() and not got.insufficient.numpy()[~failing].any()
    if name in DECIDES:
        assert failing.any() and (chosen[np.argmax(failing):] >= 0).any()  # binds follow a failure
        assert want_fc[failing][:, DECIDES[name] - kernels.F_PORTS].any()


def test_the_failure_cases_decide_the_order_of_attribution():
    """On the nodes where two filters fail, the earlier one takes the node,
    and only nodes that pass ports count as short of a resource."""
    rows = {}
    for name in ("fail_ports", "fail_fit", "fail_spread", "fail_interpod", "fail_gpu"):
        port = _port_prep(name)
        fi, _ = fastpath.build_inputs(port)
        out = fs.fast_scan_reference(fi, *_stream(port))
        failing = (out.chosen < 0).numpy() & ~port.forced
        rows[name] = [(c.tolist(), s.tolist()) for c, s in zip(out.fail_counts[failing], out.insufficient[failing])]
    # ports on n0 (short of cpu too), n1 and n3; fit on n2, the one node short of cpu
    assert rows["fail_ports"] == [([3, 1, 0, 0, 0, 0, 0], [1, 0, 0, 0])]
    # fit on n0 (cpu and memory, spread too) and n1 (cpu); spread on n2, n3
    assert rows["fail_fit"] == [([0, 2, 2, 0, 0, 0, 0], [2, 1, 0, 0])]
    assert rows["fail_spread"] == [([0, 0, 3, 1, 0, 0, 0], [0, 0, 0, 0])]
    assert rows["fail_interpod"] == [([0, 0, 0, 2, 1, 0, 0], [0] * 6)]
    # the gpu-share pod, then the whole-GPU pod short of the dynamic gpu-count
    share, whole = rows["fail_gpu"]
    assert share[0] == [0, 0, 0, 0, 2, 1, 0] and whole[0] == [0, 2, 0, 0, 0, 1, 0] and sum(whole[1]) == 2


def test_forced_and_invalid_pods_get_zero_rows():
    port = _port_prep("forced")
    fi, _ = fastpath.build_inputs(port)
    tmpl, valid, forced = _stream(port)
    out = fs.fast_scan_reference(fi, tmpl, valid, forced)
    lost = int(np.flatnonzero(port.forced & (out.chosen.numpy() < 0))[0])  # bound to a node that does not exist
    assert not out.fail_counts[lost].any() and not out.insufficient[lost].any()
    failing = (out.chosen < 0) & (forced == 0)
    assert out.fail_counts[failing].any()
    valid[failing.nonzero()[0]] = 0  # the first failing pod, now invalid, touches nothing and counts nothing
    first = int(failing.nonzero()[0])
    masked = fs.fast_scan_reference(fi, tmpl, valid, forced)
    assert masked.chosen[first] == -1 and not masked.fail_counts[first].any() and not masked.insufficient[first].any()


def test_work_counts_the_counting_pass():
    port = _port_prep("fail_mixed")
    fi, _ = fastpath.build_inputs(port)
    stream = _stream(port)
    chosen = fs.fast_scan_reference(fi, *stream).chosen
    w = fs.fast_scan_work(fi, *stream, chosen)
    steps = int(((chosen < 0) & (stream[2] == 0)).sum())
    R = fi.alloc_T.shape[0]
    assert w["count"]["steps"] == steps > 0 and w["count"]["bytes"] == steps * (fs.N_FAIL + R) * 4
    assert 0 < w["count"]["ops"] < w["ops"]


# --- reason strings through simulate() ---------------------------------------

def _unschedulable_reports_reason():
    """tests/test_simulate.py:241 of the JAX package."""
    cluster = expand.ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n1", "2", "4Gi"))
    app = expand.ResourceTypes()
    app.pods.append(fx.make_fake_pod("fat-pod", "16", "1Gi"))
    app.pods.append(fx.make_fake_pod("picky-pod", "100m", "128Mi", fx.with_node_selector({"disk": "ssd"})))
    return cluster, [("a", app)]


def _fastpath_failure_reasons():
    """tests/test_fastpath.py:505 of the JAX package: 12 × 3 cores on 4 ×
    8-core nodes, 4 fail on cpu."""
    cluster = expand.ResourceTypes()
    cluster.nodes.extend(fx.make_fake_node(f"n{i}", "8", "16Gi") for i in range(4))
    app = expand.ResourceTypes()
    app.deployments.append(fx.make_fake_deployment("web", 12, "3", "1Gi"))
    return cluster, [("a", app)]


def _run_cluster(n_nodes):
    """tests/test_native.py:60 of the JAX package: 8-core nodes in 3 zones."""
    cluster = expand.ResourceTypes()
    for i in range(n_nodes):
        cluster.nodes.append(fx.make_fake_node(f"n{i:03d}", "8", "16Gi", "110",
                                               fx.with_labels({"topology.kubernetes.io/zone": f"z{i % 3}"})))
    return cluster


def _native_long_run():
    """tests/test_native.py:72 of the JAX package: one workload far over
    capacity."""
    app = expand.ResourceTypes()
    app.deployments.append(fx.make_fake_deployment("big", 600, "500m", "1Gi"))
    return _run_cluster(24), [("a", app)]


def _native_fat_and_fine():
    """tests/test_native.py:187 of the JAX package: pods that fit nowhere,
    then pods that bind."""
    app = expand.ResourceTypes()
    app.deployments.append(fx.make_fake_deployment("fat", 4, "32", "64Gi"))
    app.deployments.append(fx.make_fake_deployment("fine", 6, "500m", "1Gi"))
    return _run_cluster(6), [("a", app)]


def _native_classes():
    """tests/test_native.py:1140 of the JAX package: host ports, gpu-share
    and local-PV workloads over capacity."""
    cluster = expand.ResourceTypes()
    for i in range(3):
        cluster.nodes.append(fx.make_fake_node(
            f"n{i:03d}", "16", "32Gi", "110",
            fx.with_allocatable({"alibabacloud.com/gpu-mem": "8Gi", "alibabacloud.com/gpu-count": "2"}),
            fx.with_node_local_storage(vgs=[{"name": "pool0", "capacity": 20 * 1024**3}])))
    app = expand.ResourceTypes()
    app.deployments.append(fx.make_fake_deployment("ports", 5, "100m", "128Mi", fx.with_host_ports([8080])))
    gpu = fx.make_fake_deployment("gpu", 6, "100m", "128Mi")
    fx._tmpl_annotate(gpu, {"alibabacloud.com/gpu-mem": "4Gi", "alibabacloud.com/gpu-count": "1"})
    app.deployments.append(gpu)
    loc = fx.make_fake_deployment("loc", 4, "100m", "128Mi")
    fx._tmpl_annotate(loc, {"simon/pod-local-storage": (
        '{"volumes": [{"size": "%d", "kind": "LVM", "scName": "open-local-lvm"}]}' % (15 * 1024**3))})
    app.deployments.append(loc)
    return cluster, [("a", app)]


def _forced_unknown_node():
    """A pod bound by nodeName to a node that does not exist."""
    cluster = expand.ResourceTypes()
    cluster.nodes.extend(fx.make_fake_node(f"n{i}", "8", "16Gi") for i in range(2))
    cluster.pods.append(fx.make_fake_pod("lost", "1", "1Gi", fx.with_node_name("gone")))
    app = expand.ResourceTypes()
    app.deployments.append(fx.make_fake_deployment("web", 3, "1", "1Gi"))
    return cluster, [("a", app)]


def _oversubscribed():
    """The over-subscribed capacity plan at 50 nodes: 10 forced pods on a
    missing node, hog pods failing on cpu, memory and node affinity, then
    500 pods that bind."""
    return fx.oversubscribed_cluster(50), fx.oversubscribed_apps(50, 500)


PLANS = {f.__name__.lstrip("_"): f for f in (
    _unschedulable_reports_reason, _fastpath_failure_reasons, _native_long_run, _native_fat_and_fine,
    _native_classes, _forced_unknown_node, _oversubscribed)}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_reason_strings_match_the_reference_simulate(plan):
    cluster, apps = PLANS[plan]()
    res = sim.simulate(cluster, [sim.AppResource(n, a) for n, a in apps], device="cpu")
    c_raw, apps_raw = PLANS[plan]()
    c_ref = _reference_copy(c_raw)
    ref_apps = [ref_sim.AppResource(n, _reference_copy(a)) for n, a in apps_raw]
    prep = ref_sim.prepare(c_ref, ref_apps)
    ref_res = ref_sim.simulate(c_ref, ref_apps, prep=prep)
    got = [u.reason for u in res.unscheduled_pods]
    assert got and got == [u.reason for u in ref_res.unscheduled_pods]
    # the same pods fail, by stream index (placements are compared by index)
    names = list(prep.meta.node_names)
    placed = {id(p) for ns in ref_res.node_status for p in ns.pods}
    want = np.array([names.index(p.spec.node_name) if id(p) in placed else -1 for p in prep.ordered])
    np.testing.assert_array_equal(res.placements, want)
    # decode files no unplaced pod under a node
    in_buckets = {id(p) for ns in res.node_status for p in ns.pods}
    assert len(in_buckets) == int((res.placements >= 0).sum())
    assert not in_buckets & {id(u.pod) for u in res.unscheduled_pods}


def test_oversubscribed_plan_reports_every_failure_and_places_the_rest():
    """At 50 nodes: 17 hdd nodes take one hog-hdd pod each (20 asked), 33
    ssd nodes one hog-any pod each (40 asked); the 10 strays name a missing
    node; all 500 plan pods bind after the failures. No unplaced pod lands
    in a node's bucket."""
    cluster, apps = fx.oversubscribed_cluster(50), fx.oversubscribed_apps(50, 500)
    res = sim.simulate(cluster, [sim.AppResource(n, a) for n, a in apps], device="cpu")
    reasons_seen = {}
    for u in res.unscheduled_pods:
        reasons_seen[u.reason] = reasons_seen.get(u.reason, 0) + 1
    assert reasons_seen == {
        'node "node-99999" not found': 10,
        "0/50 nodes are available: 17 Insufficient cpu, 17 Insufficient memory, "
        "33 node(s) didn't match Pod's node affinity.": 3,
        "0/50 nodes are available: 50 Insufficient cpu, 17 Insufficient memory.": 7,
    }
    placed = sum(len(ns.pods) for ns in res.node_status)
    assert placed == int((res.placements >= 0).sum()) == 17 + 33 + 500 == len(res.placements) - 20
    assert all(p.spec.node_name == ns.node.metadata.name for ns in res.node_status for p in ns.pods)
    stray = [u.pod for u in res.unscheduled_pods if u.pod.spec.node_name]
    assert len(stray) == 10 and all(p.spec.node_name == "node-99999" for p in stray)
    assert (res.placements[-500:] >= 0).all() and (res.placements[:10] == -1).all()
