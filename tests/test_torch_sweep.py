"""Scenario sweeps: the port's plain sweep against the JAX package's XLA
sweep (and, on one tiny case, its Pallas interpreter under vmap), and the
port's drain masks, plan_drains and sweep_counts against the JAX
package's. Unscheduled counts and placements must be identical; final
usage too (rtol=0, atol=0); VG usage, a float32 sum taken in another
order over other paddings, to rtol=1e-5 as the JAX package's sweep tests
hold it."""

import copy
import dataclasses
import json

import numpy as np
import pytest

from opensim_tpu.engine import fastpath as ref_fastpath
from opensim_tpu.engine import simulator as ref_sim
from opensim_tpu.models import expand as ref_expand
from opensim_tpu.parallel import scenarios as ref_scenarios
from opensim_tpu.planner import defrag as ref_defrag
from opensim_tpu_torch.engine import fastpath, simulator as sim
from opensim_tpu_torch.models import ResourceTypes
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.parallel import scenarios
from opensim_tpu_torch.planner import defrag


def _reference_copy(rt):
    """The same objects in the JAX package's object model, rebuilt from
    their manifests: only plain dicts cross between the packages."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def _setup(n_nodes=6, replicas=8):
    """tests/test_parallel.py:13-19 of the JAX package."""
    cluster = ResourceTypes()
    for i in range(n_nodes):
        cluster.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi"))
    app = ResourceTypes()
    app.deployments.append(fx.make_fake_deployment("web", replicas, "2", "2Gi"))
    return cluster, app


def _lvm(gib):
    return fx.with_pod_local_storage(json.dumps({"volumes": [
        {"size": str(gib * 1024**3), "kind": "LVM", "scName": "open-local-lvm"}]}))


def _local_with_bound_pods():
    """The ``local`` case with a pod bound by name to each node, asking
    40 GiB of LVM: draining a node releases its pod to the others."""
    cluster, app, _ = fx.scan_case("local")
    for j in range(len(cluster.nodes)):
        cluster.pods.append(fx.make_fake_pod(f"bound-{j}", "1", "2Gi", fx.with_node_name(f"s{j}"), _lvm(40)))
    return cluster, app


def _daemon_cluster():
    """Three nodes, a DaemonSet, pods bound by name (one to a node that does
    not exist) and a bare pod pinned by matchFields, which is no DaemonSet
    pod and must stay in every scenario."""
    cluster, app = _setup(n_nodes=3, replicas=4)
    cluster.daemon_sets.append(fx.make_fake_daemon_set("agent", "100m", "128Mi"))
    for j, node in enumerate(["n0", "n1", "n1", "gone"]):
        cluster.pods.append(fx.make_fake_pod(f"bound-{j}", "500m", "1Gi", fx.with_node_name(node)))
    cluster.pods.append(fx.make_fake_pod("pinned", "500m", "1Gi", fx.with_affinity({"nodeAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": {"nodeSelectorTerms": [{"matchFields": [
            {"key": "metadata.name", "operator": "In", "values": ["n2"]}]}]}}})))
    return cluster, app


def _preps(cluster, app):
    ref = ref_sim.prepare(_reference_copy(cluster), [ref_sim.AppResource("a", _reference_copy(app))], node_pad=1)
    port = sim.prepare(cluster, [sim.AppResource("a", app)], device="cpu")
    return ref, port


def _reference_drain_masks(ref, drained):
    """The JAX package's mask loop (opensim_tpu/planner/defrag.py:68-80)."""
    names = ref.meta.node_names
    S, N, P = len(drained), ref.ec.node_valid.shape[0], len(ref.ordered)
    node_valid = np.broadcast_to(np.asarray(ref.ec.node_valid), (S, N)).copy()
    pod_valid = np.ones((S, P), dtype=bool)
    forced = np.broadcast_to(ref.forced, (S, P)).copy()
    for s, d in enumerate(drained):
        node_valid[s, d] = False
        for p, pod in enumerate(ref.ordered):
            if ref.ds_target[p] == d:
                pod_valid[s, p] = False
            elif ref.forced[p] and pod.spec.node_name == names[d]:
                forced[s, p] = False
    return node_valid, pod_valid, forced


def _assert_sweeps_equal(got, want):
    unscheduled, used, chosen, vg_used = got
    np.testing.assert_array_equal(unscheduled, np.asarray(want[0]))
    np.testing.assert_array_equal(chosen, np.asarray(want[2]))
    np.testing.assert_allclose(used, np.asarray(want[1]), rtol=0, atol=0)
    np.testing.assert_allclose(vg_used, np.asarray(want[3]), rtol=1e-5)


def test_sweep_matches_xla_sweep_over_node_counts():
    ref, port = _preps(*_setup(n_nodes=6, replicas=16))
    N, P, S = len(port.meta.node_names), len(port.ordered), 6
    node_valid = np.arange(N)[None, :] <= np.arange(S)[:, None]  # scenario s enables s + 1 nodes
    pod_valid = np.ones((S, P), dtype=bool)
    forced = np.broadcast_to(port.forced, (S, P))
    want = ref_scenarios.sweep(ref.ec, ref.st0, ref.tmpl_ids, ref.forced, node_valid, pod_valid,
                               features=ref.features)
    got = fastpath.sweep(port, node_valid, pod_valid, forced)
    _assert_sweeps_equal(got, want)
    assert got[0].tolist() == [12, 8, 4, 0, 0, 0]


def test_sweep_matches_xla_sweep_with_local_storage_and_releases():
    ref, port = _preps(*_local_with_bound_pods())
    assert port.features.local and port.forced.sum() == 4
    drained = [0, 1, 2, 3]
    node_valid, pod_valid, forced = defrag.drain_masks(port, drained)
    assert (forced.sum(axis=1) == 3).all()  # each drain releases its node's pod
    want = ref_scenarios.sweep(ref.ec, ref.st0, ref.tmpl_ids, ref.forced, node_valid, pod_valid,
                               features=ref.features, forced_masks=forced)
    got = fastpath.sweep(port, node_valid, pod_valid, forced)
    _assert_sweeps_equal(got, want)
    released = np.flatnonzero(port.forced)
    chosen = got[2]
    assert all(chosen[s, released[s]] not in (-1, drained[s]) for s in range(4))  # placed elsewhere
    assert (got[3] > 0).all()


def test_sweep_matches_pallas_interpreter_on_a_tiny_case():
    ref, port = _preps(*_setup(n_nodes=6, replicas=8))
    P = len(port.ordered)
    node_valid, pod_valid, forced = defrag.drain_masks(port, [0, 2, 5])
    want = ref_fastpath.sweep(ref, node_valid, pod_valid, forced, interpret=True)
    _assert_sweeps_equal(fastpath.sweep(port, node_valid, pod_valid, forced), want)
    assert want[2].shape == (3, P)


@pytest.mark.parametrize("case", ["daemons", "local_bound"])
def test_drain_masks_match_the_reference_loop(case):
    make = _daemon_cluster if case == "daemons" else _local_with_bound_pods
    ref, port = _preps(*make())
    np.testing.assert_array_equal(port.ds_target, np.asarray(ref.ds_target))
    drained = list(range(len(port.meta.node_names)))
    got = defrag.drain_masks(port, drained)
    for g, w in zip(got, _reference_drain_masks(ref, drained)):
        np.testing.assert_array_equal(g, w)
    if case == "daemons":
        assert (port.ds_target >= 0).sum() == 3 and not got[1].all() and not got[2].all()
        pinned = [i for i, p in enumerate(port.ordered) if p.metadata.name == "pinned"]
        assert got[1][:, pinned].all()  # a bare pinned pod is no DaemonSet pod


@pytest.mark.parametrize("setup", ["light", "tight", "prebound", "daemons"])
def test_plan_drains_matches_reference(setup):
    if setup == "daemons":
        cluster, app = _daemon_cluster()
    else:
        cluster, app = _setup(n_nodes=3, replicas={"light": 3, "tight": 12, "prebound": 0}[setup])
        if setup == "prebound":
            cluster.pods.append(fx.make_fake_pod("pinned", "1", "1Gi", fx.with_node_name("n0")))
    want = ref_defrag.plan_drains(_reference_copy(cluster), [ref_sim.AppResource("a", _reference_copy(app))])
    got = defrag.plan_drains(cluster, [sim.AppResource("a", app)], device="cpu")
    assert [dataclasses.asdict(p) for p in got.plans] == [dataclasses.asdict(p) for p in want.plans]
    assert len(got.plans) == 3
    if setup == "tight":
        assert all(not p.feasible and p.unscheduled == 4 for p in got.plans)
    if setup in ("light", "prebound"):
        assert len(got.drainable()) == 3


def test_sweep_counts_matches_reference():
    cluster, app = _setup(n_nodes=6, replicas=14)
    cluster.daemon_sets.append(fx.make_fake_daemon_set("agent", "100m", "128Mi"))
    ref, port = _preps(cluster, app)
    want, want_nv = ref_scenarios.sweep_counts(ref, 2, [0, 1, 2, 4])
    got, got_nv = scenarios.sweep_counts(port, 2, [0, 1, 2, 4])
    np.testing.assert_array_equal(got_nv, want_nv)
    _assert_sweeps_equal(got, want)
    assert got.unscheduled.tolist()[0] > got.unscheduled.tolist()[-1]


def test_sweep_auto_refuses_what_a_later_slice_brings():
    port = _preps(*_setup(n_nodes=3, replicas=2))[1]
    nv, pv, fm = defrag.drain_masks(port, [0])
    with pytest.raises(NotImplementedError, match="scheduler config"):
        scenarios.sweep_auto(port, nv, pv, fm, config=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        scenarios.sweep_auto(port, nv, pv, fm, mesh=object())
    res = scenarios.sweep_auto(port, nv, pv)  # forced masks default to the stream's
    assert res.unscheduled.tolist() == [0] and res.chosen.shape == (1, 2)
    assert not (res.chosen == 0).any()
