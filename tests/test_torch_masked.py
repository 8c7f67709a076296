"""The planner's arguments of the port's simulate() against the JAX
package's, on the CPU (plain versions): the masked re-simulation over a
prepared cluster with candidate nodes (against the JAX masked simulate()
and against a fresh prepare of the sub-cluster), the bind state's
snapshot and restore, the delta re-encode of new nodes against a fresh
prepare, and the preemption pass.
Every comparison is exact: placements by stream index, reason strings and
node annotations as strings, encoded arrays bit for bit."""

import copy
import dataclasses
import json
import re

import numpy as np
import pytest

from opensim_tpu.engine import prepcache as ref_prepcache
from opensim_tpu.engine import simulator as ref_sim
from opensim_tpu.models import expand as ref_expand
from opensim_tpu_torch.engine import fastpath, prepcache, simulator as sim
from opensim_tpu_torch.models import expand, fixtures as fx
from opensim_tpu_torch.models.objects import ObjectMeta, RawObject, ResourceTypes


def _reference_copy(rt):
    """The same objects in the JAX package's object model, rebuilt from
    their manifests: only plain dicts cross between the packages."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def _names(text: str) -> str:
    """Pod and new-node names without their process-global counters."""
    return re.sub(r"-[0-9a-f]{10}\b", "-#", re.sub(r"simon-[0-9a-f]{8}\b", "simon-#", text))


def _planner_cluster():
    """The cluster of tests/test_planner.py:184: four 8-core nodes in two
    zones under a DaemonSet, 120 one-core pods (so some fail until enough
    16-core candidates are added), and eight candidates."""
    cluster = ResourceTypes()
    for i in range(4):
        cluster.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi", "110",
                                               fx.with_labels({"topology.kubernetes.io/zone": f"z{i % 2}"})))
    cluster.daemon_sets.append(fx.make_fake_daemon_set("logger", "100m", "64Mi"))
    rt = ResourceTypes()
    rt.deployments.append(fx.make_fake_deployment("web", 120, "1", "2Gi"))
    candidates = expand.new_fake_nodes(fx.make_fake_node("tmpl", "16", "32Gi"), 8)
    return cluster, rt, candidates


def _with_nodes(cluster, nodes):
    out = copy.copy(cluster)
    out.nodes = list(cluster.nodes) + list(nodes)
    return out


def _ref_placements(prep_ref, unscheduled):
    """Stream index → node index of the JAX run (decode wrote node names
    into its prepared pods), -1 for its unscheduled pods."""
    names = list(prep_ref.meta.node_names)
    failed = {id(u.pod) for u in unscheduled}
    return np.array([-1 if id(p) in failed or not p.spec.node_name else names.index(p.spec.node_name)
                     for p in prep_ref.ordered], np.int32)


def _active(prep, mask):
    """The pods a masked run keeps: DaemonSet pods pinned to a masked-out
    node leave the stream."""
    pinned = prep.ds_target >= 0
    keep = np.ones(len(prep.ordered), bool)
    keep[pinned] = mask[prep.ds_target[pinned]]
    return keep


@pytest.mark.parametrize("k", [0, 3, 8])
def test_masked_simulate_matches_jax_masked_and_a_fresh_sub_cluster(k):
    """tests/test_planner.py:184 through the port: the prepared cluster
    with eight candidates, masked to the first k, against the JAX masked
    simulate() on the same prepared stream (placements by stream index,
    reasons in order, the report's nodes) and against a fresh prepare of
    the sub-cluster (the kept pods' placements in stream order, reasons,
    node annotations). Pods fail at k < 8, so the valid-node count in
    their reason is under test."""
    cluster, rt, candidates = _planner_cluster()
    full, sub = _with_nodes(cluster, candidates), _with_nodes(cluster, candidates[:k])
    apps = [sim.AppResource("web", rt)]
    prep = sim.prepare(full, apps, device="cpu")
    mask = np.zeros(len(prep.meta.node_names), bool)
    mask[: len(sub.nodes)] = True
    masked = sim.simulate(sub, apps, prep=prep, node_valid=mask)

    full_ref, sub_ref = _reference_copy(full), _reference_copy(sub)
    apps_ref = [ref_sim.AppResource("web", _reference_copy(rt))]
    prep_ref = ref_sim.prepare(full_ref, apps_ref)
    mask_ref = np.zeros(np.asarray(prep_ref.ec_np.node_valid).shape[0], bool)
    mask_ref[: len(sub.nodes)] = True
    want = ref_sim.simulate(sub_ref, apps_ref, prep=prep_ref, node_valid=mask_ref)
    keep = _active(prep, mask)
    np.testing.assert_array_equal(np.where(keep, masked.placements, -1),
                                  np.where(keep, _ref_placements(prep_ref, want.unscheduled_pods), -1))
    assert [u.reason for u in masked.unscheduled_pods] == [u.reason for u in want.unscheduled_pods]
    assert [ns.node.metadata.name for ns in masked.node_status] == [n.metadata.name for n in sub.nodes]

    fresh = sim.simulate(_with_nodes(cluster, candidates[:k]), apps, device="cpu")
    assert masked.placements[keep].tolist() == fresh.placements.tolist()
    assert [u.reason for u in masked.unscheduled_pods] == [u.reason for u in fresh.unscheduled_pods]
    assert [(ns.node.metadata.annotations, len(ns.pods)) for ns in masked.node_status] == \
           [(ns.node.metadata.annotations, len(ns.pods)) for ns in fresh.node_status]
    n_valid = 4 + k
    if k < 8:
        assert masked.unscheduled_pods and all(u.reason.startswith(f"0/{n_valid} nodes are available: ")
                                               for u in masked.unscheduled_pods)
    else:
        assert not masked.unscheduled_pods
    # no dropped DaemonSet pod lands in a bucket or among the unscheduled
    reported = {id(p) for ns in masked.node_status for p in ns.pods} | {id(u.pod) for u in masked.unscheduled_pods}
    assert reported == {id(p) for p, kept in zip(prep.ordered, keep) if kept}


def test_masked_inputs_follow_the_mask():
    """The three inputs a mask changes: the validity row, the spread
    weights (the sub-cluster's domain count) and the static first-fail
    counts, each equal to a fresh prepare of the sub-cluster's."""
    cluster, rt, candidates = _planner_cluster()
    apps = [sim.AppResource("web", rt)]
    prep = sim.prepare(_with_nodes(cluster, candidates), apps, device="cpu")
    fresh = sim.prepare(_with_nodes(cluster, candidates[:3]), apps, device="cpu")
    mask = np.arange(len(prep.meta.node_names)) < 7
    fi, meta = fastpath.build_inputs(prep, mask)
    fi_fresh, meta_fresh = fastpath.build_inputs(fresh)
    assert fi.node_valid.tolist() == mask.astype(np.float32).tolist()
    # per pod of the stream (the candidates' DaemonSet pods add templates)
    kept = prep.tmpl_ids[_active(prep, mask)]
    np.testing.assert_array_equal(fi.spr_weight.numpy()[kept], fi_fresh.spr_weight.numpy()[fresh.tmpl_ids])
    np.testing.assert_array_equal(meta["static_fail"][kept], meta_fresh["static_fail"][fresh.tmpl_ids])
    unmasked = fastpath.build_inputs(prep)
    assert not np.array_equal(fi.spr_weight.numpy(), unmasked[0].spr_weight.numpy())
    assert not np.array_equal(meta["static_fail"], unmasked[1]["static_fail"])


def test_bind_state_snapshot_restores_the_prepared_pods():
    """A simulation writes node names, phases and GPU annotations into the
    prepared pods; restore_bind_state undoes it, and a second simulation
    over the restored Prepared places the stream as the first did."""
    cluster, app = fx.gpu_cluster(6), fx.gpu_apps(60)
    cluster.pods.append(fx.make_fake_pod("stray", "1", "1Gi", fx.with_node_name("node-00001")))
    apps = [sim.AppResource("g", app)]
    prep = sim.prepare(cluster, apps, device="cpu")

    def state():
        return [(p.spec.node_name, p.phase, dict(p.metadata.annotations)) for p in prep.ordered]

    before = state()
    snap = sim.snapshot_bind_state(prep)
    first = sim.simulate(cluster, apps, prep=prep)
    assert state() != before
    sim.restore_bind_state(prep, snap)
    assert state() == before
    second = sim.simulate(cluster, apps, prep=prep)
    np.testing.assert_array_equal(first.placements, second.placements)
    sim.restore_bind_state(prep, snap)
    assert state() == before
    ref_snap = ref_sim.snapshot_bind_state(prep)  # the JAX package's capture of the same pods
    assert snap == ref_snap


@pytest.mark.parametrize("with_ds", [False, True])
def test_extend_with_nodes_matches_a_fresh_prepare(with_ds):
    """The delta re-encode of candidate nodes gives the stream a fresh
    prepare of the whole cluster gives (pod by pod: workload, pinned node,
    template rows), the same node axis bit for bit, and the same
    placements; so does the JAX package's delta on the same objects."""
    cluster = fx.synthetic_cluster(6)
    cluster.pods.append(fx.make_fake_pod("stray", "1", "1Gi", fx.with_node_name("node-00002")))
    if with_ds:
        cluster.daemon_sets.append(fx.make_fake_daemon_set("logger", "100m", "64Mi"))
        cluster.daemon_sets.append(fx.make_fake_daemon_set("agent", "200m", "128Mi"))
    apps = [sim.AppResource("plan", fx.synthetic_apps(60))]
    template = fx.make_fake_node("tpl", "32", "128Gi", "110",
                                 fx.with_labels({"topology.kubernetes.io/zone": "zone-9", "disk": "ssd"}))
    candidates = expand.new_fake_nodes(template, 4)
    full = _with_nodes(cluster, candidates)
    base = sim.prepare(cluster, apps, device="cpu")
    ext = prepcache.extend_with_nodes(base, candidates, cluster, apps)
    fresh = sim.prepare(full, apps, device="cpu")
    assert ext is not None and ext.n_cluster == fresh.n_cluster and ext.ds_group_sizes == fresh.ds_group_sizes

    def stream(prep):
        ec = prep.ec_np
        return [(_names(p.metadata.annotations.get("simon/workload-name", "")), sim.pinned_node_name(p), p.spec.node_name,
                 ec.req[u].tolist(), ec.spr_topo[u].tolist(), bool(f))
                for p, u, f in zip(prep.ordered, prep.tmpl_ids, prep.forced)]

    assert stream(ext) == stream(fresh)
    np.testing.assert_array_equal(ext.ds_target, fresh.ds_target)
    assert ext.meta.node_names == fresh.meta.node_names
    for name in ("node_valid", "alloc", "label_val", "node_domain", "taint_key", "node_gpu_mem", "node_vg_cap"):
        np.testing.assert_array_equal(getattr(ext.ec_np, name), getattr(fresh.ec_np, name), err_msg=name)
    for name in ("used", "gpu_free", "vg_free", "dev_free"):
        np.testing.assert_array_equal(getattr(ext.st0_np, name), getattr(fresh.st0_np, name), err_msg=name)
    r_ext = sim.simulate(full, apps, prep=ext)
    r_fresh = sim.simulate(full, apps, prep=fresh)
    np.testing.assert_array_equal(r_ext.placements, r_fresh.placements)
    np.testing.assert_array_equal(r_ext.used, r_fresh.used)

    c_ref = _reference_copy(cluster)
    apps_ref = [ref_sim.AppResource("plan", _reference_copy(apps[0].resources))]
    cand_ref = _reference_copy(ResourceTypes(nodes=candidates)).nodes
    ext_ref = ref_prepcache.extend_with_nodes(ref_sim.prepare(c_ref, apps_ref), cand_ref, c_ref, apps_ref)
    assert list(ext_ref.ds_target) == ext.ds_target.tolist()
    np.testing.assert_array_equal(np.asarray(ext_ref.tmpl_ids), ext.tmpl_ids)


def test_extend_with_nodes_declines_greed_and_app_daemonsets():
    cluster = fx.synthetic_cluster(4)
    apps = [sim.AppResource("plan", fx.synthetic_apps(20))]
    base = sim.prepare(cluster, apps, device="cpu")
    new = expand.new_fake_nodes(fx.make_fake_node("tpl", "8", "16Gi"), 2)
    assert prepcache.extend_with_nodes(base, new, cluster, apps, use_greed=True) is None
    ds_app = ResourceTypes()
    ds_app.daemon_sets.append(fx.make_fake_daemon_set("agent", "50m", "64Mi"))
    assert prepcache.extend_with_nodes(base, new, cluster, [sim.AppResource("d", ds_app)]) is None


# -- preemption: the simulate(enable_preemption=True) cases of tests/test_preemption.py


def _nodes(n=2, cpu="4", mem="8Gi", *options):
    rt = ResourceTypes()
    rt.nodes.extend(fx.make_fake_node(f"n{i}", cpu, mem, "110", *options) for i in range(n))
    return rt


def _pods(*pods):
    rt = ResourceTypes()
    rt.pods.extend(pods)
    return rt


def _pdb(name, match_labels, min_available):
    raw = {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
           "metadata": {"name": name, "namespace": "default"},
           "spec": {"selector": {"matchLabels": match_labels}, "minAvailable": min_available}}
    return RawObject(kind="PodDisruptionBudget", metadata=ObjectMeta(name=name, namespace="default"), raw=raw)


def _lvm(size):
    return fx.with_pod_local_storage(json.dumps(
        {"volumes": [{"size": str(size), "kind": "LVM", "scName": "open-local-lvm"}]}))


_GIB = 1024 ** 3
_ANTI_RED = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
    "labelSelector": {"matchLabels": {"team": "red"}}, "topologyKey": "kubernetes.io/hostname"}]}}
_AFF_DB = {"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
    "labelSelector": {"matchLabels": {"role": "db"}}, "topologyKey": "kubernetes.io/hostname"}]}}
_PREF_WEB = {"podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [{
    "weight": 10, "podAffinityTerm": {"labelSelector": {"matchLabels": {"app": "web"}},
                                      "topologyKey": "kubernetes.io/hostname"}}]}}


def _preemption_case(name):
    """(cluster, [(app name, resources)]) of the tests/test_preemption.py
    case of that name, built with the port's fixtures."""
    p, prio = fx.make_fake_pod, fx.with_priority
    if name == "eviction":  # test_high_priority_pod_lands_via_eviction
        return _nodes(1), [("a", _pods(p("low-a", "2", "2Gi", prio(10)), p("low-b", "2", "2Gi", prio(20)),
                                       p("vip", "2", "2Gi", prio(1000))))]
    if name == "equals":  # test_preemption_respects_priority_order_and_caps
        return _nodes(1), [("a", _pods(p("peer-a", "3", "2Gi", prio(50)), p("peer-b", "3", "2Gi", prio(50)),
                                       p("filler", "1", "2Gi", prio(5)), p("plain", "3", "2Gi")))]
    if name == "lowest_first":  # test_preemption_takes_lowest_priority_victims_first
        return _nodes(1, "6"), [("a", _pods(p("low-a", "2", "1Gi", prio(10)), p("low-b", "2", "1Gi", prio(20)),
                                            p("mid", "2", "1Gi", prio(50)), p("vip", "4", "2Gi", prio(100))))]
    if name == "forced":  # test_forced_pods_are_never_victims
        cluster = _nodes(1)
        cluster.pods.append(p("resident", "3", "4Gi", prio(1), fx.with_node_name("n0")))
        return cluster, [("a", _pods(p("vip", "3", "4Gi", prio(100))))]
    if name == "ports":  # test_port_holding_victim_frees_the_port
        return _nodes(1), [("a", _pods(p("holder", "1", "1Gi", prio(5), fx.with_host_ports([8080])),
                                       p("vip", "1", "1Gi", prio(500), fx.with_host_ports([8080]))))]
    if name == "gpu":  # test_gpu_victim_frees_devices_and_preemptor_gets_annotation
        cluster = ResourceTypes()
        cluster.nodes.append(fx.make_fake_node("g0", "8", "16Gi", "110", fx.with_allocatable(
            {"alibabacloud.com/gpu-mem": "16Gi", "alibabacloud.com/gpu-count": "2"})))
        req = fx.with_annotations({"alibabacloud.com/gpu-mem": "8Gi", "alibabacloud.com/gpu-count": "2"})
        return cluster, [("a", _pods(p("tenant", "1", "1Gi", prio(5), req), p("vip", "1", "1Gi", prio(500), req)))]
    if name == "storage":  # test_storage_preemptor_lands_on_storage_node
        cluster = ResourceTypes()
        cluster.nodes.append(fx.make_fake_node("s0", "4", "8Gi", "110", fx.with_node_local_storage(
            vgs=[{"name": "pool", "capacity": 100 * _GIB}])))
        return cluster, [("a", _pods(p("hog", "4", "2Gi", prio(5)),
                                     p("db", "2", "2Gi", prio(500), _lvm(10 * _GIB))))]
    if name == "cascade":  # test_cascading_replacement_rehomes_the_victim
        cluster = _nodes(1, "4", "8Gi", fx.with_labels({"disk": "ssd"}))
        cluster.nodes.append(fx.make_fake_node("n1", "4", "8Gi"))
        return cluster, [("a", _pods(p("tenant", "3", "2Gi", prio(5)),
                                     p("vip", "3", "2Gi", prio(500), fx.with_node_selector({"disk": "ssd"}))))]
    if name == "spread":  # test_spread_constrained_preemptor_still_preempts
        app = _pods(p("low", "3", "2Gi", prio(5)))
        app.deployments.append(fx.make_fake_deployment("vip", 1, "3", "2Gi", prio(500), fx.with_topology_spread([{
            "maxSkew": 1, "topologyKey": "kubernetes.io/hostname", "whenUnsatisfiable": "ScheduleAnyway",
            "labelSelector": {"matchLabels": {"app": "vip"}}}])))
        return _nodes(1), [("a", app)]
    if name == "cascade_anti":  # test_cascade_skips_anti_affinity_victims
        cluster = _nodes(1, "4", "8Gi", fx.with_labels({"disk": "ssd"}))
        cluster.nodes.append(fx.make_fake_node("n1", "4", "8Gi", "110", fx.with_labels({"disk": "hdd"})))
        anti_db = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"app": "db"}}, "topologyKey": "kubernetes.io/hostname"}]}}
        return cluster, [
            ("a", _pods(p("db", "1", "1Gi", fx.with_labels({"app": "db"}), fx.with_node_selector({"disk": "hdd"})),
                        p("tenant", "3", "2Gi", prio(5), fx.with_affinity(anti_db)))),
            ("b", _pods(p("vip", "3", "2Gi", prio(500), fx.with_node_selector({"disk": "ssd"})))),
        ]
    if name in ("pdb_saves", "pdb_exhausted", "pdb_ranking"):  # the three PDB cases
        if name == "pdb_saves":
            cluster = _nodes(1)
            cluster.pdbs.append(_pdb("guard", {"app": "protected"}, 1))
            pods = (p("protected", "2", "1Gi", prio(10), fx.with_labels({"app": "protected"})),
                    p("plain", "2", "1Gi", prio(10)), p("vip", "2", "1Gi", prio(1000)))
        elif name == "pdb_exhausted":
            cluster = _nodes(1)
            cluster.pdbs.append(_pdb("guard", {"app": "db"}, 2))
            pods = (p("db-0", "2", "1Gi", prio(10), fx.with_labels({"app": "db"})),
                    p("db-1", "2", "1Gi", prio(20), fx.with_labels({"app": "db"})), p("vip", "2", "1Gi", prio(1000)))
        else:
            cluster = _nodes(2)
            cluster.pdbs.append(_pdb("guard", {"app": "prot"}, 1))
            pods = (p("prot", "3", "1Gi", prio(5), fx.with_labels({"app": "prot"})),
                    p("plain", "3", "1Gi", prio(50)), p("vip", "3", "1Gi", prio(1000)))
        return cluster, [("a", _pods(*pods))]
    if name == "storage_victim":  # test_storage_holding_victim_released_exactly
        cluster = ResourceTypes()
        cluster.nodes.append(fx.make_fake_node("n0", "4", "8Gi", "110", fx.with_node_local_storage(
            vgs=[{"name": "pool0", "capacity": 100 * _GIB}],
            devices=[{"device": "/dev/vdb", "capacity": 50 * _GIB, "mediaType": "ssd"}])))
        return cluster, [("a", _pods(p("low", "1", "1Gi", prio(5), _lvm(90 * _GIB)),
                                     p("vip", "1", "1Gi", prio(1000), _lvm(80 * _GIB))))]
    if name == "anti_blocker":  # test_anti_affinity_preemptor_evicts_its_blocker
        return _nodes(1, "8"), [("a", _pods(p("blocker", "2", "2Gi", prio(10), fx.with_pod_labels({"team": "red"})),
                                            p("vip", "2", "2Gi", prio(1000), fx.with_affinity(_ANTI_RED))))]
    if name == "anchored":  # test_affinity_anchored_preemptor_rejected_like_kube
        return _nodes(1, "6"), [("a", _pods(p("anchor", "2", "2Gi", prio(10), fx.with_pod_labels({"role": "db"})),
                                            p("filler", "3", "2Gi", prio(10)),
                                            p("vip", "2", "2Gi", prio(1000), fx.with_affinity(_AFF_DB))))]
    if name == "hard_spread":  # test_hard_spread_preemptor_lands_post_eviction
        cluster = ResourceTypes()
        cluster.nodes.extend(fx.make_fake_node(f"n{i}", "4", "8Gi", "110",
                                               fx.with_labels({"topology.kubernetes.io/zone": f"z{i}"}))
                             for i in range(2))
        spread = fx.with_topology_spread([{"maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
                                           "whenUnsatisfiable": "DoNotSchedule",
                                           "labelSelector": {"matchLabels": {"app": "s"}}}])
        return cluster, [("a", _pods(p("filler", "4", "2Gi", prio(10)),
                                     p("spread-a", "1", "1Gi", prio(1000), fx.with_pod_labels({"app": "s"}), spread)))]
    if name == "selector_victim":  # test_selector_matched_victim_is_now_evictable
        return _nodes(1), [("a", _pods(p("anchored", "3", "2Gi", prio(10), fx.with_pod_labels({"app": "web"}),
                                         fx.with_affinity(_PREF_WEB)), p("vip", "3", "2Gi", prio(1000))))]
    raise KeyError(name)


PREEMPTION_CASES = ("eviction", "equals", "lowest_first", "forced", "ports", "gpu", "storage", "cascade", "spread",
                    "cascade_anti", "pdb_saves", "pdb_exhausted", "pdb_ranking", "storage_victim", "anti_blocker",
                    "anchored", "hard_spread", "selector_victim")


def _outcome(res):
    """Each node's pods in bucket (stream) order with their GPU devices, its
    annotations, and the unscheduled pods with their reasons, names without
    counters."""
    nodes = [(ns.node.metadata.name, ns.node.metadata.annotations,
              [(_names(q.metadata.name), q.metadata.annotations.get("simon/gpu-index")) for q in ns.pods])
             for ns in res.node_status]
    for _name, anno, _pods_ in nodes:
        anno.pop("simon/node-gpu-share", None)  # pod names inside; compared through the buckets
    return nodes, [(_names(u.pod.metadata.name), _names(u.reason)) for u in res.unscheduled_pods]


@pytest.mark.parametrize("case", PREEMPTION_CASES)
def test_preemption_matches_jax(case):
    """simulate(enable_preemption=True) against the JAX package's on the
    tests/test_preemption.py cases: each node's pods in order, the
    unscheduled pods and their reasons (victims name their preemptor)."""
    cluster, apps = _preemption_case(case)
    res = sim.simulate(cluster, [sim.AppResource(n, a) for n, a in apps], enable_preemption=True, device="cpu")
    ref_cluster, ref_apps = _preemption_case(case)
    want = ref_sim.simulate(_reference_copy(ref_cluster),
                            [ref_sim.AppResource(n, _reference_copy(a)) for n, a in ref_apps],
                            enable_preemption=True)
    assert _outcome(res) == _outcome(want)
    placed = {q.metadata.name for ns in res.node_status for q in ns.pods}
    assert ("vip" in placed) == (case in ("eviction", "lowest_first", "ports", "gpu", "cascade", "cascade_anti",
                                          "pdb_saves", "pdb_exhausted", "pdb_ranking", "storage_victim",
                                          "anti_blocker", "selector_victim"))
    with pytest.raises(ValueError, match="prep reuse does not support enable_preemption"):
        sim.simulate(cluster, [], prep=object(), enable_preemption=True)


@pytest.mark.parametrize("arg", ["sched_config", "extra_plugins", "tie_seed", "explain"])
def test_later_slice_arguments_raise(arg):
    value = {"sched_config": object(), "extra_plugins": (("filter", len),), "tie_seed": 0, "explain": True}[arg]
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        sim.simulate(fx.synthetic_cluster(2), [], device="cpu", **{arg: value})
