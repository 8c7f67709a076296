"""The port's incremental prepare (opensim_tpu_torch/engine/prepcache.py) on
the CPU against the JAX package's: each delta re-encode (apps appended,
nodes added, a scale request's drop mask) equals a fresh ``prepare`` of
the same cluster and apps — stream order, every encoded leaf array for
array at the same node padding, placements by stream index — and equals
the JAX package's delta on the same objects; the cache's hits, misses,
evictions and invalidations; the stale-fingerprint guard; a slice of the
fastpath fuzz corpus; ``simulate()``'s ``drop_pods``, ``deadline`` and
``patch_pods_fn`` arguments."""

import copy
import dataclasses
import random
import re
import threading

import numpy as np
import pytest

from opensim_tpu.engine import prepcache as ref_prepcache
from opensim_tpu.engine import simulator as ref_sim
from opensim_tpu.models import expand as ref_expand
from opensim_tpu.server.rest import _owned_by as ref_owned_by
from opensim_tpu_torch.engine import prepcache
from opensim_tpu_torch.engine import simulator as sim
from opensim_tpu_torch.models import expand, fixtures as fx
from opensim_tpu_torch.models.objects import OwnerReference, RawObject, ResourceTypes
from opensim_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from opensim_tpu_torch.server.rest import _owned_by
from opensim_tpu_torch.utils.trace import PREP_STATS

PAD = 128  # the JAX package's default node padding; the port's is 1


def _reference_copy(rt):
    """The same objects in the JAX package's object model, rebuilt from
    their manifests: only plain dicts cross between the packages."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def _port_copy(ref_rt):
    """A JAX-package ResourceTypes (the fuzz generators') as the port's."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(ref_rt) for o in getattr(ref_rt, f.name)]
    rt, skipped = expand.resources_from_dicts(docs)
    assert not skipped
    return rt


def _cluster(n_nodes=8, with_ds=False):
    """tests/test_prepcache.py's cluster: 16-core nodes in three zones, a
    disk label, a pinned bare pod, optionally a DaemonSet."""
    rt = ResourceTypes()
    for i in range(n_nodes):
        rt.nodes.append(fx.make_fake_node(
            f"n{i:03d}", "16", "64Gi", "110",
            fx.with_labels({"topology.kubernetes.io/zone": f"z{i % 3}", "disk": "ssd" if i % 2 else "hdd"})))
    if with_ds:
        rt.daemon_sets.append(fx.make_fake_daemon_set("logd", "100m", "128Mi"))
    rt.pods.append(fx.make_fake_pod("pinned", "100m", "128Mi", fx.with_node_name("n000")))
    return rt


def _app_rt():
    rt = ResourceTypes()
    rt.deployments.append(fx.make_fake_deployment("web", 10, "500m", "1Gi", fx.with_node_selector({"disk": "ssd"})))
    rt.deployments.append(fx.make_fake_deployment(
        "db", 4, "1", "2Gi",
        fx.with_topology_spread([{"maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
                                  "whenUnsatisfiable": "DoNotSchedule",
                                  "labelSelector": {"matchLabels": {"app": "db"}}}])))
    return rt


def _apps():
    return [sim.AppResource("a", _app_rt())]


def _ref_apps(apps):
    return [ref_sim.AppResource(a.name, _reference_copy(a.resources)) for a in apps]


def _names(text: str) -> str:
    return re.sub(r"-[0-9a-f]{10}\b", "-#", re.sub(r"simon-[0-9a-f]{8}\b", "simon-#", text))


#: Per-template rows that hold no vocabulary, selector or domain ids.
_ROWS = ("req", "spr_skew", "spr_hard", "ports", "gpu_mem", "gpu_count", "lvm_req", "dev_req", "pin")
#: The node axis, every leaf but the domain ids.
_NODE_LEAVES = ("node_valid", "alloc", "unschedulable", "taint_key", "taint_val", "taint_effect", "label_val",
                "label_num", "node_gpu_mem", "node_vg_cap", "node_dev_cap", "node_dev_media")


def _stream(prep, keep=None):
    """Pod by pod: normalized name, node name, forced, pinned node, and its
    template's id-free rows."""
    ec = prep.ec_np
    return [(_names(p.metadata.name), p.spec.node_name, bool(f), int(t),
             [np.asarray(getattr(ec, r))[u].tolist() for r in _ROWS])
            for i, (p, u, f, t) in enumerate(zip(prep.ordered, prep.tmpl_ids, prep.forced, prep.ds_target))
            if keep is None or keep[i]]


def _same_as_fresh(delta, fresh, keep=None):
    """A delta against a fresh prepare of the same cluster and apps: the
    same stream pod by pod (`keep`: the delta's pods a drop mask keeps),
    the node axis leaf for leaf, the topology domains up to a one-to-one
    renumbering (a delta meets the apps' topology keys after the base's
    domains, where a fresh prepare interleaves them), the initial state,
    and the cluster's part of the stream."""
    assert _stream(delta, keep) == _stream(fresh)
    for name in _NODE_LEAVES:
        np.testing.assert_array_equal(getattr(delta.ec_np, name), getattr(fresh.ec_np, name), err_msg=name)
    da, db = np.asarray(delta.ec_np.node_domain), np.asarray(fresh.ec_np.node_domain)
    assert da.shape == db.shape
    pairs = set(zip(da.ravel().tolist(), db.ravel().tolist()))
    ids = dict(pairs)
    assert len(ids) == len(pairs) == len(set(ids.values())), "the domains are not a renumbering"
    ta, tb = np.asarray(delta.ec_np.domain_topo), np.asarray(fresh.ec_np.domain_topo)
    assert all(ta[x] == tb[y] for x, y in ids.items())
    for name, x, y in zip(delta.st0_np._fields, delta.st0_np, fresh.st0_np):
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert list(delta.meta.node_names) == list(fresh.meta.node_names)
    if keep is None:
        assert (delta.n_cluster, delta.n_bare, delta.ds_group_sizes) == (fresh.n_cluster, fresh.n_bare,
                                                                         fresh.ds_group_sizes)


def _same_leaves(a, b):
    """The port's delta against the JAX package's on the same objects: every
    encoded leaf, the initial state and the per-pod arrays, array for
    array."""
    for name, x, y in zip(a.ec_np._fields, a.ec_np, b.ec_np):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
    for name, x, y in zip(a.st0_np._fields, a.st0_np, b.st0):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
    np.testing.assert_array_equal(a.tmpl_ids, b.tmpl_ids)
    np.testing.assert_array_equal(a.forced, b.forced)
    np.testing.assert_array_equal(a.ds_target, np.asarray(b.ds_target))
    assert list(a.meta.node_names) == list(b.meta.node_names)


def _ref_placements(prep_ref, res):
    """Stream index → node index of a JAX run, from its node buckets (which
    hold the prepared pods themselves), -1 for a pod in none."""
    index = {name: i for i, name in enumerate(prep_ref.meta.node_names)}
    node_of = {id(p): index[ns.node.metadata.name] for ns in res.node_status for p in ns.pods}
    return np.array([node_of.get(id(p), -1) for p in prep_ref.ordered], np.int32)


# ---------------------------------------------------------------------------
# cache behaviour
# ---------------------------------------------------------------------------


def test_cache_hit_miss_eviction_invalidation_equals_jax():
    stats = []
    for mod in (prepcache, ref_prepcache):
        cache = mod.PrepareCache(capacity=2)
        got = [cache.get("a") is None]
        cache.put("a", mod.CacheEntry("a", None))
        cache.put("b", mod.CacheEntry("b", None))
        got.append(cache.get("a") is not None and cache.get("b") is not None)
        cache.put("c", mod.CacheEntry("c", None))  # evicts the LRU entry, "a"
        got += [cache.get("a") is None, cache.invalidate("b"), cache.get("b") is None, len(cache)]
        stats.append((got, cache.stats.as_dict()))
    assert stats[0] == stats[1]
    assert stats[0][1] == {"hits": 2, "misses": 3, "invalidations": 1, "evictions": 1}


def test_fingerprints_equal_jax_and_track_content():
    cluster, apps = _cluster(with_ds=True), _apps()
    fp = prepcache.fingerprint_cluster(cluster)
    assert fp == prepcache.fingerprint_cluster(cluster) == ref_prepcache.fingerprint_cluster(_reference_copy(cluster))
    assert prepcache.fingerprint_apps(apps) == ref_prepcache.fingerprint_apps(_ref_apps(apps))
    more_nodes = copy.copy(cluster)
    more_nodes.nodes = cluster.nodes + [fx.make_fake_node("extra", "8", "16Gi")]
    more_pods = copy.copy(cluster)
    more_pods.pods = cluster.pods + [fx.make_fake_pod("p2", "100m", "128Mi")]
    assert len({fp, prepcache.fingerprint_cluster(more_nodes), prepcache.fingerprint_cluster(more_pods)}) == 3


def test_simulate_cached_second_call_is_a_hit_equal_to_jax():
    cluster, apps = _cluster(), _apps()
    cache = prepcache.PrepareCache()
    first = prepcache.simulate_cached(cluster, apps, cache, device="cpu")
    PREP_STATS.reset()
    second = prepcache.simulate_cached(cluster, apps, cache, device="cpu")
    assert PREP_STATS.snapshot()["counts"] == {"hit": 1}
    assert cache.stats.hits == 1 and cache.stats.misses == 1
    np.testing.assert_array_equal(first.placements, second.placements)
    third = prepcache.simulate_cached(cluster, apps, cache, device="cpu")  # bind state restored between uses
    assert [u.reason for u in third.unscheduled_pods] == [u.reason for u in first.unscheduled_pods]
    ref_cache = ref_prepcache.PrepareCache()
    c_ref, a_ref = _reference_copy(cluster), _ref_apps(apps)
    ref_prepcache.simulate_cached(c_ref, a_ref, ref_cache, node_pad=1)
    ref_res = ref_prepcache.simulate_cached(c_ref, a_ref, ref_cache, node_pad=1)
    (entry,) = ref_cache.entries_snapshot()
    np.testing.assert_array_equal(second.placements, _ref_placements(entry.prep, ref_res))
    assert [u.reason for u in second.unscheduled_pods] == [u.reason for u in ref_res.unscheduled_pods]


# ---------------------------------------------------------------------------
# delta re-encode == fresh prepare == the JAX package's delta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_ds", [False, True])
def test_derive_with_apps_equals_fresh_prepare_and_jax(with_ds):
    cluster, apps = _cluster(with_ds=with_ds), _apps()
    fresh = sim.prepare(cluster, apps, node_pad=PAD, device="cpu")
    base = sim.prepare(cluster, [], node_pad=PAD, device="cpu")
    entry = prepcache.CacheEntry("base", base)
    derived = prepcache.derive_with_apps(base, cluster, apps, base_entry=entry)
    _same_as_fresh(derived, fresh)
    assert derived.ec.alloc is base.ec.alloc  # an unchanged leaf keeps its tensor
    r_delta = sim.simulate(cluster, apps, prep=derived)
    r_fresh = sim.simulate(cluster, apps, prep=fresh)
    np.testing.assert_array_equal(r_delta.placements, r_fresh.placements)

    c_ref, a_ref = _reference_copy(cluster), _ref_apps(apps)
    ref_base = ref_sim.prepare(c_ref, [])
    ref_derived = ref_prepcache.derive_with_apps(ref_base, c_ref, a_ref)
    _same_leaves(derived, ref_derived)
    ref_res = ref_sim.simulate(c_ref, a_ref, prep=ref_derived)
    np.testing.assert_array_equal(r_delta.placements, _ref_placements(ref_derived, ref_res))


def test_encoding_phases_pause_the_collector_and_restore_it(monkeypatch):
    """prepare, the delta re-encodes and the decode run with the cyclic
    collector paused, as the reference's prepare and decode do
    (opensim_tpu/utils/gcpause.py), and leave it on; an outer pause wins."""
    import gc

    from opensim_tpu_torch.utils.gcpause import gc_paused

    seen = []
    for mod, name in ((prepcache, "_expand_app"), (sim, "_prepare_inner"), (sim, "_decode")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real, _name=name, **k: (seen.append((_name, gc.isenabled())),
                                                                               _real(*a, **k))[1])
    cluster, apps = _cluster(), _apps()
    base = sim.prepare(cluster, [], device="cpu")
    derived = prepcache.derive_with_apps(base, cluster, apps)
    sim.simulate(cluster, apps, prep=derived)
    assert {name for name, _on in seen} == {"_expand_app", "_prepare_inner", "_decode"}
    assert not any(on for _name, on in seen) and gc.isenabled()
    gc.disable()
    try:
        with gc_paused():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


@pytest.mark.parametrize("with_ds", [False, True])
def test_extend_with_nodes_from_an_entry_equals_fresh_prepare_and_jax(with_ds):
    cluster, apps = _cluster(n_nodes=6, with_ds=with_ds), _apps()
    template = fx.make_fake_node("tpl", "32", "128Gi", "110",
                                 fx.with_labels({"topology.kubernetes.io/zone": "z9", "disk": "ssd"}))
    candidates = expand.new_fake_nodes(template, 4)
    full = copy.copy(cluster)
    full.nodes = list(cluster.nodes) + candidates
    base = sim.prepare(cluster, apps, node_pad=PAD, device="cpu")
    ext = prepcache.extend_with_nodes(base, candidates, cluster, apps, base_entry=prepcache.CacheEntry("b", base))
    fresh = sim.prepare(full, apps, node_pad=PAD, device="cpu")
    _same_as_fresh(ext, fresh)
    r_ext = sim.simulate(full, apps, prep=ext)
    np.testing.assert_array_equal(r_ext.placements, sim.simulate(full, apps, prep=fresh).placements)

    c_ref, a_ref = _reference_copy(cluster), _ref_apps(apps)
    cand_ref = _reference_copy(ResourceTypes(nodes=candidates)).nodes
    full_ref = copy.copy(c_ref)
    full_ref.nodes = list(c_ref.nodes) + cand_ref
    ref_ext = ref_prepcache.extend_with_nodes(ref_sim.prepare(c_ref, a_ref), cand_ref, c_ref, a_ref)
    ref_res = ref_sim.simulate(full_ref, a_ref, prep=ref_ext)
    np.testing.assert_array_equal(r_ext.placements, _ref_placements(ref_ext, ref_res))


def _with_owned_pod(cluster):
    """`cluster` plus a bare pod of Deployment `web`, bound to n001."""
    owned = fx.make_fake_pod("web-1", "500m", "1Gi", fx.with_node_name("n001"))
    owned.metadata.owner_references = [OwnerReference(kind="Deployment", name="web", uid="u1", controller=True)]
    owned.raw["metadata"]["ownerReferences"] = [r.to_dict() for r in owned.metadata.owner_references]
    cluster.pods.append(owned)
    return cluster


def test_drop_mask_equals_a_fresh_prepare_of_the_filtered_cluster():
    """scale-apps as a pod-validity flip: the scaled workload's bare pods
    masked out of a cached stream place the rest as a fresh prepare of the
    filtered cluster does, and answer as the JAX package's drop mask."""
    cluster, apps = _with_owned_pod(_cluster()), _apps()
    scaled = {("Deployment", "default", "web")}
    filtered = copy.copy(cluster)
    filtered.pods = [p for p in cluster.pods if not _owned_by(p, scaled)]
    fresh = sim.prepare(filtered, apps, node_pad=PAD, device="cpu")
    base = sim.prepare(cluster, [], node_pad=PAD, device="cpu")
    derived = prepcache.derive_with_apps(base, filtered, apps)
    drop = prepcache.drop_mask_for_scaled(derived, _owned_by, scaled)
    assert drop.sum() == 1 and drop[: derived.n_bare].sum() == 1
    _same_as_fresh(derived, fresh, keep=~drop)
    r_fresh = sim.simulate(filtered, apps, prep=fresh)
    r_masked = sim.simulate(filtered, apps, prep=derived, drop_pods=drop)
    np.testing.assert_array_equal(r_masked.placements[~drop], r_fresh.placements)
    assert r_masked.placements[drop].tolist() == [-1]
    assert [(ns.node.metadata.name, len(ns.pods)) for ns in r_masked.node_status] == \
        [(ns.node.metadata.name, len(ns.pods)) for ns in r_fresh.node_status]
    assert [u.reason for u in r_masked.unscheduled_pods] == [u.reason for u in r_fresh.unscheduled_pods]

    c_ref, a_ref = _reference_copy(cluster), _ref_apps(apps)
    f_ref = copy.copy(c_ref)
    f_ref.pods = [p for p in c_ref.pods if not ref_owned_by(p, scaled)]
    ref_derived = ref_prepcache.derive_with_apps(ref_sim.prepare(c_ref, []), f_ref, a_ref)
    ref_drop = ref_prepcache.drop_mask_for_scaled(ref_derived, ref_owned_by, scaled)
    np.testing.assert_array_equal(drop, ref_drop)
    ref_res = ref_sim.simulate(f_ref, a_ref, prep=ref_derived, drop_pods=ref_drop)
    np.testing.assert_array_equal(r_masked.placements[~drop], _ref_placements(ref_derived, ref_res)[~drop])


def test_drop_mask_helpers_equal_jax():
    rng = np.random.default_rng(7)
    for n_a, n_b, n in ((5, 8, 10), (12, 3, 10), (4, None, 9), (None, 6, 6), (None, None, 4)):
        a = None if n_a is None else rng.random(n_a) < 0.4
        b = None if n_b is None else rng.random(n_b) < 0.4
        got, want = prepcache.union_drop_masks(a, b, n), ref_prepcache.union_drop_masks(a, b, n)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
            assert len(got) == n
        for m in (a, b):
            got, want = prepcache.pad_drop_mask(m, n), ref_prepcache.pad_drop_mask(m, n)
            assert (got is None and want is None) or np.array_equal(got, want)


def test_drop_pods_needs_a_prepared_stream_of_its_length():
    cluster, apps = _cluster(), _apps()
    with pytest.raises(ValueError, match="pass prep="):
        sim.simulate(cluster, apps, device="cpu", drop_pods=np.zeros(3, bool))
    prep = sim.prepare(cluster, apps, device="cpu")
    with pytest.raises(ValueError, match="cover the prepared pod stream"):
        sim.simulate(cluster, apps, prep=prep, drop_pods=np.zeros(len(prep.ordered) + 1, bool))


@pytest.mark.parametrize("seed", [3, 7, 11, 19, 42])
def test_deltas_on_the_fuzz_corpus_equal_fresh_prepares_and_jax(seed):
    """tests/test_fastpath_fuzz.py's generators (every supported feature
    mixed) through both delta paths: each equals a fresh prepare and the
    JAX package's delta, placement by placement."""
    from test_fastpath_fuzz import random_app, random_cluster

    rng = random.Random(seed)
    c_ref = random_cluster(rng, rng.randrange(6, 12))
    a_ref = [ref_sim.AppResource("fuzz", random_app(rng, rng.randrange(2, 5)))]
    cluster, apps = _port_copy(c_ref), [sim.AppResource("fuzz", _port_copy(a_ref[0].resources))]
    # the generated clusters hold no pods: one bound pod gives the base a stream
    cluster.pods.append(fx.make_fake_pod("pinned", "100m", "128Mi", fx.with_node_name(cluster.nodes[0].metadata.name)))
    c_ref, a_ref = _reference_copy(cluster), _ref_apps(apps)  # the JAX side from the same manifests
    base = sim.prepare(cluster, [], node_pad=8, device="cpu")
    full = sim.prepare(cluster, apps, node_pad=8, device="cpu")
    derived = prepcache.derive_with_apps(base, cluster, apps)
    _same_as_fresh(derived, full)
    r_delta = sim.simulate(cluster, apps, prep=derived)
    np.testing.assert_array_equal(r_delta.placements, sim.simulate(cluster, apps, prep=full).placements)
    ref_derived = ref_prepcache.derive_with_apps(ref_sim.prepare(c_ref, [], node_pad=8), c_ref, a_ref)
    ref_res = ref_sim.simulate(c_ref, a_ref, prep=ref_derived)
    np.testing.assert_array_equal(r_delta.placements, _ref_placements(ref_derived, ref_res))

    template = fx.make_fake_node("tpl", "16", "64Gi", "110", fx.with_labels({"topology.kubernetes.io/zone": "z0"}))
    candidates = expand.new_fake_nodes(template, 3)
    full_cluster = copy.copy(cluster)
    full_cluster.nodes = list(cluster.nodes) + candidates
    base2 = sim.prepare(cluster, apps, node_pad=8, device="cpu")  # pods as prepared (`full`'s were bound)
    ext = prepcache.extend_with_nodes(base2, candidates, cluster, apps)
    fresh = sim.prepare(full_cluster, apps, node_pad=8, device="cpu")
    assert ext is not None
    _same_as_fresh(ext, fresh)
    np.testing.assert_array_equal(sim.simulate(full_cluster, apps, prep=ext).placements,
                                  sim.simulate(full_cluster, apps, prep=fresh).placements)


# ---------------------------------------------------------------------------
# the stale-fingerprint guard
# ---------------------------------------------------------------------------


def _cached_once(cluster, apps):
    cache = prepcache.PrepareCache()
    prepcache.simulate_cached(cluster, apps, cache, device="cpu")
    return cache


def test_touch_without_invalidate_raises_and_the_entry_is_evicted():
    cluster, apps = _cluster(), _apps()
    cache = _cached_once(cluster, apps)
    cluster.nodes[0].touch()  # in-place mutation marker, no invalidation
    with pytest.raises(prepcache.StaleFingerprintError, match="n000"):
        prepcache.simulate_cached(cluster, apps, cache, device="cpu")
    assert len(cache) == 0  # proven stale: evicted, so the same call rebuilds
    prepcache.simulate_cached(cluster, apps, cache, device="cpu")
    prepcache.simulate_cached(cluster, apps, cache, device="cpu")  # and hits cleanly
    assert cache.stats.hits == 2


def test_invalidate_by_object_prefix_and_app_objects():
    cluster, apps = _cluster(), _apps()
    cache = _cached_once(cluster, apps)
    stranger = fx.make_fake_node("stranger", "8", "16Gi")
    assert cache.invalidate(stranger) == 0  # identity-keyed: not watched
    node = cluster.nodes[0]
    node.unschedulable = True
    node.touch()
    assert cache.invalidate(node) == 1 and len(cache) == 0
    prepcache.simulate_cached(cluster, apps, cache, device="cpu")  # rebuilt with the new version
    dep = apps[0].resources.deployments[0]
    dep.replicas += 1
    dep.touch()
    assert cache.invalidate(dep) == 1
    pdb = RawObject.from_dict({"kind": "PodDisruptionBudget", "metadata": {"name": "pdb1"}})
    cluster.pdbs.append(pdb)
    cache = _cached_once(cluster, apps)
    pdb.touch()
    assert cache.invalidate(pdb) == 1  # the raw kinds are watched too
    cache.put("abc|1", prepcache.CacheEntry("abc|1", None))
    cache.put("abd|2", prepcache.CacheEntry("abd|2", None))
    assert cache.invalidate("abc") == 1 and cache.invalidate() == 1


def test_derived_entries_share_the_base_watch_list():
    cluster = _cluster()
    cache = prepcache.PrepareCache()
    base = cache.put("fp|base", prepcache.CacheEntry("fp|base", None, watch=prepcache.watch_snapshot(cluster, [])))
    derived = cache.put("fp|deploy|x", prepcache.CacheEntry("fp|deploy|x", None, base=base))
    assert derived.watched is base.watched and derived.lock is base.lock
    assert cache.invalidate(cluster.nodes[0]) == 2


def test_watch_snapshot_is_taken_before_the_build():
    cluster, apps = _cluster(), _apps()
    snap = prepcache.watch_snapshot(cluster, apps)
    cluster.nodes[0].touch()  # lands "during the build"
    with pytest.raises(prepcache.StaleFingerprintError):
        prepcache.CacheEntry("k", None, watch=snap).check_fresh()


def test_concurrent_calls_after_a_touch_fail_typed_then_recover():
    """A touch() landing while four threads call through one cache: each
    call fails with StaleFingerprintError or returns the pristine answer,
    and the next call rebuilds and answers as before."""
    cluster, apps = _cluster(), _apps()
    cache = prepcache.PrepareCache()
    baseline = prepcache.simulate_cached(cluster, apps, cache, device="cpu").placements
    cluster.nodes[0].touch()
    barrier = threading.Barrier(4)
    outcomes = [None] * 4

    def call(i):
        barrier.wait(timeout=30)
        try:
            outcomes[i] = ("ok", prepcache.simulate_cached(cluster, apps, cache, device="cpu").placements)
        except prepcache.StaleFingerprintError:
            outcomes[i] = ("stale", None)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert [k for k, _ in outcomes].count("stale") >= 1
    assert all(np.array_equal(p, baseline) for k, p in outcomes if k == "ok")
    np.testing.assert_array_equal(prepcache.simulate_cached(cluster, apps, cache, device="cpu").placements, baseline)


# ---------------------------------------------------------------------------
# simulate()'s server arguments
# ---------------------------------------------------------------------------


def test_deadline_raises_at_the_phase_boundaries():
    cluster, apps = _cluster(), _apps()
    clock = [0.0]
    expired = Deadline.after(1.0, clock=lambda: clock[0])
    clock[0] = 2.0
    with pytest.raises(DeadlineExceeded) as ei:
        sim.simulate(cluster, apps, device="cpu", deadline=expired)
    assert ei.value.phase == "prepare"
    prep = sim.prepare(cluster, apps, device="cpu")
    with pytest.raises(DeadlineExceeded) as ei:
        sim.simulate(cluster, apps, prep=prep, deadline=expired)
    assert ei.value.phase == "schedule"
    res = sim.simulate(cluster, apps, device="cpu", deadline=Deadline.after(3600.0))
    assert len(res.placements) == len(prep.ordered)


def test_patch_pods_fn_equals_jax():
    """WithPatchPodsFuncMap: a hook that edits one pod of a workload
    changes that pod's scheduling (the workload hint is bypassed for
    patched pods), as in the JAX package."""
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n1", "4", "8Gi"))
    app = ResourceTypes()
    app.deployments.append(fx.make_fake_deployment("w", 5, "1", "1Gi"))
    seen = []

    def patch(app_name, pods):
        seen.append(app_name)
        containers = copy.deepcopy(pods[3].spec.containers)
        containers[0].requests["cpu"] = 100.0
        pods[3].spec.containers = containers
        for p in pods:
            p.metadata.annotations["patched"] = "yes"

    res = sim.simulate(cluster, [sim.AppResource("a", app)], device="cpu", patch_pods_fn=patch)
    ref = ref_sim.simulate(_reference_copy(cluster), [ref_sim.AppResource("a", _reference_copy(app))],
                           patch_pods_fn=patch)
    assert seen == ["a", "a"]
    assert [u.reason for u in res.unscheduled_pods] == [u.reason for u in ref.unscheduled_pods] \
        == ["0/1 nodes are available: 1 Insufficient cpu."]
    assert sum(len(ns.pods) for ns in res.node_status) == 4
    assert all(p.metadata.annotations.get("patched") == "yes" for ns in res.node_status for p in ns.pods)
