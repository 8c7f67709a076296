"""The port's serving fleet (opensim_tpu_torch/server/fleet.py) on the CPU:
the cases of tests/test_fleet.py through the port's shared-memory twin
publication, with the attached placements and the published arrays held
against the JAX package's.

- seqlock: a reader attaching DURING generation swaps never observes a
  torn view (generation and payload always agree);
- lifecycle: close and a hard crash leave no ``/dev/shm`` segments, and an
  exiting READER never destroys the owner's live segments;
- parity: placements simulated through an attached publication equal the
  owner's own warm-base path and the JAX package's ``simulate()`` on the
  same cluster and apps, by stream index; the published arrays equal the
  JAX package's ``publication_parts``, leaf by leaf;
- delta: unchanged buffers keep their content-keyed segments across
  generations, and the reader reuses its attachments.
"""

import copy
import dataclasses
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from opensim_tpu.engine import prepcache as ref_prepcache
from opensim_tpu.engine import simulator as ref_sim
from opensim_tpu.models import expand as ref_expand
from opensim_tpu_torch.engine import prepcache
from opensim_tpu_torch.engine.simulator import AppResource, prepare, simulate
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.models.objects import ResourceTypes
from opensim_tpu_torch.server.fleet import (
    ControlBlock,
    FleetReader,
    FleetTwinClient,
    TornGeneration,
    TwinPublisher,
)
from opensim_tpu_torch.utils.procgroup import spawn_group, stop_group

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD = 128  # the JAX package's default node padding; the port's is 1


def _shm_names(token: str):
    try:
        return [f for f in os.listdir("/dev/shm") if token in f]
    except FileNotFoundError:  # pragma: no cover - non-linux
        pytest.skip("/dev/shm not available")


def _cluster(n_nodes: int = 6, with_pod: bool = True) -> ResourceTypes:
    rt = ResourceTypes()
    for i in range(n_nodes):
        rt.nodes.append(fx.make_fake_node(f"n{i:03d}", "16", "64Gi", "110",
                                          fx.with_labels({"topology.kubernetes.io/zone": f"z{i % 3}"})))
    if with_pod:
        rt.pods.append(fx.make_fake_pod("pinned", "100m", "128Mi", fx.with_node_name("n000")))
    return rt


def _reference_copy(rt):
    """The same objects in the JAX package's object model, rebuilt from
    their manifests."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def _base_entry(cluster: ResourceTypes, **kw) -> prepcache.CacheEntry:
    return prepcache.CacheEntry("t|base", prepare(cluster, [], device="cpu", **kw))


def _parts(entry):
    with entry.lock:
        entry.restore()
        return prepcache.publication_parts(entry)


def _apps(name: str = "app-x", replicas: int = 3, cpu: str = "500m"):
    rt = ResourceTypes()
    rt.add(fx.make_fake_deployment(name, replicas, cpu, "1Gi"))
    return [AppResource("deploy", rt)]


def _placements(res):
    return (sorted((ns.node.metadata.name, len(ns.pods)) for ns in res.node_status if ns.pods),
            sorted(u.reason for u in res.unscheduled_pods))


def _derive_and_simulate(entry, cluster, apps, mod=prepcache, sim_fn=simulate):
    """The server's delta rung: derive the apps from the base entry, apply
    its drop mask, simulate. Returns (result, derived prep)."""
    with entry.lock:
        entry.restore()
        derived = mod.derive_with_apps(entry.prep, cluster, apps, base_entry=entry)
        drop = mod.pad_drop_mask(entry.base_drop, len(derived.ordered))
        try:
            return sim_fn(cluster, apps, prep=derived, drop_pods=drop), derived
        finally:
            entry.restore()


def _ref_placements(prep_ref, res):
    """Stream index → node index of a JAX run, -1 for a pod in no node."""
    index = {name: i for i, name in enumerate(prep_ref.meta.node_names)}
    node_of = {id(p): index[ns.node.metadata.name] for ns in res.node_status for p in ns.pods}
    return np.array([node_of.get(id(p), -1) for p in prep_ref.ordered], np.int32)


def _jax_placements(cluster, apps, drop_first=False):
    """The JAX package's server rung on the same manifests: its base entry
    (the first stream pod deleted by a watch event when `drop_first`), the
    apps derived, simulate() — placements by stream index."""
    c_ref = _reference_copy(cluster)
    a_ref = [ref_sim.AppResource(a.name, _reference_copy(a.resources)) for a in apps]
    base = ref_prepcache.CacheEntry("t|base", ref_sim.prepare(c_ref, [], node_pad=1))
    if drop_first:
        drop = np.zeros((len(base.prep.ordered),), dtype=bool)
        drop[0] = True
        base.base_drop = drop
    res, derived = _derive_and_simulate(base, c_ref, a_ref, ref_prepcache, ref_sim.simulate)
    return _ref_placements(derived, res)


# ---------------------------------------------------------------------------
# seqlock / torn generation
# ---------------------------------------------------------------------------


def test_control_block_roundtrip_and_poll():
    cb = ControlBlock(create=True)
    try:
        assert cb.poll() is None  # nothing published yet
        cb.write(7, {"fingerprint": "abc", "arrays": [], "blob": "b"})
        reader = ControlBlock(name=cb.name, create=False)
        assert reader.poll() == 7
        gen, payload, seq = reader.read()
        assert gen == 7 and payload["fingerprint"] == "abc" and seq % 2 == 0
        reader.close()
    finally:
        cb.unlink()
        cb.close()


def test_reader_never_observes_torn_generation():
    """Attach during continuous generation swaps: every successful attach
    is self-consistent — the published array encodes the generation it
    was written for, and both agree."""
    pub = TwinPublisher()
    stop = threading.Event()
    errors = []

    def writer():
        gen = 0
        while not stop.is_set():
            gen += 1
            pub.publish(gen, {"gen": gen}, {"stamp": np.full((64,), gen, dtype=np.int64)})
            time.sleep(0.001)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        reader = FleetReader(pub.control.name, retries=64)
        attached = 0
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            try:
                gen, _payload, obj = reader.attach()
            except TornGeneration:
                continue  # bounded: counted, never a torn view
            attached += 1
            stamp = obj["parts"]["stamp"]
            if obj["cluster"]["gen"] != gen or not (stamp == gen).all():
                errors.append((gen, obj["cluster"]["gen"], stamp[0]))
        assert attached > 10
        assert not errors, f"torn views observed: {errors[:3]}"
    finally:
        stop.set()
        t.join(timeout=5.0)
        assert not t.is_alive()
        pub.close()


def test_attach_retries_exhausted_is_typed():
    cb = ControlBlock(create=True)
    try:
        cb.write(1, {"blob": "x", "arrays": []})
        cb._seq += 1  # leave seq odd: a publish permanently in flight
        struct.pack_into("<Q", cb._shm.buf, 8, cb._seq)
        reader = FleetReader(cb.name, retries=3)
        with pytest.raises(TornGeneration):
            reader.attach()
        assert reader.retries_exhausted_total == 1
        reader.close()
    finally:
        cb.unlink()
        cb.close()


# ---------------------------------------------------------------------------
# lifecycle: no leaked /dev/shm segments, a reader never destroys the owner's
# ---------------------------------------------------------------------------


def test_close_unlinks_every_segment():
    cluster = _cluster()
    parts = _parts(_base_entry(cluster))
    pub = TwinPublisher()
    token = pub.token
    pub.publish(1, cluster, parts)
    assert _shm_names(token)  # segments exist while live
    pub.close()
    assert _shm_names(token) == []
    pub.close()  # idempotent


def test_owner_hard_crash_leaves_no_segments(tmp_path):
    """SIGKILL the owner mid-publication: the resource tracker (a separate
    process that survives the kill) unlinks everything."""
    script = tmp_path / "owner.py"
    script.write_text(
        "import sys, time\n"
        "import numpy as np\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from opensim_tpu_torch.server.fleet import TwinPublisher\n"
        "pub = TwinPublisher()\n"
        "pub.publish(1, {'x': 1}, {'a': np.zeros(1024)})\n"
        "print(pub.token, flush=True)\n"
        "time.sleep(60)\n"
    )
    out = tmp_path / "owner.out"
    with open(out, "w") as fh:
        proc = spawn_group([sys.executable, str(script)], stdout=fh, env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        deadline = time.monotonic() + 120.0
        while not out.read_text().endswith("\n"):
            assert proc.poll() is None and time.monotonic() < deadline, f"owner script: {out.read_text()[-2000:]}"
            time.sleep(0.05)
        token = out.read_text().strip()
        assert token and _shm_names(token)
        proc.kill()  # the owner alone: its resource tracker survives it
        proc.wait(timeout=30)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and _shm_names(token):
            time.sleep(0.2)
        assert _shm_names(token) == [], "resource tracker left segments behind"
    finally:
        stop_group(proc, timeout_s=0.0)


def _longest_stall(fn) -> float:
    """The longest a thread that sleeps 1 ms at a time waits to run again
    while `fn` runs in this one."""
    gaps, stop = [0.0], threading.Event()

    def probe():
        last = time.perf_counter()
        while not stop.is_set():
            time.sleep(0.001)
            now = time.perf_counter()
            gaps[0], last = max(gaps[0], now - last), now

    t = threading.Thread(target=probe)
    t.start()
    try:
        time.sleep(0.02)
        fn()
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    return gaps[0]


def test_publication_copies_release_the_gil():
    """A publication hashes and copies its arrays into shared memory
    without holding the GIL: a 256 MB array's publication stalls the
    owner's other threads (its lease renewals) far less than one copy of
    that array that holds the GIL (``tobytes``) does."""
    a = np.arange(64 << 20, dtype=np.int32)
    held = _longest_stall(a.tobytes)
    pub = TwinPublisher()
    try:
        free = _longest_stall(lambda: pub.publish(1, {"ok": True}, {"a": a}))
        reader = FleetReader(pub.control.name)
        gen, _payload, obj = reader.attach()
        assert gen == 1 and np.array_equal(obj["parts"]["a"], a)
        del obj
        reader.close()
    finally:
        pub.close()
    assert free < held / 2, f"the publication stalled another thread {free:.3f} s; a GIL-holding copy {held:.3f} s"


def test_reader_exit_does_not_destroy_owner_segments():
    """A worker that attaches and exits leaves the owner's segments intact:
    a later reader still attaches the same generation."""
    pub = TwinPublisher()
    try:
        pub.publish(3, {"ok": True}, {"a": np.arange(128, dtype=np.int64)})
        code = (
            "import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from opensim_tpu_torch.server.fleet import FleetReader\n"
            f"r = FleetReader({pub.control.name!r})\n"
            "gen, payload, obj = r.attach()\n"
            "assert gen == 3 and obj['cluster']['ok'] is True\n"
            "print('attached', flush=True)\n"
        )
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, timeout=120)
        assert out.returncode == 0, out.stderr.decode()[-2000:]
        r2 = FleetReader(pub.control.name)
        gen, _payload, obj = r2.attach()
        assert gen == 3 and (obj["parts"]["a"] == np.arange(128)).all()
        r2.close()
    finally:
        pub.close()


# ---------------------------------------------------------------------------
# parity: attached placements == owner placements == the JAX package's
# ---------------------------------------------------------------------------


def test_attached_placements_bit_identical():
    cluster = _cluster()
    base = _base_entry(cluster)
    parts = _parts(base)
    pub = TwinPublisher()
    try:
        pub.publish(5, cluster, parts)
        reader = FleetReader(pub.control.name)
        gen, _payload, obj = reader.attach()
        assert gen == 5
        entry = prepcache.entry_from_publication("fleet|5|base", obj["parts"], "cpu")
        # the attached numpy views are zero-copy and read-only; the tensors
        # on the host are copies, never aliases of the shared memory
        assert not entry.prep.ec_np.alloc.flags.writeable
        assert not np.shares_memory(entry.prep.ec.alloc.numpy(), entry.prep.ec_np.alloc)
        for apps in (_apps(), _apps("huge", 1, "640")):  # placed + unschedulable
            solo, _ = _derive_and_simulate(base, cluster, apps)
            fleet, _ = _derive_and_simulate(entry, obj["cluster"], apps)
            assert _placements(solo) == _placements(fleet)
            np.testing.assert_array_equal(fleet.placements, solo.placements)
            np.testing.assert_array_equal(fleet.placements, _jax_placements(cluster, apps))
        reader.close()
    finally:
        pub.close()


def test_publication_parts_equal_jax_leaf_by_leaf():
    """For the same cluster, the port's published arrays (the encoded
    cluster, the carry brought back from the owner's device, the template
    ids, the forced flags) equal the JAX package's ``publication_parts``."""
    cluster = fx.synthetic_cluster(12)
    cluster.pods.append(fx.make_fake_pod("pinned", "100m", "128Mi", fx.with_node_name(cluster.nodes[0].metadata.name)))
    port = _parts(_base_entry(cluster, node_pad=PAD))
    c_ref = _reference_copy(cluster)
    ref_base = ref_prepcache.CacheEntry("t|base", ref_sim.prepare(c_ref, []))
    with ref_base.lock:
        ref_base.restore()
        ref = ref_prepcache.publication_parts(ref_base)
    for name, x, y in zip(port["ec_np"]._fields, port["ec_np"], ref["ec_np"]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
    for name, x, y in zip(port["st0_np"]._fields, port["st0_np"], ref["st0_np"]):
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=name)
    np.testing.assert_array_equal(port["tmpl_ids"], ref["tmpl_ids"])
    np.testing.assert_array_equal(port["forced"], ref["forced"])
    assert (port["n_cluster"], port["n_bare"]) == (ref["n_cluster"], ref["n_bare"])


def test_base_drop_mask_round_trips():
    """The twin's event-deleted pods (base_drop) survive publication: a
    worker's simulate excludes them exactly like the owner's and the JAX
    package's."""
    cluster = _cluster()
    base = _base_entry(cluster)
    with base.lock:
        base.restore()
        drop = np.zeros((len(base.prep.ordered),), dtype=bool)
        drop[0] = True  # the pinned pod was DELETED by a watch event
        base.base_drop = drop
        parts = prepcache.publication_parts(base)
    pub = TwinPublisher()
    try:
        pub.publish(6, cluster, parts)
        reader = FleetReader(pub.control.name)
        _gen, _payload, obj = reader.attach()
        entry = prepcache.entry_from_publication("fleet|6|base", obj["parts"], "cpu")
        assert entry.base_drop is not None and entry.base_drop[0]
        solo, _ = _derive_and_simulate(base, cluster, _apps())
        fleet, _ = _derive_and_simulate(entry, obj["cluster"], _apps())
        assert _placements(solo) == _placements(fleet)
        np.testing.assert_array_equal(fleet.placements, _jax_placements(cluster, _apps(), drop_first=True))
        reader.close()
    finally:
        pub.close()


# ---------------------------------------------------------------------------
# delta publication
# ---------------------------------------------------------------------------


def test_unchanged_buffers_keep_segments_across_generations():
    cluster = _cluster()
    parts = _parts(_base_entry(cluster))
    pub = TwinPublisher()
    try:
        p1 = pub.publish(1, cluster, parts)
        p2 = pub.publish(2, cluster, parts)
        assert {a[0] for a in p1["arrays"]} == {a[0] for a in p2["arrays"]}  # every segment reused
        reader = FleetReader(pub.control.name)
        reader.attach()
        reuse0 = reader.segment_reuse_total
        pub.publish(3, cluster, parts)
        gen, _p, _o = reader.attach()
        assert gen == 3
        assert reader.segment_reuse_total > reuse0  # attachments reused too
        reader.close()
    finally:
        pub.close()


def test_gc_drops_segments_outside_keep_window():
    pub = TwinPublisher(keep_generations=2)
    try:
        names = []
        for gen in range(1, 5):
            p = pub.publish(gen, {"g": gen}, {"a": np.full(64, gen, np.int64)})
            names.append({a[0] for a in p["arrays"]})
        live = set(_shm_names(pub.token))
        # generation 1's and 2's distinct arrays are gone; 3's and 4's remain
        assert not any(n in live for n in names[0] - names[2] - names[3])
        assert all(n in live for n in names[3])
    finally:
        pub.close()


# ---------------------------------------------------------------------------
# the worker-side client
# ---------------------------------------------------------------------------


def test_fleet_twin_client_serves_and_swaps_generations():
    cluster = _cluster()
    parts = _parts(_base_entry(cluster))
    pub = TwinPublisher()
    try:
        pub.publish(1, cluster, parts, state="live", stale=False)
        cache = prepcache.PrepareCache()
        client = FleetTwinClient(pub.control.name, prep_cache=cache, device="cpu")
        assert client.start(wait_s=10.0)
        got = client.serving_snapshot()
        assert got is not None
        _cl, key, stale = got
        assert key == "fleet|1" and stale is False
        assert cache.get("fleet|1|base") is not None
        assert client.state() == "fleet-live"
        # a generation swap: the new key served, the old lineage invalidated
        pub.publish(2, cluster, parts, state="degraded", stale=True)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            _cl, key, stale = client.serving_snapshot()
            if key == "fleet|2":
                break
        assert key == "fleet|2" and stale is True
        assert cache.get("fleet|2|base") is not None
        assert cache.get("fleet|1|base") is None
        lines = client.metrics_lines()
        assert any(line.startswith("simon_fleet_attaches_total 2") for line in lines)
        assert any(line.startswith("simon_fleet_attach_retries_exhausted_total 0") for line in lines)
        client.stop()
    finally:
        pub.close()


def test_no_prep_publication_still_serves_cluster():
    """A twin with no schedulable pods publishes parts=None; the worker
    serves the cluster and the REST layer's own bootstrap covers prep."""
    cluster = _cluster(with_pod=False)
    pub = TwinPublisher()
    try:
        pub.publish(4, cluster, None)
        cache = prepcache.PrepareCache()
        client = FleetTwinClient(pub.control.name, prep_cache=cache, device="cpu")
        assert client.start(wait_s=10.0)
        cl, key, _stale = client.serving_snapshot()
        assert key == "fleet|4" and len(cl.nodes) == len(cluster.nodes)
        assert cache.get("fleet|4|base") is None  # nothing published to seed
        client.stop()
    finally:
        pub.close()


def test_same_generation_republish_reaches_workers():
    """A staleness/state flip on a quiet twin republishes at the SAME
    generation; workers refresh their payload (the control seq is the
    change detector) so degraded responses keep their stale tag."""
    cluster = _cluster()
    parts = _parts(_base_entry(cluster))
    pub = TwinPublisher()
    try:
        pub.publish(9, cluster, parts, state="live", stale=False)
        client = FleetTwinClient(pub.control.name, prep_cache=prepcache.PrepareCache(), device="cpu")
        assert client.start(wait_s=10.0)
        _cl, key, stale = client.serving_snapshot()
        assert key == "fleet|9" and stale is False
        pub.publish(9, cluster, parts, state="degraded", stale=True)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            _cl, key, stale = client.serving_snapshot()
            if stale:
                break
        assert key == "fleet|9" and stale is True
        assert client.state() == "fleet-degraded"
        client.stop()
    finally:
        pub.close()
