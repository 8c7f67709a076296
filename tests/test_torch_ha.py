"""The port's HA control plane (opensim_tpu_torch/server/fleet.py and the
journal tailer) on the CPU: the cases of tests/test_ha.py.

- fencing: a deposed owner (lease stolen at a higher epoch) never
  publishes a generation a worker attaches — the publish raises
  :class:`FencedWrite` (counted), and a worker that has seen the newer
  lease epoch refuses any stale-epoch payload;
- tailing: the standby's segment-follow reader survives rotation, torn
  tails and injected gaps (``journal.tail_gap``): the next checkpoint
  rebases its twin back to truth bit for bit;
- takeover: SIGKILL the owner mid event-storm — the standby acquires the
  lease, adopts the surviving workers (zero respawns), resumes the watch
  at the recorded rvs (zero relists), and its twin fingerprint equals a
  fresh full relist; a worker's answer then equals the JAX package's
  single-process server on the relisted cluster;
- handover: a standby started with ``--handover`` asks the live owner to
  drain; the owner exits 0 leaving its workers running, and the standby
  publishes at the next epoch (``simon_fleet_takeovers_total{reason=
  "handover"}``), its workers answering as the JAX server does.

The end-to-end runs spawn the port's owners, standbys and workers as
``--device cpu`` subprocesses, each server the leader of its own process
group with one intra-op thread (inherited by its workers); teardown stops
every group, and each run checks that no server and no worker it spawned
still runs afterwards.
"""

import copy
import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from opensim_tpu.models import expand as ref_expand
from opensim_tpu.server import rest as ref_rest
from opensim_tpu_torch.engine.prepcache import fingerprint_cluster
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.models.objects import ResourceTypes
from opensim_tpu_torch.resilience import faults
from opensim_tpu_torch.server.fleet import (
    FencedWrite,
    FleetLease,
    FleetReader,
    FleetTwinClient,
    TwinPublisher,
    lease_path,
)
from opensim_tpu_torch.server.journal import Journal, JournalTailer, apply_record
from opensim_tpu_torch.server.snapshot import _cluster_via_rest
from opensim_tpu_torch.server.stubapi import StubApiServer
from opensim_tpu_torch.server.watch import ClusterTwin
from opensim_tpu_torch.utils.procgroup import pid_gone, spawn_group, stop_group

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("OPENSIM_FAULTS", raising=False)
    faults.clear_faults()
    yield
    faults.clear_faults()


def _cluster(n_nodes: int = 4) -> ResourceTypes:
    rt = ResourceTypes()
    for i in range(n_nodes):
        rt.nodes.append(fx.make_fake_node(f"n{i:03d}", "16", "64Gi", "110"))
    return rt


def _pod_dict(name, rv, phase="Pending", node="", cpu="100m"):
    d = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": "default", "resourceVersion": str(rv)},
        "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": cpu}}}]},
        "status": {"phase": phase},
    }
    if node:
        d["spec"]["nodeName"] = node
    return d


def _wait(pred, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


# ---------------------------------------------------------------------------
# the lease
# ---------------------------------------------------------------------------


def test_lease_acquire_renew_steal_epochs(tmp_path):
    path = lease_path(str(tmp_path))
    a = FleetLease(path, lease_s=5.0, holder="owner-a")
    assert a.acquire({"port": 1234}) == 1
    assert a.check() and a.renew(control="ctrl-a")
    assert a.read()["control"] == "ctrl-a"

    # a fresh, live lease is NOT claimable by a second holder
    b = FleetLease(path, lease_s=5.0, holder="standby-b")
    assert b.acquire() is None and not b.check()

    # expiry makes it claimable; the steal bumps the epoch and fences A
    doc = a.read()
    doc["renewed_at"] = time.time() - 60.0
    b._write(doc)  # backdate: deterministic expiry
    assert b.acquire() == 2
    assert b.check()
    assert not a.check(), "the deposed holder must observe the fence"
    assert not a.renew(), "renew under a moved epoch must refuse"


def test_lease_release_handover_is_immediately_claimable(tmp_path):
    path = lease_path(str(tmp_path))
    a = FleetLease(path, lease_s=600.0, holder="owner-a")  # would never expire
    assert a.acquire() == 1
    a.release(handover=True)
    doc = a.read()
    assert doc["released"] and doc["handover"]
    b = FleetLease(path, lease_s=600.0, holder="standby-b")
    assert b.claimable(doc)
    assert b.acquire() == 2


# ---------------------------------------------------------------------------
# fencing: the deposed owner never reaches a worker
# ---------------------------------------------------------------------------


def test_stale_epoch_publish_raises_fenced_write(tmp_path):
    """Owner A holds the lease and publishes; the lease is stolen (the
    epoch moves); A's next publish refuses with FencedWrite, leaves the
    seqlock untouched and counts the fence."""
    path = lease_path(str(tmp_path))
    a = FleetLease(path, lease_s=5.0, holder="owner-a")
    assert a.acquire() == 1
    pub = TwinPublisher(epoch=a.epoch, lease=a)
    cluster = _cluster()
    try:
        pub.publish(1, cluster, None)
        reader = FleetReader(pub.control.name)
        assert reader.poll() == 1

        doc = a.read()
        doc["renewed_at"] = time.time() - 60.0
        a._write(doc)
        b = FleetLease(path, lease_s=5.0, holder="standby-b")
        assert b.acquire() == 2

        with pytest.raises(FencedWrite):
            pub.publish(2, cluster, None)
        assert pub.footprint()["fenced_writes"] >= 1
        # the control block never swapped: a worker still attaches gen 1
        gen, payload, _obj = reader.attach()
        assert gen == 1 and payload["epoch"] == 1
        reader.close()
    finally:
        pub.close()


def test_worker_refuses_stale_epoch_payload(tmp_path):
    """The reader-side fence: a worker that has seen lease epoch 2 refuses
    a payload published at epoch 1 even if it lands in shared memory, and
    keeps serving its previously attached generation."""
    path = lease_path(str(tmp_path))
    a = FleetLease(path, lease_s=600.0, holder="owner-a")
    assert a.acquire() == 1
    # lease=None mimics the doomed in-flight publish: only the worker-side
    # fence is left
    pub = TwinPublisher(epoch=1, lease=None)
    cluster = _cluster()
    client = None
    try:
        pub.publish(1, cluster, None)
        client = FleetTwinClient(pub.control.name, lease_file=path, device="cpu")
        client.LEASE_CHECK_S = 0.0  # re-read the lease every snapshot
        assert client.start(wait_s=10.0)
        assert client.serving_snapshot()[1] == "fleet|1"

        doc = a.read()
        doc["epoch"] = 2
        doc["control"] = pub.control.name
        a._write(doc)
        client.serving_snapshot()  # absorb the new lease epoch
        assert client._lease_epoch == 2

        pub.publish(5, cluster, None)  # the deposed owner's late write
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            got = client.serving_snapshot()
            assert got is not None
            assert got[1] == "fleet|1", "a stale-epoch generation must never serve"
            time.sleep(0.02)
    finally:
        if client is not None:
            client.stop()
        pub.close()


def test_worker_follows_lease_to_new_owner(tmp_path):
    """Failover discovery: once the lease names the new owner's control
    block AND the new owner has published, the worker swaps readers and
    serves the new epoch's generation, never dropping its old snapshot in
    between."""
    path = lease_path(str(tmp_path))
    a = FleetLease(path, lease_s=5.0, holder="owner-a")
    assert a.acquire() == 1
    pub_a = TwinPublisher(epoch=1, lease=a)
    cluster = _cluster()
    pub_b = None
    client = None
    try:
        pub_a.publish(3, cluster, None)
        a.renew(control=pub_a.control.name)
        client = FleetTwinClient(pub_a.control.name, lease_file=path, device="cpu")
        client.LEASE_CHECK_S = 0.0
        assert client.start(wait_s=10.0)
        assert client.serving_snapshot()[1] == "fleet|3"

        doc = a.read()
        doc["renewed_at"] = time.time() - 60.0
        a._write(doc)
        b = FleetLease(path, lease_s=5.0, holder="standby-b")
        assert b.acquire() == 2
        pub_b = TwinPublisher(epoch=2, lease=b)
        b.renew(control=pub_b.control.name)

        # the lease names B but B has not published: keep serving A's
        assert client.serving_snapshot()[1] == "fleet|3"
        assert client.owner_switches_total == 0

        pub_b.publish(4, cluster, None)

        def swapped():
            got = client.serving_snapshot()
            return got is not None and got[1] == "fleet|4"

        _wait(swapped, timeout=10.0, msg="worker to follow the lease")
        assert client.owner_switches_total == 1
        assert client.control_name == pub_b.control.name
    finally:
        if client is not None:
            client.stop()
        pub_a.close()
        if pub_b is not None:
            pub_b.close()


# ---------------------------------------------------------------------------
# the journal tailer
# ---------------------------------------------------------------------------


def _tail_journal(tmp_path, name="tail"):
    jd = str(tmp_path / name)
    return jd, Journal(jd, policy={"fsync": "always"})


def test_tailer_follows_live_writes_and_rotation(tmp_path):
    jd, jr = _tail_journal(tmp_path)
    src, dst = ClusterTwin(), ClusterTwin()
    tailer = JournalTailer(jd)
    try:
        stores, gen = src.snapshot_raw()
        jr.record_checkpoint(stores, gen, why="bootstrap")
        for i in range(5):
            obj = _pod_dict(f"p{i}", rv=10 + i)
            src.apply_event("pods", "ADDED", obj)
            jr.record_event("pods", "ADDED", obj, src.generation)
        jr.flush(timeout=10.0)
        for rec in tailer.poll():
            apply_record(dst, rec)
        assert dst.fingerprint() == src.fingerprint()
        assert tailer.last_lag_records == 0 or tailer.poll() == []

        # a cadence checkpoint rotates to a new segment; the tailer crosses
        # it and keeps applying in order
        jr.checkpoint_source = lambda: ({}, src.generation, [])
        jr.policy["checkpoint_every"] = 1
        obj = _pod_dict("rotor", rv=15)
        src.apply_event("pods", "ADDED", obj)
        jr.record_event("pods", "ADDED", obj, src.generation)
        jr.flush(timeout=10.0)
        jr.checkpoint_source = None
        for i in range(5, 8):
            obj = _pod_dict(f"p{i}", rv=10 + i)
            src.apply_event("pods", "ADDED", obj)
            jr.record_event("pods", "ADDED", obj, src.generation)
        jr.flush(timeout=10.0)
        assert len([f for f in os.listdir(jd) if f.endswith(".seg")]) >= 2, "the checkpoint should rotate"
        for rec in tailer.poll():
            apply_record(dst, rec)
        assert dst.fingerprint() == src.fingerprint()
        assert tailer.gaps_total == 0
    finally:
        jr.close()


def test_tailer_waits_at_torn_tail_then_resumes(tmp_path):
    """A torn frame at the live tail is 'incomplete': the tailer returns
    what precedes it and waits; once the torn bytes are truncated and the
    writer's next frame lands, the stream continues without a gap."""
    jd, jr = _tail_journal(tmp_path)
    src, dst = ClusterTwin(), ClusterTwin()
    tailer = JournalTailer(jd)
    try:
        stores, gen = src.snapshot_raw()
        jr.record_checkpoint(stores, gen, why="bootstrap")
        obj = _pod_dict("before-tear", rv=5)
        src.apply_event("pods", "ADDED", obj)
        jr.record_event("pods", "ADDED", obj, src.generation)
        jr.flush(timeout=10.0)
        for rec in tailer.poll():
            apply_record(dst, rec)
        assert dst.fingerprint() == src.fingerprint()

        # tear the tail: a frame header promising more bytes than exist
        seg = sorted(f for f in os.listdir(jd) if f.endswith(".seg"))[-1]
        with open(os.path.join(jd, seg), "ab") as f:
            f.write((1000).to_bytes(4, "little") + b"\x00\x00\x00\x00" + b"xx")
        assert tailer.poll() == []
        assert tailer.last_stop == "incomplete"

        # the takeover path truncates the torn bytes (writable reopen); the
        # tailer detects the shrink, re-reads, and stays consistent
        jr.close()
        jr2 = Journal(jd, policy={"fsync": "always"})
        obj2 = _pod_dict("after-tear", rv=6)
        src.apply_event("pods", "ADDED", obj2)
        jr2.record_event("pods", "ADDED", obj2, src.generation)
        jr2.flush(timeout=10.0)
        got = []
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not got:
            got = tailer.poll()
        for rec in got:
            apply_record(dst, rec)
        assert "after-tear" in {p.metadata.name for p in dst.materialize().pods}
        assert dst.fingerprint() == src.fingerprint()
        jr2.close()
    finally:
        jr.close()


def test_tail_gap_fault_heals_at_next_checkpoint(tmp_path):
    """Fault ``journal.tail_gap``: one drained batch is dropped (counted);
    the stream's next checkpoint rebases the consumer twin back to
    bit-equality with the source."""
    jd, jr = _tail_journal(tmp_path)
    src, dst = ClusterTwin(), ClusterTwin()
    tailer = JournalTailer(jd)
    try:
        stores, gen = src.snapshot_raw()
        jr.record_checkpoint(stores, gen, why="bootstrap")
        jr.flush(timeout=10.0)
        for rec in tailer.poll():
            apply_record(dst, rec)
        for i in range(4):
            obj = _pod_dict(f"lost-{i}", rv=20 + i)
            src.apply_event("pods", "ADDED", obj)
            jr.record_event("pods", "ADDED", obj, src.generation)
        jr.flush(timeout=10.0)
        faults.inject("journal.tail_gap", count=1, exc="runtime")
        assert tailer.poll() == [], "the injected gap must drop the batch"
        assert tailer.gaps_total == 1
        assert dst.fingerprint() != src.fingerprint(), "the twin is now behind"

        stores, gen = src.snapshot_raw()
        jr.record_checkpoint(stores, gen, why="heal")
        jr.flush(timeout=10.0)
        for rec in tailer.poll():
            apply_record(dst, rec)
        assert dst.fingerprint() == src.fingerprint()
    finally:
        jr.close()


def test_lease_steal_fault_forces_fenced_publish(tmp_path):
    """Fault ``fleet.lease_steal``: the injected steal makes check() fence
    even though the file still names us; the publish refuses."""
    path = lease_path(str(tmp_path))
    lease = FleetLease(path, lease_s=600.0, holder="owner-a")
    assert lease.acquire() == 1
    pub = TwinPublisher(epoch=1, lease=lease)
    try:
        pub.publish(1, _cluster(), None)
        faults.inject("fleet.lease_steal", count=1, exc="runtime")
        with pytest.raises(FencedWrite):
            pub.publish(2, _cluster(), None)
        assert pub.footprint()["fenced_writes"] == 1
        pub.publish(2, _cluster(), None)  # the injection consumed itself
        reader = FleetReader(pub.control.name)
        assert reader.poll() == 2
        reader.close()
    finally:
        pub.close()


def test_shm_republish_fault_keeps_previous_generation(tmp_path):
    """Fault ``shm.republish``: a publish dying between the segment writes
    and the seqlock swap leaves readers on the previous stable generation;
    the next publish succeeds."""
    pub = TwinPublisher()
    cluster = _cluster()
    try:
        pub.publish(1, cluster, None)
        reader = FleetReader(pub.control.name)
        assert reader.poll() == 1
        faults.inject("shm.republish", count=1, exc="runtime")
        with pytest.raises(RuntimeError, match="shm.republish"):
            pub.publish(2, cluster, None)
        gen, _payload, _obj = reader.attach()
        assert gen == 1, "a torn publish must never surface to readers"
        pub.publish(3, cluster, None)
        assert reader.poll() == 3
        reader.close()
    finally:
        pub.close()


# ---------------------------------------------------------------------------
# end to end: SIGKILL the owner mid-storm; the standby takes over
# ---------------------------------------------------------------------------

LIST_PATHS = (
    "/api/v1/nodes",
    "/api/v1/pods",
    "/apis/apps/v1/daemonsets",
    "/apis/policy/v1/poddisruptionbudgets",
    "/api/v1/services",
    "/apis/storage.k8s.io/v1/storageclasses",
    "/api/v1/persistentvolumeclaims",
    "/api/v1/configmaps",
)

#: the request each fleet's workers answer after the takeover
BODY = {"deployments": [fx.make_fake_deployment("web", 6, "500m", "1Gi").raw]}


def _seed(stub, n_nodes=4):
    stub.seed("/api/v1/nodes", [fx.make_fake_node(f"n{i}", "8", "16Gi").raw for i in range(n_nodes)])
    stub.seed("/api/v1/pods", [_pod_dict(f"bound-{i}", rv=10 + i, phase="Running", node=f"n{i % n_nodes}")
                               for i in range(6)])
    for p in LIST_PATHS[2:]:
        stub.seed(p, [])


def _free_port(span: int = 17):
    """A public port P with P .. P + span - 1 free (the owner's admin
    endpoint P + 1, the workers' loopback listeners P + 2 ..., the
    standby's admin endpoint P + 16), drawn below the kernel's ephemeral
    range, where no client connection of a concurrent test takes one of
    them as its local port."""
    import random
    import socket

    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(max(1024, low - 12000), low - span)
        try:
            for p in range(base, base + span):
                with socket.socket() as s:
                    s.bind(("0.0.0.0", p))
        except OSError:
            continue
        return base
    raise RuntimeError("no free run of ports below the ephemeral range")


def _http_json(url, timeout=3.0, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else (b"" if method == "POST" else None)
    req = urllib.request.Request(url, method=method, data=data)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _http_text(url, timeout=3.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def _ha_env(lease_s="1.5"):
    # one intra-op thread in each server and, inherited, in each of its
    # fleet workers: up to six torch interpreters run beside the test
    # run's own workers
    return dict(os.environ, PYTHONPATH=REPO, OPENSIM_HA="1", OPENSIM_HA_LEASE_S=lease_s,
                OPENSIM_HA_TAIL_POLL_MS="25", OPENSIM_FLEET_PUBLISH_MS="50",
                OPENSIM_JOURNAL_FSYNC="always", OPENSIM_JOURNAL_CHECKPOINT_EVERY="64", OMP_NUM_THREADS="1")


def _spawn(argv, env, logfile):
    # stdout goes to a FILE, not a pipe: the workers inherit the fd and
    # outlive the owner on handover/takeover; a pipe would never EOF. Each
    # server leads its own process group, which its workers join
    with open(logfile, "w") as fh:
        return spawn_group([sys.executable, "-m", "opensim_tpu_torch", "server", *argv, "--device", "cpu"],
                           stdout=fh, stderr=subprocess.STDOUT, env=env, cwd=REPO)


def _spawn_owner(kc, jd, port, env, logfile):
    return _spawn(["--kubeconfig", kc, "--watch", "on", "--journal", jd, "--port", str(port), "--workers", "2"],
                  env, logfile)


def _spawn_standby(kc, jd, port, env, logfile, handover=False):
    return _spawn(["--standby", "--kubeconfig", kc, "--watch", "auto", "--journal", jd, "--port", str(port),
                   "--workers", "2"] + (["--handover"] if handover else []), env, logfile)


def _log(path):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def _owner_up(admin_port, proc, logfile, want_workers=2):
    def pred():
        if proc.poll() is not None:
            raise AssertionError(f"process died early: {_log(logfile)[-3000:]}")
        try:
            body = _http_json(f"http://127.0.0.1:{admin_port}/healthz", timeout=2.0)
            return body.get("workers", 0) >= want_workers
        except OSError:
            return False

    return pred


def _workers_listening(status):
    """Each worker answers on its loopback listener: it has attached the
    owner's first publication (a worker still starting when its owner dies
    waits for that owner's control block, not the lease)."""
    def pred():
        try:
            return all(_http_json(f"http://127.0.0.1:{w['internal_port']}/healthz")["status"] == "ok"
                       for w in status["workers"])
        except OSError:
            return False

    return pred


def _metric_value(text, needle):
    for line in text.splitlines():
        if line.startswith(needle):
            return float(line.rsplit(" ", 1)[-1])
    return None


def _norm(obj) -> str:
    """The answer without the process counters in pod names."""
    return re.sub(r"-[0-9a-f]{10}\b", "-#", json.dumps(obj, sort_keys=True))


def _workers_answer_as_jax(kc, admin, status):
    """Each worker (its loopback listener) answers BODY as the JAX
    package's single-process server does on a fresh relist of the stub,
    once the owner's publication has settled."""
    def settled():
        gen = _http_json(f"{admin}/api/fleet/status")["generation"]
        time.sleep(0.3)
        return _http_json(f"{admin}/api/fleet/status")["generation"] == gen

    _wait(settled, timeout=30.0, msg="the publication to settle")
    fresh, _rvs = _cluster_via_rest(kc, None)
    docs = [copy.deepcopy(o.raw) for o in fresh.nodes + fresh.pods]
    ref_cluster, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    ref = ref_rest.SimonServer(base_cluster=ref_cluster, admission=False, capacity=False)
    code, want = ref.deploy_apps(copy.deepcopy(BODY))
    assert code == 200
    for w in status["workers"]:
        got = _http_json(f"http://127.0.0.1:{w['internal_port']}/api/deploy-apps", timeout=60.0,
                         method="POST", body=BODY)
        assert _norm(got) == _norm(want), f"worker {w['index']} differs from the JAX server"


def _stop(owner, standby):
    # the standby-turned-owner owns the adopted workers: SIGTERM it first
    # so it reaps them; then each process group is killed whole, the
    # workers a SIGKILLed owner left in its group included
    if standby is not None:
        stop_group(standby, timeout_s=30.0)
    if owner is not None:
        stop_group(owner, timeout_s=0.0)


def _assert_reaped(procs, worker_pids):
    """No server and no fleet worker of the run still runs."""
    left = [p.pid for p in procs if p is not None and p.poll() is None]
    left += [pid for pid in worker_pids if not pid_gone(pid)]
    assert not left, f"processes left running after teardown: {left}"


def _threads_capped(pids):
    """Each fleet worker inherited its owner's one-thread cap."""
    for pid in pids:
        with open(f"/proc/{pid}/environ", "rb") as f:
            assert b"OMP_NUM_THREADS=1" in f.read().split(b"\0"), f"worker {pid} has no thread cap"


def test_sigkill_owner_standby_takes_over_bit_equal(tmp_path):
    """SIGKILL the HA owner mid event-storm. The tailing standby takes over
    at the recorded rvs — twin fingerprint equal to a fresh full relist,
    ZERO relists, the surviving workers adopted (zero respawns), the
    publication generation monotonic, ``takeovers_total{reason="expired"}
    == 1`` — and each worker then answers as the JAX server does."""
    stub = StubApiServer(bookmark_interval_s=0.1).start()
    _seed(stub)
    kc = stub.kubeconfig(tmp_path)
    jd = str(tmp_path / "journal")
    port = _free_port()
    env = _ha_env()
    owner_log, sb_log = str(tmp_path / "owner.log"), str(tmp_path / "standby.log")
    owner = standby = None
    worker_pids = set()
    try:
        # the standby starts beside the owner: it tails once the owner's
        # lease and first checkpoint exist
        owner = _spawn_owner(kc, jd, port, env, owner_log)
        standby = _spawn_standby(kc, jd, port, env, sb_log)
        _wait(_owner_up(port + 1, owner, owner_log), timeout=120.0, msg="HA owner fleet up")
        status = _http_json(f"http://127.0.0.1:{port + 1}/api/fleet/status")
        assert status["role"] == "owner" and status["epoch"] == 1
        worker_pids = {w["pid"] for w in status["workers"] if w["alive"]}
        assert len(worker_pids) == 2
        _threads_capped(worker_pids)
        gen_before = status["generation"]
        _wait(_workers_listening(status), timeout=120.0, msg="the workers to listen")
        # the owner published: the twin it built is frozen out of the
        # collector's generations, and it renews its lease
        owned = _http_json(f"http://127.0.0.1:{port + 1}/api/fleet/status")
        assert owned["collector"]["frozen"] > 0 and owned["lease_renewals"]["count"] > 0
        sb_admin = f"http://127.0.0.1:{port + 16}"

        def standby_tailing():
            if standby.poll() is not None:
                raise AssertionError(f"standby died early: {_log(sb_log)[-3000:]}")
            try:
                body = _http_json(f"{sb_admin}/api/fleet/status")
                return body["role"] == "standby" and body["at_parity"]
            except OSError:
                return False

        _wait(standby_tailing, timeout=60.0, msg="standby to tail to parity")

        # an event storm, the owner SIGKILLed mid-stream
        for i in range(30):
            stub.upsert("/api/v1/pods", _pod_dict(f"storm-{i}", rv=1000 + i))
            if i == 20:
                owner.kill()  # no flush, no release, no goodbye
        owner.wait(timeout=10)
        stub.delete("/api/v1/pods", "storm-3")  # churn only the watch can see

        def promoted():
            try:
                return _http_json(f"{sb_admin}/api/fleet/status")["role"] == "owner"
            except OSError:
                return False

        _wait(promoted, timeout=60.0, msg="standby to take over")
        status = _http_json(f"{sb_admin}/api/fleet/status")
        assert status["epoch"] == 2
        adopted = {w["pid"] for w in status["workers"] if w["adopted"]}
        assert adopted == worker_pids, f"{adopted} != {worker_pids}"

        def caught_up():
            fresh, _rvs = _cluster_via_rest(kc, None)
            return _http_json(f"{sb_admin}/api/fleet/status")["fingerprint"] == fingerprint_cluster(fresh)

        _wait(caught_up, timeout=60.0, msg="the new owner's twin to equal a fresh relist")
        metrics = _http_text(f"{sb_admin}/metrics")
        assert _metric_value(metrics, 'simon_fleet_takeovers_total{reason="expired"}') == 1.0
        relists = _metric_value(metrics, "simon_watch_relists_total")
        assert relists in (None, 0.0), f"the takeover must not relist (saw {relists})"
        assert _metric_value(metrics, "simon_fleet_respawns_total") == 0.0
        status = _http_json(f"{sb_admin}/api/fleet/status")
        assert status["generation"] >= gen_before, "generations must stay monotonic"
        _workers_answer_as_jax(kc, sb_admin, status)
    finally:
        _stop(owner, standby)
        stub.stop()
    _assert_reaped((owner, standby), worker_pids)


def test_rolling_upgrade_handover_drains_cleanly(tmp_path):
    """A standby started with ``--handover`` tails to parity and asks the
    owner to drain; the owner exits 0 WITHOUT killing its workers, and the
    standby owns the fleet at the next epoch with
    ``takeovers_total{reason="handover"} == 1``; its workers answer as the
    JAX server does."""
    stub = StubApiServer(bookmark_interval_s=0.1).start()
    _seed(stub)
    kc = stub.kubeconfig(tmp_path)
    jd = str(tmp_path / "journal")
    port = _free_port()
    env = _ha_env(lease_s="4")
    owner_log, sb_log = str(tmp_path / "owner.log"), str(tmp_path / "standby.log")
    owner = standby = None
    worker_pids = set()
    try:
        owner = _spawn_owner(kc, jd, port, env, owner_log)
        _wait(_owner_up(port + 1, owner, owner_log), timeout=120.0, msg="HA owner fleet up")
        status = _http_json(f"http://127.0.0.1:{port + 1}/api/fleet/status")
        worker_pids = {w["pid"] for w in status["workers"] if w["alive"]}
        _threads_capped(worker_pids)
        _wait(_workers_listening(status), timeout=120.0, msg="the workers to listen")

        standby = _spawn_standby(kc, jd, port, env, sb_log, handover=True)
        owner.wait(timeout=120)
        out = _log(owner_log)
        assert owner.returncode == 0, f"owner exit {owner.returncode}: {out[-3000:]}"
        assert "handed over" in out
        for pid in worker_pids:
            os.kill(pid, 0)  # the old owner must NOT have killed its workers

        sb_admin = f"http://127.0.0.1:{port + 16}"

        def promoted():
            if standby.poll() is not None:
                raise AssertionError(f"standby died early: {_log(sb_log)[-3000:]}")
            try:
                return _http_json(f"{sb_admin}/api/fleet/status")["role"] == "owner"
            except OSError:
                return False

        _wait(promoted, timeout=60.0, msg="standby promotion after handover")
        status = _http_json(f"{sb_admin}/api/fleet/status")
        assert status["epoch"] == 2
        assert {w["pid"] for w in status["workers"] if w["adopted"]} == worker_pids
        metrics = _http_text(f"{sb_admin}/metrics")
        assert _metric_value(metrics, 'simon_fleet_takeovers_total{reason="handover"}') == 1.0
        _workers_answer_as_jax(kc, sb_admin, status)
    finally:
        _stop(owner, standby)
        stub.stop()
    _assert_reaped((owner, standby), worker_pids)
