"""The port's watch-event journal (``server/journal.py``) on the CPU, the
cases of tests/test_journal.py: CRC32 framing and torn-tail truncation,
checkpoint-plus-suffix recovery, rotation and pruning, the bounded
off-dispatch writer, replay (``rebuild_twin``, ``replay_events``, paced
and at a generation), the ``journal.*`` fault points, the capacity
timeline's restore, a SIGKILL of ``simon server --watch on --journal``
(a ``--device cpu`` subprocess) with a restart on the same journal, and
the graceful SIGTERM. Against the JAX package: a journal written by either
package replays in the other with equal records and equal ``rebuild_twin``
fingerprints, and the port's ``simon replay`` summary equals the JAX
CLI's but for ``wall_s`` and ``events_per_s``."""

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from opensim_tpu.cli import main as ref_cli
from opensim_tpu.server import journal as ref_journal
from opensim_tpu_torch.cli import main as cli
from opensim_tpu_torch.engine.prepcache import fingerprint_cluster
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.obs.capacity import CapacityEngine
from opensim_tpu_torch.obs.metrics import RECORDER, parse_metrics
from opensim_tpu_torch.obs.timeline import Sample, Timeline
from opensim_tpu_torch.resilience import faults
from opensim_tpu_torch.server import journal as journal_mod
from opensim_tpu_torch.server.journal import (
    Journal,
    JournalError,
    iter_records,
    journal_policy,
    rebuild_twin,
    replay_events,
)
from opensim_tpu_torch.server.snapshot import _cluster_via_rest
from opensim_tpu_torch.server.stubapi import StubApiServer
from opensim_tpu_torch.server.watch import RestWatchSource, WatchSupervisor
from opensim_tpu_torch.utils.procgroup import spawn_group, stop_group

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = {"stale_s": 5.0, "resync_s": 0.0, "reconnects": 3, "backoff_s": 0.02}
LOGGER = "opensim_tpu_torch.server.journal"

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


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("OPENSIM_FAULTS", raising=False)
    faults.clear_faults()
    yield
    faults.clear_faults()


def _pod_dict(name, phase="Pending", node="", cpu="100m", rv=None):
    d = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": cpu}}}]},
        "status": {"phase": phase},
    }
    if node:
        d["spec"]["nodeName"] = node
    if rv is not None:
        d["metadata"]["resourceVersion"] = str(rv)
    return d


def _seed(stub, n_nodes=4, pods=()):
    stub.seed("/api/v1/nodes", [fx.make_fake_node(f"n{i}", "8", "16Gi").raw for i in range(n_nodes)])
    stub.seed("/api/v1/pods", list(pods))
    for p in LIST_PATHS[2:]:
        stub.seed(p, [])


def _wait(pred, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


class _Obj:
    """What a checkpoint source hands the writer: objects with ``.raw``."""

    def __init__(self, raw):
        self.raw = raw


def _write_basic_journal(path, events=5, module=journal_mod):
    """A checkpoint (2 nodes) and `events` pod ADDEDs, cleanly closed, by
    `module`'s Journal (the port's or the JAX package's)."""
    j = module.Journal(path, policy={"fsync": "always"})
    j.record_checkpoint({"nodes": [fx.make_fake_node(f"n{i}", "8", "16Gi").raw for i in range(2)]}, generation=1,
                        resume_rvs={"nodes": "100", "pods": "100"}, why="test")
    for i in range(events):
        j.record_event("pods", "ADDED", _pod_dict(f"p{i}", rv=101 + i), 2 + i)
    j.close()
    return j


def _segment(jd):
    return os.path.join(jd, sorted(p for p in os.listdir(jd) if p.endswith(".seg"))[-1])


# ---------------------------------------------------------------------------
# framing, torn tails, corruption
# ---------------------------------------------------------------------------


def test_roundtrip_records_in_order(tmp_path):
    jd = str(tmp_path / "j")
    _write_basic_journal(jd, events=3)
    recs = list(iter_records(jd))
    assert [r["t"] for r in recs] == ["ck", "ev", "ev", "ev"]
    assert [r["gen"] for r in recs] == [1, 2, 3, 4]
    assert recs[0]["rvs"] == {"nodes": "100", "pods": "100"}
    assert recs[1]["o"]["metadata"]["name"] == "p0"


def test_torn_tail_truncated_loudly_on_reopen(tmp_path, caplog):
    jd = str(tmp_path / "j")
    _write_basic_journal(jd, events=3)
    with open(_segment(jd), "ab") as f:
        f.write(b"\x40\x00\x00\x00\xde\xad")  # a frame header promising 64 bytes
    with caplog.at_level("WARNING", logger=LOGGER):
        j = Journal(jd)
    assert any("torn tail" in r.message for r in caplog.records)
    j.record_event("pods", "ADDED", _pod_dict("late", rv=200), 10)
    j.close()
    assert [r["t"] for r in iter_records(jd)] == ["ck", "ev", "ev", "ev", "ev"]


def test_corruption_mid_stream_stops_replay_at_last_good_frame(tmp_path):
    jd = str(tmp_path / "j")
    _write_basic_journal(jd, events=4)
    seg = _segment(jd)
    size = os.path.getsize(seg)
    with open(seg, "r+b") as f:
        f.seek(size - 20)
        b = f.read(1)
        f.seek(size - 20)
        f.write(bytes([b[0] ^ 0xFF]))
    assert [r["t"] for r in iter_records(jd)] == ["ck", "ev", "ev", "ev"]
    state = Journal(jd, readonly=True).recover()
    assert state is not None and state.outcome == "restored"
    assert sorted(p["metadata"]["name"] for p in state.stores["pods"]) == ["p0", "p1", "p2"]


def test_recover_is_checkpoint_plus_suffix(tmp_path):
    jd = str(tmp_path / "j")
    _write_basic_journal(jd, events=3)
    state = Journal(jd, readonly=True).recover()
    assert state is not None
    assert (state.checkpoint_generation, state.generation, state.records_replayed) == (1, 4, 3)
    assert sorted(p["metadata"]["name"] for p in state.stores["pods"]) == ["p0", "p1", "p2"]
    assert len(state.stores["nodes"]) == 2
    assert state.resume_rvs == {"pods": "103", "nodes": "100"}


def test_recover_empty_journal_is_none(tmp_path):
    jd = str(tmp_path / "j")
    Journal(jd).close()
    assert Journal(jd, readonly=True).recover() is None


def test_events_without_checkpoint_degrade_to_relist(tmp_path, caplog):
    jd = str(tmp_path / "j")
    j = Journal(jd, policy={"fsync": "always"})
    j.record_event("pods", "ADDED", _pod_dict("p0", rv=1), 1)
    j.close()
    with caplog.at_level("WARNING", logger=LOGGER):
        assert Journal(jd, readonly=True).recover() is None
    assert any("no checkpoint" in r.message for r in caplog.records)


# ---------------------------------------------------------------------------
# rotation, checkpoint cadence, pruning
# ---------------------------------------------------------------------------


def _cadence_journal(jd, keep, fsync="always"):
    pods = {}

    def source():
        return ({"nodes": [_Obj(fx.make_fake_node("n0", "8", "16Gi").raw)], "pods": list(pods.values())},
                max(pods) if pods else 1, [])

    j = Journal(jd, policy={"fsync": fsync, "checkpoint_every": 5, "keep": keep})
    j.checkpoint_source = source
    for i in range(30):
        raw = _pod_dict(f"p{i}", rv=100 + i)
        pods[2 + i] = _Obj(raw)
        j.record_event("pods", "ADDED", raw, 2 + i)
        j.flush(timeout=10.0)
    j.close()


def test_checkpoint_cadence_rotates_and_prunes_old_segments(tmp_path):
    jd = str(tmp_path / "j")
    _cadence_journal(jd, keep=2)
    assert 2 <= len([p for p in os.listdir(jd) if p.endswith(".seg")]) <= 3
    state = Journal(jd, readonly=True).recover()
    assert state is not None and state.outcome == "restored" and state.generation == 31


def test_writer_queue_bound_drops_and_counts(tmp_path):
    jd = str(tmp_path / "j")
    j = Journal(jd, policy={"queue": 4, "fsync": "off"})
    for i in range(5000):
        j.record_event("pods", "ADDED", _pod_dict(f"p{i}", rv=i + 1), i + 1)
    with RECORDER.lock:
        dropped = j.dropped_total
    j.close()
    written = sum(1 for r in iter_records(jd) if r["t"] == "ev")
    assert written + dropped == 5000
    assert all(r["t"] in ("ev", "rb", "ck") for r in iter_records(jd))


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


def test_rebuild_twin_full_and_at_generation(tmp_path):
    jd = str(tmp_path / "j")
    _write_basic_journal(jd, events=4)
    twin, meta = rebuild_twin(jd)
    assert meta["events"] == 4 and meta["checkpoints"] == 1
    assert sorted(p.metadata.name for p in twin.materialize().pods) == ["p0", "p1", "p2", "p3"]
    assert twin.generation == 5
    twin3, _meta3 = rebuild_twin(jd, at_generation=3)
    assert sorted(p.metadata.name for p in twin3.materialize().pods) == ["p0", "p1"]
    assert twin3.generation == 3


def test_rebuild_twin_target_before_pruned_history_is_loud(tmp_path):
    jd = str(tmp_path / "j")
    _cadence_journal(jd, keep=1, fsync="off")
    assert min(int(r.get("gen") or 0) for r in iter_records(jd) if r["t"] == "ck") > 2
    with pytest.raises(JournalError, match="predates the retained history"):
        rebuild_twin(jd, at_generation=2)
    assert rebuild_twin(jd)[0].generation == 31


def test_replay_events_streams_and_matches_rebuild(tmp_path):
    jd = str(tmp_path / "j")
    _write_basic_journal(jd, events=4)
    twins = [t for _r, t, _c in replay_events(jd)]
    assert twins[-1].fingerprint() == rebuild_twin(jd)[0].fingerprint()


def test_replay_paced_respects_recorded_gaps(tmp_path, monkeypatch):
    class _Shim:
        monotonic = staticmethod(time.monotonic)
        sleep = staticmethod(time.sleep)
        _now = [1000.0]

        @classmethod
        def time(cls):
            return cls._now[0]

    monkeypatch.setattr(journal_mod, "time", _Shim)
    jd = str(tmp_path / "j")
    j = Journal(jd, policy={"fsync": "always"})
    j.record_checkpoint({"nodes": []}, generation=1, why="test")
    for i, name in enumerate(("a", "b", "c")):
        _Shim._now[0] = 1000.0 + i * 2.0  # 2 s recorded gaps
        j.record_event("pods", "ADDED", _pod_dict(name, rv=i + 1), 2 + i)
        j.flush(timeout=10.0)
    j.close()
    monkeypatch.undo()
    t0 = time.monotonic()
    assert sum(1 for _ in replay_events(jd, speed=20.0)) == 4
    assert 0.15 <= time.monotonic() - t0 <= 2.0  # two 2 s gaps at 20x
    t0 = time.monotonic()
    assert sum(1 for _ in replay_events(jd, speed=0.0)) == 4
    assert time.monotonic() - t0 < 0.5


def test_flush_fsyncs_promptly_even_with_fsync_off(tmp_path):
    jd = str(tmp_path / "j")
    j = Journal(jd, policy={"fsync": "off"})
    j.record_event("pods", "ADDED", _pod_dict("a", rv=1), 1)
    t0 = time.monotonic()
    assert j.flush(timeout=10.0) is True
    assert time.monotonic() - t0 < 5.0
    j.close()
    assert [r["t"] for r in iter_records(jd)] == ["ev"]


def test_replay_applies_mid_history_reanchor_checkpoints(tmp_path):
    jd = str(tmp_path / "j")
    j = Journal(jd, policy={"fsync": "always"})
    j.record_checkpoint({"pods": [_pod_dict("a", rv=1)]}, generation=1, why="bootstrap")
    j.record_event("pods", "ADDED", _pod_dict("b", rv=2), 2)
    j.record_checkpoint({"pods": [_pod_dict("a", rv=1), _pod_dict("b", rv=2), _pod_dict("c", rv=3)]},
                        generation=4, why="reanchor")
    j.record_event("pods", "ADDED", _pod_dict("d", rv=4), 5)
    j.close()
    final = None
    for _rec, twin, _change in replay_events(jd):
        final = twin
    assert sorted(p.metadata.name for p in final.materialize().pods) == ["a", "b", "c", "d"]
    assert rebuild_twin(jd)[0].fingerprint() == final.fingerprint()


def test_explicit_checkpoint_resets_cadence_no_back_to_back_duplicate(tmp_path):
    jd = str(tmp_path / "j")
    _write_basic_journal(jd, events=2)
    j = Journal(jd, policy={"fsync": "always"})
    j.checkpoint_source = lambda: ({"pods": [_Obj(_pod_dict("x", rv=50))]}, 9, [])
    j.record_checkpoint({"pods": [_pod_dict("x", rv=50)]}, generation=9, why="recovered")
    assert j.flush(timeout=10.0)
    j.close()
    cks = [r["why"] for r in iter_records(jd) if r["t"] == "ck"]
    assert cks.count("cadence") == 0, cks


# ---------------------------------------------------------------------------
# the two packages' journals: one format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_journal_of_either_package_replays_in_the_other(tmp_path, writer):
    """A journal written by one package (checkpoint, events, a rebase, a
    cadence checkpoint) is byte-identical to the other's for the same
    records, and reads in both: equal records, equal recovered state and
    equal ``rebuild_twin`` fingerprints, at the end and at a generation."""
    paths = {}
    for name, module in (("port", journal_mod), ("jax", ref_journal)):
        jd = str(tmp_path / name)
        j = module.Journal(jd, policy={"fsync": "always", "checkpoint_every": 3})
        pods = {}
        j.checkpoint_source = lambda pods=pods: ({"pods": [_Obj(d) for d in pods.values()]}, 100, [])
        j.record_checkpoint({"nodes": [fx.make_fake_node("n0", "8", "16Gi").raw]}, generation=1,
                            resume_rvs={"nodes": "5", "pods": "5"}, why="bootstrap")
        for i in range(4):
            d = _pod_dict(f"p{i}", phase="Running", node="n0", rv=10 + i)
            pods[i] = d
            j.record_event("pods", "ADDED", d, 2 + i, eid=f"e{i}", ts=1000.0 + i)
            j.flush(timeout=10.0)
        j.record_rebase("pods", [_pod_dict("p1", rv=11)], 9, rv="20", why="relist")
        j.close()
        paths[name] = jd
    names = sorted(os.listdir(paths["port"]))
    assert names == sorted(os.listdir(paths["jax"]))
    # every byte but the wall-clock stamps of the records the writers stamp
    drop_ts = lambda recs: [{k: v for k, v in r.items() if k != "ts"} for r in recs]
    assert drop_ts(iter_records(paths["port"])) == drop_ts(ref_journal.iter_records(paths["jax"]))
    jd = paths[writer]
    assert list(iter_records(jd)) == list(ref_journal.iter_records(jd))
    ours, theirs = Journal(jd, readonly=True).recover(), ref_journal.Journal(jd, readonly=True).recover()
    assert (ours.generation, ours.stores, ours.resume_rvs) == (theirs.generation, theirs.stores, theirs.resume_rvs)
    for gen in (None, 4):
        a, meta_a = rebuild_twin(jd, at_generation=gen)
        b, meta_b = ref_journal.rebuild_twin(jd, at_generation=gen)
        assert a.fingerprint() == b.fingerprint() and meta_a == meta_b


def test_simon_replay_summary_equals_the_jax_cli(tmp_path, monkeypatch):
    """``simon replay --capacity --schedule`` of the port (the plain scan on
    the CPU) and of the JAX package on one journal: the same summary but
    for the wall-clock fields."""
    monkeypatch.setenv("OPENSIM_DISABLE_NATIVE", "1")
    jd = str(tmp_path / "j")
    j = Journal(jd, policy={"fsync": "always"})
    j.record_checkpoint({"nodes": [fx.make_fake_node(f"n{i}", "4", "8Gi").raw for i in range(3)],
                         "pods": [_pod_dict("a", phase="Running", node="n0", cpu="1", rv=3)]},
                        generation=1, resume_rvs={"pods": "3"}, why="bootstrap")
    j.record_event("pods", "ADDED", _pod_dict("b", phase="Running", node="n1", cpu="2", rv=4), 2)
    j.record_event("pods", "DELETED", _pod_dict("a", phase="Running", node="n0", cpu="1", rv=5), 3)
    node = json.loads(json.dumps(fx.make_fake_node("n3", "4", "8Gi").raw))
    node["metadata"]["resourceVersion"] = "6"
    j.record_event("nodes", "ADDED", node, 4)
    j.close()
    argv = ["replay", jd, "--schedule", "6", "--events"]
    outs = []
    for run, extra in ((cli.main, ["--device", "cpu"]), (ref_cli.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run(argv + extra) == 0
        outs.append(buf.getvalue().strip().splitlines())
    assert outs[0][:-1] == outs[1][:-1]  # the --events lines
    ours, theirs = (json.loads(o[-1]) for o in outs)
    for summary in (ours, theirs):
        for key in ("wall_s", "events_per_s"):
            summary.pop(key)
        summary["schedule"].pop("wall_s")
    assert ours == theirs and ours["schedule"]["scheduled"] == 6 and ours["events"] == 3
    assert cli.main(["replay", str(tmp_path / "missing")]) == 1


# ---------------------------------------------------------------------------
# fault points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point", ["journal.write", "journal.fsync"])
def test_journal_writer_faults_degrade_loudly_without_crashing(tmp_path, caplog, point):
    jd = str(tmp_path / "j")
    j = Journal(jd, policy={"fsync": "always"})
    faults.inject(point, count=1, exc="fault")
    with caplog.at_level("WARNING", logger=LOGGER):
        j.record_event("pods", "ADDED", _pod_dict("a", rv=1), 1)
        _wait(lambda: any("degraded" in r.message for r in caplog.records), msg="writer degradation warning")
    j.record_event("pods", "ADDED", _pod_dict("b", rv=2), 2)  # the producer never throws
    j.close()
    assert faults.fault_stats().get(point) == 1


def test_journal_corrupt_fault_degrades_recovery_to_relist(tmp_path, caplog):
    jd = str(tmp_path / "j")
    _write_basic_journal(jd, events=2)
    j = Journal(jd, readonly=True)
    faults.inject("journal.corrupt", count=1, exc="fault")
    with caplog.at_level("WARNING", logger=LOGGER):
        assert j.recover() is None
    assert any("degrading to a full relist" in r.message for r in caplog.records)
    assert any('simon_journal_recoveries_total{outcome="corrupt"} 1' in ln for ln in j.metrics_lines())


def test_policy_validation_is_loud(monkeypatch):
    assert journal_policy() == ref_journal.journal_policy()
    monkeypatch.setenv("OPENSIM_JOURNAL_FSYNC", "sometimes")
    with pytest.raises(ValueError, match="OPENSIM_JOURNAL_FSYNC"):
        journal_policy()
    monkeypatch.setenv("OPENSIM_JOURNAL_FSYNC", "interval")
    monkeypatch.setenv("OPENSIM_JOURNAL_KEEP", "0")
    with pytest.raises(ValueError, match="OPENSIM_JOURNAL_KEEP"):
        journal_policy()
    monkeypatch.setenv("OPENSIM_JOURNAL_KEEP", "2")
    monkeypatch.setenv("OPENSIM_JOURNAL_FSYNC_S", "nope")
    with pytest.raises(ValueError, match="OPENSIM_JOURNAL_FSYNC_S"):
        journal_policy()


def test_timeline_restore_never_rewinds():
    tl = Timeline(capacity=8)
    tl.append(Sample(generation=10))
    tl.restore([Sample(generation=g) for g in (5, 9, 10, 12)])
    assert [s.generation for s in tl.snapshot()] == [10, 12]
    s = Sample(generation=13)
    s.utilization = {"cpu": 0.5}
    s.hottest = [("n0", {"cpu": 0.5, "memory": 0.1, "pods": 0.0})]
    d = Sample.from_dict(s.to_dict())
    assert d.generation == 13 and d.utilization["cpu"] == 0.5 and d.hottest[0][0] == "n0"


# ---------------------------------------------------------------------------
# crash recovery end to end: SIGKILL of simon server, restart on the journal
# ---------------------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _server(kc, jd, port, logfile):
    """The journaled server as the leader of its own process group, one
    intra-op thread; its output spooled to `logfile`, never a pipe, which
    nobody drains while it serves (a full pipe blocks its logging)."""
    with open(logfile, "w") as fh:
        return spawn_group(
            [sys.executable, "-m", "opensim_tpu_torch", "server", "--kubeconfig", kc, "--watch", "on", "--journal",
             jd, "--port", str(port), "--device", "cpu"],
            stdout=fh, stderr=subprocess.STDOUT, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO, OPENSIM_JOURNAL_FSYNC="always", OPENSIM_ADMISSION="off",
                     OMP_NUM_THREADS="1"),
        )


def _read(path):
    with open(path) as f:
        return f.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read().decode()


def _up(proc, port, logfile):
    def ready():
        if proc.poll() is not None:
            raise AssertionError(f"server died early: {_read(logfile)[-2000:]}")
        try:
            return _get(port, "/healthz") is not None
        except OSError:
            return False
    return ready


def test_sigkill_restart_recovers_from_checkpoint_and_suffix(tmp_path):
    """``simon server --watch on --journal`` of the port (``--device cpu``)
    SIGKILLed mid event storm: a restart on the same journal recovers from
    the checkpoint and the suffix (``simon_journal_recoveries_total
    {outcome="restored"}``, no relist), its reflectors resume and deliver
    what the crash missed, its twin answers as a polling server on the
    relisted cluster, and a SIGTERM then drains, flushes and exits 0 with
    the history recoverable."""
    stub = StubApiServer(bookmark_interval_s=0.1).start()
    _seed(stub, pods=[_pod_dict("seed", phase="Running", node="n0")])
    kc = stub.kubeconfig(tmp_path)
    jd, port = str(tmp_path / "journal"), _free_port()
    body = json.dumps({"deployments": [fx.make_fake_deployment("web", 3, "500m", "1Gi").raw]}).encode()
    first, second = str(tmp_path / "server-1.log"), str(tmp_path / "server-2.log")
    procs = [_server(kc, jd, port, first)]
    proc = procs[0]
    try:
        _wait(_up(proc, port, first), timeout=120.0, msg="journaled server to come up")
        for i in range(30):
            stub.upsert("/api/v1/pods", _pod_dict(f"storm-{i}", phase="Running", node=f"n{i % 4}", cpu="150m"))
            if i == 20:
                _wait(lambda: sum(1 for r in iter_records(jd) if r["t"] == "ev") >= 10,
                      msg="journal to absorb part of the storm")
                proc.kill()  # SIGKILL: no flush, no close
        proc.wait(timeout=30)
        stub.delete("/api/v1/pods", "storm-2")  # churn the crash missed
        on_disk = sum(1 for r in iter_records(jd) if r["t"] == "ev")
        assert on_disk >= 10
        want = {f"storm-{i}" for i in range(30)} - {"storm-2"} | {"seed"}
        fresh, _ = _cluster_via_rest(kc, None)
        assert {p.metadata.name for p in fresh.pods} == want
        lists0 = sum(1 for path, q in stub.requests_seen if "watch" not in q)
        proc = _server(kc, jd, port, second)
        procs.append(proc)
        _wait(_up(proc, port, second), timeout=120.0, msg="restart to come up from the journal")
        metrics = {}

        def converged():
            metrics.update(parse_metrics(_get(port, "/metrics")))
            return metrics.get(("simon_watch_events_total", (("kind", "DELETED"), ("resource", "pods"))), 0) >= 1
        _wait(converged, msg="the resumed stream to deliver the missed delete")
        assert metrics[("simon_journal_recoveries_total", (("outcome", "restored"),))] == 1
        assert metrics[("simon_watch_relists_total", ())] == 0
        assert sum(1 for path, q in stub.requests_seen if "watch" not in q) == lists0  # no list at all
        req = urllib.request.Request(f"http://127.0.0.1:{port}/api/deploy-apps", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.load(r)
        from opensim_tpu_torch.server import rest

        code, ref = rest.SimonServer(kubeconfig=kc, device="cpu", admission=False).deploy_apps(json.loads(body))
        strip = lambda a: sorted((e["node"], len(e["pods"])) for e in a["nodeStatus"])
        assert code == 200 and strip(answer) == strip(ref) and answer["unscheduledPods"] == []
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        out = _read(second)
        assert proc.returncode == 0 and "shutdown complete" in out, out[-2000:]
        twin, _meta = rebuild_twin(jd)
        assert twin.fingerprint() == fingerprint_cluster(fresh)
        assert ref_journal.rebuild_twin(jd)[0].fingerprint() == twin.fingerprint()
    finally:
        for p in procs:
            stop_group(p, timeout_s=0.0)
        stub.stop()


def test_restored_supervisor_resumes_the_capacity_timeline(tmp_path):
    """A supervisor restored from a journal whose checkpoint carries
    capacity samples resumes the timeline with monotonic generations and
    feeds the capacity view from its events."""
    stub = StubApiServer(bookmark_interval_s=0.1).start()
    _seed(stub, pods=[_pod_dict("seed", phase="Running", node="n0")])
    kc = stub.kubeconfig(tmp_path)
    jd = str(tmp_path / "journal")
    sup = WatchSupervisor(RestWatchSource(kc, read_timeout_s=5.0), policy=FAST,
                          journal=Journal(jd, policy={"fsync": "always"}))
    sup.capacity = CapacityEngine()
    sup2 = None
    try:
        assert sup.start(wait_s=15.0)
        sup.capacity.sample()
        stub.upsert("/api/v1/pods", _pod_dict("late", phase="Running", node="n1", cpu="2"))
        _wait(lambda: len(sup.twin.materialize().pods) == 2, msg="event applied")
        sup.capacity.sample()
        sup._checkpoint_now("samples")
        sup.stop()
        sup.journal.close()
        sup2 = WatchSupervisor(RestWatchSource(kc, read_timeout_s=5.0), policy=FAST,
                               journal=Journal(jd, policy={"fsync": "always"}))
        sup2.capacity = CapacityEngine()
        assert sup2.start(wait_s=15.0)
        assert sup2.twin.fingerprint() == sup.twin.fingerprint()
        assert sup2.capacity.event_fed and sup2.capacity.sample().pods_bound == 2
        gens = [s.generation for s in sup2.capacity.timeline.snapshot()]
        assert len(gens) >= 2 and gens == sorted(set(gens))
    finally:
        sup.stop()
        if sup2 is not None:
            sup2.stop()
            sup2.journal.close()
        stub.stop()
