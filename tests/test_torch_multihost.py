"""Ranks through ``torch.distributed`` (``opensim_tpu_torch/parallel/
multihost.py`` and the rank split of ``parallel/scenarios.sweep_auto``):
the port's counterparts of tests/test_multihost.py's two cases, run as two
CPU processes that join a Gloo group through the JAX_COORDINATOR /
JAX_NUM_PROCESSES / JAX_PROCESS_ID variables, each under a time limit of
its own; then the single-process contract of ``initialize()`` and the rank
rows of ragged scenario counts, ranks played by threads.

The two-process sweep must equal the closed form and the JAX package's
single-process sweep on the same masks: unscheduled counts, placements by
index and final usage identical, VG usage to rtol=1e-5 (a float32 sum in
another order, as tests/test_torch_sweep.py holds it); against the port's
own unsplit sweep every output is identical."""

import datetime
import inspect
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch.distributed as dist

from opensim_tpu.parallel import scenarios as ref_scenarios
from opensim_tpu_torch.engine import fastpath, simulator as sim
from opensim_tpu_torch.models import ResourceTypes
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.parallel import multihost, scenarios
from opensim_tpu_torch.utils import envknobs
from test_torch_sweep import _assert_sweeps_equal, _preps, _setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
CHILD_TIMEOUT_S = 120

#: tests/test_multihost.py:33-48's cluster and scenarios through the port:
#: 6 nodes of 8 cpu, 10 pods of 2 cpu, scenario s enabling the first
#: min(s + 1, 6) nodes; then the ragged counts S = 1 and 3 through the
#: same ranks. Each rank saves what it got and the rows it swept.
_SWEEP_CHILD = r"""
import sys
import numpy as np

{sweep_case}

assert multihost.initialize(), "JAX_COORDINATOR not picked up"
assert multihost.process_count() == 2, multihost.process_count()
swept = []
real = fastpath.sweep


def counted(prep, node_valid_masks, *args, **kw):
    swept.append(len(node_valid_masks))
    return real(prep, node_valid_masks, *args, **kw)


fastpath.sweep = counted
prep, node_valid, pod_valid = sweep_case()
out = {}
for S in (8, 1, 3):
    res = scenarios.sweep_auto(prep, node_valid[:S], pod_valid[:S])
    out.update({f"{f}_{S}": v for f, v in zip(res._fields, res)})
np.savez(sys.argv[1], swept=np.array(swept), rank=multihost.process_index(), **out)
"""

#: tests/test_multihost.py:110-164's capacity plan through the port's
#: Applier on the CPU: 2 nodes of 8 cpu, 20 pods of 2 cpu, new nodes of 8.
_PLANNER_CHILD = r"""
import os, sys
import yaml

from opensim_tpu_torch.parallel import multihost
from opensim_tpu_torch.planner.apply import Applier, Options

base = sys.argv[1]
for d in ("cluster", "app", "newnode"):
    os.makedirs(f"{base}/{d}", exist_ok=True)


def node(name):
    return {
        "apiVersion": "v1", "kind": "Node",
        "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
        "status": {"allocatable": {"cpu": "8", "memory": "32Gi", "pods": "110"},
                   "capacity": {"cpu": "8", "memory": "32Gi", "pods": "110"}},
    }


for i in range(2):
    open(f"{base}/cluster/n{i}.yaml", "w").write(yaml.safe_dump(node(f"n{i}")))
open(f"{base}/newnode/tmpl.yaml", "w").write(yaml.safe_dump(node("tmpl")))
open(f"{base}/app/d.yaml", "w").write(yaml.safe_dump({
    "apiVersion": "apps/v1", "kind": "Deployment",
    "metadata": {"name": "web"},
    "spec": {"replicas": 20, "selector": {"matchLabels": {"app": "web"}},
             "template": {"metadata": {"labels": {"app": "web"}},
                          "spec": {"containers": [{"name": "c", "image": "x",
                                   "resources": {"requests": {"cpu": "2", "memory": "2Gi"}}}]}}},
}))
open(f"{base}/config.yaml", "w").write(yaml.safe_dump({
    "apiVersion": "simon/v1alpha1", "kind": "Config",
    "metadata": {"name": "mh"},
    "spec": {"cluster": {"customConfig": f"{base}/cluster"},
             "appList": [{"name": "a", "path": f"{base}/app"}],
             "newNode": f"{base}/newnode"},
}))
applier = Applier(Options(simon_config=f"{base}/config.yaml", output_file=f"{base}/report.txt", max_new_nodes=16,
                          device="cpu"))
rc = applier.run()  # joins the job itself
assert multihost.process_count() == 2, multihost.process_count()
print("SWEEPS:" + repr([ks for ks, _s in applier.sweeps]))
print("RC:" + str(rc))
"""


def sweep_case():
    """The port's prepared input and masks of the two-process sweep (its
    source runs in the ranks too)."""
    cluster = ResourceTypes()
    for i in range(6):
        cluster.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi"))
    app = ResourceTypes()
    app.deployments.append(fx.make_fake_deployment("web", 10, "2", "2Gi"))
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], device="cpu")
    N, P, S = len(prep.meta.node_names), len(prep.ordered), 8
    node_valid = np.zeros((S, N), bool)
    for s in range(S):
        node_valid[s, : min(s + 1, 6)] = True
    return prep, node_valid, np.ones((S, P), bool)


def _with_case(script: str) -> str:
    """`script` with :func:`sweep_case`'s imports and source in place of
    ``{sweep_case}``."""
    imports = ("from opensim_tpu_torch.engine import fastpath, simulator as sim\n"
               "from opensim_tpu_torch.models import ResourceTypes, fixtures as fx\n"
               "from opensim_tpu_torch.parallel import multihost, scenarios\n\n")
    return script.replace("{sweep_case}", imports + inspect.getsource(sweep_case))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(script: str, args, check: bool = True) -> list:
    """Two children of `script` as ranks 0 and 1 of a job on a free port,
    each under CHILD_TIMEOUT_S; a job whose coordinator's port was taken
    meanwhile runs once more on another. Returns each child's exit code
    and output; with `check`, both must exit 0."""
    for attempt in range(2):
        port = _free_port()
        procs = []
        for rank in range(2):
            env = {k: v for k, v in os.environ.items() if k not in LAUNCH}
            env.update(JAX_COORDINATOR=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO)
            procs.append(subprocess.Popen([sys.executable, "-c", script, str(args[rank])], env=env, cwd=REPO,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            pytest.fail(f"a rank ran past its {CHILD_TIMEOUT_S} s limit")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if attempt == 0 and any("EADDRINUSE" in out or "address already in use" in out.lower() for out in outs):
            continue
        break
    for p, out in zip(procs, outs):
        assert p.returncode == 0 or not check, f"a rank failed:\n{out[-3000:]}"
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def test_two_process_sweep(tmp_path):
    """tests/test_multihost.py:60's two-process sweep through the port:
    each rank sweeps its half of the 8 scenarios (and of the padded S = 1
    and 3), and both hold the whole gathered result, equal to the closed
    form, to the JAX package's single-process sweep and to the port's
    unsplit sweep."""
    paths = [tmp_path / f"rank{r}.npz" for r in range(2)]
    _run_ranks(_with_case(_SWEEP_CHILD), paths)
    got = [dict(np.load(p)) for p in paths]
    assert [int(g["rank"]) for g in got] == [0, 1]
    assert [g["swept"].tolist() for g in got] == [[4, 1, 2]] * 2  # 8 / 2, then S = 1 and 3 padded to 2 and 4
    for key in got[0]:
        if key not in ("rank", "swept"):
            np.testing.assert_array_equal(got[1][key], got[0][key], err_msg=key)

    want_unscheduled = [10 - min(4 * min(s + 1, 6), 10) for s in range(8)]
    assert got[0]["unscheduled_8"].tolist() == want_unscheduled

    prep, node_valid, pod_valid = sweep_case()
    ref, _port = _preps(*_setup(n_nodes=6, replicas=10))
    want = ref_scenarios.sweep(ref.ec, ref.st0, ref.tmpl_ids, ref.forced, node_valid, pod_valid,
                               features=ref.features)
    fields = scenarios.SweepResult._fields
    _assert_sweeps_equal(tuple(got[0][f"{f}_8"] for f in fields), want)
    for S in (8, 1, 3):
        unsplit = scenarios.sweep_auto(prep, node_valid[:S], pod_valid[:S])
        for f, v in zip(fields, unsplit):
            np.testing.assert_array_equal(got[0][f"{f}_{S}"], v, err_msg=f"{f}, S = {S}")


def test_two_process_capacity_planner(tmp_path):
    """tests/test_multihost.py:168's capacity planner through the port:
    two ``Applier.run()`` ranks on the CPU each add 3 new nodes (40 cpu
    asked, 16 present, 8 a new node) from the same two sweeps."""
    dirs = [tmp_path / f"p{r}" for r in range(2)]
    for (_rc, out), d in zip(_run_ranks(_PLANNER_CHILD, dirs), dirs):
        assert "RC:0" in out.splitlines(), out[-2000:]
        assert "SWEEPS:[[0, 1, 2, 4, 8, 16], [3]]" in out.splitlines(), out[-2000:]
        assert "(added 3 new node(s))" in (d / "report.txt").read_text()


#: Rank 1 joins, then fails or stalls past a short group timeout; rank 0's
#: sweep waits in the gather for it.
_BROKEN_CHILD = r"""
import sys, time
import numpy as np

{sweep_case}

multihost.TIMEOUT_S = 2.0
assert multihost.initialize()
if multihost.process_index() == 1:
    if sys.argv[1] == "fails":
        raise SystemExit("rank 1 fails")
    time.sleep(10)
    raise SystemExit(0)
scenarios.sweep_auto(*sweep_case())
"""


@pytest.mark.parametrize("how", ["fails", "stalls"])
def test_a_broken_rank_ends_the_job(how):
    """A rank that fails ends the other's gather at once (the peer's
    connection closes); one that stalls, after the group's timeout:
    with an error, not a hang."""
    (rc0, out0), (rc1, _out1) = _run_ranks(_with_case(_BROKEN_CHILD), [how, how], check=False)
    assert rc0 != 0 and rc1 == (1 if how == "fails" else 0)
    assert ("Connection closed by peer" if how == "fails" else "Timed out") in out0, out0[-2000:]


@pytest.fixture
def no_launch_vars(monkeypatch):
    for name in LAUNCH:
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


def _refuse_joining(*_args, **_kw):
    raise AssertionError("init_process_group called again")


def test_initialize_without_variables_joins_nothing(no_launch_vars):
    assert multihost.initialize() is False
    assert not dist.is_initialized()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    a = np.arange(6, dtype=np.int32)
    assert multihost.allgather(a) is a
    assert multihost.global_mesh() == scenarios.default_mesh()  # the local devices; None on the CPU


def test_initialize_joins_once_from_the_variables(no_launch_vars):
    no_launch_vars.setenv("JAX_COORDINATOR", f"127.0.0.1:{_free_port()}")
    no_launch_vars.setenv("JAX_NUM_PROCESSES", "1")
    no_launch_vars.setenv("JAX_PROCESS_ID", "0")
    assert multihost.initialize() is True
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    no_launch_vars.setattr(multihost.dist, "init_process_group", _refuse_joining)
    assert multihost.initialize() is True  # the planner calls it on every run


def test_initialize_honours_a_callers_group(no_launch_vars, tmp_path):
    """A group the caller initialised (here one process over a file store)
    is used as it is: no second join, and a sweep over one rank is the
    unsplit sweep."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=30))
    no_launch_vars.setattr(multihost.dist, "init_process_group", _refuse_joining)
    assert multihost.initialize("127.0.0.1:1") is True
    assert multihost.process_count() == 1
    prep, node_valid, pod_valid = sweep_case()
    got = scenarios.sweep_auto(prep, node_valid, pod_valid)
    assert got.unscheduled.tolist() == [10 - min(4 * min(s + 1, 6), 10) for s in range(8)]


def test_initialize_refuses_a_rank_outside_the_job(no_launch_vars):
    with pytest.raises(ValueError, match="not a rank"):
        multihost.initialize("127.0.0.1:1", num_processes=2, process_id=2)
    assert not dist.is_initialized()


def test_launch_variables_read_through_the_registry(monkeypatch):
    """The reference's three launch variables are registered under their
    own names, apart from the OPENSIM_* knobs."""
    assert set(envknobs.LAUNCH) == set(LAUNCH) and not set(envknobs.LAUNCH) & set(envknobs.KNOBS)
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    assert envknobs.raw("JAX_PROCESS_ID", "0") == "3"
    assert all(knob.doc for knob in envknobs.LAUNCH.values())


class _ThreadRanks:
    """Ranks played by threads of one process: each thread's rank, and an
    all-gather that meets at a barrier (the process group's contract)."""

    def __init__(self, n: int) -> None:
        self.n, self.local, self.slots = n, threading.local(), [None] * n
        self.barrier = threading.Barrier(n, timeout=60)

    def allgather(self, a):
        self.slots[self.local.rank] = a
        self.barrier.wait()
        out = np.concatenate(self.slots)
        self.barrier.wait()
        return out


@pytest.mark.parametrize("ranks,S", [(2, 1), (3, 2), (2, 5), (4, 7), (3, 6)])
def test_rank_rows_join_back(monkeypatch, ranks, S):
    """S = 1, S below the number of ranks, S odd, a last rank of padding
    only: every rank sweeps its padded contiguous rows and ends holding
    the unsplit result."""
    cluster, app = _setup(n_nodes=6, replicas=16)
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], device="cpu")
    N, P = len(prep.meta.node_names), len(prep.ordered)
    node_valid = np.arange(N)[None, :] <= (np.arange(S)[:, None] % N)
    pod_valid = np.ones((S, P), dtype=bool)
    want = scenarios.sweep_auto(prep, node_valid, pod_valid)

    group, swept, got, errors = _ThreadRanks(ranks), {}, {}, []
    real = fastpath.sweep

    def counted(prep, node_valid_masks, *args, **kw):
        swept[group.local.rank] = node_valid_masks.copy()
        return real(prep, node_valid_masks, *args, **kw)

    monkeypatch.setattr(multihost, "process_index", lambda: group.local.rank)
    monkeypatch.setattr(multihost, "process_count", lambda: ranks)
    monkeypatch.setattr(multihost, "allgather", group.allgather)
    monkeypatch.setattr(fastpath, "sweep", counted)

    def rank_main(r):
        group.local.rank = r
        try:
            got[r] = scenarios.sweep_auto(prep, node_valid, pod_valid)
        except BaseException as e:  # surfaced below, after every thread has ended
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    per = -(-S // ranks)
    padded = np.concatenate([node_valid, np.repeat(node_valid[-1:], per * ranks - S, axis=0)])
    for r in range(ranks):
        np.testing.assert_array_equal(swept[r], padded[r * per:(r + 1) * per])
        for f, a, b in zip(scenarios.SweepResult._fields, got[r], want):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}: {f}")
