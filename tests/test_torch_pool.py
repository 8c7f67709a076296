"""The port's worker pool (``server/pool.py``) on the CPU, the cases of
tests/test_pool.py: the fork probe brings process mode up (and a platform
without fork, or a probe that answers wrong, falls back to threads),
unpicklable tasks run on threads, and a worker forked after the parent's
warm prepare schedules over the inherited Prepared, placing what the
parent places and what the JAX package places. Besides, the refusal of
process mode on a card: a forked child cannot use its parent's CUDA
context, so the pool, and a server on a card, raise at start."""

import multiprocessing

import numpy as np
import pytest
import torch

from opensim_tpu.engine.simulator import AppResource as RefAppResource, simulate as ref_simulate
from opensim_tpu.models import ResourceTypes as RefResourceTypes, fixtures as ref_fx
from opensim_tpu_torch.engine import fastpath
from opensim_tpu_torch.engine.simulator import AppResource, prepare
from opensim_tpu_torch.models import ResourceTypes, fixtures as fx
from opensim_tpu_torch.server import pool as pool_mod
from opensim_tpu_torch.server import rest
from opensim_tpu_torch.server.pool import WorkerPool

# module-level state the forked workers inherit copy-on-write, built lazily
_PREP = None


def _cluster(f, rt_cls):
    rt = rt_cls()
    for i in range(4):
        rt.nodes.append(f.make_fake_node(f"n{i:02d}", "16", "64Gi"))
    rt.pods.append(f.make_fake_pod("seed", "100m", "128Mi", f.with_node_name("n00")))
    app = rt_cls()
    app.add(f.make_fake_deployment("cow", 3, "500m", "1Gi"))
    return rt, app


def _build_prep():
    global _PREP
    if _PREP is None:
        rt, app = _cluster(fx, ResourceTypes)
        _PREP = prepare(rt, [AppResource("deploy", app)], device="cpu")
    return _PREP


def _schedule(prep) -> list:
    built = fastpath.build_inputs(prep)
    return [int(c) for c in fastpath.schedule(prep, [(built, 0, len(prep.ordered))]).chosen]


def _cow_schedule() -> list:
    """Runs in a forked worker: schedule the parent's Prepared with the
    plain scan (module-level, so it pickles by reference); one torch
    thread, so no thread pool forked mid-use is entered."""
    torch.set_num_threads(1)
    assert _PREP is not None, "fork did not inherit the parent's Prepared"
    return _schedule(_PREP)


def _probe_ok() -> str:
    return "alive"


def _fork_available() -> bool:
    return "fork" in multiprocessing.get_all_start_methods()


def _process_pool() -> WorkerPool:
    if not _fork_available():  # pragma: no cover - non-posix
        pytest.skip("fork start method unavailable")
    p = WorkerPool(workers=2, mode="process")
    if p.mode != "process":  # pragma: no cover - wedged platform
        p.shutdown()
        pytest.skip("process pool probe failed on this platform")
    return p


def test_probe_brings_up_process_mode_and_executes():
    p = _process_pool()
    try:
        assert p.submit(_probe_ok).result(timeout=60.0) == "alive"
    finally:
        p.shutdown()


def test_no_fork_platform_falls_back_to_threads(monkeypatch):
    monkeypatch.setattr(multiprocessing, "get_all_start_methods", lambda: ["spawn"])
    p = WorkerPool(workers=2, mode="process")
    try:
        assert p.mode == "thread"
        assert p.submit(_probe_ok).result(timeout=30.0) == "alive"
    finally:
        p.shutdown()


def test_probe_failure_falls_back_to_threads(monkeypatch):
    """A forked child that answers the probe wrong demotes the pool to
    threads at start."""
    if not _fork_available():  # pragma: no cover - non-posix
        pytest.skip("fork start method unavailable")
    monkeypatch.setattr(pool_mod, "_probe", lambda: -1)  # the child inherits the patch
    p = WorkerPool(workers=2, mode="process")
    try:
        assert p.mode == "thread"
    finally:
        p.shutdown()


def test_unpicklable_task_runs_on_threads():
    p = _process_pool()
    try:
        captured = []  # a closure: unpicklable

        def task():
            captured.append(1)
            return "threads"

        assert p.submit(task).result(timeout=30.0) == "threads"
        assert captured == [1]  # ran in this process
        assert p._warned_unpicklable
    finally:
        p.shutdown()


def test_cow_prepare_inheritance_serves_a_request():
    """A worker forked after the parent's warm prepare schedules over the
    inherited Prepared: no re-prepare, the parent's placements, which are
    the JAX package's."""
    prep = _build_prep()
    expected = _schedule(prep)
    ref_rt, ref_app = _cluster(ref_fx, RefResourceTypes)
    ref = ref_simulate(ref_rt, [RefAppResource("deploy", ref_app)])
    ref_nodes = sorted(ns.node.metadata.name for ns in ref.node_status for _p in ns.pods)
    names = prep.meta.node_names
    assert sorted(names[c] for c in np.asarray(expected) if c >= 0) == ref_nodes
    p = _process_pool()  # after the prepare: the workers inherit it
    try:
        assert p.submit(_cow_schedule).result(timeout=120.0) == expected
    finally:
        p.shutdown()


def test_process_mode_is_refused_on_a_card(monkeypatch):
    """On a CUDA device process mode raises, naming why: in the pool, and
    at a server's start (its device monkeypatched to a card)."""
    with pytest.raises(RuntimeError, match="fork"):
        WorkerPool(workers=2, mode="process", device=torch.device("cuda"))
    monkeypatch.setenv("OPENSIM_WORKERS_MODE", "process")
    monkeypatch.setattr(rest, "resolve_device", lambda device: torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA context"):
        rest.SimonServer(base_cluster=fx.admission_cluster())
    monkeypatch.setenv("OPENSIM_WORKERS_MODE", "thread")
    server = rest.SimonServer(base_cluster=fx.admission_cluster())
    try:
        assert server.admission._pool.mode == "thread"
    finally:
        server.close()
