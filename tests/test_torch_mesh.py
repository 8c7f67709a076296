"""The scenario axis split over a list of devices
(``opensim_tpu_torch/engine/fastpath.sweep(devices=)`` under
``parallel/scenarios.sweep_auto``) against the JAX
package's sweep sharded over its 8 virtual CPU devices
(tests/conftest.py), and against the port's own unsplit sweep. On the CPU
a mesh is ``[torch.device("cpu")] * k``: every shard runs the plain
version, so these tests hold the padding, the cut into contiguous shards
and the join in scenario order; shards on distinct cards run on the card
only. Unscheduled counts, placements and final usage must be identical;
VG usage against the JAX package to rtol=1e-5 (a float32 sum in another
order, as tests/test_torch_sweep.py holds it), against the unsplit sweep
exactly."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from opensim_tpu.engine import simulator as ref_sim
from opensim_tpu.parallel import scenarios as ref_scenarios
from opensim_tpu.planner import defrag as ref_defrag
from opensim_tpu_torch.engine import fastpath, schedconfig, simulator as sim
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.parallel import scenarios
from opensim_tpu_torch.planner import defrag
from test_torch_sweep import _assert_sweeps_equal, _local_with_bound_pods, _preps, _reference_copy, _setup

CPU = torch.device("cpu")


@pytest.fixture
def shards(monkeypatch):
    """The (device, scenario count) of every shard placed, in order."""
    seen = []
    real = fastpath.sweep_inputs

    def place(prep, node_valid_masks, *args, device=None):
        seen.append((torch.device(device) if device is not None else prep.device, len(node_valid_masks)))
        return real(prep, node_valid_masks, *args, device=device)

    monkeypatch.setattr(fastpath, "sweep_inputs", place)
    return seen


def _assert_identical(got, want):
    for field in scenarios.SweepResult._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def test_split_over_eight_cpu_entries_matches_the_sharded_reference(shards):
    """tests/test_parallel.py:22-41 through the port: S = 6 over eight
    entries, so two shards hold only padding, against the JAX package's
    sweep sharded over its eight virtual devices."""
    ref, port = _preps(*_setup(n_nodes=6, replicas=16))
    mesh = ref_scenarios.default_mesh()
    assert mesh is not None and mesh.devices.size == len(jax.devices()) == 8
    N, P, S = len(port.meta.node_names), len(port.ordered), 6
    node_valid = np.arange(N)[None, :] <= np.arange(S)[:, None]  # scenario s enables s + 1 nodes
    pod_valid = np.ones((S, P), dtype=bool)
    want = ref_scenarios.sweep(ref.ec, ref.st0, ref.tmpl_ids, ref.forced, node_valid, pod_valid,
                               mesh=mesh, features=ref.features)
    got = scenarios.sweep_auto(port, node_valid, pod_valid, mesh=[CPU] * 8)
    assert shards == [(CPU, 1)] * 8
    assert got.unscheduled.tolist() == [12, 8, 4, 0, 0, 0]
    _assert_sweeps_equal(got, want)


def _drain_cluster(n_nodes=5):
    """n nodes, a Deployment, and a pod bound by name to each node, which a
    drain of that node releases (a per-scenario forced mask)."""
    cluster, app = _setup(n_nodes=n_nodes, replicas=12)
    for j in range(n_nodes):
        cluster.pods.append(fx.make_fake_pod(f"bound-{j}", "3", "4Gi", fx.with_node_name(f"n{j}")))
    return cluster, app


_CFG = schedconfig.SchedulerConfig(w_least=3.0, w_simon=0.1, w_gpu_share=0.6)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("case", ["drain", "local", "config"])
def test_split_equals_unsplit_for_ragged_s(shards, case, k):
    """S = 7 over 2 and 3 entries (a last shard padded by repeating the
    last scenario): the split sweep equals the unsplit one field for field,
    on drain masks with per-scenario forced pods (the defrag input), on an
    all-local-PV case (VG usage counted per shard) and under one effective
    scheduler config (the cfg grid)."""
    cluster, app = _local_with_bound_pods() if case == "local" else _drain_cluster()
    port = sim.prepare(cluster, [sim.AppResource("a", app)], device="cpu")
    n, S = len(port.meta.node_names), 7
    node_valid, pod_valid, forced = defrag.drain_masks(port, [s % n for s in range(S)])
    config = _CFG if case == "config" else None
    if case != "local":
        assert not (forced == forced[:1]).all()  # the drains release pods of their own
    want = scenarios.sweep_auto(port, node_valid, pod_valid, forced_masks=forced, config=config)
    assert shards == [(CPU, S)]
    got = scenarios.sweep_auto(port, node_valid, pod_valid, forced_masks=forced, config=config, mesh=[CPU] * k)
    per = -(-S // k)
    assert shards[1:] == [(CPU, per)] * k
    _assert_identical(got, want)
    assert got.chosen.shape == (S, len(port.ordered)) and (got.unscheduled >= 0).all()
    if case == "local":
        assert port.features.local and (got.vg_used > 0).all()


def test_a_config_split_equals_the_reference_config_sweep():
    """The cfg grid split over three entries against the JAX package's
    sweep_auto under the same config (its sharded XLA sweep)."""
    from opensim_tpu.engine import schedconfig as ref_sc

    ref, port = _preps(*_drain_cluster())
    nv, pv, fm = defrag.drain_masks(port, [s % 5 for s in range(7)])
    want = ref_scenarios.sweep_auto(ref, nv, pv, forced_masks=fm, config=ref_sc.SchedulerConfig(**_CFG._asdict()))
    got = scenarios.sweep_auto(port, nv, pv, forced_masks=fm, config=_CFG, mesh=[CPU] * 3)
    _assert_sweeps_equal(got, want)


def test_a_two_profile_stream_ignores_the_mesh(tmp_path, shards):
    """Differing profiles run the segmented sweep on ``prep.device``
    whatever the mesh, as the reference's segmented path takes none."""
    path = fx.write_scheduler_config(tmp_path / "two.yaml", fx.SCHED_TWO_PROFILES)
    config = schedconfig.load_scheduler_config(path)
    port = sim.prepare(fx.synthetic_cluster(8), [sim.AppResource(n, a) for n, a in fx.two_profile_apps(40)],
                       device="cpu")
    segments, _invalid = schedconfig.resolve_profile_segments(config, port.ordered, port.meta.resource_names,
                                                              forced=port.forced)
    assert len(segments) == 2
    node_valid, pod_valid, forced = defrag.drain_masks(port, [0, 3, 5])
    want = scenarios.sweep_auto(port, node_valid, pod_valid, forced_masks=forced, config=config)
    got = scenarios.sweep_auto(port, node_valid, pod_valid, forced_masks=forced, config=config, mesh=[CPU] * 2)
    assert shards == [(CPU, 3), (CPU, 3)]  # one unsplit sweep each
    _assert_identical(got, want)


def _cards(monkeypatch, count):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


def test_default_mesh_and_the_devices_a_sweep_splits_over(monkeypatch):
    """None on the CPU and on one card; every card when there are several,
    for a prepared input on ``cuda`` named without an index; a card named
    by index, or the CPU, runs alone (``[prep.device]``); an explicit mesh
    is taken as given."""
    on = lambda device: types.SimpleNamespace(device=torch.device(device))
    _cards(monkeypatch, 0)
    assert scenarios.default_mesh() is None and scenarios.mesh_of(on("cpu")) == [CPU]
    _cards(monkeypatch, 1)
    assert scenarios.default_mesh() is None and scenarios.mesh_of(on("cuda")) == [torch.device("cuda")]
    _cards(monkeypatch, 2)
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert scenarios.default_mesh() == two
    assert scenarios.mesh_of(on("cuda")) == two
    assert scenarios.mesh_of(on("cuda:1")) == [torch.device("cuda", 1)]
    assert scenarios.mesh_of(on("cpu")) == [CPU]
    assert scenarios.mesh_of(on("cuda:1"), ["cuda:0", "cuda:0"]) == [torch.device("cuda", 0)] * 2
    for bad in (object(), [], ["no-such-device"]):
        with pytest.raises(ValueError, match="mesh"):
            scenarios.mesh_of(on("cpu"), bad)


def test_a_failing_shard_raises_and_nothing_falls_back(shards):
    """A shard whose launch fails raises out of the sweep: here the second
    entry is a device no kernel and no plain version runs on."""
    port = _preps(*_setup(n_nodes=3, replicas=4))[1]
    nv, pv, fm = defrag.drain_masks(port, [0, 1, 2])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        scenarios.sweep_auto(port, nv, pv, fm, mesh=[CPU, torch.device("meta")])
    assert [d.type for d, _s in shards] == ["cpu", "meta"]


@pytest.mark.parametrize("setup", ["light", "tight", "prebound"])
def test_plan_drains_over_a_cpu_mesh_matches_reference(monkeypatch, shards, setup):
    """plan_drains() with its sweep split over three CPU entries (routed
    through a patched mesh_of) gives the JAX package's plans."""
    cluster, app = _setup(n_nodes=3, replicas={"light": 3, "tight": 12, "prebound": 0}[setup])
    if setup == "prebound":
        cluster.pods.append(fx.make_fake_pod("pinned", "1", "1Gi", fx.with_node_name("n0")))
    monkeypatch.setattr(scenarios, "mesh_of", lambda prep, mesh=None: [CPU] * 3)
    want = ref_defrag.plan_drains(_reference_copy(cluster), [ref_sim.AppResource("a", _reference_copy(app))])
    got = defrag.plan_drains(cluster, [sim.AppResource("a", app)], device="cpu")
    assert shards == [(CPU, 1)] * 3
    assert [dataclasses.asdict(p) for p in got.plans] == [dataclasses.asdict(p) for p in want.plans]


def test_sweep_counts_over_a_cpu_mesh_matches_reference(monkeypatch, shards):
    """sweep_counts() split over two CPU entries (five counts: the last
    shard padded) against the JAX package's, which shards over its eight
    virtual devices."""
    cluster, app = _setup(n_nodes=6, replicas=14)
    cluster.daemon_sets.append(fx.make_fake_daemon_set("agent", "100m", "128Mi"))
    ref, port = _preps(cluster, app)
    monkeypatch.setattr(scenarios, "mesh_of", lambda prep, mesh=None: [CPU] * 2)
    ks = [0, 1, 2, 3, 4]
    want, want_nv = ref_scenarios.sweep_counts(ref, 2, ks)
    got, got_nv = scenarios.sweep_counts(port, 2, ks)
    assert shards == [(CPU, 3)] * 2
    np.testing.assert_array_equal(got_nv, want_nv)
    _assert_sweeps_equal(got, want)
