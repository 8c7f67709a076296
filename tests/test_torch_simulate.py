"""Slice parity: the port's simulate() against the JAX package's on a
small capacity plan, placements compared by stream index, plus the ways
the slice refuses to run (outside the envelope, an unscheduled pod, no
card and no explicit device)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from opensim_tpu.engine import simulator as ref_sim
from opensim_tpu.models import expand as ref_expand
from opensim_tpu_torch.engine import simulator as sim
from opensim_tpu_torch.models import expand, fixtures as fx


def _plan(n_nodes=32, n_pods=256):
    return fx.synthetic_cluster(n_nodes), fx.synthetic_apps(n_pods)


def _reference_copy(rt):
    """The same objects in the JAX package's object model, rebuilt from
    their manifests: only plain dicts cross between the packages."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def test_simulate_matches_reference_on_a_small_plan():
    c, a = _plan()
    c_ref, a_ref = _reference_copy(c), _reference_copy(a)
    ref_apps = [ref_sim.AppResource("plan", a_ref)]
    prep = ref_sim.prepare(c_ref, ref_apps)
    ref_res = ref_sim.simulate(c_ref, ref_apps, prep=prep)
    assert not ref_res.unscheduled_pods
    names = list(prep.meta.node_names)
    want = np.array([names.index(p.spec.node_name) for p in prep.ordered], np.int32)
    # per-node usage the reference's binds add up to, in stream order
    ec = prep.ec_np
    want_used = np.array(np.asarray(prep.st0.used), copy=True)
    np.add.at(want_used, want, np.asarray(ec.req)[prep.tmpl_ids])
    want_used = want_used[: len(c.nodes)]  # the reference pads the node axis to 128

    res = sim.simulate(c, [sim.AppResource("plan", a)], device="cpu")
    np.testing.assert_array_equal(res.placements, want)
    np.testing.assert_allclose(res.used, want_used, rtol=0, atol=0)
    assert not res.unscheduled_pods
    assert sum(len(ns.pods) for ns in res.node_status) == len(want) == 20 * (256 // 20)
    ref_counts = [len(ns.pods) for ns in ref_res.node_status]
    assert [len(ns.pods) for ns in res.node_status] == ref_counts
    assert [ns.node.metadata.name for ns in res.node_status] == [n.metadata.name for n in c.nodes]
    for ns in res.node_status:
        assert all(p.spec.node_name == ns.node.metadata.name and p.phase == "Running" for p in ns.pods)
    assert set(res.timings) == {"prepare", "inputs", "kernel", "decode"}


def test_simulate_raises_outside_the_envelope():
    cluster = expand.load_cluster_from_dir("example/cluster/gpushare")
    app, _ = expand.resources_from_dicts(expand.load_yaml_objects("example/application/gpushare"))
    with pytest.raises(NotImplementedError, match="GPU-share"):
        sim.simulate(cluster, [sim.AppResource("g", app)], device="cpu")


def test_simulate_raises_on_an_unscheduled_pod():
    cluster = fx.synthetic_cluster(4)
    app = expand.ResourceTypes()
    app.deployments.append(fx.make_fake_deployment("huge", 2, "100", "1Gi"))
    with pytest.raises(NotImplementedError, match="failure attribution"):
        sim.simulate(cluster, [sim.AppResource("h", app)], device="cpu")


def test_simulate_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c, a = _plan(4, 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.simulate(c, [sim.AppResource("plan", a)])


def test_simulate_with_no_pods_reports_empty_nodes():
    c, _ = _plan(4, 20)
    res = sim.simulate(c, [], device="cpu")
    assert [len(ns.pods) for ns in res.node_status] == [0, 0, 0, 0]
