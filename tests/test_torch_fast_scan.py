"""Bind-scan parity: the port's plain version against the JAX package on
the same prepared inputs (the reference's FastInputs handed across as
numpy), and the port's own marshalling against those inputs. Placements
must be identical and `used` equal to rtol=0, atol=0: one ulp would flip a
score tie."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from opensim_tpu.engine import fastpath as ref_fastpath
from opensim_tpu.engine import simulator as ref_sim
from opensim_tpu.engine.scheduler import pad_pod_stream, schedule_pods
from opensim_tpu.models import expand as ref_expand
from opensim_tpu_torch.engine import fastpath, simulator as sim
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.ops import fast_scan as fs

CASES = [c[0] for c in fx.SCAN_CASES]


def _reference_copy(rt):
    """The same objects in the JAX package's object model, rebuilt from
    their manifests: only plain dicts cross between the packages."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def _ref_prep(name):
    cluster, app, node_pad = fx.scan_case(name)
    return ref_sim.prepare(
        _reference_copy(cluster), [ref_sim.AppResource("a", _reference_copy(app))], node_pad=node_pad
    )


def _port_prep(name):
    cluster, app, node_pad = fx.scan_case(name)
    return sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device="cpu")


def _stream(prep):
    P = len(prep.tmpl_ids)
    return (
        torch.from_numpy(prep.tmpl_ids.astype(np.int32)),
        torch.ones(P, dtype=torch.int32),
        torch.from_numpy(prep.forced.astype(np.int32)),
    )


def _port_on_reference_inputs(ref):
    fi_ref, meta = ref_fastpath.build_inputs(ref)
    arrays = {k: np.asarray(v) for k, v in fi_ref._asdict().items()}
    fi = fastpath.inputs_from_reference(arrays, "cpu", n_nodes=meta["n_orig"])
    chosen, used_T = fs.fast_scan_reference(fi, *_stream(ref))
    return chosen.numpy(), used_T.T.numpy()


@pytest.mark.parametrize("name", CASES)
def test_plain_version_matches_xla_scan(name):
    ref = _ref_prep(name)
    assert ref_fastpath.why_not(ref, None) in (None, "no TPU backend (jax.default_backend()='cpu')")
    P = len(ref.ordered)
    t, v, f = pad_pod_stream(ref.tmpl_ids, np.ones(P, bool), ref.forced)
    out = schedule_pods(ref.ec, ref.st0, t, v, f, features=ref.features)
    want_chosen = np.asarray(out.chosen)[:P]
    want_used = np.asarray(out.final_state.used)
    chosen, used = _port_on_reference_inputs(ref)
    np.testing.assert_array_equal(chosen, want_chosen)
    np.testing.assert_allclose(used, want_used, rtol=0, atol=0)
    if name != "ties":  # the cases do exercise failures
        assert (chosen < 0).any()


@pytest.mark.parametrize("name", ["spread", "forced"])
def test_plain_version_matches_pallas_interpret(name):
    ref = _ref_prep(name)
    P = len(ref.ordered)
    want = ref_fastpath.schedule(ref, ref.tmpl_ids, np.ones(P, bool), ref.forced, interpret=True)
    chosen, used = _port_on_reference_inputs(ref)
    np.testing.assert_array_equal(chosen, want[0])
    np.testing.assert_allclose(used, want[1], rtol=0, atol=0)


@pytest.mark.parametrize("name", CASES)
def test_build_inputs_equal_reference_inputs(name):
    ref, port = _ref_prep(name), _port_prep(name)
    fi_ref, meta = ref_fastpath.build_inputs(ref)
    theirs = fastpath.inputs_from_reference(
        {k: np.asarray(v) for k, v in fi_ref._asdict().items()}, "cpu", n_nodes=meta["n_orig"]
    )
    ours, ours_meta = fastpath.build_inputs(port)
    A = ours.matches_AU.shape[0]
    for f in fs.FastInputs._fields:
        a, b = getattr(ours, f), getattr(theirs, f)
        if f == "matches_AU":
            assert torch.equal(b[A:], torch.zeros_like(b[A:]))
            b = b[:A]
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f
        else:
            assert a == b, f
    np.testing.assert_array_equal(ours_meta["static_fail"], meta["static_fail"])


@pytest.mark.parametrize("name", CASES)
def test_wrapper_on_cpu_runs_the_plain_version(name):
    port = _port_prep(name)
    fi, _ = fastpath.build_inputs(port)
    before = fs.LAUNCHES
    a = fs.fast_scan(fi, *_stream(port))
    b = fs.fast_scan_reference(fi, *_stream(port))
    assert fs.LAUNCHES == before  # the CPU launches no kernel
    assert a[0].dtype == torch.int32 and a[1].dtype == torch.float32
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_invalid_pods_bind_nothing():
    port = _port_prep("spread")
    fi, _ = fastpath.build_inputs(port)
    tmpl, valid, forced = _stream(port)
    valid[::2] = 0
    chosen, _ = fs.fast_scan_reference(fi, tmpl, valid, forced)
    assert (chosen[::2] == -1).all() and (chosen[1::2] >= 0).any()


def test_launcher_checks_dtypes_and_shapes():
    port = _port_prep("ties")
    fi, _ = fastpath.build_inputs(port)
    tmpl, valid, forced = _stream(port)
    with pytest.raises(ValueError, match="req"):
        fs._check(fi._replace(req=fi.req.double()), tmpl, valid, forced)
    with pytest.raises(ValueError, match="tmpl"):
        fs._check(fi, tmpl.long(), valid, forced)
    with pytest.raises(ValueError, match="static_pass"):
        fs._check(fi._replace(static_pass=fi.static_pass.t()), tmpl, valid, forced)
    fs._check(fi, tmpl, valid, forced)
    with pytest.raises(ValueError, match="no kernel"):
        fs.fast_scan(fi._replace(alloc_T=fi.alloc_T.to("meta")), tmpl, valid, forced)


def test_work_counts_scheduled_pods_only():
    port = _port_prep("forced")
    fi, _ = fastpath.build_inputs(port)
    tmpl, valid, forced = _stream(port)
    w = fs.fast_scan_work(fi, tmpl, valid, forced)
    w_none = fs.fast_scan_work(fi, tmpl, torch.zeros_like(valid), forced)
    assert w["ops"] > w_none["ops"] == 0 and w["bytes"] == w_none["bytes"] > 0


def test_work_counts_valid_node_lanes_only():
    padded = _port_prep("forced")
    cluster, app, _ = fx.scan_case("forced")
    bare = sim.prepare(cluster, [sim.AppResource("a", app)], device="cpu")
    fi_pad, _ = fastpath.build_inputs(padded)
    fi_bare, _ = fastpath.build_inputs(bare)
    assert fi_pad.alloc_T.shape[1] == 128 and fi_bare.alloc_T.shape[1] == 12
    w_pad = fs.fast_scan_work(fi_pad, *_stream(padded))
    assert w_pad == fs.fast_scan_work(fi_bare, *_stream(bare))
