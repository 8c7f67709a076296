"""The port's checkpoints (``opensim_tpu_torch/utils/checkpoint.py``)
against the JAX package's ``utils/checkpoint.py``: the port's counterparts
of ``tests/test_utils.py``'s round trip and old-archive backfill; a
checkpoint written by either package loads in the other, field by field
equal; and a resume: the state after the first k = P/2 pods of a small
GPU-share case and a host-port case, written, loaded back and run from
(the plain version, ``fastpath.schedule(init=)``) equals the uninterrupted
plain scan and the JAX package's ``schedule_pods`` on the same prepared
input, on the placements and the final scan state; the JAX package's scan
resumed from the port's file gives the same. Objects cross between the
packages only as manifests."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from opensim_tpu.encoding.state import ClusterEncoder as RefClusterEncoder
from opensim_tpu.engine import scheduler as ref_scheduler, simulator as ref_sim
from opensim_tpu.models import expand as ref_expand, fixtures as ref_fx
from opensim_tpu.utils import checkpoint as ref_checkpoint
from opensim_tpu_torch.encoding.dtypes import log_size_table
from opensim_tpu_torch.encoding.state import ClusterEncoder, EncodedCluster, ScanState, to_device
from opensim_tpu_torch.engine import fastpath, scheduler, simulator as sim
from opensim_tpu_torch.engine.explain import replay_state
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.utils.checkpoint import load_state, save_state


def _encoded(fxm, encoder):
    enc = encoder()
    enc.add_nodes([fxm.make_fake_node("n0"), fxm.make_fake_node("n1")])
    enc.add_pod(fxm.make_fake_pod("p0", "1", "1Gi"))
    ec, st, _meta = enc.build()
    return ec, st


def _equal_fields(got, want):
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_checkpoint_roundtrip(tmp_path):
    ec, st = _encoded(fx, ClusterEncoder)
    path = str(tmp_path / "ckpt.npz")
    save_state(path, ec, st, extra={"round": 3})
    ec2, st2, extra = load_state(path)
    assert extra == {"round": 3}
    _equal_fields(ec2, ec)
    _equal_fields(st2, st)
    # tensors (a state on the device) are written as the same arrays
    ecd, std = to_device(ec, st, "cpu")
    save_state(str(tmp_path / "from-tensors"), ecd, std)
    ec3, st3, extra3 = load_state(str(tmp_path / "from-tensors.npz"))
    assert extra3 == {}
    _equal_fields(ec3, ec)
    _equal_fields(st3, st)

    # resuming the scan from a checkpoint gives identical results
    tmpl = np.zeros(4, np.int32)
    valid = np.ones(4, bool)
    forced = np.zeros(4, bool)
    out1 = scheduler.schedule_pods(*to_device(ec, st, "cpu"), tmpl, valid, forced)
    out2 = scheduler.schedule_pods(*to_device(ec2, st2, "cpu"), tmpl, valid, forced)
    assert torch.equal(out1.chosen, out2.chosen)
    for a, b in zip(out1.final_state, out2.final_state):
        assert torch.equal(a, b)


def test_checkpoint_backfills_old_archives(tmp_path):
    """An archive written before EncodedCluster grew ``gc_mask`` and
    ``log_sizes`` backfills both: gc_mask all-static (exactly the saved
    behaviour) and log_sizes bit-identical to the table the encoder builds."""
    ec, st = _encoded(fx, ClusterEncoder)
    path = str(tmp_path / "old.npz")
    save_state(path, ec, st)
    with np.load(path) as data:
        stripped = {k: data[k] for k in data.files if k not in ("ec_gc_mask", "ec_log_sizes")}
    np.savez_compressed(path, **stripped)

    ec2, st2, _extra = load_state(path)
    np.testing.assert_array_equal(ec2.gc_mask, np.zeros((ec.alloc.shape[1],), dtype=bool))
    np.testing.assert_array_equal(ec2.log_sizes, log_size_table(ec.alloc.shape[0]))
    assert ec2.log_sizes.dtype == ec.log_sizes.dtype
    for name, a in ec._asdict().items():
        if name not in ("gc_mask", "log_sizes"):
            np.testing.assert_array_equal(a, getattr(ec2, name))

    tmpl = np.zeros(2, np.int32)
    valid = np.ones(2, bool)
    forced = np.zeros(2, bool)
    out1 = scheduler.schedule_pods(*to_device(ec, st, "cpu"), tmpl, valid, forced)
    out2 = scheduler.schedule_pods(*to_device(ec2, st2, "cpu"), tmpl, valid, forced)
    assert torch.equal(out1.chosen, out2.chosen)


def test_unknown_version_is_refused(tmp_path):
    ec, st = _encoded(fx, ClusterEncoder)
    path = str(tmp_path / "v2.npz")
    save_state(path, ec, st)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["__meta__"] = np.frombuffer(b'{"version": 2, "extra": {}}', dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    with pytest.raises(ValueError, match="unsupported checkpoint version 2"):
        load_state(path)


def _reference_copy(rt):
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def _preps(name):
    cluster, app, node_pad = fx.scan_case(name)
    ref = ref_sim.prepare(_reference_copy(cluster), [ref_sim.AppResource("a", _reference_copy(app))],
                          node_pad=node_pad)
    port = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device="cpu")
    return port, ref


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_checkpoint_loads_in_the_other_package(tmp_path, writer):
    """Both encoders of the same GPU-share case agree field by field; each
    package's file loads in the other as the arrays it wrote, its extra
    included."""
    port, ref = _preps("gpu")
    ec_port, st_port = port.ec_np, port.st0_np
    ec_ref = EncodedCluster(*(np.asarray(a) for a in ref.ec_np))
    st_ref = ScanState(*(np.asarray(a) for a in ref.st0))
    _equal_fields(ec_ref, ec_port)
    _equal_fields(st_ref, st_port)
    path = str(tmp_path / f"by-{writer}.npz")
    if writer == "jax":
        ref_checkpoint.save_state(path, ref.ec_np, ref.st0, extra={"by": writer})
        ec, st, extra = load_state(path)
    else:
        save_state(path, ec_port, st_port, extra={"by": writer})
        ec, st, extra = ref_checkpoint.load_state(path)
    assert extra == {"by": writer}
    _equal_fields(EncodedCluster(*ec), ec_port)
    _equal_fields(ScanState(*st), st_port)


def test_the_jax_encoder_agrees_on_the_small_cluster():
    """The round trip's cluster, encoded by each package, is one checkpoint."""
    ec, st = _encoded(fx, ClusterEncoder)
    ec_ref, st_ref = _encoded(ref_fx, RefClusterEncoder)
    _equal_fields(EncodedCluster(*(np.asarray(a) for a in ec_ref)), ec)
    _equal_fields(ScanState(*(np.asarray(a) for a in st_ref)), st)


@pytest.mark.parametrize("name", ["gpu", "ports"])
def test_a_resumed_scan_equals_the_uninterrupted_one(tmp_path, monkeypatch, name):
    """The state after the first k = P/2 pods, rebuilt from the whole run's
    placements, saved and loaded back; the plain version from it over pods
    k… equals the whole run there and the JAX package's XLA scan over the
    whole stream, on placements and final state; the JAX scan resumed from
    the port's file gives the same."""
    monkeypatch.setenv("OPENSIM_DISABLE_NATIVE", "1")
    port, ref = _preps(name)
    P = len(port.tmpl_ids)
    k = P // 2
    built = fastpath.build_inputs(port, segment=True)
    whole = fastpath.schedule(port, [(built, 0, P)], init=port.st0_np)
    assert (whole.chosen >= 0).any() and (whole.chosen[k:] >= 0).any()
    path = str(tmp_path / f"{name}-at-{k}")
    save_state(path, port.ec_np, replay_state(port, whole.chosen, whole.gpu_take, k), extra={"k": k})
    ec, st, extra = load_state(path)
    assert extra == {"k": k}
    _equal_fields(ec, port.ec_np)
    resumed = fastpath.schedule(port, [(built, k, P)], init=st)
    np.testing.assert_array_equal(resumed.chosen, whole.chosen[k:])
    for field in ("used", "gpu_free", "port_used", "vg_free", "dev_free"):
        np.testing.assert_array_equal(getattr(resumed, field), getattr(whole, field), err_msg=field)
    np.testing.assert_array_equal(resumed.gpu_take, whole.gpu_take[k:])
    if name == "gpu":
        assert whole.gpu_take[k:].sum() > 0 and port.features.gpu
    else:
        assert whole.port_used.sum() > 0 and port.features.ports

    # the JAX package's scan over the whole stream on its own prepared input
    t, v, f = ref_scheduler.pad_pod_stream(ref.tmpl_ids, np.ones(P, bool), ref.forced)
    out = ref_scheduler.schedule_pods(ref.ec, ref.st0, t, v, f, features=ref.features)
    np.testing.assert_array_equal(whole.chosen, np.asarray(out.chosen)[:P])
    want = out.final_state
    np.testing.assert_array_equal(resumed.used, np.asarray(want.used))
    np.testing.assert_array_equal(resumed.gpu_free, np.asarray(want.gpu_free))
    np.testing.assert_array_equal(resumed.vg_free, np.asarray(want.vg_free))
    np.testing.assert_array_equal(resumed.dev_free, np.asarray(want.dev_free))
    hp = resumed.port_used.shape[1]
    np.testing.assert_array_equal(resumed.port_used, np.asarray(want.port_used)[:, :hp])
    assert not np.asarray(want.port_used)[:, hp:].any()

    # and the JAX scan resumed from the port's file: the same tail and state
    ec_r, st_r, _extra = ref_checkpoint.load_state(path)
    t, v, f = ref_scheduler.pad_pod_stream(ref.tmpl_ids[k:], np.ones(P - k, bool), ref.forced[k:])
    tail = ref_scheduler.schedule_pods(*ref_scheduler.to_device(ec_r, st_r), t, v, f, features=ref.features)
    np.testing.assert_array_equal(np.asarray(tail.chosen)[:P - k], resumed.chosen)
    for field in ScanState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tail.final_state, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)
