"""Encoder parity: the port's prepare() and static tables against the JAX
package's, on the same inputs (np.array_equal, NaN-aware for label_num)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from opensim_tpu.engine import simulator as ref_sim
from opensim_tpu.models import expand as ref_expand
from opensim_tpu.ops import kernels as ref_kernels
from opensim_tpu_torch.encoding import dtypes
from opensim_tpu_torch.encoding.state import EncodedCluster, ScanState, to_device
from opensim_tpu_torch.engine import simulator as sim
from opensim_tpu_torch.models import expand, fixtures as fx
from opensim_tpu_torch.ops import kernels


_EXAMPLES = {"demo": ("demo", "simple"), "gpushare": ("gpushare", "gpushare")}
_GENERATED = {
    "synthetic": lambda: (fx.synthetic_cluster(16), fx.synthetic_apps(64)),
    "gpu_plan": lambda: (fx.gpu_cluster(16), fx.gpu_apps(160)),
}
CASES = list(_EXAMPLES) + list(_GENERATED)


def _example(pkg_expand, case):
    cluster_dir, app_dir = _EXAMPLES[case]
    cluster = pkg_expand.load_cluster_from_dir(f"example/cluster/{cluster_dir}")
    app, _skipped = pkg_expand.resources_from_dicts(
        pkg_expand.load_yaml_objects(f"example/application/{app_dir}")
    )
    return cluster, app


def _reference_copy(rt):
    """The same objects in the JAX package's object model, rebuilt from
    their manifests: only plain dicts cross between the packages."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def _both(case):
    if case in _EXAMPLES:
        (c_ref, a_ref), (c, a) = _example(ref_expand, case), _example(expand, case)
    else:
        c, a = _GENERATED[case]()
        c_ref, a_ref = _reference_copy(c), _reference_copy(a)
    # the reference's default node padding, 128 lanes; the port pads none by default
    ref = ref_sim.prepare(c_ref, [ref_sim.AppResource("a", a_ref)])
    port = sim.prepare(c, [sim.AppResource("a", a)], node_pad=128, device="cpu")
    return ref, port


def _eq(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return x.dtype == y.dtype and x.shape == y.shape and np.array_equal(
        x, y, equal_nan=x.dtype.kind == "f"
    )


@pytest.mark.parametrize("case", CASES)
def test_prepare_matches_reference(case):
    ref, port = _both(case)
    assert np.array_equal(port.tmpl_ids, ref.tmpl_ids)
    assert np.array_equal(port.forced, ref.forced)
    # pod names embed a process-global counter: compare what they are, not names
    assert [p.metadata.labels for p in port.ordered] == [p.metadata.labels for p in ref.ordered]
    for f in EncodedCluster._fields:
        assert _eq(getattr(port.ec_np, f), getattr(ref.ec_np, f)), f
        assert _eq(getattr(port.ec, f).numpy(), getattr(ref.ec_np, f)), f
    for f in ScanState._fields:
        assert _eq(getattr(port.st0_np, f), np.asarray(getattr(ref.st0, f))), f
        assert _eq(getattr(port.st0, f).numpy(), np.asarray(getattr(ref.st0, f))), f
    assert tuple(port.features) == tuple(ref.features)


@pytest.mark.parametrize("case", CASES)
def test_static_tables_bitwise(case):
    ref, port = _both(case)
    ours = kernels.precompute_static_np(port.ec_np)
    theirs = ref_kernels.precompute_static_np(ref.ec_np)
    for f in kernels.StaticTables._fields:
        assert _eq(getattr(ours, f), getattr(theirs, f)), f
    assert kernels.gc_row_of(port.ec_np) == ref_kernels.gc_row_of(ref.ec_np)


def test_gpu_cases_exercise_the_gpu_fields():
    """The GPU fields the parity tests above compare are live here: devices
    on every node, GPU-share templates, and on the GPU plan the gpu-count
    column zeroed in share_raw on device-bearing nodes (Features.gc_dyn)."""
    for case, gc_dyn in (("gpushare", False), ("gpu_plan", True)):
        _, port = _both(case)
        ec = port.ec_np
        assert port.features.gpu and port.features.gc_dyn == gc_dyn
        assert (ec.gpu_mem > 0).any() and (ec.node_gpu_mem > 0).any() and (port.st0_np.gpu_free > 0).any()
        assert ec.gc_mask.any() and (kernels.gc_row_of(ec) >= 0)
    assert (ec.gpu_count[ec.gpu_mem > 0] == 1).all() and (ec.req[:, kernels.gc_row_of(ec)] > 0).any()


def test_contracts_cover_every_field_and_set_torch_dtypes():
    assert set(dtypes.ARENA_CONTRACTS) == set(EncodedCluster._fields)
    assert set(dtypes.STATE_CONTRACTS) == set(ScanState._fields)
    _, port = _both("synthetic")
    want = {"FLOAT_DTYPE": torch.float32, "INT_DTYPE": torch.int32, "BOOL_DTYPE": torch.bool}
    for f in EncodedCluster._fields:
        assert getattr(port.ec, f).dtype == want[dtypes.ARENA_CONTRACTS[f][0]], f
    for f in ScanState._fields:
        assert getattr(port.st0, f).dtype == want[dtypes.STATE_CONTRACTS[f][0]], f


def test_to_device_refuses_an_off_contract_width():
    _, port = _both("synthetic")
    bad = port.ec_np._replace(req=port.ec_np.req.astype(np.float64))
    with pytest.raises(TypeError):
        to_device(bad, port.st0_np, "cpu")
