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


def _example(pkg_expand):
    cluster = pkg_expand.load_cluster_from_dir("example/cluster/demo")
    app, _skipped = pkg_expand.resources_from_dicts(
        pkg_expand.load_yaml_objects("example/application/simple")
    )
    return cluster, app


def _synthetic():
    return fx.synthetic_cluster(16), fx.synthetic_apps(64)


def _reference_copy(rt):
    """The same objects in the JAX package's object model, rebuilt from
    their manifests: only plain dicts cross between the packages."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def _both(case):
    if case == "demo":
        (c_ref, a_ref), (c, a) = _example(ref_expand), _example(expand)
    else:
        c, a = _synthetic()
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


@pytest.mark.parametrize("case", ["demo", "synthetic"])
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


@pytest.mark.parametrize("case", ["demo", "synthetic"])
def test_static_tables_bitwise(case):
    ref, port = _both(case)
    ours = kernels.precompute_static_np(port.ec_np)
    theirs = ref_kernels.precompute_static_np(ref.ec_np)
    for f in kernels.StaticTables._fields:
        assert _eq(getattr(ours, f), getattr(theirs, f)), f
    assert kernels.gc_row_of(port.ec_np) == ref_kernels.gc_row_of(ref.ec_np)


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
