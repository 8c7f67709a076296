"""Bind-scan parity: the port's plain version against the JAX package on
the same prepared inputs (the reference's FastInputs handed across as
numpy), and the port's own marshalling against those inputs. Placements
must be identical, and `used`, the GPU takes, the final GPU, host-port,
volume-group and device state equal to rtol=0, atol=0: one ulp would flip
a score tie."""

import copy
import ctypes
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from opensim_tpu.engine import fastpath as ref_fastpath
from opensim_tpu.engine import simulator as ref_sim
from opensim_tpu.engine.scheduler import pad_pod_stream, schedule_pods
from opensim_tpu.models import expand as ref_expand
from opensim_tpu.ops import kernels as ref_kernels
from opensim_tpu_torch.engine import fastpath, simulator as sim
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.ops import fast_scan as fs
from opensim_tpu_torch.planner import defrag

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
    if name == "local_demo":
        # the example's node storage comes from a JSON file beside the
        # manifests, so the JAX package loads the same directories
        cluster = ref_expand.load_cluster_from_dir("example/cluster/demo")
        app, _ = ref_expand.resources_from_dicts(ref_expand.load_yaml_objects("example/application/local"))
        return ref_sim.prepare(cluster, [ref_sim.AppResource("a", app)], node_pad=node_pad)
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


def _reference_inputs(ref):
    """The JAX package's FastInputs of `ref`, carried across to the port."""
    fi_ref, meta = ref_fastpath.build_inputs(ref)
    arrays = {k: np.asarray(v) for k, v in fi_ref._asdict().items()}
    ec = ref.ec_np
    gc_row = ref_kernels.gc_row_of(ec) if ref.features.gc_dyn else -1
    n_ports = int(np.asarray(ec.ports).max()) + 1
    return fastpath.inputs_from_reference(
        arrays, "cpu", ref.features, gc_row, n_nodes=meta["n_orig"], n_gpus=ref.st0.gpu_free.shape[1],
        n_ports=n_ports, n_anti=ec.anti_g_sel.shape[0], n_pref=ec.prefg_sel.shape[0],
        n_vg=ref.st0.vg_free.shape[1], n_dev=ref.st0.dev_free.shape[1],
    ), meta


def _port_on_reference_inputs(ref):
    """(chosen [P], used [N, R], gpu_take [P, Gd], gpu_free [N, Gd],
    port_used [N, Hp], vg_free [N, Vg], dev_free [N, Dv]) of the plain
    version; the GPU arrays are None when no pod asks GPU memory, the
    storage arrays when no pod asks local storage."""
    fi, _ = _reference_inputs(ref)
    out = fs.fast_scan_reference(fi, *_stream(ref))
    gpu = (out.gpu_take.numpy(), out.gpu_free.T.numpy()) if ref.features.gpu else (None, None)
    local = (out.vg_free.T.numpy(), out.dev_free.T.numpy()) if ref.features.local else (None, None)
    return (out.chosen.numpy(), out.used.T.numpy()) + gpu + (out.port_used.T.numpy(),) + local


def _exact(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    assert got.shape == np.shape(want)


@pytest.mark.parametrize("name", CASES)
def test_plain_version_matches_xla_scan(name):
    ref = _ref_prep(name)
    assert ref_fastpath.why_not(ref, None) in (None, "no TPU backend (jax.default_backend()='cpu')")
    P = len(ref.ordered)
    t, v, f = pad_pod_stream(ref.tmpl_ids, np.ones(P, bool), ref.forced)
    out = schedule_pods(ref.ec, ref.st0, t, v, f, features=ref.features)
    chosen, used, gpu_take, gpu_free, port_used, vg_free, dev_free = _port_on_reference_inputs(ref)
    np.testing.assert_array_equal(chosen, np.asarray(out.chosen)[:P])
    _exact(used, np.asarray(out.final_state.used))
    want_ports = np.asarray(out.final_state.port_used)  # [N, Hports], every port id of the vocabulary
    Hp = port_used.shape[1]
    _exact(port_used, want_ports[:, :Hp])
    assert not want_ports[:, Hp:].any() and (Hp > 0) == ref.features.ports
    if ref.features.gpu:
        _exact(gpu_take, np.asarray(out.gpu_take)[:P])
        _exact(gpu_free, np.asarray(out.final_state.gpu_free))
        assert gpu_take.sum() > 0
    else:  # without GPU-share pods the XLA scan leaves the GPUs alone
        assert not np.asarray(out.gpu_take).any()
        _exact(np.asarray(out.final_state.gpu_free), np.asarray(ref.st0.gpu_free))
    if ref.features.local:
        _exact(vg_free, np.asarray(out.final_state.vg_free))
        _exact(dev_free, np.asarray(out.final_state.dev_free))
        assert (vg_free != np.asarray(ref.st0.vg_free)).any() and (dev_free != np.asarray(ref.st0.dev_free)).any()
    else:  # without local-storage pods the XLA scan leaves the storage alone
        _exact(np.asarray(out.final_state.vg_free), np.asarray(ref.st0.vg_free))
        _exact(np.asarray(out.final_state.dev_free), np.asarray(ref.st0.dev_free))
    if name not in ("ties", "two_keys", "interpod_small", "local", "local_rules"):  # the cases do exercise failures
        assert (chosen < 0).any()


@pytest.mark.parametrize(
    "name",
    ["spread", "forced", "gpu_dyn", "scores", "interpod", "interpod_terms", "ports", "local", "local_rules", "local_demo"],
)
def test_plain_version_matches_pallas_interpret(name):
    ref = _ref_prep(name)
    P = len(ref.ordered)
    want = ref_fastpath.schedule(ref, ref.tmpl_ids, np.ones(P, bool), ref.forced, interpret=True)
    chosen, used, gpu_take, gpu_free, _ports, vg_free, dev_free = _port_on_reference_inputs(ref)
    np.testing.assert_array_equal(chosen, want[0])
    _exact(used, want[1])
    if ref.features.gpu:
        _exact(gpu_take, want[3])
        _exact(gpu_free, want[4])
    if ref.features.local:
        _exact(vg_free, want[5])
        _exact(dev_free, want[6])


def test_forced_gpu_pods_take_no_device_where_none_fits():
    ref = _ref_prep("gpu_forced")
    chosen, _used, gpu_take, _free, _ports, _vg, _dev = _port_on_reference_inputs(ref)
    # the four bound pods lead the stream: 4 GiB on g0, then 10 GiB (one and
    # two GPUs) and 6 GiB on two GPUs, all on g1 (8 GiB GPUs)
    assert ref.forced[:4].all() and chosen[:4].tolist() == [0, 1, 1, 1]
    _exact(gpu_take[:4], np.array([[1, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [1, 1, 0, 0]], np.float32))


@pytest.mark.parametrize("name", CASES)
def test_build_inputs_equal_reference_inputs(name):
    ref, port = _ref_prep(name), _port_prep(name)
    theirs, meta = _reference_inputs(ref)
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
    assert a.chosen.dtype == torch.int32 and a.used.dtype == a.gpu_take.dtype == torch.float32
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    P, Gd = len(port.tmpl_ids), fi.gpu0.shape[0]
    assert a.gpu_take.shape == (P, Gd) and a.gpu_free.shape == (Gd, fi.alloc_T.shape[1])
    assert a.port_used.shape == (fi.port_HU.shape[0], fi.alloc_T.shape[1])
    assert a.vg_free.shape == fi.vg0.shape and a.dev_free.shape == fi.dev0.shape
    v = fs.variant(fi)
    assert v.gpu == port.features.gpu == (Gd > 0)
    assert v.ports == port.features.ports and v.interpod == (port.features.interpod or port.features.prefg)
    assert v.local == port.features.local == (fi.lvm_req.numel() > 0)
    assert fs.parse_variant(fs.variant_name(fi)) == v


def test_invalid_pods_bind_nothing():
    port = _port_prep("spread")
    fi, _ = fastpath.build_inputs(port)
    tmpl, valid, forced = _stream(port)
    valid[::2] = 0
    chosen = fs.fast_scan_reference(fi, tmpl, valid, forced).chosen
    assert (chosen[::2] == -1).all() and (chosen[1::2] >= 0).any()


def test_invalid_gpu_pods_take_no_device():
    port = _port_prep("gpu")
    fi, _ = fastpath.build_inputs(port)
    tmpl, valid, forced = _stream(port)
    valid[::2] = 0
    out = fs.fast_scan_reference(fi, tmpl, valid, forced)
    assert not out.gpu_take[::2].any() and out.gpu_take[1::2].any()


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
    with pytest.raises(ValueError, match="gc_row"):
        fs._check(fi._replace(gc_row=0), tmpl, valid, forced)  # no GPU tables
    gpu = _port_prep("gpu")
    fi_g, _ = fastpath.build_inputs(gpu)
    stream_g = _stream(gpu)
    fs._check(fi_g, *stream_g)
    with pytest.raises(ValueError, match="gpu0"):
        fs._check(fi_g._replace(gpu0=fi_g.gpu0[:, :-1].contiguous()), *stream_g)
    with pytest.raises(ValueError, match="Gd=9"):
        fs._check(fi_g._replace(gpu0=torch.zeros((9, fi_g.gpu0.shape[1]))), *stream_g)
    with pytest.raises(ValueError, match="no kernel"):
        fs.fast_scan(fi._replace(alloc_T=fi.alloc_T.to("meta")), tmpl, valid, forced)


def test_work_counts_scheduled_pods_only():
    port = _port_prep("forced")
    fi, _ = fastpath.build_inputs(port)
    tmpl, valid, forced = _stream(port)
    chosen = fs.fast_scan_reference(fi, tmpl, valid, forced).chosen
    w = fs.fast_scan_work(fi, tmpl, valid, forced, chosen)
    w_none = fs.fast_scan_work(fi, tmpl, torch.zeros_like(valid), forced, chosen)
    assert w["ops"] > w_none["ops"] == 0 and w_none["bytes"] > 0
    # the inputs are read alike; only the count rows of the pods that found no node are added
    assert w["bytes"] == w_none["bytes"] + w["count"]["bytes"] and w_none["count"]["steps"] == 0


def test_work_counts_valid_node_lanes_only():
    padded = _port_prep("forced")
    cluster, app, _ = fx.scan_case("forced")
    bare = sim.prepare(cluster, [sim.AppResource("a", app)], device="cpu")
    fi_pad, _ = fastpath.build_inputs(padded)
    fi_bare, _ = fastpath.build_inputs(bare)
    assert fi_pad.alloc_T.shape[1] == 128 and fi_bare.alloc_T.shape[1] == 12
    chosen = fs.fast_scan_reference(fi_bare, *_stream(bare)).chosen
    w_pad = fs.fast_scan_work(fi_pad, *_stream(padded), chosen)
    assert w_pad == fs.fast_scan_work(fi_bare, *_stream(bare), chosen)


def test_work_counts_the_flag_branches():
    port = _port_prep("gpu_dyn")
    fi, _ = fastpath.build_inputs(port)
    stream = _stream(port)
    base = fi._replace(gpu_mem=fi.gpu_mem[:0], gpu_cnt=fi.gpu_cnt[:0], gpu0=fi.gpu0[:0], gc_row=-1)
    chosen = fs.fast_scan_reference(fi, *stream).chosen
    w, w_base = fs.fast_scan_work(fi, *stream, chosen), fs.fast_scan_work(base, *stream, chosen)
    assert w["ops"] > w_base["ops"] and w["bytes"] > w_base["bytes"]
    all_bound = fs.fast_scan_work(fi, *stream, torch.zeros_like(chosen))
    # a pod that did not bind binds nothing; it runs the counting pass instead
    assert (chosen < 0).any() and all_bound["ops"] > w["ops"] - w["count"]["ops"]
    assert w["count"]["steps"] == int((chosen < 0).sum()) and all_bound["count"]["ops"] == 0
    assert fs.variant_name(fi) == "fast_scan[gpu,gc]" and fs.variant_name(base) == "fast_scan"


def test_work_counts_the_port_and_interpod_branches():
    for name, off in (
        ("ports", lambda fi, U: fi._replace(port_HU=fi.port_HU[:0], port_conf_HU=fi.port_conf_HU[:0])),
        ("interpod", lambda fi, U: fi._replace(**{k: torch.from_numpy(t) for k, t in fastpath._no_terms(U).items()})),
    ):
        port = _port_prep(name)
        fi, _ = fastpath.build_inputs(port)
        stream = _stream(port)
        base = off(fi, fi.req.shape[0])
        assert fs.variant(base) == fs.variant(fi)._replace(**{name: False})
        chosen = fs.fast_scan_reference(fi, *stream).chosen
        w, w_base = fs.fast_scan_work(fi, *stream, chosen), fs.fast_scan_work(base, *stream, chosen)
        assert w["ops"] > w_base["ops"] and w["bytes"] > w_base["bytes"], name


def test_launcher_checks_term_indices():
    port = _port_prep("interpod")
    fi, _ = fastpath.build_inputs(port)
    stream = _stream(port)
    fs._check(fi, *stream)
    K, A = fi.zone_idx.shape[0], fi.matches_AU.shape[0]
    with pytest.raises(ValueError, match="an_key"):
        fs._check(fi._replace(an_key=torch.full_like(fi.an_key, K + 1)), *stream)
    with pytest.raises(ValueError, match="pt_sel"):
        fs._check(fi._replace(pt_sel=torch.full_like(fi.pt_sel, A)), *stream)
    with pytest.raises(ValueError, match="gmatch_GU"):
        fs._check(fi._replace(gmatch_GU=fi.gmatch_GU[:, :-1].contiguous()), *stream)


def test_variant_names_round_trip():
    for bits in range(1 << len(fs.Variant._fields)):
        v = fs.Variant(*(bool(bits >> i & 1) for i in range(len(fs.Variant._fields))))
        assert fs.parse_variant(fs._name(v)) == v and fs._bits(v) == bits
    assert fs._bits(fs.parse_variant("fast_scan[local]")) == 1 << 7  # appended: earlier numbers keep their meaning
    with pytest.raises(ValueError, match="no kernel variant"):
        fs.parse_variant("fast_scan[bogus]")


def _struct_fields(src: str):
    """Field names of ``struct FastScanArgs`` in the CUDA source, in order."""
    body = re.search(r"struct FastScanArgs \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            head, *rest = decl.split(",")
            names += [head.split()[-1].lstrip("*")] + [r.strip() for r in rest]
    return names


def test_ctypes_struct_matches_the_cuda_struct():
    src = (pathlib.Path(fs.__file__).parent / "csrc" / "fast_scan.cu").read_text()
    fields = _struct_fields(src)
    assert fields == [n for n, _ in fs._Args._fields_]
    pointers = [n for n, t in fs._Args._fields_ if t is ctypes.c_void_p]
    assert fields[: len(pointers)] == pointers  # every pointer before the int32 scalars


def _drain_grid(port, drained):
    """The sweep's inputs for draining each node of `drained`: tmpl,
    valid, forced, node_valid and spr_weight."""
    return fastpath.sweep_inputs(port, *defrag.drain_masks(port, drained))


def test_work_counts_the_local_branch():
    port = _port_prep("local")
    fi, _ = fastpath.build_inputs(port)
    stream = _stream(port)
    off = {k: torch.from_numpy(t).float() for k, t in fastpath._no_local(fi.alloc_T.shape[1]).items()}
    base = fi._replace(**off)
    assert fs.variant(base) == fs.variant(fi)._replace(local=False) and fs.variant(fi).local
    chosen = fs.fast_scan_reference(fi, *stream).chosen
    w, w_base = fs.fast_scan_work(fi, *stream, chosen), fs.fast_scan_work(base, *stream, chosen)
    assert w["ops"] > w_base["ops"] and w["bytes"] > w_base["bytes"]
    all_bound = fs.fast_scan_work(fi, *stream, torch.zeros_like(chosen))
    assert all_bound["ops"] == w["ops"]  # every pod of the case binds


def test_work_of_a_scenario_grid_counts_each_scenario_over_its_own_nodes():
    port = _port_prep("local")
    fi, _ = fastpath.build_inputs(port)
    tmpl, valid, forced, node_valid, spr_weight = _drain_grid(port, [0, 1, 2])
    chosen = fs.fast_scan_sweep_reference(fi, tmpl, valid, forced, node_valid, spr_weight).chosen
    w = fs.fast_scan_work(fi, tmpl, valid, forced, chosen, node_valid)
    singles = [fs.fast_scan_work(fi._replace(node_valid=node_valid[s]), tmpl, valid[s], forced[s], chosen[s])
               for s in range(3)]
    assert w["ops"] == sum(x["ops"] for x in singles) > 0
    assert int((node_valid != 0).sum()) == 3 * 3  # each scenario has lost one of the four nodes
    # the template tables the scenarios share are read once
    assert singles[0]["bytes"] < w["bytes"] < sum(x["bytes"] for x in singles)


def test_plain_sweep_is_the_plain_scan_per_scenario():
    port = _port_prep("forced")
    fi, _ = fastpath.build_inputs(port)
    tmpl, valid, forced, node_valid, spr_weight = _drain_grid(port, [0, 3, 5])
    assert not forced.all(dim=0).equal(forced.any(dim=0))  # draining n000 or n003 releases a bound pod
    out = fs.fast_scan_sweep(fi, tmpl, valid, forced, node_valid, spr_weight)
    assert out.fail_counts.shape == out.insufficient.shape == (3, tmpl.shape[0], 0)  # the grid does not count
    for s in range(3):
        one = fs.fast_scan_reference(fi._replace(node_valid=node_valid[s], spr_weight=spr_weight[s]),
                                     tmpl, valid[s], forced[s])
        assert all(torch.equal(getattr(out, f)[s], getattr(one, f)) for f in fs.STATE_FIELDS)
        assert not (out.chosen[s] == (0, 3, 5)[s]).any()  # nothing lands on the drained node


def test_launcher_checks_a_scenario_grid():
    port = _port_prep("ties")
    fi, _ = fastpath.build_inputs(port)
    tmpl, valid, forced = _stream(port)
    grid = (valid.repeat(2, 1), forced.repeat(2, 1), fi.node_valid.repeat(2, 1), fi.spr_weight.repeat(2, 1, 1))
    fs._check(fi, tmpl, *grid)
    with pytest.raises(ValueError, match="node_valid"):
        fs._check(fi, tmpl, grid[0], grid[1], grid[2][:, :-1].contiguous(), grid[3])
    with pytest.raises(ValueError, match="spr_weight"):
        fs._check(fi, tmpl, grid[0], grid[1], grid[2], grid[3][:1].contiguous())
    with pytest.raises(ValueError, match="forced"):
        fs._check(fi, tmpl, grid[0], forced, grid[2], grid[3])
    with pytest.raises(ValueError, match="0 or 1"):
        fs._check(fi, tmpl, grid[0], grid[1], grid[2] * 0.5, grid[3])
    with pytest.raises(ValueError, match="S >= 1"):
        fs._check(fi, tmpl, grid[0][:0], grid[1][:0], grid[2][:0], grid[3][:0])
    with pytest.raises(ValueError, match="no kernel"):
        fs.fast_scan_sweep(fi._replace(alloc_T=fi.alloc_T.to("meta")), tmpl, *grid)
    local = _port_prep("local")
    fi_l, _ = fastpath.build_inputs(local)
    fs._check(fi_l, *_stream(local))
    wide = {k: torch.zeros((rows, fi_l.alloc_T.shape[1])) for k, rows in
            (("dev_cap", 65), ("dev0", 65), ("dev_media", 130))}
    with pytest.raises(ValueError, match="Dv=65"):
        fs._check(fi_l._replace(**wide), *_stream(local))
    with pytest.raises(ValueError, match="dev_sizes"):
        fs._check(fi_l._replace(dev_sizes=fi_l.dev_sizes[:, :1].contiguous()), *_stream(local))
