"""The Python around the one-scan kernel's thread-block cluster, which runs
only on a card: its fixed shape, and the host's reckoning of what each CTA
keeps in shared memory (its slice of the per-node rows and a copy of the
small state), where it fits and where it falls back to global memory."""

import pathlib
import re

import pytest
import torch

from opensim_tpu_torch.engine import fastpath, simulator as sim
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.ops import fast_scan as fs

SRC = (pathlib.Path(fs.__file__).parent / "csrc" / "fast_scan.cu").read_text()
PLANS = {
    "capacity": lambda: (fx.synthetic_cluster(64), fx.synthetic_apps(256)),
    "gpu": lambda: (fx.gpu_cluster(64), fx.gpu_apps(256)),
    "affinity": lambda: (fx.synthetic_cluster(64), fx.affinity_apps(256)),
    "score": lambda: (fx.score_cluster(64), fx.score_apps(256)),
    "ports": lambda: (fx.score_cluster(64), fx.score_apps(256, host_port=True)),
    "local": lambda: (fx.local_pv_cluster(64), fx.local_pv_apps(256)),
}


def _inputs(cluster, apps, node_pad=1):
    prep = sim.prepare(cluster, [sim.AppResource("p", apps)], node_pad=node_pad, device="cpu")
    return fastpath.build_inputs(prep)[0]


def _expected_need(fi, nc):
    """Bytes a CTA keeps, counted from the tables' own shapes: each per-node
    row of its slice (state, then constant node tables), and the small
    state every bind touches."""
    v = fs.variant(fi)
    R, K, A = fi.alloc_T.shape[0], fi.zone_idx.shape[0], fi.matches_AU.shape[0]
    Gd, Hp, G, Gp = fi.gpu0.shape[0], fi.port_HU.shape[0], fi.anti_g_key.shape[0], fi.prefg_key.shape[0]
    Vg, Dv, Z = fi.vg0.shape[0], fi.dev0.shape[0], fi.n_zones
    state = R + A + Gd + Hp + G + Gp + Vg + Dv
    tables = R + K + 1 + (Gd if v.gc else 0) + Vg + Dv + 2 * Dv
    small = K * A * Z + (G + Gp) * Z + ((K + 1) * A if v.interpod else 0)
    return 4 * ((state + tables) * nc + small), small


def test_cluster_constants_match_the_cuda_source():
    defines = dict(re.findall(r"#define (\w+) \(?(-?\d+)\)?", SRC))
    assert (int(defines["CL"]), int(defines["NT"])) == (fs.SCAN_CLUSTER, fs.SCAN_THREADS)
    assert int(defines["SCAN_STATIC_SMEM"]) == fs.SCAN_STATIC_SMEM
    assert int(defines["SCAN_UNSCHEDULABLE"]) == fs.SCAN_UNSCHEDULABLE
    assert 2 <= fs.SCAN_CLUSTER <= 16 and fs.SCAN_THREADS % 32 == 0 and fs.SCAN_THREADS <= 1024
    # the card tests' "three nodes a thread" reach past the nodes kept in registers
    assert int(defines["SCAN_NPT"]) < 3


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_each_plan_keeps_its_slices_in_shared_memory(plan):
    fi = _inputs(*PLANS[plan]())
    shape = fs.scan_shape(fi)
    N = fi.alloc_T.shape[1]
    need, small = _expected_need(fi, shape.nc)
    assert (shape.cluster, shape.threads) == (fs.SCAN_CLUSTER, fs.SCAN_THREADS)
    assert shape.nc == -(-N // fs.SCAN_CLUSTER) and shape.nc * fs.SCAN_CLUSTER >= N
    assert shape.need == need and shape.small == small
    assert shape.resident and shape.smem == need <= fs.SMEM_MAX - fs.SCAN_STATIC_SMEM


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_the_slice_rows_and_the_small_state_do_not_overlap(plan):
    fi = _inputs(*PLANS[plan]())
    shape = fs.scan_shape(fi)
    rows = fs._slice_rows(fs._dims(fi), fs.variant(fi))
    spans = sorted((shape.offsets[k], shape.offsets[k] + n * shape.nc) for k, n in rows.items())
    assert spans[0][0] == 0 and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # back to back
    assert spans[-1][1] == shape.offsets["rep"]  # the small state's copy follows the slice
    assert 4 * (shape.offsets["rep"] + shape.small) == shape.need


def test_nodes_fewer_than_ctas_leave_some_ctas_empty():
    cluster, app, _ = fx.scan_case("gpu_forced")
    fi = _inputs(cluster, app)
    assert fi.alloc_T.shape[1] == 6 < fs.SCAN_CLUSTER
    shape = fs.scan_shape(fi)
    assert shape.nc == 1 and shape.resident


def test_sixty_four_devices_a_node_put_the_slices_in_global_memory():
    cluster, app, _ = fx.scan_case("local")
    fi = _inputs(cluster, app, node_pad=8192)
    N = fi.alloc_T.shape[1]
    wide = fi._replace(dev_cap=torch.zeros((64, N)), dev0=torch.zeros((64, N)), dev_media=torch.zeros((128, N)))
    assert fs.scan_shape(fi).resident
    shape = fs.scan_shape(wide)
    assert shape.need == _expected_need(wide, shape.nc)[0] > fs.SMEM_MAX - fs.SCAN_STATIC_SMEM
    assert not shape.resident and shape.smem == 0
    assert shape.offsets["zone_cnt"] == 0 and shape.offsets["used"] == 0  # only the small state's offsets count


def test_a_thousand_selectors_put_the_slices_in_global_memory():
    fi = _inputs(fx.synthetic_cluster(512), fx.bigu_apps(1000))
    shape = fs.scan_shape(fi)
    assert fi.matches_AU.shape[0] >= 1000
    assert not shape.resident and shape.small == _expected_need(fi, shape.nc)[1] > 0


def test_ptxas_report_reads_the_one_scan_of_each_residency():
    log = (
        "ptxas info    : Compiling entry function '_Z16fast_scan_kernelILb0ELi1EEEv12FastScanArgs' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 64 registers, 1152 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z16fast_scan_kernelILb0ELi0EEEv12FastScanArgs' for 'sm_90a'\n"
        "    32 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 67 registers, 1152 bytes smem\n"
    )
    assert fs.ptxas_report(log) == {
        "fast_scan": {"registers": 64, "spill_bytes": 0, "stack_bytes": 0, "smem_bytes": 1152},
        "fast_scan_global": {"registers": 67, "spill_bytes": 16, "stack_bytes": 32, "smem_bytes": 1152},
    }
