"""The Python around the scenario grid's kernel, which runs only on a card:
the grid's shape (scenarios per block, blocks, shared memory) and the
packing of each scenario's node validity into an N-bit mask."""

import pathlib
import re

import numpy as np
import pytest
import torch

from opensim_tpu_torch.ops import fast_scan as fs

SRC = (pathlib.Path(fs.__file__).parent / "csrc" / "fast_scan.cu").read_text()


def _slots(g, S):
    """Scenario of each (block, slot) the kernel runs: block k, slot j is
    scenario k·b + j where that is below S."""
    return [k * g.b + j for k in range(g.blocks) for j in range(g.b) if k * g.b + j < S]


def test_one_scenario_per_block_up_to_the_sms():
    for S in range(1, fs.H100_SMS + 1):
        g = fs.sweep_grid(S, 5000)
        assert (g.b, g.blocks, g.threads) == (1, S, fs.SWEEP_THREADS)


def test_one_wave_up_to_b_max_scenarios_per_sm():
    for S in range(1, fs.H100_SMS * fs.SWEEP_B_MAX + 1):
        g = fs.sweep_grid(S, 5000)
        assert g.blocks <= fs.H100_SMS and 1 <= g.b <= fs.SWEEP_B_MAX, S
    assert fs.sweep_grid(fs.H100_SMS * fs.SWEEP_B_MAX + 1, 5000).blocks == fs.H100_SMS + 1


@pytest.mark.parametrize("S", [1, 3, 132, 133, 1000, 1057])
def test_every_scenario_in_exactly_one_block_slot(S):
    g = fs.sweep_grid(S, 5000)
    slots = _slots(g, S)
    assert sorted(slots) == list(range(S)) and len(set(slots)) == S
    assert (g.blocks - 1) * g.b < S  # no block without a scenario
    assert g.b == min(fs.SWEEP_B_MAX, -(-S // fs.H100_SMS))


def test_shared_memory_fits_the_masks_up_to_a_hundred_thousand_nodes():
    rng = np.random.default_rng(7)
    for N in [64, 100, 1000, 5000, 65536, 100000, *rng.integers(64, 100001, size=20).tolist()]:
        for S in (1, 133, 1000, 5000):
            g = fs.sweep_grid(S, N)
            assert 0 < g.smem <= fs.SMEM_MAX - fs.SWEEP_STATIC_SMEM <= 232448, (N, S)
            assert g.words == -(-N // 32) and g.smem == g.b * g.words * 4 * 2  # validity and feasibility
            assert g.b == min(fs.SWEEP_B_MAX, -(-S // fs.H100_SMS)), (N, S)  # room for b_max up to here


def test_past_shared_memory_b_shrinks_then_the_masks_go_to_global_memory():
    g = fs.sweep_grid(1000, 1 << 19)  # one scenario's masks fit
    assert (g.b, g.blocks) == (1, 1000) and 0 < g.smem <= fs.SMEM_MAX - fs.SWEEP_STATIC_SMEM
    g = fs.sweep_grid(1000, 4_000_000)  # none fit: every N that why_not admits still runs
    assert g.smem == 0 and g.b == fs.SWEEP_B_MAX and sorted(_slots(g, 1000)) == list(range(1000))


def test_grid_constants_match_the_cuda_source():
    defines = dict(re.findall(r"#define (\w+) (\d+)", SRC))
    assert int(defines["SWEEP_STATIC_SMEM"]) == fs.SWEEP_STATIC_SMEM
    assert int(defines["MAX_K"]) == fs.MAX_K
    assert (int(defines["BMAX"]), int(defines["SW_NT"])) == (fs.SWEEP_B_MAX, fs.SWEEP_THREADS)
    assert fs.SWEEP_THREADS % 32 == 0 and fs.SWEEP_B_MAX <= 32  # warps; a bit per slot


@pytest.mark.parametrize("N", [1, 31, 32, 33, 100, 5000])
def test_node_validity_packs_into_n_bit_masks(N):
    rng = np.random.default_rng(N)
    rows = (rng.random((5, N)) < 0.7).astype(np.float32)
    rows[0] = 1.0  # every bit set, the sign bit of each full word too
    words = fs.pack_bits(torch.from_numpy(rows))
    assert words.dtype == torch.int32 and tuple(words.shape) == (5, -(-N // 32))
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    for n in range(N):
        assert ((w[:, n >> 5] >> (n & 31)) & 1 == rows[:, n]).all()
    pad = np.arange(N, words.shape[1] * 32)
    assert not ((w[:, pad >> 5] >> (pad & 31)) & 1).any()  # padding bits are 0
    unpacked = (w[:, :, None] >> np.arange(32)) & 1
    assert (unpacked.reshape(5, -1)[:, :N] == rows).all()  # unpacks to the float row exactly


def test_ptxas_report_reads_each_kernel():
    log = (
        "ptxas info    : Compiling entry function '_Z16fast_scan_kernelILb0EEEv17FastScanArgs' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z16fast_scan_kernelILb0EEEv17FastScanArgs\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 56 registers, 4352 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z22fast_scan_sweep_kernelILb0EEEv17FastScanArgs' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z22fast_scan_sweep_kernelILb0EEEv17FastScanArgs\n"
        "    96 bytes stack frame, 40 bytes spill stores, 32 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 17000 bytes smem\n"
    )
    assert fs.ptxas_report(log) == {
        "fast_scan": {"registers": 56, "spill_bytes": 0, "stack_bytes": 0, "smem_bytes": 4352},
        "fast_scan_sweep": {"registers": 128, "spill_bytes": 72, "stack_bytes": 96, "smem_bytes": 17000},
    }
    assert fs.ptxas_report("") == {}
