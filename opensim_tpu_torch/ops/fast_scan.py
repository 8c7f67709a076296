"""The bind scan: one hand-written Hopper kernel and its plain version.

For each pod of the stream, in order: filter the nodes (static row,
NodeResourcesFit, node validity, Open-Gpu-Share, hard PodTopologySpread),
score the feasible ones (least-allocated + balanced + 2·Simon share + 2·soft
spread, plus the NodeAffinity, TaintToleration and NodePreferAvoidPods
tables where present), take the lowest-index node among the best scores (or
the pin of a forced pod), and bind it (usage, selector counts and GPU
devices of the chosen node). This is the JAX package's Pallas megakernel
(``opensim_tpu/ops/pallas_scan.py``, ``_make_kernel`` through
``run_fast_scan``'s ``pl.pallas_call``) for the flags ``has_gpu`` (with
``gc_row``), ``has_na``, ``has_tt`` and ``has_avoid``.

- :func:`fast_scan` is the wrapper: on a CUDA tensor it launches
  ``csrc/fast_scan.cu`` (built with ``nvcc`` at first use, bound with
  ``ctypes``) or raises; on a CPU tensor it runs :func:`fast_scan_reference`.
- :func:`fast_scan_reference` is the plain PyTorch version: a Python loop
  over pods, vector ops over nodes, op for op the Pallas body's formulas.
  It runs on any device; the tests use it on the CPU, and the smoke script
  holds the kernel against it on the card.

Layouts (N nodes, R ≤ 8 resources, U templates, A selectors, K zone keys
with Z zone columns, Cs ≤ 8 spread constraints per template, Gd ≤ 8 GPUs
per node, P pods): node-minor ``[X, N]`` tables, so neighbouring threads
read neighbouring nodes. Float tables are float32, index tables int32. A
feature that is off has zero-size tables (``gc_row`` -1), and the kernel
variant that runs is chosen from them (:func:`variant`).
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..encoding import vocab as V

NEG = -1e30
BIG = 1e30
MAX_SCORE = 100.0
AVOID_WEIGHT = 10000.0  # NodePreferAvoidPods, no NormalizeScore
MAX_R = 8  # resource rows the kernel's per-pod tables take (csrc MAX_R)
MAX_CS = 8  # spread constraints per template (csrc MAX_CS)
MAX_GD = 8  # GPUs per node (csrc MAX_GD)

#: Number of kernel launches made through :func:`fast_scan` (CUDA only),
#: in all and by variant name (:func:`variant_name`).
LAUNCHES = 0
VARIANT_LAUNCHES: Dict[str, int] = {}

_SRC = Path(__file__).resolve().parent / "csrc" / "fast_scan.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


class FastInputs(NamedTuple):
    """Prepared tensors of the bind scan (engine/fastpath.build_inputs)."""

    alloc_T: torch.Tensor  # [R, N] f32 allocatable
    used0_T: torch.Tensor  # [R, N] f32 initial usage
    static_pass: torch.Tensor  # [U, N] f32 0/1 static filters
    aff_mask: torch.Tensor  # [U, N] f32 0/1 spread eligibility
    share_raw: torch.Tensor  # [U, N] f32 Simon share × 100
    zone_idx: torch.Tensor  # [K, N] i32 zone column of node n under zone key k, -1 = no label
    matches_AU: torch.Tensor  # [A, U] f32 template matches selector
    node_valid: torch.Tensor  # [N] f32 0/1
    req: torch.Tensor  # [U, R] f32
    cpu_nz: torch.Tensor  # [U] f32 cpu request, non-zero default
    mem_nz: torch.Tensor  # [U] f32 memory request, non-zero default
    pin: torch.Tensor  # [U] i32 node of a forced pod (-1 none, -2 unknown)
    spr_active: torch.Tensor  # [U, Cs] i32 0/1
    spr_key: torch.Tensor  # [U, Cs] i32 0 = hostname, 1..K = zone keys
    spr_sel: torch.Tensor  # [U, Cs] i32 selector id
    spr_skew: torch.Tensor  # [U, Cs] f32
    spr_hard: torch.Tensor  # [U, Cs] i32 0/1
    spr_self: torch.Tensor  # [U, Cs] f32 0/1 template matches its own selector
    spr_weight: torch.Tensor  # [U, Cs] f32 log(domain count + 2)
    # gpu share: [U], [U], [Gd, N]; [0], [0], [0, N] when off
    gpu_mem: torch.Tensor  # f32 per-GPU memory request
    gpu_cnt: torch.Tensor  # f32 GPUs requested
    gpu0: torch.Tensor  # f32 initial free memory of each GPU
    # static score tables: [U, N] f32 each, [0, N] when off
    na_raw: torch.Tensor  # preferred node-affinity weights
    tt_raw: torch.Tensor  # intolerable PreferNoSchedule taint counts
    avoid_raw: torch.Tensor  # NodePreferAvoidPods raw score (0 or 100)
    n_zones: int  # Z, zone columns of the count table (max over keys, >= 1)
    gc_row: int  # resource row of alibabacloud.com/gpu-count whose allocatable follows the GPUs, -1 off


class FastOutputs(NamedTuple):
    """What the scan returns, on the inputs' device."""

    chosen: torch.Tensor  # [P] i32 node of each pod, -1 when it did not bind
    used: torch.Tensor  # [R, N] f32 final usage
    gpu_take: torch.Tensor  # [P, Gd] f32 GPU slots each pod took per device ([P, 0] without gpu)
    gpu_free: torch.Tensor  # [Gd, N] f32 final free memory per GPU ([0, N] without gpu)


class Variant(NamedTuple):
    """Kernel variant: which flag branches of the Pallas body it carries."""

    gpu: bool
    gc: bool
    na: bool
    tt: bool
    avoid: bool


def variant(fi: FastInputs) -> Variant:
    return Variant(
        gpu=fi.gpu_mem.numel() > 0,
        gc=fi.gc_row >= 0,
        na=fi.na_raw.numel() > 0,
        tt=fi.tt_raw.numel() > 0,
        avoid=fi.avoid_raw.numel() > 0,
    )


def variant_name(fi: FastInputs) -> str:
    """``fast_scan`` for the base variant, else ``fast_scan[gpu,gc,...]``."""
    on = [k for k, v in variant(fi)._asdict().items() if v]
    return f"fast_scan[{','.join(on)}]" if on else "fast_scan"


_F32 = {"alloc_T", "used0_T", "static_pass", "aff_mask", "share_raw", "matches_AU",
        "node_valid", "req", "cpu_nz", "mem_nz", "spr_skew", "spr_self", "spr_weight",
        "gpu_mem", "gpu_cnt", "gpu0", "na_raw", "tt_raw", "avoid_raw"}


def _shapes(fi: FastInputs) -> Tuple[int, int, int, int, int, int, int]:
    R, N = fi.alloc_T.shape
    U = fi.static_pass.shape[0]
    A = fi.matches_AU.shape[0]
    K = fi.zone_idx.shape[0]
    Cs = fi.spr_active.shape[1]
    Gd = fi.gpu0.shape[0]
    return N, R, U, A, K, Cs, Gd


def _check(fi: FastInputs, tmpl, valid, forced) -> None:
    """Device, dtype, shape and contiguity of everything the kernel reads."""
    N, R, U, A, K, Cs, Gd = _shapes(fi)
    v = variant(fi)
    want = {
        "alloc_T": (R, N), "used0_T": (R, N), "static_pass": (U, N), "aff_mask": (U, N),
        "share_raw": (U, N), "zone_idx": (K, N), "matches_AU": (A, U), "node_valid": (N,),
        "req": (U, R), "cpu_nz": (U,), "mem_nz": (U,), "pin": (U,),
        "gpu_mem": (U if v.gpu else 0,), "gpu_cnt": (U if v.gpu else 0,), "gpu0": (Gd, N),
        "na_raw": (U if v.na else 0, N), "tt_raw": (U if v.tt else 0, N),
        "avoid_raw": (U if v.avoid else 0, N),
    }
    for f in ("spr_active", "spr_key", "spr_sel", "spr_skew", "spr_hard", "spr_self", "spr_weight"):
        want[f] = (U, Cs)
    dev = fi.alloc_T.device
    for name, shape in want.items():
        t = getattr(fi, name)
        dt = torch.float32 if name in _F32 else torch.int32
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fast_scan: {name} is {t.dtype}{tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()}); want contiguous {dt}{shape} on {dev}"
            )
    P = tmpl.shape[0]
    for name, t in (("tmpl", tmpl), ("valid", valid), ("forced", forced)):
        if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != (P,) or not t.is_contiguous():
            raise ValueError(f"fast_scan: {name} must be a contiguous int32 [{P}] tensor on {dev}")
    if R > MAX_R or Cs > MAX_CS or Gd > MAX_GD:
        raise ValueError(
            f"fast_scan: R={R} (max {MAX_R}), Cs={Cs} (max {MAX_CS}) or Gd={Gd} (max {MAX_GD}) outside the kernel"
        )
    if K < 1 or fi.n_zones < 1 or R <= V.RES_MEMORY:
        raise ValueError("fast_scan: needs K >= 1 zone-key rows, n_zones >= 1 and cpu/memory rows")
    if not v.gpu and (Gd > 0 or fi.gc_row >= 0) or fi.gc_row >= R:
        raise ValueError(
            f"fast_scan: gpu tables ({Gd} GPU rows, {fi.gpu_mem.numel()} templates) and gc_row={fi.gc_row} disagree"
        )


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

class _Args(ctypes.Structure):
    """FastScanArgs in csrc/fast_scan.cu, field for field (a CPU test holds
    the two lists equal)."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "tmpl", "valid", "forced", "alloc", "used0", "node_valid", "zone_idx",
        "static_pass", "aff_mask", "share_raw", "matches", "req", "cpu_nz", "mem_nz",
        "pin", "spr_active", "spr_key", "spr_sel", "spr_skew", "spr_hard", "spr_self",
        "spr_weight", "gpu_mem", "gpu_cnt", "gpu0", "na_raw", "tt_raw", "avoid_raw",
        "chosen", "used", "node_cnt", "zone_cnt", "gpu_take", "gpu_free",
    )] + [(n, ctypes.c_int32) for n in (
        "P", "N", "R", "U", "A", "K", "Z", "Cs", "Gd", "gc_row", "has_gpu", "has_na", "has_tt", "has_avoid",
    )]


_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG = {"seconds": None, "ptxas": "", "library": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("fast_scan: nvcc not found (needs the CUDA toolkit)")


def build() -> ctypes.CDLL:
    """Compile csrc/fast_scan.cu into ``_build/`` (once per source content)
    and load it. Raises when the build fails; there is no fallback."""
    global _LIB
    if _LIB is not None:
        return _LIB
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"fast_scan-{tag}.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        tmp = lib_path.with_suffix(f".{time.time_ns()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"fast_scan: nvcc failed ({proc.returncode}):\n{proc.stderr}")
        tmp.replace(lib_path)
        BUILD_LOG["ptxas"] = proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    lib.fast_scan_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.fast_scan_launch.restype = ctypes.c_int
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    BUILD_LOG["library"] = str(lib_path)
    _LIB = lib
    return lib


def _launch(fi: FastInputs, tmpl, valid, forced) -> FastOutputs:
    global LAUNCHES
    _check(fi, tmpl, valid, forced)
    lib = build()
    N, R, U, A, K, Cs, Gd = _shapes(fi)
    P, Z = tmpl.shape[0], fi.n_zones
    v = variant(fi)
    dev = fi.alloc_T.device
    f32 = torch.float32
    chosen = torch.empty((P,), dtype=torch.int32, device=dev)
    used = torch.empty((R, N), dtype=f32, device=dev)
    node_cnt = torch.empty((A, N), dtype=f32, device=dev)  # zeroed by the kernel
    zone_cnt = torch.empty((K * A, Z), dtype=f32, device=dev)
    gpu_take = torch.zeros((P, Gd), dtype=f32, device=dev)  # the kernel writes bound pods' rows only
    gpu_free = torch.empty((Gd, N), dtype=f32, device=dev)  # gpu0 copied in by the kernel
    ptr = lambda t: t.data_ptr()
    args = _Args(
        ptr(tmpl), ptr(valid), ptr(forced), ptr(fi.alloc_T), ptr(fi.used0_T),
        ptr(fi.node_valid), ptr(fi.zone_idx), ptr(fi.static_pass), ptr(fi.aff_mask),
        ptr(fi.share_raw), ptr(fi.matches_AU), ptr(fi.req), ptr(fi.cpu_nz), ptr(fi.mem_nz),
        ptr(fi.pin), ptr(fi.spr_active), ptr(fi.spr_key), ptr(fi.spr_sel), ptr(fi.spr_skew),
        ptr(fi.spr_hard), ptr(fi.spr_self), ptr(fi.spr_weight),
        ptr(fi.gpu_mem), ptr(fi.gpu_cnt), ptr(fi.gpu0), ptr(fi.na_raw), ptr(fi.tt_raw), ptr(fi.avoid_raw),
        ptr(chosen), ptr(used), ptr(node_cnt), ptr(zone_cnt), ptr(gpu_take), ptr(gpu_free),
        P, N, R, U, A, K, Z, Cs, Gd, fi.gc_row, int(v.gpu), int(v.na), int(v.tt), int(v.avoid),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fast_scan_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"fast_scan: kernel launch failed (cudaError {err})")
    LAUNCHES += 1
    name = variant_name(fi)
    VARIANT_LAUNCHES[name] = VARIANT_LAUNCHES.get(name, 0) + 1
    return FastOutputs(chosen, used, gpu_take, gpu_free)


def fast_scan(fi: FastInputs, tmpl, valid, forced) -> FastOutputs:
    """Run the bind scan over the pod stream. ``tmpl``/``valid``/``forced``
    are int32 ``[P]`` tensors on the inputs' device. Returns the chosen
    nodes (-1 for a pod that did not bind), the final usage, each pod's GPU
    slots per device and the final free memory per GPU.

    On a CUDA device this launches the kernel (one launch for the stream)
    or raises; on the CPU it runs the plain version."""
    dev = fi.alloc_T.device
    if dev.type == "cuda":
        return _launch(fi, tmpl, valid, forced)
    if dev.type == "cpu":
        return fast_scan_reference(fi, tmpl, valid, forced)
    raise ValueError(f"fast_scan: no kernel for device {dev}")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def fast_scan_reference(fi: FastInputs, tmpl, valid, forced) -> FastOutputs:
    """Plain PyTorch bind scan on any device: the Pallas body's formulas op
    for op (pallas_scan.py:395-782), one torch op at a time, so each float
    op rounds once as on the card. The template ids and the spread
    constraints' integer fields come to the host once, before the loop, so
    a template's rows are views and the constraint branches are Python
    branches; the bind indexes the chosen node with a one-element tensor.
    So nothing inside the loop waits for the device. Sums and prefix sums
    over GPUs run device by device, in the Pallas body's order; only exact
    ops (min, counts of 0/1 flags) are vectorised over them."""
    N, R, U, A, K, Cs, Gd = _shapes(fi)
    Z = fi.n_zones
    v = variant(fi)
    dev = fi.alloc_T.device
    f32 = torch.float32
    tmpl = tmpl.tolist()
    spr_active, spr_key, spr_sel, spr_hard = (
        t.tolist() for t in (fi.spr_active, fi.spr_key, fi.spr_sel, fi.spr_hard)
    )
    valid = valid.to(dev) != 0
    forced = forced.to(dev) != 0
    P = len(tmpl)

    used = fi.used0_T.clone()
    node_cnt = torch.zeros((A, N), dtype=f32, device=dev)
    # column Z is a "no label" column: nodes without the key gather from it,
    # and it stays 0 because binds add 0 there
    zone_cnt = torch.zeros((K, A, Z + 1), dtype=f32, device=dev)
    zone_col = torch.where(fi.zone_idx >= 0, fi.zone_idx, Z).long()  # [K, N]
    has_zone = (fi.zone_idx >= 0).to(f32)  # [K, N]
    iota_n = torch.arange(N, dtype=torch.int32, device=dev)
    valid_row = fi.node_valid
    ones_n = torch.ones((N,), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    chosen = torch.empty((P,), dtype=torch.int32, device=dev)
    gpu_free = fi.gpu0.clone()
    gpu_take = torch.zeros((P, Gd), dtype=f32, device=dev)
    if v.gc:
        # devices a node has (gpu0 > 0) never change: the count of its
        # not-fully-used devices is a sum of 0/1 flags, exact in any order
        gc_valid = (fi.gpu0 > 0).to(f32)  # [Gd, N]
        gc_has_dev = gc_valid.amax(0) if Gd else torch.zeros((N,), dtype=f32, device=dev)

    for i in range(P):
        u = tmpl[i]
        # --- NodeResourcesFit, static row, validity
        req_u = fi.req[u]  # [R]
        if v.gc:
            # dynamic gpu-count allocatable (pallas_scan.py:401-419)
            gc_dyn_row = (gc_valid * (gpu_free > 0).to(f32)).sum(0)
        fit = ones_n
        for r in range(R):
            alloc_r = fi.alloc_T[r]
            if v.gc and r == fi.gc_row:
                alloc_r = torch.where(gc_has_dev > 0, gc_dyn_row, alloc_r)
            over = (used[r] + req_u[r] > alloc_r).to(f32)
            fit = fit * torch.where(req_u[r] > 0, 1.0 - over, 1.0)
        feasible = fi.static_pass[u] * fit * valid_row

        if v.gpu:
            # Open-Gpu-Share filter: sum_d floor(free_d / mem) >= count
            gmem, gcnt = fi.gpu_mem[u], fi.gpu_cnt[u]
            gmem1 = torch.clamp(gmem, min=1.0)
            chunks_sum = torch.zeros((N,), dtype=f32, device=dev)
            for d in range(Gd):
                chunks_sum = chunks_sum + torch.floor(gpu_free[d] / gmem1)
            gpu_ok = ((chunks_sum >= gcnt) & (gcnt > 0)).to(f32)
            feasible = torch.where(gmem > 0, feasible * gpu_ok, feasible)

        # --- PodTopologySpread
        aff_row = fi.aff_mask[u] * valid_row
        soft_raw = torch.zeros((N,), dtype=f32, device=dev)
        ignored = torch.zeros((N,), dtype=f32, device=dev)
        any_soft = False
        for c in range(Cs):
            if spr_active[u][c] != 1:
                continue  # an inactive constraint changes nothing
            key, sel = spr_key[u][c], spr_sel[u][c]
            skew = fi.spr_skew[u, c]
            if key == 0:
                cnt, has_label = node_cnt[sel], ones_n
            else:
                cnt, has_label = zone_cnt[key - 1, sel][zone_col[key - 1]], has_zone[key - 1]
            if spr_hard[u][c] == 1:
                elig = aff_row * has_label
                masked = torch.where(elig > 0, cnt, BIG)
                min_cnt = torch.min(masked)
                ok = (cnt + fi.spr_self[u, c] - min_cnt <= skew) & (has_label > 0)
                feasible = feasible * ok.to(f32)
            else:
                contrib = torch.where(has_label > 0, cnt * fi.spr_weight[u, c] + (skew - 1.0), 0.0)
                soft_raw = soft_raw + contrib
                ignored = torch.maximum(ignored, 1.0 - has_label)
                any_soft = True

        # --- scores
        alloc_cpu = fi.alloc_T[V.RES_CPU]
        alloc_mem = fi.alloc_T[V.RES_MEMORY]
        used_cpu = used[V.RES_CPU] + fi.cpu_nz[u]
        used_mem = used[V.RES_MEMORY] + fi.mem_nz[u]
        l_cpu = torch.where(
            (alloc_cpu == 0) | (used_cpu > alloc_cpu),
            0.0,
            (alloc_cpu - used_cpu) * MAX_SCORE / torch.clamp(alloc_cpu, min=1.0),
        )
        l_mem = torch.where(
            (alloc_mem == 0) | (used_mem > alloc_mem),
            0.0,
            (alloc_mem - used_mem) * MAX_SCORE / torch.clamp(alloc_mem, min=1.0),
        )
        least = (l_cpu + l_mem) / 2.0
        cpu_frac = used_cpu / torch.clamp(alloc_cpu, min=1.0)
        mem_frac = used_mem / torch.clamp(alloc_mem, min=1.0)
        balanced = torch.where(
            (cpu_frac >= 1.0) | (mem_frac >= 1.0),
            0.0,
            (1.0 - torch.abs(cpu_frac - mem_frac)) * MAX_SCORE,
        )
        share_row = fi.share_raw[u]
        if v.gc:
            # gpu-count share with the Reserve-updated count (:614-630)
            gc_req = req_u[fi.gc_row]
            declared = (fi.alloc_T[fi.gc_row] > 0).to(f32)
            avail = gc_dyn_row - gc_req
            sh = torch.where(
                avail == 0,
                torch.where(gc_req == 0, 0.0, 1.0),
                gc_req / torch.where(avail == 0, 1.0, avail),
            )
            sh = torch.where((declared > 0) & (gc_has_dev > 0), torch.clamp(sh, min=0.0), 0.0) * MAX_SCORE
            share_row = torch.maximum(share_row, torch.where(gc_req > 0, sh, 0.0))
        feas_b = feasible > 0
        lo = torch.min(torch.where(feas_b, share_row, BIG))
        hi = torch.max(torch.where(feas_b, share_row, NEG))
        rng = hi - lo
        share_norm = torch.where(rng > 0, (share_row - lo) * MAX_SCORE / rng, 0.0)

        scored = feas_b & (ignored == 0)
        smn = torch.min(torch.where(scored, soft_raw, BIG))
        smx = torch.max(torch.where(scored, soft_raw, NEG))
        spread_norm = torch.where(
            smx <= 0, MAX_SCORE, MAX_SCORE * (smx + smn - soft_raw) / torch.clamp(smx, min=1.0)
        )
        spread_norm = torch.where(ignored > 0, 0.0, spread_norm)
        if not any_soft:
            spread_norm = torch.zeros_like(spread_norm)

        score = least + balanced + 2.0 * share_norm + 2.0 * spread_norm
        if v.na:
            # NodeAffinity preferred weights, max-normalised over the feasible set
            na_row = fi.na_raw[u]
            na_max = torch.max(torch.where(feas_b, na_row, 0.0))
            score = score + torch.where(
                na_max > 0, na_row * MAX_SCORE / torch.clamp(na_max, min=1.0), na_row
            )
        if v.tt:
            # TaintToleration: intolerable PreferNoSchedule counts, reversed
            tt_row = fi.tt_raw[u]
            tt_max = torch.max(torch.where(feas_b, tt_row, 0.0))
            score = score + torch.where(
                tt_max > 0, MAX_SCORE - tt_row * MAX_SCORE / torch.clamp(tt_max, min=1.0), MAX_SCORE
            )
        if v.avoid:
            score = score + AVOID_WEIGHT * fi.avoid_raw[u]

        # --- selectHost: lowest index among the maxima; pins for forced pods
        masked_score = torch.where(feas_b, score, NEG)
        mx_score = torch.max(masked_score)
        best = torch.min(torch.where(masked_score == mx_score, iota_n, N))
        any_feasible = torch.max(feasible) > 0
        sel_choice = torch.where(any_feasible, best, -1)
        pin_u = fi.pin[u]
        choice = torch.where(forced[i], torch.where(pin_u >= 0, pin_u, -1), sel_choice)
        do_bind = valid[i] & (choice >= 0)
        chosen[i] = torch.where(do_bind, choice, -1)

        # --- bind (adds exact zeros when nothing binds); the chosen node is
        # a one-element index tensor, so no value comes back to the host
        c = torch.clamp(choice, min=0).long().reshape(1)
        bind_f = do_bind.to(f32)
        used[:, c] = used[:, c] + (req_u * bind_f)[:, None]
        m_col = fi.matches_AU[:, u] * bind_f  # [A]
        node_cnt[:, c] = node_cnt[:, c] + m_col[:, None]
        for kk in range(K):
            z = zone_col[kk][c]
            zone_k = zone_cnt[kk]  # [A, Z + 1] view
            zone_k[:, z] = zone_k[:, z] + (m_col * has_zone[kk][c])[:, None]
        if v.gpu and Gd:
            # device packing on the chosen node (:759-782): one GPU takes
            # the tightest fit (first among equals), several take greedy
            # chunks with reuse, in device order
            gmem, gcnt = fi.gpu_mem[u], fi.gpu_cnt[u]
            free = gpu_free[:, c][:, 0]  # [Gd]
            fits = free >= gmem
            best_free = torch.min(torch.where(fits, free, BIG))
            tight = fits & (free == best_free)
            take_tight = (tight & (torch.cumsum(tight.to(torch.int32), 0) == 1)).to(f32)
            chunks = torch.floor(free / torch.clamp(gmem, min=1.0))
            cum = torch.empty_like(chunks)  # exclusive prefix, added device by device
            acc = zero
            for d in range(Gd):
                cum[d] = acc
                acc = acc + chunks[d]
            take_greedy = torch.minimum(torch.clamp(gcnt - cum, min=0.0), chunks)
            take = torch.where(gcnt == 1, take_tight, take_greedy)
            take = torch.where(gmem > 0, take, 0.0)
            gpu_free[:, c] = (free - take * gmem * bind_f)[:, None]
            gpu_take[i] = take * bind_f

    return FastOutputs(chosen, used, gpu_take, gpu_free)


# ---------------------------------------------------------------------------
# work accounting (for the bound a run is held against)
# ---------------------------------------------------------------------------

#: Float ops per (scheduled pod, node), besides 3 per resource row and
#: 8 per active spread constraint: feasibility 2, share/spread reductions 5,
#: least-allocated 16, balanced 10, share norm 3, spread norm 5, score sum 5,
#: selectHost 2.
_OPS_PER_NODE = 48
#: Per (scheduled pod, node) of the flag branches: the GPU filter 3 per GPU
#: plus 4 (only for a template asking GPU memory); the dynamic gpu-count
#: allocatable 4 per GPU plus 1, and its share add-back 10; NodeAffinity 6,
#: TaintToleration 7, NodePreferAvoidPods 2.
_GPU_FILTER_PER_GD, _GPU_FILTER = 3, 4
_GC_PER_GD, _GC = 4, 11
_NA, _TT, _AVOID = 6, 7, 2
#: Per bound pod: the device packing, 14 per GPU.
_GPU_BIND_PER_GD = 14

#: FastInputs tables with a node axis (their last one).
_NODE_AXIS = {"alloc_T", "used0_T", "static_pass", "aff_mask", "share_raw", "zone_idx", "node_valid",
              "gpu0", "na_raw", "tt_raw", "avoid_raw"}


def fast_scan_work(fi: FastInputs, tmpl, valid, forced, chosen) -> dict:
    """Bytes the scan must move (each input read once, each output written
    once) and float ops that this stream's pods need, over the valid node
    lanes only (padding lanes need no work): a scheduled pod does the
    per-node work of its own template's active constraints and of the
    variant's flag branches, a pod that bound (``chosen`` >= 0, the scan's
    result) its bind."""
    N, R, U, A, K, Cs, Gd = _shapes(fi)
    v = variant(fi)
    n_valid = int((fi.node_valid != 0).sum())
    in_bytes = sum(t.numel() * t.element_size() for t in (tmpl, valid, forced))
    for name, t in fi._asdict().items():
        if isinstance(t, torch.Tensor):
            lanes = n_valid / N if name in _NODE_AXIS else 1
            in_bytes += int(t.numel() * lanes) * t.element_size()
    P = int(tmpl.shape[0])
    out_bytes = P * 4 + R * n_valid * 4 + P * Gd * 4 + Gd * n_valid * 4
    tm = tmpl.long().cpu()
    vd = valid.cpu() != 0
    fd = forced.cpu() != 0
    bound = vd & (chosen.cpu() >= 0)
    active = (fi.spr_active.cpu() == 1).sum(1)[tm]  # [P]
    per_node = _OPS_PER_NODE + 3 * R + 8 * active
    per_bind = torch.full((P,), R + A * (1 + K), dtype=torch.int64)
    if v.gpu:
        asks = (fi.gpu_mem.cpu() > 0)[tm]
        per_node = per_node + asks * (_GPU_FILTER_PER_GD * Gd + _GPU_FILTER)
        per_bind = per_bind + asks * (_GPU_BIND_PER_GD * Gd)
    per_node = per_node + v.gc * (_GC_PER_GD * Gd + _GC) + v.na * _NA + v.tt * _TT + v.avoid * _AVOID
    sched = vd & ~fd
    ops = int((per_node[sched] * n_valid).sum()) + int(per_bind[bound].sum())
    return {"bytes": in_bytes + out_bytes, "ops": ops}
