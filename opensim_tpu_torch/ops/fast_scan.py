"""The bind scan: one hand-written Hopper kernel and its plain version.

For each pod of the stream, in order: filter the nodes (static row,
NodeResourcesFit, node validity, NodePorts, Open-Gpu-Share, Open-Local,
hard PodTopologySpread, InterPodAffinity), score the feasible ones
(least-allocated + balanced + 2·Simon share + 2·soft spread, plus the
NodeAffinity, TaintToleration and NodePreferAvoidPods tables, the
Open-Local binpack score and the inter-pod preferred score where present),
take the lowest-index node among the best scores (or the pin of a forced
pod), and bind it (usage, selector counts, host ports, GPU devices, volume
groups and exclusive devices, inter-pod term counts of the chosen node). A
pod that finds no node gets its failure attribution: per dynamic filter,
the nodes that fail it first, and per resource, the nodes short of it
(``kernels.pod_step``'s ``count_fails`` in the JAX package, which runs it
outside the Pallas kernel).
This is the JAX package's Pallas megakernel
(``opensim_tpu/ops/pallas_scan.py``, ``_make_kernel`` through
``run_fast_scan``'s ``pl.pallas_call``) for the flags ``has_gpu`` (with
``gc_row``), ``has_na``, ``has_tt``, ``has_avoid``, ``has_ports``,
``has_interpod`` and ``has_local``, and its scenario sweep
(``run_fast_scan`` under ``jax.vmap`` in ``engine/fastpath.sweep``). Three
paths the JAX package runs on its XLA scan instead (``scheduler._step``
over ``kernels.pod_step``) run here too: a scheduler config
(``FastInputs.cfg``: the score parts weighted and summed in
``score_parts`` order, dynamic filters switched off, fit-ignored resource
rows), a given initial state (``init``, in the cfg variants, so
consecutive launches carry the state, as the reference's segmented
profiles carry its scan state), and,
in the one scan, the sampled tie-break (``tie_seed``: the highest
Philox-4x32-10 draw among each step's best scores) and explain mode
(``explain``: the failure attribution counted on every step that runs the
pipeline, ``kernels.pod_step``'s ``count_all``, against the state before
the step's bind).

- :func:`fast_scan` is the wrapper: on a CUDA tensor it launches
  ``csrc/fast_scan.cu`` (one shared object per kernel variant, built with
  ``nvcc`` at first use and bound with ``ctypes``) or raises; on a CPU
  tensor it runs :func:`fast_scan_reference`.
- :func:`fast_scan_sweep` runs S scans that share the template tables and
  differ in node validity, spread weights, pod validity and forced masks:
  one launch of the sweep kernel in the same shared object, whose blocks
  each run B scenarios in lockstep (:func:`sweep_grid` shapes the grid);
  on the CPU, :func:`fast_scan_sweep_reference`. With ``count`` (the
  ``[count]`` variant) or ``explain`` it counts each scenario's failures as
  the one scan does, one scenario a block: the request batch's grid
  (``engine/reqbatch.py``), as the JAX package's batch runs its XLA scan
  with ``count_fails`` or ``count_all`` under ``jax.vmap``.
- :func:`fast_scan_reference` is the plain PyTorch version: a Python loop
  over pods, vector ops over nodes, op for op the Pallas body's formulas
  (with a config, ``kernels.pod_step``'s weighted sum). It runs on any
  device; the tests use it on the CPU, and the smoke script holds the
  kernel against it on the card.

Layouts (N nodes, R ≤ 8 resources, U templates, A selectors, K zone keys
with Z zone columns, Cs ≤ 8 spread constraints per template, Gd ≤ 8 GPUs
per node, Hp host-port ids, Ti/Tn/Tp required-affinity/anti/preferred
terms per template, G/Gp existing-pod anti/preferred term rows, Vg volume
groups and Dv ≤ 64 exclusive devices per node, Mv device volumes per
template and media, P pods, S scenarios): node-minor ``[X, N]`` tables,
so neighbouring threads read neighbouring nodes. Float tables are float32,
index tables int32. A feature that is off has zero-size tables (``gc_row``
-1), and the kernel variant that runs is chosen from them (:func:`variant`).

Byte counts of the storage tables are float32, as in the JAX package: GiB
multiples stay exact (600 GiB = 75·2^33), and the kernel and the plain
version do the same single ops in the same order, so any input gives the
same bits in both.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch

from ..encoding import vocab as V
from ..obs.profile import COMPILES
from ..utils import jitcache
from .kernels import F_FIT, F_GPU, F_INTERPOD, F_LOCAL, F_PORTS, F_SPREAD, NUM_FILTERS, SCORE_PARTS, KernelConfig

NEG = -1e30
BIG = 1e30
MAX_SCORE = 100.0
AVOID_WEIGHT = 10000.0  # NodePreferAvoidPods, no NormalizeScore
MAX_R = 8  # resource rows the kernel's per-pod tables take (csrc MAX_R)
MAX_CS = 8  # spread constraints per template (csrc MAX_CS)
MAX_GD = 8  # GPUs per node (csrc MAX_GD)
MAX_DV = 64  # exclusive devices per node: the bits of the bind's per-pod taken mask (csrc MAX_DV)
MAX_K = 4  # zone keys (csrc MAX_K; engine/fastpath.MAX_ZONE_KEYS)
#: Slots of a failing pod's first-fail counts (csrc N_FAIL): the dynamic
#: filters kernels.F_PORTS..F_EXTRA, in that order (ports, fit, spread,
#: inter-pod, gpu, local, extra).
N_FAIL = NUM_FILTERS - F_PORTS

#: The one scan's cluster, fixed in the kernel (csrc CL and NT): the node
#: axis split over SCAN_CLUSTER CTAs of SCAN_THREADS threads, one thread-block
#: cluster. Measured on the card among 4, 8 and 16 CTAs at 640 or 1024
#: threads (PERF.md §6).
SCAN_CLUSTER = 8
SCAN_THREADS = 640
#: Shared memory the one scan's static arrays may take (csrc
#: SCAN_STATIC_SMEM); the rest holds a CTA's slice (:func:`scan_shape`).
SCAN_STATIC_SMEM = 4096

#: The scenario grid's shape, fixed in the kernel (csrc BMAX and SW_NT): at
#: most SWEEP_B_MAX scenarios per block, run in lockstep by SWEEP_THREADS
#: threads. Measured on the card among B_max 2/4/8 at 512 or 1024 threads
#: (PERF.md §6).
SWEEP_B_MAX = 4
SWEEP_THREADS = 512
#: SMs of one H100 SXM, the grid's default width: B = ceil(S / SMs), at
#: most SWEEP_B_MAX.
H100_SMS = 132
#: Shared memory one block may take on Hopper, and the part of it that the
#: sweep kernel's static arrays may take (csrc SWEEP_STATIC_SMEM); the rest
#: holds the blocks' bit masks.
SMEM_MAX = 232448
SWEEP_STATIC_SMEM = 24576
#: What the one-scan launcher returns when no cluster of SCAN_CLUSTER CTAs
#: fits on the card (csrc SCAN_UNSCHEDULABLE).
SCAN_UNSCHEDULABLE = -1
#: Pods whose sampled tie-break draws the plain version computes at once.
DRAW_CHUNK = 256

#: Number of kernel launches made through :func:`fast_scan` and
#: :func:`fast_scan_sweep` (CUDA only; kept under ``_LAUNCH_LOCK``, as the
#: server launches from its dispatcher and worker threads), in all and by
#: row name
#: (:func:`variant_name`, :func:`sweep_name`); per one-scan row name, the
#: shape of its last launch (:class:`ScanShape`), the ptxas report of the
#: kernel it ran and that launch's ``count_clock`` (an int64 [2] tensor on
#: the card: the nanoseconds its counting passes took, by the card's global
#: timer on the cluster's first CTA, and how many ran, one per pod that
#: found no node), and per sweep row name the grid of its last launch
#: (:class:`SweepGrid`) and the ptxas report of the sweep kernel it ran
#: (:func:`ptxas_report`).
LAUNCHES = 0
VARIANT_LAUNCHES: Dict[str, int] = {}
SCAN_LAUNCHED: Dict[str, dict] = {}
SWEEP_LAUNCHED: Dict[str, dict] = {}
_LAUNCH_LOCK = threading.Lock()

_SRC = Path(__file__).resolve().parent / "csrc" / "fast_scan.cu"
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
    # host ports: [Hp, U] f32 each, [0, U] when off
    port_HU: torch.Tensor  # how often the template uses port id h (the bind adds it)
    port_conf_HU: torch.Tensor  # 0/1: port id h conflicts with one of the template's (wildcards expanded)
    # inter-pod terms of the incoming pod: [U, T] each, [U, 0] when off; key
    # 0 = hostname, 1..K = zone keys
    at_active: torch.Tensor  # i32 required affinity (Ti), selector = all terms' conjunction
    at_key: torch.Tensor  # i32
    at_sel: torch.Tensor  # i32
    at_self: torch.Tensor  # f32 0/1 the template matches the term's selector
    an_active: torch.Tensor  # i32 required anti-affinity (Tn)
    an_key: torch.Tensor  # i32
    an_sel: torch.Tensor  # i32
    pt_active: torch.Tensor  # i32 preferred terms (Tp)
    pt_key: torch.Tensor  # i32
    pt_sel: torch.Tensor  # i32
    pt_w: torch.Tensor  # f32 signed weight (anti terms negative)
    # existing pods' terms, one row per (selector, key): [G]/[G, U] anti,
    # [Gp]/[Gp, U] preferred and hard-affinity weights; zero rows when off
    anti_g_key: torch.Tensor  # i32 [G]
    antig_GU: torch.Tensor  # f32 [G, U] 0/1 the template carries anti row g
    gmatch_GU: torch.Tensor  # f32 [G, U] 0/1 the template matches row g's selector
    prefg_key: torch.Tensor  # i32 [Gp]
    prefg_GU: torch.Tensor  # f32 [Gp, U] signed weight the template carries on row g
    pmatch_GU: torch.Tensor  # f32 [Gp, U] 0/1 the template matches row g's selector
    # open-local storage, bytes: [U], [U, 2], [U, 2], [U, 2·Mv] per template
    # ([0], [0, 2], [0, 2], [0, 0] when off); media 0 = ssd, 1 = hdd
    lvm_req: torch.Tensor  # f32 LVM bytes
    dev_req: torch.Tensor  # f32 largest exclusive-device volume per media (the score's size)
    dev_need: torch.Tensor  # f32 exclusive-device volumes per media (the score's count)
    dev_sizes: torch.Tensor  # f32 each media's volume sizes, descending, 0-padded (ssd slots, then hdd)
    # and per node: [Vg, N], [Vg, N], [Dv, N], [Dv, N], [2·Dv, N] (zero rows when off)
    vg_cap: torch.Tensor  # f32 volume-group capacity
    vg0: torch.Tensor  # f32 initial free bytes per volume group
    dev_cap: torch.Tensor  # f32 device capacity
    dev0: torch.Tensor  # f32 initial free bytes per device (0 = taken or absent)
    dev_media: torch.Tensor  # f32 0/1 media one-hots: row m·Dv + d is device d of media m
    n_zones: int  # Z, zone columns of the count table (max over keys, >= 1)
    gc_row: int  # resource row of alibabacloud.com/gpu-count whose allocatable follows the GPUs, -1 off
    cfg: Optional[KernelConfig] = None  # a scheduler config's launch arguments (kernels.kernel_config); None: the default


class FastOutputs(NamedTuple):
    """What the scan returns, on the inputs' device (a sweep's fields have
    a leading scenario axis; from the kernel, the float state fields are
    views into one per-launch arena, not contiguous across scenarios).

    ``fail_counts`` and ``insufficient`` hold a row per pod: zeros, except
    on a valid pod that is not forced and finds no node, where they hold
    its failure attribution (kernels.pod_step's count_fails); in explain
    mode, every pod that is not forced holds its attribution against the
    state before its step, valid or not, bound or not (the reference's
    ``count_all``, which runs the pipeline for every such pod). Over the
    nodes that pass the static row with node validity folded in, each node
    counts under the first of the dynamic filters it fails, in that order:
    ports, fit, spread (hard constraints), inter-pod, gpu, local, extra
    (none registered: 0); the static filters' counts are the template's
    ``static_fail`` row. ``insufficient[r]`` counts the nodes that reach the
    fit filter and lack resource r (``req > 0`` and ``used + req > alloc``,
    with the dynamic gpu-count allocatable). A forced pod's row stays zero,
    as the reference's skip_pipeline returns; outside explain mode an
    invalid pod's row is zero and never read (decode drops invalid pods).
    A scenario grid counts in its ``count`` and ``explain`` variants only;
    otherwise its two count fields have width 0 (:func:`fast_scan_sweep`).

    ``state`` is the whole final scan state as one float32 row in the
    layout of :func:`state_layout` (from the kernel, its arena row, which
    the fields above view): what a later launch takes as ``init`` to go on
    from there."""

    chosen: torch.Tensor  # [P] i32 node of each pod, -1 when it did not bind
    used: torch.Tensor  # [R, N] f32 final usage
    gpu_take: torch.Tensor  # [P, Gd] f32 GPU slots each pod took per device ([P, 0] without gpu)
    gpu_free: torch.Tensor  # [Gd, N] f32 final free memory per GPU ([0, N] without gpu)
    port_used: torch.Tensor  # [Hp, N] f32 final host-port use per port id ([0, N] without ports)
    vg_free: torch.Tensor  # [Vg, N] f32 final free bytes per volume group ([0, N] without local)
    dev_free: torch.Tensor  # [Dv, N] f32 final free bytes per device, 0 once taken ([0, N] without local)
    fail_counts: torch.Tensor  # [P, N_FAIL] i32 first-fail node counts per dynamic filter ([S, P, 0]: see above)
    insufficient: torch.Tensor  # [P, R] i32 nodes short of each resource ([S, P, 0] from a grid that does not count)
    state: torch.Tensor  # [W] f32 the final state (:func:`state_layout`)


#: The outputs both kernels compute: the placements and the final state
#: (a grid that does not count leaves the two count fields empty).
STATE_FIELDS = FastOutputs._fields[:7] + ("state",)


class Variant(NamedTuple):
    """Kernel variant: which flag branches of the Pallas body it carries,
    then whether it takes a scheduler config, (one scan only) whether it
    samples its ties, whether it counts every step (explain mode) and
    (grid only) whether it counts the steps that find no node. Field i is
    bit i of the variant number the CUDA build takes."""

    gpu: bool
    gc: bool
    na: bool
    tt: bool
    avoid: bool
    ports: bool
    interpod: bool
    local: bool
    cfg: bool
    sample: bool
    explain: bool
    count: bool


def variant(fi: FastInputs, sample: bool = False, explain: bool = False, count: bool = False) -> Variant:
    """The variant that runs on these inputs; `sample`: with a tie seed;
    `explain`: in explain mode; `count`: a grid that counts failures."""
    return Variant(
        gpu=fi.gpu_mem.numel() > 0,
        gc=fi.gc_row >= 0,
        na=fi.na_raw.numel() > 0,
        tt=fi.tt_raw.numel() > 0,
        avoid=fi.avoid_raw.numel() > 0,
        ports=fi.port_HU.shape[0] > 0,
        interpod=any(n > 0 for n in (fi.at_active.shape[1], fi.an_active.shape[1], fi.pt_active.shape[1],
                                     fi.anti_g_key.numel(), fi.prefg_key.numel())),
        local=fi.lvm_req.numel() > 0,
        cfg=fi.cfg is not None,
        sample=sample,
        explain=explain,
        count=count,
    )


def _name(v: Variant) -> str:
    on = [k for k, flag in v._asdict().items() if flag]
    return f"fast_scan[{','.join(on)}]" if on else "fast_scan"


def variant_name(fi: FastInputs, sample: bool = False, explain: bool = False, count: bool = False) -> str:
    """``fast_scan`` for the base variant, else ``fast_scan[gpu,gc,...]``
    (``cfg`` with a config, ``sample`` with a tie seed, ``explain`` in
    explain mode, ``count`` for a counting grid, whose shared object holds
    the grid alone)."""
    return _name(variant(fi, sample, explain, count))


def sweep_name(fi: FastInputs, count: bool = False, explain: bool = False) -> str:
    """The launch-count name of :func:`fast_scan_sweep` on these inputs:
    ``fast_scan_sweep``, or ``fast_scan_sweep[...]`` with the variant's
    flags (``count`` or ``explain`` for a grid that counts). The sweep runs
    the shared object of :func:`variant_name` with the same flags."""
    return "fast_scan_sweep" + variant_name(fi, explain=explain, count=count)[len("fast_scan"):]


def parse_variant(name: str) -> Variant:
    """The :class:`Variant` of a :func:`variant_name` string."""
    flags = set(name[len("fast_scan["):-1].split(",")) if name != "fast_scan" else set()
    unknown = flags - set(Variant._fields)
    if not name.startswith("fast_scan") or unknown:
        raise ValueError(f"fast_scan: no kernel variant named {name!r}")
    return Variant(*(f in flags for f in Variant._fields))


def _bits(v: Variant) -> int:
    return sum(1 << i for i, flag in enumerate(v) if flag)


_I32 = {"zone_idx", "pin", "spr_active", "spr_key", "spr_sel", "spr_hard", "at_active", "at_key",
        "at_sel", "an_active", "an_key", "an_sel", "pt_active", "pt_key", "pt_sel", "anti_g_key",
        "prefg_key"}
#: Key and selector tables the kernel indexes with (checked against K and A).
_KEYS = ("spr_key", "at_key", "an_key", "pt_key", "anti_g_key", "prefg_key")
_SELS = ("spr_sel", "at_sel", "an_sel", "pt_sel")


class _Dims(NamedTuple):
    N: int
    R: int
    U: int
    A: int
    K: int
    Cs: int
    Gd: int
    Hp: int
    Ti: int
    Tn: int
    Tp: int
    G: int
    Gp: int
    Vg: int
    Dv: int
    Mv: int


def _dims(fi: FastInputs) -> _Dims:
    R, N = fi.alloc_T.shape
    return _Dims(
        N=N, R=R, U=fi.static_pass.shape[0], A=fi.matches_AU.shape[0], K=fi.zone_idx.shape[0],
        Cs=fi.spr_active.shape[1], Gd=fi.gpu0.shape[0], Hp=fi.port_HU.shape[0],
        Ti=fi.at_active.shape[1], Tn=fi.an_active.shape[1], Tp=fi.pt_active.shape[1],
        G=fi.anti_g_key.shape[0], Gp=fi.prefg_key.shape[0],
        Vg=fi.vg0.shape[0], Dv=fi.dev0.shape[0], Mv=fi.dev_sizes.shape[1] // 2,
    )


def state_layout(fi: FastInputs) -> Dict[str, tuple]:
    """The scan state's fields and shapes, in their order in one state row
    (``FastOutputs.state``, a launch's ``init``): usage, per-node and
    per-zone selector counts (zone key k's block of A rows at row k·A), GPU
    free memory, host-port use, the inter-pod term rows by node and by zone
    (each row under its own key), the per-selector totals (all bound pods,
    then those on nodes labelled with each zone key; inter-pod variants
    only), volume-group and device free bytes."""
    d = _dims(fi)
    Z = fi.n_zones
    return {"used": (d.R, d.N), "node_cnt": (d.A, d.N), "zone_cnt": (d.K * d.A, Z), "gpu_free": (d.Gd, d.N),
            "port_used": (d.Hp, d.N), "anti_node": (d.G, d.N), "anti_zone": (d.G, Z), "prefw_node": (d.Gp, d.N),
            "prefw_zone": (d.Gp, Z), "sel_total": ((d.K + 1) * d.A if variant(fi).interpod else 0,),
            "vg_free": (d.Vg, d.N), "dev_free": (d.Dv, d.N)}


def state_width(fi: FastInputs) -> int:
    """Floats of one state row (:func:`state_layout`)."""
    return sum(math.prod(shape) for shape in state_layout(fi).values())


def unpack_state(fi: FastInputs, state: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The fields of a state row ``[..., W]`` as views, by name."""
    out, o = {}, 0
    for name, shape in state_layout(fi).items():
        n = math.prod(shape)
        out[name] = state[..., o:o + n].unflatten(-1, shape)
        o += n
    return out


def pack_state(fi: FastInputs, fields: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The inverse of :func:`unpack_state`: one float32 state row ``[W]``
    from its fields by name, each of its :func:`state_layout` shape (a
    field left out is zeros), on the inputs' device: what a launch takes as
    ``init``."""
    unknown = set(fields) - set(state_layout(fi))
    if unknown:
        raise ValueError(f"pack_state: no state fields {sorted(unknown)}")
    dev = fi.alloc_T.device
    parts = []
    for name, shape in state_layout(fi).items():
        t = fields.get(name)
        if t is None:
            t = torch.zeros(shape, dtype=torch.float32, device=dev)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"pack_state: {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
        parts.append(t.to(device=dev, dtype=torch.float32).reshape(-1))
    return torch.cat(parts) if parts else torch.zeros((0,), dtype=torch.float32, device=dev)


def _check(fi: FastInputs, tmpl, valid, forced, node_valid=None, spr_weight=None, init=None) -> None:
    """Device, dtype, shape and contiguity of everything the kernel reads,
    and the range of every key and selector index it follows. ``valid``
    and ``forced`` are ``[P]`` for one scan or ``[S, P]`` for a scenario
    grid, whose ``node_valid [S, N]`` and ``spr_weight [S, U, Cs]`` are
    checked too, and ``init`` (a state row per scenario, or None) with
    them; a config's weights, filter bits and ignored rows too."""
    d = _dims(fi)
    N, R, U, A, K, Cs, Gd = d.N, d.R, d.U, d.A, d.K, d.Cs, d.Gd
    v = variant(fi)
    Ul = U if v.local else 0
    want = {
        "alloc_T": (R, N), "used0_T": (R, N), "static_pass": (U, N), "aff_mask": (U, N),
        "share_raw": (U, N), "zone_idx": (K, N), "matches_AU": (A, U), "node_valid": (N,),
        "req": (U, R), "cpu_nz": (U,), "mem_nz": (U,), "pin": (U,),
        "gpu_mem": (U if v.gpu else 0,), "gpu_cnt": (U if v.gpu else 0,), "gpu0": (Gd, N),
        "na_raw": (U if v.na else 0, N), "tt_raw": (U if v.tt else 0, N),
        "avoid_raw": (U if v.avoid else 0, N), "port_HU": (d.Hp, U), "port_conf_HU": (d.Hp, U),
        "anti_g_key": (d.G,), "antig_GU": (d.G, U), "gmatch_GU": (d.G, U),
        "prefg_key": (d.Gp,), "prefg_GU": (d.Gp, U), "pmatch_GU": (d.Gp, U),
        "lvm_req": (Ul,), "dev_req": (Ul, 2), "dev_need": (Ul, 2), "dev_sizes": (Ul, 2 * d.Mv),
        "vg_cap": (d.Vg, N), "vg0": (d.Vg, N), "dev_cap": (d.Dv, N), "dev0": (d.Dv, N),
        "dev_media": (2 * d.Dv, N),
    }
    for f in ("spr_active", "spr_key", "spr_sel", "spr_skew", "spr_hard", "spr_self", "spr_weight"):
        want[f] = (U, Cs)
    for prefix, T in (("at", d.Ti), ("an", d.Tn), ("pt", d.Tp)):
        for f in ("active", "key", "sel"):
            want[f"{prefix}_{f}"] = (U, T)
    want["at_self"], want["pt_w"] = (U, d.Ti), (U, d.Tp)
    dev = fi.alloc_T.device
    for name, shape in want.items():
        t = getattr(fi, name)
        dt = torch.int32 if name in _I32 else torch.float32
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fast_scan: {name} is {t.dtype}{tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()}); want contiguous {dt}{shape} on {dev}"
            )
    P = tmpl.shape[0]
    lead = tuple(valid.shape[:-1])  # () for one scan, (S,) for a scenario grid
    per_pod = [("tmpl", tmpl, (P,), torch.int32), ("valid", valid, lead + (P,), torch.int32),
               ("forced", forced, lead + (P,), torch.int32)]
    if node_valid is not None or spr_weight is not None:
        per_pod += [("node_valid", node_valid, lead + (N,), torch.float32),
                    ("spr_weight", spr_weight, lead + (U, Cs), torch.float32)]
    for name, t, shape, dt in per_pod:
        if (t is None or t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"fast_scan: {name} must be a contiguous {dt} {list(shape)} tensor on {dev}")
    if len(lead) > 1 or (lead and lead[0] < 1):
        raise ValueError(f"fast_scan: a scenario grid takes [S, P] masks with S >= 1, not {list(valid.shape)}")
    if init is not None:
        want_init = lead + (state_width(fi),)
        if init.device != dev or init.dtype != torch.float32 or tuple(init.shape) != want_init or not init.is_contiguous():
            raise ValueError(f"fast_scan: init must be a contiguous float32 {list(want_init)} state on {dev}")
    if fi.cfg is not None:
        c = fi.cfg
        if (len(c.weights) != len(_CFG_WEIGHTS) or not all(math.isfinite(w) for w in c.weights)
                or not 0 <= c.filters < 1 << (F_LOCAL - F_PORTS + 1) or not 0 <= c.fit_ignored < 1 << R):
            raise ValueError(f"fast_scan: config {c} is not {len(_CFG_WEIGHTS)} finite weights, "
                             f"{F_LOCAL - F_PORTS + 1} filter bits and {R} fit-ignored bits")
    if node_valid is not None and not bool(((node_valid == 0) | (node_valid == 1)).all()):
        raise ValueError("fast_scan: node_valid must hold 0 or 1 (the sweep keeps it as bits)")
    if R > MAX_R or Cs > MAX_CS or Gd > MAX_GD or d.Dv > MAX_DV:
        raise ValueError(
            f"fast_scan: R={R} (max {MAX_R}), Cs={Cs} (max {MAX_CS}), Gd={Gd} (max {MAX_GD}) "
            f"or Dv={d.Dv} (max {MAX_DV}) outside the kernel"
        )
    if K < 1 or K > MAX_K or fi.n_zones < 1 or R <= V.RES_MEMORY:
        raise ValueError(f"fast_scan: needs 1 <= K <= {MAX_K} zone-key rows, n_zones >= 1 and cpu/memory rows")
    if not v.gpu and (Gd > 0 or fi.gc_row >= 0) or fi.gc_row >= R:
        raise ValueError(
            f"fast_scan: gpu tables ({Gd} GPU rows, {fi.gpu_mem.numel()} templates) and gc_row={fi.gc_row} disagree"
        )
    for names, hi in ((_KEYS, K), (_SELS, A - 1)):
        for name in names:
            t = getattr(fi, name)
            if t.numel() and (int(t.min()) < 0 or int(t.max()) > hi):
                raise ValueError(f"fast_scan: {name} holds an index outside [0, {hi}]")


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

#: The kernel's weight fields, in kernels.SCORE_PARTS order (``share`` is
#: Simon plus Open-Gpu-Share).
_CFG_WEIGHTS = ("w_balanced", "w_least", "w_node_affinity", "w_taint_toleration", "w_interpod", "w_spread",
                "w_share", "w_local", "w_prefer_avoid")


class _Args(ctypes.Structure):
    """FastScanArgs in csrc/fast_scan.cu, field for field (a CPU test holds
    the two lists equal)."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "tmpl", "valid", "forced", "alloc", "used0", "node_valid", "zone_idx",
        "static_pass", "aff_mask", "share_raw", "matches", "req", "cpu_nz", "mem_nz",
        "pin", "spr_active", "spr_key", "spr_sel", "spr_skew", "spr_hard", "spr_self",
        "spr_weight", "gpu_mem", "gpu_cnt", "gpu0", "na_raw", "tt_raw", "avoid_raw",
        "port_hu", "port_conf", "at_active", "at_key", "at_sel", "at_self",
        "an_active", "an_key", "an_sel", "pt_active", "pt_key", "pt_sel", "pt_w",
        "anti_g_key", "antig", "gmatch", "prefg_key", "prefg", "pmatch",
        "lvm_req", "dev_req", "dev_need", "dev_sizes", "vg_cap", "vg0", "dev_cap", "dev0", "dev_media",
        "chosen", "used", "node_cnt", "zone_cnt", "gpu_take", "gpu_free",
        "port_used", "anti_node", "anti_zone", "prefw_node", "prefw_zone", "sel_total",
        "vg_free", "dev_free", "nv_bits", "feas_bits", "rep", "fail_counts", "insufficient", "count_clock",
        "init",
    )] + [("W", ctypes.c_int64)] + [(n, ctypes.c_int32) for n in (
        "S", "P", "N", "R", "U", "A", "K", "Z", "Cs", "Gd", "gc_row", "Hp", "Ti", "Tn", "Tp", "G", "Gp",
        "Vg", "Dv", "Mv",
        "has_gpu", "has_na", "has_tt", "has_avoid", "has_ports", "has_interpod", "has_local",
        "B", "Nw", "bits_in_smem",
        "Nc", "resident", "Wrep",
        "o_used", "o_node_cnt", "o_gpu_free", "o_port_used", "o_anti_node", "o_prefw_node", "o_vg_free", "o_dev_free",
        "o_alloc", "o_zone", "o_nv", "o_gpu0", "o_vg_cap", "o_dev_cap", "o_dev_media", "o_rep",
        "o_zone_cnt", "o_anti_zone", "o_prefw_zone", "o_sel_total",
        "has_cfg", "has_sample", "filters", "fit_ignored", "draw_base",
    )] + [("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32)] + [(n, ctypes.c_float) for n in _CFG_WEIGHTS] + [
        ("has_explain", ctypes.c_int32), ("has_count", ctypes.c_int32)]


#: Loaded shared objects by variant name; one per variant, each holding
#: only its own instantiation of the kernels, and ptxas's report of each.
_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.Lock()
_PTXAS: Dict[str, Dict[str, dict]] = {}
#: The last build() call: its wall-clock seconds, and per variant name the
#: library, the nvcc seconds (None when the library was already built) and
#: ptxas's log (kept beside the library, so a cached one has it too). The
#: process's builds and cache hits add up in ``obs.profile.COMPILES``.
BUILD_LOG: Dict[str, object] = {"seconds": None, "variants": {}}


def ptxas_report(log: str) -> Dict[str, dict]:
    """ptxas's -v report per kernel of one build: for ``fast_scan`` (the
    one scan with its slices in shared memory), ``fast_scan_global`` (in
    global memory) and ``fast_scan_sweep``, the registers, spill store and
    load bytes, stack frame and static shared-memory bytes."""
    out = {}
    for entry in log.split("Compiling entry function")[1:]:
        head = entry.split("\n", 1)[0]
        kernel = ("fast_scan_sweep" if "sweep_kernel" in head
                  else "fast_scan_global" if "Li0EE" in head else "fast_scan")
        num = lambda pat: sum(int(x) for x in re.findall(pat, entry))
        out[kernel] = {"registers": num(r"Used (\d+) registers"),
                       "spill_bytes": num(r"(\d+) bytes spill (?:stores|loads)"),
                       "stack_bytes": num(r"(\d+) bytes stack frame"), "smem_bytes": num(r"(\d+) bytes smem")}
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("fast_scan: nvcc not found (needs the CUDA toolkit)")


def _lib_path(v: Variant) -> Path:
    """The variant's library in the build directory (``utils/jitcache``)."""
    bits = _bits(v)
    tag = hashlib.sha1(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode() + str(bits).encode()).hexdigest()[:12]
    return jitcache.build_dir() / f"fast_scan-{tag}-v{bits}.so"


def build(names: Iterable[str]) -> None:
    """Compile and load the named kernel variants (:func:`variant_name`
    strings): one ``nvcc -DFS_VARIANT=<bits>`` per variant not yet built,
    all started together, into the build directory (``utils/jitcache``:
    ``_build/`` unless ``OPENSIM_JIT_CACHE`` names another; cached by
    source, flags and variant; ptxas's log beside each library). Raises
    when a build fails; there is no fallback. One build runs at a time
    (``_BUILD_LOCK``): two threads that launch the same variant at once
    (the server's two endpoints) compile it once, and a launch of a loaded
    variant does not wait for another's compile."""
    names = list(names)
    if all(n in _LIBS for n in names):
        return
    with _BUILD_LOCK:
        _build_locked(names)


def _build_locked(names: List[str]) -> None:
    t0 = time.perf_counter()
    todo = {n: parse_variant(n) for n in names if n not in _LIBS}
    if not todo:
        return
    jitcache.build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, v in todo.items():
        path = _lib_path(v)
        if path.exists():
            COMPILES.record_hit()
            continue
        tmp = path.with_suffix(f".{time.time_ns()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-DFS_VARIANT={_bits(v)}", "-o", str(tmp), str(_SRC)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                       tmp, path, time.perf_counter())
    log: Dict[str, dict] = {}
    failed = []
    for name, (proc, tmp, path, started) in procs.items():
        _out, err = proc.communicate()
        log[name] = {"library": str(path), "seconds": time.perf_counter() - started, "ptxas": err}
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{err}")
        else:
            path.with_suffix(".ptxas").write_text(err)  # before the library, which marks the build done
            tmp.replace(path)
            COMPILES.record_build(name, log[name]["seconds"])
    if failed:
        raise RuntimeError("fast_scan: nvcc failed for " + "\n".join(failed))
    for name, v in todo.items():
        path = _lib_path(v)
        lib = ctypes.CDLL(str(path))
        lib.fast_scan_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
        lib.fast_scan_launch.restype = ctypes.c_int
        lib.fast_scan_sweep_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        lib.fast_scan_sweep_launch.restype = ctypes.c_int
        _LIBS[name] = lib
        report = path.with_suffix(".ptxas")
        log.setdefault(name, {"library": str(path), "seconds": None,
                              "ptxas": report.read_text() if report.exists() else ""})
        _PTXAS[name] = ptxas_report(log[name]["ptxas"])
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    BUILD_LOG["variants"] = log


class ScanShape(NamedTuple):
    """Shape of one launch of the one-scan kernel: a cluster of `cluster`
    CTAs, CTA r owning nodes [r·nc, (r + 1)·nc)."""

    cluster: int  # CTAs of the thread-block cluster
    threads: int  # per CTA
    nc: int  # nodes per CTA, ceil(N / cluster)
    need: int  # bytes of a CTA's slice and its copy of the small state
    smem: int  # dynamic shared-memory bytes: `need` where it fits beside the static arrays, else 0
    resident: bool  # the slices lie in shared memory (else in global memory)
    small: int  # floats of the small state each CTA keeps a copy of
    offsets: Dict[str, int]  # the kernel's o_* fields: float offsets of each row block


#: The per-node rows of a CTA's slice, in their order in shared memory: the
#: state, then the constant node tables (``zone`` the zone columns, ``nv``
#: node validity, ``gpu0`` the GPUs' presence for the dynamic gpu-count).
def _slice_rows(d: "_Dims", v: "Variant") -> Dict[str, int]:
    return {"used": d.R, "node_cnt": d.A, "gpu_free": d.Gd, "port_used": d.Hp, "anti_node": d.G,
            "prefw_node": d.Gp, "vg_free": d.Vg, "dev_free": d.Dv, "alloc": d.R, "zone": d.K, "nv": 1,
            "gpu0": d.Gd if v.gc else 0, "vg_cap": d.Vg, "dev_cap": d.Dv, "dev_media": 2 * d.Dv}


def scan_shape(fi: FastInputs) -> ScanShape:
    """The one scan's launch on these inputs: SCAN_CLUSTER CTAs of
    SCAN_THREADS threads, each owning nc = ceil(N / SCAN_CLUSTER) nodes.
    A CTA keeps its slice's per-node rows (:func:`_slice_rows`, nc floats
    each) and a copy of the small state every bind touches (zone counts
    [K·A, Z], the inter-pod zone rows [G + Gp, Z] and per-selector totals
    [(K + 1)·A]) in shared memory when they fit beside the static arrays
    (SMEM_MAX - SCAN_STATIC_SMEM bytes); else all of it stays in global
    memory, so every N runs."""
    d, v = _dims(fi), variant(fi)
    nc = -(-d.N // SCAN_CLUSTER)
    offsets, o = {}, 0
    for name, rows in _slice_rows(d, v).items():
        offsets[name] = o
        o += rows * nc
    small = {"zone_cnt": d.K * d.A * fi.n_zones, "anti_zone": d.G * fi.n_zones, "prefw_zone": d.Gp * fi.n_zones,
             "sel_total": (d.K + 1) * d.A if v.interpod else 0}
    offsets["rep"], r = o, 0
    for name, n in small.items():
        offsets[name] = r
        r += n
    need = 4 * (o + r)
    resident = need <= SMEM_MAX - SCAN_STATIC_SMEM
    if not resident:  # offsets into shared memory mean nothing then
        offsets = {k: (x if k in small else 0) for k, x in offsets.items()}
    return ScanShape(SCAN_CLUSTER, SCAN_THREADS, nc, need, need if resident else 0, resident, r, offsets)


class SweepGrid(NamedTuple):
    """Shape of one launch of the scenario grid."""

    b: int  # scenarios per block; block k runs scenarios k·b ... k·b + b - 1
    blocks: int  # ceil(S / b); the last may hold fewer than b
    threads: int  # per block
    smem: int  # dynamic shared-memory bytes: b scenarios' bit masks, 0 when they lie in global memory
    words: int  # 32-bit words of one N-bit mask


def sweep_grid(S: int, N: int, sms: int = H100_SMS, counting: bool = False) -> SweepGrid:
    """The scenario grid for S scenarios over N nodes on a card of `sms`
    SMs: b = ceil(S / sms) scenarios per block, at most SWEEP_B_MAX, so the
    grid fills the card in as few waves as b allows (S <= sms keeps one
    scenario per block); a `counting` grid (the ``count`` and ``explain``
    variants) takes b = 1, its S blocks running in waves. Each scenario
    keeps its node validity and pass 2's feasibility as two N-bit masks in
    shared memory; where b scenarios' masks do not fit beside the static
    arrays, b shrinks to what fits, and where one scenario's do not, they
    lie in global memory, so every N runs."""
    words = -(-N // 32)
    per = 2 * 4 * words
    b = 1 if counting else min(SWEEP_B_MAX, -(-S // sms))
    fit = (SMEM_MAX - SWEEP_STATIC_SMEM) // per
    smem = 0
    if fit >= 1:
        b = min(b, fit)
        smem = b * per
    return SweepGrid(b, -(-S // b), SWEEP_THREADS, smem, words)


def pack_bits(rows: torch.Tensor) -> torch.Tensor:
    """[S, N] 0/1 float rows as [S, ceil(N / 32)] int32 words: node n is bit
    n & 31 of word n >> 5, padding bits 0."""
    S, N = rows.shape
    words = -(-N // 32)
    bits = torch.zeros((S, words * 32), dtype=torch.int64, device=rows.device)
    bits[:, :N] = (rows != 0).long()
    shift = torch.arange(32, dtype=torch.int64, device=rows.device)
    w = (bits.view(S, words, 32) << shift).sum(2)  # below 2^32
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _launch(fi: FastInputs, tmpl, valid, forced, node_valid, spr_weight, sweep: bool, init=None,
            tie_seed: Optional[int] = None, draw_base: int = 0, explain: bool = False,
            count: bool = False) -> FastOutputs:
    """One launch over S scenarios (``valid`` and ``forced`` [S, P],
    ``node_valid`` [S, N], ``spr_weight`` [S, U, Cs], ``init`` None or
    [S, W]): the one-scan kernel (S = 1), counted under
    :func:`variant_name`, or with `sweep` the sweep kernel on
    :func:`sweep_grid`'s grid, counted under :func:`sweep_name`. Every
    output and state buffer has a leading S axis; scenario s writes its own
    slice. `tie_seed` (one scan only) samples the ties, with the draws'
    pod counter starting at `draw_base`; `explain` counts every step;
    `count` (grid only) counts the steps that find no node."""
    global LAUNCHES
    _check(fi, tmpl, valid, forced, node_valid, spr_weight, init)
    sample = tie_seed is not None
    if sweep and sample:
        raise ValueError("fast_scan_sweep: the scenario grid does not sample ties")
    if count and (not sweep or explain):
        raise ValueError("fast_scan: `count` is a grid's (the one scan always counts the steps that find no node; "
                         "explain mode counts every step)")
    counting = not sweep or count or explain
    name = variant_name(fi, sample, explain, count)
    row = sweep_name(fi, count, explain) if sweep else name
    build([name])
    lib = _LIBS[name]
    d = _dims(fi)
    N, R, A, K, Gd = d.N, d.R, d.A, d.K, d.Gd
    S, P, Z = valid.shape[0], tmpl.shape[0], fi.n_zones
    v = variant(fi, sample, explain, count)
    dev = fi.alloc_T.device
    f32 = torch.float32
    if not sweep and S != 1:
        raise ValueError(f"fast_scan: one scan takes one scenario, not {S}")
    # The float state of scenario s lies in row s of one [S, W] arena
    # (state_layout), so the sweep kernel selects a scenario by one offset
    # s * W for all of it; the kernel fills it from `init` or from the
    # encoded start.
    arena = torch.empty((S, state_width(fi)), dtype=f32, device=dev)
    part = unpack_state(fi, arena)
    chosen = torch.empty((S, P), dtype=torch.int32, device=dev)
    gpu_take = torch.zeros((S, P, Gd), dtype=f32, device=dev)  # the kernel writes bound pods' rows only
    # the kernel writes the count rows of the pods that find no node (in
    # explain mode of every pod not forced); a grid that does not count
    # leaves its count fields empty
    fail_counts = torch.zeros((S, P, N_FAIL if counting else 0), dtype=torch.int32, device=dev)
    insufficient = torch.zeros((S, P, R if counting else 0), dtype=torch.int32, device=dev)
    count_clock = None if sweep else torch.zeros((2,), dtype=torch.int64, device=dev)
    grid = (sweep_grid(S, N, torch.cuda.get_device_properties(dev).multi_processor_count, counting=counting)
            if sweep else None)
    shape = None if sweep else scan_shape(fi)
    nv_bits = feas_bits = rep = None
    if grid is not None:
        nv_bits = pack_bits(node_valid)
        if not grid.smem:
            feas_bits = torch.empty_like(nv_bits)
    elif not shape.resident:
        rep = torch.empty((shape.cluster, max(shape.small, 1)), dtype=f32, device=dev)  # each CTA's small state
    ptr = lambda t: 0 if t is None else t.data_ptr()
    cfg = fi.cfg
    key = (tie_seed or 0) & (2 ** 64 - 1)
    args = _Args(
        ptr(tmpl), ptr(valid), ptr(forced), ptr(fi.alloc_T), ptr(fi.used0_T),
        ptr(None if sweep else node_valid[0]), ptr(fi.zone_idx), ptr(fi.static_pass), ptr(fi.aff_mask),
        ptr(fi.share_raw), ptr(fi.matches_AU), ptr(fi.req), ptr(fi.cpu_nz), ptr(fi.mem_nz),
        ptr(fi.pin), ptr(fi.spr_active), ptr(fi.spr_key), ptr(fi.spr_sel), ptr(fi.spr_skew),
        ptr(fi.spr_hard), ptr(fi.spr_self), ptr(spr_weight),
        ptr(fi.gpu_mem), ptr(fi.gpu_cnt), ptr(fi.gpu0), ptr(fi.na_raw), ptr(fi.tt_raw), ptr(fi.avoid_raw),
        ptr(fi.port_HU), ptr(fi.port_conf_HU), ptr(fi.at_active), ptr(fi.at_key), ptr(fi.at_sel),
        ptr(fi.at_self), ptr(fi.an_active), ptr(fi.an_key), ptr(fi.an_sel), ptr(fi.pt_active),
        ptr(fi.pt_key), ptr(fi.pt_sel), ptr(fi.pt_w), ptr(fi.anti_g_key), ptr(fi.antig_GU),
        ptr(fi.gmatch_GU), ptr(fi.prefg_key), ptr(fi.prefg_GU), ptr(fi.pmatch_GU),
        ptr(fi.lvm_req), ptr(fi.dev_req), ptr(fi.dev_need), ptr(fi.dev_sizes), ptr(fi.vg_cap),
        ptr(fi.vg0), ptr(fi.dev_cap), ptr(fi.dev0), ptr(fi.dev_media),
        ptr(chosen), *(ptr(part[n]) for n in ("used", "node_cnt", "zone_cnt")), ptr(gpu_take),
        *(ptr(part[n]) for n in ("gpu_free", "port_used", "anti_node", "anti_zone", "prefw_node", "prefw_zone",
                                 "sel_total", "vg_free", "dev_free")),
        ptr(nv_bits), ptr(feas_bits), ptr(rep),
        ptr(fail_counts if counting else None), ptr(insufficient if counting else None), ptr(count_clock),
        ptr(init),
        arena.shape[1],
        S, P, N, R, d.U, A, K, Z, d.Cs, Gd, fi.gc_row, d.Hp, d.Ti, d.Tn, d.Tp, d.G, d.Gp, d.Vg, d.Dv, d.Mv,
        int(v.gpu), int(v.na), int(v.tt), int(v.avoid), int(v.ports), int(v.interpod), int(v.local),
        *((1, 0, 0) if grid is None else (grid.b, grid.words, int(grid.smem > 0))),
    )
    if shape is not None:
        args.Nc, args.resident, args.Wrep = shape.nc, int(shape.resident), shape.small
        for field, o in shape.offsets.items():
            setattr(args, f"o_{field}", o)
    args.has_cfg, args.has_sample, args.has_explain, args.has_count = int(v.cfg), int(sample), int(explain), int(count)
    if cfg is not None:
        args.filters, args.fit_ignored = cfg.filters, cfg.fit_ignored
        for field, w in zip(_CFG_WEIGHTS, cfg.weights):
            setattr(args, field, w)
    args.draw_base, args.key0, args.key1 = draw_base, key & 0xFFFFFFFF, key >> 32
    # the variant's label on a profiler's timeline (free when none runs)
    with torch.cuda.device(dev), torch.profiler.record_function(row):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if grid is None:
            err = lib.fast_scan_launch(ctypes.byref(args), shape.cluster, shape.threads, shape.smem, stream)
        else:
            err = lib.fast_scan_sweep_launch(ctypes.byref(args), grid.blocks, grid.threads, grid.smem, stream)
    if err == SCAN_UNSCHEDULABLE:
        raise RuntimeError(f"fast_scan: a cluster of {shape.cluster} CTAs with {shape.smem} B of shared memory "
                           "each cannot be scheduled on this card")
    if err != 0:
        raise RuntimeError(f"fast_scan: kernel launch failed (cudaError {err})")
    with _LAUNCH_LOCK:
        LAUNCHES += 1
        VARIANT_LAUNCHES[row] = VARIANT_LAUNCHES.get(row, 0) + 1
        if grid is not None:
            SWEEP_LAUNCHED[row] = {"grid": grid, "ptxas": _PTXAS[name].get("fast_scan_sweep")}
        else:
            kernel = "fast_scan" if shape.resident else "fast_scan_global"
            SCAN_LAUNCHED[row] = {"shape": shape, "ptxas": _PTXAS[name].get(kernel), "count_clock": count_clock}
    return FastOutputs(chosen, part["used"], gpu_take, part["gpu_free"], part["port_used"], part["vg_free"],
                       part["dev_free"], fail_counts, insufficient, arena)


def fast_scan(fi: FastInputs, tmpl, valid, forced, init=None, tie_seed: Optional[int] = None,
              draw_base: int = 0, explain: bool = False) -> FastOutputs:
    """Run the bind scan over the pod stream. ``tmpl``/``valid``/``forced``
    are int32 ``[P]`` tensors on the inputs' device. Returns the chosen
    nodes (-1 for a pod that did not bind), the final usage, each pod's GPU
    slots per device, the final free memory per GPU, the final host-port
    use, the final free bytes per volume group and device, the failure
    attribution of each pod that found no node, and the whole final state
    (:class:`FastOutputs`).

    ``init`` (a ``[W]`` state row, :func:`state_layout`; None: the encoded
    start) is the state the scan starts from: another launch's
    ``FastOutputs.state``, so that consecutive launches go on from each
    other. ``tie_seed`` (None: the lowest index) takes each step's node
    among the best scores by the highest Philox draw keyed by the seed, the
    counter being (``draw_base`` + the pod's index in this launch, the node
    index). ``explain`` (explain mode) counts the failure attribution of
    every pod that is not forced, against the state before its step.

    The initial state is an argument of the cfg variants only (the other
    variants' code stays as it was; a segmented run takes the cfg variant
    in every segment, and a run of one segment starts from the encoded
    state).

    On a CUDA device this launches the one-scan kernel (one launch for the
    stream, a thread-block cluster shaped by :func:`scan_shape`) or raises;
    on the CPU it runs the plain version."""
    if init is not None and fi.cfg is None:
        raise ValueError("fast_scan: an initial state runs in the cfg variants")
    dev = fi.alloc_T.device
    if dev.type == "cuda":
        out = _launch(fi, tmpl, valid[None], forced[None], fi.node_valid[None], fi.spr_weight[None], sweep=False,
                      init=None if init is None else init[None], tie_seed=tie_seed, draw_base=draw_base,
                      explain=explain)
        return FastOutputs(*(t[0] for t in out))
    if dev.type == "cpu":
        return fast_scan_reference(fi, tmpl, valid, forced, init=init, tie_seed=tie_seed, draw_base=draw_base,
                                   count_all=explain)
    raise ValueError(f"fast_scan: no kernel for device {dev}")


def fast_scan_sweep(fi: FastInputs, tmpl, valid, forced, node_valid, spr_weight, init=None, count: bool = False,
                    explain: bool = False) -> FastOutputs:
    """S bind scans over one pod stream ``tmpl [P]`` that share every
    template table and differ per scenario in ``valid``/``forced`` (int32
    ``[S, P]``), ``node_valid`` (0/1 float32 ``[S, N]``),
    ``spr_weight`` (float32 ``[S, U, Cs]``, the spread weights of the
    scenario's valid nodes) and, where given, the state each starts from
    (``init``, ``[S, W]``). Returns :class:`FastOutputs` with a leading S
    axis; scenario s gives what :func:`fast_scan` gives on its rows in the
    :data:`STATE_FIELDS`. With `count` (the ``[count]`` variant) each
    scenario also counts the failures of its pods that find no node, with
    `explain` (``[explain]``) of every pod not forced, as :func:`fast_scan`
    does with the scenario's masks; otherwise ``fail_counts`` and
    ``insufficient`` are ``[S, P, 0]``.

    On a CUDA device this is one launch of the sweep kernel, B scenarios
    per block (:func:`sweep_grid`; one in the counting variants), or
    raises; on the CPU it runs the plain version scenario by scenario. As
    in :func:`fast_scan`, only the cfg variant takes an initial state."""
    if init is not None and fi.cfg is None:
        raise ValueError("fast_scan_sweep: an initial state runs in the cfg variant")
    dev = fi.alloc_T.device
    if dev.type == "cuda":
        return _launch(fi, tmpl, valid, forced, node_valid, spr_weight, sweep=True, init=init, count=count,
                       explain=explain)
    if dev.type == "cpu":
        return fast_scan_sweep_reference(fi, tmpl, valid, forced, node_valid, spr_weight, init=init, count=count,
                                         explain=explain)
    raise ValueError(f"fast_scan_sweep: no kernel for device {dev}")


def fast_scan_sweep_reference(fi: FastInputs, tmpl, valid, forced, node_valid, spr_weight, init=None,
                              count: bool = False, explain: bool = False) -> FastOutputs:
    """Plain version of :func:`fast_scan_sweep` on any device: the plain
    scan once per scenario, with the scenario's node validity, spread
    weights and initial state in place of the template's, in explain mode
    with `explain`; its count fields are empty unless `count` or `explain`
    asks for them, as the grid's."""
    if count and explain:
        raise ValueError("fast_scan_sweep: `count` and `explain` are two variants; explain mode counts every step")
    outs = [
        fast_scan_reference(fi._replace(node_valid=node_valid[s], spr_weight=spr_weight[s]), tmpl, valid[s], forced[s],
                            init=None if init is None else init[s], count_all=explain)
        for s in range(valid.shape[0])
    ]
    out = FastOutputs(*(torch.stack(field) for field in zip(*outs)))
    if count or explain:
        return out
    return out._replace(fail_counts=out.fail_counts[..., :0], insufficient=out.insufficient[..., :0])


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mulhilo(m: int, a: torch.Tensor):
    """(high, low) 32-bit words of m · a for uint32 values held in int64,
    from 16-bit halves of `a` so that no product leaves int64."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _M32


def philox_draws(seed: int, pods: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """The sampled tie-break's draws ``[len(pods), n_nodes]`` (uint32 values
    in int64): the first word of Philox-4x32-10 keyed by `seed` (its low
    and high 32 bits) at counter (pod, node, 0, 0), as the kernel's
    ``philox_draw`` computes them."""
    key = seed & (2 ** 64 - 1)
    k0, k1 = key & _M32, key >> 32
    c0 = pods.long()[:, None].expand(-1, n_nodes)
    c1 = torch.arange(n_nodes, dtype=torch.int64, device=pods.device)[None, :].expand(len(pods), -1)
    c2 = c3 = torch.zeros_like(c0)
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def fast_scan_reference(fi: FastInputs, tmpl, valid, forced, init=None, tie_seed: Optional[int] = None,
                        draw_base: int = 0, stats: Optional[dict] = None, count_all: bool = False) -> FastOutputs:
    """Plain PyTorch bind scan on any device: the Pallas body's formulas op
    for op (pallas_scan.py:395-854), one torch op at a time, so each float
    op rounds once as on the card. With a config (``fi.cfg``), the step of
    the JAX package's XLA scan instead (``kernels.pod_step``): each score
    part times its weight, summed from 0 in ``score_parts`` order, a part
    of weight 0 left out; a dynamic filter the config turns off passes
    every node; fit skips the ignored resource rows. ``init`` (a state row,
    :func:`state_layout`) is the state to start from; ``tie_seed`` takes
    each step's node among the best scores by the highest
    :func:`philox_draws` draw (pod counter ``draw_base`` + i), then the
    lowest index. Given a dict `stats`, it fills ``ties`` (int32 [P]: the
    nodes at the step's best score, 0 where the pod was not scheduled) and
    ``at_max`` (bool [P]: the chosen node is among them, or the pod was
    not scheduled). The template ids, the spread and
    inter-pod terms' integer fields and the rows each template's port and
    symmetric terms touch come to the host once, before the loop, so a
    template's rows are views and the term branches are Python branches;
    the bind indexes the chosen node with a one-element tensor. So nothing
    inside the loop waits for the device. Sums and prefix sums over GPUs
    run device by device, in the Pallas body's order; only exact ops (min,
    counts of 0/1 flags, integer counts and weights below 2^24) are
    vectorised over them or summed in another order. The Pallas body's
    inter-pod and port dots are such sums: no matmul here, which on the
    card could round through TF32. Storage terms that the Pallas body
    multiplies by ``where(size > 0, ..., 0)`` (a volume slot of size 0,
    the LVM part of a template with no LVM) are skipped, which leaves every
    value as it was.

    Each filter's verdict is also kept on its own (0/1 rows), and every
    step reckons its failure attribution from them (the nodes that reach
    each filter, in the reference's order, and fail it; the nodes that
    reach fit and lack each resource), kept only where the pod is valid,
    not forced and finds no node (with `count_all`, explain mode: where
    the pod is not forced): a select, so no step waits to learn whether it
    failed."""
    d = _dims(fi)
    N, R, U, A, K, Cs, Gd = d.N, d.R, d.U, d.A, d.K, d.Cs, d.Gd
    Vg, Dv, Mv = d.Vg, d.Dv, d.Mv
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
    cfg = fi.cfg
    on = lambda f: cfg is None or bool(cfg.filters >> (f - F_PORTS) & 1)  # dynamic filter f runs
    ignored_fit = set() if cfg is None else {r for r in range(R) if cfg.fit_ignored >> r & 1}
    given = None if init is None else unpack_state(fi, init.to(dev))
    pad_z = lambda t: torch.cat([t, torch.zeros((*t.shape[:-1], 1), dtype=f32, device=dev)], -1)

    used = (fi.used0_T if given is None else given["used"]).clone()
    node_cnt = torch.zeros((A, N), dtype=f32, device=dev) if given is None else given["node_cnt"].clone()
    # column Z is a "no label" column: nodes without the key gather from it,
    # and it stays 0 because binds add 0 there
    zone_cnt = (torch.zeros((K, A, Z + 1), dtype=f32, device=dev) if given is None
                else pad_z(given["zone_cnt"].reshape(K, A, Z)))
    zone_col = torch.where(fi.zone_idx >= 0, fi.zone_idx, Z).long()  # [K, N]
    has_zone = (fi.zone_idx >= 0).to(f32)  # [K, N]
    iota_n = torch.arange(N, dtype=torch.int32, device=dev)
    valid_row = fi.node_valid
    ones_n = torch.ones((N,), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    chosen = torch.empty((P,), dtype=torch.int32, device=dev)
    fail_counts = torch.zeros((P, N_FAIL), dtype=torch.int32, device=dev)
    insufficient = torch.zeros((P, R), dtype=torch.int32, device=dev)
    no_count = torch.zeros((N_FAIL + R,), dtype=torch.int32, device=dev)
    gpu_free = (fi.gpu0 if given is None else given["gpu_free"]).clone()
    gpu_take = torch.zeros((P, Gd), dtype=f32, device=dev)
    port_used = torch.zeros((d.Hp, N), dtype=f32, device=dev) if given is None else given["port_used"].clone()
    vg_free = (fi.vg0 if given is None else given["vg_free"]).clone()
    dev_free = (fi.dev0 if given is None else given["dev_free"]).clone()
    if cfg is not None:
        weights = [torch.tensor(w, dtype=f32, device=dev) for w in cfg.weights]
    if stats is not None:
        ties, at_max = [], []
    if v.local:
        # which storage terms each template has (host lists: control flow only)
        lvm_h, dreq_h, sizes_h = fi.lvm_req.tolist(), fi.dev_req.tolist(), fi.dev_sizes.tolist()
    if v.gc:
        # devices a node has (gpu0 > 0) never change: the count of its
        # not-fully-used devices is a sum of 0/1 flags, exact in any order
        gc_valid = (fi.gpu0 > 0).to(f32)  # [Gd, N]
        gc_has_dev = gc_valid.amax(0) if Gd else torch.zeros((N,), dtype=f32, device=dev)
    if v.ports:
        # per template: the port ids that conflict with its own
        conf = fi.port_conf_HU.t().tolist()  # [U][Hp]
        conf_rows = [[(h, w) for h, w in enumerate(row) if w != 0] for row in conf]
    if v.interpod:
        at = [t.tolist() for t in (fi.at_active, fi.at_key, fi.at_sel, fi.at_self)]
        an = [t.tolist() for t in (fi.an_active, fi.an_key, fi.an_sel)]
        pt = [t.tolist() for t in (fi.pt_active, fi.pt_key, fi.pt_sel)]
        g_key, p_key = fi.anti_g_key.tolist(), fi.prefg_key.tolist()
        # per template: the existing-pod term rows whose selector it matches
        # (0/1 matches; the other rows add exact zeros in the Pallas dots)
        g_rows = [[(g, m) for g, m in enumerate(row) if m != 0] for row in fi.gmatch_GU.t().tolist()]
        p_rows = [[(g, m) for g, m in enumerate(row) if m != 0] for row in fi.pmatch_GU.t().tolist()]
        anti_node = torch.zeros((d.G, N), dtype=f32, device=dev)
        prefw_node = torch.zeros((d.Gp, N), dtype=f32, device=dev)
        # zone rows in each row's own key space, with the "no label" column Z
        anti_zone = torch.zeros((d.G, Z + 1), dtype=f32, device=dev)
        prefw_zone = torch.zeros((d.Gp, Z + 1), dtype=f32, device=dev)
        if given is not None:
            anti_node, prefw_node = given["anti_node"].clone(), given["prefw_node"].clone()
            anti_zone, prefw_zone = pad_z(given["anti_zone"]), pad_z(given["prefw_zone"])

        def row_gather(keys):  # per row: the node's column under the row's key, and its label
            col = torch.full((len(keys), N), Z, dtype=torch.long, device=dev)
            has = torch.zeros((len(keys), N), dtype=f32, device=dev)
            for g, k in enumerate(keys):
                if k > 0:
                    col[g], has[g] = zone_col[k - 1], has_zone[k - 1]
            return col, has

        g_col, g_has = row_gather(g_key)
        p_col, p_has = row_gather(p_key)

    def sel_cnt(key, sel):
        """Count of bound pods matching selector `sel` in each node's domain
        under `key` (0 = hostname, 1..K = zone keys), and the label row."""
        if key == 0:
            return node_cnt[sel], ones_n
        return zone_cnt[key - 1, sel][zone_col[key - 1]], has_zone[key - 1]

    def term_cnt(node_rows, zone_rows, g, key):
        """Row g of a per-term count table at every node: the node row for
        a hostname term, else the row's zone column (0 without the label)."""
        if key == 0:
            return node_rows[g]
        return zone_rows[g][zone_col[key - 1]]

    for i in range(P):
        u = tmpl[i]
        # --- NodeResourcesFit, static row, validity
        req_u = fi.req[u]  # [R]
        if v.gc:
            # dynamic gpu-count allocatable (pallas_scan.py:401-419)
            gc_dyn_row = (gc_valid * (gpu_free > 0).to(f32)).sum(0)
        fit = ones_n
        short = []  # per resource row: the pod asks it and the node lacks it
        for r in range(R):
            if not on(F_FIT) or r in ignored_fit:
                short.append(torch.zeros((N,), dtype=torch.bool, device=dev))
                continue
            alloc_r = fi.alloc_T[r]
            if v.gc and r == fi.gc_row:
                alloc_r = torch.where(gc_has_dev > 0, gc_dyn_row, alloc_r)
            over = (used[r] + req_u[r] > alloc_r).to(f32)
            fit = fit * torch.where(req_u[r] > 0, 1.0 - over, 1.0)
            short.append((req_u[r] > 0) & (over > 0))
        feasible = fi.static_pass[u] * fit * valid_row
        # each dynamic filter's own verdict, for the failure attribution
        ports_ok = gpu_ok_row = local_ok = spread_ok = ip_ok = ones_n

        if v.ports and on(F_PORTS):
            # NodePorts (:425-441): a conflicting port already used there
            conflicts = zero
            for h, w in conf_rows[u]:
                conflicts = conflicts + w * (port_used[h] > 0).to(f32)
            ports_ok = (conflicts == 0).to(f32)
            feasible = feasible * ports_ok

        if v.gpu and on(F_GPU):
            # Open-Gpu-Share filter: sum_d floor(free_d / mem) >= count
            gmem, gcnt = fi.gpu_mem[u], fi.gpu_cnt[u]
            gmem1 = torch.clamp(gmem, min=1.0)
            chunks_sum = torch.zeros((N,), dtype=f32, device=dev)
            for d_ in range(Gd):
                chunks_sum = chunks_sum + torch.floor(gpu_free[d_] / gmem1)
            gpu_ok = ((chunks_sum >= gcnt) & (gcnt > 0)).to(f32)
            gpu_ok_row = torch.where(gmem > 0, gpu_ok, 1.0)
            feasible = feasible * gpu_ok_row

        if v.local and on(F_LOCAL):
            # Open-Local filter (:455-477): the LVM request fits the VG with
            # the most free bytes; the i-th largest volume of a media finds
            # at least i + 1 free devices that fit it
            if lvm_h[u] > 0:
                best_vg = torch.full((N,), NEG, dtype=f32, device=dev)
                for g_ in range(Vg):
                    best_vg = torch.maximum(best_vg, vg_free[g_])
                local_ok = local_ok * (best_vg >= fi.lvm_req[u]).to(f32)
            for m in range(2):
                for vi in range(Mv):
                    if sizes_h[u][m * Mv + vi] > 0:
                        size = fi.dev_sizes[u, m * Mv + vi]
                        cnt_fit = torch.zeros((N,), dtype=f32, device=dev)
                        for d_ in range(Dv):
                            free_d = dev_free[d_]
                            cnt_fit = cnt_fit + fi.dev_media[m * Dv + d_] * ((free_d >= size) & (free_d > 0)).to(f32)
                        local_ok = local_ok * (cnt_fit >= vi + 1).to(f32)
            feasible = feasible * local_ok

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
            cnt, has_label = sel_cnt(key, sel)
            if spr_hard[u][c] == 1:
                if not on(F_SPREAD):
                    continue
                elig = aff_row * has_label
                masked = torch.where(elig > 0, cnt, BIG)
                min_cnt = torch.min(masked)
                ok = (cnt + fi.spr_self[u, c] - min_cnt <= skew) & (has_label > 0)
                spread_ok = spread_ok * ok.to(f32)
                feasible = feasible * ok.to(f32)
            else:
                contrib = torch.where(has_label > 0, cnt * fi.spr_weight[u, c] + (skew - 1.0), 0.0)
                soft_raw = soft_raw + contrib
                ignored = torch.maximum(ignored, 1.0 - has_label)
                any_soft = True

        if v.interpod and on(F_INTERPOD):
            # --- InterPodAffinity (:503-586); every count and weight below
            # is an integer under 2^24 (fastpath.why_not), so these sums are
            # exact in any order
            for t in range(d.Tn):  # incoming required anti-affinity
                if an[0][u][t] == 1:
                    cnt, has_label = sel_cnt(an[1][u][t], an[2][u][t])
                    ip_ok = ip_ok * (1.0 - ((cnt > 0) & (has_label > 0)).to(f32))
            at_terms = [t for t in range(d.Ti) if at[0][u][t] == 1]
            if at_terms:  # incoming required affinity, with the bootstrap
                at_all_ok, at_labels_ok, at_map_total, at_self_all = ones_n, ones_n, zero, 1.0
                for t in at_terms:
                    key, sel = at[1][u][t], at[2][u][t]
                    cnt, has_label = sel_cnt(key, sel)
                    total = node_cnt[sel].sum() if key == 0 else zone_cnt[key - 1, sel, :Z].sum()
                    at_all_ok = at_all_ok * ((cnt > 0) & (has_label > 0)).to(f32)
                    at_labels_ok = at_labels_ok * (has_label > 0).to(f32)
                    at_map_total = at_map_total + total
                    at_self_all = at_self_all * (1.0 if at[3][u][t] > 0 else 0.0)
                at_bootstrap = ((at_map_total == 0) & (at_self_all > 0)).to(f32)
                ip_ok = ip_ok * torch.maximum(at_all_ok, at_labels_ok * at_bootstrap)
            # existing pods' anti terms against this pod
            sym_cnt = zero
            for g, m in g_rows[u]:
                sym_cnt = sym_cnt + m * term_cnt(anti_node, anti_zone, g, g_key[g])
            ip_ok = ip_ok * (1.0 - (sym_cnt > 0).to(f32))
            feasible = feasible * ip_ok
        if v.interpod:
            # raw score: incoming preferred terms, then the existing pods'
            # preferred and hard-affinity weights
            ip_raw = torch.zeros((N,), dtype=f32, device=dev)
            for t in range(d.Tp):
                if pt[0][u][t] == 1:
                    cnt, has_label = sel_cnt(pt[1][u][t], pt[2][u][t])
                    ip_raw = ip_raw + cnt * fi.pt_w[u, t] * has_label
            for g, m in p_rows[u]:
                ip_raw = ip_raw + m * term_cnt(prefw_node, prefw_zone, g, p_key[g])

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

        parts = {"balanced": balanced, "least": least, "spread": spread_norm, "share": share_norm}
        if v.na:
            # NodeAffinity preferred weights, max-normalised over the feasible set
            na_row = fi.na_raw[u]
            na_max = torch.max(torch.where(feas_b, na_row, 0.0))
            parts["node_affinity"] = torch.where(na_max > 0, na_row * MAX_SCORE / torch.clamp(na_max, min=1.0), na_row)
        if v.tt:
            # TaintToleration: intolerable PreferNoSchedule counts, reversed
            tt_row = fi.tt_raw[u]
            tt_max = torch.max(torch.where(feas_b, tt_row, 0.0))
            parts["taint_toleration"] = torch.where(
                tt_max > 0, MAX_SCORE - tt_row * MAX_SCORE / torch.clamp(tt_max, min=1.0), MAX_SCORE
            )
        if v.avoid:
            parts["prefer_avoid"] = fi.avoid_raw[u]
        if v.local:
            # Open-Local binpack score (:668-702): the mean over the pod's
            # storage units of request / capacity of the unit it would take,
            # × 10, min-max normalised over the feasible nodes
            local_raw = torch.zeros((N,), dtype=f32, device=dev)
            if lvm_h[u] > 0 or dreq_h[u][0] > 0 or dreq_h[u][1] > 0:  # else count = 0
                lvm = fi.lvm_req[u]
                best_free = torch.full((N,), BIG, dtype=f32, device=dev)
                best_cap = torch.zeros((N,), dtype=f32, device=dev)
                for g_ in range(Vg):
                    free_v = vg_free[g_]
                    better = (free_v >= lvm) & (free_v < best_free)
                    best_free = torch.where(better, free_v, best_free)
                    best_cap = torch.where(better, fi.vg_cap[g_], best_cap)
                lparts = torch.where((lvm > 0) & (best_free < BIG), lvm / torch.clamp(best_cap, min=1.0), 0.0)
                count = torch.where(lvm > 0, 1.0, 0.0)
                for m in range(2):
                    size, need = fi.dev_req[u, m], fi.dev_need[u, m]
                    first_cap = torch.full((N,), BIG, dtype=f32, device=dev)
                    for d_ in range(Dv):
                        free_d = dev_free[d_]
                        fitting = (fi.dev_media[m * Dv + d_] > 0) & (free_d >= size) & (free_d > 0)
                        first_cap = torch.where(fitting, torch.minimum(first_cap, fi.dev_cap[d_]), first_cap)
                    lparts = lparts + torch.where(size > 0, need * size / torch.clamp(first_cap, min=1.0), 0.0)
                    count = count + torch.where(size > 0, need, 0.0)
                local_raw = torch.where(count > 0, lparts / torch.clamp(count, min=1.0) * 10.0, 0.0)
            l_lo = torch.min(torch.where(feas_b, local_raw, BIG))
            l_hi = torch.max(torch.where(feas_b, local_raw, NEG))
            l_rng = l_hi - l_lo
            parts["local"] = torch.where(l_rng > 0, (local_raw - l_lo) * MAX_SCORE / l_rng, 0.0)
        if v.interpod:
            # inter-pod score, min-max normalised with both ends seeded at 0 (:703-711)
            ip_masked = torch.where(feas_b, ip_raw, 0.0)
            ip_hi = torch.clamp(torch.max(ip_masked), min=0.0)
            ip_lo = torch.clamp(torch.min(ip_masked), max=0.0)
            ip_rng = ip_hi - ip_lo
            parts["interpod"] = torch.where(ip_rng > 0, MAX_SCORE * (ip_raw - ip_lo) / torch.clamp(ip_rng, min=1.0), 0.0)
        if cfg is None:
            # the Pallas body's sum: ((least + balanced) + 2 share) + 2 spread,
            # then the score tables, binpack and inter-pod scores
            score = least + balanced + 2.0 * share_norm + 2.0 * spread_norm
            for name, weight in (("node_affinity", None), ("taint_toleration", None), ("prefer_avoid", AVOID_WEIGHT),
                                 ("local", None), ("interpod", None)):
                if name in parts:
                    score = score + (parts[name] if weight is None else weight * parts[name])
        else:
            # kernels.pod_step's sum of the weighted score_parts, from 0
            score = torch.zeros((N,), dtype=f32, device=dev)
            for name, w, w_t in zip(SCORE_PARTS, cfg.weights, weights):
                if w != 0.0 and name in parts:
                    score = score + w_t * parts[name]

        # --- selectHost: lowest index among the maxima (with a tie seed, the
        # highest draw among them, then the lowest index); pins for forced pods
        masked_score = torch.where(feas_b, score, NEG)
        mx_score = torch.max(masked_score)
        top = feas_b & (masked_score == mx_score)
        if tie_seed is not None:
            if i % DRAW_CHUNK == 0:
                draws = philox_draws(tie_seed, torch.arange(draw_base + i, draw_base + min(i + DRAW_CHUNK, P),
                                                            device=dev), N)
            d_i = draws[i % DRAW_CHUNK]
            top = top & (d_i == torch.max(torch.where(top, d_i, -1)))
        best = torch.min(torch.where(top, iota_n, N))
        any_feasible = torch.max(feasible) > 0
        sel_choice = torch.where(any_feasible, best, -1)
        pin_u = fi.pin[u]
        choice = torch.where(forced[i], torch.where(pin_u >= 0, pin_u, -1), sel_choice)
        do_bind = valid[i] & (choice >= 0)
        chosen[i] = torch.where(do_bind, choice, -1)
        if stats is not None:
            scheduled = valid[i] & ~forced[i] & any_feasible
            at_top = feas_b & (masked_score == mx_score)
            ties.append(torch.where(scheduled, at_top.sum(dtype=torch.int32), 0))
            at_max.append(~scheduled | at_top[torch.clamp(sel_choice, min=0)])

        # --- failure attribution (kernels.pod_step's count_fails): the
        # nodes that reach each dynamic filter, in the reference's order
        # (static row with validity, ports, fit, spread, inter-pod, gpu,
        # local; extra none), and fail it; the nodes that reach fit and lack
        # each resource. Kept where the pod is valid, not forced and finds
        # no node, or with count_all where it is not forced.
        passes = torch.stack(torch.broadcast_tensors(ports_ok, fit, spread_ok, ip_ok, gpu_ok_row, local_ok)) > 0
        base = (fi.static_pass[u] * valid_row > 0)[None]
        reach = torch.cat([base, passes[:-1]]).to(torch.int32).cumprod(0) > 0  # [6, N]
        counts = torch.cat([(reach & ~passes).sum(1, dtype=torch.int32), no_count[:N_FAIL - 6],
                            (torch.stack(short) & reach[1]).sum(1, dtype=torch.int32)])
        keep = ~forced[i] if count_all else valid[i] & ~forced[i] & ~any_feasible
        counts = torch.where(keep, counts, no_count)
        fail_counts[i], insufficient[i] = counts[:N_FAIL], counts[N_FAIL:]

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
        if v.ports:
            # the template's own ports, not the conflict rows (:754-758)
            port_used[:, c] = port_used[:, c] + (fi.port_HU[:, u] * bind_f)[:, None]
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
            for d_ in range(Gd):
                cum[d_] = acc
                acc = acc + chunks[d_]
            take_greedy = torch.minimum(torch.clamp(gcnt - cum, min=0.0), chunks)
            take = torch.where(gcnt == 1, take_tight, take_greedy)
            take = torch.where(gmem > 0, take, 0.0)
            gpu_free[:, c] = (free - take * gmem * bind_f)[:, None]
            gpu_take[i] = take * bind_f
        if v.local and lvm_h[u] > 0:
            # LVM (:784-798): the tightest VG that fits, first among equals
            lvm = fi.lvm_req[u]
            free = vg_free[:, c][:, 0]  # [Vg]
            fits = free >= lvm
            best_free = torch.min(torch.where(fits, free, BIG))
            tight = fits & (free == best_free)
            take = (tight & (torch.cumsum(tight.to(torch.int32), 0) == 1)).to(f32)
            vg_free[:, c] = (free - torch.clamp(lvm, min=0.0) * take * bind_f)[:, None]
        if v.local:
            # exclusive devices (:799-835): volumes in ascending size, each on
            # the smallest-capacity candidate this pod has not taken yet, ties
            # to the lowest index; a taken device's free bytes become 0
            cap = fi.dev_cap[:, c][:, 0]  # [Dv]
            media = fi.dev_media[:, c][:, 0]  # [2·Dv]
            free = dev_free[:, c][:, 0]
            taken = torch.zeros((Dv,), dtype=torch.bool, device=dev)
            for m in range(2):
                for vi in reversed(range(Mv)):
                    if sizes_h[u][m * Mv + vi] <= 0:
                        continue
                    size = fi.dev_sizes[u, m * Mv + vi]
                    cand = (media[m * Dv:(m + 1) * Dv] > 0) & (free >= size) & (free > 0) & ~taken
                    best_cap = torch.min(torch.where(cand, cap, BIG))
                    pick = cand & (cap == best_cap)
                    pick = pick & (torch.cumsum(pick.to(torch.int32), 0) == 1)
                    taken = taken | pick
                    free = free * (1.0 - pick.to(f32) * bind_f)
            dev_free[:, c] = free[:, None]
        if v.interpod:
            # term counts (:836-854): the node row, and the zone row under
            # the row's own key where the chosen node carries that label
            for rows, node_rows, zone_rows, col, has in (
                (fi.antig_GU, anti_node, anti_zone, g_col, g_has),
                (fi.prefg_GU, prefw_node, prefw_zone, p_col, p_has),
            ):
                add = rows[:, u] * bind_f  # [G]
                node_rows[:, c] = node_rows[:, c] + add[:, None]
                zone_rows.scatter_add_(1, col[:, c], (add * has[:, c][:, 0])[:, None])

    if stats is not None:
        stats["ties"] = torch.stack(ties) if P else torch.zeros((0,), dtype=torch.int32, device=dev)
        stats["at_max"] = torch.stack(at_max) if P else torch.zeros((0,), dtype=torch.bool, device=dev)
    # the final state as one row (state_layout): the zone columns without
    # the "no label" column; the per-selector totals from the counts
    rows = {"used": used, "node_cnt": node_cnt, "zone_cnt": zone_cnt[..., :Z], "gpu_free": gpu_free,
            "port_used": port_used, "vg_free": vg_free, "dev_free": dev_free}
    if v.interpod:
        rows.update(anti_node=anti_node, anti_zone=anti_zone[:, :Z], prefw_node=prefw_node,
                    prefw_zone=prefw_zone[:, :Z],
                    sel_total=torch.cat([node_cnt.sum(1)] + [zone_cnt[k, :, :Z].sum(1) for k in range(K)]))
    state = torch.cat([rows[name].reshape(-1) if name in rows else torch.zeros((math.prod(shape),), dtype=f32,
                                                                                device=dev)
                       for name, shape in state_layout(fi).items()])
    return FastOutputs(chosen, used, gpu_take, gpu_free, port_used, vg_free, dev_free, fail_counts, insufficient,
                       state)


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
#: NodePorts: 3 per conflicting port id of the template (compare, multiply,
#: add) plus 2 (the test and the product). InterPodAffinity: 4 per active
#: incoming anti or affinity term, 3 per active preferred term, 2 per
#: existing-pod row whose selector the template matches, 4 for the filter
#: products and bootstrap, 10 for the score's reductions and normalisation.
_PORT_PER_ROW, _PORT = 3, 2
_IP_REQ_TERM, _IP_PREF_TERM, _IP_ROW, _IP = 4, 3, 2, 14
#: Per bound pod: the device packing, 14 per GPU.
_GPU_BIND_PER_GD = 14
#: Open-Local, per (scheduled pod, node): its range reduction and
#: normalisation 4 for every pod; for a template with LVM, the filter's
#: best VG 1 per VG plus 1 and the score's VG choice 4 per VG plus 4; per
#: exclusive volume of the template, the filter's device count 4 per device
#: plus 1; per media the template asks, the score's device choice 4 per
#: device plus 6. Per bound pod: 4 per VG (with LVM) and 8 per device for
#: each of its volumes.
_LOC = 4
_LOC_VG, _LOC_DEV = 5, 4
_LOC_LVM, _LOC_VOL, _LOC_MEDIA = 5, 1, 6
_LOC_BIND_VG, _LOC_BIND_DEV = 4, 8
#: The counting pass, per (pod that finds no node, valid node): the static
#: row and validity test 2, the first failing filter's slot 7 (a compare and
#: an add each), 2 per resource row (the shortage test and its add), and
#: each filter's own verdict again: fit 3 per resource row, 8 per active
#: hard spread constraint, and the flag branches' filter terms as above
#: (GPU 3 per GPU plus 4, the dynamic gpu-count 4 per GPU plus 1, ports 3
#: per conflicting port id plus 2, inter-pod 4 per required term, 2 per
#: matched anti row, 4 for the products; Open-Local 1 per VG plus 1 with LVM,
#: 4 per device plus 1 per exclusive volume).
_COUNT, _COUNT_PER_R = 9, 2
#: A config's weighted sum (the cfg variant), per (scheduled pod, node): a
#: multiply and an add for each of the four base parts (balanced, least,
#: spread, share) of non-zero weight, in place of the default sum's 5
#: operations; a multiply for each flag part (node affinity, taint
#: toleration, inter-pod, local, avoid) of the variant with a non-zero
#: weight, whose add the flag's own count holds.
_CFG_BASE_PARTS = ("balanced", "least", "spread", "share")
_DEFAULT_SUM = 5
#: The sampled tie-break, in 32-bit integer operations (``int_ops``): only
#: a step with more than one node at its best score needs draws, one for
#: each such node (the draw orders the maxima alone), each 10 rounds of
#: Philox-4x32-10 (two multiplies, two high multiplies and four xors) and
#: the comparator's 2; the key schedule (9 bumps of two adds) is the same
#: for every node of a step, so once a step.
_DRAW, _DRAW_KEY = 82, 18

#: FastInputs tables with a node axis (their last one).
_NODE_AXIS = {"alloc_T", "used0_T", "static_pass", "aff_mask", "share_raw", "zone_idx", "node_valid",
              "gpu0", "na_raw", "tt_raw", "avoid_raw", "vg_cap", "vg0", "dev_cap", "dev0", "dev_media"}
#: FastInputs tables a scenario grid replaces with its own [S, ...] rows.
_PER_SCENARIO = {"node_valid", "spr_weight"}


def fast_scan_work(fi: FastInputs, tmpl, valid, forced, chosen, node_valid=None, ties=None,
                   explain: bool = False, count: bool = False) -> dict:
    """Bytes the scan must move (each input read once, each output written
    once) and float ops that this stream's pods need, over the valid node
    lanes only (padding lanes need no work): a scheduled pod does the
    per-node work of its own template's active constraints, terms, port
    conflicts, matched term rows and storage volumes and of the variant's
    flag branches, a pod that bound (``chosen`` >= 0, the scan's result)
    its bind, and one scan's pod that found no node the counting pass over
    the valid nodes and its count row (``N_FAIL + R`` int32 written; its
    inputs are the step's state, already on chip); with `explain` (explain
    mode) every pod that is not forced runs the counting pass and writes
    its row. A grid counts only with `count` (its ``[count]`` variant: each
    scenario's pods that found no node) or `explain`, each scenario over its
    own valid nodes. The result's ``count`` gives the counting passes' own
    share: their bytes, ops and steps (0 for a grid that does not count).

    For a scenario grid, ``valid``/``forced``/``chosen`` are ``[S, P]`` and
    ``node_valid`` ``[S, N]``: each scenario is counted over its own valid
    nodes, the template tables the scenarios share are read once, and each
    scenario's node validity and spread weights once per scenario. A
    config's weighted sum is counted per scheduled pod and valid node too
    (``_CFG_BASE_PARTS``). For a sampled one scan, `ties` (int [P], the
    plain version's ``stats["ties"]``: the nodes at each step's best score)
    gives the draws' 32-bit integer operations, apart from the float ones
    as ``int_ops`` (``_DRAW``, ``_DRAW_KEY``; 0 without `ties`)."""
    d = _dims(fi)
    R, A, K, Gd = d.R, d.A, d.K, d.Gd
    v = variant(fi)
    if valid.dim() == 1:
        valid, forced, chosen = valid[None], forced[None], chosen[None]
    if node_valid is None:
        node_valid = fi.node_valid[None]
    S = valid.shape[0]
    n_valid = int((fi.node_valid != 0).sum())
    n_valid_s = (node_valid.cpu() != 0).sum(1).tolist()  # [S]
    in_bytes = sum(t.numel() * t.element_size() for t in (tmpl, valid, forced))
    for name, t in fi._asdict().items():
        if isinstance(t, torch.Tensor):
            if name in _PER_SCENARIO:
                lanes = [n / d.N if name in _NODE_AXIS else 1 for n in n_valid_s]
                in_bytes += sum(int(t.numel() * x) * t.element_size() for x in lanes)
                continue
            lanes = n_valid / d.N if name in _NODE_AXIS else 1
            in_bytes += int(t.numel() * lanes) * t.element_size()
    P = int(tmpl.shape[0])
    out_bytes = sum(P * 4 + (R + Gd + d.Hp + d.Vg + d.Dv) * n * 4 + P * Gd * 4 for n in n_valid_s)
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
    if fi.cfg is not None:
        w = dict(zip(_CFG_WEIGHTS, fi.cfg.weights))
        flags = {"w_node_affinity": v.na, "w_taint_toleration": v.tt, "w_interpod": v.interpod, "w_local": v.local,
                 "w_prefer_avoid": v.avoid}
        per_node = (per_node + 2 * sum(w[f"w_{name}"] != 0.0 for name in _CFG_BASE_PARTS) - _DEFAULT_SUM
                    + sum(on and w[name] != 0.0 for name, on in flags.items()))
    if v.ports:
        per_node = per_node + _PORT + _PORT_PER_ROW * (fi.port_conf_HU.cpu() != 0).sum(0)[tm]
        per_bind = per_bind + d.Hp
    if v.interpod:
        count = lambda t: (t.cpu() == 1).sum(1)[tm] if t.shape[1] else torch.zeros(P, dtype=torch.int64)
        rows = (fi.gmatch_GU.cpu() != 0).sum(0)[tm] + (fi.pmatch_GU.cpu() != 0).sum(0)[tm]
        per_node = (per_node + _IP + _IP_REQ_TERM * (count(fi.at_active) + count(fi.an_active))
                    + _IP_PREF_TERM * count(fi.pt_active) + _IP_ROW * rows)
        per_bind = per_bind + 2 * (d.G + d.Gp) + A * (1 + K)
    if v.local:
        has_lvm = (fi.lvm_req.cpu() > 0)[tm]
        vols = (fi.dev_sizes.cpu() > 0).sum(1)[tm]
        medias = (fi.dev_req.cpu() > 0).sum(1)[tm]
        per_node = (per_node + _LOC + has_lvm * (_LOC_VG * d.Vg + _LOC_LVM)
                    + vols * (_LOC_DEV * d.Dv + _LOC_VOL) + medias * (_LOC_DEV * d.Dv + _LOC_MEDIA))
        per_bind = per_bind + has_lvm * (_LOC_BIND_VG * d.Vg) + vols * (_LOC_BIND_DEV * d.Dv)
    sched = vd & ~fd
    ops = sum(int(per_node[sched[s]].sum()) * n_valid_s[s] + int(per_bind[bound[s]].sum()) for s in range(S))
    counting = {"bytes": 0, "ops": 0, "steps": 0}
    if S == 1 or count or explain:
        failed = ~fd if explain else sched & (chosen.cpu() < 0)  # [S, P]
        hard = ((fi.spr_active.cpu() == 1) & (fi.spr_hard.cpu() == 1)).sum(1)[tm]
        per_count = _COUNT + (_COUNT_PER_R + 3) * R + 8 * hard
        if v.gpu:
            per_count = per_count + asks * (_GPU_FILTER_PER_GD * Gd + _GPU_FILTER)
        per_count = per_count + v.gc * (_GC_PER_GD * Gd + 1)
        if v.ports:
            per_count = per_count + _PORT + _PORT_PER_ROW * (fi.port_conf_HU.cpu() != 0).sum(0)[tm]
        if v.interpod:
            per_count = (per_count + 4 + _IP_REQ_TERM * (count(fi.at_active) + count(fi.an_active))
                         + _IP_ROW * (fi.gmatch_GU.cpu() != 0).sum(0)[tm])
        if v.local:
            per_count = per_count + has_lvm * (d.Vg + 1) + vols * (_LOC_DEV * d.Dv + _LOC_VOL)
        steps = int(failed.sum())
        counting = {"bytes": steps * (N_FAIL + R) * 4,
                    "ops": sum(int(per_count[failed[s]].sum()) * n_valid_s[s] for s in range(S)), "steps": steps}
    int_ops = 0
    if ties is not None:
        drawn = ties.cpu()[ties.cpu() > 1].long()
        int_ops = _DRAW * int(drawn.sum()) + _DRAW_KEY * drawn.numel()
    return {"bytes": in_bytes + out_bytes + counting["bytes"], "ops": ops + counting["ops"], "int_ops": int_ops,
            "count": counting}
