"""Static tables, feature flags, scheduler-config launch arguments and the
plugin pipeline of one scheduling step, in torch.

The per-(template, node) quantities that never change during a scan —
static filter masks, spread eligibility, raw share scores, spread weights —
computed once on the host in numpy, exactly as the JAX package's
``precompute_static_np`` computes them (bitwise equal; the tests assert
it), the static filters switched by the scheduler config as there. The
config's score weights, dynamic-filter switches and fit-ignored resource
columns go to the kernel as launch arguments (:func:`kernel_config`). The
usage-dependent part of a scheduling step is the bind-scan kernel in
``ops/fast_scan.py``.

The second half is the port of the JAX package's traced kernels
(``opensim_tpu/ops/kernels.py:62-1215``): every filter and score over the
whole node axis as torch ops on the tensors of an ``EncodedCluster`` and a
``ScanState`` on any device, :func:`score_parts`, :func:`pod_step` (one
pod through filter, score and selectHost, with out-of-tree plugins and the
explain mode's counts on every step) and :func:`bind_update`. Each formula
keeps the reference's op order, so one float op rounds as there (one ulp
flips a score tie). ``engine/scheduler.py`` scans them over a pod stream
(the torch reference scan), and ``engine/explain.py`` re-scores one pod
with them. A template index ``u`` is a Python int.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..encoding import vocab as V
from ..encoding.state import EncodedCluster, ScanState
from ..engine.schedconfig import DEFAULT_CONFIG, SchedulerConfig

MAX_NODE_SCORE = 100.0

# Filter ids, in the order a node's rejection is attributed (the first
# filter it fails; engine/reasons.Reason carries the same values). The four
# static ones are counted per template (StaticTables.static_fail); the bind
# scan counts the dynamic ones, F_PORTS..F_EXTRA, on a pod that finds no
# node, or on every pod in explain mode (fast_scan.FastOutputs.fail_counts).
F_NODE_PIN = 0  # NodeName
F_UNSCHEDULABLE = 1
F_TAINT = 2
F_AFFINITY = 3  # NodeAffinity + nodeSelector
F_PORTS = 4
F_FIT = 5  # NodeResourcesFit
F_SPREAD = 6
F_INTERPOD = 7
F_GPU = 8
F_LOCAL = 9
F_EXTRA = 10  # out-of-tree filter plugins (extra_plugins, on the torch reference scan); the kernel counts 0
NUM_FILTERS = 11


class StaticTables(NamedTuple):
    """Per-(template, node) quantities that never change during a scan:
    pods sharing a template share all topology-independent work."""

    static_pass: np.ndarray  # [U, N] bool — AND of the four static filters
    aff_mask: np.ndarray  # [U, N] bool (NodeAffinity + nodeSelector, for spread eligibility)
    static_fail: np.ndarray  # [U, 4] i32 first-fail counts for F_NODE_PIN..F_AFFINITY
    na_raw: np.ndarray  # [U, N] f32 preferred-node-affinity weights
    tt_raw: np.ndarray  # [U, N] f32 intolerable PreferNoSchedule counts
    share_raw: np.ndarray  # [U, N] f32 Simon/GpuShare share × 100
    spread_weight: np.ndarray  # [Tk] f32 log(domain count + 2) per topology key


def gc_row_of(ec) -> int:
    """Resource-axis row of alibabacloud.com/gpu-count, -1 when absent."""
    mask = np.asarray(ec.gc_mask)
    return int(np.argmax(mask)) if mask.any() else -1


def _unique_rows_np(*arrays):
    """(index, inverse) of the unique joint rows of per-template field
    arrays — live-cluster replays dedup pods per PINNED NODE (U ≈ N
    templates differing only in `pin`), but none of the static-table
    computations read the pin, so computing on unique field rows and
    scattering back turns an O(U·N·…) broadcast into O(U_eff·N·…) with
    U_eff = the handful of genuinely distinct specs."""
    packed = np.concatenate(
        [
            np.ascontiguousarray(a.reshape(a.shape[0], -1))
            .view(np.uint8)
            .reshape(a.shape[0], -1)
            for a in arrays
        ],
        axis=1,
    )
    _, idx, inv = np.unique(packed, axis=0, return_index=True, return_inverse=True)
    return idx, inv


def precompute_core_np(ec):
    """The node_valid- and config-INDEPENDENT half of
    :func:`precompute_static_np`: per-(template, node) filter masks and raw
    score tables. Scenario sweeps compute this ONCE and re-fold each
    scenario's node_valid through :func:`precompute_static_np` (the fold is
    O(U·N); this core is the expensive broadcast part)."""
    f32 = np.float32
    label_val = np.asarray(ec.label_val)
    label_num = np.asarray(ec.label_num)
    U = int(np.asarray(ec.req).shape[0])
    N = int(label_val.shape[0])

    def requirements_match(keys, ops, vals, nums):
        # keys/ops/nums [Uc, ...]; vals [Uc, ..., Vv] → bool [Uc, N, ...]
        keys = np.asarray(keys)
        node_val = np.moveaxis(label_val[:, np.maximum(keys, 0)], 0, 1)
        node_num = np.moveaxis(label_num[:, np.maximum(keys, 0)], 0, 1)
        present = node_val >= 0
        vals = np.asarray(vals)
        in_set = (node_val[..., None] == vals[:, None]).any(-1)
        ops_b = np.asarray(ops)[:, None]
        nums_b = np.asarray(nums)[:, None]
        res = np.ones_like(present)
        with np.errstate(invalid="ignore"):
            res = np.where(ops_b == V.OP_IN, present & in_set, res)
            res = np.where(ops_b == V.OP_NOT_IN, ~(present & in_set), res)
            res = np.where(ops_b == V.OP_EXISTS, present, res)
            res = np.where(ops_b == V.OP_DOES_NOT_EXIST, ~present, res)
            res = np.where(ops_b == V.OP_GT, node_num > nums_b, res)
            res = np.where(ops_b == V.OP_LT, node_num < nums_b, res)
        return res

    t_key = np.asarray(ec.taint_key)
    t_val = np.asarray(ec.taint_val)
    t_eff = np.asarray(ec.taint_effect)

    def taints_of(sl):
        tol_valid = np.asarray(ec.tol_valid[sl])
        tol_key = np.asarray(ec.tol_key[sl])[:, None, None, :]
        tol_op = np.asarray(ec.tol_op[sl])[:, None, None, :]
        tol_val = np.asarray(ec.tol_val[sl])[:, None, None, :]
        tol_eff = np.asarray(ec.tol_effect[sl])[:, None, None, :]
        key_ok = (tol_key == -1) | (tol_key == t_key[None, :, :, None])
        eff_ok = (tol_eff == -1) | (tol_eff == t_eff[None, :, :, None])
        val_ok = np.where(tol_op == V.TOL_EXISTS, True, tol_val == t_val[None, :, :, None])
        empty_key_bad = (tol_key == -1) & (tol_op != V.TOL_EXISTS)
        tolerated = (
            key_ok & eff_ok & val_ok & ~empty_key_bad & tol_valid[:, None, None, :]
        ).any(-1)  # [Uc, N, Tt]
        blocking = (t_eff == V.EFFECT_NO_SCHEDULE) | (t_eff == V.EFFECT_NO_EXECUTE)
        mask = ~((blocking[None] & ~tolerated).any(-1))
        ttr = ((t_eff[None] == V.EFFECT_PREFER_NO_SCHEDULE) & ~tolerated).sum(
            -1
        ).astype(f32)
        return mask, ttr

    def affinity_of(sl):
        ns_key = np.asarray(ec.ns_key[sl])
        ns_val = np.asarray(ec.ns_val[sl])
        nv = np.moveaxis(label_val[:, np.maximum(ns_key, 0)], 0, 1)
        sel_ok = ((ns_key[:, None, :] < 0) | (nv == ns_val[:, None, :])).all(-1)
        req_ok = requirements_match(
            ec.aff_key[sl], ec.aff_op[sl], ec.aff_val[sl], ec.aff_num[sl]
        )
        term_ok = req_ok.all(-1)
        any_term = (term_ok & np.asarray(ec.aff_term_valid[sl])[:, None, :]).any(-1)
        return sel_ok & np.where(np.asarray(ec.has_req_aff[sl])[:, None], any_term, True)

    def na_raw_of(sl):
        req_ok = requirements_match(
            ec.pna_key[sl], ec.pna_op[sl], ec.pna_val[sl], ec.pna_num[sl]
        )
        term_ok = req_ok.all(-1)  # [Uc, N, Pp]
        w = np.asarray(ec.pna_weight[sl], f32)[:, None, :]
        return np.where(term_ok, w, f32(0)).sum(-1, dtype=f32)

    # chunk the U axis: the taint/affinity broadcasts are [Uc, N, X, Y]
    per_u = max(
        N * max(int(t_key.shape[1]) * int(np.asarray(ec.tol_key).shape[1]), 1),
        N
        * max(int(np.asarray(ec.aff_key).shape[1]), 1)
        * max(int(np.asarray(ec.aff_key).shape[2]), 1)
        * max(int(np.asarray(ec.aff_val).shape[3]), 1),
    )
    chunk = max(1, int(4e7 // max(per_u, 1)))

    def dedup(fields, compute, outs):
        """Compute per unique field rows, scatter to [U, ...] outputs."""
        idx, inv = _unique_rows_np(*[np.asarray(f) for f in fields])
        ueff = idx.shape[0]
        parts = [np.empty((ueff,) + o.shape[1:], o.dtype) for o in outs]
        for lo in range(0, ueff, chunk):
            sel = idx[lo : lo + chunk]
            vals = compute(sel)
            if not isinstance(vals, tuple):
                vals = (vals,)
            for p, v in zip(parts, vals):
                p[lo : lo + chunk] = v
        for o, p in zip(outs, parts):
            o[:] = p[inv]

    taint = np.empty((U, N), bool)
    aff = np.empty((U, N), bool)
    na_raw = np.empty((U, N), f32)
    tt_raw = np.empty((U, N), f32)
    dedup(
        (ec.tol_valid, ec.tol_key, ec.tol_op, ec.tol_val, ec.tol_effect),
        taints_of, (taint, tt_raw),
    )
    dedup(
        (ec.ns_key, ec.ns_val, ec.has_req_aff, ec.aff_term_valid,
         ec.aff_key, ec.aff_op, ec.aff_val, ec.aff_num),
        affinity_of, (aff,),
    )
    dedup(
        (ec.pna_weight, ec.pna_key, ec.pna_op, ec.pna_val, ec.pna_num),
        na_raw_of, (na_raw,),
    )

    # share_raw: Simon share (plugin/simon.go:45-101), max over resources × 100
    req_full = np.asarray(ec.req, f32)
    alloc = np.asarray(ec.alloc, f32)
    has_dev = (np.asarray(ec.node_gpu_mem) > 0).any(-1)
    gc_mask = np.asarray(ec.gc_mask, bool)
    dyn_active = bool((np.asarray(ec.gpu_mem) > 0).any()) and bool(
        (np.where(gc_mask[None, :], req_full, 0.0) > 0).any()
    )
    share_tbl = np.empty((U, N), f32)

    def share_of(sel):
        req = req_full[sel].copy()
        req[:, V.RES_PODS] = 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            avail = alloc[None] - req[:, None, :]
            share = np.where(
                avail == 0,
                np.where(req[:, None, :] == 0, f32(0), f32(1)),
                req[:, None, :] / avail,
            )
        share = np.where(alloc[None] > 0, share, f32(0))
        share = np.where(
            gc_mask[None, None, :] & has_dev[None, :, None] & dyn_active,
            f32(0), share,
        )
        raw = np.maximum(share.max(-1), f32(0)) * f32(MAX_NODE_SCORE)
        return np.where((req > 0).any(-1)[:, None], raw, f32(MAX_NODE_SCORE))

    dedup((req_full,), share_of, (share_tbl,))

    return {
        "taint": taint,
        "aff": aff,
        "na_raw": na_raw,
        "tt_raw": tt_raw,
        "share_raw": share_tbl.astype(f32),
    }


def precompute_static_np(ec: EncodedCluster, cfg: Optional[SchedulerConfig] = None, core=None) -> StaticTables:
    """The static (usage-independent) tables of the bind scan under the
    scheduler config `cfg` (None: the default), op-for-op in float32. Every
    arithmetic step is either exact in f32 (integer-valued sums/counts,
    single IEEE divisions, max-reductions) or a shared-table gather (spread
    weights), so the tables are bitwise equal to the JAX package's —
    tests/test_torch_encoding.py asserts it. The config's static-filter
    switches (``f_unschedulable``, ``f_taints``, ``f_node_affinity``) pass
    every node through a filter that is off. `core` reuses
    :func:`precompute_core_np` output."""
    cfg = cfg or DEFAULT_CONFIG
    f32 = np.float32
    if core is None:
        core = precompute_core_np(ec)
    taint, aff = core["taint"], core["aff"]

    node_valid = np.asarray(ec.node_valid, bool)
    unsched = np.broadcast_to(~np.asarray(ec.unschedulable, bool)[None, :], taint.shape)
    true_m = np.ones_like(taint)
    fails = []
    passed = np.broadcast_to(node_valid[None, :], taint.shape)
    for m, enabled in (
        (true_m, True),  # pin column stays zero (forced-bind path)
        (unsched, cfg.f_unschedulable),
        (taint, cfg.f_taints),
        (aff, cfg.f_node_affinity),
    ):
        m = m if enabled else true_m
        fails.append((passed & ~m).sum(-1))
        passed = passed & m

    Dp1 = int(np.asarray(ec.domain_topo).shape[0])
    Tk = int(np.asarray(ec.node_domain).shape[1])
    dom_present = np.zeros((Dp1,), f32)
    nd = np.where(node_valid[:, None], np.asarray(ec.node_domain), Dp1 - 1)
    dom_present[np.unique(nd)] = 1.0
    domain_topo = np.asarray(ec.domain_topo)
    sizes = np.array(
        [
            np.where(domain_topo[: Dp1 - 1] == tk, dom_present[: Dp1 - 1], 0.0).sum()
            for tk in range(Tk)
        ]
    )
    log_sizes = np.asarray(ec.log_sizes)
    spread_weight = log_sizes[
        np.clip(sizes.astype(np.int32), 0, log_sizes.shape[0] - 1)
    ]

    return StaticTables(
        static_pass=passed,
        aff_mask=aff,
        static_fail=np.stack(fails, axis=-1).astype(np.int32),
        na_raw=core["na_raw"],
        tt_raw=core["tt_raw"],
        share_raw=core["share_raw"],
        spread_weight=spread_weight.astype(f32),
    )


class Features(NamedTuple):
    """Static (trace-time) feature flags of the whole workload set: any
    kernel whose inputs are empty across every template is eliminated from
    the compiled scan entirely. Computed host-side at encode time."""

    ports: bool
    gpu: bool
    local: bool
    interpod: bool  # any required pod affinity/anti-affinity term
    prefg: bool  # any preferred/symmetric inter-pod score term
    spread_hard: bool
    spread_soft: bool
    pref_node_affinity: bool
    prefer_taints: bool
    prefer_avoid: bool
    # some template requests alibabacloud.com/gpu-count as a SPEC resource
    # while gpushare devices exist: the allocatable column follows the device
    # state (Reserve rewrite) instead of the static table
    gc_dyn: bool = False

    @property
    def sel_counts(self) -> bool:
        return self.interpod or self.spread_hard or self.spread_soft


ALL_FEATURES = Features(*([True] * 11))


def features_of(ec_np) -> Features:
    """Derive feature flags from the (host-side numpy) encoded cluster."""
    return Features(
        ports=bool((np.asarray(ec_np.ports) >= 0).any()),
        gpu=bool((np.asarray(ec_np.gpu_mem) > 0).any()),
        local=bool(
            (np.asarray(ec_np.lvm_req) > 0).any() or (np.asarray(ec_np.dev_req) > 0).any()
        ),
        interpod=bool(
            (np.asarray(ec_np.at_sel) >= 0).any() or (np.asarray(ec_np.an_sel) >= 0).any()
        ),
        prefg=bool((np.asarray(ec_np.prefg_w) != 0).any()),
        spread_hard=bool(
            ((np.asarray(ec_np.spr_topo) >= 0) & np.asarray(ec_np.spr_hard)).any()
        ),
        spread_soft=bool(
            ((np.asarray(ec_np.spr_topo) >= 0) & ~np.asarray(ec_np.spr_hard)).any()
        ),
        pref_node_affinity=bool((np.asarray(ec_np.pna_weight) != 0).any()),
        prefer_taints=bool(
            (np.asarray(ec_np.taint_effect) == V.EFFECT_PREFER_NO_SCHEDULE).any()
        ),
        prefer_avoid=bool((np.asarray(ec_np.avoid_score) < 100.0).any()),
        gc_dyn=bool(
            (np.asarray(ec_np.gpu_mem) > 0).any()
            and np.asarray(ec_np.gc_mask).any()
            and (np.asarray(ec_np.req)[:, np.asarray(ec_np.gc_mask)] > 0).any()
        ),
    )


#: The weighted score parts of a non-default config's sum, in the order
#: the reference adds them (``kernels.score_parts``,
#: ``opensim_tpu/ops/kernels.py:918-979``, summed from 0 in ``pod_step``):
#: the weights of :class:`KernelConfig` in this order. ``share`` is Simon
#: plus Open-Gpu-Share, which share one formula.
SCORE_PARTS = ("balanced", "least", "node_affinity", "taint_toleration", "interpod", "spread", "share", "local",
               "prefer_avoid")
#: The dynamic filters a config switches, bit f - F_PORTS of
#: :attr:`KernelConfig.filters` (the kernel's order of attribution).
_DYNAMIC_FILTERS = (("f_ports", F_PORTS), ("f_fit", F_FIT), ("f_spread", F_SPREAD), ("f_interpod", F_INTERPOD),
                    ("f_gpu", F_GPU), ("f_local", F_LOCAL))


class KernelConfig(NamedTuple):
    """A non-default scheduler config as the bind-scan kernel takes it."""

    weights: Tuple[float, ...]  # float32 values, SCORE_PARTS order; 0 leaves the part out
    filters: int  # bit f - F_PORTS set: dynamic filter f is on (ports, fit, spread, inter-pod, gpu, local)
    fit_ignored: int  # bit r set: the fit filter skips resource row r


def kernel_config(cfg: Optional[SchedulerConfig], n_resources: int, segment: bool = False) -> Optional[KernelConfig]:
    """The launch arguments of scheduler config `cfg` over `n_resources`
    resource rows; None for no config or one equal to the default, which
    runs the kernel's default variant, but for a `segment` of a segmented
    multi-profile run: the reference runs every segment on its XLA scan,
    which sums the weighted parts in ``score_parts`` order whatever the
    config, and a segment after the first starts from a carried state,
    which the cfg variant takes. Each weight is the float32 the
    reference multiplies by (its weakly typed product rounds the Python
    float once); Simon's and Open-Gpu-Share's are added in double first, as
    the reference adds them. The static filters' switches are not here:
    they shape the static tables (:func:`precompute_static_np`)."""
    if not segment and (cfg is None or cfg == DEFAULT_CONFIG):
        return None
    cfg = cfg or DEFAULT_CONFIG
    cols = set(cfg.fit_ignored_cols)
    if any(not 0 <= c < n_resources for c in cols):
        raise ValueError(f"fit_ignored_cols {sorted(cols)} outside the {n_resources} resource rows")
    raw = (cfg.w_balanced, cfg.w_least, cfg.w_node_affinity, cfg.w_taint_toleration, cfg.w_interpod, cfg.w_spread,
           cfg.w_simon + cfg.w_gpu_share, cfg.w_local, cfg.w_prefer_avoid)
    weights = tuple(float(np.float32(w)) for w in raw)
    if not all(np.isfinite(weights)):
        raise ValueError(f"scheduler config weights must be finite, not {raw}")
    filters = sum(1 << (f - F_PORTS) for name, f in _DYNAMIC_FILTERS if getattr(cfg, name))
    return KernelConfig(weights, filters, sum(1 << c for c in cols))



# ---------------------------------------------------------------------------
# the plugin pipeline of one step, in torch (opensim_tpu/ops/kernels.py)
# ---------------------------------------------------------------------------

def static_tables(ec: EncodedCluster, cfg: Optional[SchedulerConfig] = None, core=None) -> StaticTables:
    """:func:`precompute_static_np` of a torch ``EncodedCluster`` (its
    ``node_valid`` folded in), as tensors on the cluster's device: the
    static tables :func:`pod_step` reads."""
    dev = ec.node_valid.device
    ec_np = EncodedCluster(*(t.cpu().numpy() for t in ec))
    stat = precompute_static_np(ec_np, cfg, core=core)
    return StaticTables(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in stat))


def _gather_label(label_arr, keys):
    """label_arr [N, K], keys [...]-shaped int32 (may be -1) → values
    [N, ...]; -1 keys read column 0 (their requirement is padding)."""
    return label_arr[:, keys.clamp(min=0).long()]


def _requirements_match(ec, keys, ops, vals, nums):
    """Node-selector requirements against all nodes: bool [N, ...], True
    where the requirement holds (padding requirements are vacuously True)."""
    node_val = _gather_label(ec.label_val, keys)
    node_num = _gather_label(ec.label_num, keys)
    present = node_val >= 0
    in_set = (node_val[..., None] == vals[None, ...]).any(-1)
    ops_b = ops[None, ...]
    result = torch.ones_like(present)
    result = torch.where(ops_b == V.OP_IN, present & in_set, result)
    result = torch.where(ops_b == V.OP_NOT_IN, ~(present & in_set), result)
    result = torch.where(ops_b == V.OP_EXISTS, present, result)
    result = torch.where(ops_b == V.OP_DOES_NOT_EXIST, ~present, result)
    result = torch.where(ops_b == V.OP_GT, node_num > nums[None, ...], result)
    result = torch.where(ops_b == V.OP_LT, node_num < nums[None, ...], result)
    return result


def _minmax_normalize(scores, feasible):
    """SimonPlugin.NormalizeScore (plugin/simon.go:76-101): min-max over the
    feasible set to [0, 100]; a degenerate range gives 0."""
    lo = torch.min(torch.where(feasible, scores, 1e30))
    hi = torch.max(torch.where(feasible, scores, -1e30))
    rng = hi - lo
    return torch.where(rng > 0, (scores - lo) * MAX_NODE_SCORE / rng, 0.0)


def _tolerated(ec, u):
    """[N, Tt] bool: some valid toleration of template u tolerates the taint."""
    t_key, t_val, t_eff = ec.taint_key, ec.taint_val, ec.taint_effect
    tol_valid = ec.tol_valid[u]
    tol_key, tol_op, tol_val, tol_eff = ec.tol_key[u], ec.tol_op[u], ec.tol_val[u], ec.tol_effect[u]
    key_ok = (tol_key[None, None, :] == -1) | (tol_key[None, None, :] == t_key[:, :, None])
    eff_ok = (tol_eff[None, None, :] == -1) | (tol_eff[None, None, :] == t_eff[:, :, None])
    val_ok = (tol_op[None, None, :] == V.TOL_EXISTS) | (tol_val[None, None, :] == t_val[:, :, None])
    # an empty-key (-1) toleration must use operator Exists to match all
    empty_key_bad = (tol_key[None, None, :] == -1) & (tol_op[None, None, :] != V.TOL_EXISTS)
    return (key_ok & eff_ok & val_ok & ~empty_key_bad & tol_valid[None, None, :]).any(-1)


def taint_filter(ec, u):
    """TaintToleration: every NoSchedule/NoExecute taint must be tolerated."""
    t_eff = ec.taint_effect
    blocking = (t_eff == V.EFFECT_NO_SCHEDULE) | (t_eff == V.EFFECT_NO_EXECUTE)
    return ~(blocking & ~_tolerated(ec, u)).any(-1)


def node_affinity_filter(ec, u):
    """NodeAffinity plugin: nodeSelector map AND required node affinity
    (OR over terms, AND over requirements)."""
    ns_key, ns_val = ec.ns_key[u], ec.ns_val[u]
    node_val = _gather_label(ec.label_val, ns_key)  # [N, Qs]
    sel_ok = ((ns_key[None, :] < 0) | (node_val == ns_val[None, :])).all(-1)
    req_ok = _requirements_match(ec, ec.aff_key[u], ec.aff_op[u], ec.aff_val[u], ec.aff_num[u])
    term_ok = req_ok.all(-1)  # [N, T]
    any_term = (term_ok & ec.aff_term_valid[u][None, :]).any(-1)
    aff_ok = any_term if bool(ec.has_req_aff[u]) else torch.ones_like(any_term)
    return sel_ok & aff_ok


def ports_filter(ec, st, u):
    """NodePorts: no requested host port may conflict with one in use on
    the node (wildcard 0.0.0.0 overlaps every hostIP, nodeports.go)."""
    ports = ec.ports[u]  # [Hp]
    conf = ec.port_conflict[ports.clamp(min=0).long()].to(torch.float32)  # [Hp, Hports]
    hits = st.port_used @ conf.T  # [N, Hp] conflicting uses: integer counts, exact
    conflict = (ports[None, :] >= 0) & (hits > 0)
    return ~conflict.any(-1)


def gc_dynamic_alloc(ec, st):
    """The gpushare Reserve rewrite (open-gpu-share.go:177-182): a
    device-bearing node's gpu-count allocatable is the number of its
    devices not fully used. Returns (dyn [N] f32, has_dev [N] bool)."""
    valid_dev = ec.node_gpu_mem > 0
    dyn = (valid_dev & (st.gpu_free > 0)).sum(-1).to(torch.float32)
    return dyn, valid_dev.any(-1)


def effective_alloc(ec, st):
    """Allocatable with the dynamic gpu-count column on device-bearing nodes."""
    dyn, has_dev = gc_dynamic_alloc(ec, st)
    return torch.where(ec.gc_mask[None, :] & has_dev[:, None], dyn[:, None], ec.alloc)


def fit_filter(ec, st, u, alloc=None, ignored_cols: tuple = ()):
    """NodeResourcesFit (noderesources/fit.go:195-260): requested resources
    fit allocatable - used. Returns (mask [N], insufficient [N, R]);
    `ignored_cols` are resource columns the filter skips."""
    alloc = ec.alloc if alloc is None else alloc
    req = ec.req[u]
    insufficient = (req[None, :] > 0) & (st.used + req[None, :] > alloc)
    for c in ignored_cols:
        insufficient[:, c] = False
    return ~insufficient.any(-1), insufficient


def spread_filter(ec, st, u, node_aff_mask):
    """PodTopologySpread DoNotSchedule constraints (filtering.go:276): for
    each hard constraint, matchCount(domain) + selfMatch - minMatch(eligible
    domains) <= maxSkew."""
    topo, sel = ec.spr_topo[u], ec.spr_sel[u].long()
    skew, hard = ec.spr_skew[u], ec.spr_hard[u]
    active = (topo >= 0) & hard
    dom = ec.node_domain[:, topo.clamp(min=0).long()].long()  # [N, Cs]
    has_label = dom < ec.domain_topo.shape[0] - 1  # the trash row: label missing
    cnt = st.dom_sel[dom, sel[None, :]]  # [N, Cs]
    self_match = ec.matches_sel[u, sel]  # [Cs]
    # min matchNum over eligible domains: nodes passing node affinity with
    # the label present (filtering.go calPreFilterState)
    eligible = node_aff_mask[:, None] & has_label & ec.node_valid[:, None]
    min_cnt = torch.where(eligible, cnt, 1e30).min(0).values  # [Cs]
    ok = cnt + self_match[None, :].to(torch.float32) - min_cnt <= skew[None, :].to(torch.float32)
    ok = ok & has_label  # a node missing the topology label fails the constraint
    return (ok | ~active[None, :]).all(-1)


def interpod_filter(ec, st, u):
    """InterPodAffinity filter (interpodaffinity/filtering.go:378): the
    pod's required anti-affinity, the existing pods' anti terms against it,
    and its required affinity with the first-pod bootstrap."""
    d_trash = ec.domain_topo.shape[0] - 1
    # (1) incoming anti terms; a node without the label forms no pair
    an_sel, an_topo = ec.an_sel[u], ec.an_topo[u].long()
    an_active = an_sel >= 0
    dom = ec.node_domain[:, an_topo].long()  # [N, Tn]
    anti_cnt = st.dom_sel[dom, an_sel.clamp(min=0).long()[None, :]]
    has_label = dom < d_trash
    anti_ok = (~an_active[None, :] | ~has_label | (anti_cnt == 0)).all(-1)
    # (2) existing pods' anti terms (symmetric check)
    g_topo = ec.anti_g_topo.long()
    dom_g = ec.node_domain[:, g_topo].long()  # [N, G]
    has_label_g = dom_g < d_trash
    exist_cnt = st.dom_anti[dom_g, torch.arange(g_topo.shape[0], device=dom_g.device)[None, :]]
    incoming_matches = ec.matches_sel[u, ec.anti_g_sel.long()]  # [G]
    sym_ok = (~(has_label_g & (exist_cnt > 0) & incoming_matches[None, :])).all(-1)
    # (3) incoming required affinity: every term's label on the node and a
    # matching pod in its domain, or the bootstrap (an empty global count
    # map, a full self-match, the labels present); filtering.go:347-374
    at_sel, at_topo = ec.at_sel[u], ec.at_topo[u]
    at_active = at_sel >= 0
    sel_a = at_sel.clamp(min=0).long()
    dom_a = ec.node_domain[:, at_topo.long()].long()  # [N, Ti]
    aff_cnt = st.dom_sel[dom_a, sel_a[None, :]]
    has_label_a = dom_a < d_trash
    dom_is_key = ec.domain_topo[None, :] == at_topo[:, None]  # [Ti, D+1]
    total = torch.where(dom_is_key, st.dom_sel[:, sel_a].T, 0.0).sum(-1)  # [Ti] integer counts
    map_empty = torch.where(at_active, total, 0.0).sum() == 0
    self_match = ec.matches_sel[u, sel_a]
    bootstrap = map_empty & (~at_active | self_match).all() & at_active.any()
    per_term_ok = ~at_active[None, :] | (has_label_a & (aff_cnt > 0))
    labels_ok = ~at_active[None, :] | has_label_a
    aff_ok = per_term_ok.all(-1) | (labels_ok.all(-1) & bootstrap)
    return anti_ok & sym_ok & aff_ok


def gpu_filter(ec, st, u):
    """Open-Gpu-Share filter (open-gpu-share.go:51-81): per-GPU memory ×
    count must be packable, i.e. sum_d floor(free_d / mem) >= count."""
    mem = ec.gpu_mem[u]
    cnt = ec.gpu_count[u].to(torch.float32)
    chunks = torch.floor_divide(st.gpu_free, torch.clamp(mem, min=1.0)).sum(-1)  # [N]
    ok = (chunks >= cnt) & (cnt > 0)
    return ok if bool(mem > 0) else torch.ones_like(ok)


def local_filter(ec, st, u):
    """Open-Local filter (open-local.go:51-92): the LVM request fits the
    best VG; with each media's volume sizes descending, the i-th largest
    finds at least i fitting free devices (Hall's condition)."""
    lvm = ec.lvm_req[u]
    lvm_ok = st.vg_free.max(-1).values >= lvm
    ok = lvm_ok if bool(lvm > 0) else torch.ones_like(lvm_ok)
    free = st.dev_free  # [N, Dv]
    for media in (0, 1):
        sizes = ec.dev_req_sizes[u, media]  # [Mv]
        fitting = (
            (ec.node_dev_media[:, None, :] == media)
            & (free[:, None, :] >= sizes[None, :, None])
            & (free[:, None, :] > 0)
        )  # [N, Mv, Dv]
        fit_cnt = fitting.sum(-1)  # [N, Mv]
        rank = torch.arange(sizes.shape[0], device=sizes.device) + 1
        ok = ok & ((sizes[None, :] <= 0) | (fit_cnt >= rank[None, :])).all(-1)
    return ok


def _nonzero_req(ec, u):
    """GetNonzeroRequests: 100m CPU / 200Mi memory for a pod that asks none."""
    cpu, mem = ec.req[u, V.RES_CPU], ec.req[u, V.RES_MEMORY]
    return torch.where(cpu > 0, cpu, 100.0), torch.where(mem > 0, mem, 200.0 * 1024 * 1024)


def _least_requested(requested, capacity):
    score = (capacity - requested) * MAX_NODE_SCORE / torch.clamp(capacity, min=1.0)
    return torch.where((capacity == 0) | (requested > capacity), 0.0, score)


def least_allocated_score(ec, st, u):
    """NodeResourcesLeastAllocated (least_allocated.go:93-117)."""
    cpu_req, mem_req = _nonzero_req(ec, u)
    cpu_score = _least_requested(st.used[:, V.RES_CPU] + cpu_req, ec.alloc[:, V.RES_CPU])
    mem_score = _least_requested(st.used[:, V.RES_MEMORY] + mem_req, ec.alloc[:, V.RES_MEMORY])
    return (cpu_score + mem_score) / 2.0


def balanced_allocation_score(ec, st, u):
    """NodeResourcesBalancedAllocation (balanced_allocation.go:82-112)."""
    cpu_req, mem_req = _nonzero_req(ec, u)
    cpu_frac = (st.used[:, V.RES_CPU] + cpu_req) / torch.clamp(ec.alloc[:, V.RES_CPU], min=1.0)
    mem_frac = (st.used[:, V.RES_MEMORY] + mem_req) / torch.clamp(ec.alloc[:, V.RES_MEMORY], min=1.0)
    score = (1.0 - torch.abs(cpu_frac - mem_frac)) * MAX_NODE_SCORE
    return torch.where((cpu_frac >= 1.0) | (mem_frac >= 1.0), 0.0, score)


def node_affinity_raw(ec, u):
    """NodeAffinity score before normalisation: the sum of the matching
    preferred terms' weights (integers, exact in any order)."""
    req_ok = _requirements_match(ec, ec.pna_key[u], ec.pna_op[u], ec.pna_val[u], ec.pna_num[u])
    term_ok = req_ok.all(-1)  # [N, Pp]
    return torch.where(term_ok, ec.pna_weight[u][None, :], 0.0).sum(-1)


def taint_toleration_raw(ec, u):
    """TaintToleration score input: intolerable PreferNoSchedule taints."""
    prefer = ec.taint_effect == V.EFFECT_PREFER_NO_SCHEDULE
    return (prefer & ~_tolerated(ec, u)).sum(-1).to(torch.float32)


def interpod_score(ec, st, u, feasible):
    """InterPodAffinity score (interpodaffinity/scoring.go): the pod's
    preferred terms against existing pods plus the existing pods'
    symmetric preferred and hard-affinity weights, min-max normalised over
    the feasible set with both ends seeded at 0. Every term is an integer
    count times an integer weight below 2^24: exact in any order."""
    d_trash = ec.domain_topo.shape[0] - 1
    pt_sel, pt_topo, pt_w = ec.pt_sel[u], ec.pt_topo[u].long(), ec.pt_w[u]
    dom = ec.node_domain[:, pt_topo].long()  # [N, Tpp]
    has_label = dom < d_trash
    cnt = st.dom_sel[dom, pt_sel.clamp(min=0).long()[None, :]]
    incoming = torch.where((pt_sel[None, :] >= 0) & has_label, cnt * pt_w[None, :], 0.0).sum(-1)
    g_topo = ec.prefg_topo.long()
    dom_g = ec.node_domain[:, g_topo].long()  # [N, Gp]
    has_label_g = dom_g < d_trash
    w_sum = st.dom_prefw[dom_g, torch.arange(g_topo.shape[0], device=dom_g.device)[None, :]]
    matches = ec.matches_sel[u, ec.prefg_sel.long()].to(torch.float32)  # [Gp]
    symmetric = torch.where(has_label_g, w_sum * matches[None, :], 0.0).sum(-1)
    raw = incoming + symmetric
    masked = torch.where(feasible, raw, 0.0)
    hi = torch.clamp(masked.max(), min=0.0)
    lo = torch.clamp(masked.min(), max=0.0)
    rng = hi - lo
    return torch.where(rng > 0, MAX_NODE_SCORE * (raw - lo) / torch.clamp(rng, min=1.0), 0.0)


def spread_score(ec, stat: StaticTables, st, u, feasible):
    """PodTopologySpread score (scoring.go:175-248) of the ScheduleAnyway
    constraints: score_n = Σ_c cnt·log-weight + (maxSkew - 1), inverted and
    normalised so spreading wins. The constraints add in their order."""
    topo, sel = ec.spr_topo[u], ec.spr_sel[u].long()
    skew = ec.spr_skew[u].to(torch.float32)
    soft = (topo >= 0) & ~ec.spr_hard[u]
    d_trash = ec.domain_topo.shape[0] - 1
    dom = ec.node_domain[:, topo.clamp(min=0).long()].long()  # [N, Cs]
    has_label = dom < d_trash
    cnt = st.dom_sel[dom, sel[None, :]]  # [N, Cs]
    ignored = feasible & ~(has_label | ~soft[None, :]).all(-1)
    scored = feasible & ~ignored
    weight = stat.spread_weight[topo.clamp(min=0).long()]  # [Cs]
    contrib = torch.where(soft[None, :] & has_label, cnt * weight[None, :] + (skew[None, :] - 1.0), 0.0)
    raw = torch.zeros_like(contrib[:, 0]) if contrib.shape[1] == 0 else contrib[:, 0]
    for c in range(1, contrib.shape[1]):
        raw = raw + contrib[:, c]
    mn = torch.where(scored, raw, 1e30).min()
    mx = torch.where(scored, raw, -1e30).max()
    norm = torch.where(mx <= 0, MAX_NODE_SCORE, MAX_NODE_SCORE * (mx + mn - raw) / torch.clamp(mx, min=1.0))
    norm = torch.where(ignored, 0.0, norm)
    return norm if bool(soft.any()) else torch.zeros_like(norm)


def share_raw(ec, u):
    """Simon / Open-Gpu-Share share score before normalisation
    (plugin/simon.go:45-74, algo.Share): the largest req / (allocatable -
    req) over the resources the node declares, × 100; the gpu-count column
    of a device-bearing node is left to :func:`gc_share_dyn` when the
    devices fill (the static tables' ``share_raw`` row of template u)."""
    req = ec.req[u].clone()
    req[V.RES_PODS] = 0.0  # the 'pods' request is not in PodRequestsAndLimits
    avail = ec.alloc - req[None, :]
    share = torch.where(avail == 0, torch.where(req[None, :] == 0, 0.0, 1.0), req[None, :] / avail)
    share = torch.where(ec.alloc > 0, share, 0.0)
    has_dev = (ec.node_gpu_mem > 0).any(-1)
    dyn_active = bool((ec.gpu_mem > 0).any()) and bool((torch.where(ec.gc_mask[None, :], ec.req, 0.0) > 0).any())
    share = torch.where(ec.gc_mask[None, :] & has_dev[:, None] & dyn_active, 0.0, share)
    raw = torch.clamp(share.max(-1).values, min=0.0) * MAX_NODE_SCORE
    return raw if bool((req > 0).any()) else torch.full_like(raw, MAX_NODE_SCORE)


def gc_share_dyn(ec, st, u):
    """The share term of the dynamic gpu-count allocatable
    (open-gpu-share.go:94-106): req / (dyn_alloc - req), 1 when the
    denominator is 0, floored at 0; 0 on device-less nodes and for a
    template that asks no gpu-count."""
    gc_req = torch.where(ec.gc_mask, ec.req[u], 0.0).sum()
    dyn, has_dev = gc_dynamic_alloc(ec, st)
    declared = torch.where(ec.gc_mask[None, :], ec.alloc, 0.0).sum(-1) > 0
    avail = dyn - gc_req
    share = torch.where(avail == 0, torch.where(gc_req == 0, 0.0, 1.0), gc_req / avail)
    share = torch.where(declared & has_dev, torch.clamp(share, min=0.0), 0.0)
    return torch.where(gc_req > 0, share * MAX_NODE_SCORE, 0.0)


def local_score(ec, st, u):
    """Open-Local binpack score (open-local.go:94-138): the mean over the
    pod's storage units of request / capacity of the unit it would take,
    × 10; the LVM unit on the tightest-fitting VG."""
    lvm = ec.lvm_req[u]
    big = 1e30
    fits = st.vg_free >= lvm  # [N, Vg]
    masked = torch.where(fits, st.vg_free, big)
    tight_free = masked.min(-1).values
    choice = masked.argmin(-1)  # the first of equals
    vg_cap = torch.gather(ec.node_vg_cap, 1, choice[:, None])[:, 0]
    parts = torch.where((lvm > 0) & (tight_free < big), lvm / torch.clamp(vg_cap, min=1.0), 0.0)
    count = (lvm > 0).to(torch.float32)
    for media in (0, 1):
        size = ec.dev_req[u, media]
        n_dev = ec.dev_req_count[u, media].to(torch.float32)
        fitting = (ec.node_dev_media == media) & (st.dev_free >= size) & (st.dev_free > 0)
        dev_cap = torch.where(fitting, ec.node_dev_cap, big)
        first_cap = dev_cap.min(-1).values  # first-fit proxy: the smallest fitting device
        parts = parts + torch.where(size > 0, n_dev * size / torch.clamp(first_cap, min=1.0), 0.0)
        count = count + torch.where(size > 0, n_dev, 0.0)
    return torch.where(count > 0, parts / torch.clamp(count, min=1.0) * 10.0, 0.0)


class StepResult(NamedTuple):
    feasible: torch.Tensor  # [N] bool
    score: torch.Tensor  # [N] f32 weighted total
    chosen: int  # node index, -1 when no node is feasible
    fail_counts: torch.Tensor  # [NUM_FILTERS - F_PORTS] i32 first-fail node counts of the dynamic filters
    insufficient: torch.Tensor  # [R] i32 nodes short of each resource


def score_parts(ec, stat: StaticTables, st, u, feasible, feat: Features = ALL_FEATURES,
                cfg: Optional[SchedulerConfig] = None, extra: tuple = ()) -> Dict[str, torch.Tensor]:
    """Each plugin's weighted score over the node axis, keyed by the kube
    plugin name, in the order :func:`pod_step` sums them
    (``kernels.score_parts``, ``opensim_tpu/ops/kernels.py:918-979``):
    summing the values from 0 in this order gives the step's score bit for
    bit. The per-plugin breakdown of ``simon explain`` reads it."""
    cfg = cfg or DEFAULT_CONFIG
    parts: Dict[str, torch.Tensor] = {}
    if cfg.w_balanced:
        parts["NodeResourcesBalancedAllocation"] = cfg.w_balanced * balanced_allocation_score(ec, st, u)
    if cfg.w_least:
        parts["NodeResourcesLeastAllocated"] = cfg.w_least * least_allocated_score(ec, st, u)
    if feat.pref_node_affinity and cfg.w_node_affinity:
        na_raw = stat.na_raw[u]
        na_max = torch.where(feasible, na_raw, 0.0).max()
        parts["NodeAffinity"] = cfg.w_node_affinity * torch.where(
            na_max > 0, na_raw * MAX_NODE_SCORE / torch.clamp(na_max, min=1.0), na_raw)
    if feat.prefer_taints and cfg.w_taint_toleration:
        tt_raw = stat.tt_raw[u]
        tt_max = torch.where(feasible, tt_raw, 0.0).max()
        parts["TaintToleration"] = cfg.w_taint_toleration * torch.where(
            tt_max > 0, MAX_NODE_SCORE - tt_raw * MAX_NODE_SCORE / torch.clamp(tt_max, min=1.0), MAX_NODE_SCORE)
    if (feat.prefg or feat.interpod) and cfg.w_interpod:
        parts["InterPodAffinity"] = cfg.w_interpod * interpod_score(ec, st, u, feasible)
    if feat.spread_soft and cfg.w_spread:
        parts["PodTopologySpread"] = cfg.w_spread * spread_score(ec, stat, st, u, feasible)
    if cfg.w_simon + cfg.w_gpu_share:
        # Simon and Open-Gpu-Share share one formula and normalisation
        share_row = stat.share_raw[u]
        if feat.gc_dyn:
            # the gpu-count column with its Reserve-updated value, which
            # share_raw left out on device-bearing nodes
            share_row = torch.maximum(share_row, gc_share_dyn(ec, st, u))
        parts["Simon/GpuShare"] = (cfg.w_simon + cfg.w_gpu_share) * _minmax_normalize(share_row, feasible)
    if feat.local and cfg.w_local:
        parts["OpenLocal"] = cfg.w_local * _minmax_normalize(local_score(ec, st, u), feasible)
    if feat.prefer_avoid and cfg.w_prefer_avoid:
        # NodePreferAvoidPods (no NormalizeScore): the raw 0/100 table
        parts["NodePreferAvoidPods"] = cfg.w_prefer_avoid * ec.avoid_score[u]
    for k, entry in enumerate(extra):
        if entry[0] == "score":
            parts[f"Extra[{k}]"] = float(entry[2]) * entry[1](ec, st, u, feasible)
    return parts


def pod_step(ec: EncodedCluster, stat: StaticTables, st: ScanState, u: int, feat: Features = ALL_FEATURES,
             cfg: Optional[SchedulerConfig] = None, extra: tuple = (), count_all: bool = False) -> StepResult:
    """One pod (template `u`) through filter, score and selectHost
    (``kernels.pod_step``, ``opensim_tpu/ops/kernels.py:982-1087``;
    scheduleOne minus the bind). The static filters are the precomputed
    row; the usage-dependent ones run where the workload needs them
    (`feat`) and `cfg` leaves them on. Each node counts under the first
    dynamic filter it fails, in the order of attribution, and, where it
    reaches fit, under each resource it lacks: on a step that finds no
    node, or on every step with `count_all` (explain mode).

    `extra` holds out-of-tree plugins as torch callables:
    ``("filter", fn)`` with ``fn(ec, st, u) -> bool [N]``, or
    ``("score", fn, weight)`` with ``fn(ec, st, u, feasible) -> f32 [N]``
    (already scaled to 0-100)."""
    cfg = cfg or DEFAULT_CONFIG
    valid = ec.node_valid
    aff_mask = stat.aff_mask[u]
    static_pass = stat.static_pass[u]  # validity folded in
    true_mask = torch.ones_like(static_pass)
    masks = [ports_filter(ec, st, u) if feat.ports and cfg.f_ports else true_mask]
    alloc_eff = effective_alloc(ec, st) if feat.gc_dyn else None
    if cfg.f_fit:
        fit_mask, insufficient = fit_filter(ec, st, u, alloc=alloc_eff, ignored_cols=cfg.fit_ignored_cols)
    else:
        fit_mask, insufficient = true_mask, torch.zeros_like(ec.alloc, dtype=torch.bool)
    masks.append(fit_mask)
    masks.append(spread_filter(ec, st, u, aff_mask & valid) if feat.spread_hard and cfg.f_spread else true_mask)
    masks.append(interpod_filter(ec, st, u) if feat.interpod and cfg.f_interpod else true_mask)
    masks.append(gpu_filter(ec, st, u) if feat.gpu and cfg.f_gpu else true_mask)
    masks.append(local_filter(ec, st, u) if feat.local and cfg.f_local else true_mask)
    extra_filter = true_mask
    for entry in extra:
        if entry[0] == "filter":
            extra_filter = extra_filter & entry[1](ec, st, u)
    masks.append(extra_filter)  # the F_EXTRA slot

    passed_list = []
    passed = static_pass
    insufficient_attributed = None
    for i, m in enumerate(masks):
        passed_list.append(passed)
        if i == F_FIT - F_PORTS:
            # per-resource counts only for nodes that reach the fit filter
            insufficient_attributed = insufficient & passed[:, None]
        passed = passed & m
    feasible = passed
    any_feasible = bool(feasible.any())
    if count_all or not any_feasible:
        fail_counts = torch.stack([(p & ~m).sum() for p, m in zip(passed_list, masks)]).to(torch.int32)
        per_res = (insufficient_attributed & valid[:, None]).sum(0).to(torch.int32)
    else:
        fail_counts = torch.zeros((len(masks),), dtype=torch.int32, device=valid.device)
        per_res = torch.zeros((insufficient.shape[1],), dtype=torch.int32, device=valid.device)

    # the weighted score parts, summed from 0 in score_parts order
    score = torch.zeros_like(stat.share_raw[u])
    for term in score_parts(ec, stat, st, u, feasible, feat, cfg, extra).values():
        score = score + term
    best = int(torch.where(feasible, score, -1e30).argmax())  # the first of the maxima
    return StepResult(feasible, score, best if any_feasible else -1, fail_counts, per_res)


def bind_update(ec: EncodedCluster, st: ScanState, u: int, node: int, feat: Features = ALL_FEATURES) -> torch.Tensor:
    """Bind template `u` on `node` (``kernels.bind_update``,
    ``opensim_tpu/ops/kernels.py:1090-1215``: the Reserve and Bind plugins
    writing back into the fake clientset), in place on `st`'s tensors,
    which the scan owns. Returns the GPU slots packed onto each device
    (the gpu-index annotation)."""
    st.used[node] += ec.req[u]
    if feat.ports:
        ports = ec.ports[u]  # [Hp]
        hports = st.port_used.shape[1]
        hot = ((torch.arange(hports, device=ports.device)[None, :] == ports[:, None]) & (ports[:, None] >= 0))
        st.port_used[node] += hot.sum(0).to(torch.float32)
    if feat.sel_counts:
        matches = ec.matches_sel[u].to(torch.float32)
        for d in ec.node_domain[node].tolist():  # one row per topology key, in key order
            st.dom_sel[d] += matches
    if feat.interpod:
        anti = ec.anti_g[u].to(torch.float32)
        for g, d in enumerate(ec.node_domain[node, ec.anti_g_topo.long()].tolist()):
            st.dom_anti[d, g] += anti[g]
    if feat.prefg:
        pref = ec.prefg_w[u]
        for g, d in enumerate(ec.node_domain[node, ec.prefg_topo.long()].tolist()):
            st.dom_prefw[d, g] += pref[g]
    take = torch.zeros_like(st.gpu_free[0])
    if feat.gpu:
        # AllocateGpuId (gpunodeinfo.go:232-290): one GPU takes the tightest
        # fit, several the greedy chunks with reuse
        mem = ec.gpu_mem[u]
        cnt = ec.gpu_count[u].to(torch.float32)
        free = st.gpu_free[node]  # [Gd]
        chunks = torch.floor_divide(free, torch.clamp(mem, min=1.0))
        cum = torch.cumsum(chunks, 0)
        take_greedy = torch.minimum(torch.clamp(cnt - (cum - chunks), min=0.0), chunks)
        fits = free >= mem
        tight = int(torch.where(fits, free, 1e30).argmin())
        # a forced pod on a node where nothing fits takes nothing
        take_tight = ((torch.arange(free.shape[0], device=free.device) == tight) & fits.any()).to(torch.float32)
        take = torch.where(cnt == 1, take_tight, take_greedy)
        take = torch.where(mem > 0, take, 0.0)
        st.gpu_free[node] += -(take * mem)
    if feat.local:
        # LVM on the tightest-fitting VG (common.go:111-116); a forced pod
        # that fits nowhere takes nothing
        lvm = ec.lvm_req[u]
        vg = st.vg_free[node]
        vg_fits = vg >= lvm
        choice = int(torch.where(vg_fits, vg, 1e30).argmin())
        hot = ((torch.arange(vg.shape[0], device=vg.device) == choice) & vg_fits.any()).to(torch.float32)
        st.vg_free[node] += -(hot * torch.clamp(lvm, min=0.0))
        # exclusive devices: one per volume, the smallest volume first onto
        # the smallest-capacity fitting free device (common.go:290-349)
        dev_free_n = st.dev_free[node].clone()
        dev_cap_n = ec.node_dev_cap[node]
        taken = torch.zeros_like(dev_free_n)
        mv = ec.dev_req_sizes.shape[2]
        for media in (0, 1):
            for i in reversed(range(mv)):  # ascending sizes; 0-pads skipped
                size = ec.dev_req_sizes[u, media, i]
                cand = (ec.node_dev_media[node] == media) & (dev_free_n >= size) & (dev_free_n > 0) & (taken == 0)
                pick = int(torch.where(cand, dev_cap_n, 1e30).argmin())
                hot = (torch.arange(dev_free_n.shape[0], device=cand.device) == pick) & cand.any() & (size > 0)
                taken = torch.maximum(taken, hot.to(torch.float32))
        st.dev_free[node] = torch.where(taken > 0, 0.0, dev_free_n)
    return take
