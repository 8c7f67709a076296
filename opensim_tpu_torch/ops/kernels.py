"""Static tables, feature flags and scheduler-config launch arguments of
the bind scan.

The per-(template, node) quantities that never change during a scan —
static filter masks, spread eligibility, raw share scores, spread weights —
computed once on the host in numpy, exactly as the JAX package's
``precompute_static_np`` computes them (bitwise equal; the tests assert
it), the static filters switched by the scheduler config as there. The
config's score weights, dynamic-filter switches and fit-ignored resource
columns go to the kernel as launch arguments (:func:`kernel_config`). The
usage-dependent part of a scheduling step is the bind-scan kernel in
``ops/fast_scan.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..encoding import vocab as V
from ..encoding.state import EncodedCluster
from ..engine.schedconfig import DEFAULT_CONFIG, SchedulerConfig

MAX_NODE_SCORE = 100.0

# Filter ids, in the order a node's rejection is attributed (the first
# filter it fails; engine/reasons.Reason carries the same values). The four
# static ones are counted per template (StaticTables.static_fail); the bind
# scan counts the dynamic ones, F_PORTS..F_EXTRA, on a pod that finds no
# node (fast_scan.FastOutputs.fail_counts).
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
F_EXTRA = 10  # out-of-tree plugins; the port registers none, so its count stays 0
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
