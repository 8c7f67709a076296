"""Explain mode: the port of ``opensim_tpu/engine/explain.py``.

Two tiers, priced differently:

- **Bulk** (``simulate(..., explain=True)``): one
  :class:`~.reasons.PlacementExplanation` per pod from what the scan
  already produced: status, node, and for an unschedulable pod the
  per-filter rejection counts. The one-scan kernel counts every step in
  explain mode (``fast_scan``'s ``[explain]`` variants), so the per-filter
  reject totals cover binding steps too (:func:`audit_rejects`).
- **Deep** (:func:`explain_pod`, behind ``simon explain <pod>``): replay
  the state to the instant before the pod's step from the recorded
  placements, then re-score the pod through the torch step
  (``kernels.pod_step`` and ``kernels.score_parts``) on the device the
  simulation ran on, for the per-plugin breakdown on the winning node and
  the margin over the runner-up. O(nodes) for one pod; no kernel outputs
  that breakdown.

The scan's ``chosen`` stays authoritative: the replayed state is the sum
of the recorded binds, and the breakdown is reported about the scan's
winner, never used to re-decide it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..encoding.state import ScanState
from ..ops import kernels
from . import reasons
from .reasons import PlacementExplanation, Reason


def rebuild_counts(prep, chosen: np.ndarray, upto: Optional[int] = None):
    """The scan state's count tables (port_used, dom_sel, dom_anti,
    dom_prefw) rebuilt on the host from the placements: the numpy mirror of
    ``kernels.bind_update``'s count updates, over the binds before stream
    index `upto` (None: every bind)."""
    ec = prep.ec_np
    st0 = prep.st0_np
    chosen = np.asarray(chosen)
    bound = chosen >= 0
    if upto is not None:
        bound = bound.copy()
        bound[upto:] = False
    us = prep.tmpl_ids[: len(bound)][bound]
    cs = chosen[bound].astype(np.int64)

    port_used = np.array(st0.port_used, dtype=np.float32, copy=True)
    ports = np.asarray(ec.ports)[us]  # [B, Hp]
    pv = ports >= 0
    if pv.any():
        rows = np.repeat(cs, ports.shape[1])[pv.ravel()]
        np.add.at(port_used, (rows, ports.ravel()[pv.ravel()]), 1.0)

    dom_sel = np.array(st0.dom_sel, dtype=np.float32, copy=True)
    matches = np.asarray(ec.matches_sel)[us].astype(np.float32)  # [B, A]
    node_domain = np.asarray(ec.node_domain)
    for tk in range(node_domain.shape[1]):
        np.add.at(dom_sel, node_domain[cs, tk], matches)

    dom_anti = np.array(st0.dom_anti, dtype=np.float32, copy=True)
    anti_g_topo = np.asarray(ec.anti_g_topo)
    anti_g = np.asarray(ec.anti_g)[us].astype(np.float32)
    for g in range(anti_g_topo.shape[0]):
        np.add.at(dom_anti[:, g], node_domain[cs, anti_g_topo[g]], anti_g[:, g])

    dom_prefw = np.array(st0.dom_prefw, dtype=np.float32, copy=True)
    prefg_topo = np.asarray(ec.prefg_topo)
    prefg_w = np.asarray(ec.prefg_w)[us]
    for g in range(prefg_topo.shape[0]):
        np.add.at(dom_prefw[:, g], node_domain[cs, prefg_topo[g]], prefg_w[:, g])

    return port_used, dom_sel, dom_anti, dom_prefw


def replay_state(prep, chosen: np.ndarray, gpu_take: np.ndarray, upto: int) -> ScanState:
    """The scan state just before stream index `upto`, rebuilt from the
    recorded placements and GPU slot packing: usage, ports and domain
    counts are sums in stream order; volume groups and devices replay the
    tightest-fit packing over the local-storage binds."""
    ec = prep.ec_np
    st0 = prep.st0_np
    chosen = np.asarray(chosen)
    bound = chosen >= 0
    bound = bound.copy()
    bound[upto:] = False
    us = prep.tmpl_ids[: len(bound)][bound]
    cs = chosen[bound].astype(np.int64)

    used = np.array(st0.used, dtype=np.float32, copy=True)
    np.add.at(used, cs, np.asarray(ec.req)[us])

    port_used, dom_sel, dom_anti, dom_prefw = rebuild_counts(prep, chosen, upto=upto)

    gpu_free = np.array(st0.gpu_free, dtype=np.float32, copy=True)
    if prep.features.gpu and len(cs):
        take = np.asarray(gpu_take)[: len(bound)][bound].astype(np.float32)  # [B, Gd]
        mem = np.asarray(ec.gpu_mem)[us].astype(np.float32)  # [B]
        np.add.at(gpu_free, cs, -(take * mem[:, None]))

    vg_free = np.array(st0.vg_free, dtype=np.float32, copy=True)
    dev_free = np.array(st0.dev_free, dtype=np.float32, copy=True)
    if prep.features.local:
        big = np.float32(1e30)
        lvm_req = np.asarray(ec.lvm_req)
        dev_req_sizes = np.asarray(ec.dev_req_sizes)
        node_dev_media = np.asarray(ec.node_dev_media)
        node_dev_cap = np.asarray(ec.node_dev_cap)
        mv = dev_req_sizes.shape[2]
        for j in np.nonzero(bound)[0]:
            u = int(prep.tmpl_ids[j])
            node = int(chosen[j])
            lvm = float(lvm_req[u])
            vf = vg_free[node]
            fits = vf >= lvm
            if fits.any():
                vf[np.argmin(np.where(fits, vf, big))] -= max(lvm, 0.0)
            df = dev_free[node]
            taken = np.zeros_like(df, dtype=bool)
            for media in (0, 1):
                for k in reversed(range(mv)):  # ascending sizes; 0-pads skipped
                    size = float(dev_req_sizes[u, media, k])
                    if size <= 0.0:
                        continue
                    cand = (node_dev_media[node] == media) & (df >= size) & (df > 0) & ~taken
                    if cand.any():
                        taken[np.argmin(np.where(cand, node_dev_cap[node], big))] = True
            df[taken] = 0.0

    return ScanState(used=used, port_used=port_used, dom_sel=dom_sel, dom_anti=dom_anti, dom_prefw=dom_prefw,
                     gpu_free=gpu_free, vg_free=vg_free, dev_free=dev_free)


@dataclass
class ExplainContext:
    """What a deep explanation needs, captured by
    ``simulate(..., explain=True)`` (``SimulateResult.explain_ctx``). It
    holds the whole Prepared, for library and CLI callers."""

    prep: object
    chosen: np.ndarray
    gpu_take: np.ndarray
    static_fail: np.ndarray  # [P, 4] per pod (each pod's row under its segment's config)
    sf_rows: np.ndarray  # pod index -> static_fail row
    fail_counts: np.ndarray  # [P, NUM_FILTERS - F_PORTS]
    insufficient: np.ndarray  # [P, R]
    n_nodes: int
    node_names: Sequence[str]
    resource_names: Sequence[str]
    config: object = None
    segments: Optional[list] = None  # [(config_or_None, lo, hi)]
    extra_plugins: tuple = ()
    # the node mask of a masked run: the deep audit scores the nodes the
    # scan considered
    node_valid: Optional[np.ndarray] = None

    def config_for(self, i: int):
        if self.segments:
            for cfg, lo, hi in self.segments:
                if lo <= i < hi:
                    return cfg
        return self.config

    def index_of(self, pod_name: str) -> Optional[int]:
        """Stream index of ``ns/name`` or bare ``name``. A query that
        matches no pod exactly falls back to the workload: the first pod
        whose name is the query plus generated uid segments
        (``web-00a3…-00a4…``); a bare name two pods share raises."""
        hit = None
        for i, p in enumerate(self.prep.ordered):
            full = f"{p.metadata.namespace}/{p.metadata.name}"
            if full == pod_name or p.metadata.name == pod_name:
                if hit is not None and p.metadata.name == pod_name:
                    raise ValueError(f"pod name {pod_name!r} is ambiguous; use namespace/name")
                hit = i
                if full == pod_name:
                    return i
        if hit is not None:
            return hit
        import re

        bare = pod_name.rsplit("/", 1)[-1]
        ns = pod_name.rsplit("/", 1)[0] if "/" in pod_name else None
        # exactly <bare> plus generated uid segments: "web" matches
        # "web-00a3…-00a4…" but not another workload "web-frontend-…"
        gen = re.compile(re.escape(bare) + r"(-[0-9a-f]{10})+$")
        matches = [i for i, p in enumerate(self.prep.ordered)
                   if gen.fullmatch(p.metadata.name) and (ns is None or p.metadata.namespace == ns)]
        return matches[0] if matches else None

    def reason_counts(self, i: int) -> List[reasons.ReasonCount]:
        return reasons.counts_from_rows(np.asarray(self.static_fail)[int(self.sf_rows[i])], self.fail_counts[i],
                                        self.insufficient[i], self.resource_names)


def audit_rejects(static_fail, sf_rows, fail_counts, mask) -> np.ndarray:
    """The 11-slot per-filter reject totals (filter-index order) over the
    pods `mask` selects (valid, not forced), from their count rows."""
    rej = np.zeros(kernels.NUM_FILTERS, np.int64)
    mask = np.asarray(mask, dtype=bool)
    if mask.any():
        static_rows = np.asarray(static_fail)[np.asarray(sf_rows)[mask]]
        rej[: kernels.F_PORTS] = static_rows.sum(axis=0, dtype=np.int64)
        rej[kernels.F_PORTS:] = np.asarray(fail_counts)[mask].sum(axis=0, dtype=np.int64)
    return rej


def primary_reason_histogram(static_fail, sf_rows, fail_counts, failed_idx) -> Dict[str, int]:
    """``{reason_name: pod count}`` over the unschedulable pods, each under
    its dominant filter (the most rejected nodes, ties to the lowest
    filter index); pods with no count are ``unattributed``."""
    out: Dict[str, int] = {}
    failed_idx = np.asarray(failed_idx)
    if not len(failed_idx):
        return out
    merged = np.concatenate([np.asarray(static_fail)[np.asarray(sf_rows)[failed_idx]],
                             np.asarray(fail_counts)[failed_idx]], axis=1)
    primary = np.argmax(merged, axis=1)
    has_any = merged.max(axis=1) > 0
    for k in primary[has_any]:
        name = Reason(int(k)).name.lower()
        out[name] = out.get(name, 0) + 1
    n_unattr = int((~has_any).sum())
    if n_unattr:
        out["unattributed"] = n_unattr
    return out


def rescore(ctx: ExplainContext, i: int) -> Tuple[kernels.StepResult, Dict[str, torch.Tensor]]:
    """Stream index `i`'s step again, through the torch ``pod_step`` and
    ``score_parts`` on the simulation's device, from the replayed state
    before it, over the nodes the scan considered (the static tables from
    ``precompute_static_np`` under the pod's config, masked as
    ``fastpath.build_inputs`` masks them). Returns the step's result and
    each plugin's weighted score."""
    prep = ctx.prep
    u = int(prep.tmpl_ids[i])
    cfg = ctx.config_for(i)
    dev = prep.device
    st = ScanState(*(torch.from_numpy(a).to(dev) for a in replay_state(prep, ctx.chosen, ctx.gpu_take, upto=i)))
    ec = prep.ec
    if ctx.node_valid is not None:
        ec = ec._replace(node_valid=torch.from_numpy(np.ascontiguousarray(ctx.node_valid, dtype=bool)).to(dev))
    stat = kernels.static_tables(ec, cfg)
    res = kernels.pod_step(ec, stat, st, u, prep.features, cfg, ctx.extra_plugins)
    return res, kernels.score_parts(ec, stat, st, u, res.feasible, prep.features, cfg, ctx.extra_plugins)


def explain_pod(ctx: ExplainContext, i: int) -> PlacementExplanation:
    """The deep audit of stream index `i`: the bulk record, and for a
    scheduled pod the per-plugin score breakdown on its node and the
    margin over the runner-up (:func:`rescore`)."""
    prep = ctx.prep
    pod = prep.ordered[i]
    name = f"{pod.metadata.namespace}/{pod.metadata.name}"
    c = int(ctx.chosen[i])
    if bool(prep.forced[i]):
        if c < 0:
            return PlacementExplanation(pod=name, status="unschedulable", nodes_total=ctx.n_nodes, forced=True,
                                        message=reasons.node_not_found(pod.spec.node_name))
        return PlacementExplanation(pod=name, status="scheduled", nodes_total=ctx.n_nodes,
                                    node=str(ctx.node_names[c]), forced=True,
                                    message="pre-bound (spec.nodeName set); bypassed the scheduler")
    if c < 0:
        counts = ctx.reason_counts(i)
        return PlacementExplanation(pod=name, status="unschedulable", nodes_total=ctx.n_nodes, reasons=counts,
                                    message=reasons.render_unschedulable(ctx.n_nodes, counts))
    res, parts = rescore(ctx, i)
    score = res.score.cpu().numpy()
    feasible = res.feasible.cpu().numpy()
    scores = {k: round(float(v[c]), 4) for k, v in parts.items()}
    total = round(float(score[c]), 4)
    runner_up = margin = None
    others = feasible.copy()
    others[c] = False
    if others.any():
        ru = int(np.argmax(np.where(others, score, -np.inf)))
        runner_up = str(ctx.node_names[ru])
        margin = round(float(score[c] - score[ru]), 4)
    return PlacementExplanation(
        pod=name, status="scheduled", nodes_total=ctx.n_nodes, node=str(ctx.node_names[c]), scores=scores,
        score=total, runner_up=runner_up, margin=margin,
        message=f"scheduled on {ctx.node_names[c]} (score {total}"
        + (f", margin {margin} over {runner_up}" if runner_up is not None else "") + ")",
    )


def build_explanations(ctx: ExplainContext, custom_reasons: Dict[int, str], victims_of: Dict[int, int],
                       drops=()) -> List[PlacementExplanation]:
    """The bulk tier: a record per pod of the stream but the dropped ones,
    from what the scan produced; no per-node work."""
    out: List[PlacementExplanation] = []
    ordered = ctx.prep.ordered
    forced = ctx.prep.forced
    for i, pod in enumerate(ordered):
        if i in drops:
            continue
        name = f"{pod.metadata.namespace}/{pod.metadata.name}"
        c = int(ctx.chosen[i])
        if forced[i] and c < 0:
            out.append(PlacementExplanation(pod=name, status="unschedulable", nodes_total=ctx.n_nodes, forced=True,
                                            message=reasons.node_not_found(pod.spec.node_name)))
        elif c >= 0:
            out.append(PlacementExplanation(pod=name, status="scheduled", nodes_total=ctx.n_nodes,
                                            node=str(ctx.node_names[c]), forced=bool(forced[i])))
        elif i in custom_reasons:
            out.append(PlacementExplanation(pod=name, status="unschedulable", nodes_total=ctx.n_nodes,
                                            message=custom_reasons[i]))
        elif i in victims_of:
            p = ordered[victims_of[i]]
            out.append(PlacementExplanation(pod=name, status="preempted", nodes_total=ctx.n_nodes,
                                            message=reasons.preempted(p.metadata.namespace, p.metadata.name)))
        else:
            counts = ctx.reason_counts(i)
            out.append(PlacementExplanation(pod=name, status="unschedulable", nodes_total=ctx.n_nodes,
                                            reasons=counts, message=reasons.render_unschedulable(ctx.n_nodes, counts)))
    return out
