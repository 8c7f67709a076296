"""ClusterState tensor assembly.

Builds the encoded cluster: node resource/label/taint tensors,
per-template scheduling encodings, global inter-pod-affinity term tables,
and the initial scan carry. This replaces the reference's scheduler cache +
snapshot (``vendor/k8s.io/kubernetes/pkg/scheduler/internal/cache``):
instead of an object graph snapshotted per cycle, the cluster IS a set of
tensors and the "snapshot" is the bind scan's carry. ``ClusterEncoder``
builds numpy arrays; :func:`to_device` moves them to torch.

Shape conventions (all static, padded):
  N  nodes (padded, ``node_valid`` masks)     R  resource axis
  K  label keys        Tt taints/node         Tl tolerations/template
  U  templates         T/Q/V node-affinity terms/reqs/values per template
  A  selectors         G  global anti-affinity terms
  Gp global preferred/symmetric-score terms   Tk topology keys
  D  topology domains (+1 trash row for masked scatters)
  Hp host-ports/template                      Cs spread constraints/template
  Ti/Tn required pod-affinity/anti terms      Pp preferred node-affinity terms
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.objects import Node, Pod
from . import vocab as V
from .dtypes import ARENA_CONTRACTS, STATE_CONTRACTS, log_size_table
from .templates import SchedTemplate, TemplateSet

_NAN = float("nan")


class EncodedCluster(NamedTuple):
    """Static (read-only during a scan) cluster tensors."""

    # nodes
    node_valid: np.ndarray  # [N] bool
    alloc: np.ndarray  # [N, R] f32
    unschedulable: np.ndarray  # [N] bool
    taint_key: np.ndarray  # [N, Tt] i32 (-1 pad)
    taint_val: np.ndarray  # [N, Tt] i32
    taint_effect: np.ndarray  # [N, Tt] i32 (-1 pad)
    label_val: np.ndarray  # [N, K] i32 (-1 absent)
    label_num: np.ndarray  # [N, K] f32 (NaN when not numeric)
    node_domain: np.ndarray  # [N, Tk] i32 (D = trash row when label absent)
    domain_topo: np.ndarray  # [D+1] i32 topo-key index owning each domain (-1 trash)
    # templates
    req: np.ndarray  # [U, R] f32
    tol_valid: np.ndarray  # [U, Tl] bool
    tol_key: np.ndarray  # [U, Tl] i32 (-1 = empty key → all)
    tol_op: np.ndarray  # [U, Tl] i32 (TOL_EQUAL/TOL_EXISTS)
    tol_val: np.ndarray  # [U, Tl] i32
    tol_effect: np.ndarray  # [U, Tl] i32 (-1 = all effects)
    ns_key: np.ndarray  # [U, Qs] i32 (-1 pad) nodeSelector map
    ns_val: np.ndarray  # [U, Qs] i32
    has_req_aff: np.ndarray  # [U] bool
    aff_term_valid: np.ndarray  # [U, T] bool
    aff_key: np.ndarray  # [U, T, Q] i32
    aff_op: np.ndarray  # [U, T, Q] i32 (OP_PAD → vacuously true)
    aff_val: np.ndarray  # [U, T, Q, Vv] i32 (-1 pad)
    aff_num: np.ndarray  # [U, T, Q] f32
    pna_weight: np.ndarray  # [U, Pp] f32 (0 pad) preferred node affinity
    pna_key: np.ndarray  # [U, Pp, Q] i32
    pna_op: np.ndarray  # [U, Pp, Q] i32
    pna_val: np.ndarray  # [U, Pp, Q, Vv] i32
    pna_num: np.ndarray  # [U, Pp, Q] f32
    ports: np.ndarray  # [U, Hp] i32 (-1 pad)
    port_conflict: np.ndarray  # [Hports, Hports] bool — wildcard-aware overlap
    spr_topo: np.ndarray  # [U, Cs] i32 topo-key index (-1 pad)
    spr_sel: np.ndarray  # [U, Cs] i32 selector id
    spr_skew: np.ndarray  # [U, Cs] i32
    spr_hard: np.ndarray  # [U, Cs] bool
    at_sel: np.ndarray  # [U, Ti] i32 (-1 pad) required pod affinity
    at_topo: np.ndarray  # [U, Ti] i32 topo-key index
    an_sel: np.ndarray  # [U, Tn] i32 required anti-affinity
    an_topo: np.ndarray  # [U, Tn] i32
    pt_sel: np.ndarray  # [U, Tpp] i32 preferred pod terms (incoming side)
    pt_topo: np.ndarray  # [U, Tpp] i32
    pt_w: np.ndarray  # [U, Tpp] f32 signed
    matches_sel: np.ndarray  # [U, A] bool
    anti_g: np.ndarray  # [U, G] bool — template carries global anti term g
    prefg_w: np.ndarray  # [U, Gp] f32 — signed weights of symmetric terms carried
    pin: np.ndarray  # [U] i32 node index; -1 none; -2 unknown node
    # global term tables
    anti_g_sel: np.ndarray  # [G] i32
    anti_g_topo: np.ndarray  # [G] i32 topo-key index
    prefg_sel: np.ndarray  # [Gp] i32
    prefg_topo: np.ndarray  # [Gp] i32
    # gpu-share extension (zeros when unused)
    gpu_mem: np.ndarray  # [U] f32 per-GPU memory request
    gpu_count: np.ndarray  # [U] i32
    node_gpu_mem: np.ndarray  # [N, Gd] f32 per-device total memory
    # one-hot over the resource axis marking alibabacloud.com/gpu-count. The
    # reference rewrites that allocatable at gpushare Reserve to the count of
    # not-fully-used devices (open-gpu-share.go:147-188, gpunodeinfo.go:354-369),
    # so its alloc column is DYNAMIC on device-bearing nodes — kernels derive
    # it from gpu_free instead of this table when Features.gc_dyn is set.
    gc_mask: np.ndarray  # [R] bool
    # open-local extension
    avoid_score: np.ndarray  # [U, N] f32 NodePreferAvoidPods raw score (0 or 100)
    lvm_req: np.ndarray  # [U] f32 total LVM bytes requested
    dev_req: np.ndarray  # [U, 2] f32 max exclusive-device bytes by media (score proxy)
    dev_req_count: np.ndarray  # [U, 2] i32 number of exclusive devices by media
    dev_req_sizes: np.ndarray  # [U, 2, Mv] f32 per-volume sizes, sorted descending
    node_vg_cap: np.ndarray  # [N, Vg] f32 volume-group capacities
    node_dev_cap: np.ndarray  # [N, Dv] f32 device capacities
    node_dev_media: np.ndarray  # [N, Dv] i32 0=ssd 1=hdd (-1 pad)
    # log(k+2) lookup over possible per-key domain counts (k = 0..N): the
    # topology-spread normalizing weight is a GATHER from this table in
    # every engine, so the kernel, its plain version and the static tables
    # read bitwise-identical weights — an f32 log and numpy's differ by
    # 1 ulp on ~3% of inputs, enough to flip score ties.
    log_sizes: np.ndarray  # [N+1] f32


class ScanState(NamedTuple):
    """Mutable carry threaded through the bind scan."""

    used: np.ndarray  # [N, R] f32
    port_used: np.ndarray  # [N, Hports] f32
    dom_sel: np.ndarray  # [D+1, A] f32
    dom_anti: np.ndarray  # [D+1, G] f32
    dom_prefw: np.ndarray  # [D+1, Gp] f32
    gpu_free: np.ndarray  # [N, Gd] f32
    vg_free: np.ndarray  # [N, Vg] f32
    dev_free: np.ndarray  # [N, Dv] f32 (0 when device is taken or absent)


@dataclass
class ClusterMeta:
    """Host-side decode tables for reports."""

    node_names: List[str] = field(default_factory=list)
    n_real_nodes: int = 0
    vocab: Optional[V.Vocab] = None
    template_set: Optional[TemplateSet] = None
    resource_names: List[str] = field(default_factory=list)
    n_domains: int = 0
    node_gpu_count: Optional[np.ndarray] = None  # [N] i32
    node_vg_names: List[List[str]] = field(default_factory=list)
    node_dev_names: List[List[str]] = field(default_factory=list)
    # original capacities (host copies) for usage reports
    node_gpu_mem: Optional[np.ndarray] = None  # [N, Gd] f32
    node_vg_cap: Optional[np.ndarray] = None  # [N, Vg] f32
    node_dev_cap: Optional[np.ndarray] = None  # [N, Dv] f32
    node_dev_media: Optional[np.ndarray] = None  # [N, Dv] i32


def _pad_to(n: int, mult: int) -> int:
    return max(mult, mult * math.ceil(n / mult))


def _grown(a: np.ndarray, shape: Tuple[int, ...], fill: object) -> np.ndarray:
    """Re-allocate `a` at `shape`, copying the existing prefix block and
    filling the rest with `fill` (axis growth for delta re-encoding)."""
    out = np.full(shape, fill, dtype=a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


@dataclass
class NodeArenas:
    """The O(N) node-axis build products, cached across builds.

    This is the expensive half of ``ClusterEncoder.build()`` at cluster
    scale (the per-node python loop over labels/taints/resources/domains).
    The incremental-prepare layer reuses these arenas across repeated
    builds so a delta build pays O(changes), not O(cluster). Arrays are
    immutable once built — ``extend`` paths re-allocate instead of
    mutating — so forked encoders share them by reference."""

    N: int
    K: int  # label-key axis width the arrays were built at
    R: int  # resource axis width the arrays were built at
    Tt: int
    node_valid: np.ndarray
    alloc: np.ndarray
    unschedulable: np.ndarray
    taint_key: np.ndarray
    taint_val: np.ndarray
    taint_effect: np.ndarray
    label_val: np.ndarray
    label_num: np.ndarray
    domain_ids: Dict[Tuple[int, int], int]  # (topo key idx, label vid) -> domain id
    node_domain: np.ndarray  # [N, n_topo] raw domain ids, -1 = absent (pre-trash)
    n_topo: int  # real topo-key count covered by node_domain columns
    node_gpu_mem: np.ndarray
    node_gpu_count: np.ndarray
    node_vg_cap: np.ndarray
    node_dev_cap: np.ndarray
    node_dev_media: np.ndarray
    vg_names: List[List[str]]
    dev_names: List[List[str]]
    avoid_entries: List[Tuple[int, frozenset]]  # (node idx, {(kind, uid)})

    def clone(self) -> "NodeArenas":
        import copy as _copy

        new = _copy.copy(self)
        # the only pieces mutated in place by domain-column extension
        new.domain_ids = dict(self.domain_ids)
        return new


def encode_labels(vocab: V.Vocab, labels: Dict[str, str], extra: Dict[str, str]) -> Dict[int, Tuple[int, float]]:
    out: Dict[int, Tuple[int, float]] = {}
    for k, v in {**labels, **extra}.items():
        kid = vocab.key_id(k)
        vid = vocab.val_id(str(v))
        try:
            num = float(int(str(v)))
        except ValueError:
            num = _NAN
        out[kid] = (vid, num)
    return out


class ClusterEncoder:
    """Accumulates nodes + pods, then materializes the tensors.

    Usage:
        enc = ClusterEncoder()
        enc.add_nodes(nodes)
        tmpl_ids = [enc.add_pod(p, owner_selector) for p in pods]
        cluster, state0, meta = enc.build()
    """

    def __init__(self, node_pad: int = 8) -> None:
        self.vocab = V.Vocab()
        self.ts = TemplateSet()
        self.nodes: List[Node] = []
        self.node_index: Dict[str, int] = {}
        self.node_pad = node_pad
        # encoded labels per node, built once at add_nodes and reused by
        # build() — encode_labels is 2×5k calls at headline shape otherwise
        self._node_enc: List[Dict[int, Tuple[int, float]]] = []
        # cached node-axis build (incremental prepare: rebuilds skip the
        # O(N) node loop) and the count of templates already interned
        self._arenas: Optional[NodeArenas] = None
        self._n_interned = 0

    def fork(self) -> "ClusterEncoder":
        """Copy-on-write fork for delta re-encoding: vocab and template
        tables are copied (they are append-only, so the base stays valid),
        built node arenas are shared by reference."""
        new = object.__new__(ClusterEncoder)
        new.vocab = self.vocab.clone()
        new.ts = self.ts.clone()
        new.nodes = list(self.nodes)
        new.node_index = dict(self.node_index)
        new.node_pad = self.node_pad
        new._node_enc = list(self._node_enc)
        new._arenas = self._arenas.clone() if self._arenas is not None else None
        new._n_interned = self._n_interned
        return new

    # -- ingestion ----------------------------------------------------------

    def add_nodes(self, nodes: List[Node]) -> None:
        for n in nodes:
            if n.metadata.name in self.node_index:
                continue
            self.node_index[n.metadata.name] = len(self.nodes)
            self.nodes.append(n)
            # Pre-intern label/taint strings so vocab is complete.
            self._node_enc.append(
                encode_labels(self.vocab, n.metadata.labels, {"metadata.name": n.metadata.name})
            )
            for t in n.taints:
                self.vocab.key_id(t.key)
                self.vocab.val_id(t.value)
            for r in n.allocatable:
                self.vocab.resource_id(r)

    def add_pod(self, pod: Pod, owner_selector: Optional[dict] = None, hint: Optional[tuple] = None) -> int:
        return self.ts.add_pod(pod, owner_selector, hint=hint)

    # -- template feature interning (strings → ids) -------------------------

    def _intern_template(self, t: SchedTemplate) -> None:
        vb = self.vocab
        for r in t.requests:
            vb.resource_id(r)
        for k, v in t.node_selector.items():
            vb.key_id(k)
            vb.val_id(str(v))
        for key, _op, val, _eff in t.tolerations:
            if key:
                vb.key_id(key)
            vb.val_id(val)
        for term in t.affinity_terms:
            for e in (term.get("matchExpressions") or []) + (term.get("matchFields") or []):
                vb.key_id(str(e.get("key", "")) if e.get("key") != "metadata.name" else "metadata.name")
                for v in e.get("values") or []:
                    vb.val_id(str(v))
        for pref in t.pref_node_affinity:
            for e in ((pref.get("preference") or {}).get("matchExpressions") or []) + (
                (pref.get("preference") or {}).get("matchFields") or []
            ):
                vb.key_id(str(e.get("key", "")))
                for v in e.get("values") or []:
                    vb.val_id(str(v))
        for proto, port, ip in t.host_ports:
            vb.port_id(proto, port, ip)
        for c in t.spread:
            vb.topo_key_id(c.topo_key)
        for term in t.aff_terms + t.anti_terms:
            vb.topo_key_id(term.topo_key)
        for term in t.pref_terms:
            vb.topo_key_id(term.topo_key)

    # -- node-affinity term encoding helper ---------------------------------

    def _encode_terms(
        self, terms: List[dict], T: int, Q: int, Vv: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        vb = self.vocab
        valid = np.zeros((T,), dtype=bool)
        key = np.full((T, Q), -1, dtype=np.int32)
        op = np.full((T, Q), V.OP_PAD, dtype=np.int32)
        val = np.full((T, Q, Vv), -1, dtype=np.int32)
        num = np.full((T, Q), _NAN, dtype=np.float32)
        for ti, term in enumerate(terms[:T]):
            reqs = list(term.get("matchExpressions") or [])
            for f in term.get("matchFields") or []:
                f = dict(f)
                f["key"] = "metadata.name"
                reqs.append(f)
            valid[ti] = True
            for qi, e in enumerate(reqs[:Q]):
                key[ti, qi] = vb.label_keys.get(str(e.get("key", "metadata.name") if e.get("key") else ""), -1)
                if key[ti, qi] < 0:
                    key[ti, qi] = vb.key_id(str(e.get("key", "")))
                op[ti, qi] = V.NODE_OP_CODES.get(str(e.get("operator", "")), V.OP_PAD)
                vals = [str(x) for x in (e.get("values") or [])]
                for vi, x in enumerate(vals[:Vv]):
                    val[ti, qi, vi] = vb.val_id(x)
                if op[ti, qi] in (V.OP_GT, V.OP_LT) and vals:
                    try:
                        num[ti, qi] = float(int(vals[0]))
                    except ValueError:
                        num[ti, qi] = _NAN
        return valid, key, op, val, num

    # -- build --------------------------------------------------------------

    def build(self) -> Tuple[EncodedCluster, ScanState, ClusterMeta]:
        """Materialize the tensors. Repeat builds on the same encoder (the
        incremental-prepare layer: a fork with extra pods or nodes) reuse
        the cached node arenas, so a rebuild pays O(templates + changes)
        instead of re-running the O(N) node loop."""
        for t in self.ts.templates[self._n_interned :]:
            self._intern_template(t)
        self._n_interned = len(self.ts.templates)
        templates = self.ts.templates or [SchedTemplate()]
        if self._arenas is None:
            self._arenas = self._build_node_arenas()
        self._extend_domain_columns(self._arenas)
        return self._assemble(self._arenas, templates)

    def _build_node_arenas(self) -> NodeArenas:
        """The O(N) half: per-node resource/taint/label tensors, topology
        domains, extension capacities, preferAvoidPods annotations."""
        vb = self.vocab
        N = _pad_to(len(self.nodes), self.node_pad)
        R = vb.n_resources
        K = max(vb.n_label_keys, 1)
        Tt = max([len(n.taints) for n in self.nodes] + [1])

        arrays = {
            "node_valid": np.zeros((N,), dtype=bool),
            "alloc": np.zeros((N, R), dtype=np.float32),
            "unschedulable": np.zeros((N,), dtype=bool),
            "taint_key": np.full((N, Tt), -1, dtype=np.int32),
            "taint_val": np.full((N, Tt), -1, dtype=np.int32),
            "taint_effect": np.full((N, Tt), -1, dtype=np.int32),
            "label_val": np.full((N, K), -1, dtype=np.int32),
            "label_num": np.full((N, K), _NAN, dtype=np.float32),
        }
        self._encode_node_rows(arrays, 0, K, Tt)

        # topology domains, raw ids (-1 = label absent); the trash-row
        # substitution happens at assemble time once D is final
        n_topo = vb.n_topo_keys
        domain_ids: Dict[Tuple[int, int], int] = {}
        node_domain = np.full((N, n_topo), -1, dtype=np.int32)
        label_val = arrays["label_val"]
        topo_key_to_label = [vb.label_keys.get(k) for k in vb.topo_keys.items()]
        for i in range(len(self.nodes)):
            for tki in range(n_topo):
                lk = topo_key_to_label[tki]
                vid = label_val[i, lk] if lk >= 0 else -1
                if vid >= 0:
                    node_domain[i, tki] = domain_ids.setdefault(
                        (tki, int(vid)), len(domain_ids)
                    )

        from .extensions import encode_gpu_nodes, encode_local_storage

        node_gpu_mem, node_gpu_count = encode_gpu_nodes(self.nodes, N)
        node_vg_cap, node_dev_cap, node_dev_media, vg_names, dev_names = (
            encode_local_storage(self.nodes, N)
        )

        avoid_entries: List[Tuple[int, frozenset]] = []
        for i, n in enumerate(self.nodes):
            avoided = self._node_avoid_set(n)
            if avoided:
                avoid_entries.append((i, avoided))

        return NodeArenas(
            N=N, K=K, R=R, Tt=Tt,
            node_valid=arrays["node_valid"], alloc=arrays["alloc"],
            unschedulable=arrays["unschedulable"],
            taint_key=arrays["taint_key"], taint_val=arrays["taint_val"],
            taint_effect=arrays["taint_effect"],
            label_val=arrays["label_val"], label_num=arrays["label_num"],
            domain_ids=domain_ids, node_domain=node_domain, n_topo=n_topo,
            node_gpu_mem=node_gpu_mem, node_gpu_count=node_gpu_count,
            node_vg_cap=node_vg_cap, node_dev_cap=node_dev_cap,
            node_dev_media=node_dev_media, vg_names=vg_names,
            dev_names=dev_names, avoid_entries=avoid_entries,
        )

    def _encode_node_rows(self, arrays: dict, start: int, K: int, Tt: int) -> None:
        vb = self.vocab
        for i in range(start, len(self.nodes)):
            n = self.nodes[i]
            arrays["node_valid"][i] = True
            arrays["unschedulable"][i] = n.unschedulable
            for rname, v in n.allocatable.items():
                rid = vb.resource_id(rname)
                if rid >= 0:
                    arrays["alloc"][i, rid] = v * 1000.0 if rname == "cpu" else v
            for j, t in enumerate(n.taints[:Tt]):
                arrays["taint_key"][i, j] = vb.key_id(t.key)
                arrays["taint_val"][i, j] = vb.val_id(t.value)
                arrays["taint_effect"][i, j] = V.EFFECT_CODES.get(t.effect, -1)
            for kid, (vid, num) in self._node_enc[i].items():
                if kid < K:
                    arrays["label_val"][i, kid] = vid
                    arrays["label_num"][i, kid] = num

    @staticmethod
    def _node_avoid_set(n: Node) -> Optional[frozenset]:
        """NodePreferAvoidPods (node_prefer_avoid_pods.go:47-82): the set of
        (controller kind, uid) the node's preferAvoidPods annotation names."""
        anno = n.metadata.annotations.get("scheduler.alpha.kubernetes.io/preferAvoidPods")
        if not anno:
            return None
        try:
            entries = json.loads(anno).get("preferAvoidPods") or []
        except (ValueError, AttributeError):
            return None
        return frozenset(
            (
                str(((e.get("podSignature") or {}).get("podController") or {}).get("kind", "")),
                str(((e.get("podSignature") or {}).get("podController") or {}).get("uid", "")),
            )
            for e in entries
        )

    def _extend_domain_columns(self, ar: NodeArenas) -> None:
        """Add node_domain columns for topo keys interned since the arenas
        were built (a delta pod batch spreading on a new topology key):
        O(N) per new key instead of an O(N·Tk) domain rebuild."""
        vb = self.vocab
        n_now = vb.n_topo_keys
        if n_now <= ar.n_topo:
            return
        topo_keys = vb.topo_keys.items()
        cols = np.full((ar.N, n_now - ar.n_topo), -1, dtype=np.int32)
        label_val = ar.label_val
        for c, tki in enumerate(range(ar.n_topo, n_now)):
            lk = vb.label_keys.get(topo_keys[tki])
            if lk < 0 or lk >= ar.K:
                continue  # key unknown to every node: whole column absent
            for i in range(len(self.nodes)):
                vid = label_val[i, lk]
                if vid >= 0:
                    cols[i, c] = ar.domain_ids.setdefault(
                        (tki, int(vid)), len(ar.domain_ids)
                    )
        ar.node_domain = np.concatenate([ar.node_domain, cols], axis=1)
        ar.n_topo = n_now

    def extend_nodes(self, new_nodes: List[Node]) -> None:
        """Delta re-encode for node addition: append nodes to a BUILT
        encoder by re-allocating the node arenas and encoding only the new
        rows — O(new nodes) host work plus O(N) memcpy, instead of the full
        O(N) python node build."""
        if self._arenas is None:
            raise ValueError("extend_nodes needs a built encoder (call build() first)")
        ar = self._arenas
        n0 = len(self.nodes)
        self.add_nodes(new_nodes)  # interns labels/taints/resources + _node_enc
        added = self.nodes[n0:]
        if not added:
            return
        vb = self.vocab
        n1 = len(self.nodes)
        N2 = max(_pad_to(n1, self.node_pad), ar.N)
        K2 = max(vb.n_label_keys, ar.K)
        R2 = max(vb.n_resources, ar.R)
        Tt2 = max([len(n.taints) for n in added] + [ar.Tt])

        arrays = {
            "node_valid": _grown(ar.node_valid, (N2,), False),
            "alloc": _grown(ar.alloc, (N2, R2), 0.0),
            "unschedulable": _grown(ar.unschedulable, (N2,), False),
            "taint_key": _grown(ar.taint_key, (N2, Tt2), -1),
            "taint_val": _grown(ar.taint_val, (N2, Tt2), -1),
            "taint_effect": _grown(ar.taint_effect, (N2, Tt2), -1),
            "label_val": _grown(ar.label_val, (N2, K2), -1),
            "label_num": _grown(ar.label_num, (N2, K2), _NAN),
        }
        self._encode_node_rows(arrays, n0, K2, Tt2)

        domain_ids = dict(ar.domain_ids)
        node_domain = _grown(ar.node_domain, (N2, ar.n_topo), -1)
        label_val = arrays["label_val"]
        topo_key_to_label = [
            vb.label_keys.get(k) for k in vb.topo_keys.items()[: ar.n_topo]
        ]
        for i in range(n0, n1):
            for tki in range(ar.n_topo):
                lk = topo_key_to_label[tki]
                vid = label_val[i, lk] if lk >= 0 else -1
                if vid >= 0:
                    node_domain[i, tki] = domain_ids.setdefault(
                        (tki, int(vid)), len(domain_ids)
                    )

        from .extensions import encode_gpu_nodes, encode_local_storage

        gm_new, gc_new = encode_gpu_nodes(added, len(added))
        vg_new, dev_new, media_new, vgn_new, devn_new = encode_local_storage(
            added, len(added)
        )
        Gd2 = max(ar.node_gpu_mem.shape[1], gm_new.shape[1])
        Vg2 = max(ar.node_vg_cap.shape[1], vg_new.shape[1])
        Dv2 = max(ar.node_dev_cap.shape[1], dev_new.shape[1])
        node_gpu_mem = _grown(ar.node_gpu_mem, (N2, Gd2), 0.0)
        node_gpu_mem[n0:n1, : gm_new.shape[1]] = gm_new
        node_gpu_count = _grown(ar.node_gpu_count, (N2,), 0)
        node_gpu_count[n0:n1] = gc_new
        node_vg_cap = _grown(ar.node_vg_cap, (N2, Vg2), 0.0)
        node_vg_cap[n0:n1, : vg_new.shape[1]] = vg_new
        node_dev_cap = _grown(ar.node_dev_cap, (N2, Dv2), 0.0)
        node_dev_cap[n0:n1, : dev_new.shape[1]] = dev_new
        node_dev_media = _grown(ar.node_dev_media, (N2, Dv2), -1)
        node_dev_media[n0:n1, : media_new.shape[1]] = media_new

        avoid_entries = list(ar.avoid_entries)
        for k, n in enumerate(added):
            avoided = self._node_avoid_set(n)
            if avoided:
                avoid_entries.append((n0 + k, avoided))

        self._arenas = NodeArenas(
            N=N2, K=K2, R=R2, Tt=Tt2,
            node_valid=arrays["node_valid"], alloc=arrays["alloc"],
            unschedulable=arrays["unschedulable"],
            taint_key=arrays["taint_key"], taint_val=arrays["taint_val"],
            taint_effect=arrays["taint_effect"],
            label_val=arrays["label_val"], label_num=arrays["label_num"],
            domain_ids=domain_ids, node_domain=node_domain, n_topo=ar.n_topo,
            node_gpu_mem=node_gpu_mem, node_gpu_count=node_gpu_count,
            node_vg_cap=node_vg_cap, node_dev_cap=node_dev_cap,
            node_dev_media=node_dev_media,
            vg_names=ar.vg_names + vgn_new, dev_names=ar.dev_names + devn_new,
            avoid_entries=avoid_entries,
        )

    def _assemble(
        self, ar: NodeArenas, templates: List[SchedTemplate]
    ) -> Tuple[EncodedCluster, ScanState, ClusterMeta]:
        """The O(U) half: template tensors + global term tables, assembled
        against the (possibly cached) node arenas."""
        vb = self.vocab
        N = ar.N
        R = vb.n_resources
        K = max(vb.n_label_keys, 1)
        U = len(templates)
        A = max(len(self.ts.selectors), 1)
        Tk = max(vb.n_topo_keys, 1)
        Hports = max(vb.n_ports, 1)

        Tt = ar.Tt
        # node arrays: shared from the arenas; axes that grew since the
        # arenas were built (new label keys / resources from delta pods)
        # are padded with "absent" on the node side
        node_valid = ar.node_valid
        unschedulable = ar.unschedulable
        taint_key, taint_val, taint_effect = ar.taint_key, ar.taint_val, ar.taint_effect
        alloc = ar.alloc if R == ar.R else _grown(ar.alloc, (N, R), 0.0)
        label_val = ar.label_val if K == ar.K else _grown(ar.label_val, (N, K), -1)
        label_num = ar.label_num if K == ar.K else _grown(ar.label_num, (N, K), _NAN)

        Tl = max([len(t.tolerations) for t in templates] + [1])
        Qs = max([len(t.node_selector) for t in templates] + [1])
        T = max([len(t.affinity_terms) for t in templates] + [1])
        Q = max(
            [
                len((term.get("matchExpressions") or [])) + len((term.get("matchFields") or []))
                for t in templates
                for term in t.affinity_terms
            ]
            + [1]
        )
        Vv = max(
            [
                len(e.get("values") or [])
                for t in templates
                for term in t.affinity_terms
                for e in (term.get("matchExpressions") or []) + (term.get("matchFields") or [])
            ]
            + [
                len(e.get("values") or [])
                for t in templates
                for pref in t.pref_node_affinity
                for e in ((pref.get("preference") or {}).get("matchExpressions") or [])
            ]
            + [1]
        )
        Pp = max([len(t.pref_node_affinity) for t in templates] + [1])
        Qp = max(
            [
                len(((pref.get("preference") or {}).get("matchExpressions") or []))
                + len(((pref.get("preference") or {}).get("matchFields") or []))
                for t in templates
                for pref in t.pref_node_affinity
            ]
            + [1]
        )
        Qmax = max(Q, Qp)
        Hp = max([len(t.host_ports) for t in templates] + [1])
        Cs = max([len(t.spread) for t in templates] + [1])
        Ti = max([len(t.aff_terms) for t in templates] + [1])
        Tn = max([len(t.anti_terms) for t in templates] + [1])
        Tpp = max([len(t.pref_terms) for t in templates] + [1])

        # ---- topology domains: trash-row substitution over the raw arena
        # ids (the arena keeps -1 for absent so D can keep growing)
        raw_domain = ar.node_domain
        if raw_domain.shape[1] < Tk:
            raw_domain = np.concatenate(
                [raw_domain, np.full((N, Tk - raw_domain.shape[1]), -1, np.int32)],
                axis=1,
            )
        D = max(len(ar.domain_ids), 1)
        node_domain = np.where(raw_domain < 0, D, raw_domain).astype(np.int32)  # D = trash row
        domain_topo = np.full((D + 1,), -1, dtype=np.int32)
        for (tki, _vid), did in ar.domain_ids.items():
            domain_topo[did] = tki

        # ---- global inter-pod term tables
        topo_idx = {k: i for i, k in enumerate(vb.topo_keys.items())}
        anti_table: Dict[Tuple[int, int], int] = {}
        pref_table: Dict[Tuple[int, int], int] = {}
        for t in templates:
            for term in t.anti_terms:
                anti_table.setdefault((term.sel_id, topo_idx.get(term.topo_key, -1)), len(anti_table))
            for term in t.pref_terms:
                pref_table.setdefault((term.sel_id, topo_idx.get(term.topo_key, -1)), len(pref_table))
            # existing pods' REQUIRED affinity terms score with hard weight 1
            for term in t.aff_terms:
                pref_table.setdefault((term.sel_id, topo_idx.get(term.topo_key, -1)), len(pref_table))
        G = max(len(anti_table), 1)
        Gp = max(len(pref_table), 1)
        anti_g_sel = np.zeros((G,), dtype=np.int32)
        anti_g_topo = np.zeros((G,), dtype=np.int32)
        for (sid, tki), g in anti_table.items():
            anti_g_sel[g] = sid
            anti_g_topo[g] = max(tki, 0)
        prefg_sel = np.zeros((Gp,), dtype=np.int32)
        prefg_topo = np.zeros((Gp,), dtype=np.int32)
        for (sid, tki), g in pref_table.items():
            prefg_sel[g] = sid
            prefg_topo[g] = max(tki, 0)

        # ---- template tensors
        req = np.zeros((U, R), dtype=np.float32)
        tol_valid = np.zeros((U, Tl), dtype=bool)
        tol_key = np.full((U, Tl), -1, dtype=np.int32)
        tol_op = np.zeros((U, Tl), dtype=np.int32)
        tol_val = np.full((U, Tl), -1, dtype=np.int32)
        tol_effect = np.full((U, Tl), -1, dtype=np.int32)
        ns_key = np.full((U, Qs), -1, dtype=np.int32)
        ns_val = np.full((U, Qs), -1, dtype=np.int32)
        has_req_aff = np.zeros((U,), dtype=bool)
        aff_term_valid = np.zeros((U, T), dtype=bool)
        aff_key = np.full((U, T, Qmax), -1, dtype=np.int32)
        aff_op = np.full((U, T, Qmax), V.OP_PAD, dtype=np.int32)
        aff_val = np.full((U, T, Qmax, Vv), -1, dtype=np.int32)
        aff_num = np.full((U, T, Qmax), _NAN, dtype=np.float32)
        pna_weight = np.zeros((U, Pp), dtype=np.float32)
        pna_key = np.full((U, Pp, Qmax), -1, dtype=np.int32)
        pna_op = np.full((U, Pp, Qmax), V.OP_PAD, dtype=np.int32)
        pna_val = np.full((U, Pp, Qmax, Vv), -1, dtype=np.int32)
        pna_num = np.full((U, Pp, Qmax), _NAN, dtype=np.float32)
        ports = np.full((U, Hp), -1, dtype=np.int32)
        spr_topo = np.full((U, Cs), -1, dtype=np.int32)
        spr_sel = np.zeros((U, Cs), dtype=np.int32)
        spr_skew = np.zeros((U, Cs), dtype=np.int32)
        spr_hard = np.zeros((U, Cs), dtype=bool)
        at_sel = np.full((U, Ti), -1, dtype=np.int32)
        at_topo = np.zeros((U, Ti), dtype=np.int32)
        an_sel = np.full((U, Tn), -1, dtype=np.int32)
        an_topo = np.zeros((U, Tn), dtype=np.int32)
        pt_sel = np.full((U, Tpp), -1, dtype=np.int32)
        pt_topo = np.zeros((U, Tpp), dtype=np.int32)
        pt_w = np.zeros((U, Tpp), dtype=np.float32)
        anti_g = np.zeros((U, G), dtype=bool)
        prefg_w = np.zeros((U, Gp), dtype=np.float32)
        pin = np.full((U,), -1, dtype=np.int32)
        gpu_mem = np.zeros((U,), dtype=np.float32)
        gpu_count = np.zeros((U,), dtype=np.int32)

        for u, t in enumerate(templates):
            for rid, v in vb.encode_resources(t.requests).items():
                req[u, rid] = v
            req[u, V.RES_PODS] += 1.0  # every pod consumes one pod slot
            if t.node_name:
                pin[u] = self.node_index.get(t.node_name, -2)
            for j, (key, op, val, eff) in enumerate(t.tolerations[:Tl]):
                tol_valid[u, j] = True
                tol_key[u, j] = vb.label_keys.get(key, -1) if key else -1
                tol_op[u, j] = V.TOL_EXISTS if op == "Exists" else V.TOL_EQUAL
                tol_val[u, j] = vb.label_vals.get(val, -1)
                tol_effect[u, j] = V.EFFECT_CODES.get(eff, -1) if eff else -1
            for j, (k, v) in enumerate(sorted(t.node_selector.items())[:Qs]):
                ns_key[u, j] = vb.key_id(k)
                ns_val[u, j] = vb.label_vals.get(str(v), -1)
            if t.affinity_terms:
                has_req_aff[u] = True
                tv, tk_, to, tva, tn = self._encode_terms(t.affinity_terms, T, Qmax, Vv)
                aff_term_valid[u], aff_key[u], aff_op[u], aff_val[u], aff_num[u] = tv, tk_, to, tva, tn
            if t.pref_node_affinity:
                terms = [p.get("preference") or {} for p in t.pref_node_affinity]
                tv, tk_, to, tva, tn = self._encode_terms(terms, Pp, Qmax, Vv)
                pna_key[u], pna_op[u], pna_val[u], pna_num[u] = tk_, to, tva, tn
                for j, p in enumerate(t.pref_node_affinity[:Pp]):
                    pna_weight[u, j] = float(p.get("weight", 0))
            for j, (proto, port, ip) in enumerate(t.host_ports[:Hp]):
                ports[u, j] = vb.port_id(proto, port, ip)
            for j, c in enumerate(t.spread[:Cs]):
                spr_topo[u, j] = topo_idx.get(c.topo_key, -1)
                spr_sel[u, j] = c.sel_id
                spr_skew[u, j] = c.max_skew
                spr_hard[u, j] = c.hard
            for j, term in enumerate(t.aff_terms[:Ti]):
                # filter counts pods matching ALL terms — use the conjunction
                # selector when the template has several (templates.py)
                at_sel[u, j] = t.aff_conj if t.aff_conj >= 0 else term.sel_id
                at_topo[u, j] = max(topo_idx.get(term.topo_key, -1), 0)
            for j, term in enumerate(t.anti_terms[:Tn]):
                an_sel[u, j] = term.sel_id
                an_topo[u, j] = max(topo_idx.get(term.topo_key, -1), 0)
                anti_g[u, anti_table[(term.sel_id, topo_idx.get(term.topo_key, -1))]] = True
            for j, term in enumerate(t.pref_terms[:Tpp]):
                pt_sel[u, j] = term.sel_id
                pt_topo[u, j] = max(topo_idx.get(term.topo_key, -1), 0)
                pt_w[u, j] = term.weight
                prefg_w[u, pref_table[(term.sel_id, topo_idx.get(term.topo_key, -1))]] += term.weight
            for term in t.aff_terms:
                # symmetric hard-affinity weight (HardPodAffinityWeight = 1)
                prefg_w[u, pref_table[(term.sel_id, topo_idx.get(term.topo_key, -1))]] += 1.0
            gpu_mem[u] = t.gpu_mem
            gpu_count[u] = t.gpu_count

        matches_sel = np.zeros((U, A), dtype=bool)
        mm = self.ts.match_matrix()
        if mm.size:
            matches_sel[: mm.shape[0], : mm.shape[1]] = mm

        # ---- NodePreferAvoidPods (node_prefer_avoid_pods.go:47-82): pods
        # controlled by an RS/RC listed in the node's preferAvoidPods
        # annotation score 0 there, 100 elsewhere
        avoid_score = np.full((U, N), 100.0, dtype=np.float32)
        for i, avoided in ar.avoid_entries:
            for u, t in enumerate(templates):
                if t.controller[0] and tuple(t.controller) in avoided:
                    avoid_score[u, i] = 0.0

        # ---- extensions: node side cached in the arenas, template side
        # encoded by its dedicated module (task: gpu/local)
        from .extensions import encode_local_requests

        node_gpu_mem, node_gpu_count = ar.node_gpu_mem, ar.node_gpu_count
        from ..models.objects import RES_GPU_COUNT

        gc_mask = np.zeros((R,), dtype=bool)
        gc_col = vb.resources.get(RES_GPU_COUNT)
        if gc_col >= 0:
            gc_mask[gc_col] = True
        node_vg_cap, node_dev_cap, node_dev_media = (
            ar.node_vg_cap, ar.node_dev_cap, ar.node_dev_media
        )
        vg_names, dev_names = ar.vg_names, ar.dev_names
        lvm_req, dev_req, dev_req_count, dev_req_sizes = encode_local_requests(templates)

        cluster = EncodedCluster(
            node_valid=node_valid,
            alloc=alloc,
            unschedulable=unschedulable,
            taint_key=taint_key,
            taint_val=taint_val,
            taint_effect=taint_effect,
            label_val=label_val,
            label_num=label_num,
            node_domain=node_domain,
            domain_topo=domain_topo,
            req=req,
            tol_valid=tol_valid,
            tol_key=tol_key,
            tol_op=tol_op,
            tol_val=tol_val,
            tol_effect=tol_effect,
            ns_key=ns_key,
            ns_val=ns_val,
            has_req_aff=has_req_aff,
            aff_term_valid=aff_term_valid,
            aff_key=aff_key,
            aff_op=aff_op,
            aff_val=aff_val,
            aff_num=aff_num,
            pna_weight=pna_weight,
            pna_key=pna_key,
            pna_op=pna_op,
            pna_val=pna_val,
            pna_num=pna_num,
            ports=ports,
            port_conflict=vb.port_conflict_matrix(),
            spr_topo=spr_topo,
            spr_sel=spr_sel,
            spr_skew=spr_skew,
            spr_hard=spr_hard,
            at_sel=at_sel,
            at_topo=at_topo,
            an_sel=an_sel,
            an_topo=an_topo,
            pt_sel=pt_sel,
            pt_topo=pt_topo,
            pt_w=pt_w,
            matches_sel=matches_sel,
            anti_g=anti_g,
            prefg_w=prefg_w,
            pin=pin,
            avoid_score=avoid_score,
            anti_g_sel=anti_g_sel,
            anti_g_topo=anti_g_topo,
            prefg_sel=prefg_sel,
            prefg_topo=prefg_topo,
            gpu_mem=gpu_mem,
            gpu_count=gpu_count,
            node_gpu_mem=node_gpu_mem,
            gc_mask=gc_mask,
            lvm_req=lvm_req,
            dev_req=dev_req,
            dev_req_count=dev_req_count,
            dev_req_sizes=dev_req_sizes,
            node_vg_cap=node_vg_cap,
            node_dev_cap=node_dev_cap,
            node_dev_media=node_dev_media,
            log_sizes=log_size_table(N),
        )

        state0 = ScanState(
            used=np.zeros((N, R), dtype=np.float32),
            port_used=np.zeros((N, Hports), dtype=np.float32),
            dom_sel=np.zeros((D + 1, A), dtype=np.float32),
            dom_anti=np.zeros((D + 1, G), dtype=np.float32),
            dom_prefw=np.zeros((D + 1, Gp), dtype=np.float32),
            gpu_free=node_gpu_mem.copy(),
            vg_free=node_vg_cap.copy(),
            dev_free=node_dev_cap.copy(),
        )

        meta = ClusterMeta(
            node_names=[n.metadata.name for n in self.nodes],
            n_real_nodes=len(self.nodes),
            vocab=vb,
            template_set=self.ts,
            resource_names=list(vb.resources.items()),
            n_domains=D,
            node_gpu_count=node_gpu_count,
            node_vg_names=vg_names,
            node_dev_names=dev_names,
            node_gpu_mem=node_gpu_mem.copy(),
            node_vg_cap=node_vg_cap.copy(),
            node_dev_cap=node_dev_cap.copy(),
            node_dev_media=node_dev_media.copy(),
        )
        return cluster, state0, meta


_TORCH_DTYPES = {
    "FLOAT_DTYPE": torch.float32,
    "INT_DTYPE": torch.int32,
    "BOOL_DTYPE": torch.bool,
}


def _field_to_torch(a: np.ndarray, policy: str, device: torch.device) -> torch.Tensor:
    want = _TORCH_DTYPES[policy]
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype != want:
        raise TypeError(f"array of dtype {t.dtype} where the contract names {want}")
    return t.to(device)


def to_device(
    ec_np: EncodedCluster, st0: ScanState, device: torch.device, reuse: Optional[Dict[int, torch.Tensor]] = None,
) -> Tuple[EncodedCluster, ScanState]:
    """Move the numpy-built cluster and carry to torch tensors on `device`,
    each field with the dtype its contract in ``encoding/dtypes.py`` names
    (a field built at another width raises instead of being cast).
    `reuse` (``{id(numpy leaf): tensor}``, the delta re-encoders') keeps
    the tensor already on `device` for each cluster leaf it holds."""
    device = torch.device(device)
    reuse = reuse or {}
    return (
        EncodedCluster(*[
            reuse[id(a)] if id(a) in reuse else _field_to_torch(a, ARENA_CONTRACTS[f][0], device)
            for f, a in zip(EncodedCluster._fields, ec_np)
        ]),
        ScanState(*[
            _field_to_torch(a, STATE_CONTRACTS[f][0], device)
            for f, a in zip(ScanState._fields, st0)
        ]),
    )
