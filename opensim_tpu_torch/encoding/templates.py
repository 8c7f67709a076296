"""Scheduling-template extraction.

Pods expanded from the same workload share an identical scheduling-relevant
spec; 50k pods typically collapse to a few dozen *templates*. All per-pod
device encodings are stored once per template and gathered by ``tmpl_id``
inside the scan — this is the shape-dedup that keeps the encoded cluster
small and the jit cache warm.

Canonical selectors: inter-pod affinity terms and topology-spread constraints
reference label selectors; each distinct (namespace-set, selector) pair
becomes a selector id, and per-template match bits (does a pod of template u
match selector a?) are precomputed on host — the device never does string
matching.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..models.objects import Pod
from ..models.selectors import match_label_selector

ZONE_LABEL = "topology.kubernetes.io/zone"
HOSTNAME_LABEL = "kubernetes.io/hostname"

# System-default topology spread (k8s 1.21 DefaultPodTopologySpread feature,
# scoring-only): maxSkew 3 on hostname, maxSkew 5 on zone, ScheduleAnyway.
SYSTEM_DEFAULT_SPREAD = (
    (HOSTNAME_LABEL, 3, False),
    (ZONE_LABEL, 5, False),
)


def canon_selector(ns, selector: Optional[dict]) -> Optional[tuple]:
    """(namespaces, matchLabels, matchExpressions) canonical form; `ns` is a
    namespace or tuple of namespaces (pod-affinity terms may list several);
    None for a nil selector (matches nothing)."""
    if selector is None:
        return None
    ns_t = tuple(sorted(ns)) if isinstance(ns, (tuple, list, set)) else (ns,)
    ml = tuple(sorted((str(k), str(v)) for k, v in (selector.get("matchLabels") or {}).items()))
    exprs = tuple(
        sorted(
            (
                str(e.get("key", "")),
                str(e.get("operator", "")),
                tuple(sorted(str(v) for v in (e.get("values") or []))),
            )
            for e in (selector.get("matchExpressions") or [])
        )
    )
    return (ns_t, ml, exprs)


def selector_matches(canon: Optional[tuple], ns: str, labels: Dict[str, str]) -> bool:
    """Host-side evaluation of a canonical selector against a pod's
    namespace + labels (the golden form used to precompute match bits)."""
    if canon is None:
        return False
    if canon[0] == "AND":
        # conjunction selector: a pod matches iff it matches every member
        # (podMatchesAllAffinityTerms, interpodaffinity/filtering.go:150-161)
        return all(selector_matches(sub, ns, labels) for sub in canon[1])
    sel_ns, ml, exprs = canon
    if ns not in sel_ns:
        return False
    sel = {
        "matchLabels": dict(ml),
        "matchExpressions": [{"key": k, "operator": op, "values": list(vals)} for k, op, vals in exprs],
    }
    return match_label_selector(sel, labels)


@dataclass(frozen=True)
class PodAffinityTerm:
    sel_id: int
    topo_key: str


@dataclass(frozen=True)
class PrefPodAffinityTerm:
    sel_id: int
    topo_key: str
    weight: float  # signed: negative for anti-affinity


@dataclass(frozen=True)
class SpreadConstraint:
    topo_key: str
    sel_id: int
    max_skew: int
    hard: bool  # DoNotSchedule vs ScheduleAnyway


@dataclass
class SchedTemplate:
    """One deduplicated scheduling spec."""

    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    requests: Dict[str, float] = field(default_factory=dict)  # resource name -> base units
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity_terms: List[dict] = field(default_factory=list)  # required node-affinity terms
    pref_node_affinity: List[dict] = field(default_factory=list)  # {weight, preference}
    tolerations: List[tuple] = field(default_factory=list)  # (key, op, value, effect)
    host_ports: List[Tuple[str, int, str]] = field(default_factory=list)
    spread: List[SpreadConstraint] = field(default_factory=list)
    aff_terms: List[PodAffinityTerm] = field(default_factory=list)  # required pod affinity
    aff_conj: int = -1  # conjunction selector id when len(aff_terms) > 1
    anti_terms: List[PodAffinityTerm] = field(default_factory=list)  # required pod anti-affinity
    pref_terms: List[PrefPodAffinityTerm] = field(default_factory=list)  # preferred, signed weights
    gpu_mem: float = 0.0  # per-GPU memory request (gpu-share extension)
    gpu_count: int = 0
    local_volumes: tuple = ()  # ((kind, size, scName), ...) open-local extension
    controller: tuple = ("", "")  # (kind, uid) when owned by a ReplicaSet/RC
    #   (NodePreferAvoidPods matches on controller kind+uid,
    #    node_prefer_avoid_pods.go:58-80)


class TemplateSet:
    """Dedupes pods into templates and interns selectors."""

    def __init__(self) -> None:
        self.templates: List[SchedTemplate] = []
        self._index: Dict[str, int] = {}
        self._hint_index: Dict[tuple, int] = {}
        self.selectors: List[Optional[tuple]] = []
        self._sel_index: Dict[Optional[tuple], int] = {}
        self._mm = None  # cached match matrix (incremental rebuilds)

    def clone(self) -> "TemplateSet":
        """Fork for delta re-encoding: template/selector ids are
        append-only, so a fork can add pods without touching the base.
        SchedTemplate objects are shared (immutable after extraction)."""
        new = object.__new__(TemplateSet)
        new.templates = list(self.templates)
        new._index = dict(self._index)
        new._hint_index = dict(self._hint_index)
        new.selectors = list(self.selectors)
        new._sel_index = dict(self._sel_index)
        new._mm = self._mm  # replaced, never mutated, on rebuild
        return new

    def selector_id(self, ns: "str | tuple", selector: Optional[dict]) -> int:
        canon = canon_selector(ns, selector)
        idx = self._sel_index.get(canon)
        if idx is None:
            idx = len(self.selectors)
            self._sel_index[canon] = idx
            self.selectors.append(canon)
        return idx

    def conjunction_id(self, sel_ids: List[int]) -> int:
        """Selector id matching pods that match ALL of `sel_ids` — the
        counting basis k8s uses for a pod's required affinity terms
        (updateWithAffinityTerms → podMatchesAllAffinityTerms,
        interpodaffinity/filtering.go:113-127)."""
        subs = tuple(sorted({self.selectors[i] for i in sel_ids}, key=repr))
        if len(subs) == 1:
            return self._sel_index[subs[0]]
        canon = ("AND", subs)
        idx = self._sel_index.get(canon)
        if idx is None:
            idx = len(self.selectors)
            self._sel_index[canon] = idx
            self.selectors.append(canon)
        return idx

    def add_pod(self, pod: Pod, owner_selector: Optional[dict] = None, hint: Optional[tuple] = None) -> int:
        """Returns the template id for this pod (creating it if new).

        `hint` is an optional cheap identity key (e.g. the owning workload):
        pods expanded from one workload share an identical scheduling spec,
        so the full canonical-extraction path runs once per workload instead
        of once per pod — the host-side analogue of the chunked pod
        validation the reference needed for >3k-node scale
        (pkg/simulator/utils.go:77)."""
        if hint is not None:
            idx = self._hint_index.get(hint)
            if idx is not None:
                return idx
        # owner_selector may be a callable (lazy): hint hits above never pay
        # the selector dict build, only actual extractions do
        if callable(owner_selector):
            owner_selector = owner_selector()
        tmpl = self._extract(pod, owner_selector)
        key = self._canon_key(tmpl)
        idx = self._index.get(key)
        if idx is None:
            idx = len(self.templates)
            self._index[key] = idx
            self.templates.append(tmpl)
        if hint is not None:
            self._hint_index[hint] = idx
        return idx

    # -- extraction ---------------------------------------------------------

    def _extract(self, pod: Pod, owner_selector: Optional[dict]) -> SchedTemplate:
        ns = pod.metadata.namespace or "default"
        t = SchedTemplate(namespace=ns, labels=dict(pod.metadata.labels))
        t.requests = pod.resource_requests()
        t.node_name = pod.spec.node_name
        t.node_selector = dict(pod.spec.node_selector)
        aff = pod.spec.affinity or {}
        node_aff = aff.get("nodeAffinity") or {}
        required = node_aff.get("requiredDuringSchedulingIgnoredDuringExecution")
        if required is not None:
            t.affinity_terms = list(required.get("nodeSelectorTerms") or [])
            if not t.affinity_terms:
                # empty terms matches no node; encode an impossible term
                t.affinity_terms = [{"matchExpressions": [{"key": "", "operator": "In", "values": []}]}]
        t.pref_node_affinity = list(node_aff.get("preferredDuringSchedulingIgnoredDuringExecution") or [])
        t.tolerations = [
            (tol.key, tol.operator, tol.value, tol.effect) for tol in pod.spec.tolerations
        ]
        t.host_ports = [(p.protocol, p.host_port, p.host_ip) for p in pod.host_ports()]

        # -- inter-pod affinity
        pod_aff = aff.get("podAffinity") or {}
        pod_anti = aff.get("podAntiAffinity") or {}
        for term in pod_aff.get("requiredDuringSchedulingIgnoredDuringExecution") or []:
            t.aff_terms.append(self._pod_term(ns, term))
        if len(t.aff_terms) > 1:
            # k8s counts only existing pods matching ALL required affinity
            # terms (filtering.go:113-127): the FILTER uses this interned
            # conjunction as its counting basis, while the symmetric
            # hard-affinity SCORE keeps the per-term selectors
            # (scoring.go processExistingPod matches terms individually).
            t.aff_conj = self.conjunction_id([x.sel_id for x in t.aff_terms])
        for term in pod_anti.get("requiredDuringSchedulingIgnoredDuringExecution") or []:
            t.anti_terms.append(self._pod_term(ns, term))
        for pref in pod_aff.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
            term = self._pod_term(ns, pref.get("podAffinityTerm") or {})
            t.pref_terms.append(PrefPodAffinityTerm(term.sel_id, term.topo_key, float(pref.get("weight", 0))))
        for pref in pod_anti.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
            term = self._pod_term(ns, pref.get("podAffinityTerm") or {})
            t.pref_terms.append(PrefPodAffinityTerm(term.sel_id, term.topo_key, -float(pref.get("weight", 0))))

        # -- topology spread
        explicit = pod.spec.topology_spread_constraints
        if explicit:
            for c in explicit:
                sel_id = self.selector_id(ns, c.get("labelSelector"))
                t.spread.append(
                    SpreadConstraint(
                        topo_key=str(c.get("topologyKey", "")),
                        sel_id=sel_id,
                        max_skew=int(c.get("maxSkew", 1)),
                        hard=(c.get("whenUnsatisfiable", "DoNotSchedule") == "DoNotSchedule"),
                    )
                )
        elif owner_selector is not None:
            # System-default spreading (scoring only) using the owning
            # workload's selector — stands in for k8s's service/RS/STS
            # selector lookup in defaultConstraints.
            for topo_key, max_skew, hard in SYSTEM_DEFAULT_SPREAD:
                sel_id = self.selector_id(ns, owner_selector)
                t.spread.append(SpreadConstraint(topo_key, sel_id, max_skew, hard))

        # -- extensions (gpu-share, open-local)
        t.gpu_mem = pod.gpu_mem_request()
        t.gpu_count = pod.gpu_count_request()
        for ref in pod.metadata.owner_references:
            if ref.controller and ref.kind in ("ReplicaSet", "ReplicationController"):
                t.controller = (ref.kind, ref.uid)
                break
        t.local_volumes = tuple(
            (str(v.get("kind", "")), int(v.get("size", 0)), str(v.get("scName", "")))
            for v in pod.local_volumes()
        )
        return t

    def _pod_term(self, ns: str, term: dict) -> PodAffinityTerm:
        # a term's selector applies within its explicit namespaces, or the
        # owning pod's namespace by default; the canonical selector carries
        # the whole namespace set so multi-namespace terms match exactly
        namespaces = tuple(str(n) for n in (term.get("namespaces") or [])) or (ns,)
        sel_id = self.selector_id(namespaces, term.get("labelSelector"))
        return PodAffinityTerm(sel_id=sel_id, topo_key=str(term.get("topologyKey", "")))

    # -- canonical dedupe key ----------------------------------------------

    @staticmethod
    def _canon_key(t: SchedTemplate) -> str:
        return json.dumps(
            {
                "ns": t.namespace,
                "labels": sorted(t.labels.items()),
                "req": sorted(t.requests.items()),
                "node": t.node_name,
                "nsel": sorted(t.node_selector.items()),
                "aff": t.affinity_terms,
                "paff": t.pref_node_affinity,
                "tol": t.tolerations,
                "ports": t.host_ports,
                "spread": [(c.topo_key, c.sel_id, c.max_skew, c.hard) for c in t.spread],
                "at": [(x.sel_id, x.topo_key) for x in t.aff_terms],
                "nt": [(x.sel_id, x.topo_key) for x in t.anti_terms],
                "pt": [(x.sel_id, x.topo_key, x.weight) for x in t.pref_terms],
                "gpu": [t.gpu_mem, t.gpu_count],
                "lv": list(t.local_volumes),
                "ctl": list(t.controller),
            },
            sort_keys=True,
            default=str,
        )

    # -- host-side match precompute ----------------------------------------

    def match_matrix(self):
        """[U, A] bool: does a pod of template u match selector a?

        Incremental: the previous matrix (if any) fills the known block, so
        a delta build evaluates only new-template rows and new-selector
        columns — O(ΔU·A + U·ΔA) python selector matches, not O(U·A). A
        row depends on the template's namespace and labels alone, so
        templates that share them (the pinned replicas of one workload in a
        live snapshot) share one evaluation."""
        import numpy as np

        U, A = len(self.templates), len(self.selectors)
        m = np.zeros((U, A), dtype=bool)
        u0 = a0 = 0
        prev = self._mm
        if prev is not None and prev.shape[0] <= U and prev.shape[1] <= A:
            u0, a0 = prev.shape
            m[:u0, :a0] = prev
        rows: Dict[tuple, np.ndarray] = {}
        for u, t in enumerate(self.templates):
            lo = a0 if u < u0 else 0
            if lo >= A:
                continue
            key = (t.namespace, tuple(sorted(t.labels.items())), lo)
            row = rows.get(key)
            if row is None:
                row = rows[key] = np.array(
                    [selector_matches(canon, t.namespace, t.labels) for canon in self.selectors[lo:]], dtype=bool)
            m[u, lo:] = row
        self._mm = m
        return m
