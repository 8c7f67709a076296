"""Host-side label-selector / node-affinity / taint matching.

Reference-parity with the ``k8s.io/apimachinery`` label machinery and the
scheduler helpers the reference calls (e.g. daemon predicates used by
``NodeShouldRunPod``, ``pkg/utils/utils.go:325-351``). These functions serve
two roles: (1) host-side workload expansion (DaemonSet eligibility), and
(2) golden references for the vectorized static tables in ``ops/``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .objects import Node, Pod, Taint, Toleration


# ---------------------------------------------------------------------------
# Label selectors (metav1.LabelSelector): matchLabels + matchExpressions.
# ---------------------------------------------------------------------------

def match_label_selector(selector: Optional[dict], labels: Dict[str, str]) -> bool:
    """Does a metav1.LabelSelector match a label set?  A nil selector matches
    nothing (k8s semantics for e.g. affinity term selectors); an empty
    selector matches everything."""
    if selector is None:
        return False
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != str(v):
            return False
    for expr in selector.get("matchExpressions") or []:
        if not _match_expression(expr, labels):
            return False
    return True


def _match_expression(expr: dict, labels: Dict[str, str]) -> bool:
    key = expr.get("key", "")
    op = expr.get("operator", "")
    values = [str(v) for v in (expr.get("values") or [])]
    present = key in labels
    val = labels.get(key)
    if op == "In":
        return present and val in values
    if op == "NotIn":
        return not present or val not in values
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    raise ValueError(f"unknown label selector operator: {op}")


# ---------------------------------------------------------------------------
# Node selectors / node affinity (corev1.NodeSelector).
# ---------------------------------------------------------------------------

def _match_node_expression(expr: dict, labels: Dict[str, str]) -> bool:
    key = expr.get("key", "")
    op = expr.get("operator", "")
    values = [str(v) for v in (expr.get("values") or [])]
    present = key in labels
    val = labels.get(key)
    if op == "In":
        return present and val in values
    if op == "NotIn":
        return not present or val not in values
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    if op in ("Gt", "Lt"):
        if not present or len(values) != 1:
            return False
        try:
            node_val = int(val)  # type: ignore[arg-type]
            sel_val = int(values[0])
        except (TypeError, ValueError):
            return False
        return node_val > sel_val if op == "Gt" else node_val < sel_val
    raise ValueError(f"unknown node selector operator: {op}")


def match_node_selector_term(term: dict, node: Node) -> bool:
    """One NodeSelectorTerm: AND of matchExpressions (on labels) and
    matchFields (on metadata.name)."""
    exprs = term.get("matchExpressions") or []
    fields = term.get("matchFields") or []
    if not exprs and not fields:
        return False  # empty term matches no objects (k8s semantics)
    for expr in exprs:
        if not _match_node_expression(expr, node.metadata.labels):
            return False
    for expr in fields:
        if expr.get("key") != "metadata.name":
            return False
        if not _match_node_expression(expr, {"metadata.name": node.metadata.name}):
            return False
    return True


def match_node_selector_terms(terms: List[dict], node: Node) -> bool:
    """NodeSelector = OR over terms."""
    return any(match_node_selector_term(t, node) for t in terms)


def pod_matches_node_selector_and_affinity(pod: Pod, node: Node) -> bool:
    """RequiredDuringSchedulingIgnoredDuringExecution node affinity plus the
    plain nodeSelector map — the predicate behind the NodeAffinity filter
    plugin and daemon.Predicates' fitsNodeAffinity."""
    for k, v in pod.spec.node_selector.items():
        if node.metadata.labels.get(k) != str(v):
            return False
    aff = (pod.spec.affinity or {}).get("nodeAffinity") or {}
    required = aff.get("requiredDuringSchedulingIgnoredDuringExecution")
    if required is not None:
        # k8s MatchNodeSelectorTerms: an empty terms list matches no nodes.
        if not match_node_selector_terms(required.get("nodeSelectorTerms") or [], node):
            return False
    return True


def node_affinity_preferred_score(pod: Pod, node: Node) -> int:
    """Sum of matching preferred term weights (NodeAffinity score plugin)."""
    aff = (pod.spec.affinity or {}).get("nodeAffinity") or {}
    total = 0
    for pref in aff.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
        term = pref.get("preference") or {}
        if match_node_selector_term(term, node):
            total += int(pref.get("weight", 0))
    return total


# ---------------------------------------------------------------------------
# Taints / tolerations.
# ---------------------------------------------------------------------------

def toleration_tolerates_taint(tol: Toleration, taint: Taint) -> bool:
    if tol.effect and tol.effect != taint.effect:
        return False
    if tol.key and tol.key != taint.key:
        return False
    # empty key with Exists matches all taints
    if not tol.key and tol.operator != "Exists":
        return False
    if tol.operator == "Exists":
        return True
    if tol.operator in ("Equal", ""):
        return tol.value == taint.value
    return False


def find_untolerated_taint(
    taints: List[Taint], tolerations: List[Toleration], effects: Optional[List[str]] = None
) -> Optional[Taint]:
    """First taint (with effect in `effects`, default NoSchedule+NoExecute)
    not tolerated by any toleration. Mirrors v1helper.FindMatchingUntoleratedTaint."""
    if effects is None:
        effects = ["NoSchedule", "NoExecute"]
    for taint in taints:
        if taint.effect not in effects:
            continue
        if not any(toleration_tolerates_taint(t, taint) for t in tolerations):
            return taint
    return None


def count_intolerable_prefer_no_schedule(pod: Pod, node: Node) -> int:
    """TaintToleration score plugin input: number of PreferNoSchedule taints
    the pod does not tolerate."""
    count = 0
    for taint in node.taints:
        if taint.effect != "PreferNoSchedule":
            continue
        if not any(toleration_tolerates_taint(t, taint) for t in pod.spec.tolerations):
            count += 1
    return count


# ---------------------------------------------------------------------------
# DaemonSet eligibility — parity with NodeShouldRunPod
# (pkg/utils/utils.go:325-351 → k8s.io/kubernetes/pkg/controller/daemon
# Predicates: fitsNodeName, fitsNodeAffinity, fitsTaints).
# ---------------------------------------------------------------------------

def node_should_run_pod(node: Optional[Node], pod: Pod) -> bool:
    if node is None:
        return False
    if pod.spec.node_name and pod.spec.node_name != node.metadata.name:
        return False
    if not pod_matches_node_selector_and_affinity(pod, node):
        return False
    if find_untolerated_taint(node.taints, pod.spec.tolerations, ["NoSchedule", "NoExecute"]):
        return False
    return True


# ---------------------------------------------------------------------------
# Inter-pod affinity helpers (host-side golden reference).
# ---------------------------------------------------------------------------

def affinity_term_matches_pod(term: dict, term_pod_namespace: str, candidate: Pod) -> bool:
    """Does an affinity term (labelSelector + namespaces) match a candidate
    pod?  Empty `namespaces` means the term-owner pod's own namespace."""
    namespaces = [str(n) for n in (term.get("namespaces") or [])] or [term_pod_namespace]
    if candidate.metadata.namespace not in namespaces:
        return False
    return match_label_selector(term.get("labelSelector"), candidate.metadata.labels)
