"""The registered reason codes of an unschedulable pod, and their kube
FitError rendering: the port's own copy of the JAX package's
``opensim_tpu/engine/reasons.py`` (the part ``simulate()`` calls).

Every unschedulable-reason string of the port comes from this module: the
kube-scheduler FitError phrasings of the 11 filter plugins, and the
missing pinned node of a forced pod, and the eviction of a preemption
victim. The filter members' values are the
filter indices of ``ops/kernels.py`` (``F_NODE_PIN`` … ``F_EXTRA``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Sequence


class Reason(enum.Enum):
    """Registered reason codes. Filter members carry their kernel filter
    index as the value; non-filter outcomes live at 100+."""

    # --- filter plugins (value == ops.kernels filter index) ---------------
    NODE_PIN = 0          # NodeName
    UNSCHEDULABLE = 1     # NodeUnschedulable
    TAINT = 2             # TaintToleration
    AFFINITY = 3          # NodeAffinity + nodeSelector
    PORTS = 4             # NodePorts
    FIT = 5               # NodeResourcesFit
    SPREAD = 6            # PodTopologySpread
    INTERPOD = 7          # InterPodAffinity
    GPU = 8               # GpuShare
    LOCAL = 9             # OpenLocal
    EXTRA = 10            # out-of-tree extra_plugins
    # --- non-filter outcomes ----------------------------------------------
    NODE_NOT_FOUND = 100   # forced pod whose spec.nodeName matches no node
    UNKNOWN_PROFILE = 101  # spec.schedulerName matches no profile
    PREEMPTED = 102        # evicted by a higher-priority pod

    @property
    def message(self) -> str:
        return _MESSAGES[self]

    @property
    def is_filter(self) -> bool:
        return self.value < 100


# kube-scheduler FitError phrasings (vendor/.../framework/types.go +
# the sim plugins' Filter status messages)
_MESSAGES: Dict[Reason, str] = {
    Reason.NODE_PIN: "node(s) didn't match the requested hostname",
    Reason.UNSCHEDULABLE: "node(s) were unschedulable",
    Reason.TAINT: "node(s) had taints that the pod didn't tolerate",
    Reason.AFFINITY: "node(s) didn't match Pod's node affinity",
    Reason.PORTS: "node(s) didn't have free ports for the requested pod ports",
    Reason.FIT: "Insufficient resources",
    Reason.SPREAD: "node(s) didn't match pod topology spread constraints",
    Reason.INTERPOD: "node(s) didn't satisfy inter-pod affinity rules",
    Reason.GPU: "Insufficient GPU memory in 1 GPU device",
    Reason.LOCAL: "node(s) didn't have enough local storage",
    Reason.EXTRA: "node(s) were rejected by an out-of-tree plugin",
    Reason.NODE_NOT_FOUND: 'node "{node}" not found',
    Reason.UNKNOWN_PROFILE: (
        "no scheduler profile named {profile!r} "
        "(pod never enters any profile's scheduling queue)"
    ),
    Reason.PREEMPTED: "preempted by higher-priority pod {pod}",
}

# the 11 filter messages in kernel filter-index order
FILTER_MESSAGES: List[str] = [
    _MESSAGES[r] for r in sorted((r for r in Reason if r.is_filter), key=lambda r: r.value)
]


def node_not_found(node_name: str) -> str:
    return Reason.NODE_NOT_FOUND.message.format(node=node_name)


def preempted(namespace: str, name: str) -> str:
    return Reason.PREEMPTED.message.format(pod=f"{namespace}/{name}")


@dataclass
class ReasonCount:
    """One line of a FitError breakdown: ``count`` nodes rejected for
    ``code``; ``resource`` names the short resource for FIT rejections
    (kube reports each resource class on its own line)."""

    code: Reason
    count: int
    resource: str = ""

    @property
    def label(self) -> str:
        if self.code is Reason.FIT and self.resource:
            return f"Insufficient {self.resource}"
        return self.code.message


def render_unschedulable(n_nodes: int, counts: Sequence[ReasonCount]) -> str:
    """The kube FitError headline: ``0/N nodes are available: 3 node(s) had
    taints that the pod didn't tolerate, 1 Insufficient cpu.`` — parts
    sorted by label like the reference's sorted reason map."""
    parts = [(c.count, c.label) for c in counts if c.count > 0]
    if not parts:
        return f"0/{n_nodes} nodes are available."
    body = ", ".join(f"{cnt} {msg}" for cnt, msg in sorted(parts, key=lambda x: x[1]))
    return f"0/{n_nodes} nodes are available: {body}."


def counts_from_rows(
    static_fail_row,
    fail_counts_row,
    insufficient_row,
    resource_names: Sequence[str],
) -> List[ReasonCount]:
    """Normalize one pod's failure-attribution rows into typed reason
    counts. ``static_fail_row`` covers the 4 template-static filters,
    ``fail_counts_row`` the dynamic ones (PORTS..EXTRA); FIT expands into
    per-resource lines from ``insufficient_row`` (kube reports Insufficient
    per resource, not per plugin)."""
    merged = list(static_fail_row) + list(fail_counts_row)
    out: List[ReasonCount] = []
    for code in sorted((r for r in Reason if r.is_filter), key=lambda r: r.value):
        cnt = int(merged[code.value])
        if cnt <= 0:
            continue
        if code is Reason.FIT:
            for r, rname in enumerate(resource_names):
                rcnt = int(insufficient_row[r])
                if rcnt > 0:
                    out.append(ReasonCount(code, rcnt, resource=str(rname)))
        else:
            out.append(ReasonCount(code, cnt))
    return out
