"""Capacity observatory — utilization, headroom and fragmentation of the
observed cluster: the port of ``opensim_tpu/obs/capacity.py``.

A :class:`CapacityEngine` keeps per-node request/allocatable aggregates,
the per-node utilization *distribution* (bucket counts moved between fixed
utilization buckets) and the spread moments (Σu, Σu² per resource) so that
one event moves them in O(1); a :meth:`~CapacityEngine.sample` folds them
into fragmentation (largest free node vs total free) and the top-K hottest
nodes once per generation, memoized. With the live twin the watch
supervisor bootstraps the engine at every sync and rebase and feeds it one
:meth:`~CapacityEngine.on_twin_change` per accepted event; ``simon replay``
feeds it each journal record (:meth:`~CapacityEngine.on_replay`). On the
polling snapshot the server bootstraps it per snapshot key.

Headroom is probed, not guessed: the max additional replicas of each
registered workload profile (``OPENSIM_HEADROOM_PROFILES``) comes from a
scenario sweep over the prepared snapshot — the probe app delta re-encoded
onto a cached base (``prepcache.derive_with_app_slices``) or prepared
afresh, candidate replica counts probed as pod-validity mask prefixes: one
grid launch of the bind-scan kernel for the ladder (``scenarios.sweep_auto``)
and one S = 1 grid launch per bisection step, so the verdict is the one a
fresh ``simulate`` of the cluster plus that many replicas gives.

Surfaces: cardinality-capped Prometheus families in ``/metrics``
(``simon_cluster_utilization_bucket{resource=}`` distribution, top-K
``simon_cluster_node_utilization{node=,resource=}`` series,
``simon_cluster_headroom{profile=}`` and the aggregate gauges),
``GET /api/cluster/report`` (the same rows the text renderer of
``planner/report.py`` prints), ``GET /api/debug/capacity`` (the timeline
ring) and ``simon top``.
"""

from __future__ import annotations

import heapq
import io
import logging
import math
import re
import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

if TYPE_CHECKING:
    from ..engine.prepcache import CacheEntry

from ..device import DeviceLike
from ..models.objects import LABEL_APP_NAME, Node, Pod, ResourceTypes
from ..models.quantity import format_milli, format_quantity, parse_quantity
from ..utils import envknobs
from .metrics import UTILIZATION_BUCKETS, escape_label_value, family_header
from .timeline import Sample, Timeline

log = logging.getLogger("opensim_tpu_torch.obs")

__all__ = [
    "CapacityEngine",
    "WorkloadProfile",
    "build_report",
    "format_top",
    "headroom_probe",
    "headroom_profiles",
    "snapshot_result",
    "topk_nodes",
]

#: the resources the observatory tracks per node ("pods" is the bound-pod
#: count vs the node's pod capacity) — a fixed set on purpose: the
#: per-resource label cardinality is part of the registry contract
RESOURCES: Tuple[str, ...] = ("cpu", "memory", "pods")

_CPU, _MEM, _PODS = 0, 1, 2

#: default registered headroom profiles (OPENSIM_HEADROOM_PROFILES
#: overrides): a typical small service pod and a chunky batch pod
DEFAULT_PROFILES = "small=500m:1Gi,large=4:8Gi"

_PROFILE_NAME_RE = re.compile(r"^[A-Za-z0-9_.\-]+$")


def topk_nodes() -> int:
    """``OPENSIM_CAPACITY_TOPK`` (default 10): the per-node series cap for
    ``simon_cluster_node_utilization`` — the cardinality governor that
    keeps a 100k-node twin from emitting 300k series per scrape. A typo
    degrades to the default with a warning."""
    raw = envknobs.raw("OPENSIM_CAPACITY_TOPK")
    try:
        return max(0, int(raw)) if raw else 10
    except ValueError:
        log.warning("ignoring unparseable OPENSIM_CAPACITY_TOPK=%r (using 10)", raw)
        return 10


@dataclass(frozen=True)
class WorkloadProfile:
    """One registered headroom probe shape: ``cpu``/``memory`` are quantity
    strings (they parameterize a fake Deployment template), ``max_replicas``
    bounds the probe ladder."""

    name: str
    cpu: str
    memory: str
    max_replicas: int = 256

    @property
    def cpu_cores(self) -> float:
        return parse_quantity(self.cpu)

    @property
    def mem_bytes(self) -> float:
        return parse_quantity(self.memory)


def headroom_profiles() -> List[WorkloadProfile]:
    """Parse ``OPENSIM_HEADROOM_PROFILES`` (``name=cpu:mem[:max],...``).
    Validated loudly — a silently-dropped typo would
    report headroom for profiles the operator never asked about."""
    raw = envknobs.raw("OPENSIM_HEADROOM_PROFILES").strip() or DEFAULT_PROFILES
    out: List[WorkloadProfile] = []
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, spec = entry.partition("=")
        parts = spec.split(":")
        if not sep or len(parts) not in (2, 3):
            raise ValueError(
                f"OPENSIM_HEADROOM_PROFILES entry {entry!r} must be "
                "name=cpu:memory[:max_replicas]"
            )
        name = name.strip()
        if not _PROFILE_NAME_RE.match(name):
            raise ValueError(
                f"OPENSIM_HEADROOM_PROFILES profile name {name!r} must match "
                f"{_PROFILE_NAME_RE.pattern}"
            )
        max_replicas = 256
        if len(parts) == 3:
            try:
                max_replicas = int(parts[2])
            except ValueError:
                raise ValueError(
                    f"OPENSIM_HEADROOM_PROFILES max_replicas {parts[2]!r} must be an integer"
                ) from None
            if max_replicas < 1:
                raise ValueError("OPENSIM_HEADROOM_PROFILES max_replicas must be >= 1")
        profile = WorkloadProfile(name, parts[0].strip(), parts[1].strip(), max_replicas)
        if profile.cpu_cores <= 0 and profile.mem_bytes <= 0:
            raise ValueError(
                f"OPENSIM_HEADROOM_PROFILES profile {name!r} requests no cpu and "
                "no memory; its headroom would be unbounded"
            )
        out.append(profile)
    if len({p.name for p in out}) != len(out):
        raise ValueError("OPENSIM_HEADROOM_PROFILES has duplicate profile names")
    return out


class _NodeState:
    """Per-node aggregate the event path maintains in O(1): allocatable and
    requested vectors over :data:`RESOURCES`, plus the utilization-bucket
    index currently credited per resource (-1 = not in the distribution —
    zero allocatable makes the ratio undefined)."""

    __slots__ = ("alloc", "req", "bucket")

    def __init__(self) -> None:
        self.alloc = [0.0, 0.0, 0.0]
        self.req = [0.0, 0.0, 0.0]
        self.bucket = [-1, -1, -1]


class CapacityEngine:
    """The incrementally-maintained capacity view. Thread-safe: events
    may be fed while scrapes and reports read samples.

    Wiring: a live-twin server attaches the engine to its
    :class:`~..server.watch.WatchSupervisor` (bootstrap on sync, one
    :meth:`on_twin_change` per accepted event, :meth:`sample` on the
    maintenance tick); a polling or fixed-cluster server bootstraps it
    lazily per snapshot key through :meth:`ensure_bootstrap`."""

    def __init__(self, topk: Optional[int] = None, timeline: Optional[Timeline] = None) -> None:
        self._lock = threading.RLock()
        self.topk = topk_nodes() if topk is None else max(0, topk)
        self.timeline = timeline if timeline is not None else Timeline()
        self._buckets = tuple(UTILIZATION_BUCKETS) + (math.inf,)
        self._nodes: Dict[str, _NodeState] = {}  # guarded-by: _lock
        # requests accumulated per NODE NAME, independent of whether the
        # node object has been seen yet (a pod can be bound to a node whose
        # ADDED event arrives later; its contribution folds in on arrival)
        self._node_req: Dict[str, List[float]] = {}  # guarded-by: _lock
        self._pods: Dict[Tuple[str, str], Tuple[str, float, float]] = {}  # guarded-by: _lock
        self._pending = 0  # guarded-by: _lock
        # distribution state per resource: bucket counts + spread moments
        self._dist = [[0] * len(self._buckets) for _ in RESOURCES]  # guarded-by: _lock
        self._sum_u = [0.0, 0.0, 0.0]  # guarded-by: _lock
        self._sum_u2 = [0.0, 0.0, 0.0]  # guarded-by: _lock
        self._n_util = [0, 0, 0]  # guarded-by: _lock
        self._alloc_total = [0.0, 0.0, 0.0]  # guarded-by: _lock
        self._req_total = [0.0, 0.0, 0.0]  # guarded-by: _lock
        # < 0: never bootstrapped, render nothing
        self.generation = -1  # guarded-by: _lock
        self._boot_key: Optional[str] = None  # guarded-by: _lock
        self._headroom: Dict[str, int] = {}  # guarded-by: _lock
        self._sample: Optional[Sample] = None  # guarded-by: _lock
        # set by the watch supervisor once it owns the view (bootstrap +
        # per-event feed): snapshot-keyed rebootstraps become no-ops
        self.event_fed = False  # guarded-by: _lock

    # -- bootstrap ----------------------------------------------------------

    def bootstrap(self, cluster: ResourceTypes, generation: int, key: Optional[str] = None) -> None:
        """One O(cluster) pass rebuilding the aggregates from scratch — the
        observatory's analogue of the twin's list+rebase (sync, 410
        recovery, anti-entropy repair, or a polling snapshot change)."""
        with self._lock:
            self._nodes.clear()
            self._node_req.clear()
            self._pods.clear()
            self._pending = 0
            self._dist = [[0] * len(self._buckets) for _ in RESOURCES]
            self._sum_u = [0.0, 0.0, 0.0]
            self._sum_u2 = [0.0, 0.0, 0.0]
            self._n_util = [0, 0, 0]
            self._alloc_total = [0.0, 0.0, 0.0]
            self._req_total = [0.0, 0.0, 0.0]
            for node in cluster.nodes:
                self._node_upsert(node)
            for pod in cluster.pods:
                self._pod_upsert(pod)
            self.generation = generation
            self._boot_key = key
            self._sample = None

    def ensure_bootstrap(self, cluster: ResourceTypes, key: str) -> None:
        """Polling-path maintenance: rebootstrap only when the snapshot key
        (content fingerprint or twin generation key) moved. Once the watch
        supervisor owns the view (``event_fed``) this is a no-op — events,
        not snapshot keys, keep it fresh."""
        with self._lock:
            if self.generation >= 0 and (self.event_fed or self._boot_key == key):
                return
            next_gen = self.generation + 1
        self.bootstrap(cluster, next_gen, key=key)

    # -- event path (O(1) per accepted twin event) --------------------------

    def on_twin_change(
        self, field: str, ev_type: str, obj: dict, change: tuple, generation: int
    ) -> None:
        """Fold one ACCEPTED twin event (``ClusterTwin.apply_event``
        returned a non-None change verdict) into the aggregates. The
        verdict carries decoded objects for the delta-shaped cases; only
        pod/node MODIFIED arrives as a bare ``rebuild`` and pays its own
        O(1) re-wrap here."""
        kind = change[0]
        with self._lock:
            if kind == "pod_add":
                self._pod_upsert(change[1])
            elif kind == "pod_del":
                self._pod_remove(change[1])
            elif kind == "node_add":
                self._node_upsert(change[1])
            elif field == "pods" and ev_type in ("ADDED", "MODIFIED"):
                self._pod_upsert(Pod.from_dict(obj))
            elif field == "nodes":
                meta = obj.get("metadata") or {}
                if ev_type == "DELETED":
                    self._node_remove(str(meta.get("name") or ""))
                elif ev_type in ("ADDED", "MODIFIED"):
                    self._node_upsert(Node.from_dict(obj))
            # non-pod/node resources don't change capacity accounting
            self.generation = generation
            self._boot_key = None  # event-fed: content key no longer applies

    def on_replay(self, record: dict, twin, change: Optional[tuple]) -> None:
        """Fold one replayed journal record (a ``server/journal.py``
        :func:`~..server.journal.replay_events` triple) into the
        aggregates: event records ride the same O(1) ``on_twin_change``
        path the live dispatch uses, and list-shaped records (checkpoint
        fast-forward, 410/anti-entropy rebases) rebootstrap from the
        replay twin — exactly the live supervisor's ``_capacity_rebase``
        moments, so a replayed timeline matches the recorded one."""
        t = record.get("t")
        if t == "ev" and change is not None:
            self.on_twin_change(
                str(record.get("f") or ""), str(record.get("k") or ""),
                record.get("o") or {}, change, int(record.get("gen") or 0),
            )
            return
        if t in ("rb", "ck"):
            with twin._lock:
                cluster = twin.materialize()
                gen = twin.generation
            self.claim_event_fed()
            self.bootstrap(cluster, gen)

    # -- internal accounting -------------------------------------------------

    @staticmethod
    def _pod_vec(pod: Pod) -> Tuple[float, float]:
        req = pod.resource_requests()
        return float(req.get("cpu", 0.0)), float(req.get("memory", 0.0))

    def _bucket_of(self, u: float) -> int:
        for i, bound in enumerate(self._buckets):
            if u <= bound:
                return i
        return len(self._buckets) - 1

    def _retire_node(self, name: str) -> None:
        ns = self._nodes.get(name)
        if ns is None:
            return
        for r in range(len(RESOURCES)):
            if ns.bucket[r] >= 0:
                u = ns.req[r] / ns.alloc[r]
                self._dist[r][ns.bucket[r]] -= 1
                self._sum_u[r] -= u
                self._sum_u2[r] -= u * u
                self._n_util[r] -= 1
                ns.bucket[r] = -1

    def _admit_node(self, name: str) -> None:
        ns = self._nodes.get(name)
        if ns is None:
            return
        req = self._node_req.get(name)
        ns.req = list(req) if req is not None else [0.0, 0.0, 0.0]
        for r in range(len(RESOURCES)):
            if ns.alloc[r] > 0:
                u = ns.req[r] / ns.alloc[r]
                ns.bucket[r] = self._bucket_of(u)
                self._dist[r][ns.bucket[r]] += 1
                self._sum_u[r] += u
                self._sum_u2[r] += u * u
                self._n_util[r] += 1

    def _node_upsert(self, node: Node) -> None:
        name = node.metadata.name
        alloc = [
            float(node.allocatable.get("cpu", 0.0)),
            float(node.allocatable.get("memory", 0.0)),
            float(node.allocatable.get("pods", 0.0)),
        ]
        self._retire_node(name)
        ns = self._nodes.get(name)
        if ns is None:
            ns = self._nodes[name] = _NodeState()
        for r in range(len(RESOURCES)):
            self._alloc_total[r] += alloc[r] - ns.alloc[r]
        ns.alloc = alloc
        self._admit_node(name)
        self._sample = None

    def _node_remove(self, name: str) -> None:
        ns = self._nodes.get(name)
        if ns is None:
            return
        self._retire_node(name)
        for r in range(len(RESOURCES)):
            self._alloc_total[r] -= ns.alloc[r]
        del self._nodes[name]
        # bound-pod contributions stay in _node_req/_req_total: the pods
        # still exist; they fold back into the distribution if the node
        # reappears (the twin treats node flap exactly the same way)
        self._sample = None

    def _add_req(self, node_name: str, cpu: float, mem: float, sign: float) -> None:
        self._retire_node(node_name)
        req = self._node_req.setdefault(node_name, [0.0, 0.0, 0.0])
        req[_CPU] += sign * cpu
        req[_MEM] += sign * mem
        req[_PODS] += sign
        self._req_total[_CPU] += sign * cpu
        self._req_total[_MEM] += sign * mem
        self._req_total[_PODS] += sign
        if sign < 0 and req[_PODS] <= 0 and abs(req[_CPU]) < 1e-12 and abs(req[_MEM]) < 1e-12:
            self._node_req.pop(node_name, None)
        self._admit_node(node_name)

    def _pod_upsert(self, pod: Pod) -> None:
        key = (pod.metadata.namespace, pod.metadata.name)
        self._pod_remove(key)
        if pod.phase in ("Succeeded", "Failed"):
            # terminal pods hold no capacity (the twin's admissibility rule
            # already deletes them on the event path; this covers bootstrap
            # from custom/unfiltered clusters)
            self._sample = None
            return
        cpu, mem = self._pod_vec(pod)
        node = pod.spec.node_name or ""
        self._pods[key] = (node, cpu, mem)
        if node:
            self._add_req(node, cpu, mem, +1.0)
        else:
            self._pending += 1
        self._sample = None

    def _pod_remove(self, key: Tuple[str, str]) -> None:
        old = self._pods.pop(key, None)
        if old is None:
            return
        node, cpu, mem = old
        if node:
            self._add_req(node, cpu, mem, -1.0)
        else:
            self._pending -= 1
        self._sample = None

    # -- headroom ------------------------------------------------------------

    def fit_upper_bound(self, profile: WorkloadProfile) -> int:
        """Resource-fit upper bound on the profile's additional replicas,
        O(nodes) over the aggregates: Σ over nodes of how many replicas the
        node's FREE cpu/memory/pod-slots admit. An upper bound only — the
        scan is authoritative (scheduling constraints can only reduce it) —
        used to size the probe ladder, never to report headroom."""
        cpu, mem = profile.cpu_cores, profile.mem_bytes
        total = 0
        with self._lock:
            for ns in self._nodes.values():
                k = float("inf")
                if cpu > 0:
                    k = min(k, math.floor(max(0.0, ns.alloc[_CPU] - ns.req[_CPU]) / cpu + 1e-6))
                if mem > 0:
                    k = min(k, math.floor(max(0.0, ns.alloc[_MEM] - ns.req[_MEM]) / mem + 1e-6))
                if ns.alloc[_PODS] > 0:
                    k = min(k, math.floor(max(0.0, ns.alloc[_PODS] - ns.req[_PODS]) + 1e-6))
                if not math.isfinite(k):
                    return profile.max_replicas
                total += int(k)
                if total >= profile.max_replicas:
                    return profile.max_replicas
        return min(total, profile.max_replicas)

    def claim_event_fed(self) -> None:
        """The watch supervisor declares ownership of the view (it will
        bootstrap and feed per-event updates): snapshot-keyed rebootstraps
        via :meth:`ensure_bootstrap` become no-ops from here on."""
        with self._lock:
            self.event_fed = True

    def set_headroom(self, values: Dict[str, int]) -> None:
        """Record the latest probe verdicts (merged into samples and the
        ``simon_cluster_headroom`` gauges until the next probe)."""
        with self._lock:
            self._headroom = dict(values)
            self._sample = None

    def headroom(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._headroom)

    # -- sampling (generation-keyed, O(nodes)) -------------------------------

    def sample(self) -> Optional[Sample]:
        """The derived capacity view for the current generation, memoized —
        repeated scrapes/reports of one generation reuse the fold. Appends
        to (or refreshes) the timeline. None before the first bootstrap."""
        with self._lock:
            if self.generation < 0:
                return None
            if self._sample is not None and self._sample.generation == self.generation:
                return self._sample
            s = Sample(generation=self.generation)
            s.nodes = len(self._nodes)
            s.pods_bound = len(self._pods) - self._pending
            s.pods_pending = self._pending
            free_total = [0.0, 0.0, 0.0]
            free_max = [0.0, 0.0, 0.0]
            for ns in self._nodes.values():
                for r in range(len(RESOURCES)):
                    free = max(0.0, ns.alloc[r] - ns.req[r])
                    free_total[r] += free
                    if free > free_max[r]:
                        free_max[r] = free
            for r, res in enumerate(RESOURCES):
                s.allocatable[res] = self._alloc_total[r]
                s.requested[res] = self._req_total[r]
                s.utilization[res] = (
                    self._req_total[r] / self._alloc_total[r] if self._alloc_total[r] > 0 else 0.0
                )
                n = self._n_util[r]
                if n > 0:
                    mean = self._sum_u[r] / n
                    var = max(0.0, self._sum_u2[r] / n - mean * mean)
                    s.spread[res] = math.sqrt(var) / mean if mean > 0 else 0.0
                else:
                    s.spread[res] = 0.0
                s.fragmentation[res] = (
                    1.0 - free_max[r] / free_total[r] if free_total[r] > 0 else 0.0
                )
            s.headroom = dict(self._headroom)
            s.hottest = self._hottest_locked()
            self._sample = s
        self.timeline.append(s)
        return s

    def _hottest_locked(self) -> List[Tuple[str, Dict[str, float]]]:
        """Top-K nodes by hottest resource ratio (cpu/memory), with a
        deterministic name tie-break so repeat scrapes of an idle cluster
        render identical series."""
        if self.topk <= 0:
            return []

        def heat(item):
            name, ns = item
            us = [
                ns.req[r] / ns.alloc[r]
                for r in (_CPU, _MEM)
                if ns.alloc[r] > 0
            ]
            return max(us) if us else 0.0

        top = heapq.nsmallest(
            self.topk, self._nodes.items(), key=lambda item: (-heat(item), item[0])
        )
        out = []
        for name, ns in top:
            out.append(
                (
                    name,
                    {
                        res: (ns.req[r] / ns.alloc[r] if ns.alloc[r] > 0 else 0.0)
                        for r, res in enumerate(RESOURCES)
                    },
                )
            )
        return out

    # -- /metrics ------------------------------------------------------------

    def metrics_lines(self) -> List[str]:
        """Prometheus lines (rendered by the REST layer). Cardinality is
        governed here: per-resource families are bounded by
        :data:`RESOURCES`, per-node series by :attr:`topk`, per-profile
        gauges by the registered profile list."""
        s = self.sample()
        if s is None:
            return []
        esc = escape_label_value
        lines: List[str] = []
        with self._lock:
            lines += family_header("simon_cluster_nodes")
            lines.append(f"simon_cluster_nodes {s.nodes}")
            lines += family_header("simon_cluster_pods_bound")
            lines.append(f"simon_cluster_pods_bound {s.pods_bound}")
            lines += family_header("simon_cluster_pods_pending")
            lines.append(f"simon_cluster_pods_pending {s.pods_pending}")
            for family, values in (
                ("simon_cluster_allocatable", s.allocatable),
                ("simon_cluster_requested", s.requested),
                ("simon_cluster_utilization_ratio", s.utilization),
                ("simon_cluster_spread", s.spread),
                ("simon_cluster_fragmentation", s.fragmentation),
            ):
                lines += family_header(family)
                lines += [
                    f'{family}{{resource="{esc(res)}"}} {values[res]:.6f}'
                    for res in RESOURCES
                ]
            # the per-node utilization DISTRIBUTION: a histogram-shaped
            # snapshot of current state (bucket counts move as nodes heat
            # and cool — maintained incrementally on the event path)
            lines += family_header("simon_cluster_utilization")
            for r, res in enumerate(RESOURCES):
                cum = 0
                for i, bound in enumerate(self._buckets):
                    cum += self._dist[r][i]
                    le = "+Inf" if math.isinf(bound) else f"{bound:g}"
                    lines.append(
                        f'simon_cluster_utilization_bucket{{resource="{esc(res)}",le="{le}"}} {cum}'
                    )
                lines.append(
                    f'simon_cluster_utilization_sum{{resource="{esc(res)}"}} {self._sum_u[r]:.6f}'
                )
                lines.append(
                    f'simon_cluster_utilization_count{{resource="{esc(res)}"}} {self._n_util[r]}'
                )
            if s.hottest:
                lines += family_header("simon_cluster_node_utilization")
                for name, utils in s.hottest:
                    lines += [
                        f'simon_cluster_node_utilization{{node="{esc(name)}",resource="{esc(res)}"}} '
                        f"{utils[res]:.6f}"
                        for res in RESOURCES
                    ]
            if s.headroom:
                lines += family_header("simon_cluster_headroom")
                lines += [
                    f'simon_cluster_headroom{{profile="{esc(p)}"}} {v}'
                    for p, v in sorted(s.headroom.items())
                ]
        return lines


# ---------------------------------------------------------------------------
# headroom probe: batched mask-prefix scan over the always-warm prep
# ---------------------------------------------------------------------------


def _probe_app(profile: WorkloadProfile, replicas: int):
    from ..engine.simulator import AppResource
    from ..models.fixtures import make_fake_deployment

    rt = ResourceTypes()
    rt.add(
        make_fake_deployment(
            f"simon-headroom-{profile.name}", replicas, profile.cpu, profile.memory
        )
    )
    return AppResource(f"simon-headroom-{profile.name}", rt)


def _probe_scan(prep, app_slice: Tuple[int, int], drop, ks: List[int]) -> List[bool]:
    """One batched sweep: scenario ``s`` enables the base stream (minus the
    twin's event-deleted pods) plus the first ``ks[s]`` probe replicas.
    Feasible = every enabled probe replica placed. The probe pods sit at
    the stream tail, so placements of the first k replicas are identical
    across scenarios — feasibility is monotone in k and a prefix ladder
    plus bisection finds the frontier exactly."""
    import numpy as np

    from ..parallel import scenarios

    lo, _hi = app_slice
    P = len(prep.ordered)
    base_valid = np.ones((P,), dtype=bool)
    base_valid[lo:] = False
    if drop is not None:
        base_valid &= ~np.asarray(drop, dtype=bool)[:P]
    node_row = np.asarray(prep.ec_np.node_valid, dtype=bool)
    S = len(ks)
    pod_valid = np.repeat(base_valid[None, :], S, axis=0)
    for s, k in enumerate(ks):
        pod_valid[s, lo : lo + k] = True
    node_valid = np.repeat(node_row[None, :], S, axis=0)
    res = scenarios.sweep_auto(prep, node_valid, pod_valid)
    chosen = np.asarray(res.chosen)
    return [bool((chosen[s, lo : lo + k] >= 0).all()) for s, k in enumerate(ks)]


def _probe_max(prep, app_slice: Tuple[int, int], drop, kmax: int) -> int:
    """Geometric ladder (one sweep) then bisection (S=1 sweeps) for the max
    feasible replica count in [0, kmax]. Every sweep runs on the same
    prepared stream, so the kernel's inputs are built once and kept."""
    if prep.inputs_memo is None:
        prep.inputs_memo = {}
    ladder = sorted({k for k in (2**i for i in range(kmax.bit_length())) if k <= kmax} | {kmax})
    ok = _probe_scan(prep, app_slice, drop, ladder)
    feasible = [k for k, good in zip(ladder, ok) if good]
    if not feasible:
        return 0
    k_lo = max(feasible)
    infeasible = [k for k, good in zip(ladder, ok) if not good and k > k_lo]
    if not infeasible:
        return k_lo  # kmax itself fits
    k_hi = min(infeasible)
    while k_hi - k_lo > 1:
        mid = (k_lo + k_hi) // 2
        if _probe_scan(prep, app_slice, drop, [mid])[0]:
            k_lo = mid
        else:
            k_hi = mid
    return k_lo


def headroom_probe(
    cluster: ResourceTypes,
    profile: WorkloadProfile,
    base: Optional["CacheEntry"] = None,
    kmax: Optional[int] = None,
    device: DeviceLike = None,
) -> int:
    """Max additional replicas of ``profile`` the cluster still schedules.

    With a warm ``base`` (a prep-cache :class:`CacheEntry` whose prep was
    built from ``cluster`` with no apps — the twin's always-warm base or
    the REST base entry), the probe app is DELTA re-encoded onto the cached
    arenas and only pays O(replicas) host work; without one it pays one
    full prepare (the bootstrap). ``kmax`` caps the ladder (callers pass
    the engine's :meth:`CapacityEngine.fit_upper_bound`); when the whole
    cap fits the probe re-derives at a doubled cap so a too-small resource
    bound can never under-report (``profile.max_replicas`` is the hard
    ceiling). Without a base the prepare goes to `device` (the card unless
    the caller names another); with one, to the base's device."""
    from ..engine import prepcache
    from ..engine.simulator import prepare

    kmax = profile.max_replicas if kmax is None else min(kmax, profile.max_replicas)
    if kmax <= 0:
        return 0
    while True:
        app = _probe_app(profile, kmax)
        if base is not None and base.prep is not None:
            with base.lock:
                base.restore()
                got = prepcache.derive_with_app_slices(
                    base.prep, cluster, [app], base_entry=base
                )
                if got is None:
                    return 0  # empty stream: nothing to probe against
                prep, slices = got
                # the live twin's event-deleted pods stay in its base
                # stream as masked rows: every probe launch drops them
                drop = prepcache.pad_drop_mask(base.base_drop, len(prep.ordered))
                try:
                    got_k = _probe_max(prep, slices[0], drop, kmax)
                finally:
                    base.restore()
        else:
            prep = prepare(cluster, [app], device=device)
            # the one app's pods close the stream, after the cluster's
            if prep is None or prep.n_cluster == len(prep.ordered):
                return 0
            got_k = _probe_max(prep, (prep.n_cluster, len(prep.ordered)), None, kmax)
        if got_k < kmax or kmax >= profile.max_replicas:
            return got_k
        # the resource bound under-sized the ladder (everything fit):
        # double and re-probe so the report never understates headroom
        kmax = min(profile.max_replicas, kmax * 2)


# ---------------------------------------------------------------------------
# report assembly: ONE computation path for JSON and text
# ---------------------------------------------------------------------------


def snapshot_result(cluster: ResourceTypes):
    """The OBSERVED cluster as a ``SimulateResult``-shaped view (pods
    grouped under their bound nodes, pending pods as unscheduled entries)
    so the planner's report row builders — the same functions the text
    renderer prints — serve ``GET /api/cluster/report`` unchanged."""
    from ..engine import reasons
    from ..engine.simulator import NodeStatus, SimulateResult, UnscheduledPod

    statuses = [NodeStatus(node=n, pods=[]) for n in cluster.nodes]
    by_name = {ns.node.metadata.name: ns for ns in statuses}
    unscheduled = []
    for pod in cluster.pods:
        if pod.phase in ("Succeeded", "Failed"):
            continue
        node = pod.spec.node_name or ""
        if node:
            ns = by_name.get(node)
            if ns is not None:
                ns.pods.append(pod)
        else:
            unscheduled.append(UnscheduledPod(pod, reasons.pending_observed()))
    return SimulateResult(unscheduled_pods=unscheduled, node_status=statuses)


def build_report(
    engine: CapacityEngine,
    cluster: ResourceTypes,
    extended_resources: Optional[List[str]] = None,
    state: str = "",
) -> dict:
    """The ``/api/cluster/report`` body: the capacity sample plus the SAME
    table rows ``planner/report.py`` renders as text (byte-equal cells —
    gated by the report-parity test)."""
    from ..planner import report as report_mod

    extended = list(extended_resources or [])
    result = snapshot_result(cluster)
    app_names = sorted(
        {
            p.metadata.labels.get(LABEL_APP_NAME)
            for ns in result.node_status
            for p in ns.pods
            if p.metadata.labels.get(LABEL_APP_NAME)
        }
    )
    sample = engine.sample()
    # pods bound to a node ABSENT from the view (the node-flap window: the
    # aggregates still count them — see _node_remove) have no table row;
    # list them explicitly so capacity.pods_bound always reconciles with
    # the tables instead of silently disagreeing
    known = {n.metadata.name for n in cluster.nodes}
    orphaned = [
        f"{p.metadata.namespace}/{p.metadata.name} (on {p.spec.node_name})"
        for p in cluster.pods
        if p.spec.node_name
        and p.spec.node_name not in known
        and p.phase not in ("Succeeded", "Failed")
    ]
    out = {
        "state": state,
        "capacity": sample.to_dict() if sample is not None else None,
        "pending": [
            f"{u.pod.metadata.namespace}/{u.pod.metadata.name}"
            for u in result.unscheduled_pods
        ],
        "orphaned": orphaned,
    }
    out.update(report_mod.report_data(result, extended, app_names))
    return out


def format_top(report: dict) -> str:
    """The ``simon top`` table view of one report body (CLI rendering of
    the same JSON the endpoint serves)."""
    from ..planner.report import _table

    out = io.StringIO()
    cap = report.get("capacity") or {}
    state = report.get("state") or "n/a"
    print(
        f"cluster: {cap.get('nodes', 0)} nodes, {cap.get('pods_bound', 0)} pods bound, "
        f"{cap.get('pods_pending', 0)} pending | twin: {state} "
        f"(generation {cap.get('generation', '?')})",
        file=out,
    )
    rows = [["Resource", "Allocatable", "Requested", "Utilization", "Spread", "Fragmentation"]]
    alloc = cap.get("allocatable") or {}
    req = cap.get("requested") or {}
    util = cap.get("utilization") or {}
    spread = cap.get("spread") or {}
    frag = cap.get("fragmentation") or {}
    for res in RESOURCES:
        if res == "cpu":
            a = format_milli(int(alloc.get(res, 0.0) * 1000))
            r = format_milli(int(req.get(res, 0.0) * 1000))
        elif res == "memory":
            a = format_quantity(alloc.get(res, 0.0))
            r = format_quantity(req.get(res, 0.0))
        else:
            a = str(int(alloc.get(res, 0.0)))
            r = str(int(req.get(res, 0.0)))
        rows.append(
            [
                res,
                a,
                r,
                f"{util.get(res, 0.0) * 100:.1f}%",
                f"{spread.get(res, 0.0):.3f}",
                f"{frag.get(res, 0.0):.3f}",
            ]
        )
    _table(rows, out)
    headroom = cap.get("headroom") or {}
    if headroom:
        print("", file=out)
        rows = [["Profile", "Headroom (replicas)"]]
        for name, v in sorted(headroom.items()):
            rows.append([name, str(v)])
        _table(rows, out)
    hottest = cap.get("hottest") or []
    if hottest:
        print("", file=out)
        rows = [["Hottest Node", "CPU", "Memory", "Pods"]]
        for entry in hottest:
            u = entry.get("utilization") or {}
            rows.append(
                [
                    entry.get("node", ""),
                    f"{u.get('cpu', 0.0) * 100:.1f}%",
                    f"{u.get('memory', 0.0) * 100:.1f}%",
                    f"{u.get('pods', 0.0) * 100:.1f}%",
                ]
            )
        _table(rows, out)
    memory = report.get("memory") or {}
    if memory.get("rows"):
        # the memory block (?mem=1, simon top --mem), rendered from the
        # rows the JSON carries (obs/footprint.memory_rows)
        print("", file=out)
        _table(memory["rows"], out)
    pending = report.get("pending") or []
    if pending:
        print("", file=out)
        shown = ", ".join(pending[:8]) + (", …" if len(pending) > 8 else "")
        print(f"pending pods ({len(pending)}): {shown}", file=out)
    orphaned = report.get("orphaned") or []
    if orphaned:
        print("", file=out)
        shown = ", ".join(orphaned[:8]) + (", …" if len(orphaned) > 8 else "")
        print(
            f"pods bound to absent nodes ({len(orphaned)}): {shown}",
            file=out,
        )
    return out.getvalue()
