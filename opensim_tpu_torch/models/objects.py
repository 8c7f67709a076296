"""Kubernetes object model (host layer).

Plain-Python dataclasses standing in for the ``corev1``/``appsv1`` typed
objects the reference manipulates. Each object keeps its source dict in
``raw`` so unmodelled fields round-trip. The set of modelled kinds mirrors
``ResourceTypes`` in the reference (``pkg/simulator/core.go:38-52``): Pods,
Nodes, Deployments, ReplicaSets, StatefulSets, DaemonSets, Jobs, CronJobs,
Services, PodDisruptionBudgets, StorageClasses, PersistentVolumeClaims,
ConfigMaps.
"""

from __future__ import annotations

import copy
import threading as _threading
import uuid as _uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .quantity import parse_quantity

# Annotation / label protocol — parity with pkg/type/const.go:19-31.
ANNO_WORKLOAD_KIND = "simon/workload-kind"
ANNO_WORKLOAD_NAME = "simon/workload-name"
ANNO_WORKLOAD_NAMESPACE = "simon/workload-namespace"
ANNO_NODE_LOCAL_STORAGE = "simon/node-local-storage"
ANNO_POD_LOCAL_STORAGE = "simon/pod-local-storage"
ANNO_NODE_GPU_SHARE = "simon/node-gpu-share"
ANNO_POD_PROVISIONER = "simon/pod-provisioner"
LABEL_NEW_NODE = "simon/new-node"
LABEL_APP_NAME = "simon/app-name"
ENV_MAX_CPU = "MaxCPU"
ENV_MAX_MEMORY = "MaxMemory"
ENV_MAX_VG = "MaxVG"
SEPARATE_SYMBOL = "-"
# simontype.DefaultSchedulerName = corev1.DefaultSchedulerName
# (pkg/type/const.go:12): the reference schedules with the DEFAULT
# kube scheduler name, and MakeValidPod defaults pods to it
DEFAULT_SCHEDULER_NAME = "default-scheduler"
LABEL_HOSTNAME = "kubernetes.io/hostname"

# GPU-share annotation protocol — pkg/type/open-gpu-share/utils/const.go:4-8.
RES_GPU_MEM = "alibabacloud.com/gpu-mem"
RES_GPU_COUNT = "alibabacloud.com/gpu-count"
ANNO_GPU_INDEX = "alibabacloud.com/gpu-index"
ANNO_GPU_ASSUME_TIME = "alibabacloud.com/assume-time"
LABEL_GPU_CARD_MODEL = "alibabacloud.com/gpu-card-model"

_counter = [0]


class VersionedObject:
    """Local mutation counter for the prepare-cache coherence protocol.

    ``PrepareCache`` fingerprints hash object identity + version, NOT deep
    content — so in-place edits of an already-fingerprinted object are
    invisible to the cache (the NOTES.md envelope). The protocol:

    1. mutate the object, then call ``obj.touch()`` — a cheap marker that
       the content behind the fingerprint changed;
    2. drop the stale entries with ``cache.invalidate(obj)``.

    A cache hit on an entry whose watched object was touched without
    invalidation raises ``StaleFingerprintError`` (engine/prepcache.py).
    The static side of the same contract is opensim-lint's cache-mutation
    rule (OSL401)."""

    _local_version = 0  # class default: instances allocate on first touch
    # process-global epoch: bumped on EVERY touch so cache freshness checks
    # are one integer compare in the steady state (no touches anywhere)
    # instead of an O(watched objects) version scan per cache hit. Lock-
    # guarded: a lost increment would let an entry re-arm its fast path
    # past a concurrent touch and silently serve a stale prepare.
    _touch_epoch = [0]
    _touch_lock = _threading.Lock()

    def touch(self) -> None:
        with VersionedObject._touch_lock:
            self._local_version = self._local_version + 1
            VersionedObject._touch_epoch[0] += 1

    @property
    def local_version(self) -> int:
        return self._local_version


def touch_epoch() -> int:
    """Current global touch epoch (see VersionedObject.touch)."""
    return VersionedObject._touch_epoch[0]


def _rand_suffix(n: int = 10) -> str:
    """Deterministic unique suffix standing in for k8s rand.String(10)
    (``pkg/utils/utils.go:313``). Deterministic so runs are reproducible."""
    _counter[0] += 1
    return f"{_counter[0]:0{n}x}"[-n:]


def new_uid() -> str:
    """Unique id in UUID shape without the UUID-object cost (this is on the
    50k-pod expansion hot path)."""
    _counter[0] += 1
    return f"00000000-0000-0000-0000-{_counter[0]:012x}"


@dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    uid: str = ""
    api_version: str = ""
    controller: bool = True

    def to_dict(self) -> dict:
        return {
            "apiVersion": self.api_version,
            "kind": self.kind,
            "name": self.name,
            "uid": self.uid,
            "controller": self.controller,
            "blockOwnerDeletion": True,
        }


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    uid: str = ""
    generate_name: str = ""
    owner_references: List[OwnerReference] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ObjectMeta":
        d = d or {}
        refs = [
            OwnerReference(
                kind=r.get("kind", ""),
                name=r.get("name", ""),
                uid=r.get("uid", ""),
                api_version=r.get("apiVersion", ""),
                controller=bool(r.get("controller", False)),
            )
            for r in d.get("ownerReferences") or []
        ]
        return cls(
            name=d.get("name", "") or "",
            namespace=d.get("namespace", "") or "",
            labels={k: str(v) for k, v in (d.get("labels") or {}).items()},
            annotations={k: str(v) for k, v in (d.get("annotations") or {}).items()},
            uid=str(d.get("uid", "") or ""),
            generate_name=d.get("generateName", "") or "",
            owner_references=refs,
        )

    def to_dict(self) -> dict:
        out: Dict[str, Any] = {"name": self.name}
        if self.namespace:
            out["namespace"] = self.namespace
        if self.labels:
            out["labels"] = dict(self.labels)
        if self.annotations:
            out["annotations"] = dict(self.annotations)
        if self.uid:
            out["uid"] = self.uid
        if self.generate_name:
            out["generateName"] = self.generate_name
        if self.owner_references:
            out["ownerReferences"] = [r.to_dict() for r in self.owner_references]
        return out


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" matches all effects
    toleration_seconds: Optional[int] = None

    @classmethod
    def from_dict(cls, d: dict) -> "Toleration":
        return cls(
            key=d.get("key", "") or "",
            operator=d.get("operator") or "Equal",  # k8s default operator is Equal
            value=str(d.get("value", "") or ""),
            effect=d.get("effect", "") or "",
            toleration_seconds=d.get("tolerationSeconds"),
        )


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute

    @classmethod
    def from_dict(cls, d: dict) -> "Taint":
        return cls(
            key=d.get("key", "") or "",
            value=str(d.get("value", "") or ""),
            # k8s requires an effect on taints; default missing ones to
            # NoSchedule so parsed and programmatic taints behave alike
            effect=d.get("effect", "") or "NoSchedule",
        )


@dataclass
class ContainerPort:
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class Container:
    name: str = ""
    image: str = ""
    requests: Dict[str, float] = field(default_factory=dict)
    limits: Dict[str, float] = field(default_factory=dict)
    ports: List[ContainerPort] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "Container":
        res = d.get("resources") or {}
        requests = {k: parse_quantity(v) for k, v in (res.get("requests") or {}).items()}
        limits = {k: parse_quantity(v) for k, v in (res.get("limits") or {}).items()}
        ports = [
            ContainerPort(
                host_port=int(p.get("hostPort", 0) or 0),
                container_port=int(p.get("containerPort", 0) or 0),
                protocol=p.get("protocol", "TCP") or "TCP",
                host_ip=p.get("hostIP", "") or "",
            )
            for p in d.get("ports") or []
        ]
        return cls(
            name=d.get("name", "") or "",
            image=d.get("image", "") or "",
            requests=requests,
            limits=limits,
            ports=ports,
        )


@dataclass
class PodSpec:
    node_name: str = ""
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    overhead: Dict[str, float] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[dict] = None  # raw affinity dict (nodeAffinity/podAffinity/podAntiAffinity)
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread_constraints: List[dict] = field(default_factory=list)
    host_network: bool = False
    scheduler_name: str = ""
    priority: int = 0
    volumes: List[dict] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PodSpec":
        d = d or {}
        return cls(
            node_name=d.get("nodeName", "") or "",
            containers=[Container.from_dict(c) for c in d.get("containers") or []],
            init_containers=[Container.from_dict(c) for c in d.get("initContainers") or []],
            overhead={k: parse_quantity(v) for k, v in (d.get("overhead") or {}).items()},
            node_selector={k: str(v) for k, v in (d.get("nodeSelector") or {}).items()},
            affinity=copy.deepcopy(d.get("affinity")) if d.get("affinity") else None,
            tolerations=[Toleration.from_dict(t) for t in d.get("tolerations") or []],
            topology_spread_constraints=copy.deepcopy(d.get("topologySpreadConstraints") or []),
            host_network=bool(d.get("hostNetwork", False)),
            scheduler_name=d.get("schedulerName", "") or "",
            priority=int(d.get("priority", 0) or 0),
            volumes=copy.deepcopy(d.get("volumes") or []),
        )


@dataclass
class Pod(VersionedObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    phase: str = ""
    raw: dict = field(default_factory=dict)

    kind = "Pod"

    @classmethod
    def from_dict(cls, d: dict) -> "Pod":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            spec=PodSpec.from_dict(d.get("spec")),
            phase=(d.get("status") or {}).get("phase", "") or "",
            raw=d,
        )

    # -- effective resource requests, k8s semantics:
    # max(sum(containers), max(initContainers)) + overhead
    # (mirrors resourcehelper.PodRequestsAndLimits used at plugin/simon.go:46)
    def resource_requests(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for c in self.spec.containers:
            for k, v in c.requests.items():
                total[k] = total.get(k, 0.0) + v
        for c in self.spec.init_containers:
            for k, v in c.requests.items():
                if v > total.get(k, 0.0):
                    total[k] = v
        for k, v in self.spec.overhead.items():
            total[k] = total.get(k, 0.0) + v
        return total

    def resource_limits(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for c in self.spec.containers:
            for k, v in c.limits.items():
                total[k] = total.get(k, 0.0) + v
        for c in self.spec.init_containers:
            for k, v in c.limits.items():
                if v > total.get(k, 0.0):
                    total[k] = v
        for k, v in self.spec.overhead.items():
            total[k] = total.get(k, 0.0) + v
        return total

    def host_ports(self) -> List[ContainerPort]:
        out = []
        for c in list(self.spec.containers) + list(self.spec.init_containers):
            for p in c.ports:
                if p.host_port > 0:
                    out.append(p)
        return out

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    # GPU-share request, parity with GetGpuMemoryAndCountFromPodAnnotation
    # (pkg/type/open-gpu-share/utils/pod.go:83-100): gpu-mem (memory PER GPU)
    # and gpu-count both come from pod *annotations*; absent count → 0.
    def gpu_mem_request(self) -> float:
        val = self.metadata.annotations.get(RES_GPU_MEM)
        if not val:
            return 0.0
        try:
            return parse_quantity(val)
        except ValueError:
            return 0.0

    def local_volumes(self) -> list:
        """Decode the simon/pod-local-storage annotation (volume dicts with
        kind/size/scName); the single parser shared by encoding and reports."""
        import json

        raw = self.metadata.annotations.get(ANNO_POD_LOCAL_STORAGE)
        if not raw:
            return []
        try:
            data = json.loads(raw)
            vols = data.get("volumes") if isinstance(data, dict) else None
        except ValueError:
            return []
        return [v for v in (vols or []) if isinstance(v, dict)]

    def gpu_count_request(self) -> int:
        try:
            cnt = int(self.metadata.annotations.get(RES_GPU_COUNT, "0"))
        except ValueError:
            return 0
        return max(cnt, 0)


@dataclass
class Node(VersionedObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    allocatable: Dict[str, float] = field(default_factory=dict)
    capacity: Dict[str, float] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False
    raw: dict = field(default_factory=dict)

    kind = "Node"

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        status = d.get("status") or {}
        spec = d.get("spec") or {}
        alloc = {k: parse_quantity(v) for k, v in (status.get("allocatable") or {}).items()}
        cap = {k: parse_quantity(v) for k, v in (status.get("capacity") or {}).items()}
        if not alloc:
            alloc = dict(cap)
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            allocatable=alloc,
            capacity=cap,
            taints=[Taint.from_dict(t) for t in spec.get("taints") or []],
            unschedulable=bool(spec.get("unschedulable", False)),
            raw=d,
        )

    @property
    def name(self) -> str:
        return self.metadata.name

    def to_dict(self) -> dict:
        d = copy.deepcopy(self.raw) if self.raw else {"apiVersion": "v1", "kind": "Node"}
        d["metadata"] = self.metadata.to_dict()
        return d


@dataclass
class Workload(VersionedObject):
    """Common shape for Deployment / ReplicaSet / StatefulSet / DaemonSet /
    Job / CronJob: metadata + pod template (+ replicas/completions)."""

    kind: str = ""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    replicas: int = 1
    selector: Optional[dict] = None
    template_metadata: ObjectMeta = field(default_factory=ObjectMeta)
    template_spec: PodSpec = field(default_factory=PodSpec)
    template_raw: dict = field(default_factory=dict)
    volume_claim_templates: List[dict] = field(default_factory=list)
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "Workload":
        kind = d.get("kind", "")
        spec = d.get("spec") or {}
        if kind == "CronJob":
            job_spec = (spec.get("jobTemplate") or {}).get("spec") or {}
            template = job_spec.get("template") or {}
            completions = job_spec.get("completions")
            replicas = 1 if completions is None else int(completions)
            selector = job_spec.get("selector")
            vct = []
        elif kind == "Job":
            template = spec.get("template") or {}
            completions = spec.get("completions")
            replicas = 1 if completions is None else int(completions)
            selector = spec.get("selector")
            vct = []
        else:
            template = spec.get("template") or {}
            replicas = int(spec.get("replicas", 1) if spec.get("replicas") is not None else 1)
            selector = spec.get("selector")
            vct = copy.deepcopy(spec.get("volumeClaimTemplates") or [])
        return cls(
            kind=kind,
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            replicas=replicas,
            selector=copy.deepcopy(selector),
            template_metadata=ObjectMeta.from_dict(template.get("metadata")),
            template_spec=PodSpec.from_dict(template.get("spec")),
            template_raw=copy.deepcopy(template),
            volume_claim_templates=vct,
            raw=d,
        )

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class RawObject(VersionedObject):
    """Kinds carried through but not interpreted beyond a few fields:
    Service, StorageClass, PersistentVolumeClaim, ConfigMap."""

    kind: str = ""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "RawObject":
        return cls(kind=d.get("kind", ""), metadata=ObjectMeta.from_dict(d.get("metadata")), raw=d)


@dataclass
class PodDisruptionBudget(VersionedObject):
    """Typed ``policy/v1`` PodDisruptionBudget: the campaign
    engine tracks per-step disruption budgets, so the spec fields the
    disruption controller reads — ``minAvailable`` / ``maxUnavailable``
    (absolute or percentage) and the pod ``selector`` — are parsed once
    here instead of being re-dug out of ``raw`` at every eviction check.
    ``raw`` still round-trips the full object (the preemption pass and the
    twin keep reading it like any other resource)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    #: int, ``"N%"`` string, or None — exactly one of the two is normally set
    min_available: Optional[object] = None
    max_unavailable: Optional[object] = None
    selector: Optional[dict] = None
    raw: dict = field(default_factory=dict)

    kind = "PodDisruptionBudget"

    @classmethod
    def from_dict(cls, d: dict) -> "PodDisruptionBudget":
        spec = d.get("spec") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            min_available=spec.get("minAvailable"),
            max_unavailable=spec.get("maxUnavailable"),
            selector=copy.deepcopy(spec.get("selector")),
            raw=d,
        )

    @property
    def name(self) -> str:
        return self.metadata.name

    def key(self) -> str:
        return f"{self.metadata.namespace or 'default'}/{self.metadata.name}"

    @staticmethod
    def _resolve(value, basis: int) -> int:
        """An absolute count, or ``ceil(pct · basis)`` for ``"N%"`` — the
        disruption controller's ``GetScaledValueFromIntOrPercent`` with
        round-up semantics."""
        import math

        if isinstance(value, str) and value.strip().endswith("%"):
            return int(math.ceil(float(value.strip()[:-1]) / 100.0 * basis))
        return int(value)

    def selects(self) -> bool:
        """Nil/empty selectors match nothing (``filterPodsWithPDBViolation``
        semantics — same rule the preemption pass applies)."""
        sel = self.selector or {}
        return bool(sel.get("matchLabels") or sel.get("matchExpressions"))

    def matches(self, pod: "Pod") -> bool:
        from . import selectors

        return (
            self.selects()
            and pod.metadata.namespace == (self.metadata.namespace or "default")
            and bool(pod.metadata.labels)
            and selectors.match_label_selector(self.selector, pod.metadata.labels)
        )

    def disruptions_allowed(self, healthy: int, expected: int) -> int:
        """``status.disruptionsAllowed`` from the current healthy matching
        count and the expected count (the owning workloads' declared
        replicas) — the disruption controller's arithmetic, clamped at 0.
        A PDB with neither field set allows unlimited disruptions."""
        if self.min_available is not None:
            allowed = healthy - self._resolve(self.min_available, expected)
        elif self.max_unavailable is not None:
            allowed = healthy - (expected - self._resolve(self.max_unavailable, expected))
        else:
            return 1 << 30
        return max(int(allowed), 0)


@dataclass
class ResourceTypes:
    """Parity with pkg/simulator/core.go:38-52."""

    pods: List[Pod] = field(default_factory=list)
    nodes: List[Node] = field(default_factory=list)
    deployments: List[Workload] = field(default_factory=list)
    replica_sets: List[Workload] = field(default_factory=list)
    stateful_sets: List[Workload] = field(default_factory=list)
    daemon_sets: List[Workload] = field(default_factory=list)
    jobs: List[Workload] = field(default_factory=list)
    cron_jobs: List[Workload] = field(default_factory=list)
    services: List[RawObject] = field(default_factory=list)
    pdbs: List[PodDisruptionBudget] = field(default_factory=list)
    storage_classes: List[RawObject] = field(default_factory=list)
    pvcs: List[RawObject] = field(default_factory=list)
    config_maps: List[RawObject] = field(default_factory=list)

    def add(self, obj) -> bool:
        kind = obj.kind
        dest = {
            "Pod": self.pods,
            "Node": self.nodes,
            "Deployment": self.deployments,
            "ReplicaSet": self.replica_sets,
            "StatefulSet": self.stateful_sets,
            "DaemonSet": self.daemon_sets,
            "Job": self.jobs,
            "CronJob": self.cron_jobs,
            "Service": self.services,
            "PodDisruptionBudget": self.pdbs,
            "StorageClass": self.storage_classes,
            "PersistentVolumeClaim": self.pvcs,
            "ConfigMap": self.config_maps,
        }.get(kind)
        if dest is None:
            return False
        dest.append(obj)
        return True


WORKLOAD_KINDS = {"Deployment", "ReplicaSet", "StatefulSet", "DaemonSet", "Job", "CronJob"}
RAW_KINDS = {"Service", "StorageClass", "PersistentVolumeClaim", "ConfigMap"}


def object_from_dict(d: dict):
    """Typed decode switch — parity with GetObjectFromYamlContent
    (``pkg/simulator/utils.go:233-275``). Returns None for unsupported kinds."""
    if not isinstance(d, dict):
        return None
    kind = d.get("kind", "")
    if kind == "Pod":
        return Pod.from_dict(d)
    if kind == "Node":
        return Node.from_dict(d)
    if kind in WORKLOAD_KINDS:
        return Workload.from_dict(d)
    if kind == "PodDisruptionBudget":
        return PodDisruptionBudget.from_dict(d)
    if kind in RAW_KINDS:
        return RawObject.from_dict(d)
    return None
