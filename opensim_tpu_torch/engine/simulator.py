"""Simulation facade — parity with ``pkg/simulator/core.go``.

``simulate(cluster, apps)`` mirrors ``Simulate()``
(``pkg/simulator/core.go:67-117``): expand the cluster's workloads into
pods, schedule cluster pods first, then each app in configured order, and
return which pods landed where and why the others found no node. The
whole pod stream is placed by one bind-scan kernel launch
(``ops/fast_scan.py``), which also counts, for each pod that finds no
node, the nodes each filter rejected; decode renders those counts as the
reference's kube FitError reason strings (``engine/reasons.py``).

The planner's arguments are here: a prepared input reused over a masked
node axis (``prep=``/``node_valid=``) and the opt-in preemption pass
(``enable_preemption=``, ``engine/preemption.py``). It
raises rather than falls back: ``NotImplementedError`` for an input
outside the kernel's envelope (``fastpath.why_not``) and for a scheduler
config, extra plugins, a sampled tie-break or explain mode (ROADMAP
Queue 1 item 5).
"""

from __future__ import annotations

import copy
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..encoding.state import ClusterEncoder, ClusterMeta, EncodedCluster, ScanState, to_device
from ..models import expand
from ..models.objects import (
    ANNO_GPU_ASSUME_TIME,
    ANNO_GPU_INDEX,
    ANNO_NODE_GPU_SHARE,
    ANNO_NODE_LOCAL_STORAGE,
    ANNO_WORKLOAD_KIND,
    LABEL_APP_NAME,
    LABEL_GPU_CARD_MODEL,
    Node,
    Pod,
    ResourceTypes,
)
from ..ops import fast_scan, kernels
from . import fastpath, preemption, queues, reasons


@dataclass
class AppResource:
    """Parity with core.go:54-57."""

    name: str
    resources: ResourceTypes


@dataclass
class UnscheduledPod:
    """Parity with core.go:25-28."""

    pod: Pod
    reason: str


@dataclass
class NodeStatus:
    """Parity with core.go:31-36."""

    node: Node
    pods: List[Pod] = field(default_factory=list)


@dataclass
class SimulateResult:
    """Parity with core.go:19-23, plus what the run measured: the node
    index of each pod of the stream (``placements``, -1 unplaced), the final
    per-node usage ``used [N, R]``, the GPU slots each pod took per device
    ``gpu_take [P, Gd]``, the final free memory per GPU ``gpu_free [N, Gd]``,
    the final free bytes per volume group ``vg_free [N, Vg]`` and per
    exclusive device ``dev_free [N, Dv]`` (0 once taken), and host-clock
    phase times in seconds (``timings``: prepare, inputs, kernel with the
    copies back, decode with the preemption pass), and the engine that ran
    (``engine``: the kernel variant and the device)."""

    unscheduled_pods: List[UnscheduledPod] = field(default_factory=list)
    node_status: List[NodeStatus] = field(default_factory=list)
    placements: Optional[np.ndarray] = None
    used: Optional[np.ndarray] = None
    gpu_take: Optional[np.ndarray] = None
    gpu_free: Optional[np.ndarray] = None
    vg_free: Optional[np.ndarray] = None
    dev_free: Optional[np.ndarray] = None
    timings: Dict[str, float] = field(default_factory=dict)
    engine: str = ""

    def pods_on(self, node_name: str) -> List[Pod]:
        for ns in self.node_status:
            if ns.node.metadata.name == node_name:
                return ns.pods
        return []


@dataclass
class Prepared:
    """Expanded + encoded simulation inputs: the numpy encoding
    (``ec_np``/``st0_np``) and its tensors on ``device`` (``ec``/``st0``).
    ``ds_target[p]`` is the node a DaemonSet pod is pinned to, -1 for any
    other pod. For the delta re-encoders (``engine/prepcache.py``): the
    encoder that built it (``encoder``), the length of the cluster's part of
    the stream (``n_cluster``) and the sizes of the cluster DaemonSets'
    groups, which close it (``ds_group_sizes``)."""

    ec: EncodedCluster
    st0: ScanState
    ec_np: EncodedCluster
    st0_np: ScanState
    meta: ClusterMeta
    ordered: List[Pod]
    tmpl_ids: np.ndarray
    forced: np.ndarray
    ds_target: np.ndarray
    features: kernels.Features
    device: torch.device
    encoder: ClusterEncoder
    n_cluster: int
    ds_group_sizes: List[int]


def pinned_node_name(pod: Pod) -> str:
    """Target node of a DaemonSet pod pinned via matchFields metadata.name
    (SetDaemonSetPodNodeNameByNodeAffinity semantics)."""
    aff = (pod.spec.affinity or {}).get("nodeAffinity") or {}
    required = aff.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    for term in required.get("nodeSelectorTerms") or []:
        for f in term.get("matchFields") or []:
            if f.get("key") == "metadata.name" and f.get("operator") == "In":
                vals = f.get("values") or []
                if len(vals) == 1:
                    return str(vals[0])
    return ""


def _tmpl_hint(pod: Pod) -> Optional[tuple]:
    """Cheap template-identity key for workload-owned pods: all pods of one
    workload expansion share a scheduling spec. DaemonSet pods embed their
    pinned node (each targets a different one); bare pods get no hint and
    take the full canonical path."""
    kind = pod.metadata.annotations.get(ANNO_WORKLOAD_KIND)
    name = pod.metadata.annotations.get("simon/workload-name")
    if not kind or not name:
        return None
    # the owning object's uid disambiguates same-named workloads coming from
    # different sources (cluster snapshot vs apps, or two apps)
    owner_uid = pod.metadata.owner_references[0].uid if pod.metadata.owner_references else ""
    pin = pinned_node_name(pod) if kind == "DaemonSet" else ""
    return (pod.metadata.namespace, kind, name, owner_uid, pod.spec.node_name, pin)


def _owner_selector(pod: Pod) -> Optional[dict]:
    """Selector used for system-default topology spreading: the owning
    workload's pods share identical labels, so matching on the pod's own
    labels reproduces the RS/STS selector grouping that k8s
    buildDefaultConstraints derives from the owning objects."""
    if pod.metadata.annotations.get(ANNO_WORKLOAD_KIND) and pod.metadata.labels:
        return {"matchLabels": dict(pod.metadata.labels)}
    return None


def _cluster_pods(cluster: ResourceTypes) -> Tuple[List[Pod], List[int]]:
    """GetValidPodExcludeDaemonSet (pkg/simulator/utils.go:77-230): bare
    cluster pods minus DaemonSet-owned ones (those are re-expanded per
    node), plus expanded cluster workloads. Returns ``(pods,
    ds_group_sizes)``: the DaemonSet pods form the tail, grouped in
    ``cluster.daemon_sets`` order, and the delta re-encoder splices new
    nodes' DaemonSet pods in by these sizes."""
    ds_names = {(d.metadata.namespace, d.metadata.name) for d in cluster.daemon_sets}
    bare = [
        p
        for p in cluster.pods
        if not any(
            r.kind == "DaemonSet" and (p.metadata.namespace, r.name) in ds_names
            for r in p.metadata.owner_references
        )
    ]
    rt = ResourceTypes(
        pods=bare,
        deployments=cluster.deployments,
        replica_sets=cluster.replica_sets,
        stateful_sets=cluster.stateful_sets,
        jobs=cluster.jobs,
        cron_jobs=cluster.cron_jobs,
    )
    pods = expand.generate_pods_from_resources(rt, cluster.nodes, include_daemon_sets=False)
    ds_group_sizes: List[int] = []
    for ds in cluster.daemon_sets:
        group = expand.pods_from_daemon_set(ds, cluster.nodes)
        ds_group_sizes.append(len(group))
        pods.extend(group)
    return pods, ds_group_sizes


def ds_targets(ordered: List[Pod], meta: ClusterMeta) -> np.ndarray:
    """The node each DaemonSet pod of the stream is pinned to, -1 for any
    other pod: only DaemonSet expansion pins a pod by matchFields
    metadata.name, and a bare pinned pod is not a DaemonSet pod (the drain
    and candidate masks rely on it)."""
    node_idx = {name: i for i, name in enumerate(meta.node_names)}
    return np.array(
        [
            node_idx.get(pinned_node_name(p), -1) if p.metadata.annotations.get(ANNO_WORKLOAD_KIND) == "DaemonSet"
            else -1
            for p in ordered
        ],
        dtype=np.int32,
    )


def prepare(
    cluster: ResourceTypes,
    apps: List[AppResource],
    use_greed: bool = False,
    node_pad: int = 1,
    device: DeviceLike = None,
) -> Optional[Prepared]:
    """Expand cluster + app workloads into an ordered pod stream and encode
    it; the tensors go to `device` (the card unless the caller names
    another). The node axis is padded to a multiple of `node_pad` with
    invalid nodes (1: no padding). Returns None when there are no pods."""
    device = resolve_device(device)
    enc = ClusterEncoder(node_pad=node_pad)
    enc.add_nodes(cluster.nodes)

    ordered, ds_group_sizes = _cluster_pods(cluster)
    n_cluster = len(ordered)
    for app in apps:
        app_pods = expand.generate_pods_from_resources(app.resources, cluster.nodes)
        for p in app_pods:
            p.metadata.labels.setdefault(LABEL_APP_NAME, app.name)
        # simulator.go:238-241: affinity sort then toleration sort
        app_pods = queues.toleration_sort(queues.affinity_sort(app_pods))
        if use_greed:
            app_pods = queues.greed_sort(cluster.nodes, app_pods)
        ordered.extend(app_pods)
    if not ordered:
        return None

    # pods of one workload share a template: the hint short-circuits
    # canonical extraction and the lazy selector callable skips the per-pod
    # dict build on hint hits
    tmpl_ids = np.array(
        [enc.add_pod(p, (lambda p=p: _owner_selector(p)), hint=_tmpl_hint(p)) for p in ordered],
        dtype=np.int32,
    )
    ec_np, st0_np, meta = enc.build()
    ec, st0 = to_device(ec_np, st0_np, device)
    return Prepared(
        ec=ec,
        st0=st0,
        ec_np=ec_np,
        st0_np=st0_np,
        meta=meta,
        ordered=ordered,
        tmpl_ids=tmpl_ids,
        forced=np.array([bool(p.spec.node_name) for p in ordered], dtype=bool),
        ds_target=ds_targets(ordered, meta),
        features=kernels.features_of(ec_np),
        device=device,
        encoder=enc,
        n_cluster=n_cluster,
        ds_group_sizes=ds_group_sizes,
    )


def _later_slice(sched_config, extra_plugins, tie_seed, explain) -> None:
    """Raise for the arguments whose engine paths the port has not yet:
    ROADMAP Queue 1 item 5 (scheduler-config surfaces)."""
    for name, given in (("sched_config", sched_config is not None), ("extra_plugins", bool(extra_plugins)),
                        ("tie_seed", tie_seed is not None), ("explain", bool(explain))):
        if given:
            raise NotImplementedError(
                f"simulate({name}=...): scheduler-config surfaces are ROADMAP Queue 1 item 5, not yet ported"
            )


def _pod_valid(prep: Prepared, cluster: ResourceTypes, node_valid) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The stream's pod-validity mask and the masked node axis, checked as
    the reference checks them (``opensim_tpu/engine/simulator.py:889-916``):
    `node_valid` must select exactly ``cluster.nodes`` as a prefix of the
    prepared node order, and DaemonSet pods pinned to a masked-out node
    leave the stream, as a fresh expansion of the sub-cluster would never
    create them."""
    pod_valid = np.ones((len(prep.ordered),), dtype=bool)
    if node_valid is None:
        return pod_valid, None
    nv_mask = np.asarray(node_valid, dtype=bool)
    if nv_mask.shape[0] != int(np.asarray(prep.ec_np.node_valid).shape[0]):
        raise ValueError("node_valid mask must cover the prepared (padded) node axis")
    names = [n.metadata.name for n in cluster.nodes]
    if names != list(prep.meta.node_names[: len(names)]):
        raise ValueError("cluster.nodes must be the valid prefix of the prepared node order")
    n_valid = int(nv_mask.sum())
    if n_valid != len(names) or not nv_mask[:n_valid].all():
        raise ValueError("node_valid must select exactly cluster.nodes as a prefix")
    pinned = prep.ds_target >= 0
    pod_valid[pinned] &= nv_mask[prep.ds_target[pinned]]
    return pod_valid, nv_mask


def simulate(
    cluster: ResourceTypes,
    apps: List[AppResource],
    use_greed: bool = False,
    node_pad: int = 1,
    device: DeviceLike = None,
    sched_config=None,
    extra_plugins: tuple = (),
    enable_preemption: bool = False,
    tie_seed: Optional[int] = None,
    prep: Optional[Prepared] = None,
    node_valid: Optional[np.ndarray] = None,
    explain: bool = False,
) -> SimulateResult:
    """One full simulation: cluster pods then apps in order, all placed by
    the bind-scan kernel on `device` (the card unless the caller names
    another device; the CPU runs the kernel's plain version).

    `prep`/`node_valid` (the planner's reuse): run over an existing
    Prepared (on its device) with the node axis masked down to
    `node_valid`; ``cluster.nodes`` must be exactly the valid prefix of the
    prepared node order. Placements, reasons and node annotations equal a
    fresh prepare of the sub-cluster's. `enable_preemption` runs the
    preemption pass over the kernel's final state (not with `prep`)."""
    _later_slice(sched_config, extra_plugins, tie_seed, explain)
    if prep is not None and enable_preemption:
        raise ValueError("prep reuse does not support enable_preemption; pass prep=None")
    t0 = time.perf_counter()
    if prep is None:
        prep = prepare(cluster, apps, use_greed=use_greed, node_pad=node_pad, device=device)
    if prep is None:
        return SimulateResult(node_status=[NodeStatus(node=n, pods=[]) for n in cluster.nodes])
    pod_valid, nv_mask = _pod_valid(prep, cluster, node_valid)
    miss = fastpath.why_not(prep)
    if miss is not None:
        raise NotImplementedError(f"outside the port's bind-scan envelope: {miss}")
    t1 = time.perf_counter()
    built = fastpath.build_inputs(prep, nv_mask)
    if prep.device.type == "cuda":
        torch.cuda.synchronize(prep.device)
    t2 = time.perf_counter()
    out = fastpath.schedule(prep, built, pod_valid=pod_valid)  # host copies: the card is done
    t3 = time.perf_counter()
    victims_of: Dict[int, int] = {}
    if enable_preemption and (out.chosen[~prep.forced] < 0).any():
        out, victims_of = _preempt(prep, out, cluster, apps, pod_valid)
    n_nodes = prep.meta.n_real_nodes if nv_mask is None else int(nv_mask.sum())
    statuses, unscheduled = _decode(prep, out, cluster.nodes, pod_valid, n_nodes, victims_of)
    t4 = time.perf_counter()
    return SimulateResult(
        unscheduled_pods=unscheduled,
        node_status=statuses,
        placements=out.chosen,
        used=out.used,
        gpu_take=out.gpu_take,
        gpu_free=out.gpu_free,
        vg_free=out.vg_free,
        dev_free=out.dev_free,
        timings={"prepare": t1 - t0, "inputs": t2 - t1, "kernel": t3 - t2, "decode": t4 - t3},
        engine=f"{fast_scan.variant_name(built[0])} on {prep.device.type}",
    )


def _preempt(prep: Prepared, out: fastpath.Scheduled, cluster: ResourceTypes, apps: List[AppResource],
             pod_valid: np.ndarray) -> Tuple[fastpath.Scheduled, Dict[int, int]]:
    """The preemption pass over copies of the scan's final state (the
    encoder's layouts, as ``fastpath.schedule`` returns them); returns the
    updated result and the victims, each with its preemptor."""
    state = {name: np.array(getattr(out, name), copy=True)
             for name in ("used", "gpu_take", "port_used", "gpu_free", "vg_free", "dev_free")}
    pdbs = tuple(cluster.pdbs) + tuple(pdb for app in apps for pdb in app.resources.pdbs)
    chosen, victims_of = preemption.preempt_pass(
        prep, out.chosen, cluster.nodes, alloc=np.asarray(prep.ec_np.alloc), pdbs=pdbs, eligible=pod_valid, **state,
    )
    return out._replace(chosen=chosen, **state), victims_of


def _reason_string(
    static_fail: np.ndarray,
    fail_counts: np.ndarray,
    insufficient: np.ndarray,
    meta: ClusterMeta,
    n_nodes: int,
) -> str:
    """The kube-scheduler FitError message the reference surfaces (e.g.
    '0/4 nodes are available: 3 node(s) had taints...'), rendered through
    the registered reason codes (engine/reasons.py). static_fail covers the
    4 template-static filters, fail_counts the usage-dependent ones."""
    counts = reasons.counts_from_rows(static_fail, fail_counts, insufficient, meta.resource_names)
    return reasons.render_unschedulable(n_nodes, counts)


def _decode(
    prep: Prepared, out: fastpath.Scheduled, nodes: List[Node], active: np.ndarray, n_nodes: int,
    victims_of: Dict[int, int],
) -> Tuple[List[NodeStatus], List[UnscheduledPod]]:
    """One numpy pass splits the stream's `active` pods (the valid ones)
    into placed and failed pods (the reference's ``_decode``). Each placed
    pod goes into its node's bucket, in stream order, with the GPU devices
    it took; each failed pod gets its reason, in stream order: a forced
    pod's node was not found, a preemption victim names its preemptor, any
    other pod gets the FitError rendering of its counts over the `n_nodes`
    valid nodes. Returns the node statuses, whose annotations show the
    final GPU and local-storage state, and the unscheduled pods."""
    node_pods: Dict[str, List[Pod]] = {n.metadata.name: [] for n in nodes}
    # a masked run's nodes past the valid prefix have no bucket (no pod lands there)
    pod_lists = [node_pods.get(n) for n in prep.meta.node_names]
    gpu_any = (out.gpu_take.sum(axis=1) > 0).tolist()
    chosen = out.chosen
    placed_idx = np.nonzero(active & (chosen >= 0))[0]
    failed_idx = np.nonzero(active & (chosen < 0))[0]
    for i, c in zip(placed_idx.tolist(), chosen[placed_idx].astype(int).tolist()):
        pod = prep.ordered[i]
        pod.spec.node_name = prep.meta.node_names[c]
        pod.phase = "Running"
        if gpu_any[i]:
            # gpu-index parity (GetUpdatedPodAnnotationSpec, gpushare
            # utils/pod.go:116-127): one device id per packed slot, and the
            # bind time in nanoseconds
            ids: List[str] = []
            for d, cnt in enumerate(out.gpu_take[i].tolist()):
                ids.extend([str(d)] * int(round(cnt)))
            pod.metadata.annotations[ANNO_GPU_INDEX] = "-".join(ids)
            pod.metadata.annotations[ANNO_GPU_ASSUME_TIME] = str(time.time_ns())
        pod_lists[c].append(pod)
    unscheduled: List[UnscheduledPod] = []
    for i in failed_idx.tolist():
        pod = prep.ordered[i]
        if prep.forced[i]:
            reason = reasons.node_not_found(pod.spec.node_name)
        elif i in victims_of:
            preemptor = prep.ordered[victims_of[i]]
            reason = reasons.preempted(preemptor.metadata.namespace, preemptor.metadata.name)
        else:
            reason = _reason_string(out.static_fail[prep.tmpl_ids[i]], out.fail_counts[i], out.insufficient[i],
                                    prep.meta, n_nodes)
        unscheduled.append(UnscheduledPod(pod, reason))
    statuses = _node_statuses(nodes, node_pods, prep.meta, out.gpu_free, out.vg_free, out.dev_free)
    return statuses, unscheduled


def snapshot_bind_state(prep: Prepared) -> list:
    """Everything :func:`_decode` changes on the prepared pods, so that a
    caller running several simulations over one Prepared (the planner:
    the first simulation, then the delta re-encode that reuses its pods)
    can restore them between runs. Kept next to ``_decode``: a new
    bind-time change to a pod goes into both."""
    return [
        (
            p.spec.node_name,
            p.phase,
            p.metadata.annotations.get(ANNO_GPU_INDEX),
            p.metadata.annotations.get(ANNO_GPU_ASSUME_TIME),
        )
        for p in prep.ordered
    ]


def restore_bind_state(prep: Prepared, snap: list) -> None:
    for p, (node_name, phase, gpu_idx, assume) in zip(prep.ordered, snap):
        p.spec.node_name = node_name
        p.phase = phase
        for key, value in ((ANNO_GPU_INDEX, gpu_idx), (ANNO_GPU_ASSUME_TIME, assume)):
            if value is None:
                p.metadata.annotations.pop(key, None)
            else:
                p.metadata.annotations[key] = value


def _node_statuses(
    nodes: List[Node],
    node_pods: Dict[str, List[Pod]],
    meta: ClusterMeta,
    gpu_free: np.ndarray,
    vg_free: np.ndarray,
    dev_free: np.ndarray,
) -> List[NodeStatus]:
    """Write final storage/GPU usage back into node annotations — parity
    with the Bind plugins updating the fake cluster's node objects
    (open-local.go:175-254 writes simon/node-local-storage;
    open-gpu-share.go Reserve writes simon/node-gpu-share)."""
    statuses: List[NodeStatus] = []
    for idx, orig in enumerate(nodes):
        # shallow-copy the node and give it fresh metadata so the caller's
        # objects stay untouched without deep-copying 5k raw dicts
        node = copy.copy(orig)
        node.metadata = copy.copy(orig.metadata)
        node.metadata.annotations = dict(orig.metadata.annotations)
        node.metadata.labels = dict(orig.metadata.labels)
        pods = node_pods[node.metadata.name]
        vg_names = meta.node_vg_names[idx] if idx < len(meta.node_vg_names) else []
        dev_names = meta.node_dev_names[idx] if idx < len(meta.node_dev_names) else []
        if vg_names or dev_names:
            vgs = []
            for j, name in enumerate(vg_names):
                cap = float(meta.node_vg_cap[idx, j])
                vgs.append({"name": name, "capacity": int(cap), "requested": int(cap - vg_free[idx, j])})
            devices = []
            for j, name in enumerate(dev_names):
                devices.append(
                    {
                        "name": name,
                        "device": name,
                        "capacity": int(meta.node_dev_cap[idx, j]),
                        "mediaType": "ssd" if int(meta.node_dev_media[idx, j]) == 0 else "hdd",
                        "isAllocated": bool(dev_free[idx, j] == 0 and meta.node_dev_cap[idx, j] > 0),
                    }
                )
            node.metadata.annotations[ANNO_NODE_LOCAL_STORAGE] = json.dumps({"vgs": vgs, "devices": devices})
        gpu_count = int(meta.node_gpu_count[idx]) if meta.node_gpu_count is not None else 0
        if gpu_count > 0:
            devs = {}
            for d in range(gpu_count):
                total = float(meta.node_gpu_mem[idx, d])
                devs[str(d)] = {
                    "GpuTotalMemory": int(total),
                    "GpuUsedMemory": int(total - gpu_free[idx, d]),
                    "PodList": [p.metadata.name for p in pods if _pod_uses_device(p, d)],
                }
            info = {
                "GpuCount": gpu_count,
                "GpuTotalMemory": int(sum(v["GpuTotalMemory"] for v in devs.values())),
                "GpuModel": node.metadata.labels.get(LABEL_GPU_CARD_MODEL, "N/A"),
                "NumPods": sum(1 for p in pods if ANNO_GPU_INDEX in p.metadata.annotations),
                "DevsBrief": devs,
            }
            node.metadata.annotations[ANNO_NODE_GPU_SHARE] = json.dumps(info)
        statuses.append(NodeStatus(node=node, pods=pods))
    return statuses


def _pod_uses_device(pod: Pod, device: int) -> bool:
    idx = pod.metadata.annotations.get(ANNO_GPU_INDEX, "")
    return str(device) in idx.split("-") if idx else False

