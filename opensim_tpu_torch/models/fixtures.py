"""Test fixture builders — parity with ``pkg/test`` (MakeFakePod/Node/... with
functional ``With*`` options, e.g. ``pkg/test/node.go:15-40``,
``pkg/test/pod.go:13-47``)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from .objects import (
    ANNO_NODE_LOCAL_STORAGE,
    ANNO_POD_LOCAL_STORAGE,
    Node,
    Pod,
    ResourceTypes,
    Workload,
    object_from_dict,
)

Option = Callable[[dict], None]


# -- pod/template options ----------------------------------------------------

def with_labels(labels: Dict[str, str]) -> Option:
    def apply(d: dict) -> None:
        d.setdefault("metadata", {}).setdefault("labels", {}).update(labels)

    return apply


def with_annotations(annotations: Dict[str, str]) -> Option:
    def apply(d: dict) -> None:
        d.setdefault("metadata", {}).setdefault("annotations", {}).update(annotations)

    return apply


def with_namespace(ns: str) -> Option:
    def apply(d: dict) -> None:
        d.setdefault("metadata", {})["namespace"] = ns

    return apply


def _pod_template(d: dict) -> dict:
    if d.get("kind") == "CronJob":
        return d["spec"]["jobTemplate"]["spec"].setdefault("template", {})
    return d["spec"].setdefault("template", {})


def _pod_spec(d: dict) -> dict:
    # For workloads, options target the pod template.
    if d.get("kind") in ("Deployment", "ReplicaSet", "StatefulSet", "DaemonSet", "Job", "CronJob"):
        return _pod_template(d).setdefault("spec", {})
    return d.setdefault("spec", {})


def _pod_meta(d: dict) -> dict:
    if d.get("kind") in ("Deployment", "ReplicaSet", "StatefulSet", "DaemonSet", "Job", "CronJob"):
        return _pod_template(d).setdefault("metadata", {})
    return d.setdefault("metadata", {})


def with_pod_labels(labels: Dict[str, str]) -> Option:
    def apply(d: dict) -> None:
        _pod_meta(d).setdefault("labels", {}).update(labels)

    return apply


def with_node_name(name: str) -> Option:
    def apply(d: dict) -> None:
        _pod_spec(d)["nodeName"] = name

    return apply


def with_scheduler_name(name: str) -> Option:
    """The scheduler profile (``spec.schedulerName``) a pod selects."""
    def apply(d: dict) -> None:
        _pod_spec(d)["schedulerName"] = name

    return apply


def with_node_selector(sel: Dict[str, str]) -> Option:
    def apply(d: dict) -> None:
        _pod_spec(d).setdefault("nodeSelector", {}).update(sel)

    return apply


def with_tolerations(tolerations: List[dict]) -> Option:
    def apply(d: dict) -> None:
        _pod_spec(d).setdefault("tolerations", []).extend(tolerations)

    return apply


def with_affinity(affinity: dict) -> Option:
    def apply(d: dict) -> None:
        # merge at the top level so nodeAffinity and podAffinity options
        # compose instead of the last call replacing the whole dict
        _pod_spec(d).setdefault("affinity", {}).update(affinity)

    return apply


def with_requests(requests: Dict[str, str]) -> Option:
    def apply(d: dict) -> None:
        spec = _pod_spec(d)
        for c in spec.setdefault("containers", []):
            c.setdefault("resources", {}).setdefault("requests", {}).update(requests)

    return apply


def with_host_ports(ports: List[int]) -> Option:
    def apply(d: dict) -> None:
        spec = _pod_spec(d)
        for c in spec.setdefault("containers", []):
            c.setdefault("ports", []).extend(
                {"hostPort": p, "containerPort": p, "protocol": "TCP"} for p in ports
            )

    return apply


def with_priority(priority: int) -> Option:
    def apply(d: dict) -> None:
        _pod_spec(d)["priority"] = int(priority)

    return apply


def with_host_port_specs(specs: List[dict]) -> Option:
    """Full container-port dicts (hostPort/protocol/hostIP)."""

    def apply(d: dict) -> None:
        spec = _pod_spec(d)
        for c in spec.setdefault("containers", []):
            c.setdefault("ports", []).extend(dict(p) for p in specs)

    return apply


def with_topology_spread(constraints: List[dict]) -> Option:
    def apply(d: dict) -> None:
        _pod_spec(d)["topologySpreadConstraints"] = constraints

    return apply


def with_pod_local_storage(volumes_json: str) -> Option:
    return with_annotations({ANNO_POD_LOCAL_STORAGE: volumes_json})


def with_volume_claims(claims: List[tuple]) -> Option:
    """A StatefulSet's volumeClaimTemplates, one per (name, storage class,
    size); the open-local classes become local volumes of its pods."""

    def apply(d: dict) -> None:
        d["spec"]["volumeClaimTemplates"] = [
            {"metadata": {"name": name},
             "spec": {"storageClassName": sc, "resources": {"requests": {"storage": size}}}}
            for name, sc, size in claims
        ]

    return apply


# -- node options ------------------------------------------------------------

def with_taints(taints: List[dict]) -> Option:
    def apply(d: dict) -> None:
        d.setdefault("spec", {}).setdefault("taints", []).extend(taints)

    return apply


def with_node_local_storage(vgs: Optional[List[dict]] = None, devices: Optional[List[dict]] = None) -> Option:
    """WithNodeLocalStorage (pkg/test/node.go:64-69): the
    simon/node-local-storage annotation JSON."""
    payload = json.dumps({"vgs": vgs or [], "devices": devices or []})
    return with_annotations({ANNO_NODE_LOCAL_STORAGE: payload})


def with_allocatable(alloc: Dict[str, str]) -> Option:
    def apply(d: dict) -> None:
        d.setdefault("status", {}).setdefault("allocatable", {}).update(alloc)
        d.setdefault("status", {}).setdefault("capacity", {}).update(alloc)

    return apply


# -- builders ----------------------------------------------------------------

def make_fake_pod(name: str, cpu: str = "100m", memory: str = "128Mi", *options: Option) -> Pod:
    """MakeFakePod (pkg/test/pod.go:13-47): defaults an nginx container."""
    d = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {
            "containers": [
                {
                    "name": "nginx",
                    "image": "nginx:latest",
                    "resources": {"requests": {"cpu": cpu, "memory": memory}},
                }
            ]
        },
    }
    for opt in options:
        opt(d)
    return Pod.from_dict(d)


def make_fake_node(name: str, cpu: str = "32", memory: str = "64Gi", pods: str = "110", *options: Option) -> Node:
    """MakeFakeNode (pkg/test/node.go:15-40): default 110-pod capacity."""
    d = {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
        "status": {
            "allocatable": {"cpu": cpu, "memory": memory, "pods": pods},
            "capacity": {"cpu": cpu, "memory": memory, "pods": pods},
        },
    }
    for opt in options:
        opt(d)
    return Node.from_dict(d)


def _make_workload(kind: str, name: str, replicas: int, cpu: str, memory: str, *options: Option) -> Workload:
    labels = {"app": name}
    d = {
        "apiVersion": "apps/v1" if kind in ("Deployment", "ReplicaSet", "StatefulSet", "DaemonSet") else "batch/v1",
        "kind": kind,
        "metadata": {"name": name, "namespace": "default", "labels": dict(labels)},
        "spec": {
            "selector": {"matchLabels": dict(labels)},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {
                    "containers": [
                        {
                            "name": "nginx",
                            "image": "nginx:latest",
                            "resources": {"requests": {"cpu": cpu, "memory": memory}},
                        }
                    ]
                },
            },
        },
    }
    if kind in ("Deployment", "ReplicaSet", "StatefulSet"):
        d["spec"]["replicas"] = replicas
    elif kind == "Job":
        d["spec"]["completions"] = replicas
        d["spec"].pop("selector")
    for opt in options:
        opt(d)
    return Workload.from_dict(d)


def make_fake_deployment(name: str, replicas: int = 1, cpu: str = "100m", memory: str = "128Mi", *options: Option) -> Workload:
    return _make_workload("Deployment", name, replicas, cpu, memory, *options)


def make_fake_replica_set(name: str, replicas: int = 1, cpu: str = "100m", memory: str = "128Mi", *options: Option) -> Workload:
    return _make_workload("ReplicaSet", name, replicas, cpu, memory, *options)


def make_fake_stateful_set(name: str, replicas: int = 1, cpu: str = "100m", memory: str = "128Mi", *options: Option) -> Workload:
    return _make_workload("StatefulSet", name, replicas, cpu, memory, *options)


def make_fake_daemon_set(name: str, cpu: str = "100m", memory: str = "128Mi", *options: Option) -> Workload:
    return _make_workload("DaemonSet", name, 1, cpu, memory, *options)


def make_fake_job(name: str, completions: int = 1, cpu: str = "100m", memory: str = "128Mi", *options: Option) -> Workload:
    return _make_workload("Job", name, completions, cpu, memory, *options)


def make_fake_cron_job(name: str, completions: int = 1, cpu: str = "100m", memory: str = "128Mi", *options: Option) -> Workload:
    job = _make_workload("Job", name, completions, cpu, memory)
    d = {
        "apiVersion": "batch/v1beta1",
        "kind": "CronJob",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"schedule": "* * * * *", "jobTemplate": {"spec": job.raw["spec"]}},
    }
    for opt in options:
        opt(d)
    return Workload.from_dict(d)


# -- generated clusters ---------------------------------------------------------

def _fleet_node(i: int, *options: Option) -> Node:
    """Node i of the capacity plan's fleet (bench.py:85-104)."""
    zones = [f"zone-{z}" for z in range(4)]
    return make_fake_node(
        f"node-{i:05d}", "64", "256Gi", "256",
        with_labels({
            "topology.kubernetes.io/zone": zones[i % len(zones)],
            "node-role.kubernetes.io/worker": "",
            "disk": "ssd" if i % 3 else "hdd",
        }),
        *options,
    )


def synthetic_cluster(n_nodes: int) -> ResourceTypes:
    """The capacity plan's fleet (bench.py:85-104): identical 64-core /
    256 GiB / 256-pod nodes, 4 zones, a `disk` label on every node."""
    rt = ResourceTypes()
    rt.nodes.extend(_fleet_node(i) for i in range(n_nodes))
    return rt


def _plan_workload(w: int) -> tuple:
    """(cpu, memory, options) of workload w of the capacity plan
    (bench.py:107-135): node selectors on every fourth, soft zone spread on
    every fifth."""
    opts = []
    if w % 4 == 0:
        opts.append(with_node_selector({"disk": "ssd"}))
    if w % 5 == 0:
        opts.append(with_topology_spread([{
            "maxSkew": 5,
            "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "ScheduleAnyway",
            "labelSelector": {"matchLabels": {"app": f"bench-{w}"}},
        }]))
    return f"{100 + 20 * (w % 8)}m", f"{256 + 64 * (w % 6)}Mi", opts


def synthetic_apps(n_pods: int) -> ResourceTypes:
    """The capacity plan's workload (bench.py:107-135): 20 Deployments,
    node selectors on every fourth, soft zone spread on every fifth."""
    rt = ResourceTypes()
    n_workloads = 20
    per = n_pods // n_workloads
    for w in range(n_workloads):
        cpu, memory, opts = _plan_workload(w)
        rt.deployments.append(make_fake_deployment(f"bench-{w}", per, cpu, memory, *opts))
    return rt


def affinity_apps(n_pods: int, max_skew: int = 3) -> ResourceTypes:
    """The affinity-heavy plan's workload (bench.py:454-506, BASELINE.md
    config 4): 10 Deployments of ``n_pods // 10`` pods, each under a hard
    zone spread (maxSkew 3); the even ones prefer not to share a host with
    their own pods (preferred anti-affinity, weight 100), and each odd one
    requires a zone that holds its even neighbour's pods. At maxSkew 3 no
    node fails the spread filter on the synthetic fleet; `max_skew` 1
    makes it reject nodes on most binding steps (explain mode's cell)."""
    rt = ResourceTypes()
    n_workloads = 10
    per = n_pods // n_workloads
    for w in range(n_workloads):
        opts = [with_topology_spread([{
            "maxSkew": max_skew,
            "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": f"aff-{w}"}},
        }])]
        if w % 2 == 0:
            opts.append(with_affinity({"podAntiAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [{
                "weight": 100,
                "podAffinityTerm": {
                    "labelSelector": {"matchLabels": {"app": f"aff-{w}"}},
                    "topologyKey": "kubernetes.io/hostname",
                },
            }]}}))
        else:
            opts.append(with_affinity({"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
                "labelSelector": {"matchLabels": {"app": f"aff-{w - 1}"}},
                "topologyKey": "topology.kubernetes.io/zone",
            }]}}))
        rt.deployments.append(make_fake_deployment(f"aff-{w}", per, "100m", "256Mi", *opts))
    return rt


_AVOID_RS = json.dumps({"preferAvoidPods": [{"podSignature": {"podController": {
    "apiVersion": "apps/v1", "kind": "ReplicaSet", "name": "avoided",
    "uid": "rs-avoided", "controller": True}}}]})


def _avoided_replica_set(replicas: int, cpu: str, memory: str, *options: Option) -> Workload:
    """A ReplicaSet of fixed uid, so that a node's preferAvoidPods
    annotation can name it."""
    return make_fake_replica_set("avoided", replicas, cpu, memory,
                                 lambda d: d["metadata"].update(uid="rs-avoided"), *options)


def score_cluster(n_nodes: int, blocked: int = 0) -> ResourceTypes:
    """The capacity plan's fleet with the score tables' inputs: a
    PreferNoSchedule taint on every eighth node, and every eighth node
    (another set) prefers to avoid the ReplicaSet ``avoided``; with
    `blocked`, every `blocked`-th node also carries a NoSchedule taint that
    no pod tolerates (the config plan: its config turns that filter off)."""
    rt = ResourceTypes()
    for i in range(n_nodes):
        opts = []
        if blocked and i % blocked == 0:
            opts.append(with_taints([{"key": "block", "value": "x", "effect": "NoSchedule"}]))
        if i % 8 == 0:
            opts.append(with_taints([{"key": "soft", "value": "x", "effect": "PreferNoSchedule"}]))
        if i % 8 == 4:
            opts.append(with_annotations({"scheduler.alpha.kubernetes.io/preferAvoidPods": _AVOID_RS}))
        rt.nodes.append(_fleet_node(i, *opts))
    return rt


def score_apps(n_pods: int, host_port: bool = False, widget: bool = False) -> ResourceTypes:
    """The capacity plan's workload with the score tables' inputs: 20
    workloads of ``n_pods // 20`` pods with its node selectors and soft
    zone spread, preferred ``disk=ssd`` node affinity (weight 50) on every
    third, and workload 4 the ReplicaSet ``avoided``, which tolerates the
    soft taint; with `host_port`, Deployment 0 also asks host port 8080;
    with `widget`, Deployment 1 also asks one ``example.com/widget``, which
    no node offers (the config plan: its config ignores that resource).
    The queue sorts put the tolerating pods first and the node-selector
    pods next, so both lead the stream."""
    rt = ResourceTypes()
    n_workloads = 20
    per = n_pods // n_workloads
    for w in range(n_workloads):
        cpu, memory, opts = _plan_workload(w)
        if w % 3 == 0:
            opts.append(with_affinity({"nodeAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 50, "preference": {"matchExpressions": [
                    {"key": "disk", "operator": "In", "values": ["ssd"]}]}},
            ]}}))
        if host_port and w == 0:
            opts.append(with_host_ports([8080]))
        if widget and w == 1:
            opts.append(with_requests({WIDGET: "1"}))
        if w == 4:
            opts.append(with_tolerations([{"key": "soft", "operator": "Exists", "effect": "PreferNoSchedule"}]))
            rt.replica_sets.append(_avoided_replica_set(per, cpu, memory, *opts))
        else:
            rt.deployments.append(make_fake_deployment(f"bench-{w}", per, cpu, memory, *opts))
    return rt


#: The extended resource of the config plan, which no node offers.
WIDGET = "example.com/widget"

#: KubeSchedulerConfiguration files of the card plans, in the format
#: ``engine/schedconfig.py`` parses. The config plan's: every setting
#: decides placements on the config plan (score_cluster(n, blocked=10),
#: score_apps(n, widget=True)): the TaintToleration filter off, the
#: NodeResourcesBalancedAllocation and NodePreferAvoidPods scores off,
#: NodeResourcesLeastAllocated at weight 3, NodeAffinity at 2,
#: PodTopologySpread at 1, and the widget ignored by the fit filter.
SCHED_CONFIG_PLAN = f"""apiVersion: kubescheduler.config.k8s.io/v1beta1
kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: default-scheduler
    plugins:
      filter:
        disabled:
          - name: TaintToleration
      score:
        disabled:
          - name: NodeResourcesBalancedAllocation
          - name: NodePreferAvoidPods
        enabled:
          - name: NodeResourcesLeastAllocated
            weight: 3
          - name: NodeAffinity
            weight: 2
          - name: PodTopologySpread
            weight: 1
    pluginConfig:
      - name: NodeResourcesFit
        args:
          ignoredResources:
            - {WIDGET}
"""
#: The two-profile plan's: ``default-scheduler`` with LeastAllocated at
#: weight 3; ``batch`` with BalancedAllocation at 5 and no spread score.
SCHED_TWO_PROFILES = """apiVersion: kubescheduler.config.k8s.io/v1beta1
kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: default-scheduler
    plugins:
      score:
        enabled:
          - name: NodeResourcesLeastAllocated
            weight: 3
  - schedulerName: batch
    plugins:
      score:
        disabled:
          - name: PodTopologySpread
        enabled:
          - name: NodeResourcesBalancedAllocation
            weight: 5
"""
#: ``simon apply -d`` on the apply plan: the config plan's settings that
#: apply to the capacity fleet (no taints, preferred node affinity,
#: avoided controllers or widgets there).
SCHED_APPLY = """apiVersion: kubescheduler.config.k8s.io/v1beta1
kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: default-scheduler
    plugins:
      score:
        disabled:
          - name: NodeResourcesBalancedAllocation
        enabled:
          - name: NodeResourcesLeastAllocated
            weight: 3
          - name: PodTopologySpread
            weight: 1
"""


def write_scheduler_config(path, text: str) -> str:
    """Write a KubeSchedulerConfiguration (one of the SCHED_* texts) to
    `path`, creating its directory; returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return str(path)


def two_profile_apps(n_pods: int) -> List[Tuple[str, ResourceTypes]]:
    """The two-profile plan's apps, in order, as (name, resources): the
    capacity plan's 20 Deployments (:func:`synthetic_apps`), the first ten
    in ``plan`` and the last ten, selecting the ``batch`` profile, in
    ``batch``. Each app's pods are sorted on their own, so the batch pods,
    the second half, stay contiguous: two profile segments."""
    per = n_pods // 20
    apps = []
    for name, ws, opts in (("plan", range(10), ()), ("batch", range(10, 20), (with_scheduler_name("batch"),))):
        rt = ResourceTypes()
        for w in ws:
            cpu, memory, w_opts = _plan_workload(w)
            rt.deployments.append(make_fake_deployment(f"bench-{w}", per, cpu, memory, *w_opts, *opts))
        apps.append((name, rt))
    return apps


def bigu_apps(n_pods: int, n_templates: int = 1000) -> ResourceTypes:
    """The template-heavy workload (bench.py:138-149): `n_templates`
    Deployments of distinct requests, ``n_pods // n_templates`` pods each
    (at least one)."""
    rt = ResourceTypes()
    per = max(n_pods // n_templates, 1)
    for w in range(n_templates):
        rt.deployments.append(
            make_fake_deployment(f"t{w:04d}", per, f"{100 + (w % 400)}m", f"{128 + (w % 97)}Mi")
        )
    return rt


def _tmpl_annotate(deploy: Workload, anno: Dict[str, str]) -> None:
    """Pod-template annotations on a workload (bench.py:165-171): gpu-share
    and open-local pod requests live on the pod template, not on the
    controller's metadata. The manifest (`raw`) carries them too."""
    deploy.template_metadata.annotations.update(anno)
    deploy.template_raw.setdefault("metadata", {}).setdefault("annotations", {}).update(anno)
    _pod_template(deploy.raw).setdefault("metadata", {}).setdefault("annotations", {}).update(anno)


def gpu_cluster(n_nodes: int) -> ResourceTypes:
    """The all-GPU fleet (bench.py:174-191): the plan's 64-core / 256 GiB /
    256-pod nodes in 4 zones, each advertising 8 gpu-share devices of 8 GiB
    (per-device memory = gpu-mem / gpu-count)."""
    rt = ResourceTypes()
    zones = [f"zone-{z}" for z in range(4)]
    for i in range(n_nodes):
        rt.nodes.append(
            make_fake_node(
                f"node-{i:05d}", "64", "256Gi", "256",
                with_labels({"topology.kubernetes.io/zone": zones[i % len(zones)]}),
                with_allocatable({
                    "alibabacloud.com/gpu-mem": "64Gi",
                    "alibabacloud.com/gpu-count": "8",
                }),
            )
        )
    return rt


def gpu_apps(n_pods: int) -> ResourceTypes:
    """The all-GPU workload (bench.py:194-217): 10 Deployments of
    ``n_pods // 10`` pods. Eight are gpu-share templates (pod-template
    annotations asking one GPU with 2, 4 or 6 GiB); two (every fifth) ask
    a whole GPU as the spec resource ``alibabacloud.com/gpu-count: 1``,
    which turns on the dynamic gpu-count allocatable."""
    rt = ResourceTypes()
    n_workloads = 10
    per = n_pods // n_workloads
    for w in range(n_workloads):
        if w % 5 == 4:
            rt.deployments.append(
                make_fake_deployment(
                    f"gpu-{w}", per, "250m", "512Mi",
                    with_requests({"alibabacloud.com/gpu-count": "1"}),
                )
            )
            continue
        d = make_fake_deployment(f"gpu-{w}", per, "250m", "512Mi")
        _tmpl_annotate(d, {
            "alibabacloud.com/gpu-mem": f"{2 + 2 * (w % 3)}Gi",
            "alibabacloud.com/gpu-count": "1",
        })
        rt.deployments.append(d)
    return rt


def local_pv_cluster(n_nodes: int) -> ResourceTypes:
    """The all-local-PV fleet (bench.py:220-239): the plan's 64-core /
    256 GiB / 256-pod nodes in 4 zones, each with an open-local volume
    group of 600 GiB and two exclusive 100 GiB SSDs."""
    rt = ResourceTypes()
    zones = [f"zone-{z}" for z in range(4)]
    for i in range(n_nodes):
        rt.nodes.append(
            make_fake_node(
                f"node-{i:05d}", "64", "256Gi", "256",
                with_labels({"topology.kubernetes.io/zone": zones[i % len(zones)]}),
                with_node_local_storage(
                    vgs=[{"name": "pool0", "capacity": 600 * 1024**3}],
                    devices=[
                        {"device": "/dev/vdb", "capacity": 100 * 1024**3, "mediaType": "ssd"},
                        {"device": "/dev/vdc", "capacity": 100 * 1024**3, "mediaType": "ssd"},
                    ],
                ),
            )
        )
    return rt


def local_pv_apps(n_pods: int) -> ResourceTypes:
    """The all-local-PV workload (bench.py:242-262): 10 Deployments of
    ``n_pods // 10`` pods, each asking an LVM volume of 5, 10 or 15 GiB
    (pod-template annotation); Deployment 4 also asks a 20 GiB exclusive
    SSD."""
    rt = ResourceTypes()
    n_workloads = 10
    per = n_pods // n_workloads
    for w in range(n_workloads):
        vols = [{"size": str((5 + 5 * (w % 3)) * 1024**3), "kind": "LVM", "scName": "open-local-lvm"}]
        if w == 4:
            vols.append({"size": str(20 * 1024**3), "kind": "SSD", "scName": "open-local-device"})
        d = make_fake_deployment(f"loc-{w}", per, "250m", "512Mi")
        _tmpl_annotate(d, {ANNO_POD_LOCAL_STORAGE: json.dumps({"volumes": vols})})
        rt.deployments.append(d)
    return rt


def oversubscribed_cluster(n_nodes: int) -> ResourceTypes:
    """The over-subscribed capacity plan's fleet: the capacity plan's
    (:func:`synthetic_cluster`; disk ``hdd`` on the nodes with i % 3 == 0)
    plus 10 bare pods bound by nodeName to ``node-99999``, a node that does
    not exist, so they fail as forced pods."""
    rt = synthetic_cluster(n_nodes)
    rt.pods.extend(make_fake_pod(f"stray-{k}", "1", "1Gi", with_node_name("node-99999")) for k in range(10))
    return rt


def oversubscribed_apps(n_nodes: int, n_pods: int) -> List[Tuple[str, ResourceTypes]]:
    """The over-subscribed capacity plan's three apps, in order, as (name,
    resources): ``hog-hdd``, one Deployment of 0.4·n_nodes pods of 48 cores /
    200 GiB under the node selector ``disk: hdd`` (one fits on each hdd
    node, the rest fail on cpu and memory there and on node affinity
    elsewhere); ``hog-any``, one Deployment of 0.8·n_nodes pods of 40 cores /
    100 GiB (one fits on each ssd node, none where hog-hdd left 16 cores);
    ``plan``, :func:`synthetic_apps` of n_pods pods, which all bind after
    those failures. At 5,000 nodes: 2,000 and 4,000 hog pods, 333 and 667
    of them failing."""
    hdd = ResourceTypes()
    hdd.deployments.append(make_fake_deployment("hog-hdd", 2 * n_nodes // 5, "48", "200Gi",
                                                with_node_selector({"disk": "hdd"})))
    anywhere = ResourceTypes()
    anywhere.deployments.append(make_fake_deployment("hog-any", 4 * n_nodes // 5, "40", "100Gi"))
    return [("hog-hdd", hdd), ("hog-any", anywhere), ("plan", synthetic_apps(n_pods))]


def apply_apps(n_pods: int, n_hog: int) -> List[Tuple[str, ResourceTypes]]:
    """The apply plan's two apps, in order, as (name, resources): ``bench``,
    :func:`synthetic_apps` of n_pods pods, and ``hog``, one Deployment of
    n_hog pods of 60 cores / 128 GiB, last in the stream. Each node of the
    capacity fleet keeps about 1.7 cores in use after ``bench`` (at 10 pods
    a node), so it then holds one ``hog`` pod and no second: the plan needs
    n_hog − (fleet size) new nodes of the fleet's kind."""
    hog = ResourceTypes()
    hog.deployments.append(make_fake_deployment("hog", n_hog, "60", "128Gi"))
    return [("bench", synthetic_apps(n_pods)), ("hog", hog)]


def write_apply_plan(root, n_nodes: int, n_pods: int, n_hog: int) -> str:
    """Write the apply plan as a user would hand it to ``simon apply``: the
    capacity fleet of n_nodes (:func:`synthetic_cluster`) in ``cluster/``,
    the apps of :func:`apply_apps` in ``bench/`` and ``hog/``, the fleet's
    next node as the new-node template in ``newnode/``, and the Config CR
    naming them, ``config.yaml``, whose path it returns."""
    import yaml

    dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
    root = Path(root)
    dirs = {
        "cluster": [n.raw for n in synthetic_cluster(n_nodes).nodes],
        "newnode": [_fleet_node(n_nodes).raw],
        **{name: [w.raw for w in rt.deployments] for name, rt in apply_apps(n_pods, n_hog)},
    }
    for name, docs in dirs.items():
        (root / name).mkdir(parents=True, exist_ok=True)
        with open(root / name / f"{name}.yaml", "w") as f:
            yaml.dump_all(docs, f, Dumper=dumper)
    config = root / "config.yaml"
    config.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1",
        "kind": "Config",
        "metadata": {"name": "apply-plan"},
        "spec": {
            "cluster": {"customConfig": "cluster"},
            "appList": [{"name": "bench", "path": "bench"}, {"name": "hog", "path": "hog"}],
            "newNode": "newnode",
        },
    }))
    return str(config)


def _gpu_share(mem: str, count: str) -> Option:
    return with_annotations({"alibabacloud.com/gpu-mem": mem, "alibabacloud.com/gpu-count": count})


def _gpu_node(name: str) -> Node:
    """64 cores, 128 GiB, 4 gpu-share devices of 8 GiB."""
    return make_fake_node(
        name, "64", "128Gi", "110",
        with_allocatable({"alibabacloud.com/gpu-mem": "32Gi", "alibabacloud.com/gpu-count": "4"}),
    )


#: Small bind-scan cases: (name, node count, node_pad) — see scan_case.
SCAN_CASES = (
    ("ties", 16, 128),
    ("spread", 16, 128),
    ("spread_no_zone", 16, 128),
    ("no_spread", 16, 128),
    ("forced", 12, 128),
    ("unpadded_n", 20, 1),
    ("gpu", 6, 128),
    ("gpu_dyn", 8, 1),
    ("gpu_forced", 6, 1),
    ("scores", 6, 128),
    ("interpod", 12, 128),
    ("interpod_terms", 12, 128),
    ("two_keys", 12, 128),
    ("ports", 6, 128),
    ("interpod_small", 64, 1),
    ("local", 4, 128),
    ("local_rules", 9, 1),
    ("local_demo", 0, 1),
    ("fail_ports", 4, 1),
    ("fail_fit", 4, 1),
    ("fail_spread", 4, 128),
    ("fail_interpod", 3, 1),
    ("fail_gpu", 3, 1),
    ("fail_local", 3, 128),
    ("fail_mixed", 6, 128),
)


def scan_case(name: str):
    """(cluster, app, node_pad) of a small bind-scan case. ``ties``: a
    uniform fleet where equal scores are the rule; ``spread``: hard
    hostname spread plus soft zone spread, some nodes without the zone
    label, and pods that fit nowhere; ``spread_no_zone``/``no_spread``: the
    same with the zone label or the spread workload left out; ``forced``:
    pods bound to a node by name, one to a node that does not exist;
    ``unpadded_n``: 20 nodes, not a multiple of 32, no node padding;
    ``gpu``: gpu-share pods asking 1, 2 and 3 GPUs on 4-GPU nodes, and
    pods larger than any GPU; ``gpu_dyn``: 8 nodes of the all-GPU fleet
    under both template kinds of its workload, overloaded (dynamic
    gpu-count allocatable); ``gpu_forced``: gpu-share pods bound by name,
    some to a node where no GPU fits; ``scores``: PreferNoSchedule taints,
    preferred node affinity and a node that prefers to avoid a ReplicaSet's
    pods; ``ports``: the same with host port 8080 on the bare pods, more of
    them than nodes, and pods asking 8080 on one address, which the
    wildcard address blocks; ``interpod``: required affinity (one term and
    two), required anti-affinity and preferred anti-affinity, some nodes
    without the zone label; ``interpod_terms``: the same fleet, where each
    inter-pod rule decides placements: pods that require a zone holding
    their own kind (the first one passes by the bootstrap), pods that only
    an existing pod's anti term keeps off its node, and pods that prefer a
    partner's node; ``two_keys``: spread and inter-pod terms over
    hostname, zone and region; ``interpod_small``: the affinity-heavy plan
    at 64 nodes and 640 pods; ``local``: open-local volume groups and SSD
    and HDD devices, StatefulSets asking LVM, an HDD device, and two SSD
    volumes of different sizes; ``local_demo``: the shipped
    ``example/cluster/demo`` with ``example/application/local`` (its node
    count is the example's), where two pods find no device. The ``fail_*``
    cases decide the failure attribution (:func:`_fail_case`)."""
    n_nodes, node_pad = {c[0]: c[1:] for c in SCAN_CASES}[name]
    cluster = ResourceTypes()
    app = ResourceTypes()
    if name.startswith("fail_"):
        return (*_fail_case(name), node_pad)
    if name == "local":
        return _local_cluster(n_nodes), _local_apps(), node_pad
    if name == "local_rules":
        return _local_rules_cluster(), _local_rules_apps(), node_pad
    if name == "local_demo":
        from . import expand

        example = Path(__file__).resolve().parents[2] / "example"
        cluster = expand.load_cluster_from_dir(str(example / "cluster" / "demo"))
        app, _skipped = expand.resources_from_dicts(expand.load_yaml_objects(str(example / "application" / "local")))
        return cluster, app, node_pad
    if name == "ties":
        for i in range(n_nodes):
            cluster.nodes.append(make_fake_node(f"n{i:03d}", "8", "16Gi", "110"))
        app.deployments.append(make_fake_deployment("even", 40, "500m", "1Gi"))
        app.deployments.append(make_fake_deployment("odd", 24, "300m", "700Mi"))
        return cluster, app, node_pad
    if name in ("interpod", "interpod_terms"):
        # tests/test_fastpath.py:291-371 of the JAX package; every fourth
        # node lacks the zone label
        for i in range(n_nodes):
            labels = {} if i % 4 == 3 else {"topology.kubernetes.io/zone": f"z{i % 3}"}
            cluster.nodes.append(make_fake_node(f"n{i:02d}", "16", "32Gi", "110", with_labels(labels)))
        return cluster, _interpod_apps() if name == "interpod" else _interpod_terms_apps(), node_pad
    if name in ("gpu", "gpu_forced"):
        # tests/test_fastpath.py:144-178 of the JAX package
        cluster.nodes.extend(_gpu_node(f"g{i}") for i in range(n_nodes))
        mix = [("4Gi", "1", 10), ("10Gi", "1", 6), ("6Gi", "2", 4), ("8Gi", "3", 3)]
        if name == "gpu_forced":
            # bound by name: one device fits on g0; on g1 nothing fits a
            # 10 GiB slot (one GPU or two), so those take no device
            for j, (mem, cnt, node) in enumerate([("4Gi", "1", "g0"), ("10Gi", "1", "g1"),
                                                   ("10Gi", "2", "g1"), ("6Gi", "2", "g1")]):
                cluster.pods.append(make_fake_pod(f"bound-{j}", "1", "1Gi", _gpu_share(mem, cnt),
                                                  with_node_name(node)))
            mix = [("4Gi", "1", 16), ("6Gi", "2", 6), ("12Gi", "1", 2)]
        for j, (mem, cnt, n) in enumerate(mix):
            for k in range(n):
                app.pods.append(make_fake_pod(f"gpu-{j}-{k}", "1", "1Gi", _gpu_share(mem, cnt)))
        return cluster, app, node_pad
    if name == "gpu_dyn":
        # 200 pods: devices fill and pods fail, yet whole-GPU pods still
        # place where the gpu-count share (its add-back) decides the node
        return gpu_cluster(n_nodes), gpu_apps(200), node_pad
    if name in ("scores", "ports"):
        # tests/test_fastpath.py:181-214 of the JAX package; its host ports
        # only in "ports"
        for i in range(n_nodes):
            opts = [with_labels({"disk": "ssd" if i % 2 else "hdd"})]
            if i < 2:
                opts.append(with_taints([{"key": "soft", "value": "x", "effect": "PreferNoSchedule"}]))
            if i == 3:
                opts.append(with_annotations({"scheduler.alpha.kubernetes.io/preferAvoidPods": _AVOID_RS}))
            cluster.nodes.append(make_fake_node(f"n{i}", "16", "32Gi", "110", *opts))
        if name == "scores":
            for k in range(5):
                app.pods.append(make_fake_pod(f"web-{k}", "500m", "1Gi"))
        else:
            # 8080 on every address: one pod per node, two left over; then
            # 8080 on one address, which conflicts with the wildcard
            for k in range(n_nodes + 2):
                app.pods.append(make_fake_pod(f"web-{k}", "500m", "1Gi", with_host_ports([8080])))
            for k in range(3):
                app.pods.append(make_fake_pod(f"edge-{k}", "250m", "256Mi", with_host_port_specs([
                    {"hostPort": 8080, "containerPort": 8080, "protocol": "TCP", "hostIP": "10.0.0.1"}])))
            for k in range(3):
                app.pods.append(make_fake_pod(f"alt-{k}", "250m", "256Mi", with_host_ports([9090])))
        app.deployments.append(
            make_fake_deployment(
                "pref", 6, "250m", "512Mi",
                with_affinity({"nodeAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": 50, "preference": {"matchExpressions": [
                        {"key": "disk", "operator": "In", "values": ["ssd"]}]}},
                ]}}),
            )
        )
        app.replica_sets.append(_avoided_replica_set(8, "1", "2Gi"))
        # overload so some pods genuinely fail
        app.deployments.append(make_fake_deployment("fat", 16, "6", "12Gi"))
        return cluster, app, node_pad
    if name == "two_keys":
        return _two_keys_cluster(n_nodes), _two_keys_apps(), node_pad
    if name == "interpod_small":
        return synthetic_cluster(n_nodes), affinity_apps(10 * n_nodes), node_pad
    with_zone = name != "spread_no_zone"
    for i in range(n_nodes):
        labels = {}
        if with_zone and i % 4 != 3:  # some nodes lack the zone label
            labels["topology.kubernetes.io/zone"] = f"z{i % 3}"
        cluster.nodes.append(make_fake_node(f"n{i:03d}", "16", "32Gi", "110", with_labels(labels)))
    if name == "forced":
        for j in range(6):
            cluster.pods.append(
                make_fake_pod(f"bound-{j}", "2", "4Gi", with_node_name(f"n{(3 * j) % n_nodes:03d}"))
            )
        cluster.pods.append(make_fake_pod("lost", "1", "1Gi", with_node_name("gone")))
    app.deployments.append(make_fake_deployment("plain", 64, "500m", "1Gi"))
    app.deployments.append(make_fake_deployment("tiny", 32, "100m", "128Mi"))
    if name != "no_spread":
        app.deployments.append(
            make_fake_deployment(
                "spread", 32, "250m", "512Mi",
                with_topology_spread([
                    {
                        "maxSkew": 2,
                        "topologyKey": "kubernetes.io/hostname",
                        "whenUnsatisfiable": "DoNotSchedule",
                        "labelSelector": {"matchLabels": {"app": "spread"}},
                    },
                    {
                        "maxSkew": 3,
                        "topologyKey": "topology.kubernetes.io/zone",
                        "whenUnsatisfiable": "ScheduleAnyway",
                        "labelSelector": {"matchLabels": {"app": "spread"}},
                    },
                ]),
            )
        )
    # overload so some pods genuinely fail
    app.deployments.append(make_fake_deployment("fat", 40, "8", "16Gi"))
    return cluster, app, node_pad


def _interpod_apps() -> ResourceTypes:
    """The ``interpod`` case's workload (tests/test_fastpath.py:300-358 of
    the JAX package): two anchors, followers that require an anchor's zone,
    picky pods that require a pod matching both of two terms (zone and
    host), and a StatefulSet that must not share a host with its own pods
    and prefers not to share a zone. Its 14 replicas are more than the 12
    nodes, so two find no node."""
    app = ResourceTypes()
    app.pods.append(make_fake_pod("anchor", "100m", "128Mi", with_labels({"role": "anchor"})))
    app.pods.append(make_fake_pod("anchor-b", "100m", "128Mi", with_labels({"role": "anchor", "grade": "gold"})))
    app.deployments.append(make_fake_deployment("followers", 6, "200m", "256Mi", with_affinity({
        "podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"role": "anchor"}}, "topologyKey": "topology.kubernetes.io/zone"},
        ]},
    })))
    app.deployments.append(make_fake_deployment("picky", 4, "200m", "256Mi", with_affinity({
        "podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"role": "anchor"}}, "topologyKey": "topology.kubernetes.io/zone"},
            {"labelSelector": {"matchLabels": {"grade": "gold"}}, "topologyKey": "kubernetes.io/hostname"},
        ]},
    })))
    app.stateful_sets.append(make_fake_stateful_set("spread-db", 14, "500m", "1Gi", with_affinity({
        "podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": "spread-db"}}, "topologyKey": "kubernetes.io/hostname"},
            ],
            "preferredDuringSchedulingIgnoredDuringExecution": [{"weight": 100, "podAffinityTerm": {
                "labelSelector": {"matchLabels": {"app": "spread-db"}},
                "topologyKey": "topology.kubernetes.io/zone",
            }}],
        },
    })))
    return app


def _interpod_terms_apps() -> ResourceTypes:
    """Workloads where each inter-pod rule decides placements: ``colo``
    requires a zone holding ``colo`` pods, so its first pod places only by
    the bootstrap (no match anywhere yet, and it matches itself); ``guard``
    keeps ``tier: noisy`` pods off its nodes, and the ``noisy`` pods carry
    no term of their own, so only the symmetric anti check stops them;
    ``cache`` prefers the nodes of ``web`` (weight 100), against
    least-allocated, which prefers the empty ones; ``orphan`` requires a
    zone holding pods that never come, and does not match itself, so it
    finds no node."""
    app = ResourceTypes()
    app.deployments.append(make_fake_deployment("colo", 5, "300m", "512Mi", with_affinity({
        "podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"app": "colo"}}, "topologyKey": "topology.kubernetes.io/zone"},
        ]},
    })))
    app.deployments.append(make_fake_deployment("guard", 4, "200m", "256Mi", with_affinity({
        "podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"tier": "noisy"}}, "topologyKey": "kubernetes.io/hostname"},
        ]},
    })))
    app.deployments.append(make_fake_deployment("noisy", 20, "2", "2Gi", with_pod_labels({"tier": "noisy"})))
    app.deployments.append(make_fake_deployment("web", 3, "1", "1Gi"))
    app.deployments.append(make_fake_deployment("cache", 6, "500m", "512Mi", with_affinity({
        "podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [{"weight": 100, "podAffinityTerm": {
            "labelSelector": {"matchLabels": {"app": "web"}}, "topologyKey": "kubernetes.io/hostname",
        }}]},
    })))
    app.deployments.append(make_fake_deployment("orphan", 2, "100m", "128Mi", with_affinity({
        "podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"app": "missing"}}, "topologyKey": "topology.kubernetes.io/zone"},
        ]},
    })))
    return app


def _local_cluster(n_nodes: int) -> ResourceTypes:
    """tests/test_fastpath.py:219-239 of the JAX package: two volume groups
    (100 and 50 GiB), SSDs of 80 and 30 GiB and an HDD of 120 GiB per node."""
    rt = ResourceTypes()
    for i in range(n_nodes):
        rt.nodes.append(make_fake_node(
            f"s{i}", "32", "64Gi", "110",
            with_node_local_storage(
                vgs=[{"name": "pool0", "capacity": 100 * 1024**3}, {"name": "pool1", "capacity": 50 * 1024**3}],
                devices=[
                    {"device": "/dev/vdb", "capacity": 80 * 1024**3, "mediaType": "ssd"},
                    {"device": "/dev/vdd", "capacity": 30 * 1024**3, "mediaType": "ssd"},
                    {"device": "/dev/vdc", "capacity": 120 * 1024**3, "mediaType": "hdd"},
                ],
            ),
        ))
    return rt


def _local_apps() -> ResourceTypes:
    """tests/test_fastpath.py:240-258 of the JAX package: 30 GiB LVM
    volumes, 100 GiB HDD devices, and two SSD volumes of 10 and 60 GiB per
    pod (one device per volume, not count × largest size)."""
    app = ResourceTypes()
    app.stateful_sets.append(make_fake_stateful_set(
        "db", 6, "500m", "1Gi", with_volume_claims([("data", "open-local-lvm", "30Gi")])))
    app.stateful_sets.append(make_fake_stateful_set(
        "disk", 3, "250m", "512Mi", with_volume_claims([("d", "open-local-device-hdd", "100Gi")])))
    app.stateful_sets.append(make_fake_stateful_set(
        "mixed", 2, "250m", "512Mi",
        with_volume_claims([("small", "open-local-device-ssd", "10Gi"), ("big", "open-local-device-ssd", "60Gi")])))
    return app


def _local_node(name: str, group: str, cpu: str, vgs=(), ssd=(), hdd=()) -> Node:
    """A node of the ``local_rules`` case: label ``rule=<group>``, volume
    groups and devices of the given sizes in GiB."""
    devices = [{"device": f"/dev/{m}{j}", "capacity": gib * 1024**3, "mediaType": m}
               for m, sizes in (("ssd", ssd), ("hdd", hdd)) for j, gib in enumerate(sizes)]
    return make_fake_node(
        name, cpu, "32Gi", "110", with_labels({"rule": group}),
        with_node_local_storage(vgs=[{"name": f"vg{j}", "capacity": gib * 1024**3} for j, gib in enumerate(vgs)],
                                devices=devices),
    )


def _local_pod(name: str, group: str, volumes) -> Pod:
    """A 1.5-core pod of the ``local_rules`` case on the nodes of `group`,
    with local volumes (kind, GiB)."""
    vols = [{"size": str(gib * 1024**3), "kind": kind, "scName": "open-local"} for kind, gib in volumes]
    return make_fake_pod(name, "1500m", "1Gi", with_node_selector({"rule": group}),
                         with_pod_local_storage(json.dumps({"volumes": vols})))


def _local_rules_cluster() -> ResourceTypes:
    """Groups of nodes, one per Open-Local rule, that the ``local_rules``
    pods reach by node selector. In ``vg`` and ``dev`` the 2-core node
    would win on the share score if the storage filter let it through; in the other groups the nodes tie on every score but the
    binpack score, or the pod binds to one node and the choice of its
    volume group shows in the final state."""
    rt = ResourceTypes()
    rt.nodes.extend([
        _local_node("vg-a", "vg", "2", vgs=[29]),  # too small for 30 GiB
        _local_node("vg-b", "vg", "8", vgs=[1000]),
        _local_node("dev-a", "dev", "2", ssd=[25, 5]),  # one device for two volumes
        _local_node("dev-b", "dev", "8", ssd=[200, 200]),
        _local_node("bind-a", "vgbind", "16", vgs=[100, 40, 40]),  # tightest VG, first among equals
        _local_node("lvm-b", "lvm", "16", vgs=[60]),
        _local_node("lvm-a", "lvm", "16", vgs=[200, 35]),  # the score's VG is the tightest, not the first
        _local_node("ssd-b", "ssd", "16", ssd=[300]),
        _local_node("ssd-a", "ssd", "16", ssd=[25, 400]),  # the score's device is the smallest that fits
    ])
    return rt


def _local_rules_apps() -> ResourceTypes:
    app = ResourceTypes()
    app.pods.extend([
        _local_pod("vg", "vg", [("LVM", 30)]),
        _local_pod("dev", "dev", [("SSD", 20), ("SSD", 10)]),
        _local_pod("vgbind", "vgbind", [("LVM", 30)]),
        _local_pod("lvm", "lvm", [("LVM", 30)]),
        _local_pod("ssd", "ssd", [("SSD", 20)]),
    ])
    return app


def _two_keys_cluster(n_nodes: int) -> ResourceTypes:
    """Nodes under hostname, zone and region; some lack the zone label and
    others, independently, the region label (tests/test_fastpath.py:
    379-386 of the JAX package)."""
    rt = ResourceTypes()
    for i in range(n_nodes):
        labels = {}
        if i % 4 != 3:
            labels["topology.kubernetes.io/zone"] = f"z{i % 3}"
        if i % 5 != 4:
            labels["topology.kubernetes.io/region"] = f"r{i % 2}"
        rt.nodes.append(make_fake_node(f"n{i:02d}", "16", "32Gi", "110", with_labels(labels)))
    return rt


def _two_keys_apps() -> ResourceTypes:
    """tests/test_fastpath.py:387-438 of the JAX package: hard zone and
    soft region spread, required region affinity to an anchor, and required
    zone anti-affinity with preferred region anti-affinity."""
    app = ResourceTypes()
    app.deployments.append(make_fake_deployment("zonal", 9, "250m", "512Mi", with_topology_spread([
        {"maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone", "whenUnsatisfiable": "DoNotSchedule",
         "labelSelector": {"matchLabels": {"app": "zonal"}}},
        {"maxSkew": 2, "topologyKey": "topology.kubernetes.io/region", "whenUnsatisfiable": "ScheduleAnyway",
         "labelSelector": {"matchLabels": {"app": "zonal"}}},
    ])))
    app.pods.append(make_fake_pod("anchor", "100m", "128Mi", with_labels({"role": "anchor"})))
    app.deployments.append(make_fake_deployment("regional", 4, "200m", "256Mi", with_affinity({
        "podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"role": "anchor"}}, "topologyKey": "topology.kubernetes.io/region"},
        ]},
    })))
    app.stateful_sets.append(make_fake_stateful_set("iso", 4, "500m", "1Gi", with_affinity({
        "podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": "iso"}}, "topologyKey": "topology.kubernetes.io/zone"},
            ],
            "preferredDuringSchedulingIgnoredDuringExecution": [{"weight": 50, "podAffinityTerm": {
                "labelSelector": {"matchLabels": {"app": "iso"}},
                "topologyKey": "topology.kubernetes.io/region",
            }}],
        },
    })))
    return app


def _bound(name: str, node: str, cpu: str, memory: str, *options: Option) -> Pod:
    """A cluster pod bound to `node` by nodeName: it sets up the node's
    state before the app's pods are scheduled."""
    return make_fake_pod(name, cpu, memory, with_node_name(node), *options)


def _anti(labels: Dict[str, str]) -> Option:
    """Required anti-affinity, per host, against pods with `labels`."""
    return with_affinity({"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
        {"labelSelector": {"matchLabels": labels}, "topologyKey": "kubernetes.io/hostname"}]}})


def _hard_host_spread(app: str) -> Option:
    return with_topology_spread([{"maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
                                  "whenUnsatisfiable": "DoNotSchedule",
                                  "labelSelector": {"matchLabels": {"app": app}}}])


def _fail_case(name: str) -> Tuple[ResourceTypes, ResourceTypes]:
    """The failure-attribution cases: in each, a pod finds no node, and on
    some node the filter under test is the first to fail while a later one
    fails there too (the counts then show the reference's order), and pods
    bind after the failure.

    - ``fail_ports``: host port 8080 taken on n0 (2 cores left) and n1, n2
      short of cpu; the first 4-core pod asking 8080 binds on n3, the next
      fails: ports on n0, n1, n3 (n0 lacks cpu too, but only n2 counts as
      short of cpu), fit on n2.
    - ``fail_fit``: hard hostname spread (maxSkew 1) with n0 holding one
      such pod and lacking both cpu and memory, n1 lacking cpu only, n2 and
      n3 holding one such pod each: fit on n0 (cpu and memory short, spread
      fails there too) and n1, spread on n2 and n3.
    - ``fail_spread``: hard hostname spread with such pods on n0 (two), n1
      and n2, and pods that the newcomer's required anti-affinity refuses
      on n0 and n3: spread on n0 (inter-pod too), n1, n2; inter-pod on n3.
    - ``fail_interpod``: gpu-share nodes; anti-affinity refused on g0
      (whose GPUs are full) and g2, g1's GPUs full: inter-pod on g0 (gpu
      too) and g2, gpu on g1.
    - ``fail_gpu``: nodes with 4 GPUs of 8 GiB and a 20 GiB volume group,
      whole-GPU pods asking ``alibabacloud.com/gpu-count`` (the dynamic
      gpu-count allocatable): n0 GPUs full and 10 GiB of its VG left, n1
      GPUs full, n2 10 GiB of its VG left (and its SSD taken). A gpu-share
      pod with a 15 GiB LVM volume fails gpu on n0 (local too) and n1,
      local on n2; a whole-GPU pod with the same volume fails fit (no device
      left with free memory: gpu-count short) on n0 (local too) and n1,
      local on n2.
    - ``fail_local``: an LVM volume and an SSD device: n0's VG too small,
      n1 without a free SSD, n2 short of cpu: local on n0 and n1, fit on n2;
      then an SSD pod and an LVM pod bind.
    - ``fail_mixed``: a plain fleet, half of it ``disk: ssd``, the other
      half with 4 of 8 cores taken: 7-core pods under that node selector
      fill the ssd nodes and the fourth fails (node affinity first on the
      hdd nodes, which lack cpu too, and cpu on the ssd nodes), big pods
      fail on cpu in the middle of the stream, pods bind after them, and
      later pods fail with other counts."""
    cluster, app = ResourceTypes(), ResourceTypes()
    if name == "fail_ports":
        cluster.nodes.extend(make_fake_node(f"n{i}", "8", "16Gi", "110") for i in range(4))
        cluster.pods += [_bound("holder-0", "n0", "6", "1Gi", with_host_ports([8080])),
                         _bound("holder-1", "n1", "1", "1Gi", with_host_ports([8080])),
                         _bound("filler-2", "n2", "6", "1Gi")]
        app.pods += [make_fake_pod(f"web-{k}", "4", "1Gi", with_host_ports([8080])) for k in range(2)]
        app.pods += [make_fake_pod(f"tail-{k}", "500m", "512Mi") for k in range(3)]
    elif name == "fail_fit":
        cluster.nodes.extend(make_fake_node(f"n{i}", "4", "8Gi", "110") for i in range(4))
        sp = with_labels({"app": "sp"})
        cluster.pods += [_bound("sp-0", "n0", "3", "6Gi", sp), _bound("filler-1", "n1", "3", "1Gi"),
                         _bound("sp-2", "n2", "100m", "128Mi", sp), _bound("sp-3", "n3", "100m", "128Mi", sp)]
        app.pods.append(make_fake_pod("sp-new", "2", "4Gi", sp, _hard_host_spread("sp")))
        app.pods += [make_fake_pod(f"tail-{k}", "500m", "512Mi") for k in range(3)]
    elif name == "fail_spread":
        cluster.nodes.extend(make_fake_node(f"n{i}", "8", "16Gi", "110") for i in range(4))
        sp, bad = with_labels({"app": "sp2"}), with_labels({"role": "bad"})
        cluster.pods += [_bound("sp-0a", "n0", "100m", "128Mi", sp), _bound("sp-0b", "n0", "100m", "128Mi", sp),
                         _bound("sp-1", "n1", "100m", "128Mi", sp), _bound("sp-2", "n2", "100m", "128Mi", sp),
                         _bound("bad-0", "n0", "100m", "128Mi", bad), _bound("bad-3", "n3", "100m", "128Mi", bad)]
        app.pods.append(make_fake_pod("sp-new", "1", "1Gi", sp, _hard_host_spread("sp2"), _anti({"role": "bad"})))
        app.pods += [make_fake_pod(f"tail-{k}", "500m", "512Mi") for k in range(3)]
    elif name == "fail_interpod":
        cluster.nodes.extend(_gpu_node(f"g{i}") for i in range(3))
        bad = with_labels({"role": "bad"})
        cluster.pods += [_bound("bad-0", "g0", "1", "1Gi", bad, _gpu_share("8Gi", "4")),
                         _bound("full-1", "g1", "1", "1Gi", _gpu_share("8Gi", "4")),
                         _bound("bad-2", "g2", "1", "1Gi", bad)]
        app.pods.append(make_fake_pod("picky", "1", "1Gi", _gpu_share("4Gi", "1"), _anti({"role": "bad"})))
        app.pods += [make_fake_pod(f"tail-{k}", "1", "1Gi", _gpu_share("2Gi", "1")) for k in range(3)]
    elif name == "fail_gpu":
        for i in range(3):
            cluster.nodes.append(make_fake_node(
                f"n{i}", "16", "32Gi", "110",
                with_allocatable({"alibabacloud.com/gpu-mem": "32Gi", "alibabacloud.com/gpu-count": "4"}),
                with_node_local_storage(vgs=[{"name": "pool0", "capacity": 20 * 1024**3}],
                                        devices=[{"device": "/dev/vdb", "capacity": 50 * 1024**3, "mediaType": "ssd"}])))
        def lvm(gib, ssd=0):
            vols = [{"size": str(gib * 1024**3), "kind": "LVM", "scName": "open-local-lvm"}]
            vols += [{"size": str(ssd * 1024**3), "kind": "SSD", "scName": "open-local-device"}] if ssd else []
            return with_pod_local_storage(json.dumps({"volumes": vols}))

        cluster.pods += [_bound("full-0", "n0", "1", "1Gi", _gpu_share("8Gi", "4"), lvm(10)),
                         _bound("full-1", "n1", "1", "1Gi", _gpu_share("8Gi", "4")),
                         _bound("vg-2", "n2", "1", "1Gi", lvm(10, ssd=20))]
        app.pods += [make_fake_pod("share", "1", "1Gi", _gpu_share("6Gi", "1"), lvm(15)),
                     make_fake_pod("whole", "1", "1Gi", with_requests({"alibabacloud.com/gpu-count": "1"}), lvm(15))]
        app.pods += [make_fake_pod(f"tail-{k}", "1", "1Gi", with_requests({"alibabacloud.com/gpu-count": "1"}))
                     for k in range(2)]
    elif name == "fail_local":
        cluster.nodes += [_local_node("n0", "x", "8", vgs=[10], ssd=[50]),
                          _local_node("n1", "x", "8", vgs=[100]),
                          _local_node("n2", "x", "1", vgs=[100], ssd=[100])]
        app.pods.append(_local_pod("both", "x", [("LVM", 30), ("SSD", 20)]))
        app.pods += [_local_pod("dev", "x", [("SSD", 20)]), _local_pod("lvm", "x", [("LVM", 10)])]
    elif name == "fail_mixed":
        cluster.nodes.extend(make_fake_node(f"n{i}", "8", "16Gi", "110", with_labels({"disk": "ssd" if i % 2 else "hdd"}))
                             for i in range(6))
        cluster.pods += [_bound(f"fill-{i}", f"n{i}", "4", "1Gi") for i in (0, 2, 4)]
        app.deployments += [make_fake_deployment("a", 10, "3", "2Gi"), make_fake_deployment("huge", 3, "9", "1Gi"),
                            make_fake_deployment("b", 8, "1", "1Gi"), make_fake_deployment("c", 3, "500m", "10Gi"),
                            make_fake_deployment("d", 4, "500m", "512Mi")]
        app.pods += [make_fake_pod(f"ssd-{k}", "7", "1Gi", with_node_selector({"disk": "ssd"})) for k in range(4)]
    else:
        raise ValueError(f"no failure case named {name!r}")
    return cluster, app
