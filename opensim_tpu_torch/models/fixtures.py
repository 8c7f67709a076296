"""Test fixture builders — parity with ``pkg/test`` (MakeFakePod/Node/... with
functional ``With*`` options, e.g. ``pkg/test/node.go:15-40``,
``pkg/test/pod.go:13-47``)."""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional

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

def synthetic_cluster(n_nodes: int) -> ResourceTypes:
    """The capacity plan's fleet (bench.py:85-104): identical 64-core /
    256 GiB / 256-pod nodes, 4 zones, a `disk` label on every node."""
    rt = ResourceTypes()
    zones = [f"zone-{z}" for z in range(4)]
    for i in range(n_nodes):
        rt.nodes.append(
            make_fake_node(
                f"node-{i:05d}", "64", "256Gi", "256",
                with_labels({
                    "topology.kubernetes.io/zone": zones[i % len(zones)],
                    "node-role.kubernetes.io/worker": "",
                    "disk": "ssd" if i % 3 else "hdd",
                }),
            )
        )
    return rt


def synthetic_apps(n_pods: int) -> ResourceTypes:
    """The capacity plan's workload (bench.py:107-135): 20 Deployments,
    node selectors on every fourth, soft zone spread on every fifth."""
    rt = ResourceTypes()
    n_workloads = 20
    per = n_pods // n_workloads
    for w in range(n_workloads):
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
        rt.deployments.append(
            make_fake_deployment(
                f"bench-{w}", per, f"{100 + 20 * (w % 8)}m", f"{256 + 64 * (w % 6)}Mi", *opts
            )
        )
    return rt


#: Small bind-scan cases: (name, node count, node_pad) — see scan_case.
SCAN_CASES = (
    ("ties", 16, 128),
    ("spread", 16, 128),
    ("spread_no_zone", 16, 128),
    ("no_spread", 16, 128),
    ("forced", 12, 128),
    ("unpadded_n", 20, 1),
)


def scan_case(name: str):
    """(cluster, app, node_pad) of a small bind-scan case. ``ties``: a
    uniform fleet where equal scores are the rule; ``spread``: hard
    hostname spread plus soft zone spread, some nodes without the zone
    label, and pods that fit nowhere; ``spread_no_zone``/``no_spread``: the
    same with the zone label or the spread workload left out; ``forced``:
    pods bound to a node by name, one to a node that does not exist;
    ``unpadded_n``: 20 nodes, not a multiple of 32, no node padding."""
    n_nodes, node_pad = {c[0]: c[1:] for c in SCAN_CASES}[name]
    cluster = ResourceTypes()
    app = ResourceTypes()
    if name == "ties":
        for i in range(n_nodes):
            cluster.nodes.append(make_fake_node(f"n{i:03d}", "8", "16Gi", "110"))
        app.deployments.append(make_fake_deployment("even", 40, "500m", "1Gi"))
        app.deployments.append(make_fake_deployment("odd", 24, "300m", "700Mi"))
        return cluster, app, node_pad
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
