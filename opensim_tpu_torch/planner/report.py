"""Report rendering — the port's copy of ``opensim_tpu/planner/report.py``:
plain-text parity with the pterm tables of ``pkg/apply/apply.go:309-687``
(Node Info, Extended Resource Info, Pod Info, App Info). Every table is
built by a ``*_rows`` function returning the formatted cells (header row
first), and the text renderers below print those rows."""

from __future__ import annotations

import json
import sys
from typing import List, TextIO

from ..engine.simulator import SimulateResult
from ..models.objects import (
    ANNO_GPU_INDEX,
    ANNO_NODE_GPU_SHARE,
    ANNO_NODE_LOCAL_STORAGE,
    ANNO_POD_LOCAL_STORAGE,
    LABEL_APP_NAME,
    LABEL_NEW_NODE,
    RES_GPU_COUNT,
    RES_GPU_MEM,
)
from ..models.quantity import format_milli, format_quantity


def _table(rows: List[List[str]], out: TextIO) -> None:
    if not rows:
        return
    widths = [max(len(str(r[c])) for r in rows) for c in range(len(rows[0]))]
    for r in rows:
        print(" | ".join(str(v).ljust(w) for v, w in zip(r, widths)).rstrip(), file=out)


def contains_gpu(extended: List[str]) -> bool:
    return "gpu" in extended


def contains_local_storage(extended: List[str]) -> bool:
    return "open-local" in extended


def report(
    result: SimulateResult,
    extended_resources: List[str],
    app_names: List[str],
    out: TextIO = sys.stdout,
    pod_nodes: List[str] = None,
) -> None:
    report_cluster_info(result, extended_resources, out)
    if pod_nodes is not None:
        report_node_info(result, extended_resources, pod_nodes, out)
    report_app_info(result, app_names, out)


# ---------------------------------------------------------------------------
# row builders (header row first; cells pre-formatted)
# ---------------------------------------------------------------------------


def pod_info_rows(
    result: SimulateResult, extended: List[str], nodes: List[str]
) -> List[List[str]]:
    """Pod Info per node — reportNodeInfo (apply.go:528-597); the reference
    prompts for the node selection, here the caller passes it (empty list =
    every node)."""
    selected = set(nodes) if nodes else {ns.node.metadata.name for ns in result.node_status}
    header = ["Node", "Pod", "App Name", "CPU Requests", "Memory Requests"]
    if contains_local_storage(extended):
        header.append("Volume Request")
    if contains_gpu(extended):
        header.append("GPU Mem Requests")
    rows = [header]
    for status in result.node_status:
        if status.node.metadata.name not in selected:
            continue
        for pod in status.pods:
            req = pod.resource_requests()
            row = [
                status.node.metadata.name,
                f"{pod.metadata.namespace}/{pod.metadata.name}",
                pod.metadata.labels.get(LABEL_APP_NAME, ""),
                format_milli(int(req.get("cpu", 0.0) * 1000)),
                format_quantity(req.get("memory", 0.0)),
            ]
            if contains_local_storage(extended):
                sizes = [
                    f"{v.get('kind')}:{format_quantity(float(v.get('size', 0) or 0))}"
                    for v in pod.local_volumes()
                ]
                row.append(",".join(sizes))
            if contains_gpu(extended):
                row.append(format_quantity(pod.gpu_mem_request() * pod.gpu_count_request()))
            rows.append(row)
    return rows


def cluster_info_rows(result: SimulateResult, extended: List[str]) -> List[List[str]]:
    """Node Info — the capacity report's headline table (apply.go:309-400)."""
    header = ["Node", "CPU Allocatable", "CPU Requests", "Memory Allocatable", "Memory Requests"]
    if contains_gpu(extended):
        header += ["GPU Mem Allocatable", "GPU Mem Requests"]
    header += ["Pod Count", "New Node"]
    rows = [header]
    for status in result.node_status:
        node = status.node
        cpu_alloc = node.allocatable.get("cpu", 0.0)
        mem_alloc = node.allocatable.get("memory", 0.0)
        cpu_req = sum(p.resource_requests().get("cpu", 0.0) for p in status.pods)
        mem_req = sum(p.resource_requests().get("memory", 0.0) for p in status.pods)
        row = [
            node.metadata.name,
            format_milli(int(cpu_alloc * 1000)),
            f"{format_milli(int(cpu_req * 1000))}({int(cpu_req / cpu_alloc * 100) if cpu_alloc else 0}%)",
            format_quantity(mem_alloc),
            f"{format_quantity(mem_req)}({int(mem_req / mem_alloc * 100) if mem_alloc else 0}%)",
        ]
        if contains_gpu(extended):
            gpu_alloc = node.allocatable.get(RES_GPU_MEM, 0.0)
            gpu_req = sum(p.gpu_mem_request() * p.gpu_count_request() for p in status.pods)
            row += [
                format_quantity(gpu_alloc),
                f"{format_quantity(gpu_req)}({int(gpu_req / gpu_alloc * 100) if gpu_alloc else 0}%)",
            ]
        row += [str(len(status.pods)), "√" if LABEL_NEW_NODE in node.metadata.labels else ""]
        rows.append(row)
    return rows


def local_storage_rows(result: SimulateResult) -> List[List[str]]:
    """Node Local Storage — Extended Resource Info (apply.go:402-470)."""
    rows = [["Node", "Storage Kind", "Storage Name", "Storage Allocatable", "Storage Requests"]]
    for status in result.node_status:
        anno = status.node.metadata.annotations.get(ANNO_NODE_LOCAL_STORAGE)
        if not anno:
            continue
        try:
            storage = json.loads(anno)
        except ValueError:
            continue
        for vg in storage.get("vgs") or []:
            cap = float(vg.get("capacity", 0) or 0)
            req = float(vg.get("requested", 0) or 0)
            rows.append(
                [
                    status.node.metadata.name,
                    "VG",
                    vg.get("name", ""),
                    format_quantity(cap),
                    f"{format_quantity(req)}({int(req / cap * 100) if cap else 0}%)",
                ]
            )
        for dev in storage.get("devices") or []:
            rows.append(
                [
                    status.node.metadata.name,
                    f"Device({dev.get('mediaType', '')})",
                    dev.get("device", ""),
                    format_quantity(float(dev.get("capacity", 0) or 0)),
                    "used" if dev.get("isAllocated") else "unused",
                ]
            )
    return rows


def gpu_node_rows(result: SimulateResult) -> List[List[str]]:
    """GPU Node Resource (apply.go:472-526)."""
    rows = [["Node", "GPU ID", "GPU Request/Capacity", "Pod List"]]
    for status in result.node_status:
        anno = status.node.metadata.annotations.get(ANNO_NODE_GPU_SHARE)
        if not anno:
            continue
        try:
            info = json.loads(anno)
        except ValueError:
            continue
        total = float(info.get("GpuTotalMemory", 0))
        used = sum(float(d.get("GpuUsedMemory", 0)) for d in (info.get("DevsBrief") or {}).values())
        rows.append(
            [
                f"{status.node.metadata.name} ({info.get('GpuModel', 'N/A')})",
                f"{info.get('GpuCount', 0)} GPUs",
                f"{format_quantity(used)}/{format_quantity(total)}({int(used / total * 100) if total else 0}%)",
                f"{info.get('NumPods', 0)} Pods",
            ]
        )
        for idx, dev in sorted((info.get("DevsBrief") or {}).items()):
            dtot = float(dev.get("GpuTotalMemory", 0))
            if dtot <= 0:
                continue
            dused = float(dev.get("GpuUsedMemory", 0))
            rows.append(
                [
                    f"{status.node.metadata.name} ({info.get('GpuModel', 'N/A')})",
                    str(idx),
                    f"{format_quantity(dused)}/{format_quantity(dtot)}({int(dused / dtot * 100) if dtot else 0}%)",
                    str(dev.get("PodList") or []),
                ]
            )
    return rows


def gpu_pod_map_rows(result: SimulateResult) -> List[List[str]]:
    """Pod -> Node Map (the GPU report's companion table)."""
    pod_list = [p for status in result.node_status for p in status.pods]
    rows = [["Pod", "CPU Req", "Mem Req", "GPU Req", "Host Node", "GPU IDX"]]
    for pod in sorted(pod_list, key=lambda p: p.metadata.name):
        req = pod.resource_requests()
        rows.append(
            [
                pod.metadata.name,
                format_milli(int(req.get("cpu", 0.0) * 1000)),
                format_quantity(req.get("memory", 0.0)),
                format_quantity(pod.gpu_mem_request() * pod.gpu_count_request()),
                pod.spec.node_name,
                pod.metadata.annotations.get(ANNO_GPU_INDEX, ""),
            ]
        )
    return rows


def app_info_rows(result: SimulateResult, app_names: List[str]) -> List[List[str]]:
    """App Info — pods per app per node (reportAppInfo, apply.go:598-687)."""
    rows = [["App", "Pod Count", "Nodes"]]
    for app in app_names:
        pods = [
            p
            for status in result.node_status
            for p in status.pods
            if p.metadata.labels.get(LABEL_APP_NAME) == app
        ]
        nodes = sorted({p.spec.node_name for p in pods})
        rows.append([app, str(len(pods)), ",".join(nodes)])
    return rows


# ---------------------------------------------------------------------------
# text renderers (print the SAME rows)
# ---------------------------------------------------------------------------


def report_node_info(
    result: SimulateResult, extended: List[str], nodes: List[str], out: TextIO
) -> None:
    print("Pod Info", file=out)
    _table(pod_info_rows(result, extended, nodes), out)
    print("", file=out)


def report_cluster_info(result: SimulateResult, extended: List[str], out: TextIO) -> None:
    print("Node Info", file=out)
    _table(cluster_info_rows(result, extended), out)
    print("", file=out)

    if contains_local_storage(extended):
        print("Extended Resource Info", file=out)
        print("Node Local Storage", file=out)
        _table(local_storage_rows(result), out)
        print("", file=out)

    if contains_gpu(extended):
        print("GPU Node Resource", file=out)
        _table(gpu_node_rows(result), out)
        print("\nPod -> Node Map", file=out)
        _table(gpu_pod_map_rows(result), out)
        print("", file=out)


def report_app_info(result: SimulateResult, app_names: List[str], out: TextIO) -> None:
    if not app_names:
        return
    print("App Info", file=out)
    _table(app_info_rows(result, app_names), out)
    print("", file=out)
