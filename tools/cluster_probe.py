#!/usr/bin/env python3
"""Latency of the one-scan kernel's per-step cluster primitives on the card,
for PERF.md's per-step floor of a serial scan:

    python3 tools/cluster_probe.py          # on the card

Builds tools/cluster_probe.cu (which includes the kernel's source, so it
runs the kernel's own reductions at its cluster shape) with nvcc into the
port's build directory, times ITERS iterations of each primitive in one
launch with CUDA events (after a warm-up launch), and prints one JSON line:
the card's name and power limit, the cluster shape, nanoseconds per
iteration of each primitive, and the floor of a step without and with
hard spread constraints: its cluster reductions (two, or three), its
selectHost and the barrier after the bind. Needs a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "tools" / "cluster_probe.cu"
ITERS = 20000
MODES = ("cluster_sync", "syncthreads", "cluster_reduce_5", "cluster_argmax", "dsmem_load")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("cluster_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.utils import jitcache

    build_dir = jitcache.build_dir()
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / "cluster_probe.so"
    cmd = [fs._nvcc(), *fs.NVCC_FLAGS, "-DFS_VARIANT=0", "-o", str(lib_path), str(SRC)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f"cluster_probe: nvcc failed:\n{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.cluster_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.cluster_probe_launch.restype = ctypes.c_int
    out = torch.zeros(fs.SCAN_CLUSTER, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ns = {}
    for mode, name in enumerate(MODES):
        for iters in (100, ITERS):  # warm-up, then the timed launch
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            err = lib.cluster_probe_launch(out.data_ptr(), iters, mode, stream)
            end.record()
            torch.cuda.synchronize()
            if err != 0:
                raise SystemExit(f"cluster_probe: launch of {name} failed (cudaError {err})")
        ns[name] = start.elapsed_time(end) * 1e6 / ITERS
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    step = ns["cluster_reduce_5"] + ns["cluster_argmax"] + ns["syncthreads"]
    print(json.dumps({"card": card, "cluster": fs.SCAN_CLUSTER, "threads": fs.SCAN_THREADS, "iters": ITERS,
                      "ns": ns, "step_floor_ns": step, "step_floor_hard_ns": step + ns["cluster_reduce_5"],
                      "stream_floor_ms_50k": step * 50000 / 1e6}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
