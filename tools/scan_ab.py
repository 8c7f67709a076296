#!/usr/bin/env python3
"""Time the port's bind-scan kernels for one checkout, so that two commits
can be compared in turns on one card: the one-scan kernel on the six plans
of chip_smoke.py (capacity, all-GPU-share, affinity-heavy, score-table,
host-port, all-local-PV; 5,000 nodes, 50,000 pods, the whole stream) and
the scenario grid on the 1,000-scenario drain sweep of the capacity plan:

    git archive PARENT | tar -x -C _chipcheck/parent    # gitignored
    for r in _chipcheck/parent . . _chipcheck/parent; do
        python3 tools/scan_ab.py --root $r; done           # on the card

--root (default: this checkout) must lie inside this checkout, so the tool
never loads code from another tree. Prints one JSON line per kernel: the
plan, the kernel row, the root, the card's name and power limit, the
lines of ptxas's report of the variant's library (each kernel's entry,
registers and spills), the one scan's launch shape where the checkout
records it (cluster, threads, shared memory, residency), the number of
steps whose template differs from the step before's, and the kernel's
milliseconds per launch (CUDA events over three launches after one
warm-up); the grid's line adds the bytes of its own state one
step-scenario reads. The six variants are built at once before the first
plan. ``--plans capacity,affinity`` times those plans alone (the grid
only when ``drains`` is named too, with ``capacity``), for bisecting a
difference over many checkouts. To compare shapes of the
one scan's cluster or of
the grid, time copies of this checkout whose SCAN_CLUSTER/SCAN_THREADS or
SWEEP_B_MAX/SWEEP_THREADS (ops/fast_scan.py) and CL/NT or BMAX/SW_NT
(ops/csrc/fast_scan.cu) were edited, in turns. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PLANS = {  # fixtures' cluster and apps makers, the apps maker's options, and the kernel variant
    "capacity": ("synthetic_cluster", "synthetic_apps", {}, "fast_scan"),
    "gpu": ("gpu_cluster", "gpu_apps", {}, "fast_scan[gpu,gc]"),
    "affinity": ("synthetic_cluster", "affinity_apps", {}, "fast_scan[interpod]"),
    "score": ("score_cluster", "score_apps", {}, "fast_scan[na,tt,avoid]"),
    "ports": ("score_cluster", "score_apps", {"host_port": True}, "fast_scan[na,tt,avoid,ports]"),
    "local": ("local_pv_cluster", "local_pv_apps", {}, "fast_scan[local]"),
}
REPS = 3
N_NODES, N_PODS, N_SCENARIOS = 5000, 50000, 1000
GRID = "drains"  # the 1,000-scenario grid of the capacity plan, for --plans


def _events_ms(torch, fn, reps: int) -> float:
    fn()  # build and warm up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _step_bytes(fi, tmpl) -> dict:
    """Bytes of one scenario's own state that one step reads, averaged over
    the stream (4 B a node): pass 2 the rows of `used` the pod requests and
    the hostname count row of each active spread constraint; pass 3 (with
    the feasibility bits) `used`'s cpu and memory rows and the same count
    rows. Zone counts are a few floats."""
    N = fi.alloc_T.shape[1]
    req = (fi.req > 0).cpu()
    host_rows = ((fi.spr_active == 1) & (fi.spr_key == 0)).sum(1).cpu()
    tm = tmpl.long().cpu()
    p2 = (req.sum(1) + host_rows)[tm].double().mean().item() * 4 * N
    p3 = (2 + host_rows)[tm].double().mean().item() * 4 * N
    return {"pass2": p2, "pass3": p3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="checkout to time, inside this one")
    ap.add_argument("--plans", default=",".join(list(PLANS) + [GRID]),
                    help=f"comma-separated plans to time, of {list(PLANS) + [GRID]}")
    args = ap.parse_args()
    plans = args.plans.split(",")
    if not set(plans) <= set(PLANS) | {GRID}:
        raise SystemExit(f"scan_ab: --plans {args.plans}: not among {list(PLANS) + [GRID]}")
    root = args.root.resolve()
    if root != ROOT and ROOT not in root.parents:
        raise SystemExit(f"scan_ab: --root {root} lies outside this checkout {ROOT}")
    import torch

    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from opensim_tpu_torch.engine import fastpath, simulator as sim
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.planner import defrag

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    fs.build([PLANS[plan][3] for plan in plans if plan in PLANS])  # every variant at once
    for plan, (make_cluster, make_apps, opts, _variant) in PLANS.items():
        if plan not in plans:
            continue
        cluster, apps = getattr(fx, make_cluster)(N_NODES), getattr(fx, make_apps)(N_PODS, **opts)
        prep = sim.prepare(cluster, [sim.AppResource("plan", apps)], device="cuda")
        fi, _ = fastpath.build_inputs(prep)
        stream = fastpath.pod_stream(prep)
        ms = _events_ms(torch, lambda: fs.fast_scan(fi, *stream), REPS)
        name = fs.variant_name(fi)
        log = fs.BUILD_LOG["variants"].get(name, {}).get("ptxas", "")
        ptxas = [line.strip() for line in log.splitlines() if any(k in line for k in ("entry", "registers", "spill"))]
        launched = getattr(fs, "SCAN_LAUNCHED", {}).get(name)  # none before the cluster kernel
        shape = launched and {k: v for k, v in launched["shape"]._asdict().items() if k != "offsets"}
        tmpl = stream[0]
        switches = int((tmpl[1:] != tmpl[:-1]).sum())  # steps whose template differs from the step before's
        print(json.dumps({"plan": plan, "variant": name, "root": str(root), "card": card, "ptxas": ptxas,
                          "shape": shape, "template_switches": switches, "ms": ms, "reps": REPS}), flush=True)
        if plan == "capacity" and GRID in plans:
            tmpl, *grid = fastpath.sweep_inputs(prep, *defrag.drain_masks(prep, list(range(N_SCENARIOS))))
            ms = _events_ms(torch, lambda: fs.fast_scan_sweep(fi, tmpl, *grid), REPS)
            print(json.dumps({"plan": f"capacity, {N_SCENARIOS} drains", "variant": fs.sweep_name(fi),
                              "root": str(root), "card": card, "ptxas": ptxas, "step_bytes": _step_bytes(fi, tmpl),
                              "ms": ms, "reps": REPS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
