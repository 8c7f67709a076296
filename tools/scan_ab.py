#!/usr/bin/env python3
"""Time the port's bind-scan kernel on the capacity and score-table plans
(5,000 nodes, 50,000 pods, the whole stream) for one checkout, so that two
commits can be compared in turns on one card:

    git archive PARENT | tar -x -C _chipcheck/parent    # gitignored
    for r in _chipcheck/parent . . _chipcheck/parent; do
        python3 tools/scan_ab.py --root $r; done           # on the card

--root (default: this checkout) must lie inside this checkout, so the tool
never loads code from another tree. Prints one JSON line per plan: the
plan, the kernel variant, the root, the card's name and power limit, the
ptxas report of the variant, and the kernel's milliseconds per launch
(CUDA events, three launches after one warm-up). Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PLANS = {
    "capacity": ("synthetic_cluster", "synthetic_apps"),
    "score": ("score_cluster", "score_apps"),
}
REPS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="checkout to time, inside this one")
    root = ap.parse_args().root.resolve()
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

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for plan, (make_cluster, make_apps) in PLANS.items():
        cluster, apps = getattr(fx, make_cluster)(5000), getattr(fx, make_apps)(50000)
        prep = sim.prepare(cluster, [sim.AppResource("plan", apps)], device="cuda")
        fi, _ = fastpath.build_inputs(prep)
        stream = fastpath.pod_stream(prep)
        fs.fast_scan(fi, *stream)  # build and warm up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fs.fast_scan(fi, *stream)
        end.record()
        torch.cuda.synchronize()
        name = fs.variant_name(fi)
        ptxas = fs.BUILD_LOG["variants"].get(name, {}).get("ptxas", "")
        print(json.dumps({"plan": plan, "variant": name, "root": str(root), "card": card,
                          "ptxas": " ".join(l.strip() for l in ptxas.splitlines() if "registers" in l or "spill" in l),
                          "ms": start.elapsed_time(end) / REPS, "reps": REPS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
