#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the bind-scan kernel from ops/csrc/ with nvcc, holds it against its
plain PyTorch version on small cases and over the whole stream at full
width, runs simulate() on
the capacity plan (50,000 pods from 20 Deployments on 5,000 nodes, 4
zones; bench.py:85-135) through the kernel, and times the kernel, its
plain version and the phases of simulate() with CUDA events and the host
clock. Every phase raises on failure. The last lines are the card's name
and power limit, one JSON line per the kernel table, and
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

#: Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: float32 non-tensor-core FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
#: The capacity plan of bench.py:85-135, at its full size.
N_NODES = 5000
N_PODS = 50000


def _phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _events_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _same(got, want, what: str) -> float:
    """Identical placements and usage, or raise; returns max |Δused|."""
    (c1, u1), (c2, u2) = got, want
    if not torch.equal(c1, c2):
        bad = int((c1 != c2).sum())
        first = int(torch.nonzero(c1 != c2)[0, 0])
        raise AssertionError(f"{what}: {bad} placements differ (first at pod {first})")
    err = float((u1 - u2).abs().max()) if u1.numel() else 0.0
    if not torch.equal(u1, u2):
        raise AssertionError(f"{what}: used differs, max abs err {err}")
    return err


def small_cases(device) -> None:
    from opensim_tpu_torch.engine import fastpath, simulator as sim
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs

    for name, _n, _pad in fx.SCAN_CASES:
        cluster, app, node_pad = fx.scan_case(name)
        prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=device)
        fi, _ = fastpath.build_inputs(prep)
        stream = fastpath.pod_stream(prep)
        got = fs.fast_scan(fi, *stream)
        want = fs.fast_scan_reference(fi, *stream)
        _same(got, want, f"case {name}")
        print(f"case {name}: N={fi.alloc_T.shape[1]} P={len(prep.tmpl_ids)} "
              f"placed={int((got[0] >= 0).sum())} identical", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from opensim_tpu_torch.engine import fastpath, simulator as sim
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    _phase("1 card")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    _phase("2 build")
    t0 = time.perf_counter()
    fs.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({fs.BUILD_LOG['library']})")
    for line in fs.BUILD_LOG["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    _phase("3 small cases: kernel vs plain version")
    small_cases(device)

    _phase(f"4 full width: {N_NODES} nodes, the whole {N_PODS}-pod stream, kernel vs plain")
    cluster = fx.synthetic_cluster(N_NODES)
    apps = [sim.AppResource("plan", fx.synthetic_apps(N_PODS))]
    prep = sim.prepare(cluster, apps, device=device)
    miss = fastpath.why_not(prep)
    if miss is not None:
        raise AssertionError(f"the plan falls outside the envelope: {miss}")
    fi, _ = fastpath.build_inputs(prep)
    tmpl, valid, forced = fastpath.pod_stream(prep)
    P, N = tmpl.shape[0], fi.alloc_T.shape[1]
    got = fs.fast_scan(fi, tmpl, valid, forced)
    torch.cuda.synchronize()
    plain = [None]

    def run_plain():
        plain[0] = fs.fast_scan_reference(fi, tmpl, valid, forced)

    plain_ms = _events_ms(run_plain, reps=1)
    err = _same(got, plain[0], "whole stream")
    print(f"{P} pods at N={N}: kernel and plain version identical (plain {plain_ms:.3f} ms)")

    _phase(f"5 simulate(): {N_PODS} pods on {N_NODES} nodes")
    fs.LAUNCHES = 0
    res = sim.simulate(cluster, apps, device=device)
    launches = fs.LAUNCHES
    n_placed = sum(len(ns.pods) for ns in res.node_status)
    if launches < 1:
        raise AssertionError("simulate() did not launch the fast_scan kernel")
    if len(res.placements) != P or (res.placements < 0).any() or n_placed != P:
        raise AssertionError(f"placed {n_placed} of {P} pods")
    if not (res.used.shape == (N, fi.alloc_T.shape[0]) and bool(torch.isfinite(torch.from_numpy(res.used)).all())):
        raise AssertionError("final usage has the wrong shape or non-finite values")
    if not torch.equal(got[0].cpu(), torch.from_numpy(res.placements)):
        raise AssertionError("simulate() placed the stream differently from the checked kernel run")
    wall = sum(res.timings.values())
    print(f"placed {n_placed}/{P} pods, kernel launches {launches}")
    print("timings: " + json.dumps({k: round(v, 6) for k, v in res.timings.items()}))
    print(f"plan wall-clock {wall:.6f} s, {P / wall:.1f} pods/s (host clock)")

    _phase("6 timing: the kernel over the whole stream (CUDA events)")
    ms = _events_ms(lambda: fs.fast_scan(fi, tmpl, valid, forced), reps=3)
    work = fs.fast_scan_work(fi, tmpl, valid, forced)
    t_bytes = work["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = work["ops"] / PEAK_F32_S * 1e3
    print(f"kernel {ms:.3f} ms ({ms * 1e3 / P:.3f} us/pod), plain {plain_ms:.3f} ms, "
          f"bound {max(t_bytes, t_ops):.6f} ms ({work['bytes']} B, {work['ops']} flop)")

    row = {
        "name": "fast_scan",
        "route": "cuda",
        "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu",
        "replaces": "opensim_tpu/ops/pallas_scan.py:1009",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    print(card)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
