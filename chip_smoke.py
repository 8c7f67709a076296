#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the bind-scan kernel's variants from ops/csrc/ with nvcc (one
shared object per variant, all compiled at once), holds each against its
plain PyTorch version on small cases and at full width (the scenario grid
too, with three drain scenarios per small case), drives simulate()
through the kernel on six plans of 50,000 pods on 5,000 nodes, and
``simon apply`` end to end:

- the capacity plan (20 Deployments, 4 zones; bench.py:85-135), the
  kernel's base variant;
- the all-GPU-share plan (10 Deployments on nodes of 8 × 8 GiB GPUs;
  bench.py:174-217), ``fast_scan[gpu,gc]``;
- the affinity-heavy plan (10 Deployments under hard zone spread,
  preferred host anti-affinity and required zone affinity;
  bench.py:454-506), ``fast_scan[interpod]``;
- the score-table plan (the capacity plan with PreferNoSchedule taints,
  preferred node affinity and a node-avoided ReplicaSet),
  ``fast_scan[na,tt,avoid]``, and the same with host port 8080 on one
  Deployment, ``fast_scan[na,tt,avoid,ports]``;
- the all-local-PV plan (10 Deployments with LVM volumes on nodes of one
  600 GiB volume group and two 100 GiB SSDs; bench.py:220-262),
  ``fast_scan[local]``.

For each plan it holds the one-scan kernel (a thread-block cluster that
splits the node axis, fast_scan.SCAN_CLUSTER CTAs) identical to the plain
version (over the whole stream for the affinity plan, over a prefix of the
others: the plain version is a Python loop) and, over the whole stream, to
one launch of the scenario grid at S = 1 (all nodes valid, the plan's own
spread weights), a kernel of another design; runs simulate() with the
launch counts set to 0 just before and read just after, prints the launch
shape the one scan recorded (fast_scan.SCAN_LAUNCHED), and times the kernel
over the whole stream, the grid at S = 1, the plain version and the phases
of simulate() with CUDA events and the host clock. Then it drives plan_drains() on the capacity plan with
1,000 drain scenarios (the first 1,000 nodes; bench.py:308-335): one
launch of the scenario grid, which runs up to fast_scan.SWEEP_B_MAX
scenarios to a block in lockstep, its rows held against single-scenario
launches over the whole stream; then a grid of 1,001 scenarios, whose
last block holds one, its last two rows against their own launches and,
with its first two, against the plain sweep over prefixes. Last, the
over-subscribed capacity plan (the capacity fleet with 10 pods bound to a
missing node, then 2,000 pods of 48 cores on the hdd nodes and 4,000 of 40
cores anywhere, then the capacity plan's 50,000 pods; 1,010 pods find no
node, all before the last 50,000 bind): the one scan against the plain
version on all nine outputs over the first 6,010 pods (every failure,
failure counts included), against the grid at S = 1 on the seven state
outputs over the whole stream, simulate() through exactly one launch
reporting the reason strings of the plain version's counts, and the
counting pass timed by the card's global timer inside the kernel.
Then ``simon apply`` (phases 28-30): the apply plan (the capacity plan
plus 5,100 pods of 60 cores, one a node, so 100 new nodes must come out
of 128 candidates; ``fixtures.write_apply_plan``) written as YAML
directories and run through the port's ``Applier`` as a user would, its
steps timed against BASELINE.md's 10 s and its launches counted (two one
scans, two grids); the masked one scan at 0, n_new - 1 and n_new new
nodes against the coarse and fine grids' rows over the whole stream and
the plain version over a prefix, the minimality of n_new by those
launches, at 0 new nodes the first simulation's 100 reasons pod for pod
and the failing tail (the 5,100 large pods, from the kernel's usage
after the others) against the plain version on all nine outputs; and the three example configs, whose reports on the card equal
the plain versions' on the CPU. Each small case of phase 3 also runs as a
masked one scan (a node and a third of the pods masked out) against the
plain version. Every phase raises on failure.
The last lines are the card's name and power limit, one JSON line with
a row per kernel variant timed at full width, one for the drain sweep
and three for the apply plan (the masked one scan, the coarse and the fine
grid), and ``{"ok": true, "device": {...}}``.
Without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: float32 non-tensor-core FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
#: Every plan at its full size.
N_NODES = 5000
N_PODS = 50000
#: The drain sweep: scenarios (bench.py --scenarios default), and the
#: scenarios and pods its plain version is checked on, in a grid of one
#: scenario more, whose last block holds one scenario (1,001 is one more
#: than a multiple of every B the grid takes at this size): the first two
#: over a short prefix, and the last two (the last full block's last
#: scenario and the ragged block's) over a longer one.
N_SCENARIOS = 1000
PLAIN_SCENARIOS, PLAIN_PODS = 2, 2000
LATE_PODS = 5000
#: The over-subscribed plan's pods before the capacity plan's 50,000: 10
#: strays, 2,000 and 4,000 hog pods; the plain version checks them all.
OVER_HEAD = 6010
#: The apply plan: the capacity plan plus `hog`, one pod of 60 cores per
#: node and 100 more, so `simon apply` must add APPLY_NEW nodes of the
#: fleet's kind out of APPLY_MAX_NEW candidates; the plain version checks
#: the masked one scan over APPLY_PLAIN_PODS pods. BASELINE.md's target:
#: the whole command under APPLY_LIMIT_S seconds (recorded, not asserted).
APPLY_NEW = 100
APPLY_HOG = N_NODES + APPLY_NEW
APPLY_MAX_NEW = 128
APPLY_PLAIN_PODS = 2000
APPLY_LIMIT_S = 10.0
#: The example configs, their extended-resource reports and the kernel
#: variant each runs (phase 30 checks it against the launches).
EXAMPLES = (("simon-config.yaml", [], "fast_scan[interpod]"),
            ("simon-gpushare-config.yaml", ["gpu"], "fast_scan[gpu]"),
            ("simon-local-config.yaml", ["open-local"], "fast_scan[local]"))


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


def _same(got, want, what: str, fields=None) -> float:
    """Identical outputs, all nine unless `fields` names fewer (placements,
    usage, GPU takes, GPU, host-port, volume-group and device state, the
    failure counts and shortages), or raise; returns the largest absolute
    difference of the other outputs."""
    if not torch.equal(got.chosen, want.chosen):
        diff = got.chosen != want.chosen
        raise AssertionError(
            f"{what}: {int(diff.sum())} placements differ (first at {torch.nonzero(diff)[0].tolist()})"
        )
    err = 0.0
    for field in (fields or got._fields)[1:]:
        g, w = getattr(got, field), getattr(want, field)
        if g.shape != w.shape:
            raise AssertionError(f"{what}: {field} has shape {tuple(g.shape)}, want {tuple(w.shape)}")
        e = float((g - w).abs().max()) if g.numel() else 0.0
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: {field} differs, max abs err {e}")
        err = max(err, e)
    return err


def _small_preps(device):
    from opensim_tpu_torch.engine import fastpath, simulator as sim
    from opensim_tpu_torch.models import fixtures as fx

    for name, _n, _pad in fx.SCAN_CASES:
        cluster, app, node_pad = fx.scan_case(name)
        prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=device)
        yield name, prep, fastpath.build_inputs(prep)[0]


def _drain_grid(prep, drained):
    """The scenario grid's inputs for draining each node of `drained`:
    tmpl [P], valid and forced [S, P], node_valid [S, N], spr_weight [S, U, Cs]."""
    from opensim_tpu_torch.engine import fastpath
    from opensim_tpu_torch.planner import defrag

    return fastpath.sweep_inputs(prep, *defrag.drain_masks(prep, drained))


def small_cases(device) -> None:
    from opensim_tpu_torch.engine import fastpath
    from opensim_tpu_torch.ops import fast_scan as fs

    masked_failures = 0
    for name, prep, fi in _small_preps(device):
        stream = fastpath.pod_stream(prep)
        got = fs.fast_scan(fi, *stream)
        want = fs.fast_scan_reference(fi, *stream)
        _same(got, want, f"case {name}")
        # the same case on a masked node axis (node 1 out) and stream (every
        # third pod out), as the planner's masked re-simulation launches it
        node_valid = prep.ec_np.node_valid.copy()
        node_valid[min(1, len(node_valid) - 1)] = False
        pod_valid = np.arange(len(prep.tmpl_ids)) % 3 != 2
        fi_m = fastpath.build_inputs(prep, node_valid)[0]
        stream_m = fastpath.pod_stream(prep, pod_valid)
        got_m = fs.fast_scan(fi_m, *stream_m)
        _same(got_m, fs.fast_scan_reference(fi_m, *stream_m), f"case {name}, masked")
        failing_m = int(((got_m.chosen < 0) & (stream_m[1] != 0) & (stream_m[2] == 0)).sum())
        masked_failures += failing_m
        grid = _drain_grid(prep, list(range(min(3, len(prep.meta.node_names)))))
        got_s = fs.fast_scan_sweep(fi, *grid)
        want_s = fs.fast_scan_sweep_reference(fi, *grid)
        _same(got_s, want_s, f"case {name}, sweep of {grid[1].shape[0]} drains")
        counted = int(got.fail_counts.any(1).sum())
        print(f"case {name} ({fs.variant_name(fi)}): N={fi.alloc_T.shape[1]} P={len(prep.tmpl_ids)} "
              f"placed={int((got.chosen >= 0).sum())} counted failures={counted} gpu slots={int(got.gpu_take.sum())} "
              f"ports used={int(got.port_used.sum())} devices taken={int((got.dev_free < fi.dev0).sum())} "
              f"identical; sweep of {grid[1].shape[0]} drains identical "
              f"(placed {(got_s.chosen >= 0).sum(1).tolist()}); masked one scan identical "
              f"({int(pod_valid.sum())} pods on {int(node_valid.sum())} nodes, {failing_m} found no node)", flush=True)
    if masked_failures == 0:
        raise AssertionError("no masked small case had a pod that found no node")


def full_plan(device, label: str, make, variant: str, prefix=None) -> dict:
    """Kernel against its plain version over the first `prefix` pods of
    the stream (None: the whole stream), simulate() through the kernel,
    then the kernel timed alone over the whole stream. Returns the plan's
    row of the kernels table."""
    from opensim_tpu_torch.engine import fastpath, simulator as sim
    from opensim_tpu_torch.ops import fast_scan as fs

    span = "the whole stream" if prefix is None else f"its first {prefix} pods"
    _phase(f"{label}: {N_NODES} nodes, {N_PODS} pods, kernel vs plain over {span}")
    cluster, app = make()
    apps = [sim.AppResource("plan", app)]
    prep = sim.prepare(cluster, apps, device=device)
    miss = fastpath.why_not(prep)
    if miss is not None:
        raise AssertionError(f"the plan falls outside the envelope: {miss}")
    fi, _ = fastpath.build_inputs(prep)
    if fs.variant_name(fi) != variant:
        raise AssertionError(f"the plan runs {fs.variant_name(fi)}, not {variant}")
    tmpl, valid, forced = fastpath.pod_stream(prep)
    P, N = tmpl.shape[0], fi.alloc_T.shape[1]
    head = (tmpl, valid, forced) if prefix is None else tuple(t[:prefix].contiguous() for t in (tmpl, valid, forced))
    P_head = head[0].shape[0]
    got_head = fs.fast_scan(fi, *head)
    torch.cuda.synchronize()
    plain = [None]

    def run_plain():
        plain[0] = fs.fast_scan_reference(fi, *head)

    plain_ms = _events_ms(run_plain, reps=1)
    err = _same(got_head, plain[0], f"{label}, {P_head} pods")
    print(f"{P_head} pods at N={N}: kernel and plain version identical on all nine outputs "
          f"(plain {plain_ms:.3f} ms, {int(got_head.gpu_take.sum())} GPU slots taken, "
          f"{int(got_head.port_used.sum())} host ports used)", flush=True)
    whole = fs.fast_scan(fi, tmpl, valid, forced)
    grid1 = [None]

    def run_grid1():
        grid1[0] = fs.fast_scan_sweep(fi, tmpl, valid[None], forced[None], fi.node_valid[None], fi.spr_weight[None])

    grid1_ms = _events_ms(run_grid1, reps=1)
    err = max(err, _same(whole, fs.FastOutputs(*(t[0] for t in grid1[0])),
                         f"{label}: one scan vs the grid at S=1 over {P} pods", fs.STATE_FIELDS))
    print(f"{P} pods: one scan and the grid at S=1 identical on all seven outputs over the whole stream "
          f"(grid at S=1 {grid1_ms:.3f} ms)", flush=True)

    _phase(f"{label}: simulate(), {N_PODS} pods on {N_NODES} nodes")
    cluster, app = make()  # fresh objects: simulate() writes into its pods
    apps = [sim.AppResource("plan", app)]
    torch.cuda.synchronize()
    fs.LAUNCHES = 0
    fs.VARIANT_LAUNCHES.clear()
    res = sim.simulate(cluster, apps, device=device)
    launches, by_variant = fs.LAUNCHES, dict(fs.VARIANT_LAUNCHES)
    launched = fs.SCAN_LAUNCHED[variant]  # the shape simulate()'s launch ran and its kernel's ptxas report
    n_placed = sum(len(ns.pods) for ns in res.node_status)
    if launches != 1 or by_variant != {variant: 1}:
        raise AssertionError(f"simulate() launched {by_variant}, want exactly one {variant}")
    if len(res.placements) != P or (res.placements < 0).any() or n_placed != P:
        raise AssertionError(f"placed {n_placed} of {P} pods")
    for field, shape in (("used", (N, fi.alloc_T.shape[0])), ("gpu_take", (P, prep.st0_np.gpu_free.shape[1])),
                         ("gpu_free", prep.st0_np.gpu_free.shape), ("vg_free", prep.st0_np.vg_free.shape),
                         ("dev_free", prep.st0_np.dev_free.shape)):
        arr = torch.from_numpy(getattr(res, field))
        if tuple(arr.shape) != tuple(shape) or not bool(torch.isfinite(arr).all()):
            raise AssertionError(f"simulate(): {field} has the wrong shape or non-finite values")
    head_placements = torch.from_numpy(res.placements[:P_head])
    if not torch.equal(got_head.chosen.cpu(), head_placements):
        raise AssertionError("simulate() placed the stream differently from the checked kernel run")
    if got_head.gpu_take.numel() and not torch.equal(got_head.gpu_take.cpu(), torch.from_numpy(res.gpu_take[:P_head])):
        raise AssertionError("simulate() took GPUs differently from the checked kernel run")
    if prep.features.local:
        storage = [ns.node.metadata.annotations.get("simon/node-local-storage") for ns in res.node_status]
        if not all(storage) or not (res.vg_free < prep.st0_np.vg_free).any():
            raise AssertionError("simulate() wrote no local-storage state")
    wall = sum(res.timings.values())
    print(f"placed {n_placed}/{P} pods, kernel launches {by_variant}")
    shape = {k: v for k, v in launched["shape"]._asdict().items() if k != "offsets"}
    print(f"one scan launched as {json.dumps(shape)}; ptxas {json.dumps(launched['ptxas'])}")
    print("timings: " + json.dumps({k: round(v, 6) for k, v in res.timings.items()}))
    print(f"plan wall-clock {wall:.6f} s, {P / wall:.1f} pods/s (host clock)", flush=True)

    _phase(f"{label}: the kernel over the whole stream (CUDA events)")
    ms = _events_ms(lambda: fs.fast_scan(fi, tmpl, valid, forced), reps=3)
    work = fs.fast_scan_work(fi, tmpl, valid, forced, torch.from_numpy(res.placements))
    t_bytes = work["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = work["ops"] / PEAK_F32_S * 1e3
    print(f"kernel {ms:.3f} ms ({ms * 1e3 / P:.3f} us/pod), plain {plain_ms:.3f} ms over {P_head} pods "
          f"({plain_ms * 1e3 / P_head:.3f} us/pod), bound {max(t_bytes, t_ops):.6f} ms "
          f"({work['bytes']} B, {work['ops']} flop)", flush=True)
    return {
        "name": variant,
        "plan": label.split(" ", 1)[1],
        "route": "cuda",
        "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu",
        "replaces": "opensim_tpu/ops/pallas_scan.py:1009",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "pods": P,
        "plain_pods": P_head,
        "grid_s1_ms": grid1_ms,
        "cluster": shape["cluster"],
        "threads": shape["threads"],
        "smem": shape["smem"],
        "resident": shape["resident"],
        "ptxas": launched["ptxas"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


def drain_sweep(device) -> dict:
    """plan_drains() on the capacity plan with N_SCENARIOS drain scenarios
    (one launch of the scenario grid), the grid's rows against
    single-scenario launches and against the plain sweep, the grid timed
    alone. Returns its row of the kernels table."""
    from opensim_tpu_torch.engine import fastpath, simulator as sim
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.planner import defrag

    _phase(f"22 drain sweep: plan_drains(), {N_SCENARIOS} scenarios of {N_PODS} pods on {N_NODES} nodes")
    cluster, app = fx.synthetic_cluster(N_NODES), fx.synthetic_apps(N_PODS)
    apps = [sim.AppResource("plan", app)]
    candidates = [n.metadata.name for n in cluster.nodes[:N_SCENARIOS]]
    torch.cuda.synchronize()
    fs.LAUNCHES = 0
    fs.VARIANT_LAUNCHES.clear()
    fs.SWEEP_LAUNCHED.clear()
    t0 = time.perf_counter()
    result = defrag.plan_drains(cluster, apps, candidates=candidates)
    wall = time.perf_counter() - t0
    launches, by_name = fs.LAUNCHES, dict(fs.VARIANT_LAUNCHES)
    launched = fs.SWEEP_LAUNCHED["fast_scan_sweep"]  # the grid that ran and its library's ptxas report
    grid_shape, ptxas = launched["grid"], launched["ptxas"]
    if launches != 1 or by_name != {"fast_scan_sweep": 1}:
        raise AssertionError(f"plan_drains() launched {by_name}, want exactly one fast_scan_sweep")
    plans = result.plans
    if [p.node for p in plans] != candidates:
        raise AssertionError("plan_drains() returned plans for other nodes than the candidates")
    print(f"plan_drains: {len(plans)} plans, {len(result.drainable())} drainable, launches {by_name}")
    print("timings: " + json.dumps({k: round(v, 6) for k, v in result.timings.items()}))
    print(f"plan_drains wall-clock {wall:.6f} s, {len(plans) / wall:.3f} scenarios/s (host clock)", flush=True)

    print(f"grid at S={N_SCENARIOS}: {grid_shape.b} scenarios per block, {grid_shape.blocks} blocks of "
          f"{grid_shape.threads} threads, {grid_shape.smem} B of dynamic shared memory; "
          f"sweep kernel ptxas {json.dumps(ptxas)}", flush=True)

    _phase("23 drain sweep: the grid timed alone, its rows against single-scenario launches")
    prep = sim.prepare(cluster, apps, device=device)
    fi, _ = fastpath.build_inputs(prep)
    drained = list(range(N_SCENARIOS))
    tmpl, *grid = _drain_grid(prep, drained)
    out = [None]

    def run_grid():
        out[0] = fs.fast_scan_sweep(fi, tmpl, *grid)

    ms = _events_ms(run_grid, reps=1)
    sweep = out[0]
    unscheduled = ((sweep.chosen < 0) & (grid[0] != 0)).sum(1).cpu().numpy()
    if unscheduled.tolist() != [p.unscheduled for p in plans]:
        raise AssertionError("the timed grid and plan_drains() disagree on unscheduled pods")
    for s, d in enumerate(drained):
        if bool((sweep.chosen[s] == d).any()):
            raise AssertionError(f"scenario {s} placed a pod on its drained node {d}")
    if not bool(torch.isfinite(sweep.used).all()):
        raise AssertionError("the sweep's usage is not finite")

    def own_launches(sweep, grid, rows, what):
        err = 0.0
        for s in rows:
            one = fs.fast_scan(fi._replace(node_valid=grid[2][s], spr_weight=grid[3][s]), tmpl, grid[0][s], grid[1][s])
            err = max(err, _same(fs.FastOutputs(*(t[s] for t in sweep)), one, f"{what} scenario {s} vs its own launch",
                                 fs.STATE_FIELDS))
        return err

    checked = [0, N_SCENARIOS // 2, N_SCENARIOS - 1]
    err = own_launches(sweep, grid, checked, "sweep")
    print(f"sweep kernel {ms:.3f} ms for {N_SCENARIOS} scenarios ({ms / N_SCENARIOS:.3f} ms/scenario); "
          f"scenarios {checked} identical to single-scenario launches over the whole stream", flush=True)

    S_r = N_SCENARIOS + 1
    ragged = fs.sweep_grid(S_r, N_NODES, torch.cuda.get_device_properties(0).multi_processor_count)
    late = [S_r - 2, S_r - 1]
    _phase(f"24 drain sweep: a grid of {S_r} scenarios ({ragged.blocks} blocks, the last holding "
           f"{S_r - (ragged.blocks - 1) * ragged.b}): scenarios {late} against their own launches; kernel vs "
           f"plain sweep, scenarios 0-{PLAIN_SCENARIOS - 1} x {PLAIN_PODS} pods and {late} x {LATE_PODS} pods")
    tmpl_r, *grid_r = _drain_grid(prep, list(range(S_r)))
    err = max(err, own_launches(fs.fast_scan_sweep(fi, tmpl_r, *grid_r), grid_r, late, "ragged grid"))
    if fs.SWEEP_LAUNCHED["fast_scan_sweep"]["grid"] != ragged:
        raise AssertionError(f"the ragged grid ran as {fs.SWEEP_LAUNCHED['fast_scan_sweep']['grid']}, not {ragged}")
    print(f"scenarios {late} of the {S_r}-scenario grid identical to single-scenario launches over the whole "
          f"stream", flush=True)
    plain_ms = 0.0
    for rows, pods in ((slice(0, PLAIN_SCENARIOS), PLAIN_PODS), (slice(late[0], late[-1] + 1), LATE_PODS)):
        head = [t[:, :pods].contiguous() for t in grid_r[:2]] + grid_r[2:]
        got = fs.fast_scan_sweep(fi, tmpl_r[:pods].contiguous(), *head)  # all S_r scenarios
        got = fs.FastOutputs(*(t[rows] for t in got))
        plain = [None]

        def run_plain():
            plain[0] = fs.fast_scan_sweep_reference(fi, tmpl_r[:pods].contiguous(), *(t[rows] for t in head))

        ms_rows = _events_ms(run_plain, reps=1)
        plain_ms += ms_rows
        err = max(err, _same(got, plain[0], f"sweep scenarios {rows.start}-{rows.stop - 1} x {pods} pods vs plain"))
        print(f"scenarios {rows.start}-{rows.stop - 1} of the grid x {pods} pods identical to the plain sweep "
              f"(plain {ms_rows:.3f} ms)", flush=True)
    work = fs.fast_scan_work(fi, tmpl, grid[0], grid[1], sweep.chosen, grid[2])
    t_bytes = work["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = work["ops"] / PEAK_F32_S * 1e3
    print(f"plain {plain_ms:.3f} ms in all; bound {max(t_bytes, t_ops):.6f} ms "
          f"({work['bytes']} B, {work['ops']} flop)", flush=True)
    return {
        "name": "fast_scan_sweep",
        "route": "cuda",
        "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu",
        "replaces": "opensim_tpu/engine/fastpath.py:532",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "scenarios": N_SCENARIOS,
        "pods": int(tmpl.shape[0]),
        "b": grid_shape.b,
        "blocks": grid_shape.blocks,
        "threads": grid_shape.threads,
        "smem": grid_shape.smem,
        "ptxas": ptxas,
        "own_launch_checks": checked + [f"{s} of {S_r}" for s in late],
        "plain_checks": [[0, PLAIN_SCENARIOS - 1, PLAIN_PODS], [late[0], late[-1], LATE_PODS]],
        "plain_pod_scenarios": PLAIN_SCENARIOS * PLAIN_PODS + len(late) * LATE_PODS,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "plan_drains_s": wall,
        "plan_drains_timings": result.timings,
        "scenarios_per_s": len(plans) / wall,
        "drainable": len(result.drainable()),
    }


def oversubscribed_plan(device) -> list:
    """The over-subscribed capacity plan through the one scan's counting
    pass: kernel vs plain over the first OVER_HEAD pods (every failure) on
    all nine outputs, vs the grid at S = 1 on the seven state outputs over
    the whole stream; simulate() through exactly one launch, its reasons
    those of the plain version's counts; the kernel timed over the whole
    stream and its counting passes by their own clock. Returns the plan's
    row and the counting pass's row of the kernels table."""
    from opensim_tpu_torch.engine import fastpath, reasons, simulator as sim
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs

    variant = "fast_scan"

    def make():
        return fx.oversubscribed_cluster(N_NODES), [
            sim.AppResource(name, app) for name, app in fx.oversubscribed_apps(N_NODES, N_PODS)]

    _phase(f"25 over-subscribed plan: {N_NODES} nodes, {N_PODS + OVER_HEAD} pods, kernel vs plain over its first "
           f"{OVER_HEAD} pods (every failure), vs the grid at S=1 over the whole stream")
    prep = sim.prepare(*make(), device=device)
    if fastpath.why_not(prep) is not None:
        raise AssertionError(f"the plan falls outside the envelope: {fastpath.why_not(prep)}")
    fi, built = fastpath.build_inputs(prep)
    if fs.variant_name(fi) != variant:
        raise AssertionError(f"the plan runs {fs.variant_name(fi)}, not {variant}")
    tmpl, valid, forced = fastpath.pod_stream(prep)
    P, N = tmpl.shape[0], fi.alloc_T.shape[1]
    head = tuple(t[:OVER_HEAD].contiguous() for t in (tmpl, valid, forced))
    got_head = fs.fast_scan(fi, *head)
    torch.cuda.synchronize()
    plain = [None]

    def run_plain():
        plain[0] = fs.fast_scan_reference(fi, *head)

    plain_ms = _events_ms(run_plain, reps=1)
    err = _same(got_head, plain[0], f"over-subscribed plan, {OVER_HEAD} pods")
    count_err = max(float((got_head.fail_counts - plain[0].fail_counts).abs().max()),
                    float((got_head.insufficient - plain[0].insufficient).abs().max()))
    failing = (got_head.chosen < 0) & (head[2] == 0)
    n_failing, n_forced = int(failing.sum()), int(((got_head.chosen < 0) & (head[2] != 0)).sum())
    if n_failing == 0 or not bool(got_head.fail_counts[failing].any(1).all()):
        raise AssertionError(f"{n_failing} failing pods, not every one counted")
    print(f"{OVER_HEAD} pods at N={N}: kernel and plain version identical on all nine outputs (plain "
          f"{plain_ms:.3f} ms); {n_failing} pods found no node and were counted, {n_forced} forced pods "
          f"found none", flush=True)
    whole = fs.fast_scan(fi, tmpl, valid, forced)
    grid1 = fs.fast_scan_sweep(fi, tmpl, valid[None], forced[None], fi.node_valid[None], fi.spr_weight[None])
    err = max(err, _same(whole, fs.FastOutputs(*(t[0] for t in grid1)),
                         f"over-subscribed plan: one scan vs the grid at S=1 over {P} pods", fs.STATE_FIELDS))
    if not torch.equal(whole.fail_counts[:OVER_HEAD], got_head.fail_counts) or whole.fail_counts[OVER_HEAD:].any():
        raise AssertionError("the whole stream's counts differ from the checked prefix's")
    print(f"{P} pods: one scan and the grid at S=1 identical on the seven state outputs; the whole stream's "
          f"counts are the prefix's", flush=True)

    _phase(f"26 over-subscribed plan: simulate(), {P} pods on {N_NODES} nodes")
    fresh = make()  # new objects: simulate() writes into its pods
    torch.cuda.synchronize()
    fs.LAUNCHES = 0
    fs.VARIANT_LAUNCHES.clear()
    fs.SCAN_LAUNCHED.clear()
    res = sim.simulate(*fresh, device=device)
    launches, by_variant = fs.LAUNCHES, dict(fs.VARIANT_LAUNCHES)
    passes = int(fs.SCAN_LAUNCHED[variant]["count_clock"][1])  # counting passes in simulate()'s launch
    if launches != 1 or by_variant != {variant: 1}:
        raise AssertionError(f"simulate() launched {by_variant}, want exactly one {variant}")
    if passes != n_failing:
        raise AssertionError(f"simulate()'s launch ran {passes} counting passes, want {n_failing}")
    want = []
    for i in torch.nonzero(plain[0].chosen < 0).flatten().tolist():
        if prep.forced[i]:
            want.append(reasons.node_not_found(prep.ordered[i].spec.node_name))
        else:
            want.append(sim._reason_string(built["static_fail"][prep.tmpl_ids[i]], plain[0].fail_counts[i].cpu().numpy(),
                                           plain[0].insufficient[i].cpu().numpy(), prep.meta, prep.meta.n_real_nodes))
    got = [u.reason for u in res.unscheduled_pods]
    if got != want:
        raise AssertionError(f"simulate() reported {len(got)} unscheduled pods, want the plain version's {len(want)}")
    n_placed = sum(len(ns.pods) for ns in res.node_status)
    if n_placed != P - len(want) or n_placed != int((res.placements >= 0).sum()) or (res.placements[OVER_HEAD:] < 0).any():
        raise AssertionError(f"placed {n_placed} of {P} pods, {len(want)} unscheduled")
    hist = {}
    for r in got:
        hist[r] = hist.get(r, 0) + 1
    print(f"placed {n_placed}/{P} pods, {len(got)} unscheduled with the plain version's reasons, kernel launches "
          f"{by_variant}, {passes} counting passes")
    for r, n in sorted(hist.items(), key=lambda x: -x[1]):
        print(f"  {n:6d} x {r}")
    wall = sum(res.timings.values())
    print("timings: " + json.dumps({k: round(v, 6) for k, v in res.timings.items()}))
    print(f"plan wall-clock {wall:.6f} s, {P / wall:.1f} pods/s (host clock)", flush=True)

    _phase("27 over-subscribed plan: the kernel over the whole stream (CUDA events), its counting passes "
           "(the card's global timer)")
    clocks = []

    def run_kernel():
        fs.fast_scan(fi, tmpl, valid, forced)
        clocks.append(fs.SCAN_LAUNCHED[variant]["count_clock"])

    ms = _events_ms(run_kernel, reps=3)
    count_ms = sum(int(c[0]) for c in clocks) / len(clocks) / 1e6
    work = fs.fast_scan_work(fi, tmpl, valid, forced, torch.from_numpy(res.placements))
    bound = lambda w: (w["bytes"] / PEAK_BYTES_S * 1e3, w["ops"] / PEAK_F32_S * 1e3)
    t_bytes, t_ops = bound(work)
    c_bytes, c_ops = bound(work["count"])
    launched = fs.SCAN_LAUNCHED[variant]
    shape = {k: v for k, v in launched["shape"]._asdict().items() if k != "offsets"}
    print(f"kernel {ms:.3f} ms ({ms * 1e3 / P:.3f} us/pod), bound {max(t_bytes, t_ops):.6f} ms; counting passes "
          f"{count_ms:.3f} ms ({count_ms * 1e3 / n_failing:.3f} us each over {n_failing}), bound "
          f"{max(c_bytes, c_ops):.6f} ms ({work['count']['bytes']} B, {work['count']['ops']} op); "
          f"plain {plain_ms:.3f} ms over {OVER_HEAD} pods", flush=True)
    plan_row = {
        "name": variant, "plan": "over-subscribed plan", "route": "cuda",
        "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu", "replaces": "opensim_tpu/ops/pallas_scan.py:1009",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "pods": P,
        "plain_pods": OVER_HEAD, "unscheduled": len(got), "cluster": shape["cluster"], "threads": shape["threads"],
        "smem": shape["smem"], "resident": shape["resident"], "ptxas": launched["ptxas"],
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    count_row = {
        "name": "fast_scan:count_fails", "plan": "over-subscribed plan", "route": "cuda",
        "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu", "replaces": "opensim_tpu/ops/kernels.py:1042",
        "launches": passes, "max_abs_err": count_err, "ms": count_ms, "plain_ms": plain_ms,
        "plain_pods": OVER_HEAD, "us_per_pass": count_ms * 1e3 / n_failing,
        "bound_ms": max(c_bytes, c_ops), "bound_by": "bytes" if c_bytes >= c_ops else "operations",
        "library_ms": None,
    }
    return [plan_row, count_row]


def _without_counters(text: str) -> str:
    """A report without its engine footer, new-node and pod names without
    their process-global counters (simon-<8 hex>, <name>-<10 hex>)."""
    import re

    text = re.sub(r"-[0-9a-f]{10}\b", "-#", re.sub(r"simon-[0-9a-f]{8}\b", "simon-#", text))
    return "\n".join(line for line in text.splitlines() if not line.startswith("Scheduling engine: "))


def _plan_dir() -> Path:
    from opensim_tpu_torch.ops import fast_scan as fs

    return Path(fs.BUILD_DIR) / "smoke"


def _example(name: str) -> str:
    return str(Path(__file__).resolve().parent / "example" / name)


def _apply_failures(applier, prep, fi_k, tmpl, valid, node_valid, forced, out) -> tuple:
    """The first simulation's failures at full width, on the masked node
    axis of k = 0 (the candidates out): the reasons of the masked one
    scan's counts (`out`) equal the Applier's first simulation's, pod for
    pod, each the expected string; then the hog pods that close the stream
    run from the kernel's usage after the bench pods, by the kernel (equal
    to `out`'s rows over them) and by the plain version, on all nine
    outputs, so the failing pods' counts and shortages are the plain
    version's. Returns the largest difference and the plain version's ms."""
    from opensim_tpu_torch.engine import fastpath, simulator as sim
    from opensim_tpu_torch.models.objects import LABEL_APP_NAME
    from opensim_tpu_torch.ops import fast_scan as fs

    static_fail = fastpath.build_inputs(prep, node_valid.cpu().numpy() != 0)[1]["static_fail"]
    n_valid = int(node_valid.sum())
    failed = torch.nonzero((out.chosen < 0) & (valid != 0)).flatten().tolist()
    got = [(prep.ordered[i].metadata.name,
            sim._reason_string(static_fail[prep.tmpl_ids[i]], out.fail_counts[i].cpu().numpy(),
                               out.insufficient[i].cpu().numpy(), prep.meta, n_valid)) for i in failed]
    first = [(u.pod.metadata.name, u.reason) for u in applier.first_result.unscheduled_pods]
    want = f"0/{N_NODES} nodes are available: {N_NODES} Insufficient cpu, {N_NODES} Insufficient memory."
    if got != first:
        raise AssertionError(f"k=0: the masked one scan's {len(got)} failures differ from the first simulation's "
                             f"{len(first)}: {[g for g in got if g not in first][:3]}")
    if len(got) != APPLY_NEW or any(r != want for _name, r in got):
        raise AssertionError(f"k=0: want {APPLY_NEW} pods each '{want}', got {len(got)}: "
                             f"{sorted({r for _name, r in got})[:3]}")
    print(f"k=0: the masked one scan's {len(got)} failures are the first simulation's, pod for pod, each "
          f"'{want}'", flush=True)

    apps = [p.metadata.labels.get(LABEL_APP_NAME) for p in prep.ordered]
    t0 = len(apps) - APPLY_HOG
    if apps[t0:] != ["hog"] * APPLY_HOG or "hog" in apps[:t0] or fs.variant_name(fi_k) != "fast_scan":
        raise AssertionError("the apply plan's stream does not close with its hog pods on the base variant")
    head = fs.fast_scan(fi_k, tmpl[:t0].contiguous(), valid[:t0].contiguous(), forced[:t0].contiguous())
    fi_tail = fi_k._replace(used0_T=head.used.clone())
    tail = (tmpl[t0:].contiguous(), valid[t0:].contiguous(), forced[t0:].contiguous())
    got_tail = fs.fast_scan(fi_tail, *tail)
    per_pod = ("chosen", "gpu_take", "fail_counts", "insufficient")
    err = _same(got_tail, fs.FastOutputs(*(getattr(out, f)[t0:] if f in per_pod else getattr(out, f)
                                            for f in fs.FastOutputs._fields)),
                f"k=0: the hog pods from the kernel's state after pod {t0} vs the whole stream's launch")
    plain = [None]

    def run_plain():
        plain[0] = fs.fast_scan_reference(fi_tail, *tail)

    plain_ms = _events_ms(run_plain, reps=1)
    err = max(err, _same(got_tail, plain[0], f"k=0: the hog pods from the kernel's state after pod {t0} vs plain"))
    failing = int((got_tail.chosen < 0).sum())
    print(f"k=0: the {APPLY_HOG} hog pods from the kernel's usage after pod {t0}: kernel identical to the whole "
          f"stream's launch and to the plain version on all nine outputs ({failing} found no node, their counts "
          f"and shortages included; plain {plain_ms:.3f} ms)", flush=True)
    return err, plain_ms


def apply_plan(device, card: str) -> list:
    """`simon apply` on the apply plan through the port's Applier as a
    user runs it (YAML directories, the card): its launches, the new-node
    count, the steps' host-clock times against BASELINE.md's 10 s; then
    the path's masked one scan at k = 0, n_new - 1 and n_new new nodes
    against the rows of the coarse and fine grids for those k (the seven
    state outputs, over the whole stream) and against the plain version
    over a prefix (all nine), each grid timed alone, and at k = 0 the
    first simulation's failures (:func:`_apply_failures`). Returns the
    rows of the masked one scan and the two grids."""
    from opensim_tpu_torch.engine import fastpath
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.parallel import scenarios
    from opensim_tpu_torch.planner import apply

    _phase(f"28 apply plan: simon apply on {N_NODES} nodes, {N_PODS} + {APPLY_HOG} pods, "
           f"{APPLY_MAX_NEW} candidate nodes (Applier.run() on the card)")
    root = _plan_dir() / "apply"
    config = fx.write_apply_plan(root, N_NODES, N_PODS, APPLY_HOG)
    report = root / "report.txt"
    torch.cuda.synchronize()
    fs.LAUNCHES = 0
    fs.VARIANT_LAUNCHES.clear()
    fs.SCAN_LAUNCHED.clear()
    fs.SWEEP_LAUNCHED.clear()
    t0 = time.perf_counter()
    applier = apply.Applier(apply.Options(simon_config=config, output_file=str(report),
                                          max_new_nodes=APPLY_MAX_NEW))
    rc = applier.run()
    wall = time.perf_counter() - t0
    by_name = dict(fs.VARIANT_LAUNCHES)
    scan_shape = fs.SCAN_LAUNCHED["fast_scan"]["shape"]  # the masked re-simulation's launch, N = 5,128
    text = report.read_text()
    if rc != 0 or "Simulation success!" not in text:
        raise AssertionError(f"simon apply returned {rc}:\n{text[:2000]}")
    if by_name != {"fast_scan": 2, "fast_scan_sweep": 2}:
        raise AssertionError(f"simon apply launched {by_name}, want two one scans (first simulation, masked "
                             f"re-simulation) and two grids (coarse, fine)")
    n_new = applier.n_new
    (coarse, coarse_s), (fine, fine_s) = applier.sweeps
    print(f"simon apply: rc {rc}, {n_new} new nodes, launches {by_name}; sweeps {coarse} then "
          f"{fine[0]}..{fine[-1]} ({len(fine)} scenarios)")
    print(f"masked one scan at N={len(applier.prep_full.meta.node_names)} launched as "
          f"{json.dumps({k: v for k, v in scan_shape._asdict().items() if k != 'offsets'})}")
    steps = dict(applier.timings, **{"sweep: coarse": coarse_s, "sweep: fine": fine_s})
    print("steps: " + json.dumps({k: round(v, 6) for k, v in steps.items()}))
    verdict = "met" if wall < APPLY_LIMIT_S else "missed"
    print(f"simon apply wall-clock {wall:.6f} s against the {APPLY_LIMIT_S:.0f} s limit: {verdict} ({card})",
          flush=True)
    if n_new != APPLY_NEW or f"(added {APPLY_NEW} new node(s))" not in text:
        raise AssertionError(f"simon apply added {n_new} nodes, want {APPLY_NEW}")

    _phase(f"29 apply plan: the masked one scan at k = 0, {n_new - 1} and {n_new} against the coarse and fine "
           f"grids' rows over the whole stream and the plain version over {APPLY_PLAIN_PODS} pods; at k = 0 the "
           f"first simulation's reasons and the failing tail of {APPLY_HOG} pods against the plain version")
    prep = applier.prep_full
    n_real = N_NODES
    fi, _ = fastpath.build_inputs(prep)
    forced = torch.from_numpy(prep.forced.astype(np.int32)).to(device)
    rows, grids = [], {}
    for label, ks in (("coarse", coarse), ("fine", fine)):
        node_valid, pod_valid = scenarios.count_masks(prep, n_real, ks)
        tmpl, *grid = fastpath.sweep_inputs(prep, node_valid, pod_valid, np.broadcast_to(prep.forced, pod_valid.shape))
        out = [None]

        def run_grid():
            out[0] = fs.fast_scan_sweep(fi, tmpl, *grid)

        grid_ms = _events_ms(run_grid, reps=1)
        launched = fs.SWEEP_LAUNCHED["fast_scan_sweep"]
        unscheduled = ((out[0].chosen < 0) & (grid[0] != 0)).sum(1).tolist()
        grids[label] = (ks, grid, out[0])
        # the rows of the k that phase 29 checks, against the plain sweep over a prefix
        sel = [ks.index(k) for k in ((0,) if label == "coarse" else (n_new - 1, n_new))]
        head = [t[:, :APPLY_PLAIN_PODS].contiguous() for t in grid[:2]] + grid[2:]
        got = fs.fast_scan_sweep(fi, tmpl[:APPLY_PLAIN_PODS].contiguous(), *head)
        plain = [None]

        def run_plain():
            plain[0] = fs.fast_scan_sweep_reference(fi, tmpl[:APPLY_PLAIN_PODS].contiguous(), *(t[sel] for t in head))

        plain_ms = _events_ms(run_plain, reps=1)
        err = _same(fs.FastOutputs(*(t[sel] for t in got)), plain[0], f"{label} grid rows {sel} vs plain")
        work = fs.fast_scan_work(fi, tmpl, grid[0], grid[1], out[0].chosen, grid[2])
        t_bytes, t_ops = work["bytes"] / PEAK_BYTES_S * 1e3, work["ops"] / PEAK_F32_S * 1e3
        print(f"{label} grid, S={len(ks)}: {grid_ms:.3f} ms ({launched['grid'].b} scenarios per block, "
              f"{launched['grid'].blocks} blocks); unscheduled {dict(zip(ks, unscheduled))}; rows {sel} identical "
              f"to the plain sweep over {APPLY_PLAIN_PODS} pods (plain {plain_ms:.3f} ms); bound "
              f"{max(t_bytes, t_ops):.6f} ms", flush=True)
        rows.append({
            "name": "fast_scan_sweep", "plan": f"apply plan, {label} sweep", "route": "cuda",
            "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu", "replaces": "opensim_tpu/engine/fastpath.py:532",
            "launches": by_name["fast_scan_sweep"], "launches_are": "the path's two grids, coarse and fine",
            "max_abs_err": err, "ms": grid_ms, "plain_ms": plain_ms, "scenarios": len(ks),
            "pods": int(tmpl.shape[0]), "plain_checks": [sel, APPLY_PLAIN_PODS], "b": launched["grid"].b,
            "blocks": launched["grid"].blocks, "threads": launched["grid"].threads, "ptxas": launched["ptxas"],
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "host_s": coarse_s if label == "coarse" else fine_s,
        })

    err, one = 0.0, {}
    for k, label in ((0, "coarse"), (n_new - 1, "fine"), (n_new, "fine")):
        ks, grid, out = grids[label]
        s = ks.index(k)
        fi_k, _ = fastpath.build_inputs(prep, grid[2][s].cpu().numpy() != 0)
        if not torch.equal(fi_k.spr_weight, grid[3][s]) or not torch.equal(fi_k.node_valid, grid[2][s]):
            raise AssertionError(f"k={k}: the masked one scan's validity or spread weights are not the grid's")
        clocks = []

        def run_one():
            one[k] = fs.fast_scan(fi_k, tmpl, grid[0][s], forced)
            clocks.append(int(fs.SCAN_LAUNCHED["fast_scan"]["count_clock"][1]))

        ms_k = _events_ms(run_one, reps=3 if k == n_new else 1)
        err = max(err, _same(one[k], fs.FastOutputs(*(t[s] for t in out)),
                             f"masked one scan at k={k} vs the {label} grid's row", fs.STATE_FIELDS))
        failing = int(((one[k].chosen < 0) & (grid[0][s] != 0) & (forced == 0)).sum())
        if clocks[-1] != failing:
            raise AssertionError(f"k={k}: {clocks[-1]} counting passes for {failing} pods that found no node")
        print(f"k={k}: masked one scan {ms_k:.3f} ms, identical to the {label} grid's row on the seven state "
              f"outputs over {int(grid[0][s].sum())} pods; {failing} pods found no node ({clocks[-1]} counting "
              f"passes)", flush=True)
        if k == 0:
            tail_err, tail_plain_ms = _apply_failures(applier, prep, fi_k, tmpl, grid[0][s], grid[2][s], forced,
                                                      one[k])
            err = max(err, tail_err)
        if k == n_new:
            ms, fi_new, valid_new = ms_k, fi_k, grid[0][s]
        if (k == n_new) != (failing == 0):
            raise AssertionError(f"k={k}: {failing} pods found no node; the answer {n_new} is not minimal")
        if k == n_new - 1:
            head = (tmpl[:APPLY_PLAIN_PODS].contiguous(), grid[0][s][:APPLY_PLAIN_PODS].contiguous(),
                    forced[:APPLY_PLAIN_PODS].contiguous())
            plain = [None]

            def run_plain():
                plain[0] = fs.fast_scan_reference(fi_k, *head)

            plain_ms = _events_ms(run_plain, reps=1)
            err = max(err, _same(fs.fast_scan(fi_k, *head), plain[0], f"masked one scan at k={k}, "
                                 f"{APPLY_PLAIN_PODS} pods vs plain"))
            print(f"k={k}: masked one scan and plain version identical on all nine outputs over "
                  f"{APPLY_PLAIN_PODS} pods (plain {plain_ms:.3f} ms)", flush=True)
    work = fs.fast_scan_work(fi_new, tmpl, valid_new, forced, one[n_new].chosen)
    t_bytes, t_ops = work["bytes"] / PEAK_BYTES_S * 1e3, work["ops"] / PEAK_F32_S * 1e3
    launched = fs.SCAN_LAUNCHED["fast_scan"]
    print(f"masked one scan at k={n_new}: {ms:.3f} ms, bound {max(t_bytes, t_ops):.6f} ms", flush=True)
    rows.insert(0, {
        "name": "fast_scan", "plan": f"apply plan, masked re-simulation at k={n_new}", "route": "cuda",
        "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu", "replaces": "opensim_tpu/ops/pallas_scan.py:1009",
        "launches": by_name["fast_scan"], "launches_are": "the path's two one scans, first simulation and masked",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "pods": int(tmpl.shape[0]),
        "plain_pods": APPLY_PLAIN_PODS, "plain_tail": [APPLY_HOG, tail_plain_ms], "nodes": int(fi.alloc_T.shape[1]), "valid_nodes": N_NODES + n_new,
        "cluster": scan_shape.cluster, "threads": scan_shape.threads, "smem": scan_shape.smem,
        "resident": scan_shape.resident, "ptxas": launched["ptxas"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
        "apply_wall_s": wall, "apply_steps_s": steps, "apply_limit_s": APPLY_LIMIT_S, "apply_limit": verdict,
    })
    return rows


def example_reports(device) -> None:
    """The example configs through the port's Applier, on the CPU (the
    plain versions) and on the card: the two reports equal."""
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.planner import apply

    _phase("30 example configs: simon apply on the card against the plain versions on the CPU")
    root = _plan_dir() / "examples"
    root.mkdir(parents=True, exist_ok=True)
    for config, extended, variant in EXAMPLES:
        runs = []
        for where, dev in (("cpu", "cpu"), ("card", str(device))):
            out = root / f"{config}.{where}.txt"
            fs.VARIANT_LAUNCHES.clear()
            rc = apply.Applier(apply.Options(simon_config=_example(config), output_file=str(out),
                                             extended_resources=extended, device=dev)).run()
            runs.append((rc, out.read_text(), dict(fs.VARIANT_LAUNCHES)))
        (rc_cpu, cpu, _), (rc_card, card_text, launches) = runs
        if rc_cpu != 0 or rc_card != 0 or _without_counters(cpu) != _without_counters(card_text):
            raise AssertionError(f"{config}: the card's report (rc {rc_card}) differs from the CPU's (rc {rc_cpu})")
        if not launches or {name.replace("fast_scan_sweep", "fast_scan") for name in launches} != {variant}:
            raise AssertionError(f"{config}: launched {launches}, want {variant} (built in phase 2)")
        footer = [line for line in card_text.splitlines() if line.startswith("Scheduling engine: ")]
        print(f"{config}: card and CPU reports identical ({len(card_text.splitlines())} lines); launches {launches}; "
              f"{footer[0] if footer else ''}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    _phase("1 card")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    plans = [
        ("4-6 capacity plan", lambda: (fx.synthetic_cluster(N_NODES), fx.synthetic_apps(N_PODS)),
         "fast_scan", 10000),
        ("7-9 all-GPU-share plan", lambda: (fx.gpu_cluster(N_NODES), fx.gpu_apps(N_PODS)),
         "fast_scan[gpu,gc]", 10000),
        ("10-12 affinity-heavy plan", lambda: (fx.synthetic_cluster(N_NODES), fx.affinity_apps(N_PODS)),
         "fast_scan[interpod]", None),
        ("13-15 score-table plan", lambda: (fx.score_cluster(N_NODES), fx.score_apps(N_PODS)),
         "fast_scan[na,tt,avoid]", 5000),
        ("16-18 host-port plan", lambda: (fx.score_cluster(N_NODES), fx.score_apps(N_PODS, host_port=True)),
         "fast_scan[na,tt,avoid,ports]", 5000),
        ("19-21 all-local-PV plan", lambda: (fx.local_pv_cluster(N_NODES), fx.local_pv_apps(N_PODS)),
         "fast_scan[local]", 5000),
    ]

    _phase("2 build")
    variants = sorted({v for *_rest, v, _p in plans} | {fs.variant_name(fi) for _n, _p, fi in _small_preps("cpu")}
                      | {v for *_rest, v in EXAMPLES})
    fs.build(variants)
    print(f"build: {fs.BUILD_LOG['seconds']:.3f} s for {len(variants)} kernel variants, one nvcc each, "
          f"all started together: {', '.join(variants)}")
    for name, entry in fs.BUILD_LOG["variants"].items():
        secs = "cached" if entry["seconds"] is None else f"nvcc {entry['seconds']:.3f} s"
        print(f"  {name}: {secs}, ptxas {json.dumps(fs.ptxas_report(entry['ptxas']))}")

    _phase("3 small cases: kernel vs plain version, one scan and a sweep of drains each")
    small_cases(device)

    rows = [full_plan(device, label, make, variant, prefix) for label, make, variant, prefix in plans]
    rows.append(drain_sweep(device))
    rows.extend(oversubscribed_plan(device))
    rows.extend(apply_plan(device, card))
    example_reports(device)
    print(f"smoke run {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
