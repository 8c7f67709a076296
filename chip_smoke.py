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
version (over a prefix: the plain version is a Python loop) and, over the
whole stream, to
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
version on all ten outputs over the first 6,010 pods (every failure,
failure counts included), against the grid at S = 1 on the eight state
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
after the others) against the plain version on all ten outputs; and the three example configs, whose reports on the card equal
the plain versions' on the CPU. Each small case of phase 3 also runs as a
masked one scan (a node and a third of the pods masked out) against the
plain version; those of the base and score-table variants also under a
scheduler config (one scan and grid), cut in two with the state carried,
and (the base ones) with the sampled tie-break. Then the scheduler-config
and sampled paths (phases 31-41): the config plan (the score-table plan
with a NoSchedule taint no pod tolerates on every tenth node and one
Deployment asking a resource no node offers, under a one-profile config
that turns the taint filter off, ignores that resource and reweighs the
scores: ``fast_scan[na,tt,avoid,cfg]``, its placements against the
default config's), the two-profile plan (the capacity plan, its second
half under the ``batch`` profile: two launches of ``fast_scan[cfg]``, the
second from the first's state) and the sampled plan (the capacity plan
with tie seed 7: ``fast_scan[sample]``), each against its plain version
over 5,000 pods (of each segment), the first two against grid launches at
S = 1 over the whole stream, the sampled placements each among its step's
best scores and a quarter at least off the lowest index's; and ``simon
apply -d`` on the apply plan (the cfg variants of both kernels), its
masked one scan at n_new - 1 and n_new against the grids' rows. Then
explain mode (phases 42-49), the one scan's ``[explain]`` variants, which
count every step's rejections: the affinity-heavy plan with its hard
zone spread at maxSkew 1 (``fast_scan[interpod,explain]``; at maxSkew 3
no node fails a filter on any step), whose binding steps reject nodes,
and the all-GPU-share plan
(``fast_scan[gpu,gc,explain]``), each with placements, GPU takes and final
state equal to the default variant's over the whole stream and all ten
outputs equal to the plain version counting every step over its first
2,000 pods; the over-subscribed plan (``fast_scan[explain]``), its failing
steps' counts the default variant's over the whole stream; the capacity
plan's simulate(explain=True) timed by phase; each simulate(explain=True)
through exactly one launch; ``explain_pod`` on the card for an
unscheduled pod and a scheduled one near the end of the stream, whose
torch re-score (``kernels.pod_step`` at full width) takes the kernel's
node; ``simon apply --explain`` on the apply plan, its report above the
placement audit phase 28's; and the example configs' ``--explain``
reports, card against CPU. The affinity-heavy plan's default variant is
held against the plain version over its first 10,000 pods (phase 10;
against the grid over the whole stream), leaving the run time for these
phases. Every phase raises on failure.
The last lines are the card's name and power limit, one JSON line with
a row per kernel variant timed at full width, one for the drain sweep,
three for the apply plan (the masked one scan, the coarse and the fine
grid), one each for the config, two-profile and sampled plans (the
last timed over its checked prefix, whose ties the plain version records
for its bound), three
for the apply plan under ``-d`` and five for explain mode, and
``{"ok": true, "device": {...}}``.
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
#: float32 non-tensor-core FLOP/s (128 lanes per SM, a fused multiply-add
#: counted as two). The 32-bit integer rate follows from the same clock:
#: 64 lanes per SM, an operation counted as one.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_I32_S = PEAK_F32_S / 4
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
#: The scheduler-config and sampled plans: the plain version checks the
#: first CFG_PLAIN_PODS pods (of each segment of the two-profile plan);
#: the sampled plan's seed. SMALL_CONFIG is the config phase 3 runs the
#: small cases of the default and score-table variants under.
CFG_PLAIN_PODS = 5000
TIE_SEED = 7
SMALL_CONFIG = dict(w_balanced=0.0, w_least=3.0, w_node_affinity=2.0, w_taint_toleration=5.0, w_spread=1.0,
                    w_prefer_avoid=0.0, w_simon=0.5, f_taints=False, f_spread=False, fit_ignored_cols=(1,))
#: The variants the new plans and phase 3's config and sampled cases run.
CFG_VARIANTS = ("fast_scan[cfg]", "fast_scan[na,tt,avoid,cfg]", "fast_scan[sample]")
#: Explain mode (phases 42-49): the plain version counting every step
#: checks the first EXPLAIN_PLAIN_PODS pods of each plan; the variants the
#: plans run (the examples' are their own variants', explained). The
#: affinity-heavy plan's default variant is held against the plain version
#: over AFFINITY_PLAIN_PODS pods (and against the grid over the whole
#: stream), which leaves the run time for these phases.
EXPLAIN_PLAIN_PODS = 2000
EXPLAIN_VARIANTS = ("fast_scan[interpod,explain]", "fast_scan[gpu,gc,explain]", "fast_scan[explain]")
AFFINITY_PLAIN_PODS = 10000
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


def _ops_ms(work: dict) -> float:
    """The least time the card could take for a work count's operations:
    its integer operations alone at the INT32 rate, or all of them through
    the issue slots, where an integer operation takes the slot of a fused
    multiply-add (two float operations), whichever is longer."""
    return max(work["ops"] + 2 * work["int_ops"], PEAK_F32_S / PEAK_I32_S * work["int_ops"]) / PEAK_F32_S * 1e3


def _same(got, want, what: str, fields=None) -> float:
    """Identical outputs, all ten unless `fields` names fewer (placements,
    usage, GPU takes, GPU, host-port, volume-group and device state, the
    failure counts and shortages, the whole final state row), or raise;
    returns the largest absolute difference of the other outputs."""
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
        extra = _config_small_case(prep, fs.variant_name(fi), name)
        counted = int(got.fail_counts.any(1).sum())
        print(f"case {name} ({fs.variant_name(fi)}): N={fi.alloc_T.shape[1]} P={len(prep.tmpl_ids)} "
              f"placed={int((got.chosen >= 0).sum())} counted failures={counted} gpu slots={int(got.gpu_take.sum())} "
              f"ports used={int(got.port_used.sum())} devices taken={int((got.dev_free < fi.dev0).sum())} "
              f"identical; sweep of {grid[1].shape[0]} drains identical "
              f"(placed {(got_s.chosen >= 0).sum(1).tolist()}); masked one scan identical "
              f"({int(pod_valid.sum())} pods on {int(node_valid.sum())} nodes, {failing_m} found no node){extra}",
              flush=True)
    if masked_failures == 0:
        raise AssertionError("no masked small case had a pod that found no node")


def _sched_config(prep, text: str, name: str):
    """The scheduler config file `text` (a ``fixtures.SCHED_*`` text)
    written under the smoke directory as ``<name>.yaml``, loaded as
    ``simon apply -d`` loads it, and routed over the prepared stream:
    (the loaded config, its segments [(config, lo, hi)])."""
    from opensim_tpu_torch.engine import schedconfig
    from opensim_tpu_torch.models import fixtures as fx

    path = fx.write_scheduler_config(_plan_dir() / "sched" / f"{name}.yaml", text)
    sched = schedconfig.load_scheduler_config(path)
    segments, invalid = schedconfig.resolve_profile_segments(sched, prep.ordered, prep.meta.resource_names,
                                                             forced=prep.forced)
    if invalid:
        raise AssertionError(f"{len(invalid)} pods name no profile of {path}")
    return sched, segments


def _config_small_case(prep, variant: str, name: str) -> str:
    """A small case of the default or score-table variant also under
    SMALL_CONFIG (the cfg variant's one scan and three-drain grid against
    the plain versions), cut in two with the state carried (one scan and
    grid, against one launch), and with the default variant sampled
    (TIE_SEED; against the plain version). Returns what it checked."""
    from opensim_tpu_torch.engine import fastpath, schedconfig
    from opensim_tpu_torch.ops import fast_scan as fs

    if variant not in ("fast_scan", "fast_scan[na,tt,avoid]"):
        return ""
    fi, _ = fastpath.build_inputs(prep, cfg=schedconfig.SchedulerConfig(**SMALL_CONFIG))
    stream = fastpath.pod_stream(prep)
    whole = fs.fast_scan(fi, *stream)
    _same(whole, fs.fast_scan_reference(fi, *stream), f"case {name} under a config")
    grid = _drain_grid(prep, list(range(min(3, len(prep.meta.node_names)))))
    whole_g = fs.fast_scan_sweep(fi, *grid)
    _same(whole_g, fs.fast_scan_sweep_reference(fi, *grid), f"case {name} under a config, sweep")
    k = stream[0].shape[0] // 2
    a = fs.fast_scan(fi, *(t[:k] for t in stream))
    b = fs.fast_scan(fi, *(t[k:] for t in stream), init=a.state)
    per_pod = ("chosen", "gpu_take", "fail_counts", "insufficient")
    _same(fs.FastOutputs(*(getattr(whole, f)[k:] if f in per_pod else getattr(whole, f) for f in fs.FastOutputs._fields)),
          b, f"case {name} from the state after pod {k}")
    cut = lambda sl: [grid[0][sl]] + [t[:, sl].contiguous() for t in grid[1:3]] + list(grid[3:])
    a_g = fs.fast_scan_sweep(fi, *cut(slice(None, k)))
    b_g = fs.fast_scan_sweep(fi, *cut(slice(k, None)), init=a_g.state)
    _same(fs.FastOutputs(*(getattr(whole_g, f)[:, k:] if f in per_pod else getattr(whole_g, f)
                           for f in fs.FastOutputs._fields)), b_g, f"case {name} sweep from the state after pod {k}")
    out = f"; under a config ({fs.variant_name(fi)}) one scan, sweep and both from the state after pod {k} identical"
    if variant == "fast_scan":
        fi0, _ = fastpath.build_inputs(prep)
        _same(fs.fast_scan(fi0, *stream, tie_seed=TIE_SEED), fs.fast_scan_reference(fi0, *stream, tie_seed=TIE_SEED),
              f"case {name} sampled")
        out += f"; sampled ({fs.variant_name(fi0, True)}) identical"
    return out


def full_plan(device, label: str, make, variant: str, prefix=None, sched_text=None, tie_seed=None) -> dict:
    """Kernel against its plain version over the first `prefix` pods of
    the stream (None: the whole stream), simulate() through the kernel,
    then the kernel timed alone over the whole stream. With `sched_text`
    (a one-profile scheduler config file), all of it under that config,
    and the placements compared with the default config's; with
    `tie_seed`, all of it with the sampled tie-break (no grid: it does not
    sample), each placement among its step's best scores by the plain
    version's record, and a quarter of the prefix's placements at least
    off the lowest index's. Returns the plan's row of the kernels table."""
    from opensim_tpu_torch.engine import fastpath, simulator as sim
    from opensim_tpu_torch.ops import fast_scan as fs

    span = "the whole stream" if prefix is None else f"its first {prefix} pods"
    _phase(f"{label}: {N_NODES} nodes, {N_PODS} pods, kernel vs plain over {span}")
    cluster, app = make()
    apps = [sim.AppResource("plan", app)]
    prep = sim.prepare(cluster, apps, device=device)
    sched = cfg = None
    if sched_text is not None:
        sched, segments = _sched_config(prep, sched_text, label.split()[1])
        if len(segments) != 1:
            raise AssertionError(f"the plan's config routes {len(segments)} segments, not one")
        cfg = segments[0][0]
    miss = fastpath.why_not(prep, cfg)
    if miss is not None:
        raise AssertionError(f"the plan falls outside the envelope: {miss}")
    fi, _ = fastpath.build_inputs(prep, cfg=cfg)
    sample = tie_seed is not None
    if fs.variant_name(fi, sample) != variant:
        raise AssertionError(f"the plan runs {fs.variant_name(fi, sample)}, not {variant}")
    tmpl, valid, forced = fastpath.pod_stream(prep)
    P, N = tmpl.shape[0], fi.alloc_T.shape[1]
    head = (tmpl, valid, forced) if prefix is None else tuple(t[:prefix].contiguous() for t in (tmpl, valid, forced))
    P_head = head[0].shape[0]
    got_head = fs.fast_scan(fi, *head, tie_seed=tie_seed)
    torch.cuda.synchronize()
    plain, stats = [None], {}

    def run_plain():
        plain[0] = fs.fast_scan_reference(fi, *head, tie_seed=tie_seed, stats=stats)

    plain_ms = _events_ms(run_plain, reps=1)
    err = _same(got_head, plain[0], f"{label}, {P_head} pods")
    print(f"{P_head} pods at N={N}: kernel and plain version identical on all ten outputs "
          f"(plain {plain_ms:.3f} ms, {int(got_head.gpu_take.sum())} GPU slots taken, "
          f"{int(got_head.port_used.sum())} host ports used)", flush=True)
    whole = fs.fast_scan(fi, tmpl, valid, forced, tie_seed=tie_seed)
    extra = {}
    if sample:
        scheduled = (head[1] != 0) & (head[2] == 0) & (got_head.chosen >= 0)
        if not bool(stats["at_max"].all()):
            raise AssertionError(f"{int((~stats['at_max']).sum())} sampled placements off their step's maxima")
        lowest = fs.fast_scan(fi, *head).chosen
        moved = float((got_head.chosen != lowest).float().mean())
        if moved < 0.25:
            raise AssertionError(f"only {moved:.3f} of the sampled placements differ from the lowest index's")
        ties = stats["ties"][scheduled].float()
        extra = {"tie_seed": tie_seed, "moved_from_lowest": moved, "mean_ties": float(ties.mean()),
                 "steps_tied": int((ties > 1).sum())}
        print(f"every sampled placement among its step's best scores (plain version's record; {extra['steps_tied']} "
              f"of {int(scheduled.sum())} steps tied, {extra['mean_ties']:.1f} nodes at the best score on average); "
              f"{moved:.4f} of the {P_head} placements differ from the lowest-index run", flush=True)
        grid1_ms = None
    else:
        grid1 = [None]

        def run_grid1():
            grid1[0] = fs.fast_scan_sweep(fi, tmpl, valid[None], forced[None], fi.node_valid[None],
                                          fi.spr_weight[None])

        grid1_ms = _events_ms(run_grid1, reps=1)
        err = max(err, _same(whole, fs.FastOutputs(*(t[0] for t in grid1[0])),
                             f"{label}: one scan vs the grid at S=1 over {P} pods", fs.STATE_FIELDS))
        print(f"{P} pods: one scan and the grid at S=1 identical on all eight state outputs over the whole stream "
              f"(grid at S=1 {grid1_ms:.3f} ms)", flush=True)
    if cfg is not None:
        default = fs.fast_scan(fastpath.build_inputs(prep)[0], tmpl, valid, forced).chosen
        differ = int((default != whole.chosen).sum())
        if differ == 0:
            raise AssertionError("the config placed the stream as the default config does")
        extra = {"differs_from_default": differ, "default_unplaced": int((default < 0).sum())}
        print(f"{differ} of {P} placements differ from the default config's ({extra['default_unplaced']} pods "
              f"find no node there)", flush=True)

    _phase(f"{label}: simulate(), {N_PODS} pods on {N_NODES} nodes")
    cluster, app = make()  # fresh objects: simulate() writes into its pods
    apps = [sim.AppResource("plan", app)]
    torch.cuda.synchronize()
    fs.LAUNCHES = 0
    fs.VARIANT_LAUNCHES.clear()
    res = sim.simulate(cluster, apps, device=device, sched_config=sched, tie_seed=tie_seed)
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
    ms = _events_ms(lambda: fs.fast_scan(fi, tmpl, valid, forced, tie_seed=tie_seed), reps=3)
    work = fs.fast_scan_work(fi, tmpl, valid, forced, torch.from_numpy(res.placements))
    P_timed = P
    if sample:
        # the bound counts a draw per node at a tied step's best score, which
        # the plain version records over the prefix only: the row times the
        # kernel over that prefix, beside the lowest-index kernel on it
        extra.update(whole_ms=ms, whole_pods=P, lowest_ms=_events_ms(lambda: fs.fast_scan(fi, *head), reps=3))
        ms, P_timed = _events_ms(lambda: fs.fast_scan(fi, *head, tie_seed=tie_seed), reps=3), P_head
        work = fs.fast_scan_work(fi, *head, got_head.chosen, ties=stats["ties"])
        print(f"kernel over the whole stream {extra['whole_ms']:.3f} ms ({extra['whole_ms'] * 1e3 / P:.3f} us/pod); "
              f"over the first {P_head} pods sampled {ms:.3f} ms, lowest index {extra['lowest_ms']:.3f} ms",
              flush=True)
    t_bytes = work["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = _ops_ms(work)
    print(f"kernel {ms:.3f} ms over {P_timed} pods ({ms * 1e3 / P_timed:.3f} us/pod), plain {plain_ms:.3f} ms over "
          f"{P_head} pods ({plain_ms * 1e3 / P_head:.3f} us/pod), bound {max(t_bytes, t_ops):.6f} ms "
          f"({work['bytes']} B, {work['ops']} flop, {work['int_ops']} integer operations)", flush=True)
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
        "pods": P_timed,
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
        **extra,
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
    all ten outputs, vs the grid at S = 1 on the eight state outputs over
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
    print(f"{OVER_HEAD} pods at N={N}: kernel and plain version identical on all ten outputs (plain "
          f"{plain_ms:.3f} ms); {n_failing} pods found no node and were counted, {n_forced} forced pods "
          f"found none", flush=True)
    whole = fs.fast_scan(fi, tmpl, valid, forced)
    grid1 = fs.fast_scan_sweep(fi, tmpl, valid[None], forced[None], fi.node_valid[None], fi.spr_weight[None])
    err = max(err, _same(whole, fs.FastOutputs(*(t[0] for t in grid1)),
                         f"over-subscribed plan: one scan vs the grid at S=1 over {P} pods", fs.STATE_FIELDS))
    if not torch.equal(whole.fail_counts[:OVER_HEAD], got_head.fail_counts) or whole.fail_counts[OVER_HEAD:].any():
        raise AssertionError("the whole stream's counts differ from the checked prefix's")
    print(f"{P} pods: one scan and the grid at S=1 identical on the eight state outputs; the whole stream's "
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
    to `out`'s rows over them) and by the plain version, on the nine
    outputs but the state row (the hog pods ask for no selector count, so
    the tail's launch starts its counts at 0), so the failing pods' counts
    and shortages are the plain version's. Returns the largest difference
    and the plain version's ms."""
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
    nine = fs.FastOutputs._fields[:-1]
    per_pod = ("chosen", "gpu_take", "fail_counts", "insufficient")
    err = _same(got_tail, fs.FastOutputs(*(getattr(out, f)[t0:] if f in per_pod else getattr(out, f)
                                            for f in fs.FastOutputs._fields)),
                f"k=0: the hog pods from the kernel's usage after pod {t0} vs the whole stream's launch", nine)
    plain = [None]

    def run_plain():
        plain[0] = fs.fast_scan_reference(fi_tail, *tail)

    plain_ms = _events_ms(run_plain, reps=1)
    err = max(err, _same(got_tail, plain[0], f"k=0: the hog pods from the kernel's usage after pod {t0} vs plain"))
    failing = int((got_tail.chosen < 0).sum())
    print(f"k=0: the {APPLY_HOG} hog pods from the kernel's usage after pod {t0}: kernel identical to the whole "
          f"stream's launch on the nine outputs but the state row and to the plain version on all ten ({failing} "
          f"found no node, their counts and shortages included; plain {plain_ms:.3f} ms)", flush=True)
    return err, plain_ms


def apply_plan(device, card: str) -> list:
    """`simon apply` on the apply plan through the port's Applier as a
    user runs it (YAML directories, the card): its launches, the new-node
    count, the steps' host-clock times against BASELINE.md's 10 s; then
    the path's masked one scan at k = 0, n_new - 1 and n_new new nodes
    against the rows of the coarse and fine grids for those k (the eight
    state outputs, over the whole stream) and against the plain version
    over a prefix (all ten), each grid timed alone, and at k = 0 the
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
        print(f"k={k}: masked one scan {ms_k:.3f} ms, identical to the {label} grid's row on the eight state "
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
            print(f"k={k}: masked one scan and plain version identical on all ten outputs over "
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


def two_profile_plan(device) -> dict:
    """The capacity plan with its last ten Deployments under the ``batch``
    profile (``fixtures.two_profile_apps``) and the two-profile config:
    two segments, two launches of the cfg variant, the second from the
    first's state. Each segment's first CFG_PLAIN_PODS pods against the
    plain version (the second's from the kernel's state at the boundary),
    the whole stream against two grid launches at S = 1 carrying the
    state, simulate() through exactly two launches, both launches timed.
    Returns the plan's row of the kernels table."""
    from opensim_tpu_torch.engine import fastpath, simulator as sim
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs

    variant = "fast_scan[cfg]"

    def make():
        return fx.synthetic_cluster(N_NODES), [sim.AppResource(n, a) for n, a in fx.two_profile_apps(N_PODS)]

    _phase(f"34 two-profile plan: {N_NODES} nodes, {N_PODS} pods in two profile segments, kernel vs plain over "
           f"{CFG_PLAIN_PODS} pods of each, vs two grids at S=1 over the whole stream")
    prep = sim.prepare(*make(), device=device)
    sched, segments = _sched_config(prep, fx.SCHED_TWO_PROFILES, "two-profile")
    half = N_PODS // 2
    if [(lo, hi) for _c, lo, hi in segments] != [(0, half), (half, N_PODS)]:
        raise AssertionError(f"the plan routes segments {[(lo, hi) for _c, lo, hi in segments]}")
    built = []
    for cfg, lo, hi in segments:
        if fastpath.why_not(prep, cfg) is not None:
            raise AssertionError(f"the plan falls outside the envelope: {fastpath.why_not(prep, cfg)}")
        fi = fastpath.build_inputs(prep, cfg=cfg)[0]
        if fs.variant_name(fi) != variant:
            raise AssertionError(f"segment {lo}:{hi} runs {fs.variant_name(fi)}, not {variant}")
        built.append((fi, lo, hi))
    tmpl, valid, forced = fastpath.pod_stream(prep)

    def run_kernel():
        outs, state = [], None
        for fi, lo, hi in built:
            outs.append(fs.fast_scan(fi, tmpl[lo:hi], valid[lo:hi], forced[lo:hi], init=state))
            state = outs[-1].state
        return outs

    whole = run_kernel()
    err, plain_ms = 0.0, 0.0
    for k, (fi, lo, hi) in enumerate(built):
        init = None if k == 0 else whole[k - 1].state
        head = (tmpl[lo:lo + CFG_PLAIN_PODS], valid[lo:lo + CFG_PLAIN_PODS], forced[lo:lo + CFG_PLAIN_PODS])
        got = fs.fast_scan(fi, *head, init=init)
        if not torch.equal(got.chosen, whole[k].chosen[:CFG_PLAIN_PODS]):
            raise AssertionError(f"segment {k}: the prefix's launch placed differently from the segment's")
        plain = [None]

        def run_plain():
            plain[0] = fs.fast_scan_reference(fi, *head, init=init)

        ms = _events_ms(run_plain, reps=1)
        plain_ms += ms
        err = max(err, _same(got, plain[0], f"two-profile plan, segment {k}, {CFG_PLAIN_PODS} pods"))
        print(f"segment {k} ({lo}:{hi}), its first {CFG_PLAIN_PODS} pods{' from the kernel state at ' + str(lo) if k else ''}: "
              f"kernel and plain version identical on all ten outputs (plain {ms:.3f} ms)", flush=True)
    grid = [None]

    def run_grid():
        outs, state = [], None
        for fi, lo, hi in built:
            outs.append(fs.fast_scan_sweep(fi, tmpl[lo:hi], valid[None, lo:hi].contiguous(),
                                           forced[None, lo:hi].contiguous(), fi.node_valid[None], fi.spr_weight[None],
                                           init=state))
            state = outs[-1].state
        grid[0] = outs

    grid_ms = _events_ms(run_grid, reps=1)
    for k, (one, g) in enumerate(zip(whole, grid[0])):
        err = max(err, _same(one, fs.FastOutputs(*(t[0] for t in g)),
                             f"two-profile plan: segment {k}, one scan vs the grid at S=1", fs.STATE_FIELDS))
    print(f"{N_PODS} pods: two one-scan launches and two grid launches at S=1, each carrying the state, identical "
          f"on all eight state outputs (grids {grid_ms:.3f} ms)", flush=True)

    _phase(f"35 two-profile plan: simulate(sched_config=), {N_PODS} pods on {N_NODES} nodes")
    fresh = make()
    torch.cuda.synchronize()
    fs.LAUNCHES = 0
    fs.VARIANT_LAUNCHES.clear()
    res = sim.simulate(*fresh, device=device, sched_config=sched)
    launches, by_variant = fs.LAUNCHES, dict(fs.VARIANT_LAUNCHES)
    if by_variant != {variant: 2}:
        raise AssertionError(f"simulate() launched {by_variant}, want two {variant}, one a segment")
    chosen = torch.cat([o.chosen for o in whole]).cpu().numpy()
    if (res.placements < 0).any() or not np.array_equal(res.placements, chosen):
        raise AssertionError("simulate() placed the stream differently from the checked launches")
    print(f"placed {int((res.placements >= 0).sum())}/{N_PODS} pods, kernel launches {by_variant}; engine "
          f"{res.engine}")
    print("timings: " + json.dumps({k: round(v, 6) for k, v in res.timings.items()}))
    wall = sum(res.timings.values())
    print(f"plan wall-clock {wall:.6f} s, {N_PODS / wall:.1f} pods/s (host clock)", flush=True)

    _phase("36 two-profile plan: both launches over the whole stream (CUDA events)")
    ms = _events_ms(run_kernel, reps=3)
    works = [fs.fast_scan_work(fi, tmpl[lo:hi], valid[lo:hi], forced[lo:hi], o.chosen)
             for (fi, lo, hi), o in zip(built, whole)]
    t_bytes = sum(w["bytes"] for w in works) / PEAK_BYTES_S * 1e3
    t_ops = sum(w["ops"] for w in works) / PEAK_F32_S * 1e3
    launched = fs.SCAN_LAUNCHED[variant]
    print(f"two launches {ms:.3f} ms ({ms * 1e3 / N_PODS:.3f} us/pod), bound {max(t_bytes, t_ops):.6f} ms", flush=True)
    return {
        "name": variant, "plan": "two-profile plan (two segments)", "route": "cuda",
        "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu", "replaces": "opensim_tpu/ops/pallas_scan.py:1009",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "pods": N_PODS,
        "plain_pods": 2 * CFG_PLAIN_PODS, "grid_s1_ms": grid_ms, "segments": [[lo, hi] for _f, lo, hi in built],
        "ptxas": launched["ptxas"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
        "plan_wall_s": wall,
    }


def apply_config_plan(device, card: str) -> list:
    """``simon apply -d`` on the apply plan (phase 28's directories) with
    ``fixtures.SCHED_APPLY``: through the Applier on the card, its launches
    all of the cfg variant (two one scans, two grids); then the masked one
    scan at n_new - 1 and n_new against the grids' rows over the whole
    stream (eight state outputs) and at n_new - 1 against the plain version
    over APPLY_PLAIN_PODS pods, one row of each grid against the plain
    sweep over as many, each kernel timed. Returns the rows of the masked
    one scan and the two grids."""
    from opensim_tpu_torch.engine import fastpath, schedconfig
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.parallel import scenarios
    from opensim_tpu_torch.planner import apply

    scan, sweep = "fast_scan[cfg]", "fast_scan_sweep[cfg]"
    _phase(f"40 apply plan under -d: simon apply -d with the capacity fleet's settings of the config plan "
           f"(Applier.run() on the card)")
    root = _plan_dir() / "apply"
    sched_path = fx.write_scheduler_config(_plan_dir() / "sched" / "apply.yaml", fx.SCHED_APPLY)
    report = root / "report-d.txt"
    torch.cuda.synchronize()
    fs.LAUNCHES = 0
    fs.VARIANT_LAUNCHES.clear()
    fs.SCAN_LAUNCHED.clear()
    fs.SWEEP_LAUNCHED.clear()
    t0 = time.perf_counter()
    applier = apply.Applier(apply.Options(simon_config=str(root / "config.yaml"), default_scheduler_config=sched_path,
                                          output_file=str(report), max_new_nodes=APPLY_MAX_NEW))
    rc = applier.run()
    wall = time.perf_counter() - t0
    by_name = dict(fs.VARIANT_LAUNCHES)
    text = report.read_text()
    n_new = applier.n_new
    if rc != 0 or "Simulation success!" not in text or not n_new:
        raise AssertionError(f"simon apply -d returned {rc} with {n_new} new nodes:\n{text[:2000]}")
    if by_name != {scan: 2, sweep: 2}:
        raise AssertionError(f"simon apply -d launched {by_name}, want two {scan} and two {sweep}")
    (coarse, coarse_s), (fine, fine_s) = applier.sweeps
    steps = dict(applier.timings, **{"sweep: coarse": coarse_s, "sweep: fine": fine_s})
    print(f"simon apply -d: rc {rc}, {n_new} new nodes, launches {by_name}; sweeps {coarse} then "
          f"{fine[0]}..{fine[-1]} ({len(fine)} scenarios)")
    print("steps: " + json.dumps({k: round(v, 6) for k, v in steps.items()}))
    print(f"simon apply -d wall-clock {wall:.6f} s against the {APPLY_LIMIT_S:.0f} s limit: "
          f"{'met' if wall < APPLY_LIMIT_S else 'missed'} ({card})", flush=True)

    _phase(f"41 apply plan under -d: the masked one scan at k = {n_new - 1} and {n_new} against the grids' rows "
           f"over the whole stream, and the plain versions over {APPLY_PLAIN_PODS} pods")
    prep = applier.prep_full
    (cfg, _lo, _hi), = schedconfig.resolve_profile_segments(applier.sched_config, prep.ordered,
                                                            prep.meta.resource_names, forced=prep.forced)[0]
    fi, _ = fastpath.build_inputs(prep, cfg=cfg)
    forced = torch.from_numpy(prep.forced.astype(np.int32)).to(device)
    rows, grids = [], {}
    for label, ks in (("coarse", coarse), ("fine", fine)):
        node_valid, pod_valid = scenarios.count_masks(prep, N_NODES, ks)
        tmpl, *grid = fastpath.sweep_inputs(prep, node_valid, pod_valid, np.broadcast_to(prep.forced, pod_valid.shape))
        out = [None]

        def run_grid():
            out[0] = fs.fast_scan_sweep(fi, tmpl, *grid)

        grid_ms = _events_ms(run_grid, reps=1)
        launched = fs.SWEEP_LAUNCHED[sweep]
        grids[label] = (ks, grid, out[0])
        sel = [max(i for i, k in enumerate(ks) if k <= n_new)]
        head = [t[:, :APPLY_PLAIN_PODS].contiguous() for t in grid[:2]] + grid[2:]
        got = fs.fast_scan_sweep(fi, tmpl[:APPLY_PLAIN_PODS].contiguous(), *head)
        plain = [None]

        def run_plain():
            plain[0] = fs.fast_scan_sweep_reference(fi, tmpl[:APPLY_PLAIN_PODS].contiguous(), *(t[sel] for t in head))

        plain_ms = _events_ms(run_plain, reps=1)
        err = _same(fs.FastOutputs(*(t[sel] for t in got)), plain[0], f"-d {label} grid rows {sel} vs plain")
        work = fs.fast_scan_work(fi, tmpl, grid[0], grid[1], out[0].chosen, grid[2])
        t_bytes, t_ops = work["bytes"] / PEAK_BYTES_S * 1e3, work["ops"] / PEAK_F32_S * 1e3
        print(f"-d {label} grid, S={len(ks)}: {grid_ms:.3f} ms; row {sel} identical to the plain sweep over "
              f"{APPLY_PLAIN_PODS} pods (plain {plain_ms:.3f} ms); bound {max(t_bytes, t_ops):.6f} ms", flush=True)
        rows.append({
            "name": sweep, "plan": f"apply plan under -d, {label} sweep", "route": "cuda",
            "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu", "replaces": "opensim_tpu/engine/fastpath.py:532",
            "launches": by_name[sweep], "launches_are": "the path's two grids, coarse and fine",
            "max_abs_err": err, "ms": grid_ms, "plain_ms": plain_ms, "scenarios": len(ks),
            "pods": int(tmpl.shape[0]), "plain_checks": [sel, APPLY_PLAIN_PODS], "b": launched["grid"].b,
            "blocks": launched["grid"].blocks, "ptxas": launched["ptxas"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
            "host_s": coarse_s if label == "coarse" else fine_s,
        })
    err = 0.0
    for k in (n_new - 1, n_new):
        label = "fine" if k in fine else "coarse"
        ks, grid, out = grids[label]
        s = ks.index(k)
        fi_k, _ = fastpath.build_inputs(prep, grid[2][s].cpu().numpy() != 0, cfg=cfg)
        one = [None]

        def run_one():
            one[0] = fs.fast_scan(fi_k, tmpl, grid[0][s], forced)

        ms_k = _events_ms(run_one, reps=3 if k == n_new else 1)
        err = max(err, _same(one[0], fs.FastOutputs(*(t[s] for t in out)),
                             f"-d masked one scan at k={k} vs the {label} grid's row", fs.STATE_FIELDS))
        failing = int(((one[0].chosen < 0) & (grid[0][s] != 0) & (forced == 0)).sum())
        if (k == n_new) != (failing == 0):
            raise AssertionError(f"-d k={k}: {failing} pods found no node; the answer {n_new} is not minimal")
        print(f"-d k={k}: masked one scan {ms_k:.3f} ms, identical to the {label} grid's row on the eight state "
              f"outputs; {failing} pods found no node", flush=True)
        if k == n_new - 1:
            head = (tmpl[:APPLY_PLAIN_PODS].contiguous(), grid[0][s][:APPLY_PLAIN_PODS].contiguous(),
                    forced[:APPLY_PLAIN_PODS].contiguous())
            plain = [None]

            def run_plain():
                plain[0] = fs.fast_scan_reference(fi_k, *head)

            plain_ms = _events_ms(run_plain, reps=1)
            err = max(err, _same(fs.fast_scan(fi_k, *head), plain[0], f"-d masked one scan at k={k} vs plain"))
        else:
            ms, work = ms_k, fs.fast_scan_work(fi_k, tmpl, grid[0][s], forced, one[0].chosen)
    t_bytes, t_ops = work["bytes"] / PEAK_BYTES_S * 1e3, work["ops"] / PEAK_F32_S * 1e3
    launched = fs.SCAN_LAUNCHED[scan]
    print(f"-d masked one scan at k={n_new}: {ms:.3f} ms, bound {max(t_bytes, t_ops):.6f} ms; plain "
          f"{plain_ms:.3f} ms over {APPLY_PLAIN_PODS} pods at k={n_new - 1}", flush=True)
    rows.insert(0, {
        "name": scan, "plan": f"apply plan under -d, masked re-simulation at k={n_new}", "route": "cuda",
        "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu", "replaces": "opensim_tpu/ops/pallas_scan.py:1009",
        "launches": by_name[scan], "launches_are": "the path's two one scans, first simulation and masked",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "pods": int(tmpl.shape[0]),
        "plain_pods": APPLY_PLAIN_PODS, "ptxas": launched["ptxas"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
        "apply_wall_s": wall, "apply_steps_s": steps, "n_new": n_new,
    })
    return rows


def _explain_row(fi, stream, variant: str, plan: str, launches: int, err: float, plain_ms: float, plain_pods: int,
                 extra=None) -> dict:
    """The kernels-table row of an [explain] variant on `stream`: the
    kernel timed over the whole stream in explain mode (CUDA events, 3
    launches) and, beside it, the default variant; its counting passes by
    the card's global timer, its bound with the counting pass on every
    step (``fast_scan_work(explain=True)``)."""
    from opensim_tpu_torch.ops import fast_scan as fs

    clocks, out = [], [None]

    def run_kernel():
        out[0] = fs.fast_scan(fi, *stream, explain=True)
        clocks.append(fs.SCAN_LAUNCHED[variant]["count_clock"])

    ms = _events_ms(run_kernel, reps=3)
    default_ms = _events_ms(lambda: fs.fast_scan(fi, *stream), reps=3)
    passes = int(clocks[-1][1])
    count_ms = sum(int(c[0]) for c in clocks) / len(clocks) / 1e6
    work = fs.fast_scan_work(fi, *stream, out[0].chosen, explain=True)
    t_bytes, t_ops = work["bytes"] / PEAK_BYTES_S * 1e3, work["ops"] / PEAK_F32_S * 1e3
    P = stream[0].shape[0]
    launched = fs.SCAN_LAUNCHED[variant]
    print(f"{variant}: kernel {ms:.3f} ms ({ms * 1e3 / P:.3f} us/pod; the default variant {default_ms:.3f} ms), "
          f"of which {passes} counting passes "
          f"{count_ms:.3f} ms ({count_ms * 1e3 / max(passes, 1):.3f} us each); bound {max(t_bytes, t_ops):.6f} ms "
          f"({work['bytes']} B, {work['ops']} flop; counting {work['count']['ops']} op); ptxas "
          f"{json.dumps(launched['ptxas'])}", flush=True)
    return {
        "name": variant, "plan": plan, "route": "cuda", "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu",
        "replaces": "opensim_tpu/ops/kernels.py:1056", "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "pods": P, "plain_pods": plain_pods, "default_ms": default_ms,
        "count_passes": passes, "count_ms": count_ms,
        "us_per_pass": count_ms * 1e3 / max(passes, 1), "ptxas": launched["ptxas"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None, **(extra or {}),
    }


def _explained(device, make, variant: str, what: str, reasons_of=None):
    """simulate(explain=True) on a fresh copy of the plan with the launch
    counts set to 0 just before: exactly one launch of `variant`, every
    pod of the stream explained, the reject totals those of the kernel's
    rows; with `reasons_of` (a run without explain mode), its placements
    and reasons. Returns the result and its launches."""
    from opensim_tpu_torch.engine import explain, reasons, simulator as sim
    from opensim_tpu_torch.ops import fast_scan as fs

    cluster, apps = make()
    torch.cuda.synchronize()
    fs.LAUNCHES = 0
    fs.VARIANT_LAUNCHES.clear()
    res = sim.simulate(cluster, apps, device=device, explain=True)
    launches, by_variant = fs.LAUNCHES, dict(fs.VARIANT_LAUNCHES)
    if launches != 1 or by_variant != {variant: 1}:
        raise AssertionError(f"{what}: simulate(explain=True) launched {by_variant}, want exactly one {variant}")
    ctx = res.explain_ctx
    if len(res.explanations) != len(ctx.prep.ordered) or res.engine != f"{variant} on {torch.device(device).type}":
        raise AssertionError(f"{what}: {len(res.explanations)} explanations of {len(ctx.prep.ordered)} pods, "
                             f"engine {res.engine}")
    rejects = explain.audit_rejects(ctx.static_fail, ctx.sf_rows, ctx.fail_counts, ~ctx.prep.forced)
    if res.filter_rejects != reasons.rejects_dict(rejects):
        raise AssertionError(f"{what}: the reject totals are not the kernel rows' sums")
    if reasons_of is not None:
        if not np.array_equal(res.placements, reasons_of.placements) or \
                [u.reason for u in res.unscheduled_pods] != [u.reason for u in reasons_of.unscheduled_pods]:
            raise AssertionError(f"{what}: explain mode placed or reasoned differently from the run without it")
    wall = sum(res.timings.values())
    print(f"{what}: simulate(explain=True) launched {by_variant}; {len(res.explanations)} explanations, "
          f"{sum(e.status != 'scheduled' for e in res.explanations)} not scheduled; filter rejects "
          f"{json.dumps(res.filter_rejects)}")
    print("timings: " + json.dumps({k: round(v, 6) for k, v in res.timings.items()}))
    print(f"plan wall-clock {wall:.6f} s, {len(ctx.prep.ordered) / wall:.1f} pods/s (host clock)", flush=True)
    return res, launches


def make_apps(make):
    """`make` (cluster, app) as (cluster, [AppResource])."""
    from opensim_tpu_torch.engine import simulator as sim

    def made():
        cluster, app = make()
        return cluster, [sim.AppResource("plan", app)]
    return made


def explain_plan(device, label: str, make, variant: str, rejects: bool = False) -> dict:
    """A plan in explain mode: over the whole stream the [explain] kernel's
    placements, GPU takes and final state equal the default variant's, and
    its counts on the failing pods the default's; its counts equal the
    plain version counting every step over the first EXPLAIN_PLAIN_PODS
    pods (all ten outputs); with `rejects`, some binding step of that
    prefix rejects nodes; simulate(explain=True) through exactly one
    launch; the kernel timed. Returns its row of the kernels table."""
    from opensim_tpu_torch.engine import fastpath, simulator as sim
    from opensim_tpu_torch.ops import fast_scan as fs

    _phase(f"{label}: {N_NODES} nodes, {N_PODS} pods in explain mode: kernel vs the default variant over the whole "
           f"stream, vs plain over its first {EXPLAIN_PLAIN_PODS} pods")
    cluster, app = make()
    prep = sim.prepare(cluster, [sim.AppResource("plan", app)], device=device)
    fi, _ = fastpath.build_inputs(prep)
    if fs.variant_name(fi, explain=True) != variant:
        raise AssertionError(f"the plan runs {fs.variant_name(fi, explain=True)}, not {variant}")
    stream = fastpath.pod_stream(prep)
    got = fs.fast_scan(fi, *stream, explain=True)
    default = fs.fast_scan(fi, *stream)
    err = _same(got, default, f"{label}: explain vs the default variant", fs.STATE_FIELDS)
    failing = (default.chosen < 0) & (stream[1] != 0) & (stream[2] == 0)
    if not torch.equal(got.fail_counts[failing], default.fail_counts[failing]) or \
            not torch.equal(got.insufficient[failing], default.insufficient[failing]):
        raise AssertionError(f"{label}: the failing pods' counts differ from the default variant's")
    bound_counted = int((got.fail_counts.any(1) & (got.chosen >= 0)).sum())
    head = tuple(t[:EXPLAIN_PLAIN_PODS].contiguous() for t in stream)
    got_head = fs.fast_scan(fi, *head, explain=True)
    plain = [None]

    def run_plain():
        plain[0] = fs.fast_scan_reference(fi, *head, count_all=True)

    plain_ms = _events_ms(run_plain, reps=1)
    err = max(err, _same(got_head, plain[0], f"{label}: explain, {EXPLAIN_PLAIN_PODS} pods vs plain"))
    if rejects and not bool((got_head.fail_counts.any(1) & (got_head.chosen >= 0)).any()):
        raise AssertionError(f"{label}: no binding step of the checked prefix rejected a node")
    print(f"{N_PODS} pods: explain and default variants identical on the eight state outputs, the {int(failing.sum())} "
          f"failing pods' counts too; {bound_counted} binding steps rejected nodes; {EXPLAIN_PLAIN_PODS} pods: kernel "
          f"and plain version (count_all) identical on all ten outputs (plain {plain_ms:.3f} ms)", flush=True)
    res, launches = _explained(device, make_apps(make), variant, label)
    if not np.array_equal(res.placements, default.chosen.cpu().numpy()):
        raise AssertionError(f"{label}: simulate(explain=True) placed differently from the default variant")
    return _explain_row(fi, stream, variant, label.split(" ", 1)[1], launches, err, plain_ms, EXPLAIN_PLAIN_PODS,
                        {"binding_steps_counted": bound_counted, "plan_wall_s": sum(res.timings.values())})


def explain_oversubscribed(device) -> dict:
    """The over-subscribed plan in explain mode: over the whole stream the
    [explain] kernel's state outputs equal the default variant's, and its
    counts on every failing step; over the first EXPLAIN_PLAIN_PODS pods
    all ten outputs equal the plain version's counting every step;
    simulate(explain=True) through exactly one launch, placing and
    reasoning as the run without it; then
    ``explain_pod`` on the card for a pod that found no node, whose torch
    re-score finds no feasible node either. Returns its row."""
    from opensim_tpu_torch.engine import explain, fastpath, simulator as sim
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs

    variant = "fast_scan[explain]"

    def make():
        return fx.oversubscribed_cluster(N_NODES), [
            sim.AppResource(name, app) for name, app in fx.oversubscribed_apps(N_NODES, N_PODS)]

    _phase(f"46 over-subscribed plan in explain mode: {N_PODS + OVER_HEAD} pods, kernel vs the default variant over "
           f"the whole stream, simulate(explain=True), explain_pod of an unscheduled pod on the card")
    prep = sim.prepare(*make(), device=device)
    fi, _ = fastpath.build_inputs(prep)
    stream = fastpath.pod_stream(prep)
    got = fs.fast_scan(fi, *stream, explain=True)
    default = fs.fast_scan(fi, *stream)
    err = _same(got, default, "over-subscribed plan: explain vs the default variant", fs.STATE_FIELDS)
    failing = (default.chosen < 0) & (stream[1] != 0) & (stream[2] == 0)
    if not bool(failing.any()) or not torch.equal(got.fail_counts[failing], default.fail_counts[failing]) or \
            not torch.equal(got.insufficient[failing], default.insufficient[failing]):
        raise AssertionError("over-subscribed plan: the failing steps' counts differ from the default variant's")
    head = tuple(t[:EXPLAIN_PLAIN_PODS].contiguous() for t in stream)
    plain = [None]

    def run_plain():
        plain[0] = fs.fast_scan_reference(fi, *head, count_all=True)

    plain_ms = _events_ms(run_plain, reps=1)
    err = max(err, _same(fs.fast_scan(fi, *head, explain=True), plain[0],
                         f"over-subscribed plan: explain, {EXPLAIN_PLAIN_PODS} pods vs plain"))
    print(f"{stream[0].shape[0]} pods: explain and default variants identical on the eight state outputs and on the "
          f"{int(failing.sum())} failing steps' counts; {EXPLAIN_PLAIN_PODS} pods: kernel and plain version "
          f"(count_all) identical on all ten outputs (plain {plain_ms:.3f} ms)", flush=True)
    plain_res = sim.simulate(*make(), device=device)
    res, launches = _explained(device, make, variant, "over-subscribed plan", reasons_of=plain_res)
    i = int(torch.nonzero(failing)[-1])
    deep = explain.explain_pod(res.explain_ctx, i)
    step, _parts = explain.rescore(res.explain_ctx, i)
    if deep.status != "unschedulable" or step.chosen != -1 or bool(step.feasible.any()):
        raise AssertionError(f"pod {i}: explain_pod says {deep.status}, the torch re-score chose {step.chosen}")
    want = {id(u.pod): u.reason for u in res.unscheduled_pods}[id(res.explain_ctx.prep.ordered[i])]
    if deep.message != want:
        raise AssertionError(f"pod {i}: explain_pod says {deep.message!r}, the report {want!r}")
    print(f"explain_pod({i}) on the card: {deep.message}; the torch re-score finds no feasible node", flush=True)
    return _explain_row(fi, stream, variant, "over-subscribed plan", launches, err, plain_ms, EXPLAIN_PLAIN_PODS,
                        {"unscheduled": len(res.unscheduled_pods), "plan_wall_s": sum(res.timings.values())})


def explain_capacity(device) -> dict:
    """simulate(explain=True) on the capacity plan, timed by phase; the
    [explain] kernel against the plain version over EXPLAIN_PLAIN_PODS pods;
    ``explain_pod`` on the card for a scheduled pod near the end of the
    stream, whose torch re-score (``pod_step`` at full width on the card)
    takes the node the kernel took. Returns its row."""
    from opensim_tpu_torch.engine import explain, fastpath, simulator as sim
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs

    variant = "fast_scan[explain]"
    make = make_apps(lambda: (fx.synthetic_cluster(N_NODES), fx.synthetic_apps(N_PODS)))
    _phase(f"47 capacity plan in explain mode: simulate(explain=True), kernel vs plain over {EXPLAIN_PLAIN_PODS} pods, "
           f"explain_pod of a scheduled pod near the end on the card")
    res, launches = _explained(device, make, variant, "capacity plan")
    ctx = res.explain_ctx
    prep = ctx.prep
    fi, _ = fastpath.build_inputs(prep)
    stream = fastpath.pod_stream(prep)
    head = tuple(t[:EXPLAIN_PLAIN_PODS].contiguous() for t in stream)
    plain = [None]

    def run_plain():
        plain[0] = fs.fast_scan_reference(fi, *head, count_all=True)

    plain_ms = _events_ms(run_plain, reps=1)
    err = _same(fs.fast_scan(fi, *head, explain=True), plain[0], f"capacity plan: explain, {EXPLAIN_PLAIN_PODS} pods")
    i = len(prep.ordered) - 7
    t0 = time.perf_counter()
    deep = explain.explain_pod(ctx, i)
    deep_s = time.perf_counter() - t0
    step, parts = explain.rescore(ctx, i)
    c = int(res.placements[i])
    if deep.status != "scheduled" or step.chosen != c or deep.node != prep.meta.node_names[c]:
        raise AssertionError(f"pod {i}: the kernel chose node {c}, the torch re-score {step.chosen} ({deep.status})")
    print(f"explain_pod({i}) on the card ({deep_s:.3f} s): {deep.message}; the torch pod_step's lowest-index argmax "
          f"over the feasible nodes is the kernel's node {c}; breakdown {json.dumps(deep.scores)}", flush=True)
    return _explain_row(fi, stream, variant, "capacity plan", launches, err, plain_ms, EXPLAIN_PLAIN_PODS,
                        {"plan_wall_s": sum(res.timings.values()), "plan_timings": res.timings,
                         "explain_pod_s": deep_s})


def apply_explain(device, card: str) -> dict:
    """``simon apply --explain`` on the apply plan (phase 28's directories)
    through the Applier on the card: both one scans in explain mode, the
    grids as before, the report's placement audit; then the example
    configs with ``--explain``, card report vs CPU report. Returns the
    masked one scan's row."""
    from opensim_tpu_torch.engine import fastpath
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.parallel import scenarios
    from opensim_tpu_torch.planner import apply

    _phase("48 apply plan: simon apply --explain (Applier.run() on the card)")
    root = _plan_dir() / "apply"
    report = root / "report-explain.txt"
    torch.cuda.synchronize()
    fs.LAUNCHES = 0
    fs.VARIANT_LAUNCHES.clear()
    fs.SCAN_LAUNCHED.clear()
    t0 = time.perf_counter()
    applier = apply.Applier(apply.Options(simon_config=str(root / "config.yaml"), output_file=str(report),
                                          max_new_nodes=APPLY_MAX_NEW, explain=True))
    rc = applier.run()
    wall = time.perf_counter() - t0
    by_name = dict(fs.VARIANT_LAUNCHES)
    text = report.read_text()
    if rc != 0 or applier.n_new != APPLY_NEW or "\nPlacement audit:\n" not in text:
        raise AssertionError(f"simon apply --explain returned {rc} with {applier.n_new} new nodes:\n{text[-2000:]}")
    if by_name != {"fast_scan[explain]": 2, "fast_scan_sweep": 2}:
        raise AssertionError(f"simon apply --explain launched {by_name}, want two fast_scan[explain] and two grids")
    audit = text[text.index("\nPlacement audit:\n") + 1:].splitlines()
    plain_text = (root / "report.txt").read_text()
    if _without_counters(text[:text.index("\nPlacement audit:\n")]) != _without_counters(plain_text.rstrip("\n")):
        raise AssertionError("simon apply --explain reported the placements differently from simon apply")
    (coarse, coarse_s), (fine, fine_s) = applier.sweeps
    steps = dict(applier.timings, **{"sweep: coarse": coarse_s, "sweep: fine": fine_s})
    print(f"simon apply --explain: rc {rc}, {applier.n_new} new nodes, launches {by_name}; the report above its "
          f"audit is phase 28's; audit: {audit[1].strip() if len(audit) > 1 else ''}; {len(audit) - 2} audit lines")
    print("steps: " + json.dumps({k: round(v, 6) for k, v in steps.items()}))
    print(f"simon apply --explain wall-clock {wall:.6f} s against the {APPLY_LIMIT_S:.0f} s limit: "
          f"{'met' if wall < APPLY_LIMIT_S else 'missed'} ({card})", flush=True)
    prep = applier.prep_full
    (node_valid,), (pod_valid,) = scenarios.count_masks(prep, N_NODES, [APPLY_NEW])  # the masked re-simulation's
    fi, _ = fastpath.build_inputs(prep, node_valid)
    stream = fastpath.pod_stream(prep, pod_valid)
    head = tuple(t[:APPLY_PLAIN_PODS].contiguous() for t in stream)
    plain = [None]

    def run_plain():
        plain[0] = fs.fast_scan_reference(fi, *head, count_all=True)

    plain_ms = _events_ms(run_plain, reps=1)
    err = _same(fs.fast_scan(fi, *head, explain=True), plain[0], f"apply --explain: masked, {APPLY_PLAIN_PODS} pods")
    row = _explain_row(fi, stream, "fast_scan[explain]", f"apply plan --explain, masked re-simulation at "
                       f"k={APPLY_NEW}", by_name["fast_scan[explain]"], err, plain_ms, APPLY_PLAIN_PODS,
                       {"launches_are": "the path's two one scans, first simulation and masked",
                        "apply_wall_s": wall, "apply_steps_s": steps})
    _phase("49 example configs: simon apply --explain on the card against the plain versions on the CPU")
    example_reports(device, explain=True)
    return row


def _explain_name(variant: str) -> str:
    """The [explain] variant of a default variant's name."""
    return variant[:-1] + ",explain]" if variant.endswith("]") else variant + "[explain]"


def example_reports(device, explain: bool = False) -> None:
    """The example configs through the port's Applier, on the CPU (the
    plain versions) and on the card: the two reports equal; with
    `explain`, ``simon apply --explain``'s (the placement audit too), on
    the [explain] variants."""
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.planner import apply

    if not explain:
        _phase("30 example configs: simon apply on the card against the plain versions on the CPU")
    root = _plan_dir() / "examples"
    root.mkdir(parents=True, exist_ok=True)
    for config, extended, variant in EXAMPLES:
        runs = []
        for where, dev in (("cpu", "cpu"), ("card", str(device))):
            out = root / f"{config}.{where}{'.explain' if explain else ''}.txt"
            fs.VARIANT_LAUNCHES.clear()
            rc = apply.Applier(apply.Options(simon_config=_example(config), output_file=str(out),
                                             extended_resources=extended, device=dev, explain=explain)).run()
            runs.append((rc, out.read_text(), dict(fs.VARIANT_LAUNCHES)))
        (rc_cpu, cpu, _), (rc_card, card_text, launches) = runs
        if rc_cpu != 0 or rc_card != 0 or _without_counters(cpu) != _without_counters(card_text):
            raise AssertionError(f"{config}: the card's report (rc {rc_card}) differs from the CPU's (rc {rc_cpu})")
        base = {n.replace("fast_scan_sweep", "fast_scan").replace(",explain]", "]").replace("[explain]", "")
                for n in launches}
        scans = {n for n in launches if not n.startswith("fast_scan_sweep")}
        if base != {variant} or scans != {_explain_name(variant) if explain else variant}:
            raise AssertionError(f"{config}: launched {launches}, want {variant} (built in phase 2)"
                                 + (" in explain mode" if explain else ""))
        if explain and "\nPlacement audit:\n" not in card_text:
            raise AssertionError(f"{config}: the card's report has no placement audit")
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
         "fast_scan[interpod]", AFFINITY_PLAIN_PODS),
        ("13-15 score-table plan", lambda: (fx.score_cluster(N_NODES), fx.score_apps(N_PODS)),
         "fast_scan[na,tt,avoid]", 5000),
        ("16-18 host-port plan", lambda: (fx.score_cluster(N_NODES), fx.score_apps(N_PODS, host_port=True)),
         "fast_scan[na,tt,avoid,ports]", 5000),
        ("19-21 all-local-PV plan", lambda: (fx.local_pv_cluster(N_NODES), fx.local_pv_apps(N_PODS)),
         "fast_scan[local]", 5000),
    ]

    _phase("2 build")
    variants = sorted({v for *_rest, v, _p in plans} | {fs.variant_name(fi) for _n, _p, fi in _small_preps("cpu")}
                      | {v for *_rest, v in EXAMPLES} | set(CFG_VARIANTS) | set(EXPLAIN_VARIANTS)
                      | {_explain_name(v) for *_rest, v in EXAMPLES})
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
    rows.append(full_plan(device, "31-33 config plan", lambda: (fx.score_cluster(N_NODES, blocked=10),
                                                                fx.score_apps(N_PODS, widget=True)),
                          "fast_scan[na,tt,avoid,cfg]", CFG_PLAIN_PODS, sched_text=fx.SCHED_CONFIG_PLAN))
    rows.append(two_profile_plan(device))
    rows.append(full_plan(device, "37-39 sampled plan", lambda: (fx.synthetic_cluster(N_NODES), fx.synthetic_apps(N_PODS)),
                          "fast_scan[sample]", CFG_PLAIN_PODS, tie_seed=TIE_SEED))
    rows.extend(apply_config_plan(device, card))
    rows.append(explain_plan(device, "42-43 affinity-heavy plan at maxSkew 1",
                             lambda: (fx.synthetic_cluster(N_NODES), fx.affinity_apps(N_PODS, max_skew=1)),
                             "fast_scan[interpod,explain]", rejects=True))
    rows.append(explain_plan(device, "44-45 all-GPU-share plan", lambda: (fx.gpu_cluster(N_NODES), fx.gpu_apps(N_PODS)),
                             "fast_scan[gpu,gc,explain]"))
    rows.append(explain_oversubscribed(device))
    rows.append(explain_capacity(device))
    rows.append(apply_explain(device, card))
    print(f"smoke run {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
