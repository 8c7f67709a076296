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
and (the base ones) with the sampled tie-break; phase 3's plain versions
run on the CPU, on copies of the launches' inputs, in worker processes
beside the card's launches, as phase 62's plain sweeps do. Then the scheduler-config
and sampled paths (phases 31-41): the config plan (the score-table plan
with a NoSchedule taint no pod tolerates on every tenth node and one
Deployment asking a resource no node offers, under a one-profile config
that turns the taint filter off, ignores that resource and reweighs the
scores: ``fast_scan[na,tt,avoid,cfg]``, its placements against the
default config's), the two-profile plan (the capacity plan, its second
half under the ``batch`` profile: two launches of ``fast_scan[cfg]``, the
second from the first's state) and the sampled plan (the capacity plan
with tie seed 7: ``fast_scan[sample]``), each against its plain version
over 1,000 pods (of each segment; the sampled plan over 3,000), the first
two against grid launches at
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
1,000 pods; the over-subscribed plan (``fast_scan[explain]``), its failing
steps' counts the default variant's over the whole stream; the capacity
plan's simulate(explain=True) timed by phase; each simulate(explain=True)
through exactly one launch; ``explain_pod`` on the card for an
unscheduled pod and a scheduled one near the end of the stream, whose
torch re-score (``kernels.pod_step`` at full width) takes the kernel's
node; ``simon apply --explain`` on the apply plan, its report above the
placement audit phase 28's; and the example configs' ``--explain``
reports, card against CPU. The affinity-heavy plan's default variant is
held against the plain version over its first 1,000 pods (phase 10;
against the grid over the whole stream), leaving the run time for these
phases; past that prefix, it and the explain-mode plans of phases 42-45
are held against the torch step (``kernels.pod_step``) re-run on the card
from the replayed state before each of 100 steps spread over the whole
stream: the chosen node and, in explain mode, the step's counts.
Then ``simon server`` (phases 50-55): the capacity fleet served by the
port's stub apiserver, whose snapshot holds the capacity plan's first ten
Deployments (25,000 pods) bound where a card simulate() placed them; the
server started as ``serve()`` starts it, its kernel variants built before
it listens; eight requests over HTTP in order, each with the launch counts
read around it: healthz, deploy-apps of the next ten Deployments (cold:
the snapshot's base prepare and a delta re-encode, one launch at 50,000
pods), the same again (a full-key hit, no encode, the same answer),
scale-apps of bench-0 to 5,000 replicas (a drop mask over its 2,500 bound
pods, one launch), the deploy with 100 new nodes (node extension, one
launch at 5,100 nodes), the deploy with explain=1 (one ``[explain]``
launch, its placements served), a spent deadline (504, no launch) and
/metrics; then the scale answer and the new-nodes deploy's against the
uncached server's full prepares on the card, and the kernel rows of three
requests, each held against the
plain version over 2,000 of the request's own pods (the plain version
starting from the kernel's state before them; in explain mode from the
first step where the kernel counted a rejection, if any) on every output,
the final state included. Then
``prepcache.simulate_cached`` on the capacity plan, one cold call and ten
warm hits, and ``simon apply`` in kubeConfig mode (the example config's
cluster listed from the stub apiserver), card report vs CPU report.
Then the sweep consumers (phases 56-61): ``simon defrag --json
--candidates`` on the capacity plan written as YAML (one grid launch, its
rows phase 22's plans, its steps timed, the grid phase 23's on the same
inputs and its head phase 24's plain sweep) and on the example configs, card against CPU; the capacity
observatory on the server plan's running server: ``GET
/api/cluster/report`` with the default headroom profiles and the fixture
profile whose headroom lies inside its ladder (one grid launch per probe
scan: each profile's ladder, then its bisection at S = 1), card
``simulate()`` placing k replicas of it and not k + 1, the ladder's rows
at the largest feasible and the smallest infeasible k and one bisection
launch against the plain version over their probe pods (from the grid's
state after the snapshot's forced binds), the timeline, ``simon top
--json`` and ``/metrics``; and lifecycle campaigns: the campaign plan (the
capacity fleet and Deployments under PDBs, a canary, a rolling drain, a
spot storm, an autoscaler add, a scale-up, scale-down checks and a defrag
plan; ``fixtures.write_campaign_plan``) in warm mode, every scheduling
pass one ``fast_scan[cfg]`` launch from its carried state, each step's
wall-clock, launches and kernel share printed, every launch against the
plain version over its valid pods (the baseline's first 2,000, and its
whole stream against a grid launch at S = 1 from the same state); cold mode
over the baseline, the canary and the rolling drain, its fingerprints warm
mode's;
example/campaign.yaml card against CPU; ``POST /api/campaign`` on the
server plan's server against an in-process ``run_campaign``.
Then the live twin (phases 65-67): ``simon server --watch on --journal``
started in this process on the server plan's stub; wave W1 (2,000 pods
ADDED, 1,000 of the snapshot's DELETED, 20 nodes ADDED) and wave W2 (a
node MODIFIED) sent through the stub, after each the twin's fingerprint a
full relist's and R2's body served from the twin (its generation in the
request's trace; after W1 a delta on the folded base, no full prepare)
with the uncached server's answer on the relisted cluster, W1's request's
kernel row against the plain version and the torch step; storm A sent
while a wave of events lands (every launch the grid's ``[count]``, each
lane its one scan over the whole stream); the server as a subprocess on
the card, SIGKILLed after wave W3 and restarted on its journal (checkpoint
and suffix, no list, no variant rebuilt), its answer the in-process
twin's, and that the uncached server's on the relisted cluster once the
storm's wave and W3 have settled (the polling answer); ``simon replay
--capacity --schedule`` on the journal, its fingerprint the relist's and
its count a card ``simulate()``'s.
Then the serving fleet (phase 68), while the in-process twin serves:
``simon server --workers 2 --watch on --journal`` under ``OPENSIM_HA=1``
on phase 67's journal (restored from checkpoint and suffix: no list, no
relist, no variant built; /dev/shm must hold two generations of its
publication), R2's body on each worker (one ``fast_scan`` each, the
in-process twin's answer), the publication attached in this process (its
request's kernel row against the plain version over 2,000 of its pods),
storm A at the fleet's port (every rider the in-process twin's answer), a
wave W4 (both workers attach the new generation and answer as the twin),
``simon server --standby`` at parity, a SIGKILL of the owner (the standby
takes over at epoch 2, reason expired, no relist, the two workers adopted,
none respawned), SIGTERM (every process exits 0 with "shutdown
complete", no ``simon-fleet-*`` segment left in /dev/shm).
Every phase raises on failure, and each prints the time it took.
The last lines are the card's name and power limit, one JSON line with
a row per kernel variant timed at full width, one for the drain sweep,
three for the apply plan (the masked one scan, the coarse and the fine
grid), one each for the config, two-profile and sampled plans (the
last timed over its checked prefix, whose ties the plain version records
for its bound), three
for the apply plan under ``-d``, five for explain mode, three for the
server plan, one for ``simon defrag``'s grid, two for the headroom probes
(the ladder and a bisection step), one for the campaign plan's launches
(in all and their median), two for the storms, one for the live twin's
request after W1, one for the fleet's R2 from the publication, and
``{"ok": true, "device": {...}}``.
Without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
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
#: and the last two (the last full block's last scenario and the ragged
#: block's) over a prefix each.
N_SCENARIOS = 1000
PLAIN_SCENARIOS, PLAIN_PODS = 2, 2000
LATE_PODS = 2000
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
#: first CFG_PLAIN_PODS pods of the config plan and of each segment of the
#: two-profile plan (both are also held whole against the grid at S = 1),
#: and the first SAMPLED_PLAIN_PODS of the sampled plan (no grid samples);
#: the sampled plan's seed. SMALL_CONFIG is the config phase 3 runs the
#: small cases of the default and score-table variants under.
CFG_PLAIN_PODS = 1000
SAMPLED_PLAIN_PODS = 3000
TIE_SEED = 7
SMALL_CONFIG = dict(w_balanced=0.0, w_least=3.0, w_node_affinity=2.0, w_taint_toleration=5.0, w_spread=1.0,
                    w_prefer_avoid=0.0, w_simon=0.5, f_taints=False, f_spread=False, fit_ignored_cols=(1,))
#: The variants the new plans and phase 3's config and sampled cases run.
CFG_VARIANTS = ("fast_scan[cfg]", "fast_scan[na,tt,avoid,cfg]", "fast_scan[sample]")
#: Explain mode (phases 42-49): the plain version counting every step
#: checks the first EXPLAIN_PLAIN_PODS pods of each plan; the variants the
#: plans run (the examples' are their own variants', explained). The
#: six plans of phases 4-21 are held against the plain version over their
#: first PLAN_PLAIN_PODS pods (and against the grid over the whole stream),
#: which leaves the run time for these phases, the live twin's and the
#: serving fleet's.
EXPLAIN_PLAIN_PODS = 1000
EXPLAIN_VARIANTS = ("fast_scan[interpod,explain]", "fast_scan[gpu,gc,explain]", "fast_scan[explain]")
PLAN_PLAIN_PODS = 1000
#: The affinity-heavy plan's default variant (phases 10-12) and the
#: explain-mode plans (phases 42-45) are also held against the torch step
#: (``kernels.pod_step``) re-run on the card from the replayed state before
#: each of REPLAY_STEPS steps spread over the whole stream: the chosen
#: node, and in explain mode the step's counts.
REPLAY_STEPS = 100
#: The server plan (phases 50-53): the snapshot holds the capacity plan's
#: first fixtures.SERVER_BOUND Deployments bound on the fleet; R5 adds
#: SERVER_NEW nodes; the snapshot is cached for SERVER_TTL_S (longer than
#: the phase, so every request reads one fingerprint); each kernel row is
#: held against the plain version over SERVER_PLAIN_PODS of the request's
#: own pods (from the kernel's state before them; the live twin's and the
#: fleet's rows too) and the torch step over SERVER_REPLAY_STEPS steps of
#: the request's pods. The steady phase (54) runs STEADY_WARM warm
#: simulate_cached() calls.
SERVER_NEW = 100
SERVER_TTL_S = 3600.0
SERVER_PLAIN_PODS = 2000
SERVER_REPLAY_STEPS = 100
STEADY_WARM = 10
#: The campaign plan (phases 59-61, fixtures.write_campaign_plan): every
#: launch is held against the plain version over its valid pods, the
#: baseline's (all 50,000) over its first CAMPAIGN_PLAIN_PODS; the cold run
#: covers the baseline and the first COLD_STEPS steps (the canary deploy and
#: the rolling drain, a full prepare a scheduling pass: its drain is cut to
#: two waves); POST /api/campaign on the server plan drains
#: SERVER_CAMPAIGN_DRAIN nodes, SERVER_CAMPAIGN_WAVE a wave.
CAMPAIGN_PLAIN_PODS = 2000
CAMPAIGN_SIZES = dict(canary=1000, drain=10, drain_wave=5, reclaim=50, add=20, scale_up=500, check=32, defrag=64,
                      defrag_max=8, defrag_wave=4)
COLD_STEPS = 2
SERVER_CAMPAIGN_DRAIN, SERVER_CAMPAIGN_WAVE = 4, 2
#: The variant every campaign pass launches, on the campaign plan, on
#: example/campaign.yaml's demo cluster and on the server plan's snapshot
#: (the cfg variant takes the carried state; built with CFG_VARIANTS).
CAMPAIGN_VARIANT = "fast_scan[cfg]"
#: The request storms (phases 62-64): the coalescing window the storms'
#: admission queue takes (tests/test_admission.py's), the lanes of phase
#: 62's grid in waves (more than the card's 132 SMs), and the explain
#: rider's pods the plain sweep checks (the 80-core rider's are 100).
STORM_WINDOW_S = 0.25
WAVE_LANES = 140
STORM_PLAIN_PODS = 2000
#: Phase 62 runs its plain sweeps in this many CPU processes beside the card's launches.
PLAIN_WORKERS = 6
#: The live twin (phases 65-67) on the server plan's stub: wave W1 adds
#: TWIN_ADD pods (bound round-robin, in the requested workloads' shapes),
#: deletes TWIN_DEL of the snapshot's and adds TWIN_NEW_NODES nodes; the
#: storm of phase 66 runs under a wave of TWIN_STORM_WAVE pods ADDED and
#: as many DELETED, and phase 67's W3 under one of TWIN_W3_WAVE each;
#: ``simon replay --schedule`` places TWIN_REPLAY_PODS replicas. Every
#: wait is bounded by TWIN_WAIT_S, a subprocess's start by TWIN_START_S.
TWIN_ADD, TWIN_DEL, TWIN_NEW_NODES = 2000, 1000, 20
TWIN_STORM_WAVE = 250
TWIN_W3_WAVE = 250
TWIN_REPLAY_PODS = 5000
TWIN_WAIT_S = 120.0
TWIN_START_S = 240.0
#: The serving fleet (phase 68) on phase 67's journal: FLEET_WORKERS
#: worker processes under an HA lease of FLEET_LEASE_S seconds: the owner's
#: renewals stall for seconds at this size (its full collections), and a
#: live owner lost a 2 s lease to the standby on the card and left a 5 s
#: lease unrenewed for 5.1 s (PERF.md); wave W4 adds FLEET_W4_WAVE pods and
#: deletes as many.
FLEET_WORKERS = 2
FLEET_LEASE_S = 10.0
FLEET_W4_WAVE = 250
EXAMPLES = (("simon-config.yaml", [], "fast_scan[interpod]"),
            ("simon-gpushare-config.yaml", ["gpu"], "fast_scan[gpu]"),
            ("simon-local-config.yaml", ["open-local"], "fast_scan[local]"))


_PHASE_T = []


def _phase(name: str) -> None:
    """Print a phase's header, after the time the previous phase took."""
    now = time.perf_counter()
    if _PHASE_T:
        print(f"   (phase took {now - _PHASE_T[-1]:.1f} s)")
    _PHASE_T.append(now)
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
    """Phase 3: each small case as one scan, as a masked one scan (a node
    and a third of the pods out) and as a sweep of three drains, and (the
    base and score-table variants) under SMALL_CONFIG and sampled
    (:func:`_config_small_case`), each launch held against the plain
    version on all ten outputs. The plain versions run on the CPU, on
    copies of the launches' inputs, in PLAIN_WORKERS processes while the
    card runs the launches, as phase 62 runs its plain sweeps."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from opensim_tpu_torch.engine import fastpath
    from opensim_tpu_torch.ops import fast_scan as fs

    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t
    masked_failures = 0
    held, lines = [], []
    with ProcessPoolExecutor(PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:

        def hold(sweep: bool, fi, args, got, what: str, **kw) -> None:
            """Submit the plain version of a launch (`got`) on CPU copies of
            its inputs; the comparison comes when every case has run."""
            plain = pool.submit(_plain_on_cpu, sweep, fs.FastInputs(*map(cpu, fi)), [cpu(t) for t in args], kw)
            held.append((plain, fs.FastOutputs(*map(cpu, got)), what))

        for name, prep, fi in _small_preps(device):
            stream = fastpath.pod_stream(prep)
            got = fs.fast_scan(fi, *stream)
            hold(False, fi, stream, got, f"case {name}")
            # the same case on a masked node axis (node 1 out) and stream
            # (every third pod out), as the planner's masked re-simulation
            # launches it
            node_valid = prep.ec_np.node_valid.copy()
            node_valid[min(1, len(node_valid) - 1)] = False
            pod_valid = np.arange(len(prep.tmpl_ids)) % 3 != 2
            fi_m = fastpath.build_inputs(prep, node_valid)[0]
            stream_m = fastpath.pod_stream(prep, pod_valid)
            got_m = fs.fast_scan(fi_m, *stream_m)
            hold(False, fi_m, stream_m, got_m, f"case {name}, masked")
            failing_m = int(((got_m.chosen < 0) & (stream_m[1] != 0) & (stream_m[2] == 0)).sum())
            masked_failures += failing_m
            grid = _drain_grid(prep, list(range(min(3, len(prep.meta.node_names)))))
            got_s = fs.fast_scan_sweep(fi, *grid)
            hold(True, fi, grid, got_s, f"case {name}, sweep of {grid[1].shape[0]} drains")
            extra = _config_small_case(prep, fs.variant_name(fi), name, hold)
            counted = int(got.fail_counts.any(1).sum())
            lines.append(f"case {name} ({fs.variant_name(fi)}): N={fi.alloc_T.shape[1]} P={len(prep.tmpl_ids)} "
                         f"placed={int((got.chosen >= 0).sum())} counted failures={counted} "
                         f"gpu slots={int(got.gpu_take.sum())} ports used={int(got.port_used.sum())} "
                         f"devices taken={int((got.dev_free < fi.dev0).sum())} identical; sweep of "
                         f"{grid[1].shape[0]} drains identical (placed {(got_s.chosen >= 0).sum(1).tolist()}); masked "
                         f"one scan identical ({int(pod_valid.sum())} pods on {int(node_valid.sum())} nodes, "
                         f"{failing_m} found no node){extra}")
        for plain, got, what in held:
            _same(got, plain.result(), what)
    for line in lines:
        print(line, flush=True)
    print(f"{len(held)} launches identical to the plain version on the CPU on all ten outputs", flush=True)
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


def _config_small_case(prep, variant: str, name: str, hold) -> str:
    """A small case of the default or score-table variant also under
    SMALL_CONFIG (the cfg variant's one scan and three-drain grid against
    the plain versions), cut in two with the state carried (one scan and
    grid, against one launch), and with the default variant sampled
    (TIE_SEED; against the plain version). The plain versions go to
    `hold` (:func:`small_cases`). Returns what it checked."""
    from opensim_tpu_torch.engine import fastpath, schedconfig
    from opensim_tpu_torch.ops import fast_scan as fs

    if variant not in ("fast_scan", "fast_scan[na,tt,avoid]"):
        return ""
    fi, _ = fastpath.build_inputs(prep, cfg=schedconfig.SchedulerConfig(**SMALL_CONFIG))
    stream = fastpath.pod_stream(prep)
    whole = fs.fast_scan(fi, *stream)
    hold(False, fi, stream, whole, f"case {name} under a config")
    grid = _drain_grid(prep, list(range(min(3, len(prep.meta.node_names)))))
    whole_g = fs.fast_scan_sweep(fi, *grid)
    hold(True, fi, grid, whole_g, f"case {name} under a config, sweep")
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
        hold(False, fi0, stream, fs.fast_scan(fi0, *stream, tie_seed=TIE_SEED), f"case {name} sampled",
             tie_seed=TIE_SEED)
        out += f"; sampled ({fs.variant_name(fi0, True)}) identical"
    return out


def full_plan(device, label: str, make, variant: str, prefix=None, sched_text=None, tie_seed=None,
              replay: bool = False) -> dict:
    """Kernel against its plain version over the first `prefix` pods of
    the stream (None: the whole stream), simulate() through the kernel,
    then the kernel timed alone over the whole stream. With `sched_text`
    (a one-profile scheduler config file), all of it under that config,
    and the placements compared with the default config's; with
    `tie_seed`, all of it with the sampled tie-break (no grid: it does not
    sample), each placement among its step's best scores by the plain
    version's record, and a quarter of the prefix's placements at least
    off the lowest index's. With `replay`, REPLAY_STEPS steps spread over
    the whole stream are also re-run through the torch step on the card
    (:func:`_replay_check`). Returns the plan's row of the kernels
    table."""
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
    if replay:
        extra["replay"] = _replay_check(prep, whole, label, valid, forced)
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


def drain_sweep(device) -> tuple:
    """plan_drains() on the capacity plan with N_SCENARIOS drain scenarios
    (one launch of the scenario grid), the grid's rows against
    single-scenario launches and against the plain sweep, the grid timed
    alone. Returns its row of the kernels table, plan_drains()' plans and
    the timed grid (``fi``, ``args``, ``out``) with the plain sweep's
    placements of its scenarios 0-1 over PLAIN_PODS pods (``plain``, and
    ``plain_ms``), which phase 56 holds ``simon defrag``'s grid against."""
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
    plain_ms, head_plain = 0.0, {}
    for rows, pods in ((slice(0, PLAIN_SCENARIOS), PLAIN_PODS), (slice(late[0], late[-1] + 1), LATE_PODS)):
        head = [t[:, :pods].contiguous() for t in grid_r[:2]] + grid_r[2:]
        got = fs.fast_scan_sweep(fi, tmpl_r[:pods].contiguous(), *head)  # all S_r scenarios
        got = fs.FastOutputs(*(t[rows] for t in got))
        plain = [None]

        def run_plain():
            plain[0] = fs.fast_scan_sweep_reference(fi, tmpl_r[:pods].contiguous(), *(t[rows] for t in head))

        ms_rows = _events_ms(run_plain, reps=1)
        plain_ms += ms_rows
        head_plain.setdefault("plain", plain[0])
        head_plain.setdefault("plain_ms", ms_rows)
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
    }, plans, {"fi": fi, "args": (tmpl, *grid), "out": sweep, **head_plain}


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


def _apply_failures(applier, prep, fi_k, tmpl, valid, node_valid, forced, out, pool) -> tuple:
    """The first simulation's failures at full width, on the masked node
    axis of k = 0 (the candidates out): the reasons of the masked one
    scan's counts (`out`) equal the Applier's first simulation's, pod for
    pod, each the expected string; then the hog pods that close the stream
    run from the kernel's usage after the bench pods, by the kernel (equal
    to `out`'s rows over them, on the nine outputs but the state row: the
    hog pods ask for no selector count, so the tail's launch starts its
    counts at 0) and by the plain version on all ten, so the failing pods'
    counts and shortages are the plain version's. The plain version runs
    on the CPU, on copies of the tail launch's inputs, in `pool`'s worker
    process while the card goes on. Returns the largest difference so far
    and a function that waits for the plain version, holds the kernel
    against it and returns the largest difference and its ms."""
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
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t
    plain = pool.submit(_plain_on_cpu_timed, fs.FastInputs(*map(cpu, fi_tail)), [cpu(t) for t in tail])
    got_cpu = fs.FastOutputs(*map(cpu, got_tail))
    failing = int((got_tail.chosen < 0).sum())

    def finish() -> tuple:
        want, secs = plain.result()
        tail_err = _same(got_cpu, want, f"k=0: the hog pods from the kernel's usage after pod {t0} vs plain")
        print(f"k=0: the {APPLY_HOG} hog pods from the kernel's usage after pod {t0}: kernel identical to the whole "
              f"stream's launch on the nine outputs but the state row and to the plain version on all ten "
              f"({failing} found no node, their counts and shortages included; plain {secs * 1e3:.3f} ms on the "
              f"CPU, in a worker process)", flush=True)
        return max(err, tail_err), secs * 1e3

    return err, finish


def apply_plan(device, card: str) -> tuple:
    """`simon apply` on the apply plan through the port's Applier as a
    user runs it (YAML directories, the card): its launches, the new-node
    count, the steps' host-clock times against BASELINE.md's 10 s; then
    the path's masked one scan at k = 0, n_new - 1 and n_new new nodes
    against the rows of the coarse and fine grids for those k (the eight
    state outputs, over the whole stream) and against the plain version
    over a prefix (all ten), each grid timed alone, and at k = 0 the
    first simulation's failures (:func:`_apply_failures`). Returns the
    rows of the masked one scan and the two grids, and a function that
    completes the rows with the hog pods' plain check (its worker process
    runs through phase 30; the function raises if it differs)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs
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
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        rows, finish_tail = _apply_masked(device, applier, n_new, coarse, fine, by_name, scan_shape, wall, steps,
                                          verdict, pool)
    except BaseException:
        pool.shutdown(cancel_futures=True)
        raise

    def finish() -> None:
        try:
            err, tail_plain_ms = finish_tail()
        finally:
            pool.shutdown()
        rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], err)
        rows[0]["plain_tail"] = [APPLY_HOG, tail_plain_ms, "ms on the CPU"]

    return rows, finish


def _apply_masked(device, applier, n_new, coarse, fine, by_name, scan_shape, wall, steps, verdict, pool) -> tuple:
    """Phase 29's checks of :func:`apply_plan` (the grids' rows, the masked
    one scans, the first simulation's failures): the rows and the hog
    pods' pending plain check."""
    from opensim_tpu_torch.engine import fastpath
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.parallel import scenarios

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
            "library_ms": None, "host_s": steps[f"sweep: {label}"],
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
            tail_err, finish_tail = _apply_failures(applier, prep, fi_k, tmpl, grid[0][s], grid[2][s], forced,
                                                    one[k], pool)
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
        "plain_pods": APPLY_PLAIN_PODS, "plain_tail": None, "nodes": int(fi.alloc_T.shape[1]),
        "valid_nodes": N_NODES + n_new,
        "cluster": scan_shape.cluster, "threads": scan_shape.threads, "smem": scan_shape.smem,
        "resident": scan_shape.resident, "ptxas": launched["ptxas"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
        "apply_wall_s": wall, "apply_steps_s": steps, "apply_limit_s": APPLY_LIMIT_S, "apply_limit": verdict,
    })
    return rows, finish_tail


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
    replayed = _replay_check(prep, got, label, stream[1], stream[2], explain=True)
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
                        {"binding_steps_counted": bound_counted, "plan_wall_s": sum(res.timings.values()),
                         "replay": replayed})


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


def _replay_check(prep, out, label: str, valid, forced, explain: bool = False, steps: int = REPLAY_STEPS,
                  lo: int = 0, among=None) -> dict:
    """`steps` steps of the stream from `lo` on, spread evenly over its valid
    pods not forced (and among the stream indices `among`, if given), each re-run through the torch step
    (``kernels.pod_step``, the JAX package's step op for op) on the card
    from the state before it, rebuilt from the kernel's placements
    (``engine/explain.replay_state``): the node it chooses must be the
    kernel's and, in explain mode, its per-filter counts and shortages the
    kernel's row. Returns what was checked."""
    from opensim_tpu_torch.encoding.state import ScanState
    from opensim_tpu_torch.engine import explain as explain_mod
    from opensim_tpu_torch.ops import kernels

    chosen, gpu_take = out.chosen.cpu().numpy(), out.gpu_take.cpu().numpy()
    fail_counts, insufficient = out.fail_counts.cpu().numpy(), out.insufficient.cpu().numpy()
    cand = np.nonzero((valid.cpu().numpy() != 0) & (forced.cpu().numpy() == 0))[0]
    cand = cand[cand >= lo]
    if among is not None:
        cand = np.intersect1d(cand, among)
    idx = cand[np.linspace(0, len(cand) - 1, min(steps, len(cand))).round().astype(int)]
    stat = kernels.static_tables(prep.ec, None)
    t0 = time.perf_counter()
    rejecting = 0
    for i in idx.tolist():
        st = ScanState(*(torch.from_numpy(a).to(prep.device)
                         for a in explain_mod.replay_state(prep, chosen, gpu_take, upto=i)))
        res = kernels.pod_step(prep.ec, stat, st, int(prep.tmpl_ids[i]), prep.features, None, (), count_all=explain)
        if res.chosen != int(chosen[i]):
            raise AssertionError(f"{label}: step {i}: the kernel chose node {int(chosen[i])}, the torch step "
                                 f"{res.chosen}")
        if explain:
            fc, ins = res.fail_counts.cpu().numpy(), res.insufficient.cpu().numpy()
            if not np.array_equal(fc, fail_counts[i]) or not np.array_equal(ins, insufficient[i]):
                raise AssertionError(f"{label}: step {i}: the kernel counted {fail_counts[i].tolist()} / "
                                     f"{insufficient[i].tolist()}, the torch step {fc.tolist()} / {ins.tolist()}")
            rejecting += int(fc.any() or ins.any())
    secs = time.perf_counter() - t0
    span = f"{int(idx[0])}..{int(idx[-1])}"
    print(f"{len(idx)} steps spread over stream indices {span}: the torch step from the replayed state chose the "
          f"kernel's node" + (f" and counted its rows ({rejecting} of them rejecting nodes)" if explain else "")
          + f" ({secs:.3f} s, {secs / len(idx):.4f} s a step)", flush=True)
    return {"steps": len(idx), "first": int(idx[0]), "last": int(idx[-1]), "seconds": secs,
            "rejecting_steps": rejecting if explain else None}


def _http(url: str, path: str, body=None, headers=None):
    """(status, response headers, JSON body, round-trip seconds) of one
    request to the server under test."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method="GET" if body is None else "POST",
                                 headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, hdrs, raw = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        code, hdrs, raw = e.code, dict(e.headers), e.read()
    rt = time.perf_counter() - t0
    try:
        return code, hdrs, json.loads(raw), rt
    except ValueError:
        return code, hdrs, raw.decode(), rt


def _server_row(label: str, entry, explain: bool, launches: int, request_rt: float) -> dict:
    """The kernels-table row of one server request's launch, on the stream
    the server cached for it (its drop mask applied): the kernel timed over
    the whole stream (CUDA events, 3 launches); held against the plain
    version over SERVER_PLAIN_PODS of the request's own pods, the plain
    version starting from the kernel's state before them (a launch over the
    stream up to there) and compared on every output, the final state row
    included, with a launch over the stream up to the window's end; and
    against the torch step over SERVER_REPLAY_STEPS steps of the request's
    pods (:func:`_replay_check`). The window opens at the first request pod
    (``prep.n_cluster``: the snapshot's forced binds precede it) or, in
    explain mode, at the first step where the kernel counted a node
    rejected, and half the replayed steps are then drawn from those steps.
    Its bound from ``fast_scan_work``."""
    from opensim_tpu_torch.engine import fastpath
    from opensim_tpu_torch.ops import fast_scan as fs

    prep = entry.prep
    fi, _ = fastpath.build_inputs(prep)  # the request's own inputs, kept on its cache entry
    stream = fastpath.pod_stream(prep, None if entry.drop_mask is None else ~entry.drop_mask)
    variant = fs.variant_name(fi, explain=explain)
    out = [None]

    def run_kernel():
        out[0] = fs.fast_scan(fi, *stream, explain=explain)

    ms = _events_ms(run_kernel, reps=3)
    P, lo = stream[0].shape[0], prep.n_cluster
    rejecting = None
    win_lo = lo
    if explain:
        rejecting = np.nonzero((out[0].fail_counts.any(1) | out[0].insufficient.any(1)).cpu().numpy())[0]
        rejecting = rejecting[rejecting >= lo]
        if len(rejecting):
            win_lo = max(lo, min(int(rejecting[0]), P - SERVER_PLAIN_PODS))
    hi = min(win_lo + SERVER_PLAIN_PODS, P)
    cut = lambda a, b: tuple(t[a:b].contiguous() for t in stream)
    init = fs.fast_scan(fi, *cut(0, win_lo), explain=explain).state.clone()
    upto = fs.fast_scan(fi, *cut(0, hi), explain=explain)
    if not torch.equal(upto.chosen, out[0].chosen[:hi]):
        raise AssertionError(f"{label}: the launch over pods 0..{hi} placed differently from the whole stream's")
    got = upto._replace(**{f: getattr(upto, f)[win_lo:] for f in ("chosen", "gpu_take", "fail_counts",
                                                                   "insufficient")})
    plain = [None]

    def run_plain():
        plain[0] = fs.fast_scan_reference(fi, *cut(win_lo, hi), init=init, count_all=explain)

    plain_ms = _events_ms(run_plain, reps=1)
    err = _same(got, plain[0], f"{label}: pods {win_lo}..{hi} vs plain from the kernel's state")
    replay = _replay_check(prep, out[0], label, stream[1], stream[2], explain=explain,
                           steps=SERVER_REPLAY_STEPS // 2 if rejecting is not None and len(rejecting)
                           else SERVER_REPLAY_STEPS, lo=lo)
    if rejecting is not None and len(rejecting):
        replay = {"spread": replay, "rejecting": _replay_check(prep, out[0], label, stream[1], stream[2],
                                                               explain=True, steps=SERVER_REPLAY_STEPS // 2,
                                                               lo=lo, among=rejecting)}
    work = fs.fast_scan_work(fi, *stream, out[0].chosen, explain=explain)
    t_bytes, t_ops = work["bytes"] / PEAK_BYTES_S * 1e3, work["ops"] / PEAK_F32_S * 1e3
    N = fi.alloc_T.shape[1]
    n_valid = int(stream[1].sum())
    U = fs._dims(fi).U
    counted = "" if rejecting is None else f"; the kernel counted rejections at {len(rejecting)} of the request's steps"
    print(f"{label} ({variant}): P={P} ({n_valid} valid), N={N}, U={U} templates: kernel {ms:.3f} ms "
          f"({ms * 1e3 / P:.3f} us/pod), plain {plain_ms:.3f} ms over request pods {win_lo}..{hi} from the "
          f"kernel's state, identical on every output{counted}; bound {max(t_bytes, t_ops):.6f} ms", flush=True)
    return {
        "name": variant, "plan": f"server plan {label}", "route": "cuda",
        "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu",
        "replaces": "opensim_tpu/ops/kernels.py:1056" if explain else "opensim_tpu/ops/pallas_scan.py:1009",
        "launches": launches, "launches_are": "the request's own launch in the server run", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "pods": P, "valid_pods": n_valid, "nodes": N, "templates": U,
        "plain_window": [win_lo, hi], "kernel_rejecting_steps": None if rejecting is None else len(rejecting),
        "replay": replay, "request_rt_s": request_rt,
        "ptxas": fs.SCAN_LAUNCHED[variant]["ptxas"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
    }


def server_plan(device, card: str) -> list:
    """``simon server`` of the port on the card (phases 50-53): the
    capacity fleet served by the port's stub apiserver, its snapshot the
    first fixtures.SERVER_BOUND Deployments of the capacity plan bound
    where a card simulate() placed them (25,000 Running pods owned by their
    ReplicaSets); the server started as ``serve()`` starts it
    (``rest.start_server``: the kernel variants built before it listens) on
    loopback, and eight requests sent in order over HTTP, each with the
    launch counts set to 0 just before and read just after: R1 healthz;
    R2 deploy bench-10..19 (cold: snapshot, base prepare, delta; one
    launch at P = 50,000); R3 the same (a full-key hit, no encode,
    verbatim R2's answer); R4 scale bench-0 to 5,000 replicas (a base
    delta whose drop mask flips its 2,500 bound pods: P = 30,000); R5 R2's
    body with SERVER_NEW new nodes (node extension and delta: N = 5,100);
    R6 R2's body with explain=1 (a hit, one [explain] launch) and its
    placements; R7 R2's body under a spent deadline (504, no launch); R8
    /metrics. Then R4 and R5 against the uncached server
    (``prep_cache=False``) on the card, and the kernel rows of R2, R4 and
    R6. Returns the rows and the running server (``server``, ``url`` and
    ``close``, which stops it and its stub apiserver), which the observatory
    and campaign phases go on using."""
    import threading

    from opensim_tpu_torch.engine import simulator as sim
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.obs.metrics import parse_metrics
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.server import rest, stubapi
    from opensim_tpu_torch.utils.gcpause import gc_paused
    from opensim_tpu_torch.utils.trace import PREP_STATS

    n_bound = N_PODS // 20 * fx.SERVER_BOUND
    _phase(f"50 server plan: {n_bound} pods of bench-0..{fx.SERVER_BOUND - 1} bound on {N_NODES} nodes by a card "
           "simulate(), served by the stub apiserver; simon server started (kernels built before it listens)")
    t_phase = time.perf_counter()
    seed = sim.simulate(fx.synthetic_cluster(N_NODES), [sim.AppResource("seed", fx.server_apps(N_PODS, 0,
                                                                                                fx.SERVER_BOUND))],
                        device=device)
    if seed.unscheduled_pods:
        raise AssertionError(f"{len(seed.unscheduled_pods)} snapshot pods found no node")
    pods = [fx.snapshot_pod(p) for ns in seed.node_status for p in ns.pods]
    stub = stubapi.StubApiServer().start()
    fx.seed_stub(stub, fx.synthetic_cluster(N_NODES), pods)
    root = _plan_dir() / "server"
    root.mkdir(parents=True, exist_ok=True)
    kube = stub.kubeconfig(root)
    log = logging.getLogger("opensim_tpu_torch.server")  # start_server's lines: the variants it built
    handler = logging.StreamHandler(sys.stdout)
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    t0 = time.perf_counter()
    try:
        # the polling snapshot (--watch off): phase 65 starts the live twin
        server, httpd = rest.start_server(kubeconfig=kube, port=0, host="127.0.0.1", device=device,
                                          snapshot_ttl_s=SERVER_TTL_S, watch="off")
    finally:
        log.removeHandler(handler)
    start_s = time.perf_counter() - t0
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    print(f"snapshot: {len(pods)} bound pods ({n_bound} expected) on {N_NODES} nodes; server started in "
          f"{start_s:.3f} s (the snapshot listed, its variants built); listening on {url}", flush=True)
    bodies = fx.server_requests(N_NODES, N_PODS, SERVER_NEW)
    answers, launches, traces = {}, {}, {}
    try:
        _phase("51 server plan: R1-R8 over HTTP, the launch counts set to 0 before each request and read after")
        plan = [
            ("R1", "/healthz", None, None),
            ("R2", "/api/deploy-apps", bodies["deploy"], None),
            ("R3", "/api/deploy-apps", bodies["deploy"], None),
            ("R4", "/api/scale-apps", bodies["scale"], None),
            ("R5", "/api/deploy-apps", bodies["newnodes"], None),
            ("R6", "/api/deploy-apps?explain=1", bodies["deploy"], None),
            ("R7", "/api/deploy-apps", bodies["deploy"], {"X-Simon-Timeout-S": "0.000001"}),
            ("R8", "/metrics", None, None),
        ]
        for name, path, body, headers in plan:
            counts0 = dict(PREP_STATS.snapshot()["counts"])
            torch.cuda.synchronize()
            fs.LAUNCHES = 0
            fs.VARIANT_LAUNCHES.clear()
            code, hdrs, answer, rt = _http(url, path, body, headers)
            launches[name] = dict(fs.VARIANT_LAUNCHES)
            counts = {k: v - counts0.get(k, 0) for k, v in PREP_STATS.snapshot()["counts"].items()
                      if v != counts0.get(k, 0)}
            rid = hdrs.get("X-Simon-Request-Id", "")
            attrs = {}
            if body is not None:
                traces[name] = _http(url, f"/api/debug/requests/{rid}")[2]
                attrs = traces[name]["spans"].get("attrs", {})
            times = {k: attrs[k] for k in ("cache_s", "prepare_s", "inputs_s", "kernel_s", "decode_s") if k in attrs}
            print(f"{name} {path}: HTTP {code} in {rt:.6f} s (round trip); rung {attrs.get('rung', '-')}; server "
                  f"times {json.dumps(times)}; prepare kinds {counts}; launches {launches[name]}", flush=True)
            answers[name] = (code, answer, rt, counts, attrs, rid)
        expect = {"R1": (200, {}), "R2": (200, {"fast_scan": 1}), "R3": (200, {"fast_scan": 1}),
                  "R4": (200, {"fast_scan": 1}), "R5": (200, {"fast_scan": 1}),
                  "R6": (200, {"fast_scan[explain]": 1}), "R7": (504, {}), "R8": (200, {})}
        for name, (code, want) in expect.items():
            if answers[name][0] != code or launches[name] != want:
                raise AssertionError(f"{name}: HTTP {answers[name][0]} with launches {launches[name]}, want {code} "
                                     f"and {want}: {str(answers[name][1])[:500]}")
        rungs = {n: answers[n][4].get("rung") for n in ("R2", "R3", "R4", "R5", "R6")}
        if rungs != {"R2": "cold", "R3": "hit", "R4": "delta", "R5": "delta", "R6": "hit"}:
            raise AssertionError(f"cache rungs {rungs}")
        if answers["R2"][3] != {"full": 1, "delta_apps": 1} or answers["R3"][3] != {"hit": 1} or \
                answers["R5"][3] != {"delta_nodes": 1, "delta_apps": 1} or answers["R6"][3] != {"hit": 1}:
            raise AssertionError("prepare kinds " + json.dumps({n: answers[n][3] for n in ("R2", "R3", "R5", "R6")}))
        if answers["R3"][1] != answers["R2"][1]:
            raise AssertionError("R3 (a full-key hit) answered differently from R2")
        r6, r2 = answers["R6"][1], answers["R2"][1]
        unplaced = lambda answer: [(u["pod"], u["reason"]) for u in answer["unscheduledPods"]]
        if r6["nodeStatus"] != r2["nodeStatus"] or unplaced(r6) != unplaced(r2) or "filterRejects" not in r6:
            raise AssertionError("R6 (explain=1) placed differently from R2 or has no filter rejects")
        code, _h, placements, _rt = _http(url, f"/api/debug/placements/{answers['R6'][5]}")
        if code != 200 or placements["pods_total"] != N_PODS:
            raise AssertionError(f"R6's placements: HTTP {code}, {placements.get('pods_total')} pods audited")
        if answers["R7"][1].get("phase") not in ("snapshot", "prepare", "encode", "schedule", "decode"):
            raise AssertionError(f"R7: {answers['R7'][1]}")
        metrics = parse_metrics(answers["R8"][1])
        seconds = lambda ep, status: metrics.get(("simon_request_seconds_count", (("endpoint", ep),
                                                                                  ("status", status))), 0)
        got = {"hits": metrics[("simon_prep_cache_hits_total", ())],
               "deploy ok": seconds("deploy-apps", "ok"), "scale ok": seconds("scale-apps", "ok"),
               "504": seconds("deploy-apps", "deadline-exceeded"),
               "timeouts": metrics[("simon_request_timeouts_total", ())]}
        if got["hits"] < 2 or got["deploy ok"] + got["scale ok"] != 5 or got["504"] != 1 or got["timeouts"] != 1:
            raise AssertionError(f"/metrics: {got}")
        print(f"R8 /metrics: {json.dumps(got)}; R6 audited {placements['pods_total']} pods "
              f"({len(placements['explanations'])} stored); R4 answered {sum(len(e['pods']) for e in answers['R4'][1]['nodeStatus'])} "
              f"placed pods; R5 placed on {sum(e['node'].startswith('simon-') for e in answers['R5'][1]['nodeStatus'])} "
              f"new nodes", flush=True)
        shape = fs.SCAN_LAUNCHED["fast_scan"]["shape"]  # R5's launch, the last of the base variant
        if shape.nc != -(-(N_NODES + SERVER_NEW) // shape.cluster):
            raise AssertionError(f"R5's launch: {shape.nc} nodes a CTA")
    except BaseException:
        httpd.shutdown()
        httpd.server_close()
        stub.stop()
        raise

    _phase("52 server plan: R4 and R5 against the uncached server (a full prepare each) on the card")
    entries = {e.key.split("|")[1]: e for e in server.prep_cache.entries_snapshot() if not e.key.endswith("|base")}
    scale_entry, deploy_entry = entries["scale"], entries["deploy"]
    if len(scale_entry.prep.ordered) != n_bound + 2 * N_PODS // 20 or \
            int(scale_entry.drop_mask.sum()) != N_PODS // 20:
        raise AssertionError(f"R4's stream: {len(scale_entry.prep.ordered)} pods, "
                             f"{int(scale_entry.drop_mask.sum())} dropped")
    if len(deploy_entry.prep.ordered) != N_PODS:
        raise AssertionError(f"R2's stream: {len(deploy_entry.prep.ordered)} pods")
    legacy = rest.SimonServer(kubeconfig=kube, prep_cache=False, device=device)
    # R2's body is held against the uncached server by the live twin's
    # phase 65 (three times); R4 is the drop mask's, R5 the request-time node
    # extension's (extend_with_nodes at N = 5,100)
    for name, call, body in (("R4", legacy.scale_apps, bodies["scale"]),
                             ("R5", legacy.deploy_apps, bodies["newnodes"])):
        t0 = time.perf_counter()
        # the collector paused: the uncached server's copy of the snapshot
        # and its prepare are the check's, not a request's to time
        with gc_paused():
            code, want = call(json.loads(json.dumps(body)))
        secs = time.perf_counter() - t0
        same = _without_counters(json.dumps(want, sort_keys=True)) == \
            _without_counters(json.dumps(answers[name][1], sort_keys=True))
        if code != 200 or not same:
            raise AssertionError(f"{name}: the uncached server answered {code} differently")
        print(f"{name}: the cached answer equals the uncached server's ({secs:.3f} s there), "
              f"{len(want['unscheduledPods'])} unscheduled", flush=True)

    _phase("53 server plan: the kernel rows of R2, R4 and R6 (CUDA events), each against the plain version and "
           "the torch step")
    rows = [_server_row("R2", deploy_entry, False, launches["R2"]["fast_scan"], answers["R2"][2]),
            _server_row("R4", scale_entry, False, launches["R4"]["fast_scan"], answers["R4"][2]),
            _server_row("R6", deploy_entry, True, launches["R6"]["fast_scan[explain]"], answers["R6"][2])]
    print(f"server plan phases {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)

    served = {"server": server, "url": url, "stub": stub, "kube": kube, "pods": pods, "bodies": bodies}
    listening = [httpd]

    def retire() -> None:
        """Stop the server and its listener and drop both (the stub
        apiserver goes on)."""
        if listening:
            listening[0].shutdown()
            listening.pop().server_close()
            served.pop("server").close()

    def close() -> None:
        retire()
        stub.stop()

    served.update(retire=retire, close=close)
    return rows, served


def steady_phase(device) -> dict:
    """``prepcache.simulate_cached`` on the capacity plan (phase 54), as
    bench.py:811-860 runs it: one cold call (the full prepare), then
    STEADY_WARM warm calls, each a cache hit launching one kernel and
    placing the stream as the cold call did. Returns its numbers."""
    import statistics

    from opensim_tpu_torch.engine import prepcache, simulator as sim
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.utils.trace import PREP_STATS

    _phase(f"54 steady phase: simulate_cached() on the capacity plan, one cold call and {STEADY_WARM} warm")
    cluster, apps = fx.synthetic_cluster(N_NODES), [sim.AppResource("plan", fx.synthetic_apps(N_PODS))]
    cache = prepcache.PrepareCache()
    t0 = time.perf_counter()
    cold = prepcache.simulate_cached(cluster, apps, cache, device=device)
    cold_s = time.perf_counter() - t0
    kind, cold_prep = PREP_STATS.snapshot()["last"]
    if kind != "full":
        raise AssertionError(f"the cold call prepared by {kind}")
    walls, preps = [], []
    for k in range(STEADY_WARM):
        torch.cuda.synchronize()
        fs.LAUNCHES = 0
        fs.VARIANT_LAUNCHES.clear()
        t0 = time.perf_counter()
        res = prepcache.simulate_cached(cluster, apps, cache, device=device)
        walls.append(time.perf_counter() - t0)
        kind, secs = PREP_STATS.snapshot()["last"]
        preps.append(secs)
        if kind != "hit" or dict(fs.VARIANT_LAUNCHES) != {"fast_scan": 1}:
            raise AssertionError(f"warm call {k}: prepared by {kind}, launched {dict(fs.VARIANT_LAUNCHES)}")
        if not np.array_equal(res.placements, cold.placements) or \
                [u.reason for u in res.unscheduled_pods] != [u.reason for u in cold.unscheduled_pods]:
            raise AssertionError(f"warm call {k} placed the stream differently from the cold call")
    out = {"cold_s": cold_s, "cold_prepare_s": cold_prep, "warm_prepare_median_s": statistics.median(preps),
           "warm_wall_median_s": statistics.median(walls), "warm_wall_s": walls, "cache": cache.stats.as_dict()}
    print(f"cold call {cold_s:.6f} s (prepare {cold_prep:.6f} s); {STEADY_WARM} warm calls, each a hit with one "
          f"launch and the cold call's placements: median prepare {out['warm_prepare_median_s']:.6f} s, median "
          f"wall-clock {out['warm_wall_median_s']:.6f} s; cache {json.dumps(out['cache'])}", flush=True)
    return out


def kubeconfig_apply(device) -> None:
    """``simon apply`` in kubeConfig mode (phase 55): example/simon-config.yaml
    with its cluster (example/cluster/demo, its Deployment's pods bound
    where a CPU simulation placed them) served by the stub apiserver, on
    the CPU and on the card: the two reports equal."""
    import yaml

    from opensim_tpu_torch.engine import simulator as sim
    from opensim_tpu_torch.models import expand, fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.planner import apply
    from opensim_tpu_torch.server import stubapi

    _phase("55 simon apply in kubeConfig mode: example/simon-config.yaml's cluster listed from the stub apiserver, "
           "card report vs CPU report")
    cluster = expand.load_cluster_from_dir(_example("cluster/demo"))
    placed = sim.simulate(cluster, [], device="cpu")
    pods = [fx.snapshot_pod(p) for ns in placed.node_status for p in ns.pods]
    stub = stubapi.StubApiServer().start()
    fx.seed_stub(stub, cluster, pods)
    root = _plan_dir() / "kubeconfig-apply"
    root.mkdir(parents=True, exist_ok=True)
    try:
        spec = yaml.safe_load(Path(_example("simon-config.yaml")).read_text())
        spec["spec"]["cluster"] = {"kubeConfig": stub.kubeconfig(root)}
        for app in spec["spec"]["appList"]:
            app["path"] = _example(app["path"])
        spec["spec"]["newNode"] = _example(spec["spec"]["newNode"])
        config = root / "config.yaml"
        config.write_text(yaml.safe_dump(spec))
        runs = []
        for where, dev in (("cpu", "cpu"), ("card", str(device))):
            out = root / f"report.{where}.txt"
            fs.VARIANT_LAUNCHES.clear()
            t0 = time.perf_counter()
            rc = apply.Applier(apply.Options(simon_config=str(config), output_file=str(out), device=dev)).run()
            runs.append((rc, out.read_text(), dict(fs.VARIANT_LAUNCHES), time.perf_counter() - t0))
    finally:
        stub.stop()
    (rc_cpu, cpu, _l, cpu_s), (rc_card, card_text, launches, card_s) = runs
    if rc_cpu != 0 or rc_card != 0 or _without_counters(cpu) != _without_counters(card_text):
        raise AssertionError(f"kubeConfig apply: the card's report (rc {rc_card}) differs from the CPU's (rc {rc_cpu})")
    if not launches or "Simulation success!" not in card_text:
        raise AssertionError(f"kubeConfig apply launched {launches}:\n{card_text[-1500:]}")
    print(f"{len(pods)} snapshot pods listed; card and CPU reports identical ({len(card_text.splitlines())} lines; "
          f"card {card_s:.3f} s, CPU {cpu_s:.3f} s); launches {launches}", flush=True)


@contextlib.contextmanager
def _patched(obj, name: str, wrap):
    """`obj.name` replaced by ``wrap(original)`` for the block."""
    real = getattr(obj, name)
    setattr(obj, name, wrap(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


@contextlib.contextmanager
def _host_watch(server=None):
    """What a server request's host time went to, for the block: the
    interpreter's full collections (count and seconds, through
    ``gc.callbacks``), each prepare kind's count and seconds
    (``PREP_STATS``) and `server`'s stale-entry retries, as deltas in the
    dict it yields."""
    import gc

    from opensim_tpu_torch.utils.trace import PREP_STATS

    got = {"gc_full": 0, "gc_full_s": 0.0}
    started = {}

    def watch(phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            got["gc_full"] += 1
            got["gc_full_s"] += time.perf_counter() - started.pop("t")

    retries = lambda: 0 if server is None else server.metrics.stale_prep_retries
    prep0, retries0 = PREP_STATS.snapshot(), retries()
    gc.callbacks.append(watch)
    try:
        yield got
    finally:
        gc.callbacks.remove(watch)
        prep1 = PREP_STATS.snapshot()
        got["prep"] = {k: [n - prep0["counts"].get(k, 0), round(prep1["seconds"][k] - prep0["seconds"].get(k, 0.0), 6)]
                       for k, n in prep1["counts"].items() if n != prep0["counts"].get(k, 0)}
        got["stale_retries"] = retries() - retries0
        got["gc_full_s"] = round(got["gc_full_s"], 6)


def _reset_launches() -> None:
    from opensim_tpu_torch.ops import fast_scan as fs

    torch.cuda.synchronize()
    fs.LAUNCHES = 0
    fs.VARIANT_LAUNCHES.clear()


def _timed_launch(rec: dict):
    """A wrapper of a kernel entry point that keeps its last call's inputs
    (``args``), outputs (``out``) and CUDA-event time (``ms``) in `rec`."""
    def wrap(real):
        def run(fi, *args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(fi, *args, **kw)
            end.record()
            torch.cuda.synchronize()
            rec.update(fi=fi, args=args, out=out, ms=start.elapsed_time(end))
            return out
        return run
    return wrap


def _sweep_row(name: str, plan: str, fi, args, out, ms: float, launches: int, err: float, plain_ms: float,
               plain: str, **extra) -> dict:
    """A kernels-table row of one grid launch (its inputs `args`, its
    outputs `out`, its CUDA-event time `ms` in the main path's run), its
    bound from ``fast_scan_work``."""
    from opensim_tpu_torch.ops import fast_scan as fs

    tmpl, valid, forced, node_valid, _sw = args
    work = fs.fast_scan_work(fi, tmpl, valid, forced, out.chosen, node_valid)
    t_bytes, t_ops = work["bytes"] / PEAK_BYTES_S * 1e3, work["ops"] / PEAK_F32_S * 1e3
    grid = fs.sweep_grid(valid.shape[0], fi.alloc_T.shape[1], torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"{plan}: {fs.sweep_name(fi)} at S={valid.shape[0]}, P={tmpl.shape[0]}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms ({plain}), bound {max(t_bytes, t_ops):.6f} ms", flush=True)
    return {"name": name, "plan": plan, "route": "cuda", "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu",
            "replaces": "opensim_tpu/engine/fastpath.py:532", "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "plain_checks": plain, "scenarios": int(valid.shape[0]), "pods": int(tmpl.shape[0]),
            "b": grid.b, "blocks": grid.blocks, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None, "library": "none", **extra}


def defrag_cli(device, card: str, drain_plans, drain_grid: dict) -> dict:
    """``simon defrag`` of the port (phase 56): the capacity plan written
    as YAML (``fixtures.write_apply_plan`` without its hog app) and run as
    a user runs it, ``--json --candidates`` over phase 22's N_SCENARIOS
    nodes, on the card: one grid launch, its rows ``drain_plan_rows`` of
    phase 22's plans; its steps (load, prepare, sweep) timed. Its grid's
    inputs are phase 23's timed grid's, tensor for tensor, so it is held
    against that grid on every output and its placements in scenarios 0-1
    over PLAIN_PODS pods against phase 24's plain sweep of the same inputs
    (no second plain run). Then the three example configs' ``--json``
    reports, card against CPU, one grid launch each. Returns the grid's
    row of the kernels table."""
    from opensim_tpu_torch.cli import main as cli
    from opensim_tpu_torch.engine import fastpath
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.planner import apply, defrag, report

    _phase(f"56 simon defrag: the capacity plan as YAML, --json --candidates over phase 22's {N_SCENARIOS} nodes, "
           "then the example configs card vs CPU")
    root = _plan_dir() / "defrag"
    config = fx.write_apply_plan(root, N_NODES, N_PODS, 0)
    candidates = [f"node-{i:05d}" for i in range(N_SCENARIOS)]
    steps, seen = {}, {}

    def timed(name):
        def wrap(real):
            def run(*a, **kw):
                t0 = time.perf_counter()
                out = real(*a, **kw)
                steps[name] = steps.get(name, 0.0) + time.perf_counter() - t0
                return out
            return run
        return wrap

    def keep(real):
        def run(*a, **kw):
            seen["result"] = out = real(*a, **kw)
            return out
        return run

    launch = {}
    out_file = root / "plan.json"
    _reset_launches()
    t0 = time.perf_counter()
    with _patched(apply.Applier, "load_cluster", timed("load")), _patched(apply.Applier, "load_apps", timed("load")), \
            _patched(defrag, "plan_drains", keep), _patched(fastpath, "fast_scan_sweep", _timed_launch(launch)):
        rc = cli.main(["defrag", "-f", config, "--json", "--candidates", ",".join(candidates), "-o", str(out_file)])
    wall = time.perf_counter() - t0
    launches = dict(fs.VARIANT_LAUNCHES)
    if rc != 0 or launches != {"fast_scan_sweep": 1}:
        raise AssertionError(f"simon defrag: rc {rc}, launches {launches}")
    body = json.loads(out_file.read_text())
    want = report.drain_plan_rows(drain_plans)
    if [body["table"]["header"]] + body["table"]["rows"] != want or body["total"] != N_SCENARIOS:
        raise AssertionError("simon defrag's rows differ from drain_plan_rows of phase 22's plans")
    timings = seen["result"].timings
    steps.update(prepare=timings.get("prepare", 0.0), sweep=timings.get("sweep", 0.0))
    print(f"simon defrag: {body['drainable']}/{body['total']} drainable, rows equal phase 22's; launches {launches}; "
          f"wall-clock {wall:.3f} s, steps " + json.dumps({k: round(v, 6) for k, v in steps.items()}), flush=True)
    fi, args = launch["fi"], launch["args"]
    ref_fi = drain_grid["fi"]
    differ = [name for name in fs.FastInputs._fields
              if not (torch.equal(getattr(fi, name), getattr(ref_fi, name))
                      if isinstance(getattr(fi, name), torch.Tensor) else getattr(fi, name) == getattr(ref_fi, name))]
    differ += [f"argument {i}" for i, (a, b) in enumerate(zip(args, drain_grid["args"])) if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"simon defrag's grid inputs differ from phase 23's: {differ}")
    err = _same(launch["out"], drain_grid["out"], "simon defrag's grid vs phase 23's grid on the same inputs")
    plain = drain_grid["plain"]
    head = fs.FastOutputs(*(t[:PLAIN_SCENARIOS, :PLAIN_PODS] if f in ("chosen", "gpu_take") else t
                            for f, t in zip(fs.FastOutputs._fields, launch["out"])))
    err = max(err, _same(head, plain, f"simon defrag's grid, scenarios 0-{PLAIN_SCENARIOS - 1} x {PLAIN_PODS} pods, "
                                      "vs phase 24's plain sweep", ("chosen", "gpu_take")))
    plain_ms = drain_grid["plain_ms"]
    for config_name, extended, variant in EXAMPLES:
        outs = {}
        for where, dev in (("cpu", "cpu"), ("card", str(device))):
            path = root / f"{config_name}.{where}.json"
            _reset_launches()
            rc = cli.main(["defrag", "-f", _example(config_name), "--json", "-o", str(path), "--device", dev])
            outs[where] = (rc, path.read_text(), dict(fs.VARIANT_LAUNCHES))
        want_l = {"fast_scan_sweep" + variant[len("fast_scan"):]: 1}
        if outs["cpu"][:2] != outs["card"][:2] or outs["card"][0] != 0 or outs["card"][2] != want_l:
            raise AssertionError(f"simon defrag -f {config_name}: card {outs['card']} vs CPU {outs['cpu'][:2]}")
        print(f"simon defrag -f {config_name} --json: card equals CPU ({json.loads(outs['card'][1])['drainable']} "
              f"drainable), launches {outs['card'][2]}", flush=True)
    return _sweep_row("fast_scan_sweep", f"simon defrag, capacity plan, {N_SCENARIOS:,} candidates", fi, args,
                      launch["out"], launch["ms"], launches["fast_scan_sweep"], err, plain_ms,
                      f"every output phase 23's grid on the same inputs; placements of scenarios "
                      f"0-{PLAIN_SCENARIOS - 1} x {PLAIN_PODS} pods phase 24's plain sweep", defrag_s=wall,
                      defrag_steps=steps, card=card)


def observatory(device, card: str, served) -> list:
    """The capacity observatory on the server plan's running server (phases
    57-58): ``GET /api/cluster/report`` with the default headroom profiles
    and the fixture profile whose headroom is the number of nodes that tie
    for the most free resources (``fixtures.headroom_profile``: 2,500 on
    this fleet, so its bisection between the ladder's 2,048 and 4,096 takes
    11 steps), the launch counts read around it (one grid launch per probe
    scan: each profile's ladder, then its bisection at S = 1); card
    ``simulate()`` placing k replicas of that profile and not k + 1; the
    ladder's rows of the largest feasible and the smallest infeasible k,
    and the bisection launch of the smallest k, against the plain version
    over their probe pods, started from the grid's state after the
    snapshot's forced binds;
    the timeline's newest sample, ``simon top --json`` and ``/metrics``
    against the report. Returns the ladder's and one bisection launch's
    rows of the kernels table."""
    import io

    from opensim_tpu_torch.cli import main as cli
    from opensim_tpu_torch.engine import fastpath, prepcache, simulator as sim
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.models.objects import LABEL_APP_NAME, ResourceTypes
    from opensim_tpu_torch.obs import capacity as cap
    from opensim_tpu_torch.obs.metrics import parse_metrics
    from opensim_tpu_torch.ops import fast_scan as fs

    server, url = served["server"], served["url"]
    cluster, key = server._observed_cluster()
    spec = fx.headroom_profile(cluster)
    os.environ["OPENSIM_HEADROOM_PROFILES"] = f"{cap.DEFAULT_PROFILES},{spec}"
    profiles = cap.headroom_profiles()
    wide = profiles[-1]
    _phase(f"57 capacity observatory: GET /api/cluster/report on the server plan's fleet, headroom of "
           f"{[p.name for p in profiles]} ({spec})")
    scans = []

    def probe_scan(real):
        def run(prep, app_slice, drop, ks):
            lo = app_slice[0]
            scans.append({"profile": prep.ordered[lo].metadata.labels.get(LABEL_APP_NAME, ""), "lo": lo,
                          "ks": list(ks)})
            out = real(prep, app_slice, drop, ks)
            scans[-1]["ok"] = out
            return out
        return run

    def grid(real):
        def run(fi, *args, **kw):
            return _timed_launch(scans[-1])(real)(fi, *args, **kw)
        return run

    _reset_launches()
    with _patched(cap, "_probe_scan", probe_scan), _patched(fastpath, "fast_scan_sweep", grid):
        code, _h, report, rt = _http(url, "/api/cluster/report")
    launches = dict(fs.VARIANT_LAUNCHES)
    if code != 200:
        raise AssertionError(f"/api/cluster/report: HTTP {code}: {str(report)[:500]}")
    headroom = report["capacity"]["headroom"]
    if set(headroom) != {p.name for p in profiles} or launches != {"fast_scan_sweep": len(scans)}:
        raise AssertionError(f"headroom {headroom}, launches {launches} for {len(scans)} probe scans")
    per_profile = {}
    for sc in scans:
        per_profile.setdefault(sc["profile"], []).append(len(sc["ks"]))
    k = headroom[wide.name]
    if not 0 < k < wide.max_replicas:
        raise AssertionError(f"the fixture profile's headroom {k} is not inside (0, {wide.max_replicas})")
    print(f"report: HTTP 200 in {rt:.3f} s; {report['capacity']['nodes']} nodes, {report['capacity']['pods_bound']} "
          f"pods bound; headroom {headroom}; launches {launches}, scenarios per probe scan by profile "
          f"{json.dumps(per_profile)}", flush=True)

    _phase(f"58 capacity observatory: card simulate() at k = {k} and k + 1 of {wide.name}; the ladder's rows vs "
           "plain; timeline, simon top --json, /metrics")
    base = server.prep_cache.get(f"{key}|base")

    def unplaced(n: int) -> int:
        rt_ = ResourceTypes()
        rt_.add(fx.make_fake_deployment(f"simon-headroom-{wide.name}", n, wide.cpu, wide.memory))
        apps = [sim.AppResource(f"simon-headroom-{wide.name}", rt_)]
        with base.lock:
            base.restore()
            try:
                derived = prepcache.derive_with_apps(base.prep, cluster, apps, base_entry=base)
                _reset_launches()
                res = sim.simulate(cluster, apps, prep=derived, device=device)
                if dict(fs.VARIANT_LAUNCHES) != {"fast_scan": 1}:
                    raise AssertionError(f"simulate() launched {dict(fs.VARIANT_LAUNCHES)}")
            finally:
                base.restore()
        return len(res.unscheduled_pods)

    t0 = time.perf_counter()
    fit_k, fit_k1 = unplaced(k), unplaced(k + 1)
    if fit_k != 0 or fit_k1 != 1:
        raise AssertionError(f"simulate(): {fit_k} of {k} and {fit_k1} of {k + 1} replicas unplaced")
    print(f"card simulate(): {k} replicas all placed, {k + 1} leave one unplaced ({time.perf_counter() - t0:.3f} s)",
          flush=True)
    mine = [sc for sc in scans if sc["profile"] == f"simon-headroom-{wide.name}"]
    ladder = next(sc for sc in mine if len(sc["ks"]) > 1 and not all(sc["ok"]))
    fi, args, out = ladder["fi"], ladder["args"], ladder["out"]
    tmpl, valid, forced, node_valid, spr_weight = args
    lo, ks, ok = ladder["lo"], ladder["ks"], ladder["ok"]
    s_f = max((s for s in range(len(ks)) if ok[s]), default=None)
    s_i = min(s for s in range(len(ks)) if not ok[s])
    pre = fs.fast_scan_sweep(fi, tmpl[:lo].contiguous(), valid[:, :lo].contiguous(), forced[:, :lo].contiguous(),
                             node_valid, spr_weight)
    # a scenario's first probe pods are another's with fewer (the probe pods
    # sit at the stream's tail): where two runs agree on everything up to
    # there, the plain version runs the longer one's rest from the shorter
    # one's final state, and its outputs are the two runs joined
    row = lambda t, s: t[s:s + 1].contiguous()
    per_pod = ("chosen", "gpu_take", "fail_counts", "insufficient")
    joined = lambda head, tail: fs.FastOutputs(*(torch.cat([h, t], 1) if f in per_pod else t
                                                 for f, h, t in zip(fs.FastOutputs._fields, head, tail)))
    same_inputs = lambda a, b: a is b or all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                                             for x, y in zip(a, b))
    err, plain_ms, plain_pods = 0.0, 0.0, 0
    held = []  # (k, its plain outputs over the probe pods)
    for s in [x for x in (s_f, s_i) if x is not None]:
        hi = lo + ks[s]
        head = held[-1] if held and all(
            torch.equal(t[s_f, :lo + held[-1][0]], t[s, :lo + held[-1][0]]) for t in (valid, forced)) and all(
            torch.equal(t[s_f], t[s]) for t in (node_valid, spr_weight, pre.state)) else None
        a = lo if head is None else lo + head[0]
        plain = [None]

        def run_plain():
            plain[0] = fs.fast_scan_sweep_reference(fi, tmpl[a:hi].contiguous(), row(valid[:, a:hi], s),
                                                    row(forced[:, a:hi], s), row(node_valid, s), row(spr_weight, s),
                                                    init=row(pre.state, s) if head is None else head[1].state)

        plain_ms += _events_ms(run_plain, reps=1)
        plain_pods += hi - a
        want = plain[0] if head is None else joined(head[1], plain[0])
        held.append((ks[s], want))
        got = fs.FastOutputs(*(t[s:s + 1, lo:hi] if f in ("chosen", "gpu_take") else t[s:s + 1]
                               for f, t in zip(fs.FastOutputs._fields, out)))
        err = max(err, _same(got, want, f"ladder scenario k={ks[s]}, probe pods {lo}..{hi}", fs.STATE_FIELDS))
    print(f"ladder {ks}: scenarios k={[ks[s] for s in (s_f, s_i) if s is not None]} identical to the plain version "
          f"over their probe pods from the grid's state after the {lo} forced binds ({plain_pods} probe pods run "
          f"plain)", flush=True)
    bisect = min((sc for sc in mine if len(sc["ks"]) == 1), key=lambda sc: sc["ks"][0])
    b_args = bisect["args"]
    b_plain = [None]
    b_hi = lo + bisect["ks"][0]
    b_pre = fs.fast_scan_sweep(bisect["fi"], b_args[0][:lo].contiguous(), *(t[:, :lo].contiguous() for t in b_args[1:3]),
                               *b_args[3:])
    k_f = held[0][0] if s_f is not None else 0
    b_head = held[0] if s_f is not None and k_f < bisect["ks"][0] and same_inputs(bisect["fi"], fi) and \
        torch.equal(b_args[0][:lo + k_f], tmpl[:lo + k_f]) and \
        all(torch.equal(b[0, :lo + k_f], t[s_f, :lo + k_f]) for b, t in zip(b_args[1:3], (valid, forced))) and \
        all(torch.equal(b[0], t[s_f]) for b, t in zip((*b_args[3:], b_pre.state), (node_valid, spr_weight, pre.state))) \
        else None
    b_a = lo if b_head is None else lo + k_f

    def run_b_plain():
        b_plain[0] = fs.fast_scan_sweep_reference(bisect["fi"], b_args[0][b_a:b_hi].contiguous(),
                                                  *(t[:, b_a:b_hi].contiguous() for t in b_args[1:3]), *b_args[3:],
                                                  init=b_pre.state if b_head is None else b_head[1].state)

    b_plain_ms = _events_ms(run_b_plain, reps=1)
    b_want = b_plain[0] if b_head is None else joined(b_head[1], b_plain[0])
    b_got = fs.FastOutputs(*(t[:, lo:b_hi] if f in ("chosen", "gpu_take") else t
                             for f, t in zip(fs.FastOutputs._fields, bisect["out"])))
    b_err = _same(b_got, b_want, f"bisection k={bisect['ks'][0]}", fs.STATE_FIELDS)
    b_checks = f"k={bisect['ks'][0]}, {b_hi - lo} probe pods" + (
        "" if b_head is None else f" (the first {k_f} the ladder's plain run of k={k_f}, the last {b_hi - b_a} "
                                  "from its final state)")

    code, _h, timeline, _rt = _http(url, "/api/debug/capacity")
    if code != 200 or timeline["samples"][-1]["generation"] != report["capacity"]["generation"]:
        raise AssertionError(f"/api/debug/capacity: HTTP {code}, newest sample "
                             f"{timeline['samples'][-1] if timeline.get('samples') else None}")
    buf = io.StringIO()
    _reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["top", "--url", url, "--json"])
    if rc != 0 or json.loads(buf.getvalue()) != report or fs.VARIANT_LAUNCHES:
        raise AssertionError(f"simon top --json: rc {rc}, launches {dict(fs.VARIANT_LAUNCHES)}, equal to the report: "
                             f"{rc == 0 and json.loads(buf.getvalue()) == report}")
    metrics = parse_metrics(_http(url, "/metrics")[2])
    got_h = {p.name: metrics.get(("simon_cluster_headroom", (("profile", p.name),))) for p in profiles}
    if got_h != {n: float(v) for n, v in headroom.items()}:
        raise AssertionError(f"/metrics headroom {got_h}, report {headroom}")
    print(f"timeline: {len(timeline['samples'])} samples, the newest of generation "
          f"{timeline['samples'][-1]['generation']}; simon top --json equals the report (no launch); /metrics "
          f"simon_cluster_headroom {got_h}", flush=True)
    rows = [_sweep_row("fast_scan_sweep", f"headroom ladder ({wide.name}, {len(ks)} scenarios)", fi, args, out,
                       ladder["ms"], 1, err, plain_ms,
                       f"scenarios k={[k_ for k_, _w in held]}, {sum(k_ for k_, _w in held)} probe pods, "
                       f"{plain_pods} of them run plain (a longer scenario's from a shorter one's final state)",
                       headroom=headroom, probe_scans=per_profile, report_s=rt, card=card),
            _sweep_row("fast_scan_sweep", f"headroom bisection step ({wide.name}, k={bisect['ks'][0]})", bisect["fi"],
                       b_args, bisect["out"], bisect["ms"], sum(1 for sc in scans if len(sc["ks"]) == 1), b_err,
                       b_plain_ms,
                       b_checks, launches_are="every bisection step's launch")]
    del os.environ["OPENSIM_HEADROOM_PROFILES"]
    return rows


def _hold_campaign_launch(rec: dict) -> tuple:
    """One campaign launch against the plain version: the launch's valid
    pods (the baseline's first CAMPAIGN_PLAIN_PODS) as a compact stream from
    the launch's initial state, the kernel on it placing them as the launch
    did and equal to the plain version on every output. A launch with more
    valid pods than that (the baseline's 50,000) is also held whole against
    a grid launch at S = 1 over the same stream from the same state, on the
    eight state outputs. Returns (largest difference, plain ms, pods
    checked, grid ms or None)."""
    from opensim_tpu_torch.ops import fast_scan as fs

    fi, stream, init, out = rec["fi"], rec["stream"], rec["init"], rec["out"]
    idx = torch.nonzero(stream[1]).flatten()
    whole = len(idx) <= CAMPAIGN_PLAIN_PODS
    grid_ms = None
    if not whole:
        grid = [None]

        def run_grid():
            grid[0] = fs.fast_scan_sweep(fi, stream[0], stream[1][None].contiguous(), stream[2][None].contiguous(),
                                         fi.node_valid[None], fi.spr_weight[None], init=init[None])

        grid_ms = _events_ms(run_grid, reps=1)
        _same(out, fs.FastOutputs(*(t[0] for t in grid[0])),
              f"{rec['where']}: the launch vs the grid at S=1 over its {len(idx)} valid pods", fs.STATE_FIELDS)
    idx = idx[:CAMPAIGN_PLAIN_PODS]
    sub = tuple(t[idx].contiguous() for t in stream)
    got = fs.fast_scan(fi, *sub, init=init)
    per_pod = ("chosen", "gpu_take", "fail_counts", "insufficient")
    launch = fs.FastOutputs(*(getattr(out, f)[idx] if f in per_pod else getattr(out, f) for f in fs.FastOutputs._fields))
    _same(got, launch, f"{rec['where']}: the launch's {len(idx)} valid pods as a compact stream",
          fields=fs.FastOutputs._fields if whole else per_pod)
    plain = [None]

    def run_plain():
        plain[0] = fs.fast_scan_reference(fi, *sub, init=init)

    plain_ms = _events_ms(run_plain, reps=1)
    return _same(got, plain[0], f"{rec['where']}: kernel vs plain over {len(idx)} pods"), plain_ms, len(idx), grid_ms


def campaign_plan(device, card: str, served) -> list:
    """Lifecycle campaigns on the card (phases 59-61): the campaign plan
    (``fixtures.write_campaign_plan``: the capacity fleet and Deployments
    under PDBs of minAvailable 90%, a 1,000-replica canary, a rolling drain
    of 10 nodes 5 at a time, a storm reclaiming 50, 20 nodes added, bench-0
    up by 500, 32 scale-down checks, a defrag over 64 candidates) written as
    a ``customConfig`` directory and run in warm mode, each step's
    wall-clock, launches and kernel share recorded, every scheduling pass
    exactly one one-scan launch (``fast_scan[cfg]``, from the carried
    state), each held against the plain version over its valid pods; cold
    mode over the baseline and the first COLD_STEPS steps, its fingerprints
    warm mode's; example/campaign.yaml card against CPU; ``POST
    /api/campaign`` on the server plan's server against an in-process
    ``run_campaign`` on its snapshot. Returns the campaign launches' row of
    the kernels table."""
    import statistics

    from opensim_tpu_torch.engine import fastpath
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.planner import campaign as cp
    from opensim_tpu_torch.utils.gcpause import gc_paused

    _phase("59 campaign plan: written as a customConfig directory, run in warm mode on the card")
    root = _plan_dir() / "campaign"
    spec_path = fx.write_campaign_plan(root, N_NODES, N_PODS, **CAMPAIGN_SIZES)
    t0 = time.perf_counter()
    spec = cp.load_campaign(spec_path)
    cluster = cp.load_campaign_cluster(spec)
    load_s = time.perf_counter() - t0
    recs, marks, engine_calls = [], [], [0]

    def launch(real):
        def run(fi, tmpl, valid, forced, init=None, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(fi, tmpl, valid, forced, init=init, **kw)
            end.record()
            torch.cuda.synchronize()
            recs.append({"fi": fi, "stream": (tmpl, valid, forced), "init": init, "out": out,
                         "ms": start.elapsed_time(end), "step": len(marks), "where": f"launch {len(recs)}"})
            return out
        return run

    def score(real):
        def run(self, rep):
            real(self, rep)
            marks.append((rep.index, rep.name, rep.type, time.perf_counter(), len(recs)))
        return run

    def engine(real):
        def run(self, *a, **kw):
            engine_calls[0] += 1
            return real(self, *a, **kw)
        return run

    _reset_launches()
    t0 = time.perf_counter()
    with _patched(fastpath, "fast_scan", launch), _patched(cp._Executor, "score", score), \
            _patched(cp._Executor, "_run_engine", engine):
        warm = cp.run_campaign(cluster, spec, mode="warm", device=device)
    warm_s = time.perf_counter() - t0
    launches = dict(fs.VARIANT_LAUNCHES)
    if launches != {CAMPAIGN_VARIANT: len(recs)} or engine_calls[0] != len(recs) or warm.full_prepares != 1:
        raise AssertionError(f"warm campaign: launches {launches}, {engine_calls[0]} scheduling passes, "
                             f"{warm.full_prepares} full prepares")
    d = warm.to_dict()
    if len(d["steps"]) != len(spec.steps) + 1 or d["steps"][1]["podsAdded"] != CAMPAIGN_SIZES["canary"]:
        raise AssertionError(f"warm campaign: {len(d['steps'])} step reports, canary {d['steps'][1]['podsAdded']}")
    per_step, t_prev, n_prev = [], t0, 0
    for (index, name, type_, t, n), s in zip(marks, d["steps"]):
        ms = [r["ms"] for r in recs[n_prev:n]]
        wall = t - t_prev
        per_step.append({"index": index, "name": name, "type": type_, "wall_s": wall, "launches": n - n_prev,
                         "kernel_ms": sum(ms), "kernel_share": sum(ms) / 1e3 / wall if wall else 0.0,
                         "evicted": s["evicted"], "rescheduled": s["rescheduled"], "unschedulable": len(s["unschedulable"]),
                         "blocked": len(s["blocked"]), "pods_bound": s["capacity"]["pods_bound"],
                         "pods_pending": s["capacity"]["pods_pending"]})
        t_prev, n_prev = t, n
    print(f"campaign plan: loaded in {load_s:.3f} s; warm run {warm_s:.3f} s, {len(recs)} launches {launches}, "
          f"fingerprint {d['fingerprint']}", flush=True)
    for row in per_step:
        print("  step " + json.dumps({k: round(v, 6) if isinstance(v, float) else v for k, v in row.items()}),
              flush=True)

    _phase(f"60 campaign plan: each of the {len(recs)} launches against the plain version over its valid pods "
           f"(the baseline over its first {CAMPAIGN_PLAIN_PODS}, and whole against the grid at S=1), from the "
           "launch's initial state")
    err, plain_ms, plain_pods, grids = 0.0, 0.0, 0, []
    valid_pods = sum(int(r["stream"][1].sum()) for r in recs)
    for rec in recs:
        e, ms, n, grid_ms = _hold_campaign_launch(rec)
        err, plain_ms, plain_pods = max(err, e), plain_ms + ms, plain_pods + n
        if grid_ms is not None:
            grids.append((rec["where"], int(rec["stream"][1].sum()), grid_ms))
    print(f"every launch identical to the plain version over {plain_pods} of its {valid_pods} valid pods "
          f"({plain_pods / valid_pods:.4f}); plain {plain_ms:.3f} ms; held whole against the grid at S=1 on the eight "
          f"state outputs (launch, valid pods, grid ms): {grids}", flush=True)

    _phase(f"61 campaigns: cold mode over the baseline and {COLD_STEPS} steps; example/campaign.yaml card vs CPU; "
           "POST /api/campaign on the server plan")
    cold_spec = cp.load_campaign(spec_path)
    cold_spec.steps = cold_spec.steps[:COLD_STEPS]
    t0 = time.perf_counter()
    # the cluster phase 59 loaded: a campaign writes nothing into it (the
    # server runs every POST /api/campaign on its one snapshot)
    cold = cp.run_campaign(cluster, cold_spec, mode="cold", device=device)
    cold_s = time.perf_counter() - t0
    if [s.fingerprint for s in cold.steps] != [s["fingerprint"] for s in d["steps"][:COLD_STEPS + 1]]:
        raise AssertionError("cold mode's step fingerprints differ from warm mode's")
    print(f"cold mode: {cold.full_prepares} full prepares in {cold_s:.3f} s, the {COLD_STEPS + 1} fingerprints warm "
          f"mode's", flush=True)
    example = cp.load_campaign(_example("campaign.yaml"))
    runs = {}
    for where, dev in (("cpu", "cpu"), ("card", device)):
        _reset_launches()
        runs[where] = (cp.run_campaign(cp.load_campaign_cluster(example), example, device=dev).to_dict(),
                       dict(fs.VARIANT_LAUNCHES))
    if runs["card"][0] != runs["cpu"][0] or set(runs["card"][1]) != {CAMPAIGN_VARIANT}:
        raise AssertionError(f"example/campaign.yaml: the card's result differs from the CPU's "
                             f"(launches {runs['card'][1]})")
    print(f"example/campaign.yaml: card equals CPU ({len(runs['card'][0]['steps'])} steps, launches "
          f"{runs['card'][1]}, fingerprint {runs['card'][0]['fingerprint']})", flush=True)
    server, url = served["server"], served["url"]
    steps = [{"name": "upgrade", "type": "drain-wave", "wave": SERVER_CAMPAIGN_WAVE,
              "nodes": [f"node-{i:05d}" for i in range(SERVER_CAMPAIGN_DRAIN)]}]
    _reset_launches()
    code, _h, answer, rt = _http(url, "/api/campaign", {"name": "server-drain", "steps": steps})
    http_launches = dict(fs.VARIANT_LAUNCHES)
    if set(http_launches) != {CAMPAIGN_VARIANT}:
        raise AssertionError(f"POST /api/campaign launched {http_launches}")
    t0 = time.perf_counter()
    with gc_paused():  # the check's run, not the one timed
        want = cp.run_campaign(server._observed_cluster()[0], cp.parse_steps(steps), name="server-drain",
                               device=device).to_dict()
    local_s = time.perf_counter() - t0
    if code != 200 or answer != want or sum(http_launches.values()) < 1 + -(-SERVER_CAMPAIGN_DRAIN // SERVER_CAMPAIGN_WAVE):
        raise AssertionError(f"POST /api/campaign: HTTP {code}, launches {http_launches}, equal to the in-process "
                             f"run: {answer == want}")
    print(f"POST /api/campaign: HTTP 200 in {rt:.3f} s, launches {http_launches}; equals run_campaign() on the "
          f"server's snapshot ({local_s:.3f} s); drained {answer['steps'][1]['nodesDrained']}", flush=True)
    work = [fs.fast_scan_work(r["fi"], *r["stream"], r["out"].chosen) for r in recs]
    t_bytes = sum(w["bytes"] for w in work) / PEAK_BYTES_S * 1e3
    t_ops = sum(w["ops"] for w in work) / PEAK_F32_S * 1e3
    ms = [r["ms"] for r in recs]
    print(f"campaign launches: {len(recs)}, kernel {sum(ms):.3f} ms in all, median {statistics.median(ms):.3f} ms, "
          f"bound {max(t_bytes, t_ops):.6f} ms ({card})", flush=True)
    return [{"name": CAMPAIGN_VARIANT, "plan": "campaign plan, warm (every scheduling pass)", "route": "cuda",
             "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu", "replaces": "opensim_tpu/ops/pallas_scan.py:1009",
             "launches": len(recs), "max_abs_err": err, "ms": sum(ms), "median_ms": statistics.median(ms),
             "max_ms": max(ms), "plain_ms": plain_ms, "plain_pods": plain_pods, "valid_pods": valid_pods,
             "grid_s1_checks": grids,
             "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None, "library": "none", "campaign_s": warm_s, "load_s": load_s, "cold_s": cold_s, "steps": per_step,
             "server_campaign_s": rt, "card": card}]


def _plain_on_cpu_timed(fi, args):
    """:func:`_plain_on_cpu` of a one scan and its host seconds, in phase
    29's worker process."""
    t0 = time.perf_counter()
    out = _plain_on_cpu(False, fi, args, {})
    return out, time.perf_counter() - t0


def _plain_on_cpu(sweep: bool, fi, args, kw):
    """The plain version of a one scan's or (`sweep`) a grid's inputs (CPU
    tensors), in a worker process of phases 3 and 62."""
    from opensim_tpu_torch.ops import fast_scan as fs

    torch.set_num_threads(1)
    return (fs.fast_scan_sweep_reference if sweep else fs.fast_scan_reference)(fi, *args, **kw)


def counting_small_cases(device) -> None:
    """Phase 62: every small case as a request batch's grid of three lanes
    of distinct pod masks, under ``[count]`` and ``[explain]``, against the
    plain sweep on all ten outputs and each lane against the one scan with
    its mask (in explain mode its ``[explain]``); the fail_mixed case also
    at WAVE_LANES lanes, more than the card's SMs, one a block, so a second
    wave of blocks runs (its first three and last three lanes against the
    plain sweep and their one scans). The plain sweeps run on the CPU, on
    copies of the grid's inputs, in PLAIN_WORKERS processes while the card
    runs the grids and the one scans: the kernel on the card is held
    against the plain version on the CPU, as phases 30 and 49 hold the
    card's reports against the CPU's."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from opensim_tpu_torch.engine import fastpath
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs

    _phase(f"62 grid counting on the small cases: [count] and [explain] grids of three lanes vs the plain sweep and "
           f"each lane's one scan; fail_mixed at {WAVE_LANES} lanes, in two waves")
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t
    held = []
    with ProcessPoolExecutor(PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        for name, prep, fi in _small_preps(device):
            P = len(prep.tmpl_ids)
            fi_cpu = fs.FastInputs(*map(cpu, fi))
            for S in ((3, WAVE_LANES) if name == "fail_mixed" else (3,)):
                args = fastpath.batch_inputs(prep, fi, fx.lane_masks(P, S))
                picks = list(range(S)) if S == 3 else [0, 1, 2, S - 3, S - 2, S - 1]
                for mode in ("count", "explain"):
                    kw = {mode: True}
                    plain = pool.submit(_plain_on_cpu, True, fi_cpu,
                                        [args[0].cpu(), *(t[picks].cpu() for t in args[1:])], kw)
                    got = fs.fast_scan_sweep(fi, *args, **kw)
                    torch.cuda.synchronize()
                    grid = fs.SWEEP_LAUNCHED[fs.sweep_name(fi, **kw)]["grid"]
                    if grid.b != 1 or grid.blocks != S:
                        raise AssertionError(f"{name} [{mode}]: {S} lanes ran as {grid}")
                    for s in picks:
                        one = fs.fast_scan(fi, args[0], args[1][s].contiguous(), args[2][s].contiguous(),
                                           explain=mode == "explain")
                        _same(fs.FastOutputs(*(t[s] for t in got)), one, f"{name} [{mode}] lane {s}: grid vs one scan")
                    held.append((plain, fs.FastOutputs(*(t[picks].cpu() for t in got)),
                                 f"{name} [{mode}] S={S}: grid vs plain sweep"))
        for plain, got, what in held:
            _same(got, plain.result(), what)
    print(f"{len(held)} counting grids identical to the plain sweep and to each lane's one scan on all ten outputs "
          f"({WAVE_LANES} lanes: {WAVE_LANES} blocks of one)", flush=True)


#: Workload names of the storms' riders, longest first: an expanded pod's
#: name starts with its workload's and a dash.
_STORM_WORKLOADS = sorted([f"bench-{w}" for w in range(20)] + ["huge"], key=len, reverse=True)


def _storm_canon(answer: dict):
    """A server answer with each pod named by its workload (pod names carry
    the process's counters): the unscheduled (pod, reason) pairs and each
    node's pods, sorted."""
    def pod(ref: str) -> str:
        ns, _, name = ref.partition("/")
        return f"{ns}/" + next((w for w in _STORM_WORKLOADS if name.startswith(w + "-")), name)

    return (sorted((pod(u["pod"]), u["reason"]) for u in answer["unscheduledPods"]),
            sorted((e["node"], sorted(pod(q) for q in e["pods"])) for e in answer["nodeStatus"]))


def _rider(body: dict, explain: bool) -> str:
    name = body["deployments"][0]["metadata"]["name"]
    return f"{name}{' (explain=1)' if explain else ''}"


def storm_plan(device, card: str, served) -> list:
    """Phases 63-64: concurrent deploy and scale requests on the server
    plan's running server. Each rider of storm B (``fixtures.storm_requests``:
    deploys of bench-10..15 at 2,500 replicas, bench-0 scaled to 5,000, 100
    replicas of 80 cores that fit no node, an explain=1 deploy of bench-16)
    sent alone first, the solo path: one launch of the one scan each. Then
    the server's admission queue with a STORM_WINDOW_S coalescing window,
    and storm A (B less the explain rider) and storm B each sent at once
    from threads: each exactly one request batch, one launch of
    ``fast_scan_sweep[count]`` (A) or ``[explain]`` (B), every rider's
    answer its solo answer (placements and reasons; the explain rider's
    reject totals too), A's riders B's; round trips, the stages' times and
    the solo round trips' sum printed. Phase 64: both launches again (CUDA
    events), each lane against one launch of the one scan with its mask
    over the whole stream on all ten outputs, the 80-core rider's lane
    (A) and the explain rider's (B) against the plain sweep over their own
    pods (the 100, and STORM_PLAIN_PODS of the 2,500) from the grid's state
    before them; the two kernel rows."""
    import threading

    from opensim_tpu_torch.engine import fastpath, reqbatch
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.server import admission, pool

    server, url = served["server"], served["url"]
    storms = {"A": fx.storm_requests(N_PODS), "B": fx.storm_requests(N_PODS, explain_rider=True)}
    path = lambda kind, explain: (("/api/deploy-apps" if kind == "deploy" else "/api/scale-apps")
                                  + ("?explain=1" if explain else ""))
    _phase(f"63 storms on the server plan: storm B's {len(storms['B'])} riders alone (the solo path), then storms A "
           f"({len(storms['A'])} riders) and B at once through the admission queue ({STORM_WINDOW_S * 1e3:g} ms window)")
    solo = []
    for kind, body, explain in storms["B"]:
        _reset_launches()
        with _host_watch(server) as host:
            code, hdrs, answer, rt = _http(url, path(kind, explain), body)
        launches = dict(fs.VARIANT_LAUNCHES)
        if code != 200 or launches != {"fast_scan[explain]" if explain else "fast_scan": 1}:
            raise AssertionError(f"solo {_rider(body, explain)}: HTTP {code}, launches {launches}: {str(answer)[:300]}")
        solo.append((answer, rt))
        attrs = _http(url, f"/api/debug/requests/{hdrs.get('X-Simon-Request-Id', '')}")[2]["spans"].get("attrs", {})
        # each request a delta on the cached base: no full prepare, no retry
        if attrs.get("rung") != "delta" or set(host["prep"]) != {"delta_apps"} or host["stale_retries"]:
            raise AssertionError(f"solo {_rider(body, explain)}: rung {attrs.get('rung')}, host {host}")
        times = {k: attrs[k] for k in ("cache_s", "prepare_s", "inputs_s", "kernel_s", "decode_s") if k in attrs}
        print(f"solo {_rider(body, explain)}: HTTP 200 in {rt:.6f} s (round trip), rung {attrs.get('rung')}, server "
              f"times {json.dumps(times)}, host {json.dumps(host)}, launches {launches}, "
              f"{sum(len(e['pods']) for e in answer['nodeStatus'])} placed, {len(answer['unscheduledPods'])} "
              "unscheduled", flush=True)
    server.admission.stop()
    server.admission = admission.AdmissionController(
        solo_fn=server._admitted_solo, batch_fn=server._admitted_batch, prep_fn=server._batch_prep,
        dispatch_fn=server._batch_dispatch, decode_fn=server._batch_decode, window_s=STORM_WINDOW_S,
        pool=pool.WorkerPool(device=device))
    ctrl = server.admission
    recorded, summary = [], {}

    def keep(real):
        def run(prep, items):
            out = real(prep, items)
            recorded.append((prep, items, out))
            return out
        return run

    with _patched(reqbatch, "dispatch_request_batch", keep):
        for label, reqs in storms.items():
            batches0 = ctrl.batches_total
            stages0 = {k: v["total_s"] for k, v in ctrl.pipeline_snapshot()["stages"].items()}
            _reset_launches()
            answers = [None] * len(reqs)

            def send(i, kind, body, explain):
                answers[i] = _http(url, path(kind, explain), body)

            threads = [threading.Thread(target=send, args=(i, *r)) for i, r in enumerate(reqs)]
            with _host_watch(server) as host:
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                storm_rt = time.perf_counter() - t0
            launches = dict(fs.VARIANT_LAUNCHES)
            row = "fast_scan_sweep[explain]" if label == "B" else "fast_scan_sweep[count]"
            if launches != {row: 1} or ctrl.batches_total != batches0 + 1:
                raise AssertionError(f"storm {label}: launches {launches}, {ctrl.batches_total - batches0} batches; "
                                     f"want one launch of {row} in one batch")
            # the batch rides the cached base: one delta, no full prepare, no retry
            if set(host["prep"]) != {"delta_apps"} or host["prep"]["delta_apps"][0] != 1 or host["stale_retries"]:
                raise AssertionError(f"storm {label}: host {host}; want one delta of the cached base")
            stages = {k: v["total_s"] - stages0.get(k, 0.0) for k, v in ctrl.pipeline_snapshot()["stages"].items()}
            queue = []
            for i, ((kind, body, explain), (code, hdrs, answer, rt)) in enumerate(zip(reqs, answers)):
                if code != 200:
                    raise AssertionError(f"storm {label}, {_rider(body, explain)}: HTTP {code}: {str(answer)[:300]}")
                if _storm_canon(answer) != _storm_canon(solo[i][0]):
                    raise AssertionError(f"storm {label}, {_rider(body, explain)}: answer differs from its solo answer")
                if explain and answer.get("filterRejects") != solo[i][0].get("filterRejects"):
                    raise AssertionError(f"storm {label}, {_rider(body, explain)}: filter rejects differ from solo")
                if label == "B" and i < len(storms["A"]) and \
                        _storm_canon(answer) != _storm_canon(summary["A"]["answers"][i][2]):
                    raise AssertionError(f"{_rider(body, explain)}: storm B placed it differently from storm A")
                tree = _http(url, f"/api/debug/requests/{hdrs.get('X-Simon-Request-Id', '')}")[2]
                spans = {c["name"]: c for c in tree["spans"].get("children", [])}
                queue.append(spans["queue"]["duration_s"] if "queue" in spans else 0.0)
                print(f"storm {label}, {_rider(body, explain)}: HTTP 200 in {rt:.6f} s (round trip), queue "
                      f"{queue[-1]:.6f} s, batch of {spans.get('schedule', {}).get('attrs', {}).get('batch')}; equals "
                      "its solo answer", flush=True)
            solo_sum = sum(rt for _a, rt in solo[:len(reqs)])
            summary[label] = {"answers": answers, "storm_rt_s": storm_rt, "solo_rt_sum_s": solo_sum, "stages_s": stages,
                              "queue_s": queue, "rider_rt_s": [a[3] for a in answers], "host": host}
            print(f"storm {label}: {len(reqs)} riders in {storm_rt:.6f} s (first send to last answer), one launch of "
                  f"{row}; stages prep {stages.get('prep', 0):.6f} s, dispatch {stages.get('dispatch', 0):.6f} s, "
                  f"decode {stages.get('decode', 0):.6f} s, queue {min(queue):.6f}-{max(queue):.6f} s; host "
                  f"{json.dumps(host)}; the solo round trips' sum {solo_sum:.6f} s ({card})", flush=True)
    if len(recorded) != 2:
        raise AssertionError(f"{len(recorded)} request batches dispatched, want 2")

    _phase("64 storm kernel rows: both launches again (CUDA events); each lane vs the one scan with its mask over the "
           "whole stream; the 80-core and the explain riders' lanes vs the plain sweep over their own pods")
    rows = []
    for label, (prep, items, dispatch) in zip(storms, recorded):
        explain = label == "B"
        kw = {"explain": True} if explain else {"count": True}
        fi, _ = fastpath.build_inputs(prep)
        args = fastpath.batch_inputs(prep, fi, dispatch.pod_valid)
        out = [None]

        def run_grid():
            out[0] = fs.fast_scan_sweep(fi, *args, **kw)

        ms = _events_ms(run_grid, reps=3)
        name = fs.sweep_name(fi, **kw)
        shape = fs.SWEEP_LAUNCHED[name]["grid"]
        grid, S, P = out[0], args[1].shape[0], args[1].shape[1]
        err = 0.0
        for s in range(S):
            host = dispatch.outs[s]
            if not (np.array_equal(grid.chosen[s].cpu().numpy(), host.chosen)
                    and np.array_equal(grid.fail_counts[s].cpu().numpy(), host.fail_counts)
                    and np.array_equal(grid.insufficient[s].cpu().numpy(), host.insufficient)):
                raise AssertionError(f"storm {label}, lane {s}: the launch timed here differs from the storm's")
            one = fs.fast_scan(fi, args[0], args[1][s].contiguous(), args[2][s].contiguous(), explain=explain)
            err = max(err, _same(fs.FastOutputs(*(t[s] for t in grid)), one,
                                 f"storm {label}, lane {s}: grid vs one scan over the whole stream"))
        # lanes lie in the batch's order of arrival: find the rider's by its app
        rider = lambda it: it.apps[0].resources.deployments[0].metadata.name
        s = next(j for j, it in enumerate(items) if (it.explain if explain else rider(it) == "huge"))
        plain_lane = f"{rider(items[s])}{' (explain=1)' if explain else ''}"
        lo = items[s].lo
        hi = min(items[s].hi, lo + STORM_PLAIN_PODS)
        lane = lambda a, b: (args[0][a:b].contiguous(), args[1][s:s + 1, a:b].contiguous(),
                             args[2][s:s + 1, a:b].contiguous(), args[3][s:s + 1], args[4][s:s + 1])
        init = fs.fast_scan_sweep(fi, *lane(0, lo), **kw).state.clone()
        upto = fs.fast_scan_sweep(fi, *lane(0, hi), **kw)
        if not torch.equal(upto.chosen[0], grid.chosen[s, :hi]):
            raise AssertionError(f"storm {label}: the lane's launch over pods 0..{hi} placed differently")
        got = upto._replace(**{f: getattr(upto, f)[:, lo:] for f in ("chosen", "gpu_take", "fail_counts",
                                                                     "insufficient")})
        plain = [None]

        def run_plain():
            plain[0] = fs.fast_scan_sweep_reference(fi, *lane(lo, hi), init=init, **kw)

        plain_ms = _events_ms(run_plain, reps=1)
        err = max(err, _same(got, plain[0], f"storm {label}, {plain_lane}'s lane, pods {lo}..{hi} vs the plain sweep "
                                            "from the grid's state"))
        failing = int((got.chosen[0] < 0).sum())
        work = fs.fast_scan_work(fi, args[0], args[1], args[2], grid.chosen, args[3], **kw)
        t_bytes, t_ops = work["bytes"] / PEAK_BYTES_S * 1e3, work["ops"] / PEAK_F32_S * 1e3
        steps = int(((args[1] != 0) & (args[2] == 0)).sum())
        print(f"storm {label}: {name} at S={S}, P={P} ({steps} lane-steps schedule, {work['count']['steps']} "
              f"counted): kernel {ms:.3f} ms ({ms * 1e3 / (S * P):.4f} us a lane-step, {ms * 1e3 / steps:.3f} us a "
              f"scheduling lane-step), {shape.blocks} blocks of {shape.b}; every lane equals its one scan; "
              f"{plain_lane}'s pods {lo}..{hi} ({failing} find no node) equal the plain sweep "
              f"({plain_ms:.3f} ms); bound {max(t_bytes, t_ops):.6f} ms ({card})", flush=True)
        rows.append({
            "name": name, "plan": f"storm {label}: {S} riders on the server plan, one request batch",
            "route": "cuda", "source": "opensim_tpu_torch/ops/csrc/fast_scan.cu",
            "replaces": "opensim_tpu/ops/kernels.py:1056" if explain else "opensim_tpu/ops/kernels.py:1042",
            "launches": 1, "launches_are": "the storm's one launch in the server run", "max_abs_err": err,
            "ms": ms, "us_per_lane_step": ms * 1e3 / (S * P), "us_per_scheduling_lane_step": ms * 1e3 / steps,
            "lanes": S, "pods": P, "scheduling_lane_steps": steps, "counted_steps": work["count"]["steps"],
            "b": shape.b, "blocks": shape.blocks, "plain_ms": plain_ms,
            "plain_span": [lo, hi], "plain_lane": plain_lane,
            "ptxas": fs.SWEEP_LAUNCHED[name]["ptxas"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None, "library": "none",
            **{k: v for k, v in summary[label].items() if k != "answers"}, "card": card,
        })
    return rows

def _wait_for(pred, timeout: float, what: str) -> float:
    """Poll `pred` until it holds; the seconds it took. Raises past
    `timeout`."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if pred():
            return time.perf_counter() - t0
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout:g} s waiting for {what}")


def _relisted(kube: str):
    """(cluster, content fingerprint) of a fresh full relist of the stub."""
    from opensim_tpu_torch.engine.prepcache import fingerprint_cluster
    from opensim_tpu_torch.server.snapshot import _cluster_via_rest

    cluster, _rvs = _cluster_via_rest(kube, None)
    return cluster, fingerprint_cluster(cluster)


def _same_answer(got: dict, want: dict, what: str) -> None:
    if _without_counters(json.dumps(got, sort_keys=True)) != _without_counters(json.dumps(want, sort_keys=True)):
        raise AssertionError(f"{what}: the answers differ")


def _twin_request(server, url: str, label: str, body: dict, key: str) -> dict:
    """One deploy over HTTP to the twin server, its launches counted and
    its host time watched (:func:`_host_watch`); the request's trace must
    carry the twin's generation key `key` (the answer came from the twin)."""
    from opensim_tpu_torch.ops import fast_scan as fs

    _reset_launches()
    with _host_watch(server) as host:
        code, hdrs, answer, rt = _http(url, "/api/deploy-apps", body)
    launches = dict(fs.VARIANT_LAUNCHES)
    attrs = _http(url, f"/api/debug/requests/{hdrs.get('X-Simon-Request-Id', '')}")[2]["spans"].get("attrs", {})
    if code != 200 or launches != {"fast_scan": 1}:
        raise AssertionError(f"{label}: HTTP {code}, launches {launches}: {str(answer)[:300]}")
    if attrs.get("twin_key") != key:
        raise AssertionError(f"{label}: served from {attrs.get('twin_key')!r}, not the twin's {key!r}")
    times = {k: attrs[k] for k in ("cache_s", "prepare_s", "inputs_s", "kernel_s", "decode_s") if k in attrs}
    print(f"{label}: HTTP 200 in {rt:.6f} s (round trip), served from {key}, rung {attrs.get('rung')}, server times "
          f"{json.dumps(times)}, host {json.dumps(host)}, launches {launches}", flush=True)
    return {"answer": answer, "rt": rt, "launches": launches, "attrs": attrs, "host": host}


def _twin_wave(stub, sup, ops, settled, label: str) -> dict:
    """Send a wave's events through the stub and wait until the twin has
    applied them (`settled`); then fold what the supervisor's tick has not
    yet folded (``flush_pending``). Returns the send, apply and flush
    times, the events per second from the first send to the last applied,
    and what the host spent (``PREP_STATS`` kinds, full collections)."""
    from opensim_tpu_torch.models import fixtures as fx

    with _host_watch() as host:
        t0 = time.perf_counter()
        fx.send_wave(stub, ops)
        send_s = time.perf_counter() - t0
        apply_s = send_s + _wait_for(settled, TWIN_WAIT_S, f"{label} applied to the twin")
        t1 = time.perf_counter()
        sup.flush_pending()
        flush_s = time.perf_counter() - t1
    out = {"events": len(ops), "send_s": send_s, "applied_s": apply_s, "events_per_s": len(ops) / apply_s,
           "final_flush_s": flush_s, "host": host, "generation": sup.twin.generation}
    print(f"{label}: {len(ops)} events sent in {send_s:.6f} s, applied by the twin {apply_s:.6f} s after the first "
          f"({len(ops) / apply_s:.1f} events/s); the last flush_pending {flush_s:.6f} s; host {json.dumps(host)}; "
          f"generation {sup.twin.generation}", flush=True)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metrics_of(url: str) -> dict:
    from opensim_tpu_torch.obs.metrics import parse_metrics

    return parse_metrics(_http(url, "/metrics")[2])


def twin_plan(device, card: str, served) -> list:
    """The live twin on the card (phases 65-67), on the server plan's stub
    apiserver and fleet. 65: a second server, ``rest.start_server(watch=
    "on", journal=...)``, its bootstrap and first request (R2's body: one
    base prepare) timed; wave W1 (TWIN_ADD pods ADDED, TWIN_DEL of the
    snapshot's DELETED, TWIN_NEW_NODES nodes ADDED), R2's body; wave W2 (one
    node MODIFIED: the lineage drops), R2's body. After each wave the
    twin's fingerprint is a full relist's; each answer the uncached
    server's on the relisted cluster; after W1 the request is one delta on
    the folded base (``twin_delta``, ``delta_nodes``, ``delta_apps``, no
    ``full``), its kernel row against the plain version and the torch
    step (as phase 53). 66: storm A through the twin server's admission
    queue while a wave of pods lands: every rider 200, every launch the
    grid's ``[count]``, each lane its one scan over the whole stream. 67:
    ``simon server --watch on --journal`` as a subprocess on the card, wave
    W3, SIGKILL, a restart on the journal (checkpoint and suffix, no
    relist, no variant rebuilt); while it recovers, the uncached server's
    answer on the relisted cluster and a card ``simulate()`` of the replay's
    probe are computed here; the restart's answer (requested beside the
    in-process twin's) the in-process twin's, and that the uncached
    server's (the polling answer after the storm's wave and W3); SIGTERM;
    ``simon replay --capacity --schedule`` on the card (the CLI in this
    process), its fingerprint the relist's (the journal's last checkpoint
    is the restored twin) and its count the card ``simulate()``'s. The
    stub apiserver's objects and the earlier phases' are frozen out of the
    collector's generations (``gc.freeze``) for these phases. Then phase 68
    (:func:`fleet_plan`) while this twin serves. Returns the kernels-table
    rows of 65's request and of 68's request from the publication."""
    import gc
    import shutil
    import signal
    import threading

    from opensim_tpu_torch.engine import fastpath, reqbatch, simulator as sim
    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.models.objects import ResourceTypes
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.server import admission, pool, rest
    from opensim_tpu_torch.utils.gcpause import gc_paused

    stub, kube, bodies = served["stub"], served["kube"], served["bodies"]
    # phase 50's server has served its phases: it stops and leaves the
    # heap, which the interpreter's full collections walk
    served["retire"]()
    # the stub apiserver's objects and what the earlier phases left stay out
    # of the twin server's full collections: a server process holds neither
    gc.freeze()
    live = served.pop("pods")  # the stub's pods, kept in step with the waves
    n_snapshot = len(live)
    root = _plan_dir() / "twin"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    _phase(f"65 live twin: simon server --watch on --journal on the server plan's stub; W1 ({TWIN_ADD} pods ADDED, "
           f"{TWIN_DEL} DELETED, {TWIN_NEW_NODES} nodes ADDED) and W2 (a node MODIFIED), R2's body after each")
    t0 = time.perf_counter()
    server, httpd = rest.start_server(kubeconfig=kube, watch="on", journal=str(root / "in-process"), port=0,
                                      host="127.0.0.1", device=device)
    start_s = time.perf_counter() - t0
    sup = server.watch
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    key = lambda: f"{sup.key_prefix}{sup.twin.generation}"
    # the uncached server, its cache off: each answer is held against its
    # full prepare of the cluster as the stub lists it then
    legacy = rest.SimonServer(kubeconfig=kube, prep_cache=False, device=device, admission=False, capacity=False)

    def relisted(label: str, got: dict) -> float:
        """A full relist of the stub: the twin's fingerprint must be its
        fingerprint, and the twin's answer `got` the uncached server's (its
        request path with the cache off: a full prepare and one launch) on
        the relisted cluster, the server's own copy. The collector is paused
        and the check's objects die before it runs again, so they add no
        full collections to the twin server's requests."""
        t1 = time.perf_counter()
        with gc_paused():
            fresh, fp = _relisted(kube)
            if sup.twin.fingerprint() != fp:
                raise AssertionError(f"{label}: the twin's fingerprint differs from a full relist's")
            want = rest._response(legacy._simulated("uncached", 0.0, fresh, [sim.AppResource(
                "deploy", rest._decode_app(json.loads(json.dumps(bodies["deploy"]))))], False))
            n_nodes, n_pods = len(fresh.nodes), len(fresh.pods)
            del fresh
        _same_answer(got, want, f"{label} vs the uncached server on the relisted cluster")
        secs = time.perf_counter() - t1
        print(f"{label}: the twin's fingerprint equals a full relist's ({n_nodes} nodes, {n_pods} pods), its answer "
              f"the uncached server's full prepare of the relisted cluster ({secs:.3f} s for both)", flush=True)
        return secs

    summary = {"start_s": start_s}
    try:
        print(f"twin server started in {start_s:.3f} s (bootstrap list, rebase, checkpoint enqueued, variants "
              f"loaded), generation {sup.twin.generation}, state {sup.state()}; listening on {url}", flush=True)
        r0 = _twin_request(server, url, "R2 on the twin (cold: one base prepare)", bodies["deploy"], key())
        if set(r0["host"]["prep"]) != {"full", "delta_apps"} or r0["attrs"].get("rung") != "cold":
            raise AssertionError(f"the twin's first request: {r0['host']}")
        n_nodes = N_NODES + TWIN_NEW_NODES
        w1 = fx.twin_wave(live, N_NODES, TWIN_ADD, TWIN_DEL, TWIN_NEW_NODES, tag="w1")
        summary["W1"] = _twin_wave(stub, sup, w1, lambda: len(sup.twin.materialize().pods) == len(live)
                                   and len(sup.twin.materialize().nodes) == n_nodes, "W1")
        r1 = _twin_request(server, url, "R2 after W1", bodies["deploy"], key())
        folded = summary["W1"]["host"]["prep"]
        if r1["attrs"].get("rung") != "delta" or set(r1["host"]["prep"]) != {"delta_apps"} or "full" in folded \
                or "twin_delta" not in folded or "delta_nodes" not in folded:
            raise AssertionError(f"W1 and the request after it: wave {folded}, request {r1['host']}")
        summary["uncached_W1_s"] = relisted("R2 after W1", r1["answer"])
        (entry,) = [e for e in server.prep_cache.entries_snapshot() if e.key.startswith(f"{key()}|deploy|")]
        if int(entry.drop_mask.sum()) != TWIN_DEL or len(entry.prep.ordered) != n_snapshot + TWIN_ADD + \
                N_PODS // 2:
            raise AssertionError(f"the twin request's stream: {len(entry.prep.ordered)} pods, "
                                 f"{int(entry.drop_mask.sum())} masked")
        shape = fs.SCAN_LAUNCHED["fast_scan"]["shape"]
        if shape.nc != -(-n_nodes // shape.cluster):
            raise AssertionError(f"the twin request's launch: {shape.nc} nodes a CTA at N = {n_nodes}")
        row = _server_row("twin R2 after W1", entry, False, r1["launches"]["fast_scan"], r1["rt"])
        w2 = fx.node_label_wave(0)
        summary["W2"] = _twin_wave(stub, sup, w2, lambda: "twin-wave" in sup.twin.materialize().nodes[0]
                                   .metadata.labels, "W2")
        r2 = _twin_request(server, url, "R2 after W2 (the lineage dropped: one base prepare)", bodies["deploy"], key())
        if set(r2["host"]["prep"]) != {"full", "delta_apps"} or r2["attrs"].get("rung") != "cold":
            raise AssertionError(f"the request after W2: {r2['host']}")
        summary["uncached_W2_s"] = relisted("R2 after W2", r2["answer"])
        summary["rt_s"] = {"first": r0["rt"], "after_W1": r1["rt"], "after_W2": r2["rt"]}
        summary["request_attrs"] = {n: {k: r["attrs"].get(k) for k in ("rung", "cache_s", "prepare_s", "inputs_s",
                                                                          "kernel_s", "decode_s")}
                                    for n, r in (("first", r0), ("after_W1", r1), ("after_W2", r2))}
        print(f"phase 65: start {start_s:.3f} s; round trips first {r0['rt']:.6f}, after W1 {r1['rt']:.6f}, after W2 "
              f"{r2['rt']:.6f} s; W1 {summary['W1']['events_per_s']:.1f} events/s ({card})", flush=True)

        _phase(f"66 storm A on the twin server while a wave of {TWIN_STORM_WAVE} pods ADDED and {TWIN_STORM_WAVE} "
               f"DELETED lands ({STORM_WINDOW_S * 1e3:g} ms window)")
        server.admission.stop()
        server.admission = admission.AdmissionController(
            solo_fn=server._admitted_solo, batch_fn=server._admitted_batch, prep_fn=server._batch_prep,
            dispatch_fn=server._batch_dispatch, decode_fn=server._batch_decode, window_s=STORM_WINDOW_S,
            pool=pool.WorkerPool(device=device))
        storm = fx.storm_requests(N_PODS)
        wave = fx.twin_wave(live, N_NODES, TWIN_STORM_WAVE, TWIN_STORM_WAVE, tag="s66")
        recorded = []

        def keep(real):
            def run(prep, items):
                out = real(prep, items)
                recorded.append((prep, items, out))
                return out
            return run

        answers = [None] * len(storm)

        def send(i, kind, body, explain):
            answers[i] = _http(url, "/api/deploy-apps" if kind == "deploy" else "/api/scale-apps", body)

        threads = [threading.Thread(target=send, args=(i, *r)) for i, r in enumerate(storm)]
        threads.append(threading.Thread(target=fx.send_wave, args=(stub, wave)))
        retries0 = server.metrics.stale_prep_retries
        _reset_launches()
        with _patched(reqbatch, "dispatch_request_batch", keep), _host_watch(server) as host:
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(TWIN_WAIT_S)
            storm_rt = time.perf_counter() - t0
        launches = dict(fs.VARIANT_LAUNCHES)
        for (kind, body, explain), got in zip(storm, answers):
            if got is None or got[0] != 200 or not {"unscheduledPods", "nodeStatus"} <= set(got[2]):
                raise AssertionError(f"storm under events, {_rider(body, explain)}: {str(got)[:300]}")
        if set(launches) != {"fast_scan_sweep[count]"}:
            raise AssertionError(f"storm under events: launches {launches}, want the grid's [count] alone")
        retries = server.metrics.stale_prep_retries - retries0
        err = 0.0
        lanes = 0
        for prep, items, dispatch in recorded:
            fi, _ = fastpath.build_inputs(prep)
            args = fastpath.batch_inputs(prep, fi, dispatch.pod_valid)
            for s_, host_out in enumerate(dispatch.outs):
                one = fs.fast_scan(fi, args[0], args[1][s_].contiguous(), args[2][s_].contiguous())
                for f in ("chosen", "fail_counts", "insufficient"):
                    if not np.array_equal(getattr(one, f).cpu().numpy(), getattr(host_out, f)):
                        raise AssertionError(f"storm under events: lane {s_}'s {f} differs from its one scan")
                lanes += 1
        print(f"storm under events: {len(storm)} riders answered 200 in {storm_rt:.6f} s, {len(recorded)} request "
              f"batch(es), launches {launches}, {retries} generation-swap retries; each of {lanes} lanes equals its "
              f"one scan over the whole stream; host {json.dumps(host)}", flush=True)
        # the polling server's answer once the wave has settled: phase 67's
        # in-process request after W3, on the cluster the stub then lists
        settle_s = _wait_for(lambda: len(sup.twin.materialize().pods) == len(live), TWIN_WAIT_S, "the storm's wave")
        summary["storm"] = {"riders": len(storm), "rt_s": storm_rt, "batches": len(recorded), "launches": launches,
                            "stale_retries": retries, "lanes": lanes, "settle_s": settle_s, "host": host,
                            "rider_rt_s": [a[3] for a in answers]}

        _phase(f"67 journal and replay: simon server --watch on --journal as a subprocess on the card, W3 "
               f"({TWIN_W3_WAVE} pods ADDED, {TWIN_W3_WAVE} DELETED), SIGKILL, restart on the journal; simon replay")
        repo = os.path.dirname(os.path.abspath(__file__))
        jd = str(root / "journal")
        env = dict(os.environ, PYTHONPATH=repo, OPENSIM_JOURNAL_FSYNC="always")
        # the subprocesses run where a user's would, on the card (a CPU
        # rehearsal of this phase names its device)
        dev_args = [] if torch.device(device).type == "cuda" else ["--device", str(device)]
        built = {p.name: p.stat().st_mtime_ns for p in Path(fs.BUILD_DIR).glob("*.so")}

        def launch(tag: str):
            """Start ``simon server --watch on --journal`` in a subprocess;
            :func:`listening` waits until it answers /healthz."""
            port = _free_port()
            log_path = root / f"server-{tag}.log"
            fh = open(log_path, "w")
            proc = subprocess.Popen([sys.executable, "-m", "opensim_tpu_torch", "server", "--kubeconfig", kube,
                                     "--watch", "on", "--journal", jd, "--port", str(port), *dev_args],
                                    stdout=fh, stderr=subprocess.STDOUT, cwd=repo, env=env)
            fh.close()
            procs.append(proc)
            sub = {"tag": tag, "proc": proc, "url": f"http://127.0.0.1:{port}", "log": log_path, "up": []}

            def up():
                if proc.poll() is not None:
                    raise AssertionError(f"simon server ({tag}) exited {proc.returncode}: "
                                         f"{log_path.read_text()[-3000:]}")
                try:
                    return _http(sub["url"], "/healthz")[0] == 200
                except OSError:
                    return False

            def watch():
                # the seconds from the start to the first /healthz answer,
                # read while this process goes on with other work
                try:
                    sub["up"].append(_wait_for(up, TWIN_START_S, f"simon server ({tag}) to listen"))
                except AssertionError as e:
                    sub["up"].append(e)

            sub["watcher"] = threading.Thread(target=watch, daemon=True)
            sub["watcher"].start()
            return sub

        def listening(sub) -> float:
            sub["watcher"].join(TWIN_START_S + 30)
            if not sub["up"] or isinstance(sub["up"][0], AssertionError):
                raise AssertionError(f"simon server ({sub['tag']}): {sub['up'][0] if sub['up'] else 'no answer'}")
            secs = sub["up"][0]
            print(f"simon server --watch on --journal ({sub['tag']}): listening {secs:.3f} s after the process "
                  f"started", flush=True)
            return secs

        procs = []
        try:
            first = launch("first")
            first_s = listening(first)
            w3 = fx.twin_wave(live, N_NODES, TWIN_W3_WAVE, TWIN_W3_WAVE, tag="w3")
            fx.send_wave(stub, w3)
            journaled = lambda: _metrics_of(first["url"]).get(("simon_journal_records_total", (("type", "ev"),)), 0)
            _wait_for(lambda: journaled() >= len(w3), TWIN_WAIT_S, "W3's events in the subprocess's journal")
            time.sleep(0.5)  # the writer counts a record before its batch's fsync
            first["proc"].kill()  # SIGKILL: no flush, no close
            first["proc"].wait(30)
            _wait_for(lambda: len(sup.twin.materialize().pods) == len(live), TWIN_WAIT_S, "W3 in the in-process twin")
            with gc_paused():
                fresh, fp = _relisted(kube)
            _wait_for(lambda: sup.twin.fingerprint() == fp, TWIN_WAIT_S, "the in-process twin to settle")
            lists0 = sum(1 for _p, q in stub.requests_seen if "watch" not in q)
            restart = launch("restart")
            # while the restart recovers, this process computes what its
            # answer and simon replay's count are held against, from the
            # relisted cluster (no list of the stub until it listens): the
            # uncached server's answer (the polling answer after the storm's
            # wave and W3) and a card simulate() of the replay's probe
            with gc_paused():
                probe_cluster = copy.deepcopy(fresh)
                t1 = time.perf_counter()
                want = rest._response(legacy._simulated("uncached", 0.0, fresh, [sim.AppResource(
                    "deploy", rest._decode_app(json.loads(json.dumps(bodies["deploy"]))))], False))
                uncached_s = time.perf_counter() - t1
                probe = ResourceTypes()
                probe.deployments.append(fx.make_fake_deployment("replay-probe", TWIN_REPLAY_PODS, "100m", "256Mi"))
                _reset_launches()
                res = sim.simulate(probe_cluster, [sim.AppResource("replay", probe)], device=device)
                probe_want = TWIN_REPLAY_PODS - len(res.unscheduled_pods)
                probe_launches = dict(fs.VARIANT_LAUNCHES)
                del res, probe_cluster, fresh
            if probe_launches != {"fast_scan": 1}:
                raise AssertionError(f"the replay probe's card simulate() launched {probe_launches}")
            restart_s = listening(restart)
            sub_url, log2 = restart["url"], restart["log"]
            m = _metrics_of(sub_url)
            if m.get(("simon_journal_recoveries_total", (("outcome", "restored"),))) != 1 or \
                    m.get(("simon_watch_relists_total", ())) != 0 or \
                    sum(1 for _p, q in stub.requests_seen if "watch" not in q) != lists0:
                raise AssertionError("the restart did not recover from the journal alone: "
                                     f"{ {k: v for k, v in m.items() if 'journal' in k[0] or 'relist' in k[0]} }")
            import re

            got = re.search(r"generation (\d+) \(checkpoint (\d+) \+ (\d+) replayed", log2.read_text())
            if got is None or int(got.group(3)) < len(w3):
                raise AssertionError(f"the restart's recovery line: {got and got.group(0)}")
            rebuilt = {p.name: p.stat().st_mtime_ns for p in Path(fs.BUILD_DIR).glob("*.so")}
            if rebuilt != built:
                raise AssertionError("a subprocess rebuilt or added kernel variants")
            # the restarted server's request (its base prepare, in its own
            # process) beside the in-process twin's on the same state
            sub_reply = [None]
            sub_thread = threading.Thread(target=lambda: sub_reply.__setitem__(
                0, _http(sub_url, "/api/deploy-apps", bodies["deploy"])))
            sub_thread.start()
            inproc = _twin_request(server, url, "R2 on the in-process twin after W3", bodies["deploy"], key())
            sub_thread.join(TWIN_WAIT_S)
            if sub_reply[0] is None or sub_reply[0][0] != 200:
                raise AssertionError(f"the restarted server answered {str(sub_reply[0])[:300]}")
            code, _h, sub_answer, sub_rt = sub_reply[0]
            _same_answer(inproc["answer"], want, "the in-process twin after W3 vs the uncached server on the relisted "
                                                 "cluster")
            _same_answer(sub_answer, inproc["answer"], "the restarted server vs the in-process twin")
            restart["proc"].send_signal(signal.SIGTERM)
            rc = restart["proc"].wait(60)
            if rc != 0 or "shutdown complete" not in log2.read_text():
                raise AssertionError(f"SIGTERM: exit {rc}: {log2.read_text()[-2000:]}")
        finally:
            for p_ in procs:
                if p_.poll() is None:
                    p_.kill()
                    p_.wait(30)
        print(f"R2 on the in-process twin after W3: the uncached server's full prepare of the relisted cluster "
              f"(the polling answer after the storm's wave and W3; {uncached_s:.3f} s, during the restart)", flush=True)
        print(f"restart: listening {restart_s:.3f} s after the process started (first start {first_s:.3f} s), "
              f"recovered {got.group(0)}; no list, no relist, no variant built; its answer equals the in-process "
              f"twin's ({sub_rt:.6f} s round trip beside it, one base prepare); SIGTERM exit 0", flush=True)
        # simon replay of the journal the restart re-anchored (its last
        # checkpoint is the restored twin), on the card, in this process
        import io

        from opensim_tpu_torch.cli import main as cli

        buf = io.StringIO()
        _reset_launches()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["replay", jd, "--capacity", "--schedule", str(TWIN_REPLAY_PODS), *dev_args])
        replay_s = time.perf_counter() - t1
        replay_launches = dict(fs.VARIANT_LAUNCHES)
        if rc != 0 or replay_launches != {"fast_scan": 1}:
            raise AssertionError(f"simon replay: exit {rc}, launches {replay_launches}: {buf.getvalue()[-2000:]}")
        replay = json.loads(buf.getvalue().strip().splitlines()[-1])
        if replay["fingerprint"] != fp or replay["schedule"]["scheduled"] != probe_want:
            raise AssertionError(f"simon replay: {json.dumps(replay)}; the card simulate() placed {probe_want}")
        print(f"simon replay --capacity --schedule {TWIN_REPLAY_PODS}: {replay_s:.3f} s, launches {replay_launches}; "
              f"{json.dumps(replay)}; its fingerprint the relist's, its {replay['schedule']['scheduled']} scheduled "
              f"the card simulate()'s", flush=True)
        summary["journal"] = {"first_start_s": first_s, "restart_s": restart_s, "recovered": got.group(0),
                              "replay_s": replay_s, "replay": replay, "restart_rt_s": sub_rt,
                              "inproc_rt_s": inproc["rt"], "uncached_W3_s": uncached_s}
        print(f"live twin phases 65-67 {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
        # phase 68: the serving fleet on the journal the restart left, while
        # this twin serves
        fleet_row = fleet_plan(device, card, {
            "server": server, "url": url, "sup": sup, "key": key, "stub": stub, "kube": kube, "bodies": bodies,
            "live": live, "jd": jd, "root": root, "built": built, "dev_args": dev_args})
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        gc.unfreeze()
    row["twin"] = summary
    return [row, fleet_row]


def _fleet_port() -> int:
    """A public port P whose fleet neighbours are free too: the owner's
    admin endpoint P + 1, the workers' loopback listeners P + 2 ... and the
    standby's admin endpoint P + 16."""
    import socket

    for _ in range(50):
        port = _free_port()
        try:
            for p in [port, port + 1, *(port + 2 + i for i in range(FLEET_WORKERS)), port + 16]:
                with socket.socket() as s:
                    s.bind(("0.0.0.0", p))
        except OSError:
            continue
        return port
    raise AssertionError("no free port block for the fleet")


def _find_span(node: dict, name: str):
    """The first span named `name` in a request's trace tree (depth first)."""
    if node.get("name") == name:
        return node
    for child in node.get("children") or []:
        got = _find_span(child, name)
        if got is not None:
            return got
    return None


def _worker_request(w: dict, body: dict, label: str, want_key: str) -> dict:
    """R2's body to one fleet worker's loopback listener: the answer, the
    round trip, and from the worker's own trace of it the kernel variants
    it launched (exactly one ``fast_scan``), the generation it served
    (`want_key`), its attach and upload times when it attached a
    generation for it, and its phase split."""
    wurl = f"http://127.0.0.1:{w['internal_port']}"
    code, hdrs, answer, rt = _http(wurl, "/api/deploy-apps", body)
    tree = _http(wurl, f"/api/debug/requests/{hdrs.get('X-Simon-Request-Id', '')}")[2]
    attrs = tree["spans"].get("attrs", {})
    if code != 200 or attrs.get("launches") != "fast_scan=1" or attrs.get("twin_key") != want_key:
        raise AssertionError(f"{label}: HTTP {code}, launches {attrs.get('launches')!r}, served from "
                             f"{attrs.get('twin_key')!r} (want {want_key!r}): {str(answer)[:300]}")
    attach = (_find_span(tree["spans"], "fleet.attach") or {}).get("attrs", {})
    split = {k: attrs[k] for k in ("rung", "cache_s", "prepare_s", "inputs_s", "kernel_s", "decode_s") if k in attrs}
    print(f"{label} (worker {w['index']}, pid {w['pid']}): HTTP 200 in {rt:.6f} s (round trip), served from "
          f"{want_key}, launches {attrs['launches']}; attach {attach.get('attach_s')} s, upload "
          f"{attach.get('upload_s')} s; split {json.dumps(split)}", flush=True)
    return {"answer": answer, "rt": rt, "attach_s": attach.get("attach_s"), "upload_s": attach.get("upload_s"),
            "split": split}


def _on_workers(workers: list, body: dict, label: str, want_key: str):
    """:func:`_worker_request` on every worker at once, from threads;
    returns a function that waits for them and returns their results."""
    import threading

    got = [None] * len(workers)

    def one(i):
        try:
            got[i] = _worker_request(workers[i], body, label, want_key)
        except BaseException as e:  # re-raised by wait(), on the caller's thread
            got[i] = e

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(workers))]
    for t in threads:
        t.start()

    def wait() -> list:
        for t in threads:
            t.join(TWIN_WAIT_S)
        for g in got:
            if g is None or isinstance(g, BaseException):
                raise AssertionError(f"{label}: {g!r}")
        return got

    return wait


def fleet_plan(device, card: str, twin: dict) -> tuple:
    """The serving fleet on the card (phase 68), run while the in-process
    twin of phases 65-67 serves, on the journal phase 67's restart left.
    ``simon server --workers 2 --watch on --journal`` starts as a
    subprocess under ``OPENSIM_HA=1``: the owner recovers from checkpoint
    and suffix (no list of the stub, no relist, no variant built), prepares
    the twin's base entry on the card and publishes it over /dev/shm (the
    tmpfs must hold two generations); its two workers attach and serve.
    R2's body to each worker's loopback listener: one ``fast_scan`` each,
    the in-process twin's answer, the attach and upload times and the
    request's split from the worker's trace. In this process a
    ``FleetTwinClient`` attaches the owner's control block and a server
    over it answers R2 through ``entry_from_publication`` on the card: the
    in-process twin's answer, its kernel row held against the plain version
    (the returned row). Storm A to the public port: every rider the
    in-process twin's answer. Wave W4 through the stub: both workers attach
    the new generation and answer as the in-process twin. ``simon server
    --standby`` tails the journal to parity; the owner is SIGKILLed; the
    standby takes over (reason expired, epoch 2, no relist, the same two
    workers adopted, none respawned, the generation monotonic), and both
    workers answer as the in-process twin. SIGTERM: the new owner and the
    workers exit 0 with "shutdown complete", and no ``simon-fleet-*``
    segment is left in /dev/shm. Returns the kernel row, with the phase's
    summary under ``fleet``."""
    import ctypes
    import re
    import signal
    import threading

    from opensim_tpu_torch.models import fixtures as fx
    from opensim_tpu_torch.obs.recorder import FLIGHT_RECORDER
    from opensim_tpu_torch.ops import fast_scan as fs
    from opensim_tpu_torch.server import rest
    from opensim_tpu_torch.server.fleet import FleetTwinClient

    server, url, sup, key = twin["server"], twin["url"], twin["sup"], twin["key"]
    stub, kube, bodies, live, jd, root = (twin[k] for k in ("stub", "kube", "bodies", "live", "jd", "root"))
    repo = os.path.dirname(os.path.abspath(__file__))
    _phase(f"68 the serving fleet: simon server --workers {FLEET_WORKERS} --watch on --journal (OPENSIM_HA=1) on "
           f"phase 67's journal; R2 on each worker and from the publication in this process; storm A; W4 "
           f"({FLEET_W4_WAVE} pods ADDED, {FLEET_W4_WAVE} DELETED); simon server --standby, SIGKILL, takeover; "
           "SIGTERM")
    t_phase = time.perf_counter()
    # the fleet's orphans (the workers a SIGKILLed owner leaves, the resource
    # trackers) re-parent to this process, which reaps them: their exit
    # status is read here, and none lingers as a zombie that a new owner
    # would take for a live worker
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:  # PR_SET_CHILD_SUBREAPER
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")
    shm = os.statvfs("/dev/shm")
    shm_total, shm_free = shm.f_frsize * shm.f_blocks, shm.f_frsize * shm.f_bavail
    print(f"/dev/shm: {shm_total} bytes, {shm_free} free; no simon-fleet-* segment: "
          f"{not [n for n in os.listdir('/dev/shm') if n.startswith('simon-fleet-')]}", flush=True)
    port = _fleet_port()
    admin, sb_admin = f"http://127.0.0.1:{port + 1}", f"http://127.0.0.1:{port + 16}"
    env = dict(os.environ, PYTHONPATH=repo, OPENSIM_HA="1", OPENSIM_HA_LEASE_S=str(FLEET_LEASE_S),
               OPENSIM_JOURNAL_FSYNC="always", OPENSIM_BATCH_WINDOW_MS=f"{STORM_WINDOW_S * 1e3:g}")
    lists = lambda: sum(1 for _p, q in stub.requests_seen if "watch" not in q)
    status = lambda base: _http(base, "/api/fleet/status")[2]
    procs, logs, worker_pids, reaped = {}, {}, [], {}

    def start(tag: str, argv: list):
        logs[tag] = root / f"fleet-{tag}.log"
        with open(logs[tag], "w") as fh:
            procs[tag] = subprocess.Popen([sys.executable, "-m", "opensim_tpu_torch", "server", "--kubeconfig", kube,
                                           "--journal", jd, "--port", str(port), *argv, *twin["dev_args"]],
                                          stdout=fh, stderr=subprocess.STDOUT, cwd=repo, env=env)
        return procs[tag]

    def alive(tag: str):
        if procs[tag].poll() is not None:
            raise AssertionError(f"{tag} exited {procs[tag].returncode}: {logs[tag].read_text()[-3000:]}")

    def serving(base: str, tag: str):
        """The owner at `base` published and every worker listens."""
        alive(tag)
        try:
            st = status(base)
            if st.get("role") != "owner" or st["generation"] < 0 or \
                    sum(w["alive"] for w in st["workers"]) < FLEET_WORKERS:
                return False
            return all(_http(f"http://127.0.0.1:{w['internal_port']}", "/healthz")[0] == 200 for w in st["workers"])
        except OSError:
            return False

    def settled(base: str, fp: str) -> dict:
        """Wait until the owner's twin is the relist's (`fp`) and its twin
        generation is the one it last published; returns its status."""
        seen = {}

        def pred():
            seen["status"] = st = status(base)
            seen["twin_generation"] = _metrics_of(base).get(("simon_twin_generation", ()))
            return st["fingerprint"] == fp and st["generation"] == seen["twin_generation"]

        try:
            _wait_for(pred, TWIN_WAIT_S, "the owner to publish the relist's twin")
        except AssertionError as e:
            st = seen.get("status", {})
            raise AssertionError(f"{e}: role {st.get('role')}, epoch {st.get('epoch')}, published generation "
                                 f"{st.get('generation')}, twin generation {seen.get('twin_generation')}, the "
                                 f"relist's fingerprint: {st.get('fingerprint') == fp}") from None
        return status(base)

    def role(base: str, want: str, flag: str = "") -> bool:
        """The process behind `base` answers in role `want` (and `flag`
        holds in its status); the standby must stay up meanwhile."""
        alive("standby")
        try:
            st = status(base)
        except OSError:
            return False
        return st.get("role") == want and (not flag or st.get(flag) is True)

    lease_file = Path(jd) / "ha-lease.json"
    lease_gap = {"max_s": 0.0, "stop": threading.Event()}

    def watch_lease():
        """The owner's longest gap between lease renewals, read from the
        lease file until the SIGKILL: a gap past FLEET_LEASE_S would let
        the standby take over from a live owner."""
        while not lease_gap["stop"].wait(0.1):
            with contextlib.suppress(OSError, ValueError):
                doc = json.loads(lease_file.read_text())
                if doc.get("epoch") == 1 and not doc.get("released"):
                    lease_gap["max_s"] = max(lease_gap["max_s"], time.time() - float(doc["renewed_at"]))

    def reap(pid: int):
        try:
            reaped[pid] = os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1])
        except ChildProcessError as e:
            reaped[pid] = e

    summary = {}
    try:
        # storm A at the fleet's public port, later, and at the in-process twin
        storm = fx.storm_requests(N_PODS)
        paths = ["/api/deploy-apps" if kind == "deploy" else "/api/scale-apps" for kind, _b, _e in storm]

        def storm_at(base: str) -> tuple:
            answers = [None] * len(storm)

            def send(i):
                answers[i] = _http(base, paths[i], storm[i][1])

            threads = [threading.Thread(target=send, args=(i,)) for i in range(len(storm))]
            t2 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(TWIN_WAIT_S)
            return answers, time.perf_counter() - t2

        lists0 = lists()
        t_owner = time.perf_counter()
        owner = start("owner", ["--watch", "on", "--workers", str(FLEET_WORKERS)])
        # the standby starts beside the owner and tails the journal while the
        # fleet serves; meanwhile the in-process twin answers R2 and storm A
        standby = start("standby", ["--standby", "--watch", "on", "--workers", str(FLEET_WORKERS)])
        t_standby = time.perf_counter()
        inproc = _twin_request(server, url, "R2 on the in-process twin (phase 68)", bodies["deploy"], key())
        twin_answers, twin_rt = storm_at(url)
        _wait_for(lambda: serving(admin, "owner"), TWIN_START_S, "the fleet to serve")
        summary["start_s"] = time.perf_counter() - t_owner
        threading.Thread(target=watch_lease, daemon=True).start()
        st = status(admin)
        workers = st["workers"]
        worker_pids[:] = [w["pid"] for w in workers]
        m = _metrics_of(admin)
        recovered = re.search(r"generation (\d+) \(checkpoint (\d+) \+ (\d+) replayed", logs["owner"].read_text())
        if m.get(("simon_journal_recoveries_total", (("outcome", "restored"),))) != 1 or \
                m.get(("simon_watch_relists_total", ())) != 0 or lists() != lists0 or recovered is None:
            raise AssertionError("the fleet owner did not recover from the journal alone: "
                                 f"{ {k: v for k, v in m.items() if 'journal' in k[0] or 'relist' in k[0]} }, "
                                 f"{lists() - lists0} lists, {recovered and recovered.group(0)}")
        if {p.name: p.stat().st_mtime_ns for p in Path(fs.BUILD_DIR).glob("*.so")} != twin["built"]:
            raise AssertionError("the fleet rebuilt or added kernel variants")
        fp_ = st["shm"]
        print(f"fleet: owner serving {summary['start_s']:.3f} s after its start (recovered {recovered.group(0)}; no "
              f"list, no relist, no variant built); generation {st['generation']}, epoch {st['epoch']}, control "
              f"{st['control']}; publisher footprint {json.dumps(fp_)}; /dev/shm {shm_total} bytes "
              f"({card})", flush=True)
        if 2 * fp_["bytes"] > shm_total:
            raise AssertionError(f"/dev/shm ({shm_total} bytes) cannot hold two generations of the publication "
                                 f"({fp_['bytes']} bytes in {fp_['segments']} segments each)")
        summary["footprint"] = fp_

        # R2 on both workers and, at the same time, in this process from the
        # same publication: the worker's path, then the kernel row of its
        # launch on a quiet card
        first_wait = _on_workers(workers, bodies["deploy"], "R2 on a fleet worker", f"fleet|{st['generation']}")
        client = FleetTwinClient(st["control"], device=device)
        local = rest.SimonServer(watch=client, device=device, admission=False, capacity=False)
        try:
            if not client.start(wait_s=30.0):
                raise AssertionError("no publication to attach in this process")
            _reset_launches()
            t1 = time.perf_counter()
            code, got = local.deploy_apps(json.loads(json.dumps(bodies["deploy"])), request_id="fleet-attach-r2")
            attach_rt = time.perf_counter() - t1
            launches = dict(fs.VARIANT_LAUNCHES)
            tr = FLIGHT_RECORDER.get("fleet-attach-r2")
            (ev,) = [sp for sp in tr.walk() if sp.name == "fleet.attach"]
            if code != 200 or launches != {"fast_scan": 1} or \
                    tr.root.attrs.get("twin_key") != f"fleet|{st['generation']}":
                raise AssertionError(f"R2 from the publication: HTTP {code}, launches {launches}: {str(got)[:300]}")
            _same_answer(got, inproc["answer"], "R2 from the publication in this process vs the in-process twin's")
            (entry,) = [e for e in local.prep_cache.entries_snapshot()
                        if e.key.startswith(f"fleet|{st['generation']}|deploy|")]
            print(f"R2 from the publication in this process, beside the workers': {attach_rt:.6f} s (attach "
                  f"{ev.attrs['attach_s']} s, upload to the card {ev.attrs['upload_s']} s), launches {launches}, the "
                  "in-process twin's answer", flush=True)
            first = first_wait()
            for g in first:
                _same_answer(g["answer"], inproc["answer"], "a fleet worker's R2 vs the in-process twin's")
            summary["first"] = [{k: g[k] for k in ("rt", "attach_s", "upload_s", "split")} for g in first]
            row = _server_row("fleet attach: R2 from the publication", entry, False, launches["fast_scan"], attach_rt)
            row["fleet_attach"] = {"attach_s": ev.attrs["attach_s"], "upload_s": ev.attrs["upload_s"],
                                   "request_s": attach_rt}
        finally:
            local.close()
            del local, client

        fleet_answers, fleet_rt = storm_at(f"http://127.0.0.1:{port}")
        batches = []
        for (kind, body, explain), got, want in zip(storm, fleet_answers, twin_answers):
            if got is None or got[0] != 200 or want is None or want[0] != 200 or \
                    _storm_canon(got[2]) != _storm_canon(want[2]):
                raise AssertionError(f"storm A through the fleet, {_rider(body, explain)}: {str(got)[:300]}")
            rid = got[1].get("X-Simon-Request-Id", "")
            for w in workers:
                code, _h, tree, _rt = _http(f"http://127.0.0.1:{w['internal_port']}", f"/api/debug/requests/{rid}")
                if code == 200:
                    batches.append((w["index"], tree["spans"].get("attrs", {}).get("batch_size")))
        summary["storm"] = {"fleet_rt_s": fleet_rt, "twin_rt_s": twin_rt, "rider_rt_s": [a[3] for a in fleet_answers],
                            "worker_batch": batches}
        print(f"storm A through the fleet's public port: {len(storm)} riders answered 200 in {fleet_rt:.6f} s, each "
              f"the in-process twin's answer (its storm {twin_rt:.6f} s); (worker, batch size) per rider {batches}",
              flush=True)

        # W4 through the stub: the owner folds and republishes, the workers
        # attach the new generation on their next request
        w4 = fx.twin_wave(live, N_NODES, FLEET_W4_WAVE, FLEET_W4_WAVE, tag="w4")
        t3 = time.perf_counter()
        fx.send_wave(stub, w4)
        _wait_for(lambda: len(sup.twin.materialize().pods) == len(live), TWIN_WAIT_S, "W4 in the in-process twin")
        fresh, fp = _relisted(kube)
        del fresh
        _wait_for(lambda: sup.twin.fingerprint() == fp, TWIN_WAIT_S, "the in-process twin to settle after W4")
        inproc4 = _twin_request(server, url, "R2 on the in-process twin after W4", bodies["deploy"], key())
        st4 = settled(admin, fp)
        published_s = time.perf_counter() - t3
        if st4["generation"] <= st["generation"]:
            raise AssertionError(f"W4 published generation {st4['generation']} after {st['generation']}")
        after = _on_workers(workers, bodies["deploy"], "R2 on a fleet worker after W4", f"fleet|{st4['generation']}")()
        for w, g in zip(workers, after):
            _same_answer(g["answer"], inproc4["answer"], "a fleet worker's R2 after W4 vs the in-process twin's")
            m = _metrics_of(f"http://127.0.0.1:{w['internal_port']}")
            if m.get(("simon_fleet_attach_generation", ())) != st4["generation"]:
                raise AssertionError(f"worker {w['index']} attached {m.get(('simon_fleet_attach_generation', ()))}")
        m = _metrics_of(admin)
        if m.get(("simon_fleet_respawns_total", ())) != 0:
            raise AssertionError(f"{m.get(('simon_fleet_respawns_total', ()))} worker respawns")
        fresh_stages = {s: [m.get(("simon_fleet_freshness_seconds_count", (("stage", s),))),
                            m.get(("simon_fleet_freshness_seconds_sum", (("stage", s),)))]
                        for s in ("journaled", "published", "attached", "served")}
        pub_s = [m.get(("simon_fleet_publish_seconds_count", ())), m.get(("simon_fleet_publish_seconds_sum", ()))]
        summary["W4"] = {"events": len(w4), "event_to_published_s": published_s, "generation": st4["generation"],
                         "after": [{k: g[k] for k in ("rt", "attach_s", "upload_s", "split")} for g in after],
                         "freshness": fresh_stages, "publish_seconds": pub_s}
        print(f"W4: {len(w4)} events; the owner published the relist's twin (generation {st4['generation']}) "
              f"{published_s:.3f} s after the first was sent; both workers attached it and answer as the in-process "
              f"twin; freshness by stage [count, sum s] {json.dumps(fresh_stages)}; publishes [count, sum s] {pub_s}; "
              f"0 respawns", flush=True)

        # the hot standby (started beside the owner): at parity, then the
        # owner SIGKILLed
        _wait_for(lambda: role(sb_admin, "standby", "at_parity"), TWIN_START_S, "the standby to tail to parity")
        summary["standby_parity_s"] = time.perf_counter() - t_standby
        g_old = status(admin)["generation"]
        lists0 = lists()  # this process's relists above were the check's
        lease_gap["stop"].set()
        summary["lease_gap_max_s"] = lease_gap["max_s"]
        if lease_gap["max_s"] >= FLEET_LEASE_S:
            raise AssertionError(f"the live owner left its lease unrenewed for {lease_gap['max_s']:.3f} s")
        owner.kill()  # SIGKILL: no flush, no lease release
        owner.wait(30)
        t4 = time.perf_counter()
        reapers = [threading.Thread(target=reap, args=(pid,), daemon=True) for pid in worker_pids]
        for t in reapers:
            t.start()
        summary["takeover_s"] = _wait_for(lambda: role(sb_admin, "owner"), TWIN_WAIT_S, "the standby to take over")
        _wait_for(lambda: status(sb_admin)["shm"]["publishes"] >= 1, TWIN_WAIT_S, "the new owner's first publication")
        st6 = status(sb_admin)
        summary["takeover_published_s"] = time.perf_counter() - t4
        m = _metrics_of(sb_admin)
        adopted = sorted(w["pid"] for w in st6["workers"] if w["adopted"] and w["alive"])
        if st6["epoch"] != 2 or m.get(("simon_fleet_takeovers_total", (("reason", "expired"),))) != 1 or \
                m.get(("simon_watch_relists_total", ())) != 0 or lists() != lists0 or \
                adopted != sorted(worker_pids) or m.get(("simon_fleet_respawns_total", ())) != 0 or \
                st6["generation"] < g_old:
            raise AssertionError(f"the takeover: epoch {st6['epoch']}, adopted {adopted} of {worker_pids}, generation "
                                 f"{st6['generation']} after {g_old}, {lists() - lists0} lists, metrics "
                                 f"{ {k: v for k, v in m.items() if 'takeover' in k[0] or 'relist' in k[0] or 'respawn' in k[0]} }")
        st6 = settled(sb_admin, fp)
        took = _on_workers(st6["workers"], bodies["deploy"], "R2 on a fleet worker after the takeover",
                           f"fleet|{st6['generation']}")()
        for g in took:
            _same_answer(g["answer"], inproc4["answer"], "a fleet worker's R2 after the takeover vs the in-process "
                                                         "twin's")
        summary["takeover"] = {"generation": [g_old, st6["generation"]],
                               "after": [{k: g[k] for k in ("rt", "attach_s", "upload_s", "split")} for g in took]}
        print(f"takeover: the standby owned the fleet {summary['takeover_s']:.3f} s after the SIGKILL (lease "
              f"{FLEET_LEASE_S:g} s) and published {summary['takeover_published_s']:.3f} s after it; epoch 2, "
              f"reason expired, no list, no relist, workers {adopted} adopted, 0 respawns, generation {g_old} -> "
              f"{st6['generation']}; both workers answer as the in-process twin; the standby at parity "
              f"(checked {summary['standby_parity_s']:.3f} s after its start); the live owner's longest gap "
              f"between lease renewals {summary['lease_gap_max_s']:.3f} s (lease {FLEET_LEASE_S:g} s)", flush=True)

        # SIGTERM: workers first, then the owner; nothing left in /dev/shm
        standby.send_signal(signal.SIGTERM)
        rc = standby.wait(120)
        for t in reapers:
            t.join(60)
        out = logs["standby"].read_text()
        workers_log = logs["owner"].read_text()
        if rc != 0 or "simon fleet: shutdown complete" not in out or \
                any(reaped.get(pid) != 0 or f"simon server[worker {pid}]: shutdown complete" not in workers_log
                    for pid in worker_pids):
            raise AssertionError(f"SIGTERM: owner exit {rc}, workers {reaped}: {out[-2000:]}")
        _wait_for(lambda: not [n for n in os.listdir("/dev/shm") if n.startswith("simon-fleet-")], TWIN_WAIT_S,
                  "no simon-fleet-* segment in /dev/shm")
        print(f"SIGTERM: the workers {worker_pids} and the owner exited 0 with \"shutdown complete\"; no "
              f"simon-fleet-* segment left in /dev/shm", flush=True)
    except BaseException:
        # what the fleet's processes said, for the failure's diagnosis
        for tag, path in logs.items():
            with contextlib.suppress(OSError):
                print(f"--- {tag} log (tail) ---\n{path.read_text()[-6000:]}", flush=True)
        raise
    finally:
        lease_gap["stop"].set()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        for pid in worker_pids:
            if pid not in reaped:
                with contextlib.suppress(OSError):
                    os.kill(pid, signal.SIGKILL)
        _reap_orphans()
    print(f"fleet phase {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    row["fleet"] = summary
    return row


def _reap_orphans() -> None:
    """Reap the zombies re-parented to this process (the fleet's resource
    trackers and workers): a zombie is already dead; waiting for it frees
    its process entry."""
    me = os.getpid()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] == "Z" and int(fields[1]) == me:
            with contextlib.suppress(ChildProcessError):
                os.waitpid(int(entry), os.WNOHANG)


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
         "fast_scan", PLAN_PLAIN_PODS),
        ("7-9 all-GPU-share plan", lambda: (fx.gpu_cluster(N_NODES), fx.gpu_apps(N_PODS)),
         "fast_scan[gpu,gc]", PLAN_PLAIN_PODS),
        ("10-12 affinity-heavy plan", lambda: (fx.synthetic_cluster(N_NODES), fx.affinity_apps(N_PODS)),
         "fast_scan[interpod]", PLAN_PLAIN_PODS),
        ("13-15 score-table plan", lambda: (fx.score_cluster(N_NODES), fx.score_apps(N_PODS)),
         "fast_scan[na,tt,avoid]", PLAN_PLAIN_PODS),
        ("16-18 host-port plan", lambda: (fx.score_cluster(N_NODES), fx.score_apps(N_PODS, host_port=True)),
         "fast_scan[na,tt,avoid,ports]", PLAN_PLAIN_PODS),
        ("19-21 all-local-PV plan", lambda: (fx.local_pv_cluster(N_NODES), fx.local_pv_apps(N_PODS)),
         "fast_scan[local]", PLAN_PLAIN_PODS),
    ]

    _phase("2 build")
    small = [fi for _n, _p, fi in _small_preps("cpu")]
    variants = sorted({v for *_rest, v, _p in plans} | {fs.variant_name(fi) for fi in small}
                      | {v for *_rest, v in EXAMPLES} | set(CFG_VARIANTS) | set(EXPLAIN_VARIANTS) | {CAMPAIGN_VARIANT}
                      | {_explain_name(v) for *_rest, v in EXAMPLES} | {"fast_scan[count]"}
                      | {fs.variant_name(fi, count=True) for fi in small}
                      | {fs.variant_name(fi, explain=True) for fi in small})
    fs.build(variants)
    print(f"build: {fs.BUILD_LOG['seconds']:.3f} s for {len(variants)} kernel variants, one nvcc each, "
          f"all started together: {', '.join(variants)}")
    for name, entry in fs.BUILD_LOG["variants"].items():
        secs = "cached" if entry["seconds"] is None else f"nvcc {entry['seconds']:.3f} s"
        print(f"  {name}: {secs}, ptxas {json.dumps(fs.ptxas_report(entry['ptxas']))}")

    _phase("3 small cases: kernel vs plain version, one scan and a sweep of drains each")
    small_cases(device)

    rows = [full_plan(device, label, make, variant, prefix, replay=variant == "fast_scan[interpod]")
            for label, make, variant, prefix in plans]
    row, drain_plans, drain_grid = drain_sweep(device)
    rows.append(row)
    rows.extend(oversubscribed_plan(device))
    apply_rows, apply_tail = apply_plan(device, card)
    rows.extend(apply_rows)
    example_reports(device)
    apply_tail()  # phase 29's hog pods, held against their plain version on the CPU meanwhile
    rows.append(full_plan(device, "31-33 config plan", lambda: (fx.score_cluster(N_NODES, blocked=10),
                                                                fx.score_apps(N_PODS, widget=True)),
                          "fast_scan[na,tt,avoid,cfg]", CFG_PLAIN_PODS, sched_text=fx.SCHED_CONFIG_PLAN))
    rows.append(two_profile_plan(device))
    rows.append(full_plan(device, "37-39 sampled plan", lambda: (fx.synthetic_cluster(N_NODES), fx.synthetic_apps(N_PODS)),
                          "fast_scan[sample]", SAMPLED_PLAIN_PODS, tie_seed=TIE_SEED))
    rows.extend(apply_config_plan(device, card))
    rows.append(explain_plan(device, "42-43 affinity-heavy plan at maxSkew 1",
                             lambda: (fx.synthetic_cluster(N_NODES), fx.affinity_apps(N_PODS, max_skew=1)),
                             "fast_scan[interpod,explain]", rejects=True))
    rows.append(explain_plan(device, "44-45 all-GPU-share plan", lambda: (fx.gpu_cluster(N_NODES), fx.gpu_apps(N_PODS)),
                             "fast_scan[gpu,gc,explain]"))
    rows.append(explain_oversubscribed(device))
    rows.append(explain_capacity(device))
    rows.append(apply_explain(device, card))
    server_rows, served = server_plan(device, card)
    rows.extend(server_rows)
    try:
        steady_phase(device)
        kubeconfig_apply(device)
        rows.append(defrag_cli(device, card, drain_plans, drain_grid))
        rows.extend(observatory(device, card, served))
        rows.extend(campaign_plan(device, card, served))
        counting_small_cases(device)
        rows.extend(storm_plan(device, card, served))
        rows.extend(twin_plan(device, card, served))
    finally:
        served["close"]()
    print(f"smoke run {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
