"""Scenario-batch what-if evaluation — the port of
``opensim_tpu/parallel/scenarios.py``.

A batch of scenarios (candidate node counts, drain plans) shares one
encoded cluster and differs only in its node-validity, pod-validity and
forced masks. On a card the whole batch is one launch of the bind-scan
kernel's scenario grid, B scenarios in lockstep per block
(``ops/fast_scan.fast_scan_sweep``); on the
CPU the plain version runs scenario by scenario. A scheduler config runs
in the grid as its launch arguments; a stream of differing profiles runs
one grid per contiguous segment, each scenario going on from its own state
(:func:`sweep_segmented`). A mesh of several devices raises (ROADMAP
Queue 1 item 9).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..engine import fastpath
from ..engine.schedconfig import DEFAULT_CONFIG, resolve_profile_segments


class SweepResult(NamedTuple):
    unscheduled: np.ndarray  # [S] i32 unscheduled pod count per scenario
    used: np.ndarray  # [S, N, R] f32 final per-node usage
    chosen: np.ndarray  # [S, P] i32
    vg_used: np.ndarray  # [S] f32 VG bytes allocated on the scenario's valid nodes


def count_masks(prep, n_real: int, ks) -> "tuple[np.ndarray, np.ndarray]":
    """The masks of a candidate new-node count sweep over a prepared arena:
    scenario s enables the first ``n_real + ks[s]`` nodes of the prepared
    node axis (``node_valid [S, N]``), and DaemonSet pods pinned to a
    disabled candidate node leave that scenario's stream (``pod_valid [S,
    P]``): a smaller expansion would never have created them."""
    N = int(np.asarray(prep.ec_np.node_valid).shape[0])
    ks = np.asarray(ks, dtype=np.int64)
    node_valid = np.arange(N)[None, :] < (n_real + ks)[:, None]
    pod_valid = np.ones((len(ks), len(prep.ordered)), dtype=bool)
    on_candidate = np.flatnonzero(prep.ds_target >= n_real)  # DaemonSet pods pinned to a candidate node
    pod_valid[:, on_candidate] = node_valid[:, prep.ds_target[on_candidate]]
    return node_valid, pod_valid


def sweep_counts(prep, n_real: int, ks, config=None) -> "tuple[SweepResult, np.ndarray]":
    """Candidate new-node count sweep over a prepared arena, one scenario a
    count (:func:`count_masks`). Returns (SweepResult, node_valid_masks)."""
    node_valid, pod_valid = count_masks(prep, n_real, ks)
    return sweep_auto(prep, node_valid, pod_valid, config=config), node_valid


def sweep_auto(
    prep,
    node_valid_masks: np.ndarray,
    pod_valid_masks: np.ndarray,
    forced_masks: Optional[np.ndarray] = None,
    config=None,
    mesh=None,
) -> SweepResult:
    """Run a scenario sweep on the prepared input's device: every scenario
    in one kernel launch on a card, the plain version on the CPU. Without
    `forced_masks` every scenario keeps the stream's forced pods. `config`
    (a ``SchedulerConfig`` or ``SchedulerProfiles``) routes as
    ``simulate()`` does (``opensim_tpu/parallel/scenarios.py:106-130``):
    pods of an unknown profile leave every scenario, differing profiles
    run :func:`sweep_segmented`, one effective config runs one grid.
    Raises ``NotImplementedError`` outside the kernel's envelope and for a
    mesh of devices (ROADMAP Queue 1 item 9). Nothing falls back to
    another engine."""
    if mesh is not None:
        raise NotImplementedError("a sweep over a mesh of several devices: ROADMAP Queue 1 item 9, not yet ported")
    S = np.asarray(node_valid_masks).shape[0]
    if forced_masks is None:
        forced_masks = np.broadcast_to(prep.forced, (S, len(prep.forced)))
    if config is not None:
        segs, invalid = resolve_profile_segments(config, prep.ordered, prep.meta.resource_names, forced=prep.forced)
        if invalid:
            pod_valid_masks = np.array(pod_valid_masks, copy=True)
            pod_valid_masks[:, list(invalid)] = False
        distinct = {c for c, _, _ in segs if c is not None and c != DEFAULT_CONFIG}
        if len(segs) > 1 and distinct:
            return sweep_segmented(prep, segs, node_valid_masks, pod_valid_masks, np.asarray(forced_masks, dtype=bool))
        config = distinct.pop() if distinct else None
    miss = fastpath.why_not(prep, config)
    if miss is not None:
        raise NotImplementedError(f"outside the port's bind-scan envelope: {miss}")
    return SweepResult(*fastpath.sweep(prep, node_valid_masks, pod_valid_masks, forced_masks,
                                       segments=[(config, 0, len(prep.tmpl_ids))]))


def sweep_segmented(
    prep,
    segments,
    node_valid_masks: np.ndarray,
    pod_valid_masks: np.ndarray,
    forced_masks: np.ndarray,
) -> SweepResult:
    """Scenario sweep over a stream of differing scheduler profiles:
    ``simulate()``'s segmented path on the scenario axis
    (``opensim_tpu/parallel/scenarios.py:220-311``). `segments` are
    ``[(config, lo, hi)]``, contiguous same-profile runs covering the
    stream in order; each is one launch of the scenario grid on its
    config's inputs, every scenario starting from its own final state of
    the run before, so each scenario's placements equal a segmented
    ``simulate()`` of its sub-cluster."""
    for cfg in {c for c, _, _ in segments}:
        miss = fastpath.why_not(prep, cfg)
        if miss is not None:
            raise NotImplementedError(f"outside the port's bind-scan envelope: {miss}")
    return SweepResult(*fastpath.sweep(prep, node_valid_masks, pod_valid_masks, forced_masks, segments=segments))
