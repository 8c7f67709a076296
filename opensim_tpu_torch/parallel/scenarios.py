"""Scenario-batch what-if evaluation — the port of
``opensim_tpu/parallel/scenarios.py``.

A batch of scenarios (candidate node counts, drain plans) shares one
encoded cluster and differs only in its node-validity, pod-validity and
forced masks. On a card the whole batch is one launch of the bind-scan
kernel's scenario grid, B scenarios in lockstep per block
(``ops/fast_scan.fast_scan_sweep``); on the
CPU the plain version runs scenario by scenario. This slice has the
single-device kernel route only: a scheduler config, segmented profiles
and a mesh of several devices raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..engine import fastpath


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
    `forced_masks` every scenario keeps the stream's forced pods. Raises
    ``NotImplementedError`` outside the kernel's envelope, for a scheduler
    config (and its segmented profiles) and for a mesh of devices: later
    slices of the port. Nothing falls back to another engine."""
    if config is not None:
        raise NotImplementedError(
            "a scheduler config (weights, disables, segmented profiles) in a sweep: a later slice of the port"
        )
    if mesh is not None:
        raise NotImplementedError("a sweep over a mesh of several devices: a later slice of the port")
    miss = fastpath.why_not(prep)
    if miss is not None:
        raise NotImplementedError(f"outside the port's bind-scan envelope: {miss}")
    S = np.asarray(node_valid_masks).shape[0]
    if forced_masks is None:
        forced_masks = np.broadcast_to(prep.forced, (S, len(prep.forced)))
    return SweepResult(*fastpath.sweep(prep, node_valid_masks, pod_valid_masks, forced_masks))
