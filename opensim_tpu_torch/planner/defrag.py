"""Node-drain what-if sweeps — the port of ``opensim_tpu/planner/defrag.py``.

Scenario s drains node d_s: the node leaves ``node_valid``, the DaemonSet
pods pinned to it leave the stream, and the pods bound to it by name lose
their pin, so the scan places them on the remaining nodes under the full
plugin rules. All scenarios run as one sweep (``parallel/scenarios``): one
kernel launch on a card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike
from ..encoding.vocab import RES_CPU, RES_MEMORY
from ..engine.simulator import AppResource, Prepared, prepare
from ..models.objects import ResourceTypes
from ..parallel import scenarios


@dataclass
class DrainPlan:
    node: str
    feasible: bool
    unscheduled: int
    # total cpu-milli + memory freed if the drain succeeds
    freed_cpu_milli: float = 0.0
    freed_memory: float = 0.0


@dataclass
class DefragResult:
    """The plans, and host-clock phase times in seconds (``timings``:
    prepare, masks, sweep with its copies back)."""

    plans: List[DrainPlan] = field(default_factory=list)
    timings: Dict[str, float] = field(default_factory=dict, compare=False)

    def drainable(self) -> List[DrainPlan]:
        return [p for p in self.plans if p.feasible]


def drain_masks(prep: Prepared, drained: Sequence[int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(node_valid [S, N], pod_valid [S, P], forced [S, P]) of the scenarios
    that drain node ``drained[s]`` each, built from arrays: a DaemonSet pod
    pinned to the drained node leaves the stream; any other pod bound to it
    by name is released (``opensim_tpu/planner/defrag.py:74-80``, in that
    order of rules)."""
    d = np.asarray(drained, dtype=np.int64)[:, None]  # [S, 1]
    N = int(np.asarray(prep.ec_np.node_valid).shape[0])
    node_valid = np.asarray(prep.ec_np.node_valid, dtype=bool)[None, :] & (np.arange(N)[None, :] != d)
    name_to_idx = {n: i for i, n in enumerate(prep.meta.node_names)}
    # each forced pod's node, -1 for a name that is no node, -2 unforced
    bound = np.array(
        [name_to_idx.get(p.spec.node_name, -1) if f else -2 for p, f in zip(prep.ordered, prep.forced)],
        dtype=np.int64,
    )
    pinned = prep.ds_target[None, :] == d
    pod_valid = ~pinned
    forced = prep.forced[None, :] & ~((bound[None, :] == d) & ~pinned)
    return node_valid, pod_valid, forced


def plan_drains(
    cluster: ResourceTypes,
    apps: Optional[List[AppResource]] = None,
    candidates: Optional[Sequence[str]] = None,
    prep: Optional[Prepared] = None,
    device: DeviceLike = None,
) -> DefragResult:
    """Evaluate draining each candidate node (default: every node) as one
    batch of scenarios on `device` (the card unless the caller names
    another); returns which drains keep every pod schedulable."""
    t0 = time.perf_counter()
    if prep is None:
        prep = prepare(cluster, apps or [], device=device)
    if prep is None:
        return DefragResult()
    t1 = time.perf_counter()

    names = prep.meta.node_names
    name_to_idx = {n: i for i, n in enumerate(names)}
    cand = list(candidates) if candidates is not None else list(names)
    cand_idx = [name_to_idx[c] for c in cand if c in name_to_idx]
    if not cand_idx:
        return DefragResult()

    node_valid, pod_valid, forced = drain_masks(prep, cand_idx)
    t2 = time.perf_counter()
    res = scenarios.sweep_auto(prep, node_valid, pod_valid, forced_masks=forced)
    t3 = time.perf_counter()
    alloc = np.asarray(prep.ec_np.alloc)
    return DefragResult(timings={"prepare": t1 - t0, "masks": t2 - t1, "sweep": t3 - t2}, plans=[
        DrainPlan(
            node=names[d],
            feasible=bool(res.unscheduled[s] == 0),
            unscheduled=int(res.unscheduled[s]),
            freed_cpu_milli=float(alloc[d, RES_CPU]),
            freed_memory=float(alloc[d, RES_MEMORY]),
        )
        for s, d in enumerate(cand_idx)
    ])
