"""Graft entry points of the port — the counterpart of ``__graft_entry__.py``.

``entry()`` gives the flagship computation as a function and its example
arguments: the torch reference scan (``engine/scheduler.schedule_pods``,
``ops/kernels.pod_step`` and ``bind_update`` pod by pod) over a tiny
encoded cluster.

``dryrun_multichip(n)`` runs the whole capacity-planning step with its
scenario axis split over n devices: S = 2·n drain-like scenarios, each
with fewer valid nodes, through ``parallel/scenarios.sweep_auto`` (one
launch of the scenario grid per shard on a card), then the reference's
reductions across scenarios on the host: the unscheduled pods of each, and
the feasible plan of least total usage.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .engine import scheduler
from .engine.simulator import AppResource, Prepared, prepare
from .models import ResourceTypes
from .models import fixtures as fx
from .parallel import scenarios


def _tiny_prepared(n_nodes: int = 8, n_pods: int = 64, device: DeviceLike = None) -> Prepared:
    """``__graft_entry__.py:36-73``'s cluster and apps: `n_nodes` nodes in
    two zones, half the pods plain, half under a hard zone spread; on
    `device` (the card unless the caller names another)."""
    cluster = ResourceTypes()
    for i in range(n_nodes):
        cluster.nodes.append(fx.make_fake_node(f"node-{i}", "64", "128Gi", "110",
                                               fx.with_labels({"topology.kubernetes.io/zone": f"z{i % 2}"})))
    app = ResourceTypes()
    app.deployments.append(fx.make_fake_deployment("graft-a", n_pods // 2, "500m", "1Gi"))
    app.deployments.append(fx.make_fake_deployment("graft-b", n_pods // 2, "250m", "512Mi", fx.with_topology_spread([{
        "maxSkew": 2,
        "topologyKey": "topology.kubernetes.io/zone",
        "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "graft-b"}},
    }])))
    prep = prepare(cluster, [AppResource("graft", app)], device=device)
    if prep is None:
        raise RuntimeError("the tiny cluster expanded to no pods")
    return prep


def _scan(ec, st0, tmpl_ids, pod_valid, forced) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan body over the whole stream under every feature and the
    default config, as ``__graft_entry__.py:91-102`` scans ``_step``:
    (chosen [P] i32, final usage [N, R] f32)."""
    out = scheduler.schedule_pods(ec, st0, tmpl_ids, pod_valid, forced)
    return out.chosen, out.final_state.used


def entry(device: DeviceLike = None):
    """(fn, example_args): the scheduling scan on the flagship path and its
    inputs, tensors on `device` (the card unless the caller names the
    CPU)."""
    prep = _tiny_prepared(device=resolve_device(device))
    pod_valid = np.ones((len(prep.ordered),), dtype=bool)
    return _scan, (prep.ec, prep.st0, prep.tmpl_ids, pod_valid, prep.forced)


def dryrun_multichip(n_devices: int, devices: Optional[List[DeviceLike]] = None) -> Tuple[List[int], int]:
    """Run the capacity-planning step with its scenario axis split over
    `devices` (default: the first `n_devices` cards; raises when there are
    fewer), on tiny shapes. Prints the reference's line and returns (the
    unscheduled pods of each scenario, the index of the feasible scenario
    of least total usage)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    prep = _tiny_prepared(device=devices[0])
    # progressively smaller clusters, two scenarios a device slot
    # (__graft_entry__.py:125-132)
    n_real = int(prep.ec_np.node_valid.sum())
    S = n_devices * 2
    node_valid = np.zeros((S, len(prep.ec_np.node_valid)), dtype=bool)
    for s in range(S):
        node_valid[s, : max(2, n_real - (s % max(n_real - 1, 1)))] = True
    pod_valid = np.ones((S, len(prep.ordered)), dtype=bool)
    res = scenarios.sweep_auto(prep, node_valid, pod_valid, mesh=devices)
    unscheds = res.unscheduled
    # the cross-scenario reduction: the cheapest plan that places every pod
    loads = res.used.reshape(S, -1).sum(axis=1, dtype=np.float64)
    best = int(np.argmin(np.where(unscheds == 0, loads, np.inf)))
    print(f"dryrun_multichip: {n_devices} devices, {S} scenarios, "
          f"unscheduled per scenario={unscheds.tolist()}, best={best}")
    return unscheds.tolist(), best
