"""The torch reference scan: the port of ``opensim_tpu/engine/scheduler.py``.

``schedule_pods`` drives the pod stream through ``ops/kernels.pod_step``
and ``kernels.bind_update`` one pod at a time, a Python loop over torch
ops on any device: the counterpart of the JAX package's XLA scan, whose
step it follows op for op. It is not the bind-scan kernel's plain version
(that is ``ops/fast_scan.fast_scan_reference``, which follows the Pallas
kernel); it runs what no kernel can: out-of-tree plugins
(``extra_plugins``, torch callables), on the CPU only
(``simulator.simulate``), and it is the scan the deep explainer
(``engine/explain.py``) re-scores one step of.

Pre-bound pods (``spec.nodeName``) skip the pipeline and land on their
node; a pod that is not valid runs the pipeline (its counts are kept, as
the reference keeps them) and binds nowhere. ``tie_seed`` takes each
step's node among its best scores by the highest Philox-4x32-10 draw at
(pod, node), then the lowest index: the draw of the sampled bind-scan
kernel (``fast_scan.philox_draws``), which matches the reference's
``jax.random`` choice in distribution, as that cannot be reproduced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..encoding.state import EncodedCluster, ScanState
from ..ops import kernels
from ..ops.fast_scan import DRAW_CHUNK, philox_draws


class ScheduleOutput(NamedTuple):
    chosen: torch.Tensor  # [P] i32 node index, -1 unscheduled
    fail_counts: torch.Tensor  # [P, NUM_FILTERS - F_PORTS] i32 first-fail counts of the dynamic filters
    insufficient: torch.Tensor  # [P, R] i32 nodes short of each resource
    gpu_take: torch.Tensor  # [P, Gd] f32 GPU slots packed per device
    static_fail: torch.Tensor  # [U, 4] i32 first-fail counts of the static filters
    final_state: ScanState


def schedule_pods(
    ec: EncodedCluster,
    st0: ScanState,
    tmpl_ids,
    pod_valid,
    forced,
    features: kernels.Features = kernels.ALL_FEATURES,
    config=None,
    extra_plugins: tuple = (),
    tie_seed: Optional[int] = None,
    explain: bool = False,
    draw_base: int = 0,
) -> ScheduleOutput:
    """Run the scan over ``tmpl_ids``/``pod_valid``/``forced`` ([P]
    sequences) from state `st0` (not changed) on the cluster's device.
    The static tables come from ``kernels.static_tables`` under `config`.
    `explain` counts every step's rejections, not only a failing step's.
    `tie_seed` samples the ties, the draws' pod counter starting at
    `draw_base`."""
    from .schedconfig import DEFAULT_CONFIG

    config = config or DEFAULT_CONFIG
    stat = kernels.static_tables(ec, config)
    dev = ec.node_valid.device
    tmpl = [int(u) for u in np.asarray(tmpl_ids)]
    valid = [bool(x) for x in np.asarray(pod_valid)]
    forced_h = [bool(x) for x in np.asarray(forced)]
    P, N = len(tmpl), ec.node_valid.shape[0]
    n_dyn = kernels.NUM_FILTERS - kernels.F_PORTS
    R, Gd = ec.alloc.shape[1], st0.gpu_free.shape[1]
    st = ScanState(*(t.clone() for t in st0))
    pin = ec.pin.tolist()
    chosen = torch.full((P,), -1, dtype=torch.int32)
    fail_counts = torch.zeros((P, n_dyn), dtype=torch.int32, device=dev)
    insufficient = torch.zeros((P, R), dtype=torch.int32, device=dev)
    gpu_take = torch.zeros((P, Gd), dtype=torch.float32, device=dev)
    drawn = None  # the first pod of the chunk whose draws `draws` holds
    for i, u in enumerate(tmpl):
        if forced_h[i]:
            c = pin[u] if pin[u] >= 0 else -1  # skips the pipeline, counts zeros
        else:
            res = kernels.pod_step(ec, stat, st, u, features, config, extra_plugins, count_all=explain)
            fail_counts[i], insufficient[i] = res.fail_counts, res.insufficient
            c = res.chosen
            if tie_seed is not None and c >= 0:
                lo = i - i % DRAW_CHUNK
                if drawn != lo:
                    pods = torch.arange(draw_base + lo, draw_base + min(lo + DRAW_CHUNK, P), device=dev)
                    draws, drawn = philox_draws(tie_seed, pods, N), lo
                masked = torch.where(res.feasible, res.score, -1e30)
                top = res.feasible & (masked == masked.max())
                d_i = draws[i - lo]
                top = top & (d_i == torch.where(top, d_i, -1).max())
                c = int(torch.nonzero(top)[0])
        if valid[i] and c >= 0:
            gpu_take[i] = kernels.bind_update(ec, st, u, c, features)
            chosen[i] = c
    return ScheduleOutput(chosen.to(dev), fail_counts, insufficient, gpu_take, stat.static_fail, st)


def pad_pod_stream(tmpl_ids, pod_valid, forced, bucket: int = 256):
    """Pad the pod stream to a multiple of `bucket` with invalid, unforced
    pods of template 0, which never bind (``scheduler.pad_pod_stream``)."""
    P = len(tmpl_ids)
    target = max(bucket, bucket * ((P + bucket - 1) // bucket))
    pad = target - P
    if pad == 0:
        return tmpl_ids, pod_valid, forced
    return (
        np.concatenate([tmpl_ids, np.zeros(pad, dtype=tmpl_ids.dtype)]),
        np.concatenate([pod_valid, np.zeros(pad, dtype=bool)]),
        np.concatenate([forced, np.zeros(pad, dtype=bool)]),
    )
