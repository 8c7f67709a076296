"""Ranks over ``torch.distributed`` — the port of
``opensim_tpu/parallel/multihost.py``.

The reference joins a ``jax.distributed`` job, after which its one-axis
mesh spans every process's devices and a sweep's scenario axis shards
across hosts. The port keeps that scale-out model on two levels:

- **local devices**: a sweep splits its scenario axis over a list of
  ``torch.device``s (``scenarios.mesh_of``, ``fastpath.sweep(devices=)``);
- **ranks**: :func:`initialize` joins a ``torch.distributed`` process
  group; a one-config sweep (``scenarios.sweep_auto``) then gives each rank
  its contiguous rows of the scenario axis, which the rank splits over its
  own devices as above, and gathers the per-scenario results to every rank
  (:func:`allgather`, the reference's tiled ``process_allgather``). Every
  rank builds the same masks (the planner is deterministic) and decides
  its next sweep from the same gathered result, so the ranks' collectives
  stay in step.

The group runs on the Gloo backend, for two reasons: the gathered outputs
are host arrays already (``fastpath.sweep`` returns numpy), so a CPU
collective moves them with no copy to a card and back; and NCCL refuses
two ranks on one card, the layout a machine with one card runs. A group
that a library caller initialised is used as it is, and must take CPU
tensors.

Typical launch (one process per host), the reference's own variables:
    JAX_COORDINATOR=host0:1234 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=0 \\
        python -m opensim_tpu_torch apply -f cfg.yaml
with :func:`initialize` called from the planner when they are set.
"""

from __future__ import annotations

import datetime
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import envknobs

#: How long a rank waits to join the group, and in a collective for the
#: others (the reference's ``jax.distributed`` start-up timeout): a rank
#: that fails or takes another branch ends the job with an error after at
#: most this long instead of hanging the others.
TIMEOUT_S = 300.0


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join a multi-host ``torch.distributed`` job (Gloo, over
    ``tcp://<coordinator>``, rank 0 listening there). Parameters default
    from the JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    variables; returns False (no-op) when no coordinator is set, so
    single-host runs need nothing. Idempotent: the planner calls this on
    every run, and a library caller may already have initialised the
    process group before invoking the planner; that group is used as it
    is."""
    coordinator = coordinator or envknobs.raw("JAX_COORDINATOR")
    if not coordinator:
        return False
    if _joined():
        return True
    num_processes = int(num_processes or envknobs.raw("JAX_NUM_PROCESSES", "1") or 1)
    process_id = int(process_id if process_id is not None else envknobs.raw("JAX_PROCESS_ID", "0") or 0)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not a rank of a job of {num_processes} processes")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if _joined() else 0


def process_count() -> int:
    """The number of ranks; 1 outside a process group."""
    return dist.get_world_size() if _joined() else 1


def allgather(a: np.ndarray) -> np.ndarray:
    """Every rank's `a` (the same shape and dtype on each), joined on the
    first axis in rank order, on every rank: the reference's
    ``multihost_utils.process_allgather(tiled=True)``. With one rank, `a`
    itself."""
    if process_count() == 1:
        return a
    t = torch.from_numpy(np.ascontiguousarray(a))
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.cat(parts).numpy()


def global_mesh() -> Optional[List[torch.device]]:
    """The local devices a sweep splits over (``scenarios.default_mesh``:
    every local card when there are several, else None). Unlike the
    reference's global mesh it holds this process's devices only: the rank
    axis above it comes from the process group."""
    from .scenarios import default_mesh

    return default_mesh()
