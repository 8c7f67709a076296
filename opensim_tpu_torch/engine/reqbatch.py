"""Request-axis batched simulation — the engine half of the server's
concurrent core, the port's ``opensim_tpu/engine/reqbatch.py``.

N compatible deploy/scale requests, folded onto one shared warm prepare
(``prepcache.derive_with_app_slices`` appends every request's app onto one
fork of the cached base), run as one batched schedule where request s's
lane enables the base cluster region plus its own app slice, minus its
drops. Foreign pods are invalid in a lane and never touch its state, so
each demultiplexed result equals what the request gets alone — the
mask-flip argument ``drop_pods`` and the scenario sweeps rest on.

The batch is one launch of the scenario grid (``fastpath.schedule_batch``:
``fast_scan_sweep``'s ``[count]`` variant, ``[explain]`` when a rider that
was not shed explains), lane s the reference's vmapped request s
(``opensim_tpu/engine/reqbatch.py:_batched_schedule``); on the CPU the
plain sweep. The port has one engine, so ``OPENSIM_BATCH_ENGINE`` has one
rung, ``auto``. The decode demultiplexes through the same
``simulator.finish_decode`` tail the solo path uses, restoring bind state
between riders so shared pod objects never leak one request's binds into
another's report.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from ..models.objects import ResourceTypes
from ..obs import trace as obs
from ..resilience.deadline import Deadline, DeadlineExceeded
from ..utils import envknobs
from . import fastpath
from .simulator import (
    AppResource,
    Prepared,
    SimulateResult,
    finish_decode,
    restore_bind_state,
    snapshot_bind_state,
)

__all__ = [
    "BatchItem",
    "BatchDispatch",
    "run_request_batch",
    "dispatch_request_batch",
    "decode_request_batch",
    "batch_engine_mode",
]

# The reference pads the request axis to a few bucket sizes (_S_BUCKETS,
# _pad_batch) because the batch size is part of its jit signature. The
# grid kernel takes any S: the port launches exactly S lanes and pads
# nothing.


@dataclass
class BatchItem:
    """One request's view of the shared batch stream."""

    cluster: ResourceTypes  # the cluster this request simulates against
    apps: List[AppResource]  # its own apps (already appended to the stream)
    lo: int  # its app slice in prep.ordered (half-open)
    hi: int
    # report-level drops: scale-removed pods and the live twin's
    # event-deleted pods (CacheEntry.base_drop), as indices over the batch
    # stream
    drops: set = field(default_factory=set)
    explain: bool = False
    # the rider's request deadline: a rider already expired before the
    # launch is shed (its lane masked out); the launch in flight is atomic
    deadline: Optional[Deadline] = None


def batch_engine_mode() -> str:
    """``OPENSIM_BATCH_ENGINE``: ``auto`` (the default), the one rung of
    the port, the grid kernel. The reference's ``xla`` and ``native``
    rungs name engines the port does not have: they raise."""
    raw = envknobs.raw("OPENSIM_BATCH_ENGINE", "auto").strip().lower() or "auto"
    if raw in ("xla", "native"):
        raise ValueError(
            f"OPENSIM_BATCH_ENGINE={raw}: the port has one engine, the bind-scan kernel's grid; only 'auto' runs"
        )
    if raw != "auto":
        raise ValueError(f"OPENSIM_BATCH_ENGINE must be auto|xla|native, got {raw!r}")
    return raw


def _request_masks(prep: Prepared, items: List[BatchItem]) -> np.ndarray:
    """[S, P] bool: request s sees the base region plus its own app slice,
    minus its report-level drops."""
    P = len(prep.ordered)
    n_base = min(i.lo for i in items) if items else P
    valid = np.zeros((len(items), P), dtype=bool)
    for s, it in enumerate(items):
        valid[s, :n_base] = True
        valid[s, it.lo : it.hi] = True
        for i in it.drops:
            valid[s, i] = False
    return valid


@dataclass
class BatchDispatch:
    """The engine half's outputs, handed from the dispatch stage to the
    decode stage (``server/admission.py``'s pipeline): host-side numpy per
    lane (or a typed shed); the decode stage never touches a device
    buffer."""

    outs: List[Optional[fastpath.Scheduled]]
    shed: Dict[int, BaseException]
    engine: str
    pod_valid: np.ndarray


def run_request_batch(prep: Prepared, items: List[BatchItem]) -> List[Union[SimulateResult, BaseException]]:
    """Schedule N requests' shared stream in one batched launch and
    demultiplex one :class:`SimulateResult` per request:
    :func:`dispatch_request_batch` followed by :func:`decode_request_batch`
    (the staged pipeline calls the halves separately).

    The caller owns the base entry's lock and the derived prep; this
    function reads ``prep`` and restores the bind state it writes. A rider
    whose deadline expired before the launch comes back as a typed
    :class:`DeadlineExceeded` (``phase="schedule"``), its lane masked out,
    so one slow queue wait never rides a whole batch; a launch in flight
    is atomic. A rider with ``explain=True`` rides the same launch: the
    batch runs the ``[explain]`` variant, so its per-pod rows exist, and
    only that rider's decode builds the audit."""
    return decode_request_batch(prep, items, dispatch_request_batch(prep, items))


def dispatch_request_batch(prep: Prepared, items: List[BatchItem]) -> BatchDispatch:
    """The engine stage: the masks and one launch, no decode. It touches
    only the derived prep's arrays and device buffers, never the shared
    pod objects, so the caller runs it without the base entry's lock while
    the next batch's prep (which holds it) overlaps."""
    batch_engine_mode()
    miss = fastpath.why_not(prep)
    if miss is not None:
        raise NotImplementedError(f"outside the port's bind-scan envelope: {miss}")
    P = len(prep.ordered)
    pod_valid = _request_masks(prep, items)
    shed: Dict[int, BaseException] = {}
    for s, it in enumerate(items):
        dl = it.deadline
        if dl is not None and dl.expired():
            # the lane schedules nothing and cannot perturb the others,
            # whose masks never held its pods
            obs.event("batch.rider_shed", status="deadline-exceeded", rider=s, over_by_s=round(-dl.remaining(), 6))
            shed[s] = DeadlineExceeded(
                f"request deadline exceeded at the 'schedule' phase (shed before the batch's launch, over by "
                f"{-dl.remaining():.3f}s)",
                phase="schedule",
            )
            pod_valid[s, :] = False
    # after shedding: a shed rider's audit has no reader
    explain_any = any(it.explain for s, it in enumerate(items) if s not in shed)
    with obs.span("engine.grid", requests=len(items), pods=P):
        row, outs = fastpath.schedule_batch(prep, pod_valid, explain=explain_any)
    for s in shed:
        outs[s] = None
    return BatchDispatch(outs=outs, shed=shed, engine=f"{row} on {prep.device.type}", pod_valid=pod_valid)


def decode_request_batch(prep: Prepared, items: List[BatchItem],
                         dispatch: BatchDispatch) -> List[Union[SimulateResult, BaseException]]:
    """The decode stage: one :class:`SimulateResult` (or typed shed) per
    rider. It writes the shared pod objects' bind state through
    ``finish_decode`` and restores it after each rider: the caller holds
    the base entry's lock, as on the solo path."""
    P = len(prep.ordered)
    segments = [(None, 0, P)]
    snap = snapshot_bind_state(prep)
    results: List[Union[SimulateResult, BaseException]] = []
    with obs.span("decode", pods=P, requests=len(items)):
        for s, it in enumerate(items):
            if s in dispatch.shed:
                results.append(dispatch.shed[s])
                continue
            # the lane's mask is the rider's report: foreign riders' slices
            # and its own drops are out of both
            lane = dispatch.pod_valid[s]
            try:
                results.append(finish_decode(prep, dispatch.outs[s], it.cluster, lane, lane, None, segments,
                                             dispatch.engine, it.explain))
            finally:
                restore_bind_state(prep, snap)
    return results
