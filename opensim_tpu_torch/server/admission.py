"""Admission queue + dispatcher — the server's concurrent core, the port's
copy of ``opensim_tpu/server/admission.py`` (framework-free: the same
controller with the port's imports).

The single-flight path answers every concurrent request with the
reference's TryLock 503 (``server.go:167,:234``). This module puts a small
queueing discipline in front of the kernel instead:

- **admission**: requests enter a bounded queue (``OPENSIM_QUEUE_BOUND``).
  Past the bound they are *shed* with a typed 503 carrying ``Retry-After``
  (:class:`QueueFull`). Shed counts land in ``simon_shed_total{reason=}``
  (and per lane in ``simon_lane_shed_total{lane=,reason=}``), with the
  real elapsed time as the rejection's latency.
- **priority lanes**: an *interactive* lane
  (explain requests, and requests expanding to at most
  ``OPENSIM_LANE_INTERACTIVE_PODS`` pods) and a *bulk* lane, picked up
  ``OPENSIM_LANE_WEIGHT``:1 in the interactive lane's favor, with a
  starvation bound (``OPENSIM_LANE_STARVATION_S``): a bulk request waiting
  past it is picked next regardless of weight (counted in
  ``simon_lane_starvation_promotions_total``).
- **coalescing**: the dispatcher waits one short window
  (``OPENSIM_BATCH_WINDOW_MS``) after the first arrival, then folds every
  *batchable* queued request (no newnodes, prep cache on) onto one shared
  warm prepare and runs them as one request batch
  (``engine/reqbatch.py``: one launch of the kernel's scenario grid). A
  lone request takes the solo path (one launch of the one scan).
- **pipelining** (``OPENSIM_PIPELINE``): with the REST layer's staged
  executors (``prep_fn``/``dispatch_fn``/``decode_fn``) the batch runs as
  a three-stage pipeline: the dispatcher thread runs batch k+1's host prep
  (expand, ``derive_with_app_slices``, masks, under the base entry's lock)
  while the engine thread runs batch k's launch (which touches only the
  derived prep) and the decode thread demultiplexes batch k-1's results.
  Stage handoffs are depth-1 queues, so at most one batch is in each
  stage. The measured overlap lands in
  ``simon_pipeline_prep_overlap_seconds_total``.
- **worker pool**: unbatchable requests run concurrently through the
  bounded :class:`server.pool.WorkerPool`.
- **load-shedding deadlines**: a ticket whose deadline expires *while
  queued* is shed with a typed 504 naming the ``queue`` phase (and a
  ``simon_shed_total{reason="deadline"}`` bump). A ticket that was already
  expired at admission still executes, solo, and its first phase boundary
  raises the typed 504 naming snapshot/prepare/...

Locking: nothing blocking (no sleeps, no I/O, no future or event waits,
no stage-queue puts) happens while the queue's condition lock is held.
"""

from __future__ import annotations

import collections
import logging
import queue as queue_mod
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..obs.metrics import (
    BATCH_SIZE_BUCKETS,
    RECORDER,
    CounterVec,
    HistogramVec,
    family_header,
)
from ..resilience.deadline import Deadline, DeadlineExceeded
from ..utils import envknobs

log = logging.getLogger("opensim_tpu_torch.server")

__all__ = [
    "AdmissionController",
    "QueueFull",
    "Ticket",
    "admission_enabled",
    "batch_window_s",
    "queue_bound",
    "batch_max",
    "pipeline_enabled",
    "lane_interactive_pods",
    "lane_weight",
    "lane_starvation_s",
    "classify_lane",
    "payload_pod_estimate",
]

LANES = ("interactive", "bulk")


def _env_float(name: str, default: float, lo: float = 0.0) -> float:
    raw = envknobs.raw(name)
    if not raw:
        return default
    try:
        return max(lo, float(raw))
    except ValueError:
        log.warning("ignoring unparseable %s=%r (using %s)", name, raw, default)
        return default


def admission_enabled() -> bool:
    """``OPENSIM_ADMISSION``: ``on`` (default) routes requests through the
    admission queue; ``off`` restores the single-flight TryLock path."""
    return envknobs.raw("OPENSIM_ADMISSION", "on").strip().lower() not in (
        "off", "0", "false",
    )


def batch_window_s() -> float:
    return _env_float("OPENSIM_BATCH_WINDOW_MS", 5.0) / 1000.0


def queue_bound() -> int:
    return int(_env_float("OPENSIM_QUEUE_BOUND", 64.0, lo=1.0))


def batch_max() -> int:
    return int(_env_float("OPENSIM_BATCH_MAX", 16.0, lo=1.0))


def pipeline_enabled() -> bool:
    """``OPENSIM_PIPELINE``: ``on`` (default) overlaps batch k+1 host prep
    with batch k engine dispatch; ``off`` restores the serial loop."""
    return envknobs.raw("OPENSIM_PIPELINE", "on").strip().lower() not in (
        "off", "0", "false",
    )


def lane_interactive_pods() -> int:
    return int(_env_float("OPENSIM_LANE_INTERACTIVE_PODS", 8.0, lo=0.0))


def lane_weight() -> int:
    return int(_env_float("OPENSIM_LANE_WEIGHT", 4.0, lo=1.0))


def lane_starvation_s() -> float:
    return _env_float("OPENSIM_LANE_STARVATION_S", 0.5)


#: payload keys that carry workload lists (mirrors rest._decode_app's map,
#: replica-bearing kinds only — the lane estimate needs counts, not decode)
_WORKLOAD_KEYS = (
    "pods", "Pods", "deployments", "Deployments", "daemonsets", "DaemonSets",
    "statefulsets", "StatefulSets", "jobs", "Jobs", "cronjobs", "CronJobs",
)


def payload_pod_estimate(payload: dict) -> int:
    """Cheap upper-ish bound on how many pods a simulate payload expands
    to: sum of ``spec.replicas`` (min 1) across workload lists. Used only
    for lane classification — an estimate, never a correctness input."""
    total = 0
    for key in _WORKLOAD_KEYS:
        objs = payload.get(key)
        if not objs:
            continue
        for obj in objs:
            reps = 1
            if isinstance(obj, dict):
                spec = obj.get("spec")
                if isinstance(spec, dict):
                    try:
                        reps = int(spec.get("replicas") or 1)
                    except (TypeError, ValueError):
                        reps = 1
            total += max(1, reps)
    return total


def classify_lane(ticket: "Ticket") -> str:
    """Interactive = explain requests (a human is waiting on an audit) and
    anything expanding to at most ``OPENSIM_LANE_INTERACTIVE_PODS`` pods
    (deploy of a few pods, scale-down checks); everything else is bulk."""
    if ticket.explain:
        return "interactive"
    try:
        estimate = payload_pod_estimate(ticket.payload)
    except Exception as e:
        # a malformed payload fails in the executor with a typed error;
        # lane classification just routes it through the bulk lane
        log.debug("lane classification failed: %s: %s", type(e).__name__, e)
        return "bulk"
    return "interactive" if estimate <= lane_interactive_pods() else "bulk"


class QueueFull(RuntimeError):
    """Typed shed: the admission queue cannot take this request.
    ``retry_after_s`` is the dispatcher's drain estimate, surfaced as the
    503's ``Retry-After`` header; ``reason`` distinguishes overload
    (``queue_full`` — retrying later helps) from graceful shutdown
    (``shutting_down`` — retry against another replica) and is echoed in
    the 503 body and ``simon_shed_total{reason=}``."""

    def __init__(
        self, message: str, retry_after_s: float = 1.0,
        reason: str = "queue_full",
    ) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.reason = reason


@dataclass(eq=False)
class Ticket:
    """One queued simulate request and its completion slot."""

    kind: str  # "deploy" | "scale"
    payload: dict
    explain: bool = False
    deadline: Optional[Deadline] = None
    trace: Optional[object] = None  # the request's TraceContext (or None)
    request_id: str = ""
    has_new_nodes: bool = False
    lane: str = "bulk"  # assigned by the controller at submit
    enqueued: float = field(default_factory=time.monotonic)
    # completion slot, written exactly once by the executor
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[object] = None  # SimulateResult on success
    error: Optional[BaseException] = None
    stale: bool = False  # request_served_stale() observed on the exec thread
    queue_s: float = 0.0
    batch_size: int = 0  # 0 = solo path

    def batchable(self) -> bool:
        # newnodes get per-request randomized fake node names (a shared
        # node axis would replay one request's names into another's
        # response). explain requests batch like any other: the batch runs
        # the grid's [explain] variant and only the explain rider's decode
        # builds the audit, equal to its solo explain answer.
        return not self.has_new_nodes

    def resolve(self, result=None, error: Optional[BaseException] = None,
                stale: bool = False, batch_size: int = 0) -> None:
        self.result, self.error, self.stale = result, error, stale
        self.batch_size = batch_size
        self.done.set()

    def expired_in_queue(self) -> bool:
        """Deadline ran out while waiting — but only if it was still alive
        at admission (a pre-expired deadline keeps the legacy behavior:
        execute, and let the first phase boundary raise its typed 504)."""
        return (
            self.deadline is not None
            and not self._expired_at_admission
            and self.deadline.expired()
        )

    def __post_init__(self) -> None:
        self._expired_at_admission = (
            self.deadline is not None and self.deadline.expired()
        )


@dataclass(eq=False)
class _InFlight:
    """One batch riding the staged pipeline: the tickets, the REST layer's
    opaque stage state (PreppedBatch), and bookkeeping for telemetry."""

    tickets: List[Ticket]
    state: object = None
    error: Optional[BaseException] = None
    started: float = 0.0
    prep_s: float = 0.0


class AdmissionController:
    """The queue + dispatcher. ``solo_fn(ticket)`` and
    ``batch_fn(tickets)`` are provided by the REST layer (they own the
    snapshot/prep-cache internals); both MUST resolve every ticket they are
    handed, success or error — an unresolved ticket would hang its client
    until the wait backstop.

    The optional staged executors turn the batch path into a pipeline
    (``OPENSIM_PIPELINE``):

    - ``prep_fn(tickets) -> state | None`` — host prep under the
      base-entry lock (expand, derive, masks). May resolve individual
      tickets (malformed payloads); returning ``None`` means the batch
      cannot ride the shared base (unroutable/derive refusal) and the
      controller falls the unresolved tickets back to the solo pool.
    - ``dispatch_fn(state) -> state`` — the launch. Touches ONLY the
      derived prep's arrays (no base-entry lock), and the kernel's launch
      and host copies release the GIL: the window prep k+1 overlaps.
    - ``decode_fn(state) -> None`` — demultiplex results per rider under
      the base-entry lock and resolve every remaining ticket.

    Without the staged executors (or with the knob off) ``batch_fn`` runs
    the proven serial inline path unchanged.
    """

    def __init__(
        self,
        solo_fn: Callable[[Ticket], None],
        batch_fn: Callable[[List[Ticket]], None],
        pool=None,
        window_s: Optional[float] = None,
        bound: Optional[int] = None,
        max_batch: Optional[int] = None,
        prep_fn: Optional[Callable[[List[Ticket]], object]] = None,
        dispatch_fn: Optional[Callable[[object], object]] = None,
        decode_fn: Optional[Callable[[object], None]] = None,
    ) -> None:
        from .pool import WorkerPool

        self.solo_fn = solo_fn
        self.batch_fn = batch_fn
        self.prep_fn = prep_fn
        self.dispatch_fn = dispatch_fn
        self.decode_fn = decode_fn
        self.window_s = batch_window_s() if window_s is None else window_s
        self.bound = queue_bound() if bound is None else bound
        self.max_batch = batch_max() if max_batch is None else max_batch
        # knobs are captured at construction: a server decides its serving
        # shape at boot, not per request (tests construct with the env set)
        self.pipelined = (
            prep_fn is not None and dispatch_fn is not None
            and decode_fn is not None and pipeline_enabled()
        )
        self.lane_weight = lane_weight()
        self.starvation_s = lane_starvation_s()
        self._pool = pool if pool is not None else WorkerPool()
        self._cond = threading.Condition()
        self._lanes: Dict[str, "collections.deque[Ticket]"] = {
            lane: collections.deque() for lane in LANES
        }  # guarded-by: _cond
        self._inter_picks = 0  # interactive pickups since last bulk; guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None  # guarded-by: _cond
        self._engine_thread: Optional[threading.Thread] = None  # guarded-by: _cond
        self._decode_thread: Optional[threading.Thread] = None  # guarded-by: _cond
        # depth-1 stage handoffs: the structural backpressure that bounds
        # the pipeline to one batch per stage
        self._dispatch_q: "queue_mod.Queue[Optional[_InFlight]]" = queue_mod.Queue(maxsize=1)
        self._decode_q: "queue_mod.Queue[Optional[_InFlight]]" = queue_mod.Queue(maxsize=1)
        # dispatch-busy clock for the overlap measurement: the engine
        # thread marks busy intervals; the prep wrapper differences the
        # clock across its window — overlap = dispatch-busy seconds that
        # elapsed while prep ran
        self._busy_lock = threading.Lock()
        self._busy_accum = 0.0  # guarded-by: _busy_lock
        self._busy_since: Optional[float] = None  # guarded-by: _busy_lock
        # telemetry (rendered into /metrics via metrics_lines): families
        # come from the obs/metrics.py registry, all mutations
        # under the ONE recorder lock like every other family
        self.shed = CounterVec("simon_shed_total", ("reason",))
        self.lane_shed = CounterVec("simon_lane_shed_total", ("lane", "reason"))
        self.batch_sizes = HistogramVec("simon_batch_size", (), buckets=BATCH_SIZE_BUCKETS)
        self.queue_wait = HistogramVec("simon_queue_wait_seconds", ())
        self.stage_seconds = HistogramVec("simon_pipeline_stage_seconds", ("stage",))
        self.batches_total = 0  # guarded-by: RECORDER.lock
        self.lane_admitted = {lane: 0 for lane in LANES}  # guarded-by: RECORDER.lock
        self.starvation_promotions = 0  # guarded-by: RECORDER.lock
        self.overlapped_batches = 0  # guarded-by: RECORDER.lock
        self.prep_overlap_s = 0.0  # guarded-by: RECORDER.lock
        self._stage_agg: Dict[str, List[float]] = {}  # stage -> [count, total, max]; guarded-by: RECORDER.lock
        # drain-rate estimate for Retry-After
        self.ewma_service_s = 0.05  # guarded-by: RECORDER.lock

    # -- client side --------------------------------------------------------

    def submit(self, ticket: Ticket) -> Ticket:
        """Admit (or shed) a ticket; starts the dispatcher on first use."""
        ticket.lane = classify_lane(ticket)
        with self._cond:
            if self._closed:
                with RECORDER.lock:
                    self.shed.inc(("shutting_down",))
                    self.lane_shed.inc((ticket.lane, "shutting_down"))
                raise QueueFull(
                    "the server is shutting down", retry_after_s=1.0,
                    reason="shutting_down",
                )
            depth = sum(len(q) for q in self._lanes.values())
            if depth >= self.bound:
                with RECORDER.lock:
                    retry = max(
                        0.05, depth * self.ewma_service_s / max(1, self.max_batch)
                    )
                    self.shed.inc(("queue_full",))
                    self.lane_shed.inc((ticket.lane, "queue_full"))
                raise QueueFull(
                    f"admission queue at bound ({depth}/{self.bound}); "
                    "try again later",
                    retry_after_s=retry,
                )
            self._lanes[ticket.lane].append(ticket)
            with RECORDER.lock:
                self.lane_admitted[ticket.lane] += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="simon-dispatch", daemon=True
                )
                self._thread.start()
                if self.pipelined:
                    self._engine_thread = threading.Thread(
                        target=self._engine_loop, name="simon-pipe-engine",
                        daemon=True,
                    )
                    self._decode_thread = threading.Thread(
                        target=self._decode_loop, name="simon-pipe-decode",
                        daemon=True,
                    )
                    self._engine_thread.start()
                    self._decode_thread.start()
            self._cond.notify()
        return ticket

    def wait(self, ticket: Ticket) -> Ticket:
        """Block the REST handler thread until the ticket resolves. The
        backstop bounds a lost ticket (a dispatcher bug) to a typed error
        instead of a hung client."""
        backstop = 600.0
        if ticket.deadline is not None:
            backstop = max(1.0, ticket.deadline.remaining() + 30.0)
        if not ticket.done.wait(timeout=backstop):
            raise RuntimeError(
                "admission dispatcher unresponsive "
                f"(ticket not resolved within {backstop:.0f}s)"
            )
        if ticket.error is not None:
            raise ticket.error
        return ticket

    def depth(self) -> int:
        with self._cond:
            return sum(len(q) for q in self._lanes.values())

    def lane_depths(self) -> Dict[str, int]:
        with self._cond:
            return {lane: len(q) for lane, q in self._lanes.items()}

    def stop(self, drain_s: float = 30.0) -> None:
        """Graceful drain (SIGTERM/SIGINT, docs/serving.md): queued tickets
        shed typed 503 ``shutting_down``; the batches/solos already IN
        FLIGHT complete (their clients get real results) before the worker
        pool stops — the dispatcher thread is joined up to ``drain_s`` and
        the pipeline stages drain through sentinels."""
        with self._cond:
            self._closed = True
            pending: List[Ticket] = []
            for q in self._lanes.values():
                pending.extend(q)
                q.clear()
            self._cond.notify_all()
            thread = self._thread
            engine_thread = self._engine_thread
            decode_thread = self._decode_thread
        if pending:
            with RECORDER.lock:
                for _t in pending:
                    self.shed.inc(("shutting_down",))
                    self.lane_shed.inc((_t.lane, "shutting_down"))
        for t in pending:
            t.resolve(
                error=QueueFull(
                    "the server is shutting down", reason="shutting_down"
                )
            )
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=drain_s)
        if engine_thread is not None:
            # the sentinel rides BEHIND any in-flight batch (depth-1 queue):
            # the engine stage finishes it, forwards the sentinel, and the
            # decode stage resolves the last clients before exiting
            self._dispatch_q.put(None)
            engine_thread.join(timeout=drain_s)
        if decode_thread is not None:
            decode_thread.join(timeout=drain_s)
        self._pool.shutdown()

    # -- dispatcher ---------------------------------------------------------

    def _first_arrival_locked(self) -> float:
        return min(
            q[0].enqueued for q in self._lanes.values() if q
        )

    def _pick_locked(self, now: float) -> Optional[Ticket]:
        """Weighted two-lane pickup (guarded-by: _cond). Interactive wins
        ``lane_weight`` picks per bulk pick; a bulk head older than the
        starvation bound is promoted immediately (counted)."""
        inter, bulk = self._lanes["interactive"], self._lanes["bulk"]
        if not inter and not bulk:
            return None
        if not inter:
            lane = "bulk"
        elif not bulk:
            lane = "interactive"
        else:
            starved = now - bulk[0].enqueued > self.starvation_s
            if starved or self._inter_picks >= self.lane_weight:
                lane = "bulk"
                if starved and self._inter_picks < self.lane_weight:
                    with RECORDER.lock:
                        self.starvation_promotions += 1
            else:
                lane = "interactive"
        if lane == "interactive":
            self._inter_picks += 1
        else:
            self._inter_picks = 0
        return self._lanes[lane].popleft()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not any(self._lanes.values()) and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return
                first_arrival = self._first_arrival_locked()
            # coalescing window, measured from the FIRST waiter's arrival so
            # a busy queue drains at window cadence instead of re-arming per
            # arrival. Outside the lock: admission must never block on it.
            delay = first_arrival + self.window_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            with self._cond:
                if self._closed:
                    return
                now = time.monotonic()
                drained, kept = [], []
                while len(drained) < self.max_batch:
                    t = self._pick_locked(now)
                    if t is None:
                        break
                    drained.append(t)
                # non-batchable tickets never consume batch slots
                for t in list(drained):
                    if not t.batchable():
                        drained.remove(t)
                        kept.append(t)
            self._dispatch(drained, kept)

    def _dispatch(self, batchable: List[Ticket], solos: List[Ticket]) -> None:
        now = time.monotonic()
        ready: List[Ticket] = []
        for t in batchable + solos:
            t.queue_s = now - t.enqueued
            if t.expired_in_queue():
                with RECORDER.lock:
                    self.shed.inc(("deadline",))
                    self.lane_shed.inc((t.lane, "deadline"))
                    self.queue_wait.observe(t.queue_s, ())
                t.resolve(
                    error=DeadlineExceeded(
                        "request deadline expired while queued "
                        f"(waited {t.queue_s:.3f}s)",
                        phase="queue",
                    )
                )
            else:
                ready.append(t)
        batchable = [t for t in batchable if t in ready]
        solos = [t for t in solos if t in ready]
        # a ticket whose deadline is ALREADY dead (pre-expired at admission
        # — kept for the legacy phase contract) must not ride a batch: the
        # batch installs no deadline scope, so only the solo path can raise
        # its typed 504 at the first phase boundary
        dead = [t for t in batchable if t.deadline is not None and t.deadline.expired()]
        if dead:
            batchable = [t for t in batchable if t not in dead]
            solos = solos + dead
        with RECORDER.lock:
            for t in ready:
                self.queue_wait.observe(t.queue_s, ())
        for t in solos:
            self._pool.submit(self._run_solo, t)
        if len(batchable) == 1:
            # a batch of one is just overhead: the solo path keeps its one
            # launch of the one scan and its per-phase span tree
            self._pool.submit(self._run_solo, batchable[0])
        elif batchable and self.pipelined:
            # staged: prep INLINE on this thread (so the next drain's prep
            # naturally overlaps the engine thread's dispatch), then hand
            # off. The blocking put IS the backpressure — one batch per
            # stage — and happens outside every lock.
            inflight = self._run_prep(batchable)
            if inflight is not None:
                self._dispatch_q.put(inflight)
        elif batchable:
            # INLINE, not pooled: one batch in flight at a time (groups
            # would only serialize on the base-entry lock anyway), so new
            # arrivals accumulate in the queue while this batch runs and
            # the next drain folds them into one bigger batch — batch size
            # adapts to the service rate under load (the classic serving-
            # system dynamic-batching loop)
            self._run_group(batchable)

    def _run_solo(self, ticket: Ticket) -> None:
        t0 = time.monotonic()
        try:
            self.solo_fn(ticket)
        except BaseException as e:  # the backstop of last resort: the
            # error is transported to the waiting client, not dropped
            log.warning("solo executor raised %s: %s", type(e).__name__, e)
            if not ticket.done.is_set():
                ticket.resolve(error=e)
        finally:
            self._note_service(time.monotonic() - t0)
        if not ticket.done.is_set():
            ticket.resolve(
                error=RuntimeError("solo executor returned without resolving")
            )

    def _run_group(self, tickets: List[Ticket]) -> None:
        t0 = time.monotonic()
        # recorded at batch START (size is known upfront): a client whose
        # ticket just resolved must already see the batch in /metrics —
        # recording after resolution races every scrape-after-response
        with RECORDER.lock:
            self.batches_total += 1
            self.batch_sizes.observe(float(len(tickets)), ())
        try:
            self.batch_fn(tickets)
        except BaseException as e:
            # transported to every waiting client as a typed error
            log.warning("batch executor raised %s: %s", type(e).__name__, e)
            for t in tickets:
                if not t.done.is_set():
                    t.resolve(error=e)
        finally:
            self._note_service(time.monotonic() - t0)
        for t in tickets:
            if not t.done.is_set():
                t.resolve(
                    error=RuntimeError("batch executor returned without resolving")
                )

    # -- pipeline stages ----------------------------------------------------

    def _busy_seconds(self, now: float) -> float:
        with self._busy_lock:
            busy = self._busy_accum
            if self._busy_since is not None:
                busy += now - self._busy_since
            return busy

    def _observe_stage(self, stage: str, seconds: float) -> None:
        with RECORDER.lock:
            self.stage_seconds.observe(seconds, (stage,))
            agg = self._stage_agg.setdefault(stage, [0.0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += seconds
            agg[2] = max(agg[2], seconds)

    def _run_prep(self, tickets: List[Ticket]) -> Optional[_InFlight]:
        t0 = time.monotonic()
        busy0 = self._busy_seconds(t0)
        with RECORDER.lock:
            self.batches_total += 1
            self.batch_sizes.observe(float(len(tickets)), ())
        inflight = _InFlight(tickets=tickets, started=t0)
        state = None
        try:
            state = self.prep_fn(tickets)
        except BaseException as e:
            log.warning("prep stage raised %s: %s", type(e).__name__, e)
            for t in tickets:
                if not t.done.is_set():
                    t.resolve(error=e)
            self._note_service(time.monotonic() - t0)
            return None
        finally:
            t1 = time.monotonic()
            overlap = max(0.0, self._busy_seconds(t1) - busy0)
            self._observe_stage("prep", t1 - t0)
            with RECORDER.lock:
                if overlap > 0.0:
                    self.overlapped_batches += 1
                    self.prep_overlap_s += overlap
        if state is None:
            # the batch cannot ride the shared base (derive refusal /
            # unroutable): unresolved tickets fall back to the solo pool,
            # exactly like the serial path's _BatchUnroutable fallback
            for t in tickets:
                if not t.done.is_set():
                    self._pool.submit(self._run_solo, t)
            self._note_service(time.monotonic() - t0)
            return None
        inflight.state = state
        inflight.prep_s = t1 - t0
        return inflight

    def _engine_loop(self) -> None:
        while True:
            item = self._dispatch_q.get()
            if item is None:
                self._decode_q.put(None)
                return
            t0 = time.monotonic()
            with self._busy_lock:
                self._busy_since = t0
            try:
                item.state = self.dispatch_fn(item.state)
            except BaseException as e:
                log.warning("dispatch stage raised %s: %s", type(e).__name__, e)
                item.error = e
            finally:
                t1 = time.monotonic()
                with self._busy_lock:
                    self._busy_accum += t1 - t0
                    self._busy_since = None
                self._observe_stage("dispatch", t1 - t0)
            self._decode_q.put(item)

    def _decode_loop(self) -> None:
        while True:
            item = self._decode_q.get()
            if item is None:
                return
            t0 = time.monotonic()
            try:
                if item.error is not None:
                    raise item.error
                self.decode_fn(item.state)
            except BaseException as e:
                log.warning("decode stage raised %s: %s", type(e).__name__, e)
                for t in item.tickets:
                    if not t.done.is_set():
                        t.resolve(error=e)
            finally:
                self._observe_stage("decode", time.monotonic() - t0)
                # the EWMA feeds Retry-After: whole-batch latency through
                # the pipeline, prep start to decode end
                self._note_service(time.monotonic() - item.started)
            for t in item.tickets:
                if not t.done.is_set():
                    t.resolve(
                        error=RuntimeError(
                            "decode stage returned without resolving"
                        )
                    )

    def _note_service(self, seconds: float) -> None:
        with RECORDER.lock:
            self.ewma_service_s = 0.8 * self.ewma_service_s + 0.2 * max(
                0.001, seconds
            )

    # -- /metrics + profile -------------------------------------------------

    def pipeline_snapshot(self) -> dict:
        """The ``simon profile`` pipeline section: stage aggregates, the
        measured overlap, and lane counters (served via
        ``/api/debug/profile``)."""
        depths = self.lane_depths()
        with RECORDER.lock:
            return {
                "enabled": self.pipelined,
                "lanes_enabled": True,  # the port always runs both lanes
                "batches": self.batches_total,
                "overlapped_batches": self.overlapped_batches,
                "prep_overlap_s": round(self.prep_overlap_s, 6),
                "starvation_promotions": self.starvation_promotions,
                "lane_admitted": dict(self.lane_admitted),
                "lane_depth": depths,
                "stages": {
                    stage: {
                        "count": int(agg[0]),
                        "total_s": round(agg[1], 6),
                        "max_s": round(agg[2], 6),
                    }
                    for stage, agg in sorted(self._stage_agg.items())
                },
            }

    def metrics_lines(self) -> List[str]:
        lines = list(family_header("simon_admission_queue_depth"))
        lines.append(f"simon_admission_queue_depth {self.depth()}")
        depths = self.lane_depths()
        lines += family_header("simon_lane_depth")
        for lane in LANES:
            lines.append(f'simon_lane_depth{{lane="{lane}"}} {depths.get(lane, 0)}')
        with RECORDER.lock:
            lines += family_header("simon_batches_total")
            lines.append(f"simon_batches_total {self.batches_total}")
            shed = self.shed.render_lines()
            if not shed:
                # conformance: the family must exist from the first scrape,
                # not only after the first shed
                shed = family_header("simon_shed_total")
            lines += shed
            lane_shed = self.lane_shed.render_lines()
            if not lane_shed:
                lane_shed = family_header("simon_lane_shed_total")
            lines += lane_shed
            lines += family_header("simon_lane_admitted_total")
            for lane in LANES:
                lines.append(
                    f'simon_lane_admitted_total{{lane="{lane}"}} '
                    f"{self.lane_admitted[lane]}"
                )
            lines += family_header("simon_lane_starvation_promotions_total")
            lines.append(
                "simon_lane_starvation_promotions_total "
                f"{self.starvation_promotions}"
            )
            stage = self.stage_seconds.render_lines()
            if not stage:
                stage = family_header("simon_pipeline_stage_seconds")
            lines += stage
            lines += family_header("simon_pipeline_prep_overlap_seconds_total")
            lines.append(
                "simon_pipeline_prep_overlap_seconds_total "
                f"{self.prep_overlap_s:.6f}"
            )
            lines += family_header("simon_pipeline_overlapped_batches_total")
            lines.append(
                "simon_pipeline_overlapped_batches_total "
                f"{self.overlapped_batches}"
            )
            lines += self.batch_sizes.render_lines()
            lines += self.queue_wait.render_lines()
        return lines
