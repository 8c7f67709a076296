"""``simon server`` of the port — the REST server of ``pkg/server/server.go``
and ``opensim_tpu/server/rest.py``: ``GET /healthz``, ``POST
/api/deploy-apps`` and ``POST /api/scale-apps`` with the reference's
request and response DTOs (``server.go:48-93``), ``GET /metrics``, the
flight recorder (``GET /api/debug/requests[/<id>]``), the decision
audit of ``?explain=1`` requests (``GET /api/debug/placements/<id>``),
the memory observatory (``GET /api/debug/memory``, ``obs/footprint.py``),
the cumulative phase profiles and the kernels' build telemetry (``GET
/api/debug/profile``, ``obs/profile.py``), a ``torch.profiler`` session
(``GET /debug/profiler``, ``?stop=1`` ends it and writes its Chrome trace),
the capacity observatory (``GET /api/cluster/report`` with its headroom
probes, ``GET /api/debug/capacity``, the ``simon_cluster_*`` families of
``/metrics``; ``obs/capacity.py``) and lifecycle campaigns (``POST
/api/campaign``; ``planner/campaign.py``).

A request goes through the encode cache (``engine/prepcache.py``): the
cluster snapshot's prepared encoding is kept across requests, and a
request re-encodes only its delta — its app's pods appended, the node axis
extended by its ``newnodes``, a scale request's removed pods flipped
invalid — and is placed by one launch of the bind-scan kernel on the card
(``fast_scan_kernel``, its ``[explain]`` variant for ``explain=1``). There
is no fallback: a failed build or launch answers 500.

The snapshot comes from the live twin (``server/watch.py``, ``watch=``: a
watch supervisor keeping an event-maintained mirror of the cluster and a
warm base entry of the encode cache, folded by O(changes) deltas; requests
are tagged ``X-Simon-Snapshot: stale`` while it is degraded), from an
apiserver through ``server/snapshot.py`` (``--kubeconfig``), cached for
``snapshot_ttl_s`` and fingerprinted — the fallback until the twin syncs —
or is a fixed ``base_cluster``. With a ``journal=`` (``server/journal.py``)
the twin restores from its crash-safe journal at start and records every
accepted event. Requests go through the admission queue
(``server/admission.py``, ``OPENSIM_ADMISSION=on``, the default): a
bounded queue with a typed 503 and ``Retry-After`` past its bound, two
priority lanes, a coalescing window that folds concurrent batchable
deploy/scale requests into one request batch (``engine/reqbatch.py``: one
launch of the kernel's scenario grid, lane s request s, counting each
lane's failures: ``[count]``, ``[explain]`` with an explain rider), a
lone request and the unbatchable ones (newnodes) solo on a worker pool
(``server/pool.py``). ``admission=False`` (``OPENSIM_ADMISSION=off``)
serves single-flight per endpoint, the reference's TryLock 503
(``server.go:167,:234``). Headroom probes and campaigns are serialized by
locks of their own. A headroom probe is one grid launch of the kernel for
its ladder and one per bisection step; a campaign one launch of the one
scan per scheduling pass. ``serve()`` started servers also run the
time-series ring and the SLO engine (``GET /api/debug/timeseries``, ``GET
/api/fleet/slo``; 503 on a server that did not start them). With
``workers`` ≥ 2 or ``standby``, :func:`serve` runs the serving fleet or its
hot standby instead (``server/fleet.py``); a process started with
``OPENSIM_FLEET_ATTACH`` is one of a fleet's workers, and its requests'
traces carry the owner's publication (:meth:`SimonServer._stamp_fleet_trace`).
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
import os
import signal
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from ..device import DeviceLike, resolve_device
from ..engine import prepcache
from ..engine.simulator import AppResource, SimulateResult, prepare, simulate
from ..models.expand import new_fake_nodes
from ..models.objects import LABEL_APP_NAME, Node, ResourceTypes, object_from_dict
from ..obs import capacity as capacity_mod
from ..obs import trace as tracing
from ..obs.capacity import CapacityEngine
from ..obs.footprint import MemoryObservatory, memory_rows
from ..obs.metrics import RECORDER, escape_label_value, family_header
from ..obs.profile import COMPILES, PROFILE
from ..obs.recorder import FLIGHT_RECORDER
from ..planner import campaign as campaign_mod
from ..resilience import faults
from ..resilience.deadline import Deadline, DeadlineExceeded, check_deadline, deadline_scope
from ..resilience.retry import retry_call
from ..utils import envknobs
from ..utils.trace import PREP_STATS
from . import admission as admission_mod
from .pool import WorkerPool
from .snapshot import SnapshotFetchError, SnapshotUnavailable, cluster_from_kubeconfig, snapshot_retry_policy

log = logging.getLogger("opensim_tpu_torch.server")
# structured access log (OPENSIM_ACCESS_LOG=1): one JSON object per line
_ACCESS_LOG = logging.getLogger("opensim_tpu_torch.access")

# per-request state (one HTTP request = one handler thread): whether THIS
# request's result was computed from a stale snapshot, and its request id
_REQUEST_STATE = threading.local()


def _mark_request_snapshot(stale: bool) -> None:
    _REQUEST_STATE.snapshot_stale = stale


def request_served_stale() -> bool:
    """Did the current thread's request get served from a stale snapshot?"""
    return getattr(_REQUEST_STATE, "snapshot_stale", False)


def last_request_id() -> str:
    """The request id of the current thread's request (the client's
    ``X-Simon-Request-Id`` honored, generated otherwise)."""
    return getattr(_REQUEST_STATE, "request_id", "")


def response_extra_headers() -> dict:
    """Headers the current thread's request adds to its response (the
    shed 503's ``Retry-After``)."""
    return getattr(_REQUEST_STATE, "extra_headers", {}) or {}


class _Metrics:
    """A server's counters at ``/metrics`` in the Prometheus text format.
    Every mutation takes the one recorder lock shared with the span sink
    and the latency histograms (``obs.metrics.RECORDER``), so a scrape
    never interleaves with a recording."""

    def __init__(self) -> None:
        self.lock = RECORDER.lock
        self.requests = {"deploy-apps": 0, "scale-apps": 0}
        self.simulations = 0
        self.pods_scheduled = 0
        self.pods_unscheduled = 0
        self.request_timeouts = 0
        self.snapshot_retries = 0
        self.snapshot_stale_served = 0
        self.stale_prep_retries = 0

    def record(self, endpoint: str, result: SimulateResult) -> None:
        with self.lock:
            self.requests[endpoint] = self.requests.get(endpoint, 0) + 1
            self.simulations += 1
            self.pods_scheduled += sum(len(ns.pods) for ns in result.node_status)
            self.pods_unscheduled += len(result.unscheduled_pods)

    def bump(self, counter: str, n: int = 1) -> None:
        with self.lock:
            setattr(self, counter, getattr(self, counter) + n)

    def render(self, prep_cache: Optional[prepcache.PrepareCache] = None, capacity=None, admission=None,
               watch=None, journal=None, memory=None) -> str:
        esc, hdr = escape_label_value, family_header
        with self.lock:
            lines = [
                *hdr("simon_requests_total"),
                *(f'simon_requests_total{{endpoint="{esc(ep)}"}} {n}' for ep, n in sorted(self.requests.items())),
                *hdr("simon_simulations_total"), f"simon_simulations_total {self.simulations}",
                *hdr("simon_pods_scheduled_total"), f"simon_pods_scheduled_total {self.pods_scheduled}",
                *hdr("simon_pods_unscheduled_total"), f"simon_pods_unscheduled_total {self.pods_unscheduled}",
                *hdr("simon_simulate_seconds_total"),
                f"simon_simulate_seconds_total {RECORDER.simulate_seconds_total():.6f}",
            ]
        lines += [*hdr("simon_prepare_seconds_total"), f"simon_prepare_seconds_total {PREP_STATS.total_seconds():.6f}"]
        if prep_cache is not None:
            st = prep_cache.stats
            lines += [
                *hdr("simon_prep_cache_hits_total"), f"simon_prep_cache_hits_total {st.hits}",
                *hdr("simon_prep_cache_misses_total"), f"simon_prep_cache_misses_total {st.misses}",
                *hdr("simon_prep_cache_invalidations_total"),
                f"simon_prep_cache_invalidations_total {st.invalidations}",
            ]
        with self.lock:
            lines += [
                *hdr("simon_request_timeouts_total"), f"simon_request_timeouts_total {self.request_timeouts}",
                *hdr("simon_snapshot_fetch_retries_total"),
                f"simon_snapshot_fetch_retries_total {self.snapshot_retries}",
                *hdr("simon_snapshot_stale_served_total"),
                f"simon_snapshot_stale_served_total {self.snapshot_stale_served}",
                *hdr("simon_stale_prep_retries_total"), f"simon_stale_prep_retries_total {self.stale_prep_retries}",
            ]
        # the live twin: the state machine one-hot, events by kind and
        # resource, reconnects, relists, drift, the generation
        if watch is not None:
            lines += watch.metrics_lines()
        # the admission queue: depth, batch sizes, sheds by reason and
        # lane, time in queue, the pipeline's stage times
        if admission is not None:
            lines += admission.metrics_lines()
        # the watch-event journal: records and bytes written, drops, fsync
        # latency, recoveries by outcome
        if journal is not None:
            lines += journal.metrics_lines()
        fired = sorted(faults.fault_stats().items())
        if fired:
            lines += hdr("simon_faults_injected_total")
            lines += [f'simon_faults_injected_total{{point="{esc(point)}"}} {n}' for point, n in fired]
        # capacity observatory (obs/capacity.py): per-node utilization
        # distribution, top-K hottest nodes, spread/fragmentation gauges,
        # headroom per registered profile
        if capacity is not None:
            lines += capacity.metrics_lines()
        # the memory observatory (obs/footprint.py): RSS and device
        # watermarks, the encode cache's arena bytes, ring occupancy
        if memory is not None:
            lines += memory.metrics_lines()
        # the kernels' build telemetry and the cumulative phase profiles
        # (obs/profile.py): process singletons, rendered on every scrape
        lines += COMPILES.metrics_lines()
        lines += PROFILE.metrics_lines()
        # per-phase / per-endpoint latency histograms, from the same spans
        # the flight recorder serves
        lines += RECORDER.render_lines()
        return "\n".join(lines) + "\n"


def _decode_app(payload: dict) -> ResourceTypes:
    rt = ResourceTypes()
    kind_map = {
        "pods": "Pod",
        "deployments": "Deployment",
        "daemonsets": "DaemonSet",
        "DaemonSets": "DaemonSet",
        "statefulsets": "StatefulSet",
        "StatefulSets": "StatefulSet",
        "Jobs": "Job",
        "jobs": "Job",
        "ConfigMaps": "ConfigMap",
        "configmaps": "ConfigMap",
        "Deployments": "Deployment",
        "Pods": "Pod",
    }
    for key, kind in kind_map.items():
        for obj in payload.get(key) or []:
            obj = dict(obj)
            obj.setdefault("kind", kind)
            decoded = object_from_dict(obj)
            if decoded is not None:
                rt.add(decoded)
    return rt


def _decode_new_nodes(payload: dict) -> List[Node]:
    """Requested nodes become fake nodes exactly like the apply path
    (server.go:187-194 → NewFakeNode): fresh simon-<rand> name, hostname
    label rewritten, simon/new-node marker."""
    nodes = []
    for obj in payload.get("newnodes") or payload.get("NewNodes") or []:
        obj = dict(obj)
        obj.setdefault("kind", "Node")
        nodes.extend(new_fake_nodes(Node.from_dict(obj), 1))
    return nodes


def _response(result: SimulateResult, explain: bool = False) -> dict:
    """getSimulateResponse (server.go:446-470): names only; node entries only
    for nodes holding app pods. ``explain=1`` upgrades each unscheduled
    entry with its typed reason breakdown and adds the per-filter reject
    totals — additive, so existing clients are unaffected."""
    expl_by_pod = {}
    if explain and result.explanations:
        expl_by_pod = {e.pod: e for e in result.explanations}
    out = {"unscheduledPods": [], "nodeStatus": []}
    for up in result.unscheduled_pods:
        name = f"{up.pod.metadata.namespace}/{up.pod.metadata.name}"
        entry = {"pod": name, "reason": up.reason}
        e = expl_by_pod.get(name)
        if e is not None:
            entry["explanation"] = e.to_dict()
        out["unscheduledPods"].append(entry)
    for ns in result.node_status:
        pods = [f"{p.metadata.namespace}/{p.metadata.name}" for p in ns.pods if LABEL_APP_NAME in p.metadata.labels]
        if pods:
            out["nodeStatus"].append({"node": ns.node.metadata.name, "pods": pods})
    if explain and result.filter_rejects is not None:
        out["filterRejects"] = result.filter_rejects
    return out


def _explain_store_n() -> int:
    """Per-trace cap on stored explanations: the ring holds N traces, and a
    50k-pod audit would pin 50k dicts per trace. A typo'd knob degrades to
    the default with a warning."""
    raw = envknobs.raw("OPENSIM_EXPLAIN_STORE_N")
    try:
        return max(1, int(raw)) if raw else 512
    except ValueError:
        log.warning("ignoring unparseable OPENSIM_EXPLAIN_STORE_N=%r (using 512)", raw)
        return 512


def _placements_payload(rid: str, result: SimulateResult) -> dict:
    """The serialized decision audit stored on the request's trace for
    ``GET /api/debug/placements/<request-id>``: unschedulable records first
    (they are what the endpoint exists for), scheduled records filling the
    remaining cap."""
    explanations = result.explanations or []
    kept = sorted(explanations, key=lambda e: e.status == "scheduled")[:_explain_store_n()]
    return {
        "request_id": rid,
        "engine": result.engine,
        "filter_rejects": result.filter_rejects or {},
        "pods_total": len(explanations),
        "truncated": max(0, len(explanations) - len(kept)),
        "explanations": [e.to_dict() for e in kept],
    }


class _BatchUnroutable(Exception):
    """The drained batch cannot run as one shared-prep request batch (a
    snapshot with no schedulable pods to derive from, a delta re-encode
    declined): the group degrades to solo runs, it does not fail."""


class _BatchState:
    """A batch handed between the pipeline's stages (prep → dispatch →
    decode). The dispatch stage touches only ``derived``/``items``, whose
    arrays nothing changes after the prep stage releases the base entry's
    lock."""

    __slots__ = ("tickets", "base", "derived", "items", "stale", "prep_s", "dispatch", "dispatch_s")

    def __init__(self, tickets, base, derived, items, stale, prep_s):
        self.tickets = tickets
        self.base = base
        self.derived = derived
        self.items = items
        self.stale = stale
        self.prep_s = prep_s
        self.dispatch = None
        self.dispatch_s = 0.0


class SimonServer:
    """The serving state: the snapshot (the live twin `watch`, a
    ``WatchSupervisor`` whose ``prep_cache`` this server sets, once it has
    synced; polled from `kubeconfig` and cached for `snapshot_ttl_s` until
    then or without one; or the fixed `base_cluster`), the twin's
    `journal` (flushed and closed by :meth:`close`), the encode cache
    (`prep_cache`: None builds one unless ``OPENSIM_PREP_CACHE=0``, False
    disables it and every request prepares afresh), the admission queue
    (`admission`: None follows ``OPENSIM_ADMISSION``, on by default; False
    serves single-flight with one lock per endpoint; an
    ``AdmissionController`` is used as it is), the capacity observatory
    (`capacity`: None builds the default engine, False disables it), the
    device the simulations run on (the card unless `device` names another;
    without a card this raises here, before any request), and the headroom
    and campaign locks. :meth:`close` stops the admission queue, the twin
    and the journal."""

    def __init__(
        self,
        kubeconfig: str = "",
        master: str = "",
        base_cluster: Optional[ResourceTypes] = None,
        snapshot_ttl_s: float = 30.0,
        prep_cache=None,
        admission=None,
        device: DeviceLike = None,
        capacity=None,
        watch=None,
        journal=None,
    ):
        self.device = resolve_device(device)
        # the live twin: once synced, requests serve from its event-fed
        # mirror (tagged stale while degraded); until then, the polling
        # snapshot below
        self.watch = watch
        self.kubeconfig = kubeconfig
        self.master = master
        self.base_cluster = base_cluster
        # the reference serves from its warm informer cache
        # (pkg/server/server.go:97-137); here the snapshot is cached between
        # requests, snapshot_ttl_s bounding its staleness (<= 0: re-list
        # every request)
        self.snapshot_ttl_s = snapshot_ttl_s
        self._snapshot: Optional[ResourceTypes] = None
        self._snapshot_at = 0.0
        self._snapshot_fp: Optional[str] = None
        # keeps (snapshot, fingerprint) pairs coherent across the two
        # endpoints' threads and collapses concurrent refreshes into one fetch
        self._snapshot_lock = threading.RLock()
        # degradation: when the apiserver stays down through every retry,
        # requests are served from the last good snapshot, tagged
        # X-Simon-Snapshot: stale
        self.snapshot_stale = False
        self._snapshot_fetched_at = 0.0
        if prep_cache is None and envknobs.raw("OPENSIM_PREP_CACHE", "1") != "0":
            prep_cache = prepcache.PrepareCache()
        self.prep_cache = prep_cache if prep_cache is not False else None
        self.metrics = _Metrics()
        self._deploy_lock = threading.Lock()  # single-flight (admission off): spans the whole simulation
        self._scale_lock = threading.Lock()
        if admission is None:
            admission = admission_mod.admission_enabled()
        if admission is True:
            admission = admission_mod.AdmissionController(
                solo_fn=self._admitted_solo, batch_fn=self._admitted_batch,
                # the staged executors: with OPENSIM_PIPELINE=on batch k+1's
                # host prep overlaps batch k's launch; batch_fn stays the
                # serial path
                prep_fn=self._batch_prep, dispatch_fn=self._batch_dispatch, decode_fn=self._batch_decode,
                pool=WorkerPool(device=self.device),
            )
        self.admission = admission or None
        if capacity is None:
            capacity = CapacityEngine()
        self.capacity = capacity or None
        if self.watch is not None:
            # the supervisor keeps this server's base entry warm and feeds
            # the capacity view event by event
            self.watch.prep_cache = self.prep_cache
            if self.capacity is not None:
                self.watch.capacity = self.capacity
        # the twin's journal: the supervisor restores from it at start and
        # records every accepted event; kept here for /metrics and close()
        self.journal = journal
        if journal is not None and self.watch is not None:
            self.watch.attach_journal(journal)
        # serializes headroom probes (each is kernel launches over the whole
        # snapshot) and guards the published-generation watermark below
        self._headroom_lock = threading.Lock()
        self._headroom_pub_gen = -1
        self._headroom_key: Optional[str] = None
        # one campaign at a time per server: each builds its own prepared
        # lineage and runs many launches
        self._campaign_lock = threading.Lock()
        # the memory observatory over the structures this server owns:
        # every view is computed on demand; only serve() (and a fleet
        # worker) starts its watermark ticker
        self.memory = MemoryObservatory(prep_cache=self.prep_cache,
                                        timeline=self.capacity.timeline if self.capacity is not None else None,
                                        journal=journal)
        # where a /debug/profiler session's Chrome trace is written
        self.profile_dir = os.path.join(tempfile.gettempdir(), "simon-profiler")
        # the time-series ring and the SLO engine: only serve() starts them,
        # so library and test constructions run no sampler thread
        self.timeseries = None
        self.slo = None
        self._ts_sampler = None

    def metrics_text(self) -> str:
        """The ``/metrics`` body (the handler's and the time-series
        sampler's): the request-layer families plus, while the ring runs,
        its own telemetry and the SLO burn-rate gauges."""
        text = self.metrics.render(self.prep_cache, capacity=self.capacity, admission=self.admission,
                                   watch=self.watch, journal=self.journal, memory=self.memory)
        extra: List[str] = []
        if self.timeseries is not None:
            extra += self.timeseries.metrics_lines()
        if self.slo is not None:
            extra += self.slo.metrics_lines()
        return text + ("\n".join(extra) + "\n" if extra else "")

    def start_timeseries(self) -> None:
        """Boot the on-disk time-series ring, the self-scrape sampler and
        the SLO engine (idempotent; serve() calls this)."""
        from ..obs.slo import SLOEngine
        from ..obs.timeseries import TimeSeriesRing, TimeSeriesSampler

        if self.timeseries is not None:
            return
        ts_dir = str(envknobs.value("OPENSIM_TS_DIR") or "") or None
        self.timeseries = TimeSeriesRing(directory=ts_dir)
        self.slo = SLOEngine(self.timeseries)
        self._ts_sampler = TimeSeriesSampler(self.timeseries, self.metrics_text)
        self._ts_sampler.start()

    def _stamp_fleet_trace(self, tr) -> None:
        """Cross-process stitching: when serving from a fleet twin client,
        stamp the serving generation and the owner's publication span and
        event ids onto the request trace. Free with tracing off (``tr is
        None``) and on non-fleet servers (no ``stitch_info`` on the watch
        object)."""
        if tr is None:
            return
        stitch = getattr(self.watch, "stitch_info", None)
        if stitch is None:
            return
        try:
            gen, pub = stitch()
        except Exception as e:  # a torn reader mid-swap must not fail the request
            log.debug("fleet stitch skipped: %s: %s", type(e).__name__, e)
            return
        if gen is None:
            return
        tr.serving_generation = gen  # the flight recorder keys the graft on this
        attrs = {"serving_generation": gen}
        if isinstance(pub, dict):
            if pub.get("span"):
                attrs["fleet_publication"] = pub["span"]
            events = [e[0] for e in pub.get("events") or []]
            if events:
                # comma-joined: span attrs are primitives so they survive
                # the tree's JSON export verbatim
                attrs["fleet_events"] = ",".join(events)
        tr.root.set(**attrs)

    def close(self) -> None:
        """Stop the admission queue (the batch and solos in flight
        complete, queued tickets shed a typed 503 ``shutting_down``), then
        the twin's reflectors, then flush, fsync and close the journal, so
        its history is complete to the last accepted event. Idempotent."""
        if self.admission is not None:
            self.admission.stop()
        self.memory.stop()
        if self._ts_sampler is not None:
            self._ts_sampler.stop()
        if self.timeseries is not None:
            self.timeseries.close()
        if self.watch is not None:
            self.watch.stop()
        if self.journal is not None:
            self.journal.close()

    # -- snapshot -------------------------------------------------------------

    def _twin_snapshot(self) -> Optional[Tuple[ResourceTypes, str]]:
        """(cluster, cache key) from the synced live twin, or None when the
        polling path must serve (no twin, or not synced yet). Tags the
        request stale while the twin is degraded or resyncing."""
        if self.watch is None:
            return None
        check_deadline("snapshot")
        with tracing.span("snapshot", source="twin") as sp:
            got = self.watch.serving_snapshot()
            if got is None:
                sp.set(synced=False)
                return None
            cluster, key, stale = got
            sp.set(key=key, stale=stale, state=self.watch.state())
            _mark_request_snapshot(stale)
            if stale:
                self.metrics.bump("snapshot_stale_served")
        tr = tracing.current_trace()
        if tr is not None:
            # the twin generation this request was served from
            tr.root.set(twin_key=key)
        return cluster, key

    def current_cluster(self) -> ResourceTypes:
        """The snapshot for the legacy (cache-off) path: each request gets
        its own copy, since simulate() writes into pods and nodes."""
        if self.base_cluster is not None:
            return self.base_cluster
        got = self._twin_snapshot()
        if got is not None:
            # the twin's objects stay pristine: this path writes into them
            return copy.deepcopy(got[0])
        if self.kubeconfig:
            self._refresh_snapshot()
            return copy.deepcopy(self._snapshot)
        return ResourceTypes()

    def _refresh_snapshot(self) -> None:
        with self._snapshot_lock:
            self._refresh_snapshot_locked()

    def _refresh_snapshot_locked(self) -> None:
        now = time.monotonic()
        if self._snapshot is not None and not (self.snapshot_ttl_s <= 0 or now - self._snapshot_at > self.snapshot_ttl_s):
            # within the TTL window after a degrade the cached snapshot is
            # still the stale one: this request is tagged too
            _mark_request_snapshot(self.snapshot_stale)
            return
        check_deadline("snapshot")
        attempts, base_delay = snapshot_retry_policy()

        def _fetch() -> ResourceTypes:
            faults.fault_point("snapshot.http")
            return cluster_from_kubeconfig(self.kubeconfig, self.master)

        def _note_retry(attempt: int, exc: BaseException, delay: float) -> None:
            self.metrics.bump("snapshot_retries")
            log.warning("snapshot fetch attempt %d failed (%s: %s); retrying in %.3fs",
                        attempt + 1, type(exc).__name__, exc, delay)

        with tracing.span("snapshot") as snap_span:
            try:
                # the one retry layer of the snapshot fetch; only the
                # transient class retries — a missing kubeconfig or an auth
                # misconfiguration will not heal and surfaces now
                self._snapshot = retry_call(
                    _fetch, attempts=attempts, base_delay=base_delay, retry_on=(SnapshotFetchError, TimeoutError),
                    on_retry=_note_retry, trace_name="snapshot.retry",
                )
            except (SnapshotFetchError, TimeoutError) as e:
                if self._snapshot is not None:
                    # degrade: serve the last good snapshot, tagged stale, and
                    # re-arm the TTL so a down apiserver is probed once per
                    # TTL window instead of on every request
                    self.snapshot_stale = True
                    _mark_request_snapshot(True)
                    self._snapshot_at = now
                    self.metrics.bump("snapshot_stale_served")
                    snap_span.mark("demoted", reason="stale snapshot served",
                                   age_s=round(now - self._snapshot_fetched_at, 3),
                                   error=f"{type(e).__name__}: {e}")
                    log.warning("snapshot refresh failed after %d attempt(s) (%s: %s); serving stale snapshot "
                                "(age %.1fs)", attempts, type(e).__name__, e, now - self._snapshot_fetched_at)
                    return
                raise SnapshotUnavailable(f"cluster snapshot unavailable after {attempts} attempt(s): {e}") from e
        self._snapshot_at = now
        self._snapshot_fetched_at = now
        self.snapshot_stale = False
        _mark_request_snapshot(False)
        self._snapshot_fp = None  # re-fingerprint lazily

    def _snapshot_for_cache(self) -> Tuple[ResourceTypes, str]:
        """(cluster, content fingerprint) for the encode-cache path — no
        defensive copy: the cached Prepared owns sanitized pod copies and
        its bind state is restored after every use, so the snapshot objects
        are never written. A fingerprint change (a refresh picked up cluster
        changes) invalidates the entries of the old one."""
        if self.base_cluster is not None:
            with self._snapshot_lock:
                if self._snapshot_fp is None:
                    self._snapshot_fp = prepcache.fingerprint_cluster(self.base_cluster)
                return self.base_cluster, self._snapshot_fp
        got = self._twin_snapshot()
        if got is not None:
            # keyed by the twin's generation, not by content: every applied
            # event bumps it, and the watch supervisor owns the base entry
            # (it replaces it by O(changes) deltas)
            return got
        if self.kubeconfig:
            # fetch + fingerprint + invalidation under ONE lock: a concurrent
            # refresh swapping the snapshot between the two reads would cache
            # a prepare under the wrong fingerprint
            with self._snapshot_lock:
                old_fp = self._snapshot_fp
                self._refresh_snapshot_locked()
                if self._snapshot_fp is None:
                    self._snapshot_fp = prepcache.fingerprint_cluster(self._snapshot)
                    if old_fp is not None and old_fp != self._snapshot_fp:
                        self.prep_cache.invalidate(old_fp)
                return self._snapshot, self._snapshot_fp
        return ResourceTypes(), "empty"

    def kernel_variants(self) -> List[str]:
        """The kernel variants this server's requests launch on its current
        snapshot (:func:`serving_variants`)."""
        cluster = None
        if self.base_cluster is not None or self.kubeconfig:
            cluster = self._snapshot_for_cache()[0] if self.prep_cache is not None else self.current_cluster()
        return serving_variants(cluster)

    # -- capacity observatory -------------------------------------------------

    def _observed_cluster(self) -> Tuple[ResourceTypes, str]:
        """(cluster, stable key) for the capacity view: the cache path's
        (snapshot, fingerprint) pair, or a content fingerprint on the
        cache-off path."""
        if self.prep_cache is not None:
            return self._snapshot_for_cache()
        cluster = self.current_cluster()
        return cluster, prepcache.fingerprint_cluster(cluster)

    def _probe_headroom(self, cluster: ResourceTypes, key: str) -> dict:
        """Headroom per registered profile, probed through the warm base
        entry of the encode cache (one delta re-encode and the kernel's
        ladder and bisection launches a profile; creating a missing base is
        the serving path's cold prepare). Keyed by the snapshot key: one
        probe set per observed cluster state."""
        if self.capacity is None:
            return {}
        # serialized: concurrent reports must not probe the same state
        # twice, and a slow probe of an OLDER snapshot must not overwrite a
        # newer probe's published gauges (the generation watermark)
        with self._headroom_lock:
            if self._headroom_key == key:
                return self.capacity.headroom()
            gen0 = self.capacity.generation
            profiles = capacity_mod.headroom_profiles()
            base = None
            if self.prep_cache is not None:
                base_key = f"{key}|base"
                base = self.prep_cache.get(base_key)
                if base is None:
                    watch = prepcache.watch_snapshot(cluster, [])  # before the build
                    base = self.prep_cache.put(
                        base_key, prepcache.CacheEntry(base_key, prepare(cluster, [], device=self.device), watch=watch))
                self.prep_cache.check_fresh(base)
                if base.prep is None:
                    base = None  # no schedulable pods cached: the probe prepares afresh
            out = {}
            for profile in profiles:
                out[profile.name] = capacity_mod.headroom_probe(
                    cluster, profile, base=base, kmax=self.capacity.fit_upper_bound(profile), device=self.device)
            if gen0 >= self._headroom_pub_gen:
                self.capacity.set_headroom(out)
                self._headroom_key = key
                self._headroom_pub_gen = gen0
            return out

    def cluster_report(self, extended: Optional[List[str]] = None, probe_headroom: bool = True,
                       include_memory: bool = False) -> dict:
        """The ``GET /api/cluster/report`` body: the capacity sample plus
        the same table rows the text renderer prints
        (``obs/capacity.build_report``). ``include_memory`` (``?mem=1``)
        adds the memory observatory's block: its summary and the rows
        ``simon top --mem`` renders (``obs/footprint.memory_rows``)."""
        if self.capacity is None:
            raise RuntimeError("capacity observatory disabled (capacity=False)")
        cluster, key = self._observed_cluster()
        self.capacity.ensure_bootstrap(cluster, key)
        if probe_headroom:
            self._probe_headroom(cluster, key)
        state = self.watch.state() if self.watch is not None else "polling"
        report = capacity_mod.build_report(self.capacity, cluster, extended_resources=extended, state=state)
        if include_memory:
            summary = self.memory.summary()
            report["memory"] = {"summary": summary, "rows": memory_rows(summary)}
        return report

    # -- campaigns ----------------------------------------------------------------

    def run_campaign(self, payload: dict, deadline: Optional[Deadline] = None) -> tuple:
        """``POST /api/campaign``: evaluate a lifecycle campaign — the body's
        ``steps``, the shape of a campaign file's ``spec.steps`` — against
        the observed cluster (the live twin once synced, else the polling
        snapshot, or the fixed cluster).
        Campaigns are serialized: each builds its own prepared lineage
        (one full prepare in warm mode) and never writes the snapshot's
        objects. Step fields naming server-side paths are refused, at
        parse and at run time. Returns ``(status, body)``."""
        try:
            with campaign_mod.remote_spec_context():
                steps = campaign_mod.parse_steps(payload.get("steps"))
        except campaign_mod.CampaignError as e:
            return 400, {"error": str(e), "step": e.step, "field": e.field}
        name = str(payload.get("name") or "campaign")
        mode = payload.get("mode") or None
        try:
            with deadline_scope(deadline), self._campaign_lock, tracing.span("campaign", steps=len(steps)):
                cluster, _key = self._observed_cluster()
                with campaign_mod.remote_spec_context():
                    result = campaign_mod.run_campaign(cluster, steps, mode=mode, name=name, device=self.device)
            return 200, result.to_dict()
        except DeadlineExceeded as e:
            return 504, {"error": str(e), "phase": e.phase, "retryable": True}
        except SnapshotUnavailable as e:
            return 503, {"error": str(e), "retryable": True}
        except campaign_mod.CampaignError as e:
            return 400, {"error": str(e), "step": e.step, "field": e.field}

    # -- simulation -----------------------------------------------------------

    def _simulate_request(self, kind: str, payload: dict, explain: bool = False) -> SimulateResult:
        """`_simulate_request_once` plus stale-entry recovery: a
        ``StaleFingerprintError`` means a fingerprinted object was
        ``touch()``ed behind the cache's back, and
        ``PrepareCache.check_fresh`` already evicted everything it taints,
        so ONE internal retry re-prepares from the live objects (a REST
        client cannot call ``invalidate(obj)``). A second stale failure
        propagates as a typed 500."""
        try:
            return self._simulate_request_once(kind, payload, explain=explain)
        except prepcache.StaleFingerprintError as e:
            self.metrics.bump("stale_prep_retries")
            log.warning("stale prepare-cache entry (%s); retrying once after eviction", e)
            return self._simulate_request_once(kind, payload, explain=explain)

    def _simulated(self, rung: str, t_cache: float, cluster: ResourceTypes, apps: List[AppResource], explain: bool,
                   **kw) -> SimulateResult:
        """simulate() on this server's device, with the cache rung the
        request took and the host-clock times of its phases (the cache's
        work, then simulate()'s prepare, inputs, kernel and decode) on the
        request's trace."""
        from ..ops import fast_scan as fs

        launched0 = dict(fs.VARIANT_LAUNCHES)
        # simulate() records its own phase spans (prepare, encode,
        # schedule with the kernel's child, decode) under this one
        with tracing.span("simulate", rung=rung):
            result = simulate(cluster, apps, device=self.device, explain=explain, **kw)
        tr = tracing.current_trace()
        if tr is not None:
            # the kernel variants launched meanwhile, as "name=count,...":
            # the request's own with one request at a time (a fleet worker's
            # launches are visible nowhere else outside its process)
            launched = ",".join(f"{k}={v - launched0.get(k, 0)}" for k, v in sorted(fs.VARIANT_LAUNCHES.items())
                                if v != launched0.get(k, 0))
            tr.root.set(rung=rung, cache_s=round(t_cache, 6), engine=result.engine, launches=launched,
                        **{f"{k}_s": round(v, 6) for k, v in result.timings.items()})
        return result

    def _simulate_request_once(self, kind: str, payload: dict, explain: bool = False) -> SimulateResult:
        """Shared deploy/scale simulation through the encode cache, by rung:

        1. an identical repeated request → full-key hit: restore + simulate,
           no re-encode (``hit``);
        2. a known snapshot → base-entry delta: append the request's app
           pods, extend the nodes by its ``newnodes``, flip the pod-validity
           bits of scaled-away pods (``delta``);
        3. cold → one full prepare of the snapshot, cached for 1 and 2,
           then the delta (``cold``).
        """
        t0 = time.monotonic()
        new_nodes = _decode_new_nodes(payload)
        app = _decode_app(payload)
        apps = [AppResource(kind, app)]
        scaled: set = set()
        if kind == "scale":
            scaled = {(w.kind, w.metadata.namespace, w.metadata.name)
                      for w in app.deployments + app.daemon_sets + app.stateful_sets}

        if self.prep_cache is None:
            # per-request snapshot copy + full prepare
            cluster = _with_new_nodes(self.current_cluster(), new_nodes)
            if scaled:
                cluster.pods = [p for p in cluster.pods if not _owned_by(p, scaled)]
            return self._simulated("uncached", time.monotonic() - t0, cluster, apps, explain)

        cluster0, fp = self._snapshot_for_cache()
        cluster = _with_new_nodes(cluster0, new_nodes)

        def _filtered() -> ResourceTypes:
            # only the full-prepare fallbacks need the scaled pods removed
            # from the input; the cached paths mask them out instead
            if not scaled:
                return cluster
            out = _with_new_nodes(cluster0, new_nodes)
            out.pods = [p for p in cluster0.pods if not _owned_by(p, scaled)]
            return out

        payload_fp = hashlib.blake2b(json.dumps(payload, sort_keys=True, default=str).encode(),
                                     digest_size=16).hexdigest()
        full_key = f"{fp}|{kind}|{payload_fp}"
        # full-key reuse only without newnodes: fake-node names are fresh per
        # request, and a cached derived prep would replay the first
        # request's names into later responses
        entry = self.prep_cache.get(full_key) if not new_nodes else None
        if entry is not None and entry.prep is not None:
            self.prep_cache.check_fresh(entry)
            with entry.lock:
                t1 = time.monotonic()
                entry.restore()
                PREP_STATS.record("hit", time.monotonic() - t1)
                try:
                    return self._simulated("hit", time.monotonic() - t0, cluster, apps, explain, prep=entry.prep,
                                           drop_pods=entry.drop_mask)
                finally:
                    entry.restore()

        base_key = f"{fp}|base"
        base = self.prep_cache.get(base_key)
        rung = "delta"
        if base is None:
            watch = prepcache.watch_snapshot(cluster0, [])  # before the build
            base = self.prep_cache.put(
                base_key, prepcache.CacheEntry(base_key, prepare(cluster0, [], device=self.device), watch=watch))
            rung = "cold"
        if base.prep is None:
            # a snapshot with no schedulable pods: nothing worth caching
            return self._simulated("empty", time.monotonic() - t0, _filtered(), apps, explain)
        self.prep_cache.check_fresh(base)
        with base.lock:
            base.restore()
            base_prep = base.prep
            if new_nodes:
                base_prep = prepcache.extend_with_nodes(base_prep, new_nodes, cluster0, [], base_entry=base)
            derived = (prepcache.derive_with_apps(base_prep, cluster, apps, base_entry=base if not new_nodes else None)
                       if base_prep is not None else None)
            if derived is None:
                return self._simulated(f"{rung}: full prepare", time.monotonic() - t0, _filtered(), apps, explain)
            # the scale request's removals joined with the live twin's
            # event-deleted pods (base_drop: kept in the cached stream,
            # their validity flipped)
            drop = prepcache.union_drop_masks(
                base.base_drop, prepcache.drop_mask_for_scaled(derived, _owned_by, scaled) if scaled else None,
                len(derived.ordered))
            entry = prepcache.CacheEntry(full_key, derived, base=base)
            entry.drop_mask = drop
            if not new_nodes:
                self.prep_cache.put(full_key, entry)
            try:
                return self._simulated(rung, time.monotonic() - t0, cluster, apps, explain, prep=derived,
                                       drop_pods=drop)
            finally:
                entry.restore()

    # -- the admission queue's executors ---------------------------------------
    #
    # They run on the dispatcher's, the pipeline's and the worker pool's
    # threads, never on the HTTP handler's: they talk to it through the
    # ticket alone (result or error, and the stale flag observed on the
    # executing thread, since _REQUEST_STATE is thread-local).

    def _admitted_solo(self, ticket) -> None:
        """A request alone: the `_simulate_request` path (the encode
        cache's rungs, one launch of the one scan, one stale retry), with
        the request's deadline and trace installed on this thread."""
        _mark_request_snapshot(False)
        _REQUEST_STATE.request_id = ticket.request_id
        try:
            with deadline_scope(ticket.deadline), tracing.trace_scope(ticket.trace):
                result = self._simulate_request(ticket.kind, ticket.payload, explain=ticket.explain)
            ticket.resolve(result=result, stale=request_served_stale())
        except BaseException as e:
            # carried to the handler thread, which answers it on its typed
            # ladder (504/503/500) and logs it there
            log.debug("solo execution failed: %s: %s", type(e).__name__, e)
            ticket.resolve(error=e, stale=request_served_stale())

    def _admitted_batch(self, tickets) -> None:
        """The serial batch path: one retry after a stale-entry eviction,
        as the solo path, and solo runs when the stream cannot batch."""
        try:
            try:
                self._run_batch_once(tickets)
            except prepcache.StaleFingerprintError as e:
                self.metrics.bump("stale_prep_retries")
                log.warning("stale prepare-cache entry in batch (%s); retrying once after eviction", e)
                self._run_batch_once(tickets)
        except _BatchUnroutable as e:
            log.info("batch of %d unroutable (%s); running solo", len(tickets), e)
            for t in tickets:
                self._admitted_solo(t)
        except BaseException as e:
            # one failure fails the group with the typed error a solo run
            # would give, never a partial result
            log.warning("batch of %d failed (%s: %s); failing the group", len(tickets), type(e).__name__, e)
            for t in tickets:
                if not t.done.is_set():
                    t.resolve(error=e)

    def _run_batch_once(self, tickets) -> None:
        """The three stage executors in a row (prep → dispatch → decode),
        so the serial and the pipelined paths share one implementation."""
        state = self._batch_prep_once(tickets)
        if state is None:
            return  # every rider resolved already (payloads that failed to decode)
        self._batch_decode(self._batch_dispatch(state))

    def _batch_prep_once(self, tickets) -> Optional[_BatchState]:
        """Stage 1, host prep under the base entry's lock: the snapshot,
        each rider's payload, one shared derive with every rider's app
        slice, each rider's drops. The derived prep it hands on is not
        changed after the lock is released."""
        import numpy as np

        from ..engine import reqbatch

        _mark_request_snapshot(False)
        t0 = time.monotonic()
        cluster0, fp = self._snapshot_for_cache()
        stale = request_served_stale()
        if self.watch is not None and fp.startswith(self.watch.key_prefix):
            for t in tickets:
                if t.trace is not None:
                    # the twin generation the batch was served from
                    t.trace.root.set(twin_key=fp)
        apps: List[AppResource] = []
        scaled_sets: List[set] = []
        kept = []
        for t in tickets:
            # one malformed payload fails its own request (typed 500), never
            # the batch
            try:
                app = _decode_app(t.payload)
            except Exception as e:
                log.warning("batch rider payload failed to decode (%s: %s)", type(e).__name__, e)
                t.resolve(error=e, stale=stale)
                continue
            kept.append(t)
            apps.append(AppResource(t.kind, app))
            scaled_sets.append({(w.kind, w.metadata.namespace, w.metadata.name)
                                for w in app.deployments + app.daemon_sets + app.stateful_sets}
                               if t.kind == "scale" else set())
        tickets = kept
        if not tickets:
            return None
        base_key = f"{fp}|base"
        base = self.prep_cache.get(base_key)
        if base is None:
            watch = prepcache.watch_snapshot(cluster0, [])  # before the build
            base = self.prep_cache.put(
                base_key, prepcache.CacheEntry(base_key, prepare(cluster0, [], device=self.device), watch=watch))
        self.prep_cache.check_fresh(base)
        with base.lock:
            base.restore()
            if base.prep is None:
                # the solo path's "empty" rung prepares each request afresh
                raise _BatchUnroutable("the snapshot has no schedulable pods to derive from")
            got = prepcache.derive_with_app_slices(base.prep, cluster0, apps, base_entry=base)
            if got is None:
                raise _BatchUnroutable("delta re-encode declined the stream")
            derived, slices = got
            items = []
            for s, t in enumerate(tickets):
                drop = prepcache.union_drop_masks(
                    base.base_drop,
                    prepcache.drop_mask_for_scaled(derived, _owned_by, scaled_sets[s]) if scaled_sets[s] else None,
                    len(derived.ordered))
                items.append(reqbatch.BatchItem(
                    cluster=cluster0, apps=[apps[s]], lo=slices[s][0], hi=slices[s][1],
                    drops=set(np.nonzero(drop)[0].tolist()) if drop is not None else set(),
                    explain=t.explain, deadline=t.deadline,
                ))
        return _BatchState(tickets, base, derived, items, stale, time.monotonic() - t0)

    def _batch_prep(self, tickets) -> Optional[_BatchState]:
        """The pipelined controller's ``prep_fn``: `_batch_prep_once` with
        one retry after a stale-entry eviction, and None for a batch that
        cannot ride the shared base (the controller then runs its riders
        solo)."""
        try:
            try:
                return self._batch_prep_once(tickets)
            except prepcache.StaleFingerprintError as e:
                self.metrics.bump("stale_prep_retries")
                log.warning("stale prepare-cache entry in batch (%s); retrying once after eviction", e)
                return self._batch_prep_once(tickets)
        except _BatchUnroutable as e:
            log.info("batch of %d unroutable (%s); degrading to solo", len(tickets), e)
            return None

    def _batch_dispatch(self, state: _BatchState) -> _BatchState:
        """Stage 2, the launch, without the base entry's lock: it touches
        only the derived prep and device buffers, so the next batch's host
        prep overlaps it."""
        from ..engine import reqbatch

        t0 = time.monotonic()
        state.dispatch = reqbatch.dispatch_request_batch(state.derived, state.items)
        state.dispatch_s = time.monotonic() - t0
        return state

    def _batch_decode(self, state: _BatchState) -> None:
        """Stage 3, each rider's result under the base entry's lock (the
        decode writes the shared pod objects' bind state, restored for the
        next holder)."""
        from ..engine import reqbatch

        tickets, base, stale = state.tickets, state.base, state.stale
        t1 = time.monotonic()
        with base.lock:
            base.restore()
            try:
                results = reqbatch.decode_request_batch(state.derived, state.items, state.dispatch)
            finally:
                base.restore()
        run_s = state.dispatch_s + (time.monotonic() - t1)
        for t, res in zip(tickets, results):
            if isinstance(res, BaseException):
                # a rider shed before the launch: answered on the typed
                # ladder (504 phase=schedule)
                t.resolve(error=res, stale=stale)
                continue
            tr = t.trace
            if tr is not None:
                # the shared batch work, on every rider's trace, so the
                # per-phase histograms see batched traffic too
                tr.root.child_from_seconds("prepare", state.prep_s, batched=True, batch=len(tickets))
                tr.root.child_from_seconds("schedule", run_s, batched=True, batch=len(tickets))
            t.resolve(result=res, stale=stale, batch_size=len(tickets))

    def _handle_admitted(self, endpoint: str, kind: str, payload: dict, deadline: Optional[Deadline] = None,
                         request_id: Optional[str] = None, explain: bool = False) -> tuple:
        """The admission path's endpoint shell: the typed failure ladder of
        :meth:`_handle` plus the queue's two sheds:

        - 503 + reason (``queue_full``, ``shutting_down``) + ``Retry-After``:
          the queue is at its bound, or the server is stopping;
        - 504 + phase ``queue``: the deadline ran out while queued (phase
          ``schedule``: before the batch's launch).

        Every outcome records its real elapsed time in the request
        histogram."""
        import math

        rid = tracing.sanitize_request_id(request_id) or tracing.new_request_id()
        _REQUEST_STATE.request_id = rid
        _REQUEST_STATE.extra_headers = {}
        _mark_request_snapshot(False)
        tr = tracing.start_trace(endpoint, request_id=rid)
        t0 = time.monotonic()
        status = "error"
        code, body = 500, {"error": "unhandled"}
        result: Optional[SimulateResult] = None
        ticket = None
        try:
            has_new_nodes = bool(payload.get("newnodes") or payload.get("NewNodes"))
            ticket = admission_mod.Ticket(
                kind=kind, payload=payload, explain=explain, deadline=deadline, trace=tr, request_id=rid,
                # with the cache off every request prepares afresh: solo on
                # the pool, never batched
                has_new_nodes=has_new_nodes or self.prep_cache is None,
            )
            self.admission.submit(ticket)
            self.admission.wait(ticket)
            result = ticket.result
            _mark_request_snapshot(ticket.stale)
            status = "ok"
            if tr is not None:
                tr.root.set(engine=result.engine)
                if ticket.batch_size:
                    tr.root.set(batch_size=ticket.batch_size)
            code, body = 200, _response(result, explain=explain)
            if explain and tr is not None and result.explanations is not None:
                tr.placements = _placements_payload(rid, result)
        except admission_mod.QueueFull as e:
            status = "shed"
            log.warning("%s shed: %s", endpoint, e)
            _REQUEST_STATE.extra_headers = {"Retry-After": str(max(1, int(math.ceil(e.retry_after_s))))}
            # overload (queue_full: retry here later) or shutdown
            # (shutting_down: retry against another replica)
            code, body = 503, {"error": str(e), "reason": e.reason, "retryable": True}
        except DeadlineExceeded as e:
            status = "deadline-exceeded"
            self.metrics.bump("request_timeouts")
            log.warning("%s timed out: %s", endpoint, e)
            code, body = 504, {"error": str(e), "phase": e.phase}
        except SnapshotUnavailable as e:
            log.warning("%s snapshot unavailable: %s", endpoint, e)
            code, body = 503, {"error": str(e), "retryable": True}
        except Exception as e:  # a failed build or launch too
            log.warning("%s failed: %s: %s", endpoint, type(e).__name__, e)
            code, body = 500, {"error": str(e), "type": type(e).__name__}
        finally:
            seconds = time.monotonic() - t0
            with RECORDER.lock:
                if status == "ok" and result is not None:
                    self.metrics.record(endpoint, result)
                RECORDER.observe_request(endpoint, seconds, status=status)
            if tr is not None:
                if ticket is not None and ticket.queue_s:
                    # the real time in queue, on the span tree too
                    tr.root.child_from_seconds("queue", ticket.queue_s)
                self._stamp_fleet_trace(tr)
                tr.finish(status=status, http_status=code)
                FLIGHT_RECORDER.record(tr)
                RECORDER.observe_trace(tr)
        return code, body

    # -- endpoints ------------------------------------------------------------

    def _handle(self, endpoint: str, kind: str, lock: threading.Lock, payload: dict,
                deadline: Optional[Deadline] = None, request_id: Optional[str] = None,
                explain: bool = False) -> tuple:
        """Shared endpoint shell: single-flight busy rejection, deadline
        scope, request-scoped trace, and the failure ladder — every outcome
        is a typed JSON body:

        - 200: the simulation's result
        - 503 busy: TryLock rejection (server.go:167,:234)
        - 504 + phase: the request deadline ran out at a phase boundary
        - 503 + retryable: the apiserver down through every retry with no
          snapshot to degrade to
        - 500 + type: anything else, a failed kernel build or launch too

        Every request gets an id (the client's ``X-Simon-Request-Id``
        honored, generated otherwise) and, when tracing is enabled, a span
        tree recorded into the flight recorder and folded into the
        ``/metrics`` latency histograms.

        With the admission queue on (the default) requests go through
        :meth:`_handle_admitted` instead; this single-flight shell is the
        ``admission=False`` path."""
        if self.admission is not None:
            return self._handle_admitted(endpoint, kind, payload, deadline, request_id, explain=explain)
        t0 = time.monotonic()
        rid = tracing.sanitize_request_id(request_id) or tracing.new_request_id()
        _REQUEST_STATE.request_id = rid
        if not lock.acquire(blocking=False):
            RECORDER.observe_request(endpoint, time.monotonic() - t0, status="busy")
            return 503, {"error": "the server is busy now, please try again later"}
        _mark_request_snapshot(False)  # until a refresh says otherwise
        tr = tracing.start_trace(endpoint, request_id=rid)
        t0 = time.monotonic()
        status = "error"
        code, body = 500, {"error": "unhandled"}
        result: Optional[SimulateResult] = None
        try:
            with deadline_scope(deadline), tracing.trace_scope(tr):
                result = self._simulate_request(kind, payload, explain=explain)
            status = "ok"
            code, body = 200, _response(result, explain=explain)
            if explain and tr is not None and result.explanations is not None:
                # the decision audit joins the flight recorder, served at
                # GET /api/debug/placements/<request-id> (serialized and
                # capped: the context holding the whole Prepared is dropped)
                tr.placements = _placements_payload(rid, result)
        except DeadlineExceeded as e:
            status = "deadline-exceeded"
            self.metrics.bump("request_timeouts")
            log.warning("%s timed out: %s", endpoint, e)
            code, body = 504, {"error": str(e), "phase": e.phase}
        except SnapshotUnavailable as e:
            log.warning("%s snapshot unavailable: %s", endpoint, e)
            code, body = 503, {"error": str(e), "retryable": True}
        except Exception as e:  # a 500 like gin's error handler
            log.warning("%s failed: %s: %s", endpoint, type(e).__name__, e)
            code, body = 500, {"error": str(e), "type": type(e).__name__}
        finally:
            try:
                seconds = time.monotonic() - t0
                # the success counters and the histogram land in one
                # critical section: a scrape never sees one without the other
                with RECORDER.lock:
                    if status == "ok" and result is not None:
                        self.metrics.record(endpoint, result)
                    RECORDER.observe_request(endpoint, seconds, status=status)
                if tr is not None:
                    self._stamp_fleet_trace(tr)
                    tr.finish(status=status, http_status=code)
                    FLIGHT_RECORDER.record(tr)
                    RECORDER.observe_trace(tr)
            finally:
                # released even if telemetry recording throws: a leaked lock
                # would 503 the endpoint until restart
                lock.release()
        return code, body

    def deploy_apps(self, payload: dict, deadline: Optional[Deadline] = None, request_id: Optional[str] = None,
                    explain: bool = False) -> tuple:
        return self._handle("deploy-apps", "deploy", self._deploy_lock, payload, deadline, request_id,
                            explain=explain)

    def scale_apps(self, payload: dict, deadline: Optional[Deadline] = None, request_id: Optional[str] = None,
                   explain: bool = False) -> tuple:
        """scale-apps (server.go:233-312): remove the workload's existing
        pods from the cluster snapshot, then re-simulate at the new scale —
        on the cached path the removal is a pod-validity flip over the
        snapshot's cached encoding, not a re-encode."""
        return self._handle("scale-apps", "scale", self._scale_lock, payload, deadline, request_id,
                            explain=explain)


def _owned_by(pod, scaled: set) -> bool:
    for ref in pod.metadata.owner_references:
        key = (ref.kind, pod.metadata.namespace, ref.name)
        if key in scaled:
            return True
        # deployment pods are owned via a generated ReplicaSet name prefix
        if ref.kind == "ReplicaSet" and any(
            k == "Deployment" and ns == pod.metadata.namespace and ref.name.startswith(name + "-")
            for k, ns, name in scaled
        ):
            return True
    return False


def _template_pods(pods: List) -> List:
    """One pod of each owner among `pods` (a bare pod is its own): the
    pods of one controller share its pod template, so they encode to the
    same features."""
    seen, out = set(), []
    for p in pods:
        owners = tuple((r.kind, r.name) for r in p.metadata.owner_references)
        key = (p.metadata.namespace, owners) if owners else id(p)
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


def snapshot_variants(cluster: ResourceTypes) -> set:
    """The kernel variant of a stream of `cluster`'s pods, its explain
    variant and its counting grid (an empty set with no pods to place):
    read from a host-only
    prepare of one pod per owner (:func:`_template_pods`), not of the
    whole snapshot, whose encode the server's first request does anyway."""
    from ..engine import fastpath
    from ..ops import fast_scan as fs

    few = copy.copy(cluster)
    few.pods = _template_pods(cluster.pods)
    prep = prepare(few, [], device="cpu")
    if prep is None:
        return set()
    fi, _ = fastpath.build_inputs(prep)
    return {fs.variant_name(fi), fs.variant_name(fi, explain=True), fs.variant_name(fi, count=True)}


def serving_variants(cluster: Optional[ResourceTypes] = None) -> List[str]:
    """The kernel variants a server's requests launch on `cluster` (its
    snapshot: :func:`snapshot_variants`) and the base variant, each also
    in explain mode and as the request batch's counting grid. A request
    whose app brings other features (GPU shares, ports, volumes, inter-pod
    terms) builds its variant when it first needs it."""
    names = {"fast_scan", "fast_scan[explain]", "fast_scan[count]"}
    if cluster is not None:
        names |= snapshot_variants(cluster)
    return sorted(names)


def _with_new_nodes(cluster: ResourceTypes, nodes: List[Node]) -> ResourceTypes:
    out = copy.copy(cluster)
    out.nodes = list(cluster.nodes) + nodes
    return out


def request_deadline(headers) -> Optional[Deadline]:
    """Per-request deadline: the ``X-Simon-Timeout-S`` header wins, else
    ``OPENSIM_REQUEST_TIMEOUT_S`` (unset/0 = no deadline)."""
    raw = headers.get("X-Simon-Timeout-S") if headers is not None else None
    if raw is None:
        raw = envknobs.raw("OPENSIM_REQUEST_TIMEOUT_S")
    if not raw:
        return None
    try:
        budget = float(raw)
    except ValueError:
        log.warning("ignoring unparseable request timeout %r", raw)
        return None
    return Deadline.after(budget) if budget > 0 else None


def make_handler(server: SimonServer):
    class Handler(BaseHTTPRequestHandler):
        # keep-alive: every response carries Content-Length, so HTTP/1.1
        # persistent connections are safe
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _begin_request(self) -> None:
            # every request — GETs and 4xx paths included — gets an id here,
            # so an access-log line always joins against the flight recorder
            self._t0 = time.monotonic()
            _REQUEST_STATE.extra_headers = {}
            _REQUEST_STATE.request_id = (tracing.sanitize_request_id(self.headers.get("X-Simon-Request-Id"))
                                         or tracing.new_request_id())

        def _access_log(self, code: int) -> None:
            """Opt-in structured access logging (``OPENSIM_ACCESS_LOG=1``):
            one JSON object per request."""
            if envknobs.raw("OPENSIM_ACCESS_LOG") != "1":
                return
            _ACCESS_LOG.info("%s", json.dumps({
                "ts": round(time.time(), 3), "request_id": last_request_id(), "method": self.command,
                "endpoint": self.path, "status": code,
                "duration_s": round(time.monotonic() - getattr(self, "_t0", time.monotonic()), 6),
                "remote": self.client_address[0],
            }, sort_keys=True))

        def _send_bytes(self, code: int, data: bytes, content_type: str, extra_headers: Optional[dict] = None):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            if last_request_id():
                self.send_header("X-Simon-Request-Id", last_request_id())
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)
            self._access_log(code)

        def _send(self, code: int, body: dict, extra_headers: Optional[dict] = None) -> None:
            self._send_bytes(code, json.dumps(body).encode(), "application/json", extra_headers)

        def do_GET(self):  # noqa: N802 (stdlib name)
            self._begin_request()
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                self._send(200, {"status": "ok"})
            elif path == "/metrics":
                self._send_bytes(200, server.metrics_text().encode(), "text/plain; version=0.0.4")
            elif path == "/api/debug/requests":
                # newest-first summaries of the last N request traces
                self._send(200, {"requests": FLIGHT_RECORDER.summaries()})
            elif path.startswith("/api/debug/requests/"):
                rid = tracing.sanitize_request_id(path.rsplit("/", 1)[1])
                tr = FLIGHT_RECORDER.get(rid)
                if tr is None:
                    self._send(404, {"error": f"no recorded trace for request id {rid!r}"})
                else:
                    body = tr.tree()
                    # a fleet worker's request: graft the owner-side
                    # publication subtree under the worker-side tree
                    gen = getattr(tr, "serving_generation", None)
                    if gen is not None:
                        from ..obs.fleetobs import publication_tree

                        fleet_node = publication_tree(gen)
                        if fleet_node is not None:
                            body["fleet"] = fleet_node
                    self._send(200, body)
            elif path == "/api/debug/timeseries":
                # the on-disk time-series ring: serve() starts it; bare
                # SimonServer constructions answer 503
                if server.timeseries is None:
                    self._send(503, {"error": "time-series ring not running"})
                else:
                    from urllib.parse import parse_qs

                    from ..obs.timeseries import parse_duration_s

                    q = parse_qs(self.path.partition("?")[2])
                    try:
                        range_s = parse_duration_s(q.get("range", [""])[-1])
                    except ValueError as e:
                        self._send(400, {"error": str(e)})
                    else:
                        self._send(200, {"stats": server.timeseries.stats(),
                                         "samples": server.timeseries.query(family=q.get("family", [""])[-1],
                                                                            range_s=range_s)})
            elif path == "/api/fleet/slo":
                # SLO burn rates, the surface the fleet's admin endpoint
                # serves too
                if server.slo is None:
                    self._send(503, {"error": "SLO engine not running"})
                else:
                    self._send(200, server.slo.evaluate())
            elif path.startswith("/api/debug/placements/"):
                rid = tracing.sanitize_request_id(path.rsplit("/", 1)[1])
                tr = FLIGHT_RECORDER.get(rid)
                placements = getattr(tr, "placements", None) if tr is not None else None
                if placements is None:
                    self._send(404, {"error": f"no recorded placements for request id {rid!r}",
                                     "hint": "POST /api/deploy-apps?explain=1 records them"})
                else:
                    self._send(200, placements)
            elif path == "/api/cluster/report":
                # the live capacity report: the same rows as the text renderer
                from urllib.parse import parse_qs

                q = parse_qs(self.path.partition("?")[2])
                extended = [e for e in q.get("extended", [""])[-1].split(",") if e]
                probe = q.get("headroom", ["1"])[-1] not in ("0", "false")
                mem = q.get("mem", ["0"])[-1] not in ("", "0", "false")
                try:
                    self._send(200, server.cluster_report(extended=extended, probe_headroom=probe,
                                                          include_memory=mem))
                except SnapshotUnavailable as e:
                    self._send(503, {"error": str(e), "retryable": True})
                except Exception as e:  # a failed build or launch too
                    log.warning("cluster report failed: %s: %s", type(e).__name__, e)
                    self._send(500, {"error": str(e), "type": type(e).__name__})
            elif path == "/api/debug/capacity":
                # the capacity timeline ring (obs/timeline.py): one sample per
                # observed generation, for trend charts
                if server.capacity is None:
                    self._send(404, {"error": "capacity observatory disabled"})
                else:
                    server.capacity.sample()  # fold in the latest generation
                    self._send(200, {"capacity": server.capacity.timeline.capacity,
                                     "samples": [s.to_dict() for s in server.capacity.timeline.snapshot()]})
            elif path == "/api/debug/memory":
                # the memory observatory: per-entry arena attribution, ring
                # occupancy, RSS and device watermarks; ?fields=0 drops the
                # per-field breakdown for cheap polling
                from urllib.parse import parse_qs

                q = parse_qs(self.path.partition("?")[2])
                fields = q.get("fields", ["1"])[-1] not in ("0", "false")
                try:
                    self._send(200, server.memory.debug_payload(include_fields=fields))
                except Exception as e:
                    log.warning("memory debug failed: %s: %s", type(e).__name__, e)
                    self._send(500, {"error": str(e), "type": type(e).__name__})
            elif path == "/api/debug/profile":
                # the cumulative phase profiles, the kernels' build
                # telemetry and the admission pipeline's stage aggregates
                from ..obs import profile as profile_mod

                try:
                    payload = profile_mod.debug_payload()
                    if server.admission is not None:
                        payload["pipeline"] = server.admission.pipeline_snapshot()
                    self._send(200, payload)
                except Exception as e:
                    log.warning("profile debug failed: %s: %s", type(e).__name__, e)
                    self._send(500, {"error": str(e), "type": type(e).__name__})
            elif path == "/debug/profiler":
                # the pprof analogue (the reference registers pprof on gin,
                # server.go:152): a torch.profiler session over the whole
                # process; ?stop=1 ends it and writes its Chrome trace
                from urllib.parse import parse_qs

                from ..utils.trace import start_profiler, stop_profiler

                stop = parse_qs(self.path.partition("?")[2]).get("stop", ["0"])[-1] not in ("", "0", "false")
                try:
                    if stop:
                        done = stop_profiler()
                        if done is None:
                            self._send(409, {"error": "no profiler session is running"})
                        else:
                            self._send(200, done)
                    else:
                        self._send(200, start_profiler(server.profile_dir, cuda=server.device.type == "cuda"))
                except Exception as e:
                    log.warning("profiler %s failed: %s: %s", "stop" if stop else "start", type(e).__name__, e)
                    self._send(500, {"error": str(e)})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802 (stdlib name)
            self._begin_request()
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except ValueError:
                self._send(400, {"error": "invalid JSON body"})
                return
            deadline = request_deadline(self.headers)
            path, _, query = self.path.partition("?")
            from urllib.parse import parse_qs

            explain = parse_qs(query).get("explain", ["0"])[-1] not in ("", "0", "false")
            if path == "/api/deploy-apps":
                code, body = server.deploy_apps(payload, deadline=deadline, request_id=last_request_id(),
                                                explain=explain)
            elif path == "/api/scale-apps":
                code, body = server.scale_apps(payload, deadline=deadline, request_id=last_request_id(),
                                               explain=explain)
            elif path == "/api/campaign":
                # a what-if like the cluster report: runs inline on the
                # handler thread, serialized across requests
                code, body = server.run_campaign(payload, deadline=deadline)
            else:
                self._send(404, {"error": "not found"})
                return
            # a result computed from a stale snapshot says so (per request,
            # thread-local: a concurrent refresh must not mis-tag it); a
            # shed says when to retry
            extra = dict(response_extra_headers())
            if request_served_stale():
                extra["X-Simon-Snapshot"] = "stale"
            self._send(code, body, extra_headers=extra or None)

    return Handler


class SimonHTTPServer(ThreadingHTTPServer):
    """The serving listener: stdlib ``ThreadingHTTPServer`` with a backlog
    sized for hundreds of concurrent keep-alive clients (the default of 5
    resets most of a connect storm before a request is read)."""

    request_queue_size = 512


#: How long ``--watch on`` waits for the live twin's first sync at start.
SYNC_TIMEOUT_S = 60.0


def build_twin(kubeconfig: str, master: str, watch: str, journal: str):
    """(watch supervisor or None, journal or None) for a serving process.
    Raises ``ValueError`` on operator errors: ``--watch on`` without a
    kubeconfig (nothing to sync from), a journal without the twin (no
    event stream to record) or an unusable journal directory."""
    if watch == "on" and not kubeconfig:
        raise ValueError("--watch on requires --kubeconfig")
    supervisor = None
    if kubeconfig and watch != "off":
        from .watch import WatchSupervisor, source_from_kubeconfig, watch_policy

        policy = watch_policy()
        supervisor = WatchSupervisor(source_from_kubeconfig(kubeconfig, master or None,
                                                            read_timeout_s=policy["stale_s"]), policy=policy)
    jrnl = None
    if journal:
        if supervisor is None:
            raise ValueError("--journal requires the live twin (--kubeconfig and --watch auto|on)")
        from .journal import Journal, JournalError

        try:
            jrnl = Journal(journal)
        except JournalError as e:
            raise ValueError(str(e)) from e
    return supervisor, jrnl


def _check_args(kubeconfig: str, watch: str, journal: str) -> None:
    for label, path in (("--kubeconfig", kubeconfig), ("--journal", journal)):
        if any(ord(c) < 32 for c in path):
            raise ValueError(f"invalid {label}: control character in {path!r}")
    if watch not in ("auto", "on", "off"):
        raise ValueError(f"--watch must be auto, on or off, got {watch!r}")


def fleet_workers(flag: int = 0) -> int:
    """The fleet size: the ``--workers`` flag wins, else
    ``OPENSIM_WORKERS_FLEET``; 0 or 1 means single-process serving."""
    if flag:
        return flag
    raw = envknobs.raw("OPENSIM_WORKERS_FLEET")
    if not raw:
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        log.warning("ignoring unparseable OPENSIM_WORKERS_FLEET=%r", raw)
        return 0


def start_server(kubeconfig: str = "", master: str = "", port: int = 8080, watch: str = "auto", journal: str = "",
                 device: DeviceLike = None, host: str = "0.0.0.0",
                 snapshot_ttl_s: float = 30.0) -> Tuple[SimonServer, SimonHTTPServer]:
    """What :func:`serve` does before a single-process server serves:
    refuse operator errors, create the server on its device (raising without a card unless
    `device` names the CPU) with its live twin and journal
    (:func:`build_twin`), start the twin — with ``watch="on"`` wait up to
    :data:`SYNC_TIMEOUT_S` for it to sync (from the journal's checkpoint and
    suffix when it has one, else a relist) and raise if it cannot; with
    ``auto`` the polling snapshot serves until it has — then on the card
    build the kernel variants its requests launch
    (:meth:`SimonServer.kernel_variants`) so no request pays a build, and
    bind the listener. Returns both; the caller runs ``serve_forever``,
    ``shutdown`` and ``server.close()``."""
    _check_args(kubeconfig, watch, journal)
    supervisor, jrnl = build_twin(kubeconfig, master, watch, journal)
    try:
        server = SimonServer(kubeconfig=kubeconfig, master=master, snapshot_ttl_s=snapshot_ttl_s, device=device,
                             watch=supervisor, journal=jrnl)
    except BaseException:
        if jrnl is not None:
            jrnl.close()
        raise
    try:
        if supervisor is not None:
            t0 = time.perf_counter()
            synced = supervisor.start(wait_s=SYNC_TIMEOUT_S if watch == "on" else None)
            if not synced:
                raise RuntimeError(f"--watch on but the live twin could not sync in {SYNC_TIMEOUT_S:g} s")
            if watch == "on":
                log.info("live twin synced in %.3f s: generation %d", time.perf_counter() - t0,
                         supervisor.twin.generation)
        if server.device.type == "cuda":
            from ..ops import fast_scan as fs

            variants = server.kernel_variants()
            t0 = time.perf_counter()
            fs.build(variants)
            log.info("kernel variants %s loaded in %.3f s", ", ".join(variants), time.perf_counter() - t0)
        return server, SimonHTTPServer((host, port), make_handler(server))
    except BaseException:
        server.close()
        raise


def serve(kubeconfig: str = "", master: str = "", port: int = 8080, watch: str = "auto", journal: str = "",
          workers: int = 0, standby: bool = False, ha_handover: bool = False, device: DeviceLike = None) -> int:
    """Start the REST server and serve until SIGTERM or SIGINT (see
    :func:`start_server`). ``watch`` selects the snapshot strategy with a
    kubeconfig: ``auto`` (the default) starts the live twin and serves
    from it once synced, from the polling snapshot until then; ``on``
    requires the twin to sync at start; ``off`` polls only. ``journal``
    names the twin's crash-safe journal directory. Shutdown drains the
    admission queue, stops the reflectors and flushes the journal.

    ``workers`` ≥ 2 (or ``OPENSIM_WORKERS_FLEET``) serves through the
    multi-process fleet instead (``server/fleet.py``): a twin-owner process
    publishing its warm base entry over shared memory and N worker
    processes sharing the port via ``SO_REUSEPORT``. ``standby`` runs the
    HA hot standby, which tails the owner's journal and takes over on lease
    expiry (with ``ha_handover``, it asks the owner to hand over once it is
    at parity). A process with ``OPENSIM_FLEET_ATTACH`` set is one of a
    fleet's workers."""
    _check_args(kubeconfig, watch, journal)
    if envknobs.raw("OPENSIM_FLEET_ATTACH"):
        # this process IS a fleet worker (the supervisor set the knob):
        # attach the owner's publication instead of building a twin
        from .fleet import run_worker

        return run_worker(port, device)
    if standby:
        from .fleet import serve_standby

        return serve_standby(kubeconfig, master, port, watch, journal, fleet_workers(workers) or 2,
                             handover=ha_handover, device=device)
    n_fleet = fleet_workers(workers)
    if n_fleet >= 2:
        from .fleet import serve_fleet

        return serve_fleet(kubeconfig, master, port, watch, journal, n_fleet, device=device)
    server, httpd = start_server(kubeconfig=kubeconfig, master=master, port=port, watch=watch, journal=journal,
                                 device=device)
    # the time-series ring, the SLO engine and the memory watermark
    # ticker: long-lived servers only
    server.start_timeseries()
    server.memory.start_ticker()

    # the handler only nudges the serve loop from a helper thread
    # (httpd.shutdown() deadlocks when called from the serving thread)
    def _graceful(signum, frame):
        log.info("received %s; shutting down", signal.Signals(signum).name)
        threading.Thread(target=httpd.shutdown, name="simon-shutdown", daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _graceful)
        except ValueError:
            break  # not the main thread (embedded use): no handlers
    if server.admission is None:
        mode = "single-flight"
    else:
        ctrl = server.admission
        mode = (f"admission queue: bound {ctrl.bound}, window {ctrl.window_s * 1000:g} ms, batches of up to "
                f"{ctrl.max_batch}, pipeline {'on' if ctrl.pipelined else 'off'}, {ctrl._pool.workers} "
                f"{ctrl._pool.mode} workers")
    twin = "" if server.watch is None else " (live twin)"
    twin += "" if server.journal is None else f" [journal {server.journal.path}]"
    print(f"simon server listening on :{port} [{mode}] on {server.device}{twin}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()
        print("simon server: shutdown complete", flush=True)
    return 0
