"""The live twin: watch-driven incremental snapshots — the port of
``opensim_tpu/server/watch.py``.

The reference simulator is informer-driven (a fake clientset and a
SharedInformerFactory reacting to object events); the polling snapshot
re-lists the whole cluster per TTL window and re-prepares it on every
change. This module mirrors the informer architecture over the snapshot's
transport ladder — the ``kubernetes`` client when the package is present,
a stdlib chunked-HTTP ``?watch=1`` consumer otherwise — and keeps a warm
:class:`~..engine.prepcache.PrepareCache` base entry, so a request pays
O(changes since the last event) on the host instead of O(cluster), and its
launch on the card reads the entry the events rewrote.

The robustness core is a supervised state machine::

    syncing ──bootstrap ok──▶ live ◀──reconverged── resyncing
                               │ ▲                      ▲
             stream stale/down │ │ traffic resumes      │ relist+rebase
                               ▼ │                      │ (410 Gone, drift)
                            degraded ───────────────────┘

- **Bootstrap** lists every resource through the snapshot's one list path
  (``snapshot.list_resource``, ``resourceVersion=0``), keeping each list's
  resourceVersion so the watch streams resume from exactly that point.
- **Reflectors** (one thread per watched resource, pods and nodes; the
  rest converges by anti-entropy) consume the event streams and reconnect
  with bounded full-jitter backoff (``resilience/retry.py``).
- **410 Gone**, at connect or mid-stream, triggers a relist and rebase.
- **Staleness deadline**: no event or BOOKMARK within
  ``OPENSIM_WATCH_STALE_S`` degrades the twin; requests served from a
  degraded twin carry ``X-Simon-Snapshot: stale``, like the polling path's
  stale serve.
- **Anti-entropy**: every ``OPENSIM_WATCH_RESYNC_S`` the supervisor
  relists, diffs the result against the twin (rv-aware), counts mismatches
  in ``simon_twin_drift_total`` and rebases on drift — the defense against
  lost events, which no stream error handler can see.
- **Fallback**: until the twin has synced (or while its bootstrap keeps
  failing) ``SimonServer`` serves through the polling snapshot.
- **Journal** (``server/journal.py``): when attached, every accepted event
  and list-shaped rebase is recorded off the dispatch path, and ``start()``
  restores the twin from the newest checkpoint plus the suffix instead of
  a relist.
- **Capacity**: when attached, the capacity observatory is bootstrapped at
  every sync and rebase and fed every accepted event in O(1).

Fault points (``OPENSIM_FAULTS``, ``resilience/faults.py``):
``watch.disconnect``, ``watch.gone``, ``watch.drop_event``,
``watch.reorder``. Telemetry: ``simon_watch_state{state=}`` one-hot,
``simon_watch_events_total{kind=,resource=}``,
``simon_watch_reconnects_total``, ``simon_twin_drift_total{resource=}``,
``simon_twin_generation``; bootstrap, resync and rebase cycles are traced
into the flight recorder (``/api/debug/requests``, ids ``watch-<op>-<n>``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from typing import TYPE_CHECKING, Dict, Iterator, List, Optional, Tuple

if TYPE_CHECKING:
    from ..engine.prepcache import PrepareCache

from ..models.objects import ResourceTypes
from ..obs import trace as tracing
from ..obs.fleetobs import FRESHNESS, new_event_id
from ..obs.metrics import RECORDER, escape_label_value, family_header
from ..obs.recorder import FLIGHT_RECORDER
from ..resilience import faults
from ..resilience.retry import retry_call
from ..utils import envknobs
from ..utils.gcpause import gc_paused
from .snapshot import (
    RESOURCE_BY_FIELD,
    RESOURCES,
    SnapshotFetchError,
    _load_kubeconfig,
    _pod_admissible,
    list_resource,
)

log = logging.getLogger("opensim_tpu_torch.server.watch")

__all__ = [
    "STATES",
    "ClusterTwin",
    "GoneError",
    "KubeWatchSource",
    "RestWatchSource",
    "WatchSupervisor",
    "source_from_kubeconfig",
    "watch_policy",
]

#: the supervisor's states, in the order the one-hot gauge renders them
STATES = ("syncing", "live", "degraded", "resyncing")

#: resources with their own watch stream by default; the rest of the
#: RESOURCES table still enters the twin at bootstrap/anti-entropy time
#: (services/PDBs/etc. change orders of magnitude slower than pods)
DEFAULT_WATCHED = ("pods", "nodes")

_UID = itertools.count(1)


class GoneError(RuntimeError):
    """The watch stream's resourceVersion expired (HTTP 410 / ERROR event
    with code 410): the only recovery is a fresh list and a twin rebase."""


def watch_policy() -> dict:
    """Env-tunable policy knobs, validated like ``snapshot_retry_policy``
    (an unparseable value raises immediately; silently restoring a default
    would mask an operator typo until an incident):

    - ``OPENSIM_WATCH_STALE_S`` (default 30): no event or bookmark for this
      long → the stream is stale and the twin degrades;
    - ``OPENSIM_WATCH_RESYNC_S`` (default 300, 0 disables): anti-entropy
      relist-and-diff interval;
    - ``OPENSIM_WATCH_RECONNECTS`` (default 5): bounded attempts per
      reconnect incident (``retry_call``);
    - ``OPENSIM_WATCH_BACKOFF_S`` (default 0.2): full-jitter backoff base.
    """
    out = {}
    for key, env, default, cast in (
        ("stale_s", "OPENSIM_WATCH_STALE_S", 30.0, float),
        ("resync_s", "OPENSIM_WATCH_RESYNC_S", 300.0, float),
        ("reconnects", "OPENSIM_WATCH_RECONNECTS", 5, int),
        ("backoff_s", "OPENSIM_WATCH_BACKOFF_S", 0.2, float),
    ):
        raw = envknobs.raw(env, str(default))
        try:
            out[key] = cast(raw)
        except ValueError:
            raise ValueError(f"{env} must be {'an integer' if cast is int else 'a number'}") from None
    if out["stale_s"] <= 0:
        raise ValueError("OPENSIM_WATCH_STALE_S must be positive")
    if out["resync_s"] < 0:
        raise ValueError("OPENSIM_WATCH_RESYNC_S must be >= 0 (0 disables)")
    if out["reconnects"] < 1:
        raise ValueError("OPENSIM_WATCH_RECONNECTS must be >= 1")
    if out["backoff_s"] < 0:
        raise ValueError("OPENSIM_WATCH_BACKOFF_S must be >= 0")
    return out


def _obj_key(d: dict) -> Tuple[str, str]:
    meta = d.get("metadata") or {}
    return (str(meta.get("namespace") or ""), str(meta.get("name") or ""))


def _obj_rv(d: dict) -> Optional[int]:
    """Numeric resourceVersion for ordering, None when non-numeric (kube
    documents rvs as opaque; they are numeric in practice, and a
    non-numeric one simply disables the duplicate/reorder guard for that
    object rather than breaking event application)."""
    raw = (d.get("metadata") or {}).get("resourceVersion")
    try:
        return int(raw)
    except (TypeError, ValueError):
        return None


# ---------------------------------------------------------------------------
# the twin: an event-sourced mirror of the cluster object set
# ---------------------------------------------------------------------------


class ClusterTwin:
    """The in-memory mirror the watch streams maintain. Object stores are
    insertion-ordered per resource — the same order an apiserver list +
    appended events produces — so a converged twin materializes a cluster
    whose content fingerprint equals a fresh full relist's.

    Event application is **rv-monotonic**: an event whose object
    resourceVersion is not newer than the stored one (duplicate delivery,
    out-of-order stream) is a no-op, and deletions leave a tombstone rv so
    a reordered stale MODIFIED cannot resurrect a deleted object.
    """

    #: retained deletion markers per resource — enough to absorb any
    #: realistic reorder window while bounding steady-state churn memory
    #: (pods on a busy cluster delete forever; the guard only needs to
    #: outlive in-flight stream reordering, not history)
    TOMBSTONE_CAP = 4096

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._stores: Dict[str, "OrderedDict[Tuple[str, str], object]"] = {  # guarded-by: _lock
            spec.field: OrderedDict() for spec in RESOURCES
        }
        self._rvs: Dict[str, Dict[Tuple[str, str], Optional[int]]] = {  # guarded-by: _lock
            spec.field: {} for spec in RESOURCES
        }
        self._tombstones: Dict[str, "OrderedDict[Tuple[str, str], Optional[int]]"] = {  # guarded-by: _lock
            spec.field: OrderedDict() for spec in RESOURCES
        }
        self.generation = 0
        self.synced_fields: set = set()
        self._mat: Optional[ResourceTypes] = None  # guarded-by: _lock
        self._mat_gen = -1  # guarded-by: _lock

    def _bury(self, field: str, k: Tuple[str, str], rv: Optional[int]) -> None:
        tomb = self._tombstones[field]
        tomb[k] = rv
        tomb.move_to_end(k)
        while len(tomb) > self.TOMBSTONE_CAP:
            tomb.popitem(last=False)

    # -- list-side -----------------------------------------------------------

    def rebase(self, field: str, items: List[dict]) -> int:
        """Replace one resource's store wholesale from a fresh list (the
        bootstrap, a 410 recovery, or an anti-entropy rebase). Returns the
        post-rebase generation, captured under the lock — callers that
        label journal records with it must not re-read ``generation``
        unlocked (a concurrent event apply could bump it first)."""
        spec = RESOURCE_BY_FIELD[field]
        with self._lock:
            store: "OrderedDict[Tuple[str, str], object]" = OrderedDict()
            rvs: Dict[Tuple[str, str], Optional[int]] = {}
            for d in items:
                if field == "pods" and not _pod_admissible(d):
                    continue
                k = _obj_key(d)
                store[k] = spec.wrap(d)
                rvs[k] = _obj_rv(d)
            self._stores[field] = store
            self._rvs[field] = rvs
            self._tombstones[field].clear()
            self.synced_fields.add(field)
            self.generation += 1
            return self.generation

    def rebase_all(self, listing: Dict[str, Tuple[List[dict], str]]) -> None:
        for field, (items, _rv) in listing.items():
            self.rebase(field, items)

    def snapshot_raw(
        self, fields: Optional[List[str]] = None
    ) -> Tuple[Dict[str, List[dict]], int]:
        """Raw-dict view of the stores plus the generation it corresponds
        to, captured atomically — the one extraction path checkpoints,
        rebase records, and recovery all share, so their view of "the
        store as raw dicts" can never diverge. ``fields=None`` returns
        every non-empty store; an explicit list returns exactly those
        stores (empty included: a rebase record for a now-empty resource
        is meaningful history)."""
        with self._lock:
            names = list(self._stores) if fields is None else list(fields)
            stores = {
                f: [getattr(o, "raw", None) or {} for o in self._stores[f].values()]
                for f in names
                if fields is not None or self._stores[f]
            }
            return stores, self.generation

    # -- event-side ----------------------------------------------------------

    def apply_event(self, field: str, ev_type: str, obj: dict) -> Optional[tuple]:
        """Apply one watch event; returns the *prep-cache delta* the change
        implies, or None for a no-op:

        - ``("pod_add", Pod)`` / ``("pod_del", (ns, name))`` — expressible
          as an O(changes) base-entry delta;
        - ``("node_add", Node)`` — expressible via ``extend_with_nodes``;
        - ``("rebuild", why)`` — the store changed in a way only a full
          re-prepare can express (modifications, node removals, workload
          object changes).
        """
        spec = RESOURCE_BY_FIELD[field]
        k = _obj_key(obj)
        rv = _obj_rv(obj)
        with self._lock:
            store = self._stores[field]
            rvs = self._rvs[field]
            tomb = self._tombstones[field]
            if rv is not None:
                dead_rv = tomb.get(k)
                if dead_rv is not None and rv <= dead_rv:
                    return None  # stale event for an already-deleted object
            if ev_type == "DELETED":
                if k not in store:
                    return None
                del store[k]
                rvs.pop(k, None)
                self._bury(field, k, rv)
                self.generation += 1
                if field == "pods":
                    return ("pod_del", k)
                return ("rebuild", f"{field} DELETED")
            if ev_type not in ("ADDED", "MODIFIED"):
                return None
            admissible = field != "pods" or _pod_admissible(obj)
            if not admissible:
                # a pod leaving the admissible set (Succeeded/Failed,
                # deletionTimestamp, DaemonSet adoption) IS a deletion as
                # far as the twin is concerned
                if k not in store:
                    return None
                del store[k]
                rvs.pop(k, None)
                self._bury(field, k, rv)
                self.generation += 1
                return ("pod_del", k)
            prev_rv = rvs.get(k)
            existed = k in store
            if existed and rv is not None and prev_rv is not None and rv <= prev_rv:
                return None  # duplicate or reordered stale delivery
            decoded = spec.wrap(obj)
            store[k] = decoded
            rvs[k] = rv
            tomb.pop(k, None)
            self.generation += 1
            if not existed:
                if field == "pods":
                    return ("pod_add", decoded)
                if field == "nodes":
                    return ("node_add", decoded)
                return ("rebuild", f"{field} ADDED")
            return ("rebuild", f"{field} MODIFIED")

    # -- serving-side --------------------------------------------------------

    def materialize(self) -> ResourceTypes:
        """The twin as a ResourceTypes, rebuilt per generation (lists are
        fresh objects per generation; the model objects are shared with the
        prepared stream, whose bind state is restored after every use)."""
        with self._lock:
            if self._mat is not None and self._mat_gen == self.generation:
                return self._mat
            rt = ResourceTypes()
            for spec in RESOURCES:
                getattr(rt, spec.field).extend(self._stores[spec.field].values())
            self._mat = rt
            self._mat_gen = self.generation
            return rt

    def fingerprint(self) -> str:
        """Content fingerprint of the materialized twin — the convergence
        check the tests and the smoke run compare against a fresh full
        relist. Not on the serving path (that keys on generation)."""
        from ..engine.prepcache import fingerprint_cluster

        return fingerprint_cluster(self.materialize())

    def reconcile(
        self,
        listing: Dict[str, Tuple[List[dict], str]],
        per_resource: Optional[Dict[str, int]] = None,
    ) -> int:
        """Anti-entropy: merge a fresh listing into the twin, returning the
        number of genuinely drifted objects repaired. The merge is
        **rv-aware** because the listing races the event streams — between
        the list fetch and this merge, reflectors may legitimately advance
        the twin past the listing. Twin-ahead is NOT drift and is never
        reverted (the stream would not redeliver what a wholesale rebase
        threw away):

        - fresh object unknown to the twin → drift (lost ADDED), unless a
          tombstone proves the twin deleted it at a newer rv;
        - fresh rv newer than the twin's → drift (lost MODIFIED), replace;
          fresh rv older → twin is ahead, keep ours;
        - twin object absent from the listing → drift (lost DELETED),
          remove — unless its rv is newer than the *list-level* rv, which
          means it was created after the list was taken.
        """
        drift = 0
        with self._lock:
            for field, (items, list_rv) in listing.items():
                field_drift0 = drift
                spec = RESOURCE_BY_FIELD[field]
                store = self._stores[field]
                rvs = self._rvs[field]
                tomb = self._tombstones[field]
                try:
                    list_rv_n: Optional[int] = int(list_rv)
                except (TypeError, ValueError):
                    list_rv_n = None
                fresh: Dict[Tuple[str, str], dict] = {}
                for d in items:
                    if field == "pods" and not _pod_admissible(d):
                        continue
                    fresh[_obj_key(d)] = d
                for k, d in fresh.items():
                    rv = _obj_rv(d)
                    if k not in store:
                        dead_rv = tomb.get(k)
                        if dead_rv is not None and rv is not None and rv <= dead_rv:
                            continue  # we deleted it after the list was taken
                        store[k] = spec.wrap(d)
                        rvs[k] = rv
                        tomb.pop(k, None)
                        drift += 1
                    else:
                        mine = rvs.get(k)
                        if rv is not None and (mine is None or rv > mine):
                            store[k] = spec.wrap(d)
                            rvs[k] = rv
                            drift += 1
                for k in [k for k in store if k not in fresh]:
                    mine = rvs.get(k)
                    if mine is not None and list_rv_n is not None and mine > list_rv_n:
                        continue  # created after the list snapshot: twin is ahead
                    del store[k]
                    self._bury(field, k, rvs.pop(k, None))
                    drift += 1
                if per_resource is not None and drift > field_drift0:
                    per_resource[field] = (
                        per_resource.get(field, 0) + drift - field_drift0
                    )
            if drift:
                self.generation += 1
        return drift


# ---------------------------------------------------------------------------
# event sources: real client / stdlib REST / (tests: any object with the
# same three methods)
# ---------------------------------------------------------------------------


class RestWatchSource:
    """Stdlib chunked-HTTP watch consumer — mirrors the snapshot's REST
    fallback: ``GET <path>?watch=1&allowWatchBookmarks=true&resourceVersion=<rv>``
    and one JSON watch event per line. The read timeout doubles as the
    transport half of the staleness deadline: a silent peer (no events, no
    bookmarks) surfaces as a TimeoutError → reconnect."""

    def __init__(
        self,
        kubeconfig: str,
        master: Optional[str] = None,
        read_timeout_s: float = 60.0,
    ) -> None:
        self._server, self._headers, self._ssl = _load_kubeconfig(kubeconfig, master)
        self.read_timeout_s = read_timeout_s

    def list(self, field: str) -> Tuple[List[dict], str]:
        got = list_resource(self._server, self._headers, self._ssl, RESOURCE_BY_FIELD[field])
        return got if got is not None else ([], "")

    def list_all(self) -> Dict[str, Tuple[List[dict], str]]:
        return {spec.field: self.list(spec.field) for spec in RESOURCES}

    def watch(self, field: str, rv: str) -> Iterator[Tuple[str, dict]]:
        spec = RESOURCE_BY_FIELD[field]
        sep = "&" if "?" in spec.path else "?"
        url = f"{self._server}{spec.path}{sep}watch=1&allowWatchBookmarks=true"
        if rv:
            url += f"&resourceVersion={rv}"
        req = urllib.request.Request(url, headers=self._headers)
        try:
            resp = urllib.request.urlopen(req, timeout=self.read_timeout_s, context=self._ssl)
        except urllib.error.HTTPError as e:
            if e.code == 410:
                raise GoneError(f"watch {spec.path} from rv {rv}: HTTP 410 Gone") from e
            if e.code >= 500:
                raise SnapshotFetchError(f"watch {spec.path} failed: HTTP {e.code}") from e
            raise RuntimeError(f"watch {spec.path} failed: HTTP {e.code}") from e
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise SnapshotFetchError(f"watch {spec.path} connect failed: {e}") from e
        return self._events(resp, spec.path)

    def _events(self, resp, path: str) -> Iterator[Tuple[str, dict]]:
        with resp:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError as e:
                    raise SnapshotFetchError(f"watch {path}: truncated frame") from e
                ev_type = str(ev.get("type") or "")
                obj = ev.get("object") or {}
                if ev_type == "ERROR":
                    code = obj.get("code")
                    if code == 410:
                        raise GoneError(f"watch {path}: resourceVersion expired (410)")
                    raise SnapshotFetchError(f"watch {path}: ERROR event {obj!r}")
                yield ev_type, obj
        # server closed the stream (apiservers time watches out routinely):
        # the reflector resumes from the last seen rv


class KubeWatchSource:
    """``kubernetes``-client-backed source, used when the package is
    importable (parity with ``cluster_from_kubeconfig``'s client branch).
    Decodes to the same raw-dict wire form the REST source yields."""

    def __init__(self, kubeconfig: str, master: Optional[str] = None) -> None:
        from kubernetes import client, config  # type: ignore

        config.load_kube_config(config_file=kubeconfig)
        core = client.CoreV1Api()
        apps = client.AppsV1Api()
        policy = client.PolicyV1Api() if hasattr(client, "PolicyV1Api") else client.PolicyV1beta1Api()
        storage = client.StorageV1Api()
        self._api = client.ApiClient()
        self._calls = {
            "nodes": core.list_node,
            "pods": core.list_pod_for_all_namespaces,
            "daemon_sets": apps.list_daemon_set_for_all_namespaces,
            "pdbs": policy.list_pod_disruption_budget_for_all_namespaces,
            "services": core.list_service_for_all_namespaces,
            "storage_classes": storage.list_storage_class,
            "pvcs": core.list_persistent_volume_claim_for_all_namespaces,
            "config_maps": core.list_config_map_for_all_namespaces,
        }

    def list(self, field: str) -> Tuple[List[dict], str]:
        resp = self._calls[field](resource_version="0")
        items = [self._api.sanitize_for_serialization(o) for o in resp.items]
        meta = getattr(resp, "metadata", None)
        rv = str(getattr(meta, "resource_version", "") or "")
        return items, rv

    def list_all(self) -> Dict[str, Tuple[List[dict], str]]:
        return {spec.field: self.list(spec.field) for spec in RESOURCES}

    def watch(self, field: str, rv: str) -> Iterator[Tuple[str, dict]]:
        from kubernetes import watch as kwatch  # type: ignore

        stream = kwatch.Watch().stream(
            self._calls[field],
            resource_version=rv or None,
            allow_watch_bookmarks=True,
        )
        try:
            for ev in stream:
                yield str(ev.get("type") or ""), dict(ev.get("raw_object") or {})
        except Exception as e:
            if getattr(e, "status", None) == 410:
                raise GoneError(f"watch {field}: resourceVersion expired (410)") from e
            raise


def source_from_kubeconfig(kubeconfig: str, master: Optional[str] = None, read_timeout_s: float = 60.0):
    """The same client-or-stdlib ladder ``cluster_from_kubeconfig`` walks."""
    try:
        import kubernetes  # type: ignore # noqa: F401
    except ImportError:
        return RestWatchSource(kubeconfig, master, read_timeout_s=read_timeout_s)
    return KubeWatchSource(kubeconfig, master)


# ---------------------------------------------------------------------------
# reflectors: one supervised list+watch lifecycle per watched resource
# ---------------------------------------------------------------------------


class _Reflector(threading.Thread):
    """client-go-reflector analogue: resume the watch from the last seen
    resourceVersion across reconnects; only a 410 (or a first start) pays a
    relist. Every (re)connect goes through ``retry_call`` — bounded
    attempts, full-jitter backoff — and an exhausted budget degrades the
    twin instead of crash-looping (the supervisor keeps a slow heartbeat
    that re-enters the cycle, and anti-entropy still converges the data)."""

    def __init__(self, sup: "WatchSupervisor", field: str) -> None:
        super().__init__(name=f"simon-watch-{field}", daemon=True)
        self.sup = sup
        self.field = field
        self.rv: str = ""  # "" → next cycle lists first
        self._delivered = 0  # items the current stream cycle yielded

    def run(self) -> None:
        connected_once = False
        last_cycle_delivered = True
        while not self.sup._stop.is_set():
            try:
                if not self.rv:
                    items, rv = retry_call(
                        lambda: self.sup.source.list(self.field),
                        attempts=self.sup.policy["reconnects"],
                        base_delay=self.sup.policy["backoff_s"],
                        retry_on=(SnapshotFetchError, TimeoutError),
                        trace_name="watch.relist.retry",
                    )
                    self.rv = rv
                    self.sup.on_relist(self.field, items, rv=rv)
                    last_cycle_delivered = True  # a relist IS fresh data
                stream = retry_call(
                    lambda: self.sup.source.watch(self.field, self.rv),
                    attempts=self.sup.policy["reconnects"],
                    base_delay=self.sup.policy["backoff_s"],
                    retry_on=(SnapshotFetchError, TimeoutError),
                    trace_name="watch.reconnect.retry",
                )
                if connected_once:
                    self.sup.note_reconnect(self.field)
                connected_once = True
                # a successful connect only resets the staleness deadline
                # when the PREVIOUS cycle actually delivered something: a
                # connectable-but-silent endpoint (half-dead LB that 200s
                # the watch and then sends nothing) must not stay "live"
                # by reconnecting once per read timeout
                if last_cycle_delivered:
                    self.sup.note_traffic(self.field)
                self._delivered = 0
                try:
                    self._consume(stream)
                    # clean EOF: apiservers time watches out routinely —
                    # resume immediately from the last seen rv
                except GoneError:
                    raise
                except Exception as e:
                    # mid-stream drop: resume from the last rv; the very
                    # next connect above is itself bounded via retry_call
                    log.info(
                        "watch[%s]: stream dropped (%s: %s); reconnecting",
                        self.field, type(e).__name__, e,
                    )
                last_cycle_delivered = self._delivered > 0
            except GoneError as e:
                log.warning("watch[%s]: %s; relisting and rebasing", self.field, e)
                self.sup.note_gone(self.field)
                self.rv = ""  # forces the relist+rebase on the next cycle
            except Exception as e:
                log.warning(
                    "watch[%s]: stream down after %d bounded attempt(s) (%s: %s)",
                    self.field, self.sup.policy["reconnects"], type(e).__name__, e,
                )
                self.sup.note_stream_down(self.field, e)
                # slow heartbeat before re-entering the bounded cycle: the
                # twin is already degraded; pace recovery at the staleness
                # deadline rather than hammering a down apiserver
                self.sup._stop.wait(self.sup.policy["stale_s"])

    def _consume(self, stream: Iterator[Tuple[str, dict]]) -> None:
        for ev_type, obj in stream:
            if self.sup._stop.is_set():
                return
            # chaos: a dropped connection mid-stream (exception ⇒ the
            # reconnect path), or an injected 410 (⇒ relist-and-rebase)
            faults.fault_point("watch.disconnect")
            try:
                faults.fault_point("watch.gone")
            except Exception as e:
                raise GoneError("injected resourceVersion expiry") from e
            self._delivered += 1
            self.sup.note_traffic(self.field)
            rv = _obj_rv(obj)
            if rv is not None:
                self.rv = str(rv)
            if ev_type == "BOOKMARK":
                # progress marker only: advances rv, feeds the staleness
                # deadline, carries no object payload
                self.sup.count_event("BOOKMARK", self.field)
                continue
            self.sup.dispatch(self.field, ev_type, obj)


# ---------------------------------------------------------------------------
# supervisor: state machine + prep maintenance + anti-entropy
# ---------------------------------------------------------------------------


class WatchSupervisor:
    """Owns the twin, the reflector threads, the state machine, and the
    always-warm prep-cache base entry. The REST server asks one question —
    :meth:`serving_snapshot` — and gets either the twin (with its staleness
    verdict) or None (not synced → caller falls back to polling)."""

    def __init__(
        self,
        source,
        prep_cache: Optional["PrepareCache"] = None,
        watched: Tuple[str, ...] = DEFAULT_WATCHED,
        policy: Optional[dict] = None,
        journal=None,
    ) -> None:
        unknown = [f for f in watched if f not in RESOURCE_BY_FIELD]
        if unknown:
            raise ValueError(f"unknown watch resource(s) {unknown}; known: {sorted(RESOURCE_BY_FIELD)}")
        self.source = source
        self.prep_cache = prep_cache
        # watch-event journal (server/journal.py): when attached,
        # every ACCEPTED event / list-shaped rebase is recorded off the
        # dispatch path, and start() restores the twin from the newest
        # checkpoint + suffix replay instead of a cold relist
        self.journal = None
        # capacity observatory (obs/capacity.py): when attached,
        # the supervisor bootstraps it at sync/rebase and feeds it every
        # ACCEPTED event — the O(1) aggregate update rides the same
        # dispatch the prep delta does
        self.capacity = None
        self.watched = tuple(watched)
        self.policy = policy or watch_policy()
        self.twin = ClusterTwin()
        self.key_prefix = f"twin|{next(_UID)}|"
        self._stop = threading.Event()
        self._synced = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._reflectors: List[_Reflector] = []
        self._state_lock = threading.Lock()
        self._state = "syncing"  # guarded-by: _state_lock
        # _down/_traffic are deliberately unguarded: set.add/discard and
        # per-key dict stores are atomic under the GIL, the readers
        # (_recompute_state, staleness checks) tolerate a stale view for
        # one tick, and taking a lock on every received event would put a
        # hot-path wait in front of twin application for a telemetry hint
        self._down: set = set()
        self._traffic: Dict[str, float] = {}
        self._maint_lock = threading.Lock()
        self._pending: List[tuple] = []  # guarded-by: _maint_lock
        self._prep_gen = -1  # guarded-by: _maint_lock
        # serializes flushers only (supervisor loop vs request threads) and
        # is held across the delta re-encode — waiting here IS the warm-path
        # contract (the request wants the folded base); _maint_lock is never
        # held that long, so reflector dispatch keeps flowing
        self._flush_lock = threading.Lock()
        self._boot_rvs: Dict[str, str] = {}
        #: in-memory state to adopt at start() instead of journal recovery
        #: (the HA standby's pre-warmed twin; see preload_state)
        self._preloaded = None
        # serializes event application against the anti-entropy merge (the
        # reflector threads vs the supervisor thread) and guards the
        # per-field reorder-fault holding slots
        self._dispatch_lock = threading.Lock()
        self._held: Dict[str, Tuple[str, dict]] = {}  # guarded-by: _dispatch_lock
        self._trace_seq = itertools.count(1)
        # counters (rendered under the one metrics lock, RECORDER.lock).
        # events and drift carry a {resource=} label so drift is
        # attributable — pods churn and nodes churn are different
        # operational stories; the unlabeled totals stay as attributes for
        # programmatic callers
        # (kind, resource)
        self.events_total: Dict[Tuple[str, str], int] = {}  # guarded-by: RECORDER.lock
        self.reconnects_total = 0  # guarded-by: RECORDER.lock
        self.relists_total = 0  # guarded-by: RECORDER.lock
        self.gone_total = 0  # guarded-by: RECORDER.lock
        self.drift_total = 0  # guarded-by: RECORDER.lock
        self.drift_by_resource: Dict[str, int] = {}  # guarded-by: RECORDER.lock
        self.resyncs_total = 0  # guarded-by: RECORDER.lock
        if journal is not None:
            self.attach_journal(journal)

    # -- journal (server/journal.py) ------------------------------------------

    def attach_journal(self, journal) -> None:
        """Wire a :class:`~.journal.Journal`: the supervisor records every
        accepted event/rebase into it and hands it the checkpoint source
        (twin object references captured under the twin lock; the journal's
        writer thread serializes them outside it)."""
        self.journal = journal
        journal.checkpoint_source = self._journal_snapshot

    def _journal_snapshot(self) -> Optional[tuple]:
        """(stores objrefs, generation, timeline dicts) for a cadence
        checkpoint — called from the journal writer thread only."""
        if not self._synced.is_set():
            return None
        with self.twin._lock:
            stores = {
                field: list(store.values())
                for field, store in self.twin._stores.items()
                if store
            }
            gen = self.twin.generation
        timeline = []
        if self.capacity is not None:
            timeline = [s.to_dict() for s in self.capacity.timeline.snapshot()]
        return stores, gen, timeline

    def _checkpoint_now(self, why: str) -> None:
        """Journal an explicit full-snapshot checkpoint of the twin — the
        bootstrap anchor and the post-recovery re-anchor. Raw dict
        references are captured under the twin lock; the journal's writer
        thread serializes them off this path."""
        if self.journal is None:
            return
        stores, gen = self.twin.snapshot_raw()
        timeline = []
        if self.capacity is not None:
            timeline = [s.to_dict() for s in self.capacity.timeline.snapshot()]
        self.journal.record_checkpoint(
            stores, gen, resume_rvs=self._boot_rvs, timeline=timeline, why=why
        )

    def preload_state(self, state) -> None:
        """Hand the supervisor an in-memory :class:`~.journal.RecoveredState`
        to adopt INSTEAD of recovering from its journal at start() — the HA
        standby's takeover path (server/fleet.py): the standby tailed the
        old owner's journal onto its own twin, and the new supervisor starts
        from that state (zero relists, reflectors resuming at the recorded
        rvs), not from a disk replay of history it already holds."""
        self._preloaded = state

    def _restore_from_journal(self) -> bool:
        """Rebuild the twin from the journal's newest checkpoint + suffix
        replay, then resume serving WITHOUT a relist: the reflectors pick
        up from the restored per-resource rvs (a too-old rv heals through
        the normal 410 relist-and-rebase path), and anti-entropy repairs —
        journaled as rebase records — cover whatever the crash lost."""
        state = self.journal.recover()
        if state is None:
            return False
        return self._adopt_state(state, "journal-restore", "recovered")

    def _adopt_state(self, state, span: str, why: str) -> bool:
        """Seed the twin, the capacity view and the resume rvs from a
        recovered (or standby-tailed) state and go live — shared by journal
        recovery and the HA takeover."""
        with self._traced(span):
            with self._maint_lock:
                for field, items in state.stores.items():
                    if field in RESOURCE_BY_FIELD:
                        self.twin.rebase(field, items)
                with self.twin._lock:
                    self.twin.generation = max(self.twin.generation, state.generation)
                self._pending.clear()
                self._prep_gen = self.twin.generation
            if self.capacity is not None and state.timeline:
                try:
                    from ..obs.timeline import Sample

                    self.capacity.timeline.restore(
                        [Sample.from_dict(d) for d in state.timeline]
                    )
                except Exception as e:
                    log.warning(
                        "capacity timeline restore failed: %s: %s",
                        type(e).__name__, e,
                    )
            self._capacity_rebase()
            self._boot_rvs = {
                f: rv for f, rv in state.resume_rvs.items() if f in RESOURCE_BY_FIELD
            }
            for field in self.watched:
                self.note_traffic(field)
            self._set_state("live")
            self._synced.set()
            # re-anchor: the next crash must not have to replay this
            # suffix again (and a restore-time drift repair now has a
            # checkpoint to be a suffix OF)
            self._checkpoint_now(why)
            log.info(
                "live twin %s: generation %d "
                "(checkpoint %d + %d replayed record(s))",
                why, state.generation, state.checkpoint_generation,
                state.records_replayed,
            )
            return True

    # -- lifecycle -----------------------------------------------------------

    def start(self, wait_s: Optional[float] = None) -> bool:
        """Spawn the supervisor thread. With ``wait_s``, block up to that
        long for the first sync and return whether it completed (the CLI's
        ``--watch on`` uses this to fail loudly)."""
        self._thread = threading.Thread(target=self._run, name="simon-watch-supervisor", daemon=True)
        self._thread.start()
        if wait_s is not None:
            return self._synced.wait(wait_s)
        return True

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self.journal is not None:
            # clean stop: the accepted-event history on disk is complete up
            # to the last dispatched event (graceful shutdown's fsync
            # barrier; the journal object itself is closed by its owner)
            self.journal.flush(timeout=10.0)

    def _run(self) -> None:
        if self._preloaded is not None and not self._synced.is_set():
            state, self._preloaded = self._preloaded, None
            try:
                self._adopt_state(state, "takeover-adopt", "takeover")
            except Exception as e:
                # a failed adopt degrades to the journal/bootstrap ladder
                # below — the takeover gets slower, never stuck
                log.warning("takeover state adopt failed (%s: %s); falling back to journal recovery / relist",
                            type(e).__name__, e)
        if self.journal is not None and not self._synced.is_set():
            try:
                self._restore_from_journal()  # sets _synced on success
            except Exception as e:
                # recovery is best-effort by contract: ANY failure here
                # degrades to the cold bootstrap below, never a crash loop
                log.warning(
                    "journal restore failed (%s: %s); falling back to a "
                    "full relist", type(e).__name__, e,
                )
        while not self._stop.is_set() and not self._synced.is_set():
            if self._bootstrap():
                break
            # bootstrap keeps failing: the server is already serving via
            # the polling fallback; re-attempt at the resync cadence
            self._stop.wait(self.policy["resync_s"] or self.policy["stale_s"])
        if self._stop.is_set():
            return
        for field in self.watched:
            r = _Reflector(self, field)
            # resume each stream from the bootstrap list's resourceVersion:
            # the whole point of capturing it is that the first watch cycle
            # needs no second relist
            r.rv = self._boot_rvs.get(field, "")
            self._reflectors.append(r)
            r.start()
        tick = min(0.5, self.policy["stale_s"] / 4.0)
        next_resync = time.monotonic() + (self.policy["resync_s"] or float("inf"))
        while not self._stop.is_set():
            self._stop.wait(tick)
            if self._stop.is_set():
                return
            self._recompute_state()
            try:
                self.flush_pending()
            except Exception as e:
                # maintenance must never kill the supervisor; the request
                # path rebuilds from scratch when the warm entry is missing
                log.warning("twin prep maintenance failed: %s: %s", type(e).__name__, e)
            if self.capacity is not None:
                try:
                    # generation-keyed and memoized: an idle tick is a dict
                    # lookup, a busy one is one O(nodes) fold feeding the
                    # capacity timeline (obs/timeline.py)
                    self.capacity.sample()
                except Exception as e:
                    log.warning("capacity sampling failed: %s: %s", type(e).__name__, e)
            if time.monotonic() >= next_resync:
                next_resync = time.monotonic() + self.policy["resync_s"]
                try:
                    self.anti_entropy()
                except Exception as e:
                    log.warning("anti-entropy pass failed: %s: %s", type(e).__name__, e)

    def _bootstrap(self) -> bool:
        with self._traced("bootstrap"):
            try:
                listing = retry_call(
                    self.source.list_all,
                    attempts=self.policy["reconnects"],
                    base_delay=self.policy["backoff_s"],
                    retry_on=(SnapshotFetchError, TimeoutError),
                    trace_name="watch.bootstrap.retry",
                )
            except Exception as e:
                log.warning(
                    "watch bootstrap failed (%s: %s); serving stays on the "
                    "polling snapshot path until the twin syncs",
                    type(e).__name__, e,
                )
                return False
            with self._maint_lock:
                self.twin.rebase_all(listing)
                self._pending.clear()
                self._prep_gen = self.twin.generation
            self._capacity_rebase()
            self._boot_rvs = {f: rv for f, (_items, rv) in listing.items()}
            for field in self.watched:
                self.note_traffic(field)
            self._set_state("live")
            self._synced.set()
            # the journal's first record is a complete history prefix: a
            # crash at ANY later point recovers from this checkpoint plus
            # the accepted-event suffix
            self._checkpoint_now("bootstrap")
            log.info(
                "live twin synced: %s",
                ", ".join(f"{len(items)} {f}" for f, (items, _rv) in listing.items() if items),
            )
            return True

    # -- event path (reflector threads) --------------------------------------

    def count_event(self, kind: str, resource: str = "") -> None:
        with RECORDER.lock:
            key = (kind, resource)
            self.events_total[key] = self.events_total.get(key, 0) + 1

    def dispatch(self, field: str, ev_type: str, obj: dict) -> None:
        t0 = time.monotonic()  # event receipt: the watch-apply clock starts
        self.count_event(
            ev_type if ev_type in ("ADDED", "MODIFIED", "DELETED") else "OTHER", field
        )
        try:
            faults.fault_point("watch.drop_event")
        except Exception as e:
            # the event is LOST — precisely the failure only the
            # anti-entropy pass can repair (the twin drifts silently)
            log.debug("watch[%s]: injected event loss (%s): %s dropped", field, e, ev_type)
            return
        with self._dispatch_lock:
            try:
                faults.fault_point("watch.reorder")
            except Exception as e:
                # hold this event back; it is delivered AFTER the stream's
                # next event (per-field slot: streams must not cross)
                log.debug("watch[%s]: injected reorder (%s): %s held back", field, e, ev_type)
                self._held[field] = (ev_type, obj)
                return
            held = self._held.pop(field, None)
            self._apply(field, ev_type, obj)
            if held is not None:
                self._apply(field, *held)
        # watch-pipeline latency: receipt → twin
        # applied, for every event that reached application (dropped/held
        # events never complete the pipeline on this call)
        RECORDER.observe_watch_apply(time.monotonic() - t0)

    def _apply(self, field: str, ev_type: str, obj: dict) -> None:
        # generation is captured atomically with the apply (the twin lock
        # is reentrant): a rebase racing in from another reflector's 410
        # recovery must not mislabel this event's journal record — replay's
        # --at-generation cut points depend on the label being the
        # generation the event actually produced
        with self.twin._lock:
            change = self.twin.apply_event(field, ev_type, obj)
            gen = self.twin.generation
        if change is None:
            return
        # acceptance stamp: the event id rides the journal record, and the
        # acceptance time is the t=0 of simon_fleet_freshness_seconds
        eid, ts = new_event_id(), time.time()
        FRESHNESS.event_accepted(eid, gen, ts)
        if self.journal is not None:
            # ACCEPTED events only (rv-monotonic no-ops never reach here):
            # an O(1) bounded-queue enqueue, never I/O — the journal's
            # writer thread drains it off this path, so dispatch never
            # waits on the disk
            self.journal.record_event(field, ev_type, obj, gen, eid=eid, ts=ts)
        if self.capacity is not None:
            try:
                self.capacity.on_twin_change(field, ev_type, obj, change, gen)
            except Exception as e:
                # observability must never break event application; the
                # next bootstrap (rebase/anti-entropy) self-heals the view
                log.warning(
                    "capacity accounting failed (%s: %s); view may lag until "
                    "the next rebase", type(e).__name__, e,
                )
        with self._maint_lock:
            self._pending.append(change)

    # -- freshness / state ---------------------------------------------------

    def note_traffic(self, field: str) -> None:
        self._traffic[field] = time.monotonic()

    def note_reconnect(self, field: str) -> None:
        with RECORDER.lock:
            self.reconnects_total += 1
        self._down.discard(field)
        self._recompute_state()

    def note_stream_down(self, field: str, exc: BaseException) -> None:
        self._down.add(field)
        self._recompute_state()

    def note_gone(self, field: str) -> None:
        with RECORDER.lock:
            self.gone_total += 1

    def on_relist(self, field: str, items: List[dict], rv: str = "") -> None:
        """A reflector relisted (first start or 410 recovery): rebase that
        resource and drop the warm prep lineage — the jump is unbounded."""
        with RECORDER.lock:
            self.relists_total += 1
        with self._traced("rebase"):
            with self._maint_lock:
                gen = self.twin.rebase(field, items)
                self._pending.clear()
                self._invalidate_prep()
                self._prep_gen = gen
            if self.journal is not None:
                # the list-shaped jump is part of the history: replay
                # applies it as the same wholesale store replacement. The
                # rebase's own generation labels the record — re-reading
                # ``twin.generation`` here would race concurrent event
                # applies on other reflector threads
                self.journal.record_rebase(field, items, gen, rv=rv, why="relist")
            self._capacity_rebase()
        self.note_traffic(field)  # a fresh list is proof of liveness
        self._down.discard(field)
        self._recompute_state()

    def _recompute_state(self) -> None:
        if not self._synced.is_set():
            self._set_state("syncing")
            return
        now = time.monotonic()
        stale = [
            f
            for f in self.watched
            if now - self._traffic.get(f, 0.0) > self.policy["stale_s"]
        ]
        if self._down or stale:
            self._set_state("degraded")
        elif self.state() != "resyncing":
            self._set_state("live")

    def _set_state(self, new: str) -> None:
        assert new in STATES, new
        with self._state_lock:
            old, self._state = self._state, new
        if old != new:
            log.info("live twin: %s -> %s", old, new)
            tracing.event("watch.state", frm=old, to=new)

    def state(self) -> str:
        with self._state_lock:
            return self._state

    def has_synced(self) -> bool:
        return self._synced.is_set()

    def is_stale(self) -> bool:
        """Should a request served from the twin be tagged stale? True in
        every state but ``live`` — degraded (streams down/silent) and
        resyncing (mid-rebase) both mean 'possibly behind the cluster'."""
        return self.state() != "live"

    # -- serving interface (request threads) ---------------------------------

    def serving_snapshot(self) -> Optional[Tuple[ResourceTypes, str, bool]]:
        """(cluster, cache key, stale?) from the twin, or None before the
        first sync (caller falls back to the polling snapshot path)."""
        if not self._synced.is_set():
            return None
        self.flush_pending()
        with self.twin._lock:
            # cluster and key must be read atomically: a concurrent event
            # bumping the generation between the two reads would cache this
            # cluster's prepare under the NEXT generation's key
            cluster = self.twin.materialize()
            key = f"{self.key_prefix}{self.twin.generation}"
        return cluster, key, self.is_stale()

    # -- prep-cache maintenance ---------------------------------------------

    def _invalidate_prep(self) -> None:
        if self.prep_cache is not None:
            self.prep_cache.invalidate(self.key_prefix)

    def _capacity_rebase(self) -> None:
        """Rebuild the capacity view from the twin after a list-shaped jump
        (bootstrap, 410 rebase, anti-entropy repair) — the same moments the
        prep lineage is dropped, and already O(cluster) paths."""
        if self.capacity is None:
            return
        try:
            with self.twin._lock:
                cluster = self.twin.materialize()
                gen = self.twin.generation
            self.capacity.claim_event_fed()  # the supervisor owns the view now
            self.capacity.bootstrap(cluster, gen)
        except Exception as e:
            log.warning("capacity rebase failed: %s: %s", type(e).__name__, e)

    def flush_pending(self) -> None:
        """Fold buffered twin changes into the warm prep-cache base entry —
        the O(changes) hand-off that makes the next request skip the
        O(cluster) prepare. Pod ADDED → arena-fork insert at the bare-region
        end; pod DELETED → valid-mask flip; node ADDED → node-arena extend
        with DaemonSet splice; anything else → drop the lineage (next
        request re-prepares once)."""
        if self.prep_cache is None:
            with self._maint_lock:
                self._pending.clear()
                self._prep_gen = self.twin.generation
            return

        # the re-encode must NOT run under _maint_lock: reflector dispatch
        # appends under it (while holding the dispatch lock), so holding it
        # across a re-encode stalls the whole event pipeline. Flushers
        # serialize on _flush_lock; the pending swap and the
        # publish are each a short _maint_lock critical section, and the
        # publish re-checks the lineage generation so a concurrent
        # relist/drift/bootstrap reset wins over a stale delta.
        with self._flush_lock:
            with self._maint_lock:
                gen_now = self.twin.generation
                old_gen = self._prep_gen
                if gen_now == old_gen and not self._pending:
                    return
                changes, self._pending = self._pending, []
            added: List[object] = []
            removed: set = set()
            nodes_added: List[object] = []
            rebuild: Optional[str] = None
            for change in changes:
                kind = change[0]
                if kind == "pod_add":
                    added.append(change[1])
                elif kind == "pod_del":
                    k = change[1]
                    before = len(added)
                    added = [
                        p
                        for p in added
                        if (p.metadata.namespace, p.metadata.name) != k
                    ]
                    if len(added) == before:
                        removed.add(k)
                elif kind == "node_add":
                    nodes_added.append(change[1])
                else:
                    rebuild = change[1]
            old_key = f"{self.key_prefix}{old_gen}|base"
            new_key = f"{self.key_prefix}{gen_now}|base"
            base = self.prep_cache.get(old_key)
            entry = None
            if rebuild is None and base is not None and base.prep is not None:
                entry = self._fold(base, new_key, added, removed, nodes_added)
            with self._maint_lock:
                if self._prep_gen != old_gen:
                    # a relist/drift repair/bootstrap reset the lineage
                    # while the delta was encoding; its verdict supersedes
                    # ours — the swapped changes belong to the dead lineage
                    return
                if entry is not None:
                    self.prep_cache.put(new_key, entry)
                    # trailing "|" so gen 5 cannot prefix-match gen 50's keys
                    self.prep_cache.invalidate(f"{self.key_prefix}{old_gen}|")
                    tracing.event(
                        "twin.delta",
                        added=len(added), removed=len(removed), nodes=len(nodes_added),
                    )
                else:
                    self._invalidate_prep()
                    if rebuild is not None:
                        log.debug("twin prep lineage dropped: %s", rebuild)
                self._prep_gen = gen_now

    def _fold(self, base, new_key: str, added: list, removed: set, nodes_added: list):
        """The pending changes folded into a new base entry, or None when
        they cannot be (the caller drops the lineage). With the cyclic
        collector paused: the twin holds the raw dicts besides the objects,
        and a full collection there costs seconds."""
        from ..engine import prepcache

        entry = None
        with gc_paused():
            cluster = self.twin.materialize()
            watch = prepcache.watch_snapshot(cluster, [])
            with base.lock:
                base.restore()
                # a mixed pod+node batch decomposes: the node wave first
                # (arena extend + DaemonSet splice), then the pod wave on
                # top (bare-region insert + mask flips) — the stream a
                # fresh prepare of the post-batch twin produces (new bare
                # pods at the bare-region end, new nodes' DaemonSet pods
                # appended per group), held equal in
                # tests/test_torch_watch.py
                mid = base
                if nodes_added:
                    new_prep = prepcache.extend_with_nodes(
                        base.prep, nodes_added, cluster, [], base_entry=base
                    )
                    mid = None
                    if new_prep is not None:
                        mid = prepcache.CacheEntry(new_key, new_prep, base=base, watch=watch)
                        mid.base_drop = prepcache.pad_drop_mask(
                            base.base_drop, len(new_prep.ordered)
                        )
                if mid is base:
                    entry = prepcache.twin_pod_delta(
                        base, new_key, added, removed, watch=watch
                    )
                elif mid is not None:
                    if added or removed:
                        # mid was created above and is not yet published:
                        # its lock is uncontended, held only for the
                        # twin_pod_delta caller contract
                        with mid.lock:
                            entry = prepcache.twin_pod_delta(
                                mid, new_key, added, removed, watch=watch
                            )
                    else:
                        entry = mid
        return entry

    # -- anti-entropy --------------------------------------------------------

    def anti_entropy(self) -> int:
        """Relist, then rv-aware-merge the listing into the twin
        (``ClusterTwin.reconcile``), counting and repairing genuinely
        drifted objects. Returns the drift count (0 = converged, -1 = the
        relist itself failed). The merge runs under the dispatch lock so it
        cannot interleave with reflector event application, and twin-ahead
        objects (events applied after the list was taken) are never
        reverted. Public: tests and the smoke run call it synchronously
        instead of waiting out ``OPENSIM_WATCH_RESYNC_S``."""
        with self._traced("anti-entropy") as tr:
            try:
                # fetched OUTSIDE the dispatch lock: a slow apiserver must
                # not stall event application for the whole list round-trip
                listing = retry_call(
                    self.source.list_all,
                    attempts=self.policy["reconnects"],
                    base_delay=self.policy["backoff_s"],
                    retry_on=(SnapshotFetchError, TimeoutError),
                    trace_name="watch.antientropy.retry",
                )
            except Exception as e:
                log.warning("anti-entropy relist failed: %s: %s", type(e).__name__, e)
                tracing.event("twin.antientropy", status="error", error=str(e))
                return -1
            with self._dispatch_lock:
                per: Dict[str, int] = {}
                drift = self.twin.reconcile(listing, per_resource=per)
                if drift:
                    with RECORDER.lock:
                        self.drift_total += drift
                        for res, n in per.items():
                            self.drift_by_resource[res] = (
                                self.drift_by_resource.get(res, 0) + n
                            )
                        self.resyncs_total += 1
                    self._set_state("resyncing")
                    log.warning(
                        "anti-entropy: repaired %d drifted object(s)", drift
                    )
                    tracing.event("twin.drift", status="error", drift=drift)
                    if self.journal is not None:
                        # drift repair against a journal-restored (or live)
                        # twin is journaled as a rebase record: without it a
                        # replay would faithfully re-create the drift the
                        # pass just fixed. The POST-reconcile store is the
                        # truth (the merge is rv-aware; the raw listing is
                        # not), recorded per drifted resource.
                        repaired, gen = self.twin.snapshot_raw(sorted(per))
                        for res, items in repaired.items():
                            self.journal.record_rebase(
                                res, items, gen,
                                rv=listing.get(res, ([], ""))[1],
                                why="anti-entropy",
                            )
                    with self._maint_lock:
                        self._pending.clear()
                        self._invalidate_prep()
                        self._prep_gen = self.twin.generation
                    self._capacity_rebase()
                    self._set_state("live")
                    self._recompute_state()
            if tr is not None:
                tr.root.set(drift=drift)
            return drift

    # -- telemetry -----------------------------------------------------------

    @contextlib.contextmanager
    def _traced(self, op: str):
        """Run one supervisor operation under its own recorded trace (ids
        ``watch-<op>-<n>`` in the flight recorder) when tracing is on."""
        tr = tracing.start_trace(f"watch-{op}", request_id=f"watch-{op}-{next(self._trace_seq)}")
        if tr is None:
            yield None
            return
        status = "ok"
        try:
            with tracing.trace_scope(tr):
                yield tr
        except BaseException:
            status = "error"
            raise
        finally:
            tr.finish(status=status)
            FLIGHT_RECORDER.record(tr)

    def metrics_lines(self) -> List[str]:
        """Prometheus lines for /metrics (rendered by the REST layer under
        the one recorder lock)."""
        esc = escape_label_value
        state = self.state()
        hdr = family_header  # headers come from the obs/metrics.py registry

        with RECORDER.lock:
            lines = hdr("simon_watch_state")
            lines += [
                f'simon_watch_state{{state="{esc(s)}"}} {int(s == state)}'
                for s in STATES
            ]
            lines += hdr("simon_watch_events_total")
            lines += [
                f'simon_watch_events_total{{kind="{esc(k)}",resource="{esc(res)}"}} {n}'
                for (k, res), n in sorted(self.events_total.items())
            ]
            lines += [
                *hdr("simon_watch_reconnects_total"),
                f"simon_watch_reconnects_total {self.reconnects_total}",
                *hdr("simon_watch_relists_total"),
                f"simon_watch_relists_total {self.relists_total}",
                *hdr("simon_watch_gone_total"),
                f"simon_watch_gone_total {self.gone_total}",
                *hdr("simon_twin_drift_total"),
            ]
            # stable per-resource series from the first scrape: every
            # watched resource renders (0 until drift is attributed to it)
            drift_res = {res: 0 for res in self.watched}
            drift_res.update(self.drift_by_resource)
            lines += [
                f'simon_twin_drift_total{{resource="{esc(res)}"}} {n}'
                for res, n in sorted(drift_res.items())
            ]
            lines += [
                *hdr("simon_twin_resyncs_total"),
                f"simon_twin_resyncs_total {self.resyncs_total}",
                # the generation gauge: every applied event bumps it — a flatlined generation under traffic is
                # the "watch died" smoke signal dashboards alert on
                *hdr("simon_twin_generation"),
                f"simon_twin_generation {self.twin.generation}",
            ]
        # the freshness pipeline's journaled stage
        lines += FRESHNESS.metrics_lines()
        return lines
