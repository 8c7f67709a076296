"""Incremental prepare: a content-keyed encode cache and delta re-encoding —
the port of ``opensim_tpu/engine/prepcache.py``.

Repeated simulations against one cluster would pay the full host-side
``prepare()`` (workload expansion plus the cluster encode, the largest
host cost of a 50k-pod plan) on every call. This module makes them pay for
their changes instead:

- ``PrepareCache``: an LRU of ``prepare()`` outputs keyed by a cluster/app
  content fingerprint, with per-entry locks and pristine bind-state
  snapshots (``simulate``'s decode writes into the prepared pods; entries
  are restored after every use, so a hit is indistinguishable from a fresh
  prepare).
- Delta re-encoders over a cached base ``Prepared``:
    * ``derive_with_apps`` — append apps' expanded pods to the stream (new
      templates assemble against the cached node arenas);
    * ``extend_with_nodes`` — add nodes (the planner's candidates, a
      request's ``newnodes``), splicing their DaemonSet pods in at the
      positions a fresh expansion would give them;
    * ``drop_mask_for_scaled`` — flip pod-validity bits for the pods a
      scale request removes, instead of re-encoding the shrunk cluster.
- ``twin_pod_delta``: the live twin's O(changes) maintenance of a base
  entry (``server/watch.py``) — pods ADDED by watch events inserted at the
  end of the bare region through a fork of the encoder, pods DELETED kept
  in the stream as valid-mask flips (``CacheEntry.base_drop``), refused
  past the compaction threshold.
- ``simulate_cached``: one simulation through the cache.

A delta's stream has the pod order of a fresh ``prepare()`` and its encoded
arrays equal the fresh ones (template, domain and vocabulary ids may be
numbered differently; the kernel does not care). Its tensors go to the
base's device; with a cache entry, only the leaves the delta changed are
uploaded (``CacheEntry.dev_map``). The serving fleet publishes a warm
base entry over shared memory (``publication_parts``) and each worker
rebuilds it on its own device (``entry_from_publication``).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..encoding.state import ClusterEncoder, EncodedCluster, ScanState, to_device
from ..models import expand
from ..models.objects import LABEL_APP_NAME, Pod, ResourceTypes, touch_epoch
from ..ops import kernels
from ..utils.gcpause import gc_paused
from ..utils.trace import PREP_STATS
from . import queues
from .simulator import (
    AppResource,
    Prepared,
    SimulateResult,
    _owner_selector,
    _tmpl_hint,
    ds_targets,
    prepare,
    restore_bind_state,
    simulate,
    snapshot_bind_state,
)

# ---------------------------------------------------------------------------
# content fingerprints
# ---------------------------------------------------------------------------


def _meta_rv(obj: object) -> str:
    raw = getattr(obj, "raw", None) or {}
    return str((raw.get("metadata") or {}).get("resourceVersion", ""))


def fingerprint_cluster(cluster: ResourceTypes) -> str:
    """Content key for a cluster snapshot. Hashes object identity + version
    (name/uid/resourceVersion) plus the node fields that feed the encoder
    directly, so hand-built clusters (no uid/rv) still key on node content.
    In-place mutation of an already-fingerprinted object is NOT detected —
    callers that edit objects must invalidate explicitly (the REST server
    re-fingerprints on every snapshot refresh)."""
    h = hashlib.blake2b(digest_size=16)
    for n in cluster.nodes:
        h.update(
            "|".join(
                (
                    "n",
                    n.metadata.name,
                    n.metadata.uid or "",
                    _meta_rv(n),
                    "1" if n.unschedulable else "0",
                    json.dumps(sorted(n.metadata.labels.items())),
                    json.dumps(sorted((t.key, t.value, t.effect) for t in n.taints)),
                    json.dumps(sorted(n.allocatable.items())),
                    n.metadata.annotations.get("simon/node-local-storage", ""),
                )
            ).encode()
        )
    for p in cluster.pods:
        m = p.metadata
        h.update(f"p|{m.namespace}|{m.name}|{m.uid}|{_meta_rv(p)}|{p.spec.node_name}|{p.phase}".encode())
    for kind, objs in (
        ("dep", cluster.deployments),
        ("rs", cluster.replica_sets),
        ("sts", cluster.stateful_sets),
        ("ds", cluster.daemon_sets),
        ("job", cluster.jobs),
        ("cj", cluster.cron_jobs),
    ):
        for w in objs:
            h.update(
                f"{kind}|{w.metadata.namespace}|{w.metadata.name}|{w.metadata.uid}|{_meta_rv(w)}|{w.replicas}".encode()
            )
    return h.hexdigest()


def fingerprint_apps(apps: List[AppResource]) -> str:
    """Content key for an app list: hashes each object's raw dict when
    present (request payloads round-trip exactly), identity otherwise."""
    h = hashlib.blake2b(digest_size=16)
    for app in apps:
        h.update(f"a|{app.name}".encode())
        rt = app.resources
        for objs in (rt.pods, rt.deployments, rt.replica_sets, rt.stateful_sets, rt.daemon_sets, rt.jobs,
                     rt.cron_jobs):
            for o in objs:
                raw = getattr(o, "raw", None)
                if raw:
                    h.update(json.dumps(raw, sort_keys=True, default=str).encode())
                else:
                    h.update(f"{type(o).__name__}|{o.metadata.namespace}|{o.metadata.name}|{o.metadata.uid}".encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


class StaleFingerprintError(RuntimeError):
    """A cache hit landed on an entry whose watched object was ``touch()``ed
    after the entry was fingerprinted — the cached encoding no longer
    matches the object's content. Fix: ``cache.invalidate(obj)`` after the
    mutation. ``obj`` carries the offending object so the cache can evict
    everything it taints."""

    def __init__(self, message: str, obj: Optional[object] = None) -> None:
        super().__init__(message)
        self.obj = obj


def _watched_objects(cluster: ResourceTypes, apps: List[AppResource]) -> List[object]:
    """Every model object a (cluster, apps) fingerprint covers — the set
    the stale-entry guard watches for version bumps."""
    out: List[object] = []
    for rt in [cluster] + [a.resources for a in apps]:
        for objs in (rt.nodes, rt.pods, rt.deployments, rt.replica_sets, rt.stateful_sets, rt.daemon_sets,
                     rt.jobs, rt.cron_jobs,
                     # the raw kinds are versioned too: they enter no
                     # fingerprint, but touch()/invalidate(obj) holds for
                     # every model object a cluster carries
                     rt.services, rt.pdbs, rt.storage_classes, rt.pvcs, rt.config_maps):
            out.extend(objs)
    return out


#: (watched (object, version) pairs, touch epoch) — both captured at
#: FINGERPRINT time, before the (possibly seconds-long) prepare runs, so a
#: touch()+invalidate() landing during the build is not lost: the entry
#: records pre-build versions and an epoch older than the touch, forcing the
#: next check_fresh to scan and catch it.
WatchSnapshot = Tuple[List[Tuple[object, int]], int]


def watch_snapshot(cluster: ResourceTypes, apps: List[AppResource]) -> WatchSnapshot:
    """Capture the stale-guard baseline for a (cluster, apps) pair. The
    epoch is read BEFORE the versions: a touch interleaving between the
    two reads then leaves the entry's epoch behind the global one, which
    forces a full version scan on the next check_fresh."""
    epoch = touch_epoch()
    pairs = [(o, getattr(o, "_local_version", 0)) for o in _watched_objects(cluster, apps)]
    return pairs, epoch


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    invalidations: int = 0
    evictions: int = 0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "invalidations": self.invalidations,
                "evictions": self.evictions}


# drop-mask compaction telemetry: how many times twin_pod_delta REFUSED a
# delta because the masked rows crossed the threshold, forcing the caller's
# full rebuild (the event that re-compacts the stream). Process-global: the
# refusal site has no cache handle.
_compaction_lock = threading.Lock()
_compactions = 0  # guarded-by: _compaction_lock


def note_compaction() -> None:
    global _compactions
    with _compaction_lock:
        _compactions += 1


def compactions_total() -> int:
    with _compaction_lock:
        return _compactions


class CacheEntry:
    """One cached ``Prepared`` plus everything reuse needs: a pristine
    bind-state snapshot, a lock serializing uses of the (shared) pod
    objects, and the map from numpy leaves to their tensors on the device
    so delta builds re-upload only the leaves they changed. Entries derived
    from a base share the base's lock — their pod streams alias the same
    objects. ``drop_mask`` is the pod-validity flip a derived entry serves
    with (a scale request's, joined with its base's ``base_drop``);
    ``base_drop`` is a live-twin base entry's: the pods watch events
    deleted, kept in the cached stream with their validity flipped. The
    entry turns on its Prepared's
    ``inputs_memo``: a hit reuses the kernel's inputs, which live on the
    device as long as the entry does."""

    def __init__(self, key: str, prep: Optional[Prepared], base: Optional["CacheEntry"] = None,
                 watch: Optional[WatchSnapshot] = None) -> None:
        self.key = key
        self.prep = prep
        # the base lends its lock and its watch list, and no reference: a
        # live twin's lineage derives a new base entry every generation, and
        # a chain of bases would keep every old Prepared (and its tensors on
        # the card) alive
        self.lock = base.lock if base is not None else threading.RLock()
        self.bind_snap = snapshot_bind_state(prep) if prep is not None else []
        if prep is not None and prep.inputs_memo is None:
            prep.inputs_memo = {}
        self.drop_mask: Optional[np.ndarray] = None
        self.base_drop: Optional[np.ndarray] = None  # guarded-by: lock
        self._dev_map: Optional[dict] = None  # guarded-by: lock
        # (object, version at fingerprint time): the stale-entry guard.
        # Derived entries share the base's list: their stream aliases the
        # same objects, and the base was proven fresh before the delta.
        if watch is None and base is not None:
            self.watched: List[Tuple[object, int]] = base.watched
            self._touch_epoch = base._touch_epoch
        elif watch is not None:
            self.watched, self._touch_epoch = watch
        else:
            self.watched, self._touch_epoch = [], touch_epoch()

    def restore(self) -> None:
        if self.prep is not None:
            restore_bind_state(self.prep, self.bind_snap)

    def watches(self, obj: object) -> bool:
        return any(o is obj for o, _ in self.watched)

    def check_fresh(self) -> None:
        """Raise StaleFingerprintError if any watched object was touched
        since this entry was fingerprinted. ``touch()`` bumps a
        process-global epoch, so when nothing anywhere was touched since
        (the steady state) this is one integer compare; a clean scan re-arms
        the fast path at the current epoch."""
        epoch = touch_epoch()
        if epoch == self._touch_epoch:
            return
        for obj, v0 in self.watched:
            v1 = getattr(obj, "_local_version", 0)
            if v1 != v0:
                kind = getattr(obj, "kind", type(obj).__name__)
                meta = getattr(obj, "metadata", None)
                name = getattr(meta, "name", "?") if meta is not None else "?"
                raise StaleFingerprintError(
                    f"cached prepare is stale: {kind} {name!r} was touch()ed (version {v1} vs {v0} at "
                    "fingerprint time) without cache invalidation; call cache.invalidate(obj) after mutating "
                    "a fingerprinted object",
                    obj=obj,
                )
        self._touch_epoch = epoch

    def dev_map(self) -> dict:
        """{id(numpy leaf): tensor on the device} over the entry's
        EncodedCluster — delta assemblies reuse the uploaded tensor of
        every leaf the delta did not touch."""
        with self.lock:
            if self._dev_map is None:
                self._dev_map = {id(np_leaf): leaf for np_leaf, leaf in zip(self.prep.ec_np, self.prep.ec)}
            return self._dev_map


class PrepareCache:
    """Thread-safe LRU of CacheEntry keyed by content fingerprint."""

    def __init__(self, capacity: int = 8) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()  # guarded-by: _lock
        self.stats = CacheStats()

    def get(self, key: str) -> Optional[CacheEntry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return entry

    def put(self, key: str, entry: CacheEntry) -> CacheEntry:
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                return existing  # racing builders: first one wins
            self._entries[key] = entry
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
            return entry

    def invalidate(self, target: Union[str, object] = "") -> int:
        """Drop cache entries; returns the number dropped.

        - ``invalidate()`` — everything;
        - ``invalidate(prefix)`` — entries whose key starts with ``prefix``
          (the REST server's path when the snapshot's fingerprint changes);
        - ``invalidate(obj)`` — entries whose fingerprint covered the model
          object ``obj`` (by identity): the call to make after mutating an
          already-fingerprinted object in place. Pair with ``obj.touch()``
          so a forgotten invalidation fails loudly (StaleFingerprintError)
          instead of serving stale placements."""
        with self._lock:
            if isinstance(target, str):
                doomed = [k for k in self._entries if k.startswith(target)]
            else:
                doomed = [k for k, e in self._entries.items() if e.watches(target)]
            for k in doomed:
                del self._entries[k]
            self.stats.invalidations += len(doomed)
        if doomed:
            # the trace event outside the cache lock
            from ..obs import trace as obs

            obs.event("prepcache.invalidate", dropped=len(doomed))
        return len(doomed)

    def check_fresh(self, entry: CacheEntry) -> None:
        """Entry freshness check that also EVICTS on staleness: a proven
        stale entry can never become fresh again, and a REST client cannot
        call invalidate(obj). Eviction is by the offending object, dropping
        every entry it taints (a base entry and its derived full-key
        entries share one watch list), then by the entry's key."""
        from ..resilience import faults

        try:
            # a fault here (exc name ``stale``) lands like a mid-flight touch()
            faults.fault_point("cache.stale")
            entry.check_fresh()
        except StaleFingerprintError as e:
            from ..obs import trace as obs

            obs.event("prepcache.stale", status="error", key=entry.key)
            if e.obj is not None:
                self.invalidate(e.obj)
            self.invalidate(entry.key)
            raise

    def entries_snapshot(self) -> List[CacheEntry]:
        """Point-in-time list of resident entries, LRU-oldest first."""
        with self._lock:
            return list(self._entries.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ---------------------------------------------------------------------------
# delta assembly
# ---------------------------------------------------------------------------


def _assemble_delta(base: Prepared, base_entry: Optional[CacheEntry], enc: ClusterEncoder, ordered: List[Pod],
                    tmpl_parts: List, forced_parts: List, n_cluster: int, n_bare: int,
                    ds_group_sizes: List[int]) -> Prepared:
    """Build the forked encoder and put the result on the base's device,
    reusing the base entry's tensors for the leaves the delta shares."""
    ec_np, st0_np, meta = enc.build()
    reuse = base_entry.dev_map() if base_entry is not None and base_entry.prep is not None else None
    ec, st0 = to_device(ec_np, st0_np, base.device, reuse=reuse)
    parts = [np.asarray(p, dtype=np.int32) for p in tmpl_parts if len(p)]
    fparts = [np.asarray(p, dtype=bool) for p in forced_parts if len(p)]
    return Prepared(
        ec=ec,
        st0=st0,
        ec_np=ec_np,
        st0_np=st0_np,
        meta=meta,
        ordered=ordered,
        tmpl_ids=np.concatenate(parts) if parts else np.zeros((0,), np.int32),
        forced=np.concatenate(fparts) if fparts else np.zeros((0,), bool),
        ds_target=ds_targets(ordered, meta),
        features=kernels.features_of(ec_np),
        device=base.device,
        encoder=enc,
        n_cluster=n_cluster,
        n_bare=n_bare,
        ds_group_sizes=ds_group_sizes,
    )


def _expand_app(cluster: ResourceTypes, app: AppResource, use_greed: bool) -> List[Pod]:
    """The app expansion of ``simulator.prepare``."""
    app_pods = expand.generate_pods_from_resources(app.resources, cluster.nodes)
    for p in app_pods:
        p.metadata.labels.setdefault(LABEL_APP_NAME, app.name)
    app_pods = queues.toleration_sort(queues.affinity_sort(app_pods))
    if use_greed:
        app_pods = queues.greed_sort(cluster.nodes, app_pods)
    return app_pods


def derive_with_apps(base: Prepared, cluster: ResourceTypes, apps: List[AppResource], use_greed: bool = False,
                     base_entry: Optional[CacheEntry] = None) -> Optional[Prepared]:
    """Delta re-encode: the cached base's stream plus `apps` appended —
    the stream ``prepare(cluster, apps)`` gives when the base was prepared
    from the same cluster with no apps. `base_entry` (whose prep is
    `base`) keeps the device tensors of unchanged leaves. Returns None
    when the result would be empty."""
    got = derive_with_app_slices(base, cluster, apps, use_greed=use_greed, base_entry=base_entry)
    return None if got is None else got[0]


@gc_paused()
def derive_with_app_slices(base: Prepared, cluster: ResourceTypes, apps: List[AppResource], use_greed: bool = False,
                           base_entry: Optional[CacheEntry] = None
                           ) -> Optional[Tuple[Prepared, List[Tuple[int, int]]]]:
    """:func:`derive_with_apps` that also reports per-app stream slices:
    ``(prep, slices)``, where ``slices[k] = (lo, hi)`` is the half-open
    range app ``k``'s expanded pods occupy in ``prep.ordered``."""
    if isinstance(base, CacheEntry):  # the entry accepted directly
        base_entry, base = base, base.prep
    t0 = time.monotonic()
    enc = base.encoder.fork()
    new_pods: List[Pod] = []
    slices: List[Tuple[int, int]] = []
    n_base = len(base.ordered)
    for app in apps:
        lo = n_base + len(new_pods)
        new_pods.extend(_expand_app(cluster, app, use_greed))
        slices.append((lo, n_base + len(new_pods)))
    if not new_pods and not base.ordered:
        return None
    tmpl_new = [enc.add_pod(p, (lambda p=p: _owner_selector(p)), hint=_tmpl_hint(p)) for p in new_pods]
    prep = _assemble_delta(
        base, base_entry, enc,
        ordered=list(base.ordered) + new_pods,
        tmpl_parts=[base.tmpl_ids, tmpl_new],
        forced_parts=[base.forced, [bool(p.spec.node_name) for p in new_pods]],
        n_cluster=base.n_cluster,
        n_bare=base.n_bare,
        ds_group_sizes=list(base.ds_group_sizes),
    )
    PREP_STATS.record("delta_apps", time.monotonic() - t0)
    return prep, slices


@gc_paused()
def extend_with_nodes(base: Prepared, new_nodes: List, cluster: ResourceTypes, apps: List[AppResource],
                      use_greed: bool = False, base_entry: Optional[CacheEntry] = None) -> Optional[Prepared]:
    """`base` (prepared from `cluster` and `apps`, its pods as prepared:
    restore them first if a simulation ran on it) plus `new_nodes`, as
    ``prepare`` of the cluster with those nodes appended would encode it:
    the new nodes go into a fork of the base's encoder and their DaemonSet
    pods are spliced into the stream where a fresh expansion puts them.
    `base_entry` (whose prep is `base`) keeps the device tensors of
    unchanged leaves. Returns None where a delta cannot reproduce a fresh
    prepare, and the caller prepares afresh:

    - the greedy sort orders app pods by node totals, which the new nodes
      change, so the whole stream may reorder;
    - an app's DaemonSets expand one pod per node inside the app's sorted
      region, where a splice need not keep the order.
    """
    if use_greed or any(a.resources.daemon_sets for a in apps):
        return None
    t0 = time.monotonic()
    # per-DaemonSet pods for the new nodes, in cluster.daemon_sets order:
    # the order _cluster_pods expands them in
    groups_new = [expand.pods_from_daemon_set(ds, new_nodes) for ds in cluster.daemon_sets]
    if len(groups_new) != len(base.ds_group_sizes):
        return None  # the cluster's DaemonSets are not the base's: not a pure node delta
    enc = base.encoder.fork()
    enc.extend_nodes(new_nodes)

    b = base.n_cluster - sum(base.ds_group_sizes)
    ordered: List = list(base.ordered[:b])
    tmpl_parts: List = [base.tmpl_ids[:b]]
    forced_parts: List = [base.forced[:b]]
    ds_group_sizes: List[int] = []
    off = b
    for size, pods_k in zip(base.ds_group_sizes, groups_new):
        ordered.extend(base.ordered[off : off + size])
        tmpl_parts.append(base.tmpl_ids[off : off + size])
        forced_parts.append(base.forced[off : off + size])
        off += size
        ordered.extend(pods_k)
        tmpl_parts.append([enc.add_pod(p, (lambda p=p: _owner_selector(p)), hint=_tmpl_hint(p)) for p in pods_k])
        forced_parts.append([bool(p.spec.node_name) for p in pods_k])
        ds_group_sizes.append(size + len(pods_k))
    # the apps' region rides along unchanged (they have no DaemonSets here)
    ordered.extend(base.ordered[base.n_cluster :])
    tmpl_parts.append(base.tmpl_ids[base.n_cluster :])
    forced_parts.append(base.forced[base.n_cluster :])
    prep = _assemble_delta(
        base, base_entry, enc,
        ordered=ordered,
        tmpl_parts=tmpl_parts,
        forced_parts=forced_parts,
        n_cluster=base.n_cluster + sum(len(g) for g in groups_new),
        n_bare=base.n_bare,
        ds_group_sizes=ds_group_sizes,
    )
    PREP_STATS.record("delta_nodes", time.monotonic() - t0)
    return prep


def drop_mask_for_scaled(prep: Prepared, owned_by: Callable[[Pod, set], bool], scaled: set) -> np.ndarray:
    """Valid-mask flip for a scale request: mark the BARE cluster pods owned
    by the scaled workloads (the pods ``scale-apps`` removes from the
    snapshot before re-simulating). Only the bare prefix is eligible — the
    fresh path filters ``cluster.pods``, never workload expansions."""
    mask = np.zeros((len(prep.ordered),), dtype=bool)
    for i in range(prep.n_bare):
        if owned_by(prep.ordered[i], scaled):
            mask[i] = True
    return mask


def pad_drop_mask(mask: Optional[np.ndarray], n: int) -> Optional[np.ndarray]:
    """Extend a base-entry drop mask to a longer derived stream. Safe for
    both derive paths: ``derive_with_apps`` appends at the end and
    ``extend_with_nodes`` splices only above the bare-pod prefix, while
    drop masks only ever flag bare pods — set bits never move (a twin
    delta that inserts pods builds its own mask)."""
    if mask is None:
        return None
    if len(mask) >= n:
        return mask[:n]
    out = np.zeros((n,), dtype=bool)
    out[: len(mask)] = mask
    return out


def union_drop_masks(a: Optional[np.ndarray], b: Optional[np.ndarray], n: int) -> Optional[np.ndarray]:
    """Union of two (optional) drop masks, padded to stream length ``n``."""
    a = pad_drop_mask(a, n)
    b = pad_drop_mask(b, n)
    if a is None:
        return b
    if b is None:
        return a
    return a | b


@gc_paused()
def twin_pod_delta(base_entry: CacheEntry, key: str, added: List[Pod], removed_keys: set,
                   watch: Optional[WatchSnapshot] = None) -> Optional[CacheEntry]:
    """O(changes) base-entry maintenance for the live twin
    (``server/watch.py``): a new base entry after a batch of pod ADDED and
    DELETED watch events, without re-expanding or re-encoding the cluster.

    - `added` pods go into a fork of the cached encoder and are inserted at
      the END OF THE BARE REGION, where a fresh ``prepare()`` of the
      re-listed cluster puts them (the twin appends new pods to its pod
      list in event order). Every later row moves, so the new Prepared gets
      its own (empty) ``inputs_memo`` from the new entry.
    - `removed_keys`, ``(namespace, name)`` pairs, become valid-mask flips
      in ``CacheEntry.base_drop``: the pods stay in the stream and every
      launch skips them, as a scale request's dropped pods. A delete-only
      delta shares the base's Prepared (its kernel inputs too): drops
      travel as pod validity, never into the inputs.

    Returns None where the entry cannot express the delta — no encoder, a
    removed pod outside the bare region, or more masked rows than
    ``max(64, P // 4)`` (the compaction threshold: the caller's full
    rebuild then compacts the stream). MUST be called with
    ``base_entry.lock`` held and bind state restored."""
    prep = base_entry.prep
    if prep is None or prep.encoder is None or prep.ds_group_sizes is None:
        return None
    t0 = time.monotonic()
    nb = prep.n_bare
    drop = (np.array(base_entry.base_drop, dtype=bool, copy=True) if base_entry.base_drop is not None
            else np.zeros((len(prep.ordered),), dtype=bool))
    if removed_keys:
        found = set()
        for i in range(nb):
            p = prep.ordered[i]
            k = (p.metadata.namespace, p.metadata.name)
            if k in removed_keys:
                drop[i] = True
                found.add(k)
        if removed_keys - found:
            # a deletion not in the bare prefix (never admissible, or in a
            # workload expansion): only the full rebuild expresses it
            return None
    if added:
        enc = prep.encoder.fork()
        ids_new = [enc.add_pod(p, (lambda p=p: _owner_selector(p)), hint=_tmpl_hint(p)) for p in added]
        new_prep = _assemble_delta(
            prep, base_entry, enc,
            ordered=list(prep.ordered[:nb]) + list(added) + list(prep.ordered[nb:]),
            tmpl_parts=[prep.tmpl_ids[:nb], ids_new, prep.tmpl_ids[nb:]],
            forced_parts=[prep.forced[:nb], [bool(p.spec.node_name) for p in added], prep.forced[nb:]],
            n_cluster=prep.n_cluster + len(added),
            n_bare=nb + len(added),
            ds_group_sizes=list(prep.ds_group_sizes),
        )
        drop = np.concatenate([drop[:nb], np.zeros((len(added),), bool), drop[nb:]])
    else:
        new_prep = prep  # drops alone never re-encode: the mask is the delta
    # deleted pods stay as masked rows, so add/delete churn would grow the
    # stream without bound: past the threshold the delta is refused and the
    # caller re-prepares the compacted cluster
    n_dropped = int(drop.sum())
    if n_dropped > max(64, len(drop) // 4):
        note_compaction()
        return None
    entry = CacheEntry(key, new_prep, base=base_entry, watch=watch)
    entry.base_drop = drop if n_dropped else None
    PREP_STATS.record("twin_delta", time.monotonic() - t0)
    return entry


# ---------------------------------------------------------------------------
# attach-from-shm (the serving fleet, server/fleet.py)
# ---------------------------------------------------------------------------


def publication_parts(entry: CacheEntry) -> Optional[dict]:
    """The host-side pieces of a warm base entry a twin owner publishes
    over shared memory (server/fleet.py): everything a worker process
    needs to rebuild an equivalent :class:`CacheEntry` EXCEPT the tensors
    (each attaching process uploads once per generation) and the per-entry
    lock (locks are process-local). The carry comes back from the owner's
    device (``st0``, as the launches start from it). MUST be called with
    ``entry.lock`` held and bind state restored, like every other reader of
    the shared pod objects. None for a no-prep entry (a cluster with no
    schedulable pods: nothing to publish)."""
    prep = entry.prep
    if prep is None:
        return None
    return {
        "ec_np": prep.ec_np,
        "st0_np": ScanState(*[t.cpu().numpy() for t in prep.st0]),
        "meta": prep.meta,
        "ordered": prep.ordered,
        "tmpl_ids": prep.tmpl_ids,
        "forced": prep.forced,
        "ds_target": prep.ds_target,
        "features": prep.features,
        "encoder": prep.encoder,
        "n_cluster": prep.n_cluster,
        "n_bare": prep.n_bare,
        "ds_group_sizes": prep.ds_group_sizes,
        "base_drop": entry.base_drop,
    }


def entry_from_publication(key: str, parts: dict, device) -> CacheEntry:
    """Rebuild a warm base :class:`CacheEntry` on `device` from published
    parts — the worker-process half of the fleet's attach-from-shm path.
    The numpy leaves in ``parts`` may be zero-copy read-only views over
    shared memory; nothing here (or on any serving path over the entry)
    writes through them — deltas fork the encoder and drop masks are copied
    before mutation — and no tensor on the host aliases them
    (``encoding.state.to_device`` copies a read-only leaf there). The one
    per-attach cost is the upload of the encoded cluster (each process owns
    its tensors; later deltas reuse them leaf by leaf through
    ``CacheEntry.dev_map``)."""
    device = torch.device(device)
    ec_np: EncodedCluster = parts["ec_np"]
    st0_np: ScanState = parts["st0_np"]
    ec, st0 = to_device(ec_np, st0_np, device)
    prep = Prepared(
        ec=ec,
        st0=st0,
        ec_np=ec_np,
        st0_np=st0_np,
        meta=parts["meta"],
        ordered=parts["ordered"],
        tmpl_ids=parts["tmpl_ids"],
        forced=parts["forced"],
        ds_target=parts["ds_target"],
        features=parts["features"],
        device=device,
        encoder=parts["encoder"],
        n_cluster=parts["n_cluster"],
        n_bare=parts["n_bare"],
        ds_group_sizes=parts["ds_group_sizes"],
    )
    entry = CacheEntry(key, prep)
    with entry.lock:  # fresh and unpublished, but base_drop is guarded-by it
        entry.base_drop = parts.get("base_drop")
    return entry


# ---------------------------------------------------------------------------
# steady-state entry point
# ---------------------------------------------------------------------------


def simulate_cached(cluster: ResourceTypes, apps: List[AppResource], cache: PrepareCache, *,
                    use_greed: bool = False, node_pad: int = 1, device=None, sched_config: Optional[object] = None,
                    extra_plugins: tuple = (), tie_seed: Optional[int] = None,
                    key: Optional[str] = None) -> SimulateResult:
    """One full simulation through the encode cache: the first call for a
    (cluster, apps) content key pays the full prepare; every later call
    reuses the cached Prepared (fingerprint + bind-state restore — no
    expansion, no encode). The entry's tensors live on `device` (the card
    unless the caller names another); the device is part of the key."""
    full_key = key or (
        fingerprint_cluster(cluster) + "|" + fingerprint_apps(apps) + f"|g{int(use_greed)}|p{node_pad}|d{device}"
    )
    entry = cache.get(full_key)
    if entry is None:
        # baseline captured BEFORE the build: a touch()+invalidate() racing
        # the prepare leaves this entry provably stale, not silently fresh
        watch = watch_snapshot(cluster, apps)
        prep = prepare(cluster, apps, use_greed=use_greed, node_pad=node_pad, device=device)
        entry = cache.put(full_key, CacheEntry(full_key, prep, watch=watch))
    else:
        t0 = time.monotonic()
        cache.check_fresh(entry)
        with entry.lock:
            entry.restore()
        PREP_STATS.record("hit", time.monotonic() - t0)
    if entry.prep is None:
        return simulate(cluster, apps, use_greed=use_greed, node_pad=node_pad, device=device,
                        sched_config=sched_config, extra_plugins=extra_plugins, tie_seed=tie_seed)
    with entry.lock:
        try:
            return simulate(cluster, apps, sched_config=sched_config, extra_plugins=extra_plugins,
                            tie_seed=tie_seed, prep=entry.prep)
        finally:
            entry.restore()
