"""The multi-process serving fleet and its hot standby — the port's copy of
``opensim_tpu/server/fleet.py``: shared-memory twin publication, worker
processes past the GIL, and the HA control plane.

The roles:

- **twin owner** (the parent, :func:`serve_fleet`): runs the watch
  supervisor and journal exactly like the single-process server, and after
  every twin generation change publishes the warm base entry's host arrays
  over POSIX shared memory (``multiprocessing.shared_memory``):

    * one **content-keyed segment per numpy buffer** (the
      ``EncodedCluster``/``ScanState`` fields, template ids, masks). Segment
      names derive from the buffer's content hash, so a generation that
      changed 2 of 75 arrays re-publishes 2 segments and the workers
      re-attach 2;
    * one **blob segment** holding the pickled host-side state (the twin's
      cluster objects, the pod stream, the encoder, the decode tables); its
      pickler externalizes every numpy leaf into the segments above, so
      arrays cross the process boundary once, by name;
    * a small **control block** with a seqlock: ``seq`` goes odd, the
      generation/fingerprint/segment-directory payload is swapped, ``seq``
      goes even. Readers retry on an odd or changed ``seq``: a worker never
      observes a torn generation (tests/test_torch_fleet.py).

  The owner prepares the base entry on its own device (the card unless
  ``--device`` names another) and brings the carry back to the host for
  the publication.

- **N server workers** (:func:`run_worker`, spawned as fresh ``python -m
  opensim_tpu_torch server`` interpreters with ``OPENSIM_FLEET_ATTACH``
  set, never forked: a process that has touched CUDA cannot fork): attach
  the segments read-only, rebuild the numpy views zero-copy
  (``np.frombuffer``), rebuild a warm base ``CacheEntry`` on their device
  through ``prepcache.entry_from_publication`` (one upload per generation
  per worker), and serve the full admission → request batch → simulate
  ladder, launching the scan kernels. Placements equal the single-process
  server's. Workers share the public port via ``SO_REUSEPORT`` and each
  binds a loopback listener the owner scrapes for aggregation. A worker
  that cannot reach the card exits non-zero; it never serves on the CPU.

- **supervision**: a crashed worker is respawned with the resilience
  layer's full-jitter backoff (``resilience.retry.backoff_delay``) and
  reattaches at the CURRENT generation. SIGTERM drains the fleet in order:
  workers first (each drains its admission queue), owner last (reflectors
  stopped, journal flushed and fsynced, segments unlinked).

Shared-memory discipline: segments are created, attached and unlinked ONLY
in this module. The owner unlinks everything on close/atexit, and the
stdlib resource tracker (a separate process that survives even SIGKILL of
the owner) unlinks whatever an owner crash leaves behind. Workers
unregister their attachments from their own tracker: an exiting worker
never destroys the owner's live segments.

**HA control plane**: with ``OPENSIM_HA=1`` the owner holds a **fenced
lease** (:class:`FleetLease`, a JSON file beside the journal carrying a
monotonic ``epoch``), renewed at a third of ``OPENSIM_HA_LEASE_S``. The
epoch is woven into every shared-memory name and into the publication
payload, and :meth:`TwinPublisher.publish` re-validates the lease right
before the seqlock control swap: a deposed owner's late publish raises
:class:`FencedWrite` (``simon_fleet_fenced_writes_total``) instead of
becoming attachable. A hot standby (``simon server --standby``,
:func:`serve_standby`) tails the journal live (:class:`~.journal.
JournalTailer`) onto its own twin and takes over on lease expiry or
explicit release (``POST /api/fleet/handover``, the rolling-upgrade path):
it bumps the epoch, starts a fresh :class:`~.watch.WatchSupervisor` from
the tailed state (zero relists, reflectors resuming at the recorded rvs),
**adopts** the surviving worker processes recorded in the lease, and
republishes at a continuous generation; workers follow the lease file to
the new control block without dropping a request.
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import hashlib
import io
import json
import logging
import os
import pickle
import re
import secrets
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from ..obs.fleetobs import FRESHNESS
from ..obs.metrics import (
    FAMILIES,
    RECORDER,
    CounterVec,
    HistogramVec,
    escape_label_value,
    family_header,
    parse_metrics,
)
from ..resilience import faults
from ..resilience.retry import backoff_delay
from ..utils import envknobs, jitcache
from ..utils.gcpause import CollectorWatch, gc_paused

if TYPE_CHECKING:
    import torch

    from ..device import DeviceLike

log = logging.getLogger("opensim_tpu_torch.server")

__all__ = [
    "ControlBlock",
    "FencedWrite",
    "FleetLease",
    "FleetReader",
    "FleetTwinClient",
    "StandbyOwner",
    "TornGeneration",
    "TwinPublisher",
    "lease_path",
    "render_aggregated",
    "run_worker",
    "serve_fleet",
    "serve_standby",
    "worker_argv",
]

# control-block layout (little-endian):
#   0..8    magic
#   8..16   seq        — seqlock: odd while a publish is in flight
#   16..24  payload len
#   24..32  generation
#   32..    payload    — json: fingerprint, state, stale, blob segment,
#                        array-segment directory (accounting + GC)
_MAGIC = b"SIMFLT01"
_HEADER = struct.Struct("<8sQQQ")
_CONTROL_SIZE = 256 * 1024

#: arrays smaller than this ride inside the pickled blob (a dedicated
#: segment per 8-byte scalar array would be pure overhead, and zero-size
#: arrays cannot be shm segments at all)
_INLINE_BYTES = 64

#: how long the publisher's exit hook waits for its lock before it leaves
#: the segments to the resource tracker
CLOSE_AT_EXIT_WAIT_S = 5.0


def resolve_device(device: "DeviceLike"):
    """``device.resolve_device``, imported when first needed: the
    publication and its readers stay importable without torch (a reader
    process imports this module alone)."""
    from ..device import resolve_device as resolve

    return resolve(device)


class TornGeneration(RuntimeError):
    """A reader exhausted its seqlock retries without observing one stable
    publication — the owner is either republishing faster than the reader
    can attach or has died mid-publish. Counted in
    ``simon_fleet_attach_retries_exhausted_total``; the caller keeps
    serving its previously attached generation."""


class FencedWrite(RuntimeError):
    """A publish was refused because the HA lease moved past this owner's
    epoch — the process has been deposed and must demote instead of
    split-braining. Counted in ``simon_fleet_fenced_writes_total``; the
    seqlock control block is left untouched, so no worker can ever attach
    a stale-epoch generation."""


#: the HA lease file, created beside the journal segments (the journal
#: directory is the one piece of shared durable state the owner and the
#: standby already agree on)
HA_LEASE_FILENAME = "ha-lease.json"


def lease_path(state_dir: str) -> str:
    return os.path.join(state_dir, HA_LEASE_FILENAME)


def ha_enabled() -> bool:
    return bool(envknobs.value("OPENSIM_HA"))


def ha_lease_s() -> float:
    # the registered validator owns the parse and the raise-on-typo policy
    return float(envknobs.value("OPENSIM_HA_LEASE_S"))


def ha_tail_poll_s() -> float:
    return float(envknobs.value("OPENSIM_HA_TAIL_POLL_MS")) / 1000.0


def ha_handover_timeout_s() -> float:
    return float(envknobs.value("OPENSIM_HA_HANDOVER_TIMEOUT_S"))


def _pid_alive(pid: int) -> bool:
    if not pid or pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # e.g. EPERM: it exists, it just isn't ours
    return True


class FleetLease:
    """Fenced ownership of the fleet: one JSON file, one monotonic epoch.

    The file carries ``{epoch, holder, pid, renewed_at, released, ...}``
    plus owner metadata (control-block name, ports, worker pids) that the
    standby needs for takeover and the workers need to re-resolve the
    owner. Writes are atomic (temp file + ``os.replace``); there is
    deliberately no fsync — the lease is a liveness signal, not durable
    history, and a machine crash takes owner and lease down together.

    Correctness story: ``acquire`` only steals a lease that is absent,
    explicitly released, or older than ``lease_s``; it writes epoch+1 and
    then **confirms after a settle window** — of two racing acquirers the
    later write wins the file, the loser observes a foreign holder on
    re-read and stands down. ``check``/``renew`` observe the file every
    time: the moment another epoch appears, the holder is fenced and every
    subsequent :meth:`TwinPublisher.publish` refuses with
    :class:`FencedWrite`. Chaos point ``fleet.lease_steal`` forces the
    fenced verdict deterministically.
    """

    #: settle window between the acquire write and its confirming re-read
    ACQUIRE_CONFIRM_S = 0.05

    def __init__(self, path: str, lease_s: Optional[float] = None,
                 holder: Optional[str] = None) -> None:
        self.path = path
        self.lease_s = float(lease_s) if lease_s is not None else ha_lease_s()
        self.holder = holder or f"{os.getpid()}-{secrets.token_hex(4)}"
        self.epoch = 0  # 0 = not holding
        self.write_max_s = 0.0  # the longest write of the file (a stall's share that is I/O)

    # -- file I/O ------------------------------------------------------------

    def read(self) -> Optional[dict]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else None
        except (OSError, ValueError):
            return None

    def _write(self, doc: dict) -> None:
        # the lease may be the journal directory's FIRST file (the owner
        # acquires before opening the journal for append)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        body = json.dumps(doc, sort_keys=True)
        t0 = time.monotonic()
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(body)
        os.replace(tmp, self.path)
        self.write_max_s = max(self.write_max_s, time.monotonic() - t0)

    # -- verdicts ------------------------------------------------------------

    @staticmethod
    def age_s(doc: Optional[dict]) -> float:
        if doc is None:
            return float("inf")
        try:
            return max(0.0, time.time() - float(doc.get("renewed_at") or 0.0))
        except (TypeError, ValueError):
            return float("inf")

    def claimable(self, doc: Optional[dict]) -> bool:
        """Absent, explicitly released, or expired — stealable."""
        return doc is None or bool(doc.get("released")) or self.age_s(doc) > self.lease_s

    # -- lifecycle -----------------------------------------------------------

    def acquire(self, meta: Optional[dict] = None) -> Optional[int]:
        """Take the lease (epoch+1) if it is claimable (or already ours).
        Returns the new epoch, or None when a live foreign holder owns it
        or a racing acquirer won the settle window."""
        doc = self.read()
        if doc is not None and doc.get("holder") != self.holder and not self.claimable(doc):
            return None
        epoch = int((doc or {}).get("epoch") or 0) + 1
        body = {
            "epoch": epoch, "holder": self.holder, "pid": os.getpid(),
            "renewed_at": time.time(), "released": False,
        }
        body.update(meta or {})
        self._write(body)
        time.sleep(self.ACQUIRE_CONFIRM_S)
        cur = self.read()
        if (
            cur is None
            or cur.get("holder") != self.holder
            or int(cur.get("epoch") or -1) != epoch
        ):
            return None  # lost the race: the later writer owns the file
        self.epoch = epoch
        return epoch

    def check(self) -> bool:
        """True while this process still holds the lease at its epoch.
        False IS the fencing verdict — the caller must stop publishing."""
        try:
            faults.fault_point("fleet.lease_steal")
        except Exception as e:
            log.warning("fleet lease: injected steal (%s); fencing", e)
            return False
        doc = self.read()
        return (
            doc is not None
            and doc.get("holder") == self.holder
            and int(doc.get("epoch") or -1) == self.epoch
            and not doc.get("released")
        )

    def renew(self, **updates) -> bool:
        """Re-stamp ``renewed_at`` (merging ``updates`` into the metadata)
        under our epoch. False = fenced; the caller demotes."""
        if not self.check():
            return False
        doc = self.read()
        if doc is None:
            return False
        doc["renewed_at"] = time.time()
        doc.update(updates)
        self._write(doc)
        return True

    def release(self, handover: bool = False) -> None:
        """Mark the lease released (the graceful-handover signal: the
        standby may take over immediately instead of waiting out the
        expiry window). No-op when the lease is no longer ours."""
        doc = self.read()
        if doc is None or doc.get("holder") != self.holder:
            return
        doc["released"] = True
        doc["handover"] = bool(handover)
        doc["renewed_at"] = time.time()
        self._write(doc)


_SHM_CLS = None


def _shm_cls():
    """The one construction point for stdlib shm segments (every create,
    attach and unlink stays inside this file). The subclass makes
    ``close()`` tolerate live buffer exports: at interpreter shutdown the
    stdlib ``__del__`` closes segments in GC order, and a zero-copy numpy
    view that outlives its segment object would otherwise spray
    ``BufferError`` tracebacks over every worker exit (the mmap itself is
    freed safely once the last view dies — suppressing the eager close is
    correct, not cosmetic)."""
    global _SHM_CLS
    if _SHM_CLS is None:
        from multiprocessing import shared_memory

        class _Segment(shared_memory.SharedMemory):
            def close(self) -> None:
                try:
                    super().close()
                except BufferError:
                    pass

        _SHM_CLS = _Segment
    return _SHM_CLS


#: segment names THIS process created (it owns their tracker registration
#: and their unlink); in-process readers — tests, the owner's own attach
#: fallback — must not unregister them out from under the owner
_OWNED_NAMES: set = set()


def _attach(name: str):
    """Attach an existing segment WITHOUT adopting ownership: Python's
    resource tracker would otherwise unlink the owner's segment when this
    (reader) process exits — exactly the destruction the owner/reader
    split exists to prevent. Segments created by this very process keep
    their registration (the owner's crash-cleanup backstop)."""
    shm = _shm_cls()(name=name)
    if name not in _OWNED_NAMES:
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
        except Exception as e:  # pragma: no cover - tracker layout off-CPython
            log.debug("resource-tracker unregister failed: %s: %s", type(e).__name__, e)
    return shm


class ControlBlock:
    """The seqlock-guarded publication header.

    One writer (the twin owner), many readers (workers). ``write`` bumps
    ``seq`` to odd, swaps the payload, bumps to even; ``read`` snapshots
    ``seq`` before and after and retries unless both are the same even
    value. 8-byte aligned header writes and bounded retries make torn
    reads impossible to observe, not merely unlikely."""

    def __init__(self, name: Optional[str] = None, create: bool = False,
                 size: int = _CONTROL_SIZE) -> None:
        self.create = create
        if create:
            self.name = name or f"simon-fleet-{os.getpid()}-{secrets.token_hex(4)}"
            self._shm = _shm_cls()(
                name=self.name, create=True, size=size
            )
            _OWNED_NAMES.add(self.name)
            self._seq = 0
            _HEADER.pack_into(self._shm.buf, 0, _MAGIC, 0, 0, 0)
        else:
            if not name:
                raise ValueError("attaching a ControlBlock requires its name")
            self.name = name
            self._shm = _attach(name)
            magic = bytes(self._shm.buf[:8])
            if magic != _MAGIC:
                raise ValueError(
                    f"shared-memory segment {name!r} is not a fleet control block"
                )

    # -- writer side ---------------------------------------------------------

    def write(self, generation: int, payload: dict) -> None:
        data = json.dumps(payload, sort_keys=True).encode()
        if _HEADER.size + len(data) > self._shm.size:
            raise ValueError(
                f"fleet control payload ({len(data)}B) exceeds the control "
                f"block ({self._shm.size}B); raise the control size"
            )
        buf = self._shm.buf
        self._seq += 1  # odd: publication in flight
        struct.pack_into("<Q", buf, 8, self._seq)
        struct.pack_into("<Q", buf, 16, len(data))
        struct.pack_into("<Q", buf, 24, generation)
        buf[_HEADER.size : _HEADER.size + len(data)] = data
        self._seq += 1  # even: stable
        struct.pack_into("<Q", buf, 8, self._seq)

    # -- reader side ---------------------------------------------------------

    def seq(self) -> int:
        return struct.unpack_from("<Q", self._shm.buf, 8)[0]

    def poll(self) -> Optional[int]:
        """(generation) of the current stable publication, or None before
        the first publish / while a swap is in flight."""
        got = self.poll_state()
        return got[0] if got is not None else None

    def poll_state(self) -> Optional[Tuple[int, int]]:
        """(generation, seq) of the current stable publication. The seq
        is the change detector: a republish at the SAME generation (a
        staleness/state flip on a quiet twin) bumps it, and readers must
        refresh their payload on any bump, not only on generation
        moves."""
        s1 = self.seq()
        if s1 == 0 or s1 % 2:
            return None
        gen = struct.unpack_from("<Q", self._shm.buf, 24)[0]
        if self.seq() != s1:
            return None
        return int(gen), s1

    def read(self) -> Optional[Tuple[int, dict, int]]:
        """One seqlock read attempt: ``(generation, payload, seq)`` or
        None on a torn/absent publication (caller retries). The json
        parse is inside the torn-read net on purpose: the pure-Python
        seqlock carries no memory fences, so on a weakly-ordered CPU a
        stable-looking seq pair can still cover torn payload bytes — a
        parse failure IS a torn read, never an exception on the serving
        path."""
        s1 = self.seq()
        if s1 == 0 or s1 % 2:
            return None
        _magic, _seq, n, gen = _HEADER.unpack_from(self._shm.buf, 0)
        data = bytes(self._shm.buf[_HEADER.size : _HEADER.size + n])
        if self.seq() != s1:
            return None
        try:
            return int(gen), json.loads(data.decode()), s1
        except ValueError:
            return None

    def close(self) -> None:
        with contextlib.suppress(BufferError, OSError):
            self._shm.close()

    def unlink(self) -> None:
        with contextlib.suppress(FileNotFoundError, OSError):
            self._shm.unlink()
        _OWNED_NAMES.discard(self.name)


# ---------------------------------------------------------------------------
# pickling with externalized arrays
# ---------------------------------------------------------------------------


class _ShmPickler(pickle.Pickler):
    """Pickles the publication blob with every material numpy buffer
    externalized into a content-keyed segment: the blob carries
    ``("shmarr", segment, dtype, shape)`` stubs, the publisher writes each
    distinct buffer exactly once, and the reader rebuilds zero-copy
    ``np.frombuffer`` views. Pickle's memo keeps aliased arrays (the
    encoder's arenas ARE the encoded cluster's node tensors) aliased."""

    def __init__(self, file, put_array) -> None:
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self._put_array = put_array

    def persistent_id(self, obj):
        if (
            type(obj) is np.ndarray
            and obj.dtype != object
            and obj.nbytes >= _INLINE_BYTES
        ):
            name = self._put_array(obj)
            return ("shmarr", name, obj.dtype.str, obj.shape)
        return None


class _ShmUnpickler(pickle.Unpickler):
    def __init__(self, file, get_segment) -> None:
        super().__init__(file)
        self._get_segment = get_segment

    def persistent_load(self, pid):
        tag, name, dtype, shape = pid
        if tag != "shmarr":
            raise pickle.UnpicklingError(f"unknown persistent id {tag!r}")
        shm = self._get_segment(name)
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(shm.buf, dtype=np.dtype(dtype), count=count)
        arr = arr.reshape(shape)
        arr.flags.writeable = False
        return arr


# ---------------------------------------------------------------------------
# owner side: the publisher
# ---------------------------------------------------------------------------


class TwinPublisher:
    """Publishes generation-stamped arena deltas over shared memory.

    Owned by the twin-owner process. ``publish`` is called with the warm
    base entry's :func:`engine.prepcache.publication_parts` (under the
    entry lock — the shared pod objects must be quiescent while they
    pickle); unchanged buffers keep their content-keyed segments, so a
    steady twin republishes only the blob and the control block.

    Lifecycle: ``close()`` unlinks everything; it is also registered via
    ``atexit``, and the stdlib resource tracker unlinks whatever a crash
    leaves behind — ``/dev/shm`` hygiene is tested, not hoped for."""

    def __init__(self, token: Optional[str] = None,
                 control_size: int = _CONTROL_SIZE, keep_generations: int = 2,
                 epoch: int = 0, lease: Optional[FleetLease] = None) -> None:
        # the epoch is woven into the token, hence into EVERY segment name
        # and the control-block name: two owners can never collide on a
        # shared-memory name, and a worker can see at a glance (and the
        # payload check below can enforce) which fencing epoch published it
        self.epoch = int(epoch)
        self.lease = lease
        default = f"{os.getpid()}-{secrets.token_hex(4)}"
        self.token = token or (f"e{self.epoch}-{default}" if self.epoch else default)
        self.control = ControlBlock(
            name=f"simon-fleet-{self.token}", create=True, size=control_size
        )
        self.keep_generations = keep_generations
        self._segments: Dict[str, object] = {}  # name -> SharedMemory
        self._seg_bytes: Dict[str, int] = {}
        self._gen_segments: "Dict[int, set]" = {}
        self._lock = threading.Lock()
        self.publishes_total = 0
        self.fenced_writes_total = 0  # guarded-by: _lock
        self.last_generation = -1
        self.publish_seconds = HistogramVec("simon_fleet_publish_seconds", ())
        self._closed = False
        atexit.register(self._close_at_exit)

    # -- segments ------------------------------------------------------------

    def _segment_name(self, data: np.ndarray) -> str:
        digest = hashlib.blake2b(data, digest_size=12).hexdigest()
        return f"simon-fleet-{self.token}-{digest}"

    def _put_bytes(self, data, current: set) -> str:
        """One content-keyed segment holding `data` (bytes, or a
        C-contiguous array). The hash and the copy run on a flat byte view
        and release the GIL (blake2b past 2 KiB, ``np.copyto``): a 0.5 GB
        buffer must not stall the owner's other threads, its lease
        renewals first, for the length of a copy."""
        flat = np.frombuffer(data, dtype=np.uint8) if isinstance(data, bytes) else data.reshape(-1).view(np.uint8)
        name = self._segment_name(flat)
        current.add(name)
        if name in self._segments:
            return name
        try:
            shm = _shm_cls()(name=name, create=True, size=flat.size)
            _OWNED_NAMES.add(name)
        except FileExistsError:
            # content-keyed: an existing same-name segment holds the same
            # bytes (it was published by US under this run token)
            shm = _attach(name)
        dst = np.frombuffer(shm.buf, dtype=np.uint8, count=flat.size)
        np.copyto(dst, flat)
        del dst  # no export may outlive the copy: close() needs none
        self._segments[name] = shm
        self._seg_bytes[name] = flat.size
        return name

    # -- publish -------------------------------------------------------------

    def publish(self, generation: int, cluster, parts: Optional[dict],
                state: str = "live", stale: bool = False) -> dict:
        """Write one publication: array segments, blob segment, control
        swap (seqlock), then garbage-collect segments no generation within
        the keep window references."""
        t0 = time.monotonic()
        # publication stamp: fold pending accepted-event ids
        # into a trace dict BEFORE taking self._lock — FRESHNESS takes
        # RECORDER.lock, and this publisher deliberately never nests the
        # two (see publish_seconds below)
        trace_info = FRESHNESS.publication(generation)
        with self._lock:
            self._check_fence()  # refuse before wasting segment writes
            current: set = set()
            arrays: List[Tuple[str, str, List[int]]] = []

            def put_array(arr: np.ndarray) -> str:
                a = np.ascontiguousarray(arr)
                name = self._put_bytes(a, current)
                arrays.append((name, a.dtype.str, list(a.shape)))
                return name

            buf = io.BytesIO()
            _ShmPickler(buf, put_array).dump({"cluster": cluster, "parts": parts})
            blob = self._put_bytes(buf.getvalue(), current)
            fingerprint = hashlib.blake2b(
                ("|".join(sorted(current)) + f"|{blob}").encode(), digest_size=16
            ).hexdigest()
            payload = {
                "fingerprint": fingerprint,
                "state": state,
                "stale": bool(stale),
                "blob": blob,
                "arrays": arrays,
                "token": self.token,
                "epoch": self.epoch,
                # cross-process stitching: publication span id + carried
                # event ids (bounded, PUB_EVENTS_MAX) ride the control
                # block to every attaching worker
                "trace": trace_info,
            }
            # chaos shm.republish: a publish dying HERE leaves the seqlock
            # even and the directory untouched — readers keep the previous
            # stable generation (the segments written above are garbage
            # until a control swap names them; close() unlinks them)
            faults.fault_point("shm.republish")
            # the authoritative fencing gate: nothing a worker can attach
            # is ever swapped in under a stale epoch. Re-checked HERE (not
            # only at entry) because the segment writes above take real
            # time — a lease stolen mid-publish must still fence the swap.
            self._check_fence()
            self.control.write(generation, payload)
            self._gen_segments[generation] = current
            self.publishes_total += 1
            self.last_generation = generation
            self._gc_segments()
        seconds = time.monotonic() - t0
        with RECORDER.lock:
            self.publish_seconds.observe(seconds, ())
        return payload

    def _gc_segments(self) -> None:
        """Unlink segments referenced by no generation in the keep window.
        A reader attaching the PREVIOUS directory mid-swap may race an
        unlink — its attach fails with FileNotFoundError and the seqlock
        retry picks up the new directory; keeping one extra generation
        makes that race rare instead of per-publish."""
        gens = sorted(self._gen_segments)
        keep = gens[-self.keep_generations :]
        live: set = set()
        for g in keep:
            live |= self._gen_segments[g]
        for g in gens:
            if g not in keep:
                del self._gen_segments[g]
        for name in list(self._segments):
            if name not in live:
                shm = self._segments.pop(name)
                self._seg_bytes.pop(name, None)
                with contextlib.suppress(FileNotFoundError, OSError, BufferError):
                    shm.unlink()
                _OWNED_NAMES.discard(name)
                with contextlib.suppress(BufferError, OSError):
                    shm.close()

    def _check_fence(self) -> None:
        """Raise :class:`FencedWrite` (and count it) when the HA lease no
        longer names this owner's epoch. No-op outside HA mode."""
        if self.lease is None:
            return
        if not self.lease.check():
            self.fenced_writes_total += 1
            raise FencedWrite(
                f"lease epoch moved past {self.epoch}; publish refused "
                "(this owner is deposed and must demote)"
            )

    # -- accounting / teardown ----------------------------------------------

    def footprint(self) -> dict:
        with self._lock:
            return {
                "segments": len(self._segments) + 1,  # + control block
                "bytes": sum(self._seg_bytes.values()) + _CONTROL_SIZE,
                "publishes": self.publishes_total,
                "generation": self.last_generation,
                "fenced_writes": self.fenced_writes_total,
                "epoch": self.epoch,
            }

    def close(self) -> None:
        """Unlink every owned segment (idempotent)."""
        with self._lock:
            self._close_locked()

    def _close_at_exit(self) -> None:
        """``close`` at interpreter exit, where a daemon thread may be
        frozen mid-publication holding the lock: wait a bounded time, then
        leave the segments to the resource tracker, which unlinks what a
        dead process owned."""
        if self._closed:
            return
        if not self._lock.acquire(timeout=CLOSE_AT_EXIT_WAIT_S):
            log.warning("fleet publisher: lock still held at exit; the resource tracker unlinks the segments")
            return
        try:
            self._close_locked()
        finally:
            self._lock.release()

    def _close_locked(self) -> None:
        if self._closed:
            return
        self._closed = True
        for name, shm in self._segments.items():
            with contextlib.suppress(FileNotFoundError, OSError, BufferError):
                shm.unlink()
            _OWNED_NAMES.discard(name)
            with contextlib.suppress(BufferError, OSError):
                shm.close()
        self._segments.clear()
        self._seg_bytes.clear()
        self.control.unlink()
        self.control.close()


# ---------------------------------------------------------------------------
# worker side: the reader
# ---------------------------------------------------------------------------


def attach_retries() -> int:
    # the registered validator owns the parse/clamp and the warn-and-
    # fall-back policy (utils/envknobs.py)
    return int(envknobs.value("OPENSIM_FLEET_ATTACH_RETRIES"))


class FleetReader:
    """Attaches a publication and rebuilds the host-side view.

    Attached segments are cached by (content-keyed) name, so a generation
    that changed 2 arrays re-attaches 2 segments and reuses the rest —
    the reader half of delta publication. Dropped cache references are
    NOT closed eagerly: live numpy views pin the mmap via the buffer
    protocol, and Python frees it only after the last view dies, which is
    what makes handing zero-copy views to long-lived cache entries safe."""

    def __init__(self, control_name: str, retries: Optional[int] = None) -> None:
        self.control = ControlBlock(name=control_name, create=False)
        self.retries = retries if retries is not None else attach_retries()
        self._cache: Dict[str, object] = {}  # segment name -> SharedMemory
        self.attaches_total = 0
        self.retries_total = 0
        self.retries_exhausted_total = 0
        self.segment_reuse_total = 0
        self.last_seq: Optional[int] = None  # seq validated by the last attach()

    def poll(self) -> Optional[int]:
        return self.control.poll()

    def poll_state(self) -> Optional[Tuple[int, int]]:
        return self.control.poll_state()

    def _segment(self, name: str):
        shm = self._cache.get(name)
        if shm is None:
            shm = _attach(name)
            self._cache[name] = shm
        else:
            self.segment_reuse_total += 1
        return shm

    def attach(self) -> Tuple[int, dict, dict]:
        """(generation, payload, blob object) for the current stable
        publication. Retries the whole read on any torn observation — an
        odd/changed seqlock, or a segment unlinked between the directory
        read and the attach. Raises :class:`TornGeneration` when the
        retry budget is exhausted."""
        last_err: Optional[BaseException] = None
        for attempt in range(self.retries):
            if attempt:
                self.retries_total += 1
                time.sleep(min(0.05, 0.002 * attempt))
            got = self.control.read()
            if got is None:
                last_err = None
                continue
            gen, payload, seq = got
            try:
                blob_shm = self._segment(payload["blob"])
                data = bytes(blob_shm.buf[:])
                obj = _ShmUnpickler(io.BytesIO(data), self._segment).load()
            except FileNotFoundError as e:
                last_err = e  # segment GC'd mid-swap: re-read the directory
                continue
            if self.control.seq() != seq:
                last_err = None
                continue  # a publish landed while we attached
            # drop cache references no longer named by this publication
            # (the mmaps stay alive until the last numpy view dies)
            live = {payload["blob"]} | {name for name, _, _ in payload["arrays"]}
            for name in [n for n in self._cache if n not in live]:
                del self._cache[name]
            self.attaches_total += 1
            self.last_seq = seq
            return gen, payload, obj
        self.retries_exhausted_total += 1
        raise TornGeneration(
            f"no stable fleet publication after {self.retries} attempts"
            + (f" (last error: {last_err})" if last_err else "")
        )

    def close(self) -> None:
        self.control.close()
        self._cache.clear()


class FleetTwinClient:
    """The worker's stand-in for the watch supervisor: same serving
    interface (``serving_snapshot``/``state``/``metrics_lines``), backed
    by the owner's shared-memory publication instead of a private watch
    pipeline. On a generation change it attaches the new view, rebuilds
    the warm base entry (``prepcache.entry_from_publication``) and swaps
    it into the server's prep cache under the new generation key — the
    request path then behaves exactly as with a live twin."""

    key_prefix = "fleet|"

    #: how often a worker re-reads the HA lease file for an owner change
    LEASE_CHECK_S = 0.25

    def __init__(self, control_name: str, prep_cache=None,
                 lease_file: str = "", device: "DeviceLike" = None) -> None:
        self.control_name = control_name
        self.prep_cache = prep_cache
        # the device each attached generation's base entry is uploaded to
        # (the card unless the caller names another)
        self.device = device
        self.capacity = None  # assigned by SimonServer; bootstrap is per key
        self.journal = None
        # HA: when the supervisor hands us the lease path, the worker
        # follows it — a failover republishes under a NEW control block (the
        # epoch is in the name), and the lease file is how the worker finds
        # it without restarting
        self.lease_file = lease_file
        self._lease_epoch = 0
        self._next_lease_check = 0.0
        self.owner_switches_total = 0
        self._reader: Optional[FleetReader] = None
        self._lock = threading.Lock()
        self._gen: Optional[int] = None
        self._seq: Optional[int] = None  # guarded-by: _lock
        self._cluster = None
        self._payload: Optional[dict] = None
        self._synced = threading.Event()

    # -- lifecycle (the serve() supervisor contract) -------------------------

    def start(self, wait_s: Optional[float] = None) -> bool:
        deadline = time.monotonic() + (wait_s if wait_s is not None else 120.0)
        attempt = 0
        while time.monotonic() < deadline:
            try:
                if self._reader is None:
                    self._reader = FleetReader(self.control_name)
                if self._reader.poll() is not None:
                    self._synced.set()
                    return True
            except (FileNotFoundError, ValueError):
                self._reader = None  # owner not up yet
            attempt += 1
            time.sleep(min(0.25, 0.01 * attempt))
        return False

    def stop(self) -> None:
        if self._reader is not None:
            self._reader.close()

    def attach_journal(self, journal) -> None:  # pragma: no cover - owner-only
        raise RuntimeError("fleet workers do not own a journal (the twin owner does)")

    def has_synced(self) -> bool:
        return self._synced.is_set()

    # -- serving interface ---------------------------------------------------

    def state(self) -> str:
        p = self._payload
        return f"fleet-{p['state']}" if p else "fleet-attaching"

    def is_stale(self) -> bool:
        p = self._payload
        return bool(p.get("stale")) if p else True

    def serving_snapshot(self):
        """(cluster, cache key, stale?) — None before the first attach.
        Steady state is one seqlock poll; ANY new publication re-attaches
        — a generation move swaps the warm base entry under the new key,
        and a same-generation republish (the owner flipping
        staleness/state on a quiet twin) refreshes the payload so
        degraded responses keep their stale tag."""
        self._follow_lease()
        reader = self._reader
        if reader is None:
            return None
        state = reader.poll_state()
        with self._lock:
            if state is not None and state[1] != self._seq:
                try:
                    self._attach_locked()
                except TornGeneration as e:
                    log.warning("fleet attach failed (%s); serving previous generation", e)
            if self._gen is None:
                return None
            return self._cluster, f"{self.key_prefix}{self._gen}", self.is_stale()

    def _follow_lease(self) -> None:
        """Failover discovery: when the HA lease names a DIFFERENT control
        block (a new owner took over at a higher epoch), swap readers and
        keep serving the old mmap'd generation until the new owner's first
        publication attaches — a worker never drops a request across a
        failover. Throttled to one file read per LEASE_CHECK_S."""
        if not self.lease_file:
            return
        now = time.monotonic()
        if now < self._next_lease_check:
            return
        self._next_lease_check = now + self.LEASE_CHECK_S
        try:
            with open(self.lease_file, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return  # lease unreadable mid-replace or gone: keep serving
        epoch = int(doc.get("epoch") or 0)
        if epoch > self._lease_epoch:
            self._lease_epoch = epoch
        control = str(doc.get("control") or "")
        if not control or control == self.control_name:
            return
        try:
            reader = FleetReader(control)
            if reader.poll() is None:
                # the new owner exists but has not published yet: stay on
                # the old (still mmap'd) generation and retry next check
                reader.close()
                return
        except (FileNotFoundError, ValueError):
            return
        with self._lock:
            # the old reader is dropped, NOT closed: request threads may be
            # mid-poll on it, and the live numpy views pin its mmaps anyway
            self._reader = reader
            self.control_name = control
            self._seq = None  # force a fresh attach on the next snapshot
            self.owner_switches_total += 1
        log.info(
            "fleet worker: followed the lease to new owner control %s "
            "(epoch %d)", control, epoch,
        )

    def _attach_locked(self) -> None:
        from ..engine import prepcache
        from ..obs import trace as tracing

        t0 = time.perf_counter()
        gen, payload, obj = self._reader.attach()
        attach_s = time.perf_counter() - t0
        upload_s = None
        ep = int(payload.get("epoch") or 0)
        if self._lease_epoch and ep and ep < self._lease_epoch:
            # fencing, reader side: a deposed owner raced one last publish
            # in. Refuse it — the caller keeps serving the previous
            # generation until the current-epoch owner publishes.
            raise TornGeneration(
                f"stale-epoch publication refused (epoch {ep} < lease "
                f"epoch {self._lease_epoch})"
            )
        if gen != self._gen:
            key = f"{self.key_prefix}{gen}"
            if self.prep_cache is not None and obj.get("parts") is not None:
                t1 = time.perf_counter()
                entry = prepcache.entry_from_publication(
                    f"{key}|base", obj["parts"], resolve_device(self.device)
                )
                upload_s = time.perf_counter() - t1
                old_gen = self._gen
                self.prep_cache.put(f"{key}|base", entry)
                if old_gen is not None:
                    # trailing "|" so gen 5 cannot prefix-match gen 50's keys
                    self.prep_cache.invalidate(f"{self.key_prefix}{old_gen}|")
            self._cluster = obj["cluster"]
        self._gen = gen
        # the seq attach() VALIDATED, not the live one: a publish landing
        # after the attach must leave this behind so the next poll
        # re-attaches instead of silently serving the older payload
        self._seq = self._reader.last_seq
        self._payload = payload
        self._synced.set()
        # worker-side freshness stage + the stitching handoff: remember
        # the owner's publication span/event ids for this generation
        trace_info = payload.get("trace")
        FRESHNESS.attached(gen, trace_info)
        pub = trace_info if isinstance(trace_info, dict) else {}
        tracing.event(
            "fleet.attach", generation=gen, fingerprint=payload["fingerprint"],
            # the seqlock read and unpickle of the publication, and the
            # base entry's rebuild on this worker's device (its upload)
            attach_s=round(attach_s, 6),
            upload_s=None if upload_s is None else round(upload_s, 6),
            state=payload.get("state"), stale=payload.get("stale"),
            publication_span=pub.get("span"),
            publication_age_s=(
                round(time.time() - float(pub["pub_ts"]), 6)
                if pub.get("pub_ts") else None
            ),
        )

    # -- telemetry -----------------------------------------------------------

    def metrics_lines(self) -> List[str]:
        r = self._reader
        lines: List[str] = []
        pairs = (
            ("simon_fleet_attaches_total", r.attaches_total if r else 0),
            ("simon_fleet_attach_retries_total", r.retries_total if r else 0),
            (
                "simon_fleet_attach_retries_exhausted_total",
                r.retries_exhausted_total if r else 0,
            ),
            ("simon_fleet_segment_reuse_total", r.segment_reuse_total if r else 0),
            ("simon_fleet_attach_generation", self._gen if self._gen is not None else -1),
        )
        for name, value in pairs:
            lines += family_header(name)
            lines.append(f"{name} {value}")
        # worker-side freshness stages (attached/served)
        lines += FRESHNESS.metrics_lines()
        return lines

    def stitch_info(self) -> Tuple[Optional[int], Optional[dict]]:
        """(serving generation, owner publication trace dict) for the
        request being served RIGHT NOW — the REST layer stamps both onto
        the request trace so the flight recorder can graft the owner-side
        publication subtree under it. Also closes the freshness pipeline:
        the first request per generation observes the ``served`` stage."""
        with self._lock:
            gen = self._gen
        if gen is None:
            return None, None
        return gen, FRESHNESS.note_served(gen)


# ---------------------------------------------------------------------------
# worker process entry
# ---------------------------------------------------------------------------


def _reuse_port_server(address, handler):
    """The public listener shared across worker processes: every worker
    binds the same port with SO_REUSEPORT and the kernel load-balances
    accepted connections — no fd passing, and a respawned worker just binds
    again."""
    from .rest import SimonHTTPServer

    class _ReusePortHTTPServer(SimonHTTPServer):  # its backlog survives a connect storm
        def server_bind(self):
            if not hasattr(socket, "SO_REUSEPORT"):  # pragma: no cover - linux CI
                raise OSError("SO_REUSEPORT is unavailable on this platform; simon server --workers needs it")
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            super().server_bind()

    return _ReusePortHTTPServer(address, handler)


def run_worker(port: int, device: "DeviceLike" = None) -> int:
    """One fleet worker: attach the owner's publication, serve the full
    REST surface on the shared public port plus a loopback listener for
    the owner's aggregation scrapes. Invoked by ``simon server`` when
    ``OPENSIM_FLEET_ATTACH`` names a control block (the supervisor sets
    it; operators never do). Its simulations run on the card unless
    `device` names another; without a card it exits 1 before it attaches
    (a worker never serves on the CPU unless told to)."""
    from .rest import SimonServer, make_handler

    try:
        device = resolve_device(device)
    except RuntimeError as e:
        print(f"simon server[worker]: {e}", flush=True)
        return 1
    control = envknobs.raw("OPENSIM_FLEET_ATTACH")
    internal_raw = envknobs.raw("OPENSIM_FLEET_INTERNAL_PORT")
    client = FleetTwinClient(
        control, lease_file=envknobs.raw("OPENSIM_FLEET_LEASE"), device=device
    )
    if not client.start(wait_s=120.0):
        print(
            f"simon server[worker]: no fleet publication at {control!r} "
            "within 120s", flush=True,
        )
        return 1
    server = SimonServer(watch=client, device=device)
    client.prep_cache = server.prep_cache
    server.memory.start_ticker()
    handler = make_handler(server)
    httpd = _reuse_port_server(("0.0.0.0", port), handler)
    internal_httpd = None
    if internal_raw:
        internal_httpd = ThreadingHTTPServer(("127.0.0.1", int(internal_raw)), handler)
        threading.Thread(
            target=internal_httpd.serve_forever, name="simon-fleet-internal",
            daemon=True,
        ).start()

    def _graceful(signum, frame):
        log.info("worker received %s; draining", signal.Signals(signum).name)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _graceful)
        except ValueError:  # pragma: no cover - embedded use
            break
    print(
        f"simon server[worker {os.getpid()}] attached to fleet "
        f"(generation {client._gen if client._gen is not None else '?'}) "
        f"on :{port}",
        flush=True,
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        # same drain order as the single-process server: stop admitting
        # (queued tickets shed typed 503s, the in-flight batch completes),
        # then detach from the publication
        if internal_httpd is not None:
            internal_httpd.shutdown()
        server.close()
        client.stop()
        print(f"simon server[worker {os.getpid()}]: shutdown complete", flush=True)
    return 0


# ---------------------------------------------------------------------------
# owner process: publisher loop + worker supervision + admin endpoint
# ---------------------------------------------------------------------------


def publish_interval_s() -> float:
    # the registered validator owns the parse/clamp and the warn-and-
    # fall-back policy (utils/envknobs.py)
    return float(envknobs.value("OPENSIM_FLEET_PUBLISH_MS")) / 1000.0


def worker_argv(port: int, device: "torch.device") -> List[str]:
    """The command line of one fleet worker: a fresh interpreter of this
    package (never a fork: the owner has touched CUDA), serving the shared
    port; on the owner's device, named only when it is not the card."""
    argv = [sys.executable, "-m", "opensim_tpu_torch", "server", "--port", str(port), "--watch", "off"]
    if device.type != "cuda":
        argv += ["--device", str(device)]
    return argv


class _Worker:
    def __init__(self, index: int, internal_port: int) -> None:
        self.index = index
        self.internal_port = internal_port
        self.proc: Optional[subprocess.Popen] = None
        self.spawned_at = 0.0
        self.crashes = 0
        # HA takeover: an adopted worker was spawned by the PREVIOUS owner
        # and survived it — we only hold its pid, not a Popen handle
        self.pid = 0
        self.adopted = False

    def alive(self) -> bool:
        if self.proc is not None:
            return self.proc.poll() is None
        return self.adopted and self.pid > 0 and _pid_alive(self.pid)


#: gauges whose fleet aggregate is a max, not a sum (a summed generation
#: number is meaningless; everything else — counters, histogram buckets,
#: queue depths — sums correctly across workers)
_AGG_MAX = {"simon_fleet_attach_generation"}

#: families additionally exposed per worker as `{worker="<index>"}` series
#: next to the summed family. An allowlist, not
#: everything: per-worker copies of all ~100 families would multiply the
#: admin endpoint's cardinality by the fleet size for series nobody
#: breaks down per worker.
_PER_WORKER = {
    "simon_request_seconds",
    "simon_requests_total",
    "simon_lane_depth",
    "simon_fleet_attach_generation",
    "simon_fleet_attaches_total",
    "simon_fleet_freshness_seconds",
}

_TYPE_LINE = re.compile(r"^# TYPE (\S+) ", re.M)


def _family_of(name: str) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def render_aggregated(worker_texts: List[Optional[str]],
                      owner_text: str = "") -> str:
    """Merge per-worker /metrics expositions (index = worker id; None =
    scrape failed) with the owner's own exposition into ONE body:

    - every series summed across processes (bucket ladders are shared, so
      histogram sums stay valid histograms; ``_AGG_MAX`` families take the
      max — a summed generation number is meaningless);
    - ``_PER_WORKER`` families additionally rendered per worker with a
      ``worker="<index>"`` label next to the summed series (same family,
      same header — exposition-format conformant, zero duplicate series
      because the label set differs);
    - exactly one ``# HELP``/``# TYPE`` header per family, including
      sample-less families that appeared header-only in any input.

    Module-level and pure so the conformance test can drive it with
    canned texts — no shared memory, no live workers."""
    sums: Dict[tuple, float] = {}
    labeled: Dict[tuple, float] = {}
    header_only: set = set(_TYPE_LINE.findall(owner_text))
    for key, v in parse_metrics(owner_text).items():
        if key[0] in _AGG_MAX:
            sums[key] = max(sums.get(key, float("-inf")), v)
        else:
            sums[key] = sums.get(key, 0.0) + v
    for i, text in enumerate(worker_texts):
        if text is None:
            continue
        header_only |= set(_TYPE_LINE.findall(text))
        for (name, labels), v in parse_metrics(text).items():
            key = (name, labels)
            if name in _AGG_MAX:
                sums[key] = max(sums.get(key, float("-inf")), v)
            else:
                sums[key] = sums.get(key, 0.0) + v
            if _family_of(name) in _PER_WORKER:
                labeled[(name, labels + (("worker", str(i)),))] = v
    by_family: Dict[str, List[tuple]] = {}
    for store in (sums, labeled):
        for key in store:
            by_family.setdefault(_family_of(key[0]), [])
    lines: List[str] = []

    def _render(store: Dict[tuple, float], name: str, labels: tuple) -> None:
        body = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels)
        rendered = f"{store[(name, labels)]:.10g}"
        lines.append(f"{name}{{{body}}} {rendered}" if body else f"{name} {rendered}")

    for family in sorted(by_family):
        if family in FAMILIES:
            lines += family_header(family)
        header_only.discard(family)
        for name, labels in sorted(k for k in sums if _family_of(k[0]) == family):
            _render(sums, name, labels)
        for name, labels in sorted(k for k in labeled if _family_of(k[0]) == family):
            _render(labeled, name, labels)
    for family in sorted(header_only):
        if family in FAMILIES:
            lines += family_header(family)
    return "\n".join(lines) + "\n"


class FleetSupervisor:
    """The twin-owner process: watch supervisor + journal + publisher +
    worker supervision + the aggregated admin endpoint."""

    def __init__(self, supervisor, journal, port: int, workers: int,
                 admin_port: Optional[int] = None, lease: Optional[FleetLease] = None,
                 adopt: Optional[list] = None, takeover_reason: str = "",
                 device: "DeviceLike" = None) -> None:
        from ..engine.prepcache import PrepareCache

        # the owner prepares each published base entry here; its workers
        # serve on the same device (the card unless it names another)
        self.device = resolve_device(device)
        self.supervisor = supervisor
        self.journal = journal
        self.port = port
        self.n_workers = workers
        raw_admin = envknobs.raw("OPENSIM_FLEET_ADMIN_PORT")
        self.admin_port = admin_port or (int(raw_admin) if raw_admin else port + 1)
        self.prep_cache = PrepareCache()
        supervisor.prep_cache = self.prep_cache
        self.lease = lease
        self.publisher = TwinPublisher(
            epoch=lease.epoch if lease is not None else 0, lease=lease
        )
        self.workers = []
        adopted_by_index = {
            int(row.get("index", -1)): row for row in (adopt or [])
        }
        for i in range(workers):
            row = adopted_by_index.get(i)
            pid = int(row.get("pid") or 0) if row else 0
            if row and pid > 0 and _pid_alive(pid):
                # a survivor from the deposed owner: keep its recorded
                # loopback port and pid; it follows the lease to us on its
                # own — adopting it is what makes takeover relist-free
                w = _Worker(i, int(row.get("internal_port") or self.admin_port + 1 + i))
                w.pid = pid
                w.adopted = True
                w.spawned_at = time.monotonic()
            else:
                w = _Worker(i, self.admin_port + 1 + i)
            self.workers.append(w)
        self.takeover_reason = takeover_reason
        self.takeovers = CounterVec("simon_fleet_takeovers_total", ("reason",))
        if takeover_reason:
            with RECORDER.lock:
                self.takeovers.inc(labels=(takeover_reason,))
        self.respawns_total = 0
        # time-series ring + SLO engine: wired by
        # start_timeseries() — NOT the ctor, so tests can build a
        # supervisor without a sampler thread or disk ring
        self.timeseries = None
        self.slo = None
        self._sampler = None
        self.handed_over = False
        self._on_handover = None  # set by the serve loop: shut the admin server
        self._fenced = threading.Event()
        self._published_gen: Optional[int] = None
        self._published_stale: Optional[bool] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # the owner's stalls, in /api/fleet/status: what the cyclic collector
        # took, and the lease renewals' gaps
        self.collector = CollectorWatch().install()
        self.lease_renewals = {"count": 0, "gap_max_s": 0.0, "late_max_s": 0.0, "renew_max_s": 0.0}

    # -- publication ---------------------------------------------------------

    def publish_once(self) -> bool:
        """Publish the twin's current generation if it moved (or its
        staleness flipped). Returns True when a publication was written.

        The cyclic collector is paused over the whole publication (the fold,
        the base entry's build, the pickle walk), and what the generation
        built is then frozen out of its generations (``gc.freeze``): no
        collection walks the twin and its base entry, millions of objects
        at the server plan's size, while another thread of this process
        renews the lease. These objects are acyclic (a base entry dropped
        later is freed by refcounting), and the supervisor owns its
        process."""
        with gc_paused():
            published = self._publish_generation()
            if published:
                gc.freeze()
        return published

    def _publish_generation(self) -> bool:
        from ..engine import prepcache
        from ..engine.simulator import prepare

        if self._fenced.is_set():
            return False
        sup = self.supervisor
        if not sup.has_synced():
            return False
        got = sup.serving_snapshot()  # folds pending deltas into the base entry
        if got is None:
            return False
        cluster, key, stale = got
        gen = int(key.rsplit("|", 1)[-1])
        if gen == self._published_gen and stale == self._published_stale:
            return False
        base_key = f"{key}|base"
        base = self.prep_cache.get(base_key)
        if base is None:
            watch = prepcache.watch_snapshot(cluster, [])  # before the build
            base = self.prep_cache.put(
                base_key,
                prepcache.CacheEntry(
                    base_key, prepare(cluster, [], device=self.device), watch=watch
                ),
            )
        state = sup.state()
        if base.prep is None:
            self.publisher.publish(gen, cluster, None, state=state, stale=stale)
        else:
            with base.lock:
                # the pickle walks the shared pod objects: bind state must
                # be pristine and stay quiescent for the walk
                base.restore()
                parts = prepcache.publication_parts(base)
                self.publisher.publish(gen, cluster, parts, state=state, stale=stale)
        self._published_gen = gen
        self._published_stale = stale
        return True

    def _publish_loop(self) -> None:
        interval = publish_interval_s()
        while not self._stop.is_set():
            try:
                self.publish_once()
            except FencedWrite as e:
                log.warning("fleet publish fenced: %s", e)
                self._demote("fenced publish")
                return
            except Exception as e:
                log.warning("fleet publish failed: %s: %s", type(e).__name__, e)
            self._stop.wait(interval)

    # -- HA lease ------------------------------------------------------------

    def _lease_doc_meta(self) -> dict:
        return {
            "control": self.publisher.control.name,
            "port": self.port,
            "admin_port": self.admin_port,
            "n_workers": self.n_workers,
            "generation": self.publisher.last_generation,
            "workers": [
                {
                    "index": w.index,
                    "internal_port": w.internal_port,
                    "pid": w.proc.pid if w.proc is not None else w.pid,
                }
                for w in self.workers
            ],
        }

    def _lease_loop(self) -> None:
        assert self.lease is not None
        interval = max(0.2, self.lease.lease_s / 3.0)
        stats = self.lease_renewals
        last = None
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                ok = self.lease.renew(**self._lease_doc_meta())
            except OSError as e:  # transient fs hiccup: try again next beat
                log.warning("fleet lease renew I/O error: %s", e)
                ok = True
            if not ok:
                self._demote("lease lost (stolen or expired past another acquire)")
                return
            t1 = time.monotonic()
            stats["count"] += 1
            stats["renew_max_s"] = max(stats["renew_max_s"], t1 - t0)
            if last is not None:
                stats["gap_max_s"] = max(stats["gap_max_s"], t1 - last)
            last = t1
            self._stop.wait(interval)
            stats["late_max_s"] = max(stats["late_max_s"], time.monotonic() - t1 - interval)

    def _demote(self, why: str) -> None:
        """The lease moved under us: stop publishing and journaling NOW.
        The epoch fence already guarantees no worker attaches anything we
        write from here on; demotion just stops us burning the disk."""
        if self._fenced.is_set():
            return
        self._fenced.set()
        log.warning("fleet owner fenced: %s; demoting", why)

        def _down():
            # keep_workers: they belong to the NEW owner now (it adopted
            # their pids from the lease doc); killing them would drop the
            # very requests failover exists to save
            self.stop(keep_workers=True)

        threading.Thread(target=_down, name="simon-fleet-demote", daemon=True).start()

    # -- handover (rolling upgrade) ------------------------------------------

    def handover(self) -> Tuple[int, dict]:
        """POST /api/fleet/handover: drain and release the lease with the
        handover flag so the tailing standby takes over without waiting
        for expiry. Returns (http_status, body)."""
        if self.lease is None:
            return 409, {"error": "not running in HA mode (OPENSIM_HA)"}
        if self._fenced.is_set() or self.handed_over:
            return 409, {"error": "already fenced or handed over"}
        threading.Thread(
            target=self._handover_drain, name="simon-fleet-handover", daemon=True
        ).start()
        return 200, {"status": "draining", "epoch": self.lease.epoch}

    def _handover_drain(self) -> None:
        log.info("fleet handover: draining owner, releasing lease")
        self._fenced.set()  # no further publishes or lease renewals
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.journal is not None:
            self.journal.close(timeout=ha_handover_timeout_s())
        if self.lease is not None:
            with contextlib.suppress(OSError):
                self.lease.release(handover=True)
        self.handed_over = True
        cb = self._on_handover
        if cb is not None:
            cb()

    # -- workers -------------------------------------------------------------

    def _spawn(self, w: _Worker) -> None:
        # the owner's build directory: the worker loads the variants
        # _build_variants built, under OPENSIM_JIT_CACHE=0 too
        env = jitcache.export(dict(os.environ))
        env["OPENSIM_FLEET_ATTACH"] = self.publisher.control.name
        env["OPENSIM_FLEET_INTERNAL_PORT"] = str(w.internal_port)
        if self.lease is not None:
            # the worker follows the lease file across owner changes
            env["OPENSIM_FLEET_LEASE"] = self.lease.path
        # a worker must never recurse into fleet mode
        env.pop("OPENSIM_WORKERS_FLEET", None)
        w.adopted = False
        w.pid = 0
        w.proc = subprocess.Popen(worker_argv(self.port, self.device), env=env)
        w.spawned_at = time.monotonic()
        w.pid = w.proc.pid
        log.info("fleet worker %d spawned (pid %d)", w.index, w.proc.pid)

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            for w in self.workers:
                if self._stop.is_set():
                    return
                if w.alive():
                    if time.monotonic() - w.spawned_at > 30.0:
                        w.crashes = 0  # stable long enough: reset the backoff
                    continue
                rc = w.proc.returncode if w.proc is not None else None
                log.warning(
                    "fleet worker %d exited (rc=%s); respawning", w.index, rc
                )
                self.respawns_total += 1
                delay = backoff_delay(w.crashes, base_delay=0.25, max_delay=5.0)
                w.crashes += 1
                if self._stop.wait(delay):
                    return
                self._spawn(w)
            self._stop.wait(0.5)

    # -- aggregation ---------------------------------------------------------

    def _scrape_worker(self, w: _Worker) -> Optional[str]:
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{w.internal_port}/metrics", timeout=2.0
            ) as resp:
                return resp.read().decode()
        except OSError:
            return None

    def _owner_metrics_text(self, live: int) -> str:
        """The owner process's OWN exposition (fleet gauges, publisher
        histogram, twin/journal families, time-series ring + SLO engine).
        Fed through :func:`render_aggregated` like a worker text so every
        family renders exactly one header at the admin endpoint."""
        lines: List[str] = []
        fp = self.publisher.footprint()
        own = [
            ("simon_fleet_workers", live),
            ("simon_fleet_workers_target", self.n_workers),
            ("simon_fleet_respawns_total", self.respawns_total),
            ("simon_fleet_publishes_total", fp["publishes"]),
            ("simon_fleet_generation", fp["generation"]),
            ("simon_fleet_shm_segments", fp["segments"]),
            ("simon_fleet_shm_bytes", fp["bytes"]),
            ("simon_fleet_fenced_writes_total", fp["fenced_writes"]),
        ]
        if self.lease is not None:
            age = FleetLease.age_s(self.lease.read())
            if age != float("inf"):
                own.append(("simon_fleet_lease_age_seconds", f"{age:.3f}"))
        for name, value in own:
            lines += family_header(name)
            lines.append(f"{name} {value}")
        with RECORDER.lock:
            lines += self.publisher.publish_seconds.render_lines()
            takeover_lines = self.takeovers.render_lines()
        lines += takeover_lines or family_header("simon_fleet_takeovers_total")
        if self.supervisor is not None:
            lines += self.supervisor.metrics_lines()
        if self.journal is not None:
            lines += self.journal.metrics_lines()
        if self.timeseries is not None:
            lines += self.timeseries.metrics_lines()
        if self.slo is not None:
            lines += self.slo.metrics_lines()
        return "\n".join(lines) + "\n"

    def aggregate_metrics(self) -> str:
        """The fleet /metrics body: per-worker expositions merged with the
        owner's own families (:func:`render_aggregated` — summed series,
        ``worker=``-labeled per-worker copies, one header per family)."""
        texts = [self._scrape_worker(w) for w in self.workers]
        live = sum(1 for t in texts if t is not None)
        return render_aggregated(texts, self._owner_metrics_text(live))

    def status(self) -> dict:
        fp = self.publisher.footprint()
        fingerprint = None
        if self.supervisor is not None and self.supervisor.has_synced():
            try:
                fingerprint = self.supervisor.twin.fingerprint()
            except Exception as e:  # pragma: no cover - racing a rebase
                log.warning("twin fingerprint failed: %s: %s", type(e).__name__, e)
                fingerprint = None
        doc = self.lease.read() if self.lease is not None else None
        age = FleetLease.age_s(doc)
        return {
            "role": "fenced" if self._fenced.is_set() else "owner",
            "epoch": self.lease.epoch if self.lease is not None else 0,
            "lease_age_s": None if age == float("inf") else round(age, 3),
            "generation": self.publisher.last_generation,
            "fingerprint": fingerprint,
            "fenced_writes": fp["fenced_writes"],
            "workers": [
                {
                    "index": w.index,
                    "pid": w.proc.pid if w.proc is not None else (w.pid or None),
                    "alive": w.alive(),
                    "adopted": w.adopted,
                    "internal_port": w.internal_port,
                    "crashes": w.crashes,
                }
                for w in self.workers
            ],
            "target_workers": self.n_workers,
            "respawns_total": self.respawns_total,
            "twin_state": self.supervisor.state() if self.supervisor else "none",
            "shm": fp,
            "control": self.publisher.control.name,
            "port": self.port,
            "admin_port": self.admin_port,
            "lease_renewals": dict({k: round(v, 6) for k, v in self.lease_renewals.items()},
                                   write_max_s=round(self.lease.write_max_s, 6) if self.lease is not None else None),
            "collector": self.collector.snapshot(),
        }

    def healthz(self) -> dict:
        alive = self.alive_workers()
        return {
            "status": "ok" if alive == self.n_workers else "degraded",
            "role": "fenced" if self._fenced.is_set() else "fleet-owner",
            "epoch": self.lease.epoch if self.lease is not None else 0,
            "workers": alive,
            "target": self.n_workers,
            "generation": self.publisher.last_generation,
        }

    def metrics_text(self) -> str:
        return self.aggregate_metrics()

    def timeseries_payload(self, family: str = "",
                           range_s: Optional[float] = None) -> Optional[dict]:
        """``GET /api/debug/timeseries`` body (None → the caller answers
        503: the ring is not running, e.g. a standby's admin surface)."""
        if self.timeseries is None:
            return None
        return {
            "stats": self.timeseries.stats(),
            "samples": self.timeseries.query(family=family, range_s=range_s),
        }

    def slo_payload(self) -> Optional[dict]:
        """``GET /api/fleet/slo`` body (None → 503, no engine)."""
        if self.slo is None:
            return None
        return self.slo.evaluate()

    def start_timeseries(self) -> None:
        """Boot the on-disk time-series ring, the sampler (scraping this
        supervisor's own aggregated exposition) and the SLO engine."""
        from ..obs.slo import SLOEngine
        from ..obs.timeseries import TimeSeriesRing, TimeSeriesSampler

        ts_dir = str(envknobs.value("OPENSIM_TS_DIR") or "") or None
        self.timeseries = TimeSeriesRing(directory=ts_dir)
        self.slo = SLOEngine(self.timeseries)
        self._sampler = TimeSeriesSampler(self.timeseries, self.aggregate_metrics)
        self._sampler.start()

    def alive_workers(self) -> int:
        return sum(1 for w in self.workers if w.alive())

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for w in self.workers:
            if w.adopted:
                log.info(
                    "fleet worker %d adopted from previous owner (pid %d)",
                    w.index, w.pid,
                )
                continue
            self._spawn(w)
        loops = [
            (self._publish_loop, "simon-fleet-publish"),
            (self._monitor_loop, "simon-fleet-monitor"),
        ]
        if self.lease is not None:
            loops.append((self._lease_loop, "simon-fleet-lease"))
        for target, name in loops:
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self, drain_s: float = 30.0, keep_workers: bool = False) -> None:
        """SIGTERM drain order: workers first (each drains its admission
        queue and completes in-flight work), then the reflectors, then the
        journal flush, then the shared-memory unlink. ``keep_workers``
        (handover / fenced demotion) leaves them running — they belong to
        the new owner now."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if not keep_workers:
            for w in self.workers:
                if w.proc is not None and w.proc.poll() is None:
                    with contextlib.suppress(OSError):
                        w.proc.terminate()
                elif w.adopted and w.pid > 0 and _pid_alive(w.pid):
                    with contextlib.suppress(OSError):
                        os.kill(w.pid, signal.SIGTERM)
            deadline = time.monotonic() + drain_s
            for w in self.workers:
                if w.proc is not None:
                    with contextlib.suppress(subprocess.TimeoutExpired):
                        w.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
                    if w.proc.poll() is None:
                        log.warning("fleet worker %d did not drain; killing", w.index)
                        with contextlib.suppress(OSError):
                            w.proc.kill()
                            w.proc.wait(timeout=5.0)
                elif w.adopted and w.pid > 0:
                    attempt = 0
                    while _pid_alive(w.pid) and time.monotonic() < deadline:
                        time.sleep(backoff_delay(attempt, base_delay=0.05, max_delay=0.5))
                        attempt += 1
                    if _pid_alive(w.pid):
                        log.warning(
                            "adopted fleet worker %d did not drain; killing", w.index
                        )
                        with contextlib.suppress(OSError):
                            os.kill(w.pid, signal.SIGKILL)
        if self._sampler is not None:
            self._sampler.stop()
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.journal is not None:
            self.journal.close()
        if self.timeseries is not None:
            self.timeseries.close()
        self.publisher.close()
        self.collector.uninstall()


class _RoleBox:
    """Indirection for the admin endpoint across a promotion: the handler
    closes over the box, and serve_standby swaps ``current`` from the
    StandbyOwner to the promoted FleetSupervisor without rebinding the
    HTTP server. Both roles expose healthz()/metrics_text()/status()/
    handover()."""

    def __init__(self, current) -> None:
        self.current = current


def _make_admin_handler(box: _RoleBox):
    class AdminHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet, like the REST handler
            pass

        def _send(self, code: int, data: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path, _, query = self.path.partition("?")
            role = box.current
            if path == "/api/debug/timeseries":
                from ..obs.timeseries import parse_duration_s

                q = urllib.parse.parse_qs(query)
                try:
                    range_s = parse_duration_s((q.get("range") or [""])[0])
                except ValueError as e:
                    self._send(
                        400, json.dumps({"error": str(e)}).encode(),
                        "application/json",
                    )
                    return
                payload = getattr(role, "timeseries_payload", lambda **kw: None)(
                    family=(q.get("family") or [""])[0], range_s=range_s
                )
                if payload is None:  # standby / ring not running
                    self._send(
                        503, b'{"error": "time-series ring not running"}',
                        "application/json",
                    )
                    return
                self._send(200, json.dumps(payload).encode(), "application/json")
                return
            if path == "/api/fleet/slo":
                payload = getattr(role, "slo_payload", lambda: None)()
                if payload is None:
                    self._send(
                        503, b'{"error": "SLO engine not running"}',
                        "application/json",
                    )
                    return
                self._send(200, json.dumps(payload).encode(), "application/json")
                return
            if path == "/healthz":
                self._send(
                    200, json.dumps(role.healthz()).encode(), "application/json"
                )
            elif path == "/metrics":
                try:
                    text = role.metrics_text()
                except Exception as e:  # a worker roll mid-scrape
                    log.warning("fleet aggregation failed: %s: %s", type(e).__name__, e)
                    self._send(
                        500, json.dumps({"error": str(e)}).encode(), "application/json"
                    )
                    return
                self._send(200, text.encode(), "text/plain; version=0.0.4")
            elif path == "/api/fleet/status":
                self._send(200, json.dumps(role.status()).encode(), "application/json")
            else:
                self._send(404, b'{"error": "not found"}', "application/json")

        def do_POST(self):
            path = self.path.split("?", 1)[0]
            if path == "/api/fleet/handover":
                code, body = box.current.handover()
                self._send(code, json.dumps(body).encode(), "application/json")
            else:
                self._send(404, b'{"error": "not found"}', "application/json")

    return AdminHandler


def _build_variants(supervisor, device) -> None:
    """On the card, build the kernel variants the workers' requests launch
    on the twin's snapshot (``rest.serving_variants``) before any worker
    spawns: the workers then only load them from the owner's build
    directory (``utils/jitcache``, handed to each in its environment), and no
    request pays a build."""
    if device.type != "cuda":
        return
    from ..ops import fast_scan as fs
    from .rest import serving_variants

    got = supervisor.serving_snapshot() if supervisor.has_synced() else None
    variants = serving_variants(got[0] if got is not None else None)
    t0 = time.perf_counter()
    fs.build(variants)
    log.info("kernel variants %s loaded in %.3f s", ", ".join(variants), time.perf_counter() - t0)


def serve_fleet(kubeconfig: str, master: str, port: int, watch: str,
                journal: str, workers: int, device: "DeviceLike" = None) -> int:
    """``simon server --workers N``: the multi-process serving fleet.
    Called by ``rest.serve`` with already-validated paths. The owner
    process never serves simulate traffic — workers own the public port
    via SO_REUSEPORT; the owner serves the aggregated fleet endpoint on
    the admin port (default: public port + 1). The owner and its workers
    run on the card unless `device` names another; without a card the
    owner raises before it starts anything."""
    from .rest import build_twin

    device = resolve_device(device)
    if not kubeconfig or watch == "off":
        print(
            "simon server: --workers needs the live twin "
            "(--kubeconfig and --watch auto|on) — the twin owner is what "
            "the workers attach to", flush=True,
        )
        return 1
    lease: Optional[FleetLease] = None
    if ha_enabled():
        if not journal:
            print(
                "simon server: OPENSIM_HA=1 needs --journal — the standby "
                "tails it and the lease lives beside it",
                flush=True,
            )
            return 1
        # acquire BEFORE build_twin: opening the journal for append
        # truncates a torn tail, which must never race a live owner's
        # writer — the lease is what proves there isn't one
        lease = FleetLease(lease_path(journal))
        if lease.acquire({"control": "", "port": port, "n_workers": workers}) is None:
            print(
                "simon server: HA lease is held by a live owner — start "
                "this process with --standby to tail it instead", flush=True,
            )
            return 1
    try:
        supervisor, jrnl = build_twin(kubeconfig, master, watch, journal)
    except ValueError as e:
        print(f"simon server: {e}", flush=True)
        return 1
    if jrnl is not None:
        # attached BEFORE start(): the twin restores from the newest
        # checkpoint + suffix replay during startup, like the
        # single-process server (SimonServer wires this in its ctor)
        supervisor.attach_journal(jrnl)
    fleet = FleetSupervisor(supervisor, jrnl, port, workers, lease=lease, device=device)
    if watch == "on":
        if not supervisor.start(wait_s=60.0):
            print("simon server: --watch on but the twin could not sync", flush=True)
            supervisor.stop()
            fleet.publisher.close()
            return 1
    else:
        supervisor.start()
    _build_variants(supervisor, device)
    box = _RoleBox(fleet)
    httpd = ThreadingHTTPServer(("0.0.0.0", fleet.admin_port), _make_admin_handler(box))
    fleet._on_handover = lambda: threading.Thread(
        target=httpd.shutdown, daemon=True
    ).start()

    def _graceful(signum, frame):
        log.info(
            "fleet received %s; draining workers then owner",
            signal.Signals(signum).name,
        )
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _graceful)
        except ValueError:  # pragma: no cover - embedded use
            break
    fleet.start()
    fleet.start_timeseries()
    print(
        f"simon fleet listening on :{port} [{workers} workers, "
        f"admin :{fleet.admin_port}]"
        + (f" [journal {journal}]" if jrnl is not None else "")
        + (f" [HA epoch {lease.epoch}]" if lease is not None else ""),
        flush=True,
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        fleet.stop(keep_workers=fleet.handed_over)
        print(
            "simon fleet: handed over" if fleet.handed_over
            else "simon fleet: shutdown complete",
            flush=True,
        )
    return 0


# ---------------------------------------------------------------------------
# hot standby: tail the journal, take over on lease expiry or handover
# ---------------------------------------------------------------------------


class StandbyOwner:
    """``simon server --standby``: tails the live owner's journal onto a
    private twin (rv-monotonic apply, checkpoint rebases) and watches the
    HA lease. When the lease expires (owner died) or is released with the
    handover flag (rolling upgrade), it acquires the lease at epoch+1,
    builds a real watch supervisor, preloads it with the tailed state
    (resume rvs and all — zero relists), adopts the surviving workers
    recorded in the lease doc, and starts publishing at a continuous
    generation. Exposes the same admin surface as the owner on
    ``port + 16`` (clear of the owner's admin at port+1 and the workers'
    loopback ports above it)."""

    def __init__(self, kubeconfig: str, master: str, port: int, watch: str,
                 journal_dir: str, workers: int,
                 auto_handover: bool = False, device: "DeviceLike" = None) -> None:
        from .journal import JournalTailer, RecoveredState
        from .watch import ClusterTwin

        # the device the promoted owner prepares on (see FleetSupervisor)
        self.device = resolve_device(device)
        self.kubeconfig = kubeconfig
        self.master = master
        self.port = port
        self.watch = watch
        self.journal_dir = journal_dir
        self.n_workers = workers
        self.admin_port = port + 16
        self.lease = FleetLease(lease_path(journal_dir))
        self.tailer = JournalTailer(journal_dir)
        self.twin = ClusterTwin()
        self.state = RecoveredState()
        self.records_applied = 0
        self.seen_checkpoint = False
        self.seen_owner = False
        self.auto_handover = auto_handover
        self._handover_requested_at = 0.0
        self.fleet: Optional[FleetSupervisor] = None

    # -- tailing -------------------------------------------------------------

    def _drain(self) -> int:
        from .journal import apply_record

        recs = self.tailer.poll()
        for rec in recs:
            apply_record(self.twin, rec, self.state)
            if rec.get("t") == "ck":
                self.seen_checkpoint = True
        self.records_applied += len(recs)
        return len(recs)

    def at_parity(self) -> bool:
        """Caught up enough to take over without a relist: at least one
        checkpoint absorbed (the re-anchor that heals any tail gap) and
        the last poll drained to the journal's end."""
        return self.seen_checkpoint and self.tailer.last_lag_records == 0

    # -- the standby loop ----------------------------------------------------

    def run(self, stop: threading.Event) -> None:
        """Tail until promoted or told to stop. Returns with ``self.fleet``
        set when this process became the owner."""
        poll_s = ha_tail_poll_s()
        while not stop.is_set():
            self._drain()
            doc = self.lease.read()
            if doc is not None:
                self.seen_owner = True
            if self.seen_owner and self.lease.claimable(doc):
                reason = (
                    "handover"
                    if doc is not None and doc.get("handover")
                    else "expired"
                )
                if self._takeover(doc, reason):
                    return
                # lost the acquire race (another standby won): keep tailing
            elif (
                self.auto_handover
                and doc is not None
                and not doc.get("released")
                and self.at_parity()
            ):
                self._maybe_request_handover(doc)
            stop.wait(poll_s)

    def _maybe_request_handover(self, doc: dict) -> None:
        now = time.monotonic()
        if (
            self._handover_requested_at
            and now - self._handover_requested_at < ha_handover_timeout_s()
        ):
            return  # request outstanding; lease-expiry watching is the fallback
        self._handover_requested_at = now
        admin = int(doc.get("admin_port") or 0)
        if not admin:
            return

        def _post():
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{admin}/api/fleet/handover",
                    data=b"", method="POST",
                )
                with urllib.request.urlopen(req, timeout=5.0) as resp:
                    resp.read()
                log.info("standby: requested handover from owner admin :%d", admin)
            except OSError as e:
                log.warning("standby: handover request failed (%s); will retry", e)
                self._handover_requested_at = 0.0

        threading.Thread(
            target=_post, name="simon-standby-handover", daemon=True
        ).start()

    # -- promotion -----------------------------------------------------------

    def _takeover(self, doc: Optional[dict], reason: str) -> bool:
        from .rest import build_twin

        doc = doc or {}
        port = int(doc.get("port") or self.port)
        n = int(doc.get("n_workers") or 0) or self.n_workers
        if self.lease.acquire(
            {"control": "", "port": port, "n_workers": n}
        ) is None:
            log.info("standby: lost the takeover race; remaining standby")
            return False
        log.warning(
            "standby: taking over as owner (reason=%s, epoch %d, "
            "%d tailed records, generation %d)",
            reason, self.lease.epoch, self.records_applied, self.twin.generation,
        )
        # one final drain: whatever the old owner flushed before it went.
        # Opening the journal for APPEND (inside build_twin) truncates any
        # torn tail, so this read must come first — and only runs now that
        # the lease proves no live writer remains.
        self._drain()
        try:
            supervisor, jrnl = build_twin(
                self.kubeconfig, self.master, self.watch, self.journal_dir
            )
        except ValueError as e:
            print(f"simon server[standby]: {e}", flush=True)
            with contextlib.suppress(OSError):
                self.lease.release()
            return False
        stores, gen = self.twin.snapshot_raw()
        self.state.stores = stores
        self.state.generation = max(self.state.generation, gen)
        supervisor.preload_state(self.state)
        if jrnl is not None:
            supervisor.attach_journal(jrnl)
        fleet = FleetSupervisor(
            supervisor, jrnl, port, n, admin_port=self.admin_port,
            lease=self.lease, adopt=list(doc.get("workers") or []),
            takeover_reason=reason, device=self.device,
        )
        if self.watch == "on":
            if not supervisor.start(wait_s=60.0):
                log.warning("standby: twin did not sync after takeover")
        else:
            supervisor.start()
        # the variants are on disk from the deposed owner's build: loaded,
        # not built, for a worker this owner respawns
        _build_variants(supervisor, self.device)
        fleet.start()
        # a fresh ring (or, with OPENSIM_TS_DIR set, the previous owner's
        # re-adopted one) — takeover markers keep accumulating
        fleet.start_timeseries()
        self.fleet = fleet
        return True

    # -- admin surface (same shape as the owner's) ---------------------------

    def healthz(self) -> dict:
        return {
            "status": "ok" if self.at_parity() else "syncing",
            "role": "standby",
            "generation": self.twin.generation,
            "tail_lag_records": self.tailer.last_lag_records,
        }

    def status(self) -> dict:
        seq, offset = self.tailer.position()
        return {
            "role": "standby",
            "fingerprint": self.twin.fingerprint(),
            "generation": self.twin.generation,
            "records_applied": self.records_applied,
            "at_parity": self.at_parity(),
            "tail": {
                "segment": seq,
                "offset": offset,
                "gaps_total": self.tailer.gaps_total,
                "lag_records": self.tailer.last_lag_records,
            },
            "lease": self.lease.read(),
            "admin_port": self.admin_port,
        }

    def metrics_text(self) -> str:
        lines: List[str] = []
        lines += family_header("simon_fleet_standby_tail_lag_records")
        lines.append(
            f"simon_fleet_standby_tail_lag_records {self.tailer.last_lag_records}"
        )
        age = FleetLease.age_s(self.lease.read())
        if age != float("inf"):
            lines += family_header("simon_fleet_lease_age_seconds")
            lines.append(f"simon_fleet_lease_age_seconds {age:.3f}")
        lines += family_header("simon_fleet_takeovers_total")
        return "\n".join(lines) + "\n"

    def handover(self) -> Tuple[int, dict]:
        return 409, {
            "error": "standby does not hold the lease; POST to the owner's "
            "admin port"
        }


def serve_standby(kubeconfig: str, master: str, port: int, watch: str,
                  journal: str, workers: int, handover: bool = False,
                  device: "DeviceLike" = None) -> int:
    """``simon server --standby``: run the hot standby until it is
    promoted (then keep serving as the fleet owner) or stopped. With
    ``handover=True`` it asks the live owner to drain once the tail
    reaches parity — the zero-downtime rolling-upgrade path."""
    if not journal:
        print(
            "simon server: --standby needs --journal — the standby tails "
            "the owner's journal", flush=True,
        )
        return 1
    if not kubeconfig or watch == "off":
        print(
            "simon server: --standby needs the live twin (--kubeconfig "
            "and --watch auto|on) to serve after takeover", flush=True,
        )
        return 1
    standby = StandbyOwner(
        kubeconfig, master, port, watch, journal, workers,
        auto_handover=handover, device=device,
    )
    box = _RoleBox(standby)
    httpd = ThreadingHTTPServer(
        ("0.0.0.0", standby.admin_port), _make_admin_handler(box)
    )
    threading.Thread(
        target=httpd.serve_forever, name="simon-standby-admin", daemon=True
    ).start()
    stop = threading.Event()

    def _graceful(signum, frame):
        log.info("standby received %s; stopping", signal.Signals(signum).name)
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _graceful)
        except ValueError:  # pragma: no cover - embedded use
            break
    print(
        f"simon standby tailing {journal} [admin :{standby.admin_port}]"
        + (" [auto-handover]" if handover else ""),
        flush=True,
    )
    try:
        standby.run(stop)
    except KeyboardInterrupt:  # pragma: no cover
        stop.set()
    fleet = standby.fleet
    if fleet is None:
        httpd.shutdown()
        print("simon standby: shutdown complete", flush=True)
        return 0
    box.current = fleet
    fleet._on_handover = stop.set
    print(
        f"simon fleet listening on :{fleet.port} [{fleet.n_workers} workers, "
        f"admin :{standby.admin_port}] [HA epoch {standby.lease.epoch}] "
        f"(took over: {fleet.takeover_reason})",
        flush=True,
    )
    try:
        while not stop.is_set():
            stop.wait(0.5)
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        httpd.shutdown()
        fleet.stop(keep_workers=fleet.handed_over)
        print(
            "simon fleet: handed over" if fleet.handed_over
            else "simon fleet: shutdown complete",
            flush=True,
        )
    return 0
