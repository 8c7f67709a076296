"""Crash-safe watch-event journal of the live twin — the port of
``opensim_tpu/server/journal.py``, its on-disk format byte for byte, so a
journal recorded by either package replays in the other.

The live twin (``server/watch.py``) and the capacity history
(``obs/capacity.py``, ``obs/timeline.py``) are event-sourced but volatile:
a crash loses the accepted event stream and the timeline, and the only
recovery is a cold full relist. The journal makes the twin durable:

- **append-only segments** in one directory (``journal-<seq>.seg``), each
  record framed as ``length || crc32 || payload`` so a torn tail — the
  shape of a crash mid-write — is detected by the frame, truncated at the
  first bad byte and reported instead of poisoning recovery;
- **record types**: ``ev`` (one ACCEPTED twin event — what
  ``ClusterTwin.apply_event`` took), ``rb`` (a list-shaped rebase: a 410
  recovery or an anti-entropy repair) and ``ck`` (a checkpoint: the full
  twin, per-field resume rvs, the capacity timeline and the generation);
- **off-dispatch writer**: ``record_*()`` is a bounded-queue enqueue — O(1),
  no I/O — and one writer thread drains it (framing, fsync policy,
  rotation, checkpoints). A full queue DROPS the record (counted, logged)
  and flags the journal for re-anchoring: the next checkpoint is by
  construction a complete history prefix again;
- **checkpoints and pruning**: every ``OPENSIM_JOURNAL_CHECKPOINT_EVERY``
  event records (and at every size-triggered rotation) the writer pulls a
  consistent twin snapshot through ``checkpoint_source`` (object
  references captured under the twin lock, serialized outside it),
  rotates to a fresh segment and writes the checkpoint as its first
  record, so pruning deletes the segments older than the
  ``OPENSIM_JOURNAL_KEEP``-th newest checkpoint segment;
- **fsync policy** (``OPENSIM_JOURNAL_FSYNC``): ``always``, ``interval``
  (the default; at most every ``OPENSIM_JOURNAL_FSYNC_S``) or ``off``.

Recovery (:meth:`Journal.recover`) finds the newest valid checkpoint,
replays the records after it and returns the state, resume rvs included, so
the reflectors continue where the stream was. Replay is rv-monotonic: a
record that raced the checkpoint re-applies as a no-op.

Replay (:func:`iter_records`, :func:`rebuild_twin`, :func:`replay_events`)
drives ``simon replay <journal>`` and the campaign's ``from-journal`` step:
the twin at any recorded generation, or the event history streamed at N×
speed into the capacity observatory and the scheduler. The HA standby
follows a live journal with :class:`JournalTailer` and applies each record
with :func:`apply_record` (a checkpoint rebases its twin wholesale).

Fault points (``OPENSIM_FAULTS``): ``journal.write`` and ``journal.fsync``
fire in the writer thread (the journal degrades loudly, the serving path
never notices); ``journal.corrupt`` fires at recovery (a corrupt journal
degrades to a full relist with a typed warning, never a crash);
``journal.tail_gap`` drops a batch the tailer drained. Every
record write goes through the one framing helper
(:meth:`Journal._write_framed`).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ..obs.fleetobs import FRESHNESS
from ..obs.metrics import RECORDER, CounterVec, HistogramVec, family_header
from ..resilience import faults
from ..utils import envknobs

log = logging.getLogger("opensim_tpu_torch.server.journal")

__all__ = [
    "Journal",
    "JournalError",
    "JournalTailer",
    "RecoveredState",
    "apply_record",
    "iter_records",
    "journal_policy",
    "rebuild_twin",
    "replay_events",
]

#: segment header: identifies the file format and versions the framing
SEGMENT_MAGIC = b"OSJRNL01"

#: frame header: 4-byte LE payload length + 4-byte LE crc32 of the payload
_FRAME = 8
_LEN_MAX = 1 << 31  # an absurd length in a frame header = corruption


class JournalError(RuntimeError):
    """Typed journal failure: an unusable journal directory at startup, or
    a ``rebuild_twin`` target generation the retained history no longer
    reaches (checkpoint pruning). Recovery paths never raise this to the
    serving path — they degrade to a relist."""


def journal_policy() -> dict:
    """Env-tunable journal knobs, validated loudly like ``watch_policy``
    (an operator typo must surface at startup, not at the first crash):

    - ``OPENSIM_JOURNAL_FSYNC`` (``always|interval|off``, default
      ``interval``): when the writer fsyncs the segment;
    - ``OPENSIM_JOURNAL_FSYNC_S`` (default 1.0): the ``interval`` cadence;
    - ``OPENSIM_JOURNAL_SEGMENT_MB`` (default 64): rotation size bound;
    - ``OPENSIM_JOURNAL_CHECKPOINT_EVERY`` (default 4096): event records
      between checkpoints;
    - ``OPENSIM_JOURNAL_KEEP`` (default 2): checkpoint segments retained by
      pruning (history older than the KEEP-th newest checkpoint is
      unreplayable anyway once its segment is gone);
    - ``OPENSIM_JOURNAL_QUEUE`` (default 65536): writer queue bound — past
      it records are dropped (counted) and the next checkpoint re-anchors.
    """
    fsync = envknobs.raw("OPENSIM_JOURNAL_FSYNC", "interval").strip().lower()
    if fsync not in ("always", "interval", "off"):
        raise ValueError(
            "OPENSIM_JOURNAL_FSYNC must be always|interval|off, got "
            f"{fsync!r}"
        )
    out: dict = {"fsync": fsync}
    for key, env, default, cast in (
        ("fsync_s", "OPENSIM_JOURNAL_FSYNC_S", 1.0, float),
        ("segment_mb", "OPENSIM_JOURNAL_SEGMENT_MB", 64.0, float),
        ("checkpoint_every", "OPENSIM_JOURNAL_CHECKPOINT_EVERY", 4096, int),
        ("keep", "OPENSIM_JOURNAL_KEEP", 2, int),
        ("queue", "OPENSIM_JOURNAL_QUEUE", 65536, int),
    ):
        raw = envknobs.raw(env, str(default))
        try:
            out[key] = cast(raw)
        except ValueError:
            raise ValueError(
                f"{env} must be {'an integer' if cast is int else 'a number'}"
            ) from None
    if out["fsync_s"] <= 0:
        raise ValueError("OPENSIM_JOURNAL_FSYNC_S must be positive")
    if out["segment_mb"] <= 0:
        raise ValueError("OPENSIM_JOURNAL_SEGMENT_MB must be positive")
    if out["checkpoint_every"] < 1:
        raise ValueError("OPENSIM_JOURNAL_CHECKPOINT_EVERY must be >= 1")
    if out["keep"] < 1:
        raise ValueError("OPENSIM_JOURNAL_KEEP must be >= 1")
    if out["queue"] < 1:
        raise ValueError("OPENSIM_JOURNAL_QUEUE must be >= 1")
    return out


def _segment_name(seq: int) -> str:
    return f"journal-{seq:08d}.seg"


def _segment_seq(name: str) -> Optional[int]:
    if not (name.startswith("journal-") and name.endswith(".seg")):
        return None
    try:
        return int(name[len("journal-") : -len(".seg")])
    except ValueError:
        return None


def _encode(record: dict) -> bytes:
    return json.dumps(record, separators=(",", ":"), sort_keys=True).encode()


class RecoveredState:
    """What :meth:`Journal.recover` hands the watch supervisor: enough to
    rebuild the twin and resume the reflectors without a relist."""

    def __init__(self) -> None:
        self.generation: int = 0
        #: {resource field: [raw wire dicts]} — the twin's stores
        self.stores: Dict[str, List[dict]] = {}
        #: {resource field: stream resume rv (string)}
        self.resume_rvs: Dict[str, str] = {}
        #: capacity timeline samples (obs/timeline.Sample dicts, oldest first)
        self.timeline: List[dict] = []
        self.checkpoint_generation: int = 0
        self.records_replayed: int = 0
        self.truncated_bytes: int = 0
        self.outcome: str = "restored"  # restored | empty | corrupt


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


class Journal:
    """One journal directory: segments, the bounded writer, checkpoints.

    ``readonly=True`` opens for :func:`iter_records`-style access only (the
    replay CLI, crash-recovery checks from another process) — no writer
    thread, no truncation, no side effects on the files.
    """

    def __init__(
        self,
        path: str,
        policy: Optional[dict] = None,
        readonly: bool = False,
    ) -> None:
        self.path = os.path.abspath(path)
        self.policy = dict(journal_policy(), **(policy or {}))
        self.readonly = readonly
        # telemetry: families registered in obs/metrics.py, every mutation
        # under the one recorder lock
        self.records_total = CounterVec("simon_journal_records_total", ("type",))
        self.dropped_total = 0  # guarded-by: RECORDER.lock
        self.bytes_total = 0  # guarded-by: RECORDER.lock
        self.fsync_seconds = HistogramVec("simon_journal_fsync_seconds", ())
        self.recoveries = CounterVec("simon_journal_recoveries_total", ("outcome",))
        #: set by the supervisor: () -> (stores_by_field objrefs, generation,
        #: timeline sample dicts). Called ONLY from the writer thread; the
        #: provider captures references under the twin lock and this module
        #: serializes them outside it.
        self.checkpoint_source: Optional[Callable[[], tuple]] = None
        self._cond = threading.Condition()
        self._queue: "deque[dict]" = deque()  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None  # guarded-by: _cond
        self._flush_waiters = 0  # guarded-by: _cond
        self._degraded = False  # writer thread only
        self._need_reanchor = False  # guarded-by: _cond
        self._f = None  # writer/recovery thread only
        self._seg_seq = 0
        self._seg_bytes = 0
        self._events_since_ck = 0
        self._last_fsync = 0.0
        self._dirty = False
        #: per-field stream cursor the next checkpoint records (journal-side
        #: bookkeeping so checkpoints need nothing from the reflectors)
        self._last_rvs: Dict[str, str] = {}  # guarded-by: _cond
        if not readonly:
            try:
                os.makedirs(self.path, exist_ok=True)
                self._open_for_append()
            except OSError as e:
                # an unusable directory is an operator mistake that must
                # surface at startup, typed — not as a raw OSError mid-boot
                raise JournalError(
                    f"journal directory {self.path} is not usable: {e}"
                ) from e

    # -- segment bookkeeping (writer side) -----------------------------------

    def _segments(self) -> List[str]:
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        out = [(s, n) for n in names if (s := _segment_seq(n)) is not None]
        return [n for _s, n in sorted(out)]

    def _open_for_append(self) -> None:
        """Validate the newest segment's tail (truncating a torn frame,
        loudly) and position the writer after the last good record."""
        segs = self._segments()
        if not segs:
            self._start_segment(1)
            return
        last = segs[-1]
        path = os.path.join(self.path, last)
        good = self._scan_segment(path, collect=None)
        size = os.path.getsize(path)
        if good < size:
            log.warning(
                "journal %s: torn tail — truncating %d byte(s) after the "
                "last valid frame (crash mid-write is the expected cause)",
                last, size - good,
            )
            with open(path, "r+b") as f:
                f.truncate(good)
        self._seg_seq = _segment_seq(last) or 1
        self._f = open(path, "ab")
        if self._f.tell() == 0:
            # the whole file (magic included) was torn away: re-stamp it
            self._f.write(SEGMENT_MAGIC)
            self._f.flush()
        self._seg_bytes = self._f.tell()
        # a fresh process re-anchors with a checkpoint soon regardless of
        # the event cadence: recovery from this journal must not have to
        # replay an unbounded pre-crash suffix again next time
        self._events_since_ck = self.policy["checkpoint_every"]

    def _start_segment(self, seq: int) -> None:
        if self._f is not None:
            self._f.close()
        self._seg_seq = seq
        path = os.path.join(self.path, _segment_name(seq))
        self._f = open(path, "ab")
        if self._f.tell() == 0:
            # flush immediately: the file on disk must never be observable
            # magic-less (recovery scans the physical bytes, not this buffer)
            self._f.write(SEGMENT_MAGIC)
            self._f.flush()
        self._seg_bytes = self._f.tell()

    def _scan_segment(self, path: str, collect: Optional[list]) -> int:
        """Walk one segment's frames; append decoded records to ``collect``
        (when given) and return the byte offset after the last VALID frame.
        Every corruption mode — bad magic, short header, absurd length,
        crc mismatch, broken JSON — stops the walk at the last good byte."""
        try:
            with open(path, "rb") as f:
                magic = f.read(len(SEGMENT_MAGIC))
                if magic != SEGMENT_MAGIC:
                    if magic:  # an EMPTY file is merely unwritten, not corrupt
                        log.warning("journal segment %s: bad magic; ignoring file", path)
                    return 0
                good = f.tell()
                while True:
                    hdr = f.read(_FRAME)
                    if len(hdr) < _FRAME:
                        return good
                    length = int.from_bytes(hdr[:4], "little")
                    crc = int.from_bytes(hdr[4:8], "little")
                    if length <= 0 or length >= _LEN_MAX:
                        return good
                    payload = f.read(length)
                    if len(payload) < length or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                        return good
                    if collect is not None:
                        try:
                            collect.append(json.loads(payload))
                        except ValueError:
                            return good
                    good = f.tell()
        except OSError as e:
            log.warning("journal segment %s unreadable: %s", path, e)
            return 0

    # -- append side (any thread; O(1), no I/O) ------------------------------

    def _enqueue(self, record: dict) -> None:
        with self._cond:
            if self._closed:
                return
            if len(self._queue) >= self.policy["queue"]:
                # shedding is the honest failure: blocking here would convoy
                # reflector dispatch behind disk I/O. The drop is counted
                # and the next checkpoint re-anchors the history.
                self._need_reanchor = True
                with RECORDER.lock:
                    self.dropped_total += 1
                    dropped = self.dropped_total
                if dropped == 1 or dropped % 1000 == 0:
                    log.warning(
                        "journal writer queue full (%d dropped so far); "
                        "history re-anchors at the next checkpoint",
                        dropped,
                    )
                return
            self._queue.append(record)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="simon-journal", daemon=True
                )
                self._thread.start()
            self._cond.notify()

    def record_event(self, field: str, ev_type: str, obj: dict, generation: int,
                     eid: str = "", ts: Optional[float] = None) -> None:
        """One ACCEPTED twin event (``apply_event`` returned a change).
        ``eid``/``ts`` are the acceptance stamp: the id rides the record so
        replay can correlate journal lines with the event."""
        rv = str(((obj.get("metadata") or {}).get("resourceVersion")) or "")
        rec = {"t": "ev", "ts": ts if ts is not None else time.time(),
               "gen": generation, "f": field, "k": ev_type, "o": obj}
        if eid:
            rec["eid"] = eid
        with self._cond:
            if rv:
                self._last_rvs[field] = rv
        self._enqueue(rec)

    def record_rebase(
        self, field: str, items: List[dict], generation: int,
        rv: str = "", why: str = "",
    ) -> None:
        """A list-shaped store replacement (410 relist, anti-entropy drift
        repair): replay applies it as ``ClusterTwin.rebase``."""
        rec = {"t": "rb", "ts": time.time(), "gen": generation, "f": field,
               "rv": rv, "why": why, "items": items}
        with self._cond:
            if rv:
                self._last_rvs[field] = rv
        self._enqueue(rec)

    def record_checkpoint(
        self,
        stores: Dict[str, List[dict]],
        generation: int,
        resume_rvs: Optional[Dict[str, str]] = None,
        timeline: Optional[List[dict]] = None,
        why: str = "",
    ) -> None:
        """An explicit checkpoint (bootstrap, post-recovery re-anchor). The
        periodic cadence checkpoints come from the writer thread via
        ``checkpoint_source`` instead."""
        rvs = dict(resume_rvs or {})
        with self._cond:
            # the per-event stream cursor wins over the caller's (listing /
            # restore-time) rvs: it only ever moves forward, and resuming a
            # touch early merely re-delivers events the rv-monotonic apply
            # no-ops. The merge then SEEDS the cursor map, so later cadence
            # checkpoints keep resume rvs for resources with no events
            self._last_rvs.update(
                {f: rv for f, rv in rvs.items() if f not in self._last_rvs}
            )
            rvs.update(self._last_rvs)
        rec = {"t": "ck", "ts": time.time(), "gen": generation, "why": why,
               "rvs": rvs, "timeline": list(timeline or []), "stores": stores}
        self._enqueue(rec)

    def flush(self, timeout: float = 30.0) -> bool:
        """Drain the queue and fsync — the graceful-shutdown barrier.
        Returns False when the writer could not finish in time. The waiter
        stays registered until the segment is SYNCED, not merely drained:
        the writer's wake predicate forces an fsync for a registered
        waiter regardless of the fsync policy (mode ``off`` would
        otherwise park forever with dirty bytes)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._flush_waiters += 1
            self._cond.notify_all()
            try:
                while (self._queue or self._dirty) and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._cond.wait(min(0.1, remaining))
            finally:
                self._flush_waiters -= 1
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Flush, fsync, stop the writer. Idempotent."""
        if self.readonly:
            return
        self.flush(timeout=timeout)
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
        if self._f is not None:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    # -- writer thread -------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while (
                    not self._queue
                    and not self._closed
                    # a flush() waiter with unsynced bytes must wake the
                    # writer regardless of fsync policy (mode "off" would
                    # otherwise park here forever and hang close())
                    and not (self._dirty and self._flush_waiters)
                ):
                    if self._dirty and self.policy["fsync"] == "interval":
                        # idle with unsynced bytes: wait at most the fsync
                        # cadence, then sync below
                        self._cond.wait(self.policy["fsync_s"])
                        break
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                batch = []
                while self._queue:
                    batch.append(self._queue.popleft())
                reanchor = self._need_reanchor
                self._need_reanchor = False
                flushing = self._flush_waiters > 0
            for rec in batch:
                try:
                    self._write_record(rec)
                    self._degraded = False
                except Exception as e:
                    # a lost record makes the suffix unfaithful: count it as
                    # a drop and flag re-anchoring — the next checkpoint is
                    # by construction a complete history prefix again
                    with self._cond:
                        self._need_reanchor = True
                    with RECORDER.lock:
                        self.dropped_total += 1
                    if not self._degraded:
                        self._degraded = True
                        log.warning(
                            "journal writer degraded (%s: %s): record "
                            "dropped; the twin keeps serving and history "
                            "re-anchors at the next checkpoint — recovery "
                            "falls back to a relist past this point",
                            type(e).__name__, e,
                        )
            try:
                if (
                    self.checkpoint_source is not None
                    and not self._degraded
                    and (
                        reanchor
                        or self._events_since_ck >= self.policy["checkpoint_every"]
                        or self._seg_bytes >= self.policy["segment_mb"] * 1024 * 1024
                    )
                ):
                    self._write_checkpoint()
                self._maybe_fsync(force=flushing or self.policy["fsync"] == "always")
            except Exception as e:
                if not self._degraded:
                    self._degraded = True
                    log.warning(
                        "journal writer degraded (%s: %s): checkpoint/fsync "
                        "failed; durability is behind until the next "
                        "successful sync", type(e).__name__, e,
                    )
            with self._cond:
                if not self._queue:
                    self._cond.notify_all()

    def _write_record(self, rec: dict) -> None:
        faults.fault_point("journal.write")
        payload = _encode(rec)
        self._write_framed(payload)
        self._dirty = True
        with RECORDER.lock:
            self.records_total.inc((rec["t"],))
            self.bytes_total += len(payload) + _FRAME
            if rec["t"] == "ev" and rec.get("eid"):
                # journaled stage of the freshness pipeline: the stamped
                # acceptance time is in the record itself (RECORDER.lock
                # is an RLock; FRESHNESS shares it)
                FRESHNESS.event_journaled(float(rec["ts"]))
        if rec["t"] == "ev":
            self._events_since_ck += 1
        elif rec["t"] == "ck":
            # ANY checkpoint (explicit bootstrap/recovered re-anchor or the
            # writer's own cadence) restarts the cadence clock — without
            # this, a restart's explicit checkpoint is immediately followed
            # by a duplicate O(cluster) cadence one
            self._events_since_ck = 0

    def _write_framed(self, payload: bytes) -> None:
        """THE one framing path: length + crc32 + payload. Nothing else in
        the package writes journal bytes."""
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._f.write(
            len(payload).to_bytes(4, "little") + crc.to_bytes(4, "little") + payload
        )
        self._seg_bytes += len(payload) + _FRAME

    def _maybe_fsync(self, force: bool = False) -> None:
        mode = self.policy["fsync"]
        if not self._dirty or self._f is None:
            return
        now = time.monotonic()
        if not force and (
            mode == "off"
            or (mode == "interval" and now - self._last_fsync < self.policy["fsync_s"])
        ):
            self._f.flush()
            return
        t0 = time.monotonic()
        faults.fault_point("journal.fsync")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._last_fsync = now
        self._dirty = False
        with RECORDER.lock:
            self.fsync_seconds.observe(time.monotonic() - t0, ())

    def _write_checkpoint(self) -> None:
        """Cadence checkpoint from the writer thread: pull a consistent
        snapshot, rotate, write it as the new segment's first record, prune.
        Raw dicts are serialized HERE — outside every supervisor lock."""
        got = self.checkpoint_source()
        if got is None:
            return
        stores_objs, generation, timeline = got
        stores = {
            field: [getattr(o, "raw", None) or {} for o in objs]
            for field, objs in stores_objs.items()
        }
        with self._cond:
            rvs = dict(self._last_rvs)
        rec = {"t": "ck", "ts": time.time(), "gen": generation, "why": "cadence",
               "rvs": rvs, "timeline": list(timeline or []), "stores": stores}
        self._rotate_and_checkpoint(rec)

    def _rotate_and_checkpoint(self, rec: dict) -> None:
        self._maybe_fsync(force=self.policy["fsync"] != "off")
        self._start_segment(self._seg_seq + 1)
        self._write_record(rec)
        self._events_since_ck = 0
        self._maybe_fsync(force=self.policy["fsync"] != "off")
        self._prune()

    def _prune(self) -> None:
        """Delete segments older than the KEEP-th newest checkpoint segment.
        Every segment after the first starts with a checkpoint (rotation
        happens exactly at checkpoint time), so 'the newest K checkpoint
        segments and everything after the oldest of them' is a complete,
        self-contained history."""
        segs = self._segments()
        ck_segs = []
        for name in segs:
            first = self._first_record_type(os.path.join(self.path, name))
            if first == "ck":
                ck_segs.append(name)
        if len(ck_segs) <= self.policy["keep"]:
            return
        floor = ck_segs[-self.policy["keep"]]
        floor_seq = _segment_seq(floor) or 0
        for name in segs:
            seq = _segment_seq(name) or 0
            if seq < floor_seq:
                try:
                    os.unlink(os.path.join(self.path, name))
                    log.info("journal: pruned segment %s (checkpointed past it)", name)
                except OSError as e:
                    log.warning("journal: failed to prune %s: %s", name, e)

    def _first_record_type(self, path: str) -> str:
        try:
            with open(path, "rb") as f:
                if f.read(len(SEGMENT_MAGIC)) != SEGMENT_MAGIC:
                    return ""
                hdr = f.read(_FRAME)
                if len(hdr) < _FRAME:
                    return ""
                length = int.from_bytes(hdr[:4], "little")
                crc = int.from_bytes(hdr[4:8], "little")
                if length <= 0 or length >= _LEN_MAX:
                    return ""
                payload = f.read(length)
                if len(payload) < length or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    return ""
                return str(json.loads(payload).get("t") or "")
        except (OSError, ValueError):
            return ""

    # -- read side -----------------------------------------------------------

    def iter_records(self) -> Iterator[dict]:
        """All valid records across all segments, in order. The walk stops
        at the first bad frame (torn tail / corruption): records past a
        corrupt point are unreachable history and are never yielded."""
        for name in self._segments():
            path = os.path.join(self.path, name)
            collected: List[dict] = []
            good = self._scan_segment(path, collect=collected)
            for rec in collected:
                yield rec
            try:
                if good < os.path.getsize(path):
                    # corruption mid-stream: everything after is suspect
                    log.warning(
                        "journal %s: stopping replay at a bad frame "
                        "(%d valid byte(s))", name, good,
                    )
                    return
            except OSError:
                return

    def recover(self) -> Optional[RecoveredState]:
        """Reconstruct the newest twin state: the newest valid checkpoint
        plus every record after it. Returns None when the journal holds no
        usable state (empty, or corrupt before the first checkpoint) — the
        caller falls back to a cold relist. NEVER raises for data-shaped
        problems; corruption degrades, loudly."""
        try:
            faults.fault_point("journal.corrupt")
            state = self._recover_inner()
        except Exception as e:
            log.warning(
                "journal recovery failed (%s: %s); degrading to a full "
                "relist — the journal stays in place for post-mortem",
                type(e).__name__, e,
            )
            with RECORDER.lock:
                self.recoveries.inc(("corrupt",))
            return None
        with RECORDER.lock:
            self.recoveries.inc((state.outcome if state else "empty",))
        return state

    def _recover_inner(self) -> Optional[RecoveredState]:
        ck: Optional[dict] = None
        suffix: List[dict] = []
        n = 0
        for rec in self.iter_records():
            n += 1
            if rec.get("t") == "ck":
                ck = rec
                suffix = []
            else:
                suffix.append(rec)
        if ck is None and not suffix:
            return None
        state = RecoveredState()
        if ck is None:
            # events with no checkpoint: the history has no complete prefix
            # (the bootstrap checkpoint was lost) — a relist is the only
            # faithful recovery
            log.warning(
                "journal holds %d record(s) but no checkpoint; a full "
                "relist is the only faithful recovery", n,
            )
            return None
        state.checkpoint_generation = int(ck.get("gen") or 0)
        state.generation = state.checkpoint_generation
        state.stores = {f: list(items) for f, items in (ck.get("stores") or {}).items()}
        state.resume_rvs = {str(k): str(v) for k, v in (ck.get("rvs") or {}).items()}
        state.timeline = list(ck.get("timeline") or [])
        if suffix:
            # replay the suffix through a real twin: rv-monotonic apply
            # makes records that raced the checkpoint no-ops
            twin = _new_twin()
            for field, items in state.stores.items():
                twin.rebase(field, items)
            for rec in suffix:
                _apply_record(twin, rec, state)
            state.generation = max(state.generation, twin.generation)
            state.stores = _twin_stores_raw(twin)
            state.records_replayed = len(suffix)
        return state

    # -- /metrics ------------------------------------------------------------

    def metrics_lines(self) -> List[str]:
        with RECORDER.lock:
            lines = self.records_total.render_lines()
            if not lines:
                lines = family_header("simon_journal_records_total")
            lines += [
                *family_header("simon_journal_bytes_total"),
                f"simon_journal_bytes_total {self.bytes_total}",
                *family_header("simon_journal_dropped_total"),
                f"simon_journal_dropped_total {self.dropped_total}",
            ]
            lines += self.fsync_seconds.render_lines()
            rec = self.recoveries.render_lines()
            if not rec:
                rec = family_header("simon_journal_recoveries_total")
            lines += rec
        return lines


# ---------------------------------------------------------------------------
# replay helpers (the CLI, the campaign's from-journal step, recovery)
# ---------------------------------------------------------------------------


def _new_twin():
    # local import: watch.py imports this module at top level
    from .watch import ClusterTwin

    return ClusterTwin()


def _twin_stores_raw(twin) -> Dict[str, List[dict]]:
    return twin.snapshot_raw()[0]


def _apply_record(twin, rec: dict, state: Optional[RecoveredState] = None):
    """Apply one record to a replay twin; returns the ``apply_event``
    change verdict for ``ev`` records (None otherwise) so replay consumers
    (the capacity feed) can ride the same O(1) delta path the live
    dispatch does."""
    t = rec.get("t")
    change = None
    if t == "ev":
        change = twin.apply_event(
            str(rec.get("f") or ""), str(rec.get("k") or ""), rec.get("o") or {}
        )
        rv = str(((rec.get("o") or {}).get("metadata") or {}).get("resourceVersion") or "")
        if state is not None and rv:
            state.resume_rvs[str(rec.get("f") or "")] = rv
    elif t == "rb":
        twin.rebase(str(rec.get("f") or ""), list(rec.get("items") or []))
        if state is not None and rec.get("rv"):
            state.resume_rvs[str(rec.get("f") or "")] = str(rec["rv"])
    # the journal's generation numbering is authoritative on replay: the
    # twin's own increments (one per store surgery) can differ from the live
    # sequence around list-shaped records
    gen = rec.get("gen")
    if isinstance(gen, int) and gen >= twin.generation:
        twin.generation = gen
    if state is not None:
        ts = rec.get("timeline")
        if ts:
            state.timeline.extend(ts)
    return change


def apply_record(twin, rec: dict, state: Optional[RecoveredState] = None):
    """Apply ANY record type to a consumer twin — the standby tailer's
    apply primitive (server/fleet.py). ``ev``/``rb`` ride
    :func:`_apply_record` (rv-monotonic, generation-overlaid); a ``ck``
    rebases the twin wholesale, exactly like :func:`replay_events` does —
    a checkpoint is an authoritative full snapshot, and applying it is
    what heals a tailer that lost records to a pruned gap."""
    if rec.get("t") != "ck":
        return _apply_record(twin, rec, state)
    for field, items in (rec.get("stores") or {}).items():
        twin.rebase(field, list(items))
    gen = rec.get("gen")
    if isinstance(gen, int) and gen >= twin.generation:
        twin.generation = gen
    if state is not None:
        for f, rv in (rec.get("rvs") or {}).items():
            state.resume_rvs[str(f)] = str(rv)
        ts = rec.get("timeline")
        if ts:
            state.timeline = list(ts)
        state.checkpoint_generation = int(gen or 0)
    return None


class JournalTailer:
    """Live segment-follow reader over a journal directory ANOTHER process
    is appending to — the HA standby's feed. Strictly read-only: never
    truncates, never writes, never takes the writer's locks.

    Follow semantics per :meth:`poll`:

    - complete CRC-framed records after the remembered offset are drained
      in order; the offset advances only past VALID frames;
    - an **incomplete tail frame** (short header or short payload — the
      writer is mid-append, or crashed there) is left unconsumed: the next
      poll re-reads from the same offset once the bytes land;
    - **rotation**: when a newer segment exists, the current one is
      finished history — whatever valid frames remain are drained, then
      the tailer moves on. A torn/corrupt tail abandoned by a crashed
      writer is skipped the same way, which is safe because every segment
      after the first STARTS with a checkpoint and :func:`apply_record`
      rebases on checkpoints (the overlap re-applies as rv-monotonic
      no-ops);
    - **pruning**: when the tailer's segment vanished underneath it (the
      writer pruned past it) or shrank below the offset (a takeover
      truncated a torn tail), it re-anchors — oldest surviving segment,
      offset 0 — and counts the gap; the first record there is a
      checkpoint, so the consumer's twin snaps back to truth.

    Chaos point ``journal.tail_gap`` drops one drained batch on the floor
    (counted in ``gaps_total``): the deterministic stand-in for a tailer
    that fell off the pruned end of history, proving the
    checkpoint-rebase healing path.
    """

    def __init__(self, path: str) -> None:
        self.path = os.path.abspath(path)
        self._seq: Optional[int] = None  # segment being followed
        self._offset = 0  # byte offset after the last valid frame
        self.records_total = 0
        self.gaps_total = 0
        #: records drained by the last poll — how far the consumer had
        #: fallen behind (simon_fleet_standby_tail_lag_records)
        self.last_lag_records = 0
        self.last_stop = ""  # incomplete | invalid | "" (clean EOF)

    def _seg_seqs(self) -> List[int]:
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        return sorted(s for n in names if (s := _segment_seq(n)) is not None)

    def _read_from(self, seq: int, offset: int) -> Tuple[List[dict], int, str]:
        """Drain valid frames from segment ``seq`` starting at ``offset``.
        Returns ``(records, new_offset, stop)`` where stop is
        ``"incomplete"`` (short tail — wait for the writer), ``"invalid"``
        (corruption — only a newer segment can unblock), or ``""`` (clean
        EOF). A magic-less prefix is ``"incomplete"`` too: the writer
        stamps the magic on segment creation, so its absence means the
        file is younger than its own header flush."""
        path = os.path.join(self.path, _segment_name(seq))
        out: List[dict] = []
        try:
            with open(path, "rb") as f:
                if offset < len(SEGMENT_MAGIC):
                    magic = f.read(len(SEGMENT_MAGIC))
                    if len(magic) < len(SEGMENT_MAGIC):
                        return out, offset, "incomplete"
                    if magic != SEGMENT_MAGIC:
                        return out, offset, "invalid"
                    offset = f.tell()
                else:
                    f.seek(offset)
                while True:
                    hdr = f.read(_FRAME)
                    if len(hdr) < _FRAME:
                        return out, offset, "incomplete" if hdr else ""
                    length = int.from_bytes(hdr[:4], "little")
                    crc = int.from_bytes(hdr[4:8], "little")
                    if length <= 0 or length >= _LEN_MAX:
                        return out, offset, "invalid"
                    payload = f.read(length)
                    if len(payload) < length:
                        return out, offset, "incomplete"
                    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                        return out, offset, "invalid"
                    try:
                        out.append(json.loads(payload))
                    except ValueError:
                        return out, offset, "invalid"
                    offset = f.tell()
        except FileNotFoundError:
            return out, offset, "invalid"
        except OSError as e:
            log.warning("journal tail: segment %s unreadable: %s", path, e)
            return out, offset, "invalid"

    def poll(self) -> List[dict]:
        """All records that became readable since the last poll, in order.
        Empty when the writer is idle (or mid-frame). Never raises for
        data-shaped problems — gaps are counted and healed by the next
        checkpoint the stream carries."""
        batch: List[dict] = []
        for _hop in range(64):  # bound: segments crossed per poll
            seqs = self._seg_seqs()
            if not seqs:
                break
            if self._seq is None:
                self._seq, self._offset = seqs[0], 0
            elif self._seq not in seqs:
                # pruned out from under us: re-anchor at the oldest
                # survivor — its first record is a checkpoint
                self.gaps_total += 1
                log.warning(
                    "journal tail: segment %d pruned underneath the tailer; "
                    "re-anchoring at segment %d (the checkpoint there heals "
                    "the gap)", self._seq, seqs[0] if self._seq < seqs[0] else seqs[-1],
                )
                newer = [s for s in seqs if s > self._seq]
                self._seq, self._offset = (newer[0] if newer else seqs[0]), 0
            else:
                # a takeover's torn-tail truncation can shrink the file
                # below our offset: re-read the whole segment (checkpoint
                # first records + rv-monotonic apply make the re-read safe)
                try:
                    size = os.path.getsize(
                        os.path.join(self.path, _segment_name(self._seq))
                    )
                except OSError:
                    size = 0
                if size < self._offset:
                    self.gaps_total += 1
                    self._offset = 0
            recs, self._offset, stop = self._read_from(self._seq, self._offset)
            batch.extend(recs)
            self.last_stop = stop
            newer = [s for s in seqs if s > self._seq]
            if newer:
                # rotation (or an abandoned torn tail): this segment is
                # finished history — move on; a skipped bad tail is healed
                # by the next segment's leading checkpoint
                if stop == "invalid" or not recs:
                    if stop == "invalid":
                        self.gaps_total += 1
                    self._seq, self._offset = newer[0], 0
                continue  # drain again: more may have landed meanwhile
            break
        if batch:
            try:
                faults.fault_point("journal.tail_gap")
            except Exception as e:
                self.gaps_total += 1
                log.warning(
                    "journal tail: injected gap (%s): %d record(s) dropped; "
                    "the next checkpoint rebases the consumer back to truth",
                    e, len(batch),
                )
                self.last_lag_records = 0
                return []
        self.last_lag_records = len(batch)
        self.records_total += len(batch)
        return batch

    def position(self) -> Tuple[Optional[int], int]:
        """(segment seq, byte offset) after the last drained frame."""
        return self._seq, self._offset


def iter_records(path: str) -> Iterator[dict]:
    """Read-only record iteration over a journal directory."""
    return Journal(path, readonly=True).iter_records()


def rebuild_twin(path: str, at_generation: Optional[int] = None):
    """Reconstruct the twin at ``at_generation`` (or the newest state):
    start from the newest checkpoint at-or-before the target and replay the
    suffix up to it. Returns ``(twin, meta)`` where meta summarizes the
    replayed window."""
    # two streaming passes so a multi-segment journal (every checkpoint a
    # full twin snapshot) is never held in memory at once: pass 1 indexes
    # the newest qualifying checkpoint and counts, pass 2 applies from it
    ck_idx = None
    oldest_ck_gen: Optional[int] = None
    meta = {"records": 0, "events": 0, "rebases": 0, "checkpoints": 0, "replayed": 0}
    for i, rec in enumerate(iter_records(path)):
        meta["records"] += 1
        t = rec.get("t")
        if t == "ev":
            meta["events"] += 1
        elif t == "rb":
            meta["rebases"] += 1
        elif t == "ck":
            meta["checkpoints"] += 1
            gen = int(rec.get("gen") or 0)
            if oldest_ck_gen is None:
                oldest_ck_gen = gen
            if at_generation is None or gen <= at_generation:
                ck_idx = i
    twin = _new_twin()
    start = 0 if ck_idx is None else ck_idx
    for i, rec in enumerate(iter_records(path)):
        if i < start:
            continue
        if i == ck_idx:
            for field, items in (rec.get("stores") or {}).items():
                twin.rebase(field, list(items))
            gen = rec.get("gen")
            if isinstance(gen, int):
                twin.generation = gen
            continue
        if rec.get("t") == "ck":
            continue
        gen = rec.get("gen")
        if at_generation is not None and isinstance(gen, int) and gen > at_generation:
            break
        _apply_record(twin, rec)
        meta["replayed"] += 1
    if at_generation is not None and ck_idx is None and meta["records"] and not meta["replayed"]:
        # checkpoint pruning dropped the prefix the target lives in: an
        # empty twin here would be valid-shaped but wrong — fail loudly
        raise JournalError(
            f"{path}: generation {at_generation} predates the retained "
            f"history (oldest surviving checkpoint is generation "
            f"{oldest_ck_gen}; older segments were pruned)"
        )
    meta["generation"] = twin.generation
    return twin, meta


def replay_events(
    path: str,
    speed: float = 0.0,
    at_generation: Optional[int] = None,
) -> Iterator[Tuple[dict, "object", Optional[tuple]]]:
    """Stream ``(record, twin, change)`` triples, applying each record to a
    live twin as it goes — the engine behind ``simon replay`` (``change``
    is the ``apply_event`` verdict for event records, None for list-shaped
    ones; the capacity feed rides it).
    ``speed`` > 0 paces the stream at N× the recorded inter-record gaps; 0
    replays as fast as possible. Pacing gaps are clamped to 30s so a
    journal spanning an idle night replays in bounded time."""
    twin = _new_twin()
    prev_ts: Optional[float] = None
    for rec in iter_records(path):
        gen = rec.get("gen")
        if at_generation is not None and isinstance(gen, int) and gen > at_generation:
            return
        if rec.get("t") == "ck":
            # EVERY checkpoint rebases the replay twin: a checkpoint is an
            # authoritative full snapshot, and a mid-history re-anchor (the
            # repair written after a writer-queue drop) is exactly the
            # record that restores faithfulness — skipping it would replay
            # the gap the journal already healed
            for field, items in (rec.get("stores") or {}).items():
                twin.rebase(field, list(items))
            if isinstance(gen, int) and gen >= twin.generation:
                twin.generation = gen
            yield rec, twin, None
            continue
        if speed > 0 and prev_ts is not None:
            ts = rec.get("ts")
            if isinstance(ts, (int, float)):
                gap = min(30.0, max(0.0, float(ts) - prev_ts)) / speed
                if gap > 0:
                    time.sleep(gap)
        ts = rec.get("ts")
        if isinstance(ts, (int, float)):
            prev_ts = float(ts)
        change = _apply_record(twin, rec)
        yield rec, twin, change
