"""Typed registry of the ``OPENSIM_*`` environment knobs the port reads —
the port's copy of ``opensim_tpu/utils/envknobs.py``, holding the knobs of
the modules it has (the kernel build cache and the CUDA probe, the server
and its admission queue, the snapshot, the live twin and its journal, the
serving fleet and its HA control plane, the resilience layer, the request
tracer, the time-series ring and SLO engine, the capacity observatory, the
memory observatory and the campaign planner), and beside them the three
``JAX_*`` variables of the reference's multi-host launch (:data:`LAUNCH`).

Every read goes through :func:`raw`, which fails loudly on an
unregistered name, so a knob cannot ship undocumented and a typo'd name
cannot silently read as unset. Writes (``os.environ["OPENSIM_X"] = ...``)
stay legal: the CLI's ``--access-log`` sets its knob for the code below.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

__all__ = ["Knob", "KNOBS", "LAUNCH", "register", "raw", "value"]


@dataclass(frozen=True)
class Knob:
    """One registered environment knob: the name, a human type tag, the
    documented default (raw string form, ``""`` = unset), its doc line and,
    for a knob read through :func:`value`, the validator that parses it
    (raising ``ValueError`` on a bad value)."""

    name: str
    type: str  # int | float | flag | enum | str | path | spec
    default: str
    doc: str
    validator: Optional[Callable[[str], object]] = None


KNOBS: Dict[str, Knob] = {}


def register(knob: Knob) -> Knob:
    if not knob.name.startswith("OPENSIM_"):
        raise ValueError(f"env knob {knob.name!r} must be OPENSIM_-prefixed")
    if knob.name in KNOBS:
        raise ValueError(f"env knob {knob.name!r} registered twice")
    KNOBS[knob.name] = knob
    return knob


#: The reference's multi-host launch contract (``opensim_tpu/parallel/
#: multihost.py``), read by the port under the same names so that one launch
#: line serves both packages. Kept apart from :data:`KNOBS`, the port's own
#: ``OPENSIM_*`` knobs; :func:`raw` reads both.
LAUNCH: Dict[str, Knob] = {k.name: k for k in (
    Knob("JAX_COORDINATOR", "str", "",
         "Multi-host job: the coordinator's `host:port` (rank 0 listens there, every process joins it) for "
         "`parallel/multihost.initialize`, which `simon apply` calls; one process per host. Unset = one process, "
         "nothing joined."),
    Knob("JAX_NUM_PROCESSES", "int", "1", "Multi-host job: the number of processes; read when JAX_COORDINATOR is set."),
    Knob("JAX_PROCESS_ID", "int", "0",
         "Multi-host job: this process's rank, 0 to JAX_NUM_PROCESSES - 1; read when JAX_COORDINATOR is set."),
)}


def _registered(name: str) -> Knob:
    knob = KNOBS.get(name) or LAUNCH.get(name)
    if knob is None:
        raise KeyError(f"env knob {name!r} is not registered in opensim_tpu_torch/utils/envknobs.py")
    return knob


def raw(name: str, default: str = "") -> str:
    """``os.environ.get`` for a REGISTERED knob; an unregistered name
    raises. A caller-supplied ``default`` keeps a site's unset-vs-empty
    semantics and must match the registered one."""
    _registered(name)
    return os.environ.get(name, default)


def value(name: str):
    """The knob parsed through its registered validator (unset: its
    default, parsed). A bad value raises ``ValueError``: the knobs read
    here are spec bounds and modes, where a typo must not pass silently.
    A knob without a validator reads as :func:`raw` with its default."""
    knob = _registered(name)
    text = os.environ.get(name, "") or knob.default
    return text if knob.validator is None else knob.validator(text)


def _int(lo: int) -> Callable[[str], int]:
    def parse(text: str) -> int:
        v = int(text)
        if v < lo:
            raise ValueError(f"must be >= {lo}, got {v}")
        return v

    return parse


def _float(lo: float, exclusive: bool = False) -> Callable[[str], float]:
    def parse(text: str) -> float:
        v = float(text)
        if v <= lo if exclusive else v < lo:
            raise ValueError(f"must be {'>' if exclusive else '>='} {lo}, got {v}")
        return v

    return parse


def _enum(*choices: str) -> Callable[[str], str]:
    def parse(text: str) -> str:
        v = text.strip().lower()
        if v not in choices:
            raise ValueError(f"must be one of {'|'.join(choices)}, got {text!r}")
        return v

    return parse


for _knob in (
    # the kernel build cache and the CUDA probe (utils/jitcache.py, utils/probe.py)
    Knob("OPENSIM_JIT_CACHE", "spec", "",
         "Kernel build cache (the `nvcc` libraries of ops/fast_scan.py): unset or `1` = opensim_tpu_torch/_build/, "
         "a path = build and load there, `0` = no reuse (a temporary directory of the process's own, removed at "
         "exit; every variant compiles cold). An unwritable directory warns and builds as `0`."),
    Knob("OPENSIM_PROBE_CACHE", "path", "",
         "CUDA probe verdict cache file (default: opensim-tpu-torch-probe-<uid> in XDG_RUNTIME_DIR when set, else "
         "in the temporary directory); a failed probe is an error, never a CPU fallback."),
    # resilience (resilience/, server/snapshot.py)
    Knob("OPENSIM_REQUEST_TIMEOUT_S", "float", "",
         "Default per-request deadline in seconds (the `X-Simon-Timeout-S` header wins; unset/0 = unbounded)."),
    Knob("OPENSIM_FAULTS", "spec", "", "Deterministic fault injection: `point:count:exc[,point:count:exc...]`."),
    Knob("OPENSIM_SNAPSHOT_TIMEOUT_S", "float", "60", "Per-endpoint timeout for cluster snapshot list calls."),
    Knob("OPENSIM_SNAPSHOT_RETRIES", "int", "3",
         "Snapshot fetch attempts before degrading to a stale snapshot / typed 503."),
    Knob("OPENSIM_SNAPSHOT_BACKOFF_S", "float", "0.1", "Full-jitter backoff base between snapshot fetch retries."),
    # serving (server/rest.py)
    Knob("OPENSIM_ADMISSION", "enum", "on",
         "`on` routes requests through the admission queue + batcher; `off` restores the single-flight TryLock "
         "path.", _enum("on", "off")),
    Knob("OPENSIM_PREP_CACHE", "flag", "1", "`0` disables the encode cache (per-request full prepare)."),
    Knob("OPENSIM_ACCESS_LOG", "flag", "",
         "`1` emits one JSON access-log line per request on the `opensim_tpu_torch.access` logger."),
    # the admission queue (server/admission.py, server/pool.py, engine/reqbatch.py)
    Knob("OPENSIM_QUEUE_BOUND", "int", "64", "Admission queue bound; past it requests shed typed 503 + Retry-After.",
         _int(1)),
    Knob("OPENSIM_BATCH_WINDOW_MS", "float", "5", "Admission coalescing window in ms, measured from the first waiter.",
         _float(0.0)),
    Knob("OPENSIM_BATCH_MAX", "int", "16", "Max requests folded into one batched schedule launch.", _int(1)),
    Knob("OPENSIM_WORKERS", "int", "",
         "Worker-pool size for unbatchable requests (default: a small CPU-derived bound)."),
    Knob("OPENSIM_WORKERS_MODE", "enum", "auto",
         "Worker pool mode: `auto`/`thread` (default) or `process` (opt-in fork+probe; on the CPU only: a forked "
         "child cannot use the parent's CUDA context).", _enum("auto", "thread", "process")),
    Knob("OPENSIM_PIPELINE", "enum", "on",
         "`on` overlaps batch k+1 host prep with batch k's launch (staged pipeline); `off` restores the serial "
         "single-batch-in-flight loop.", _enum("on", "off")),
    Knob("OPENSIM_LANE_INTERACTIVE_PODS", "int", "8",
         "Requests expanding to at most this many pods ride the interactive lane (explain requests always do).",
         _int(0)),
    Knob("OPENSIM_LANE_WEIGHT", "int", "4",
         "Interactive-lane pickups per bulk pickup when both lanes are non-empty (weighted round-robin ratio).",
         _int(1)),
    Knob("OPENSIM_LANE_STARVATION_S", "float", "0.5",
         "Starvation bound: a bulk request waiting longer than this is picked next regardless of lane weight.",
         _float(0.0)),
    Knob("OPENSIM_BATCH_ENGINE", "enum", "auto",
         "Request-axis batch engine: `auto`, the port's one rung (the grid kernel); the reference's `xla` and "
         "`native` raise.", _enum("auto")),
    # the live twin and its journal (server/watch.py, server/journal.py):
    # validated loudly by watch_policy()/journal_policy() at start
    Knob("OPENSIM_WATCH_STALE_S", "float", "30",
         "No watch event/bookmark for this long → the stream is stale and the twin degrades."),
    Knob("OPENSIM_WATCH_RESYNC_S", "float", "300", "Anti-entropy relist-and-diff interval (0 disables)."),
    Knob("OPENSIM_WATCH_RECONNECTS", "int", "5", "Bounded watch reconnect attempts per incident."),
    Knob("OPENSIM_WATCH_BACKOFF_S", "float", "0.2", "Full-jitter backoff base between watch reconnects."),
    Knob("OPENSIM_JOURNAL_FSYNC", "enum", "interval", "Journal fsync policy: `always`, `interval`, or `off`."),
    Knob("OPENSIM_JOURNAL_FSYNC_S", "float", "1.0", "Journal `interval` fsync cadence in seconds."),
    Knob("OPENSIM_JOURNAL_SEGMENT_MB", "float", "64", "Journal segment rotation size bound in MB."),
    Knob("OPENSIM_JOURNAL_CHECKPOINT_EVERY", "int", "4096", "Event records between journal cadence checkpoints."),
    Knob("OPENSIM_JOURNAL_KEEP", "int", "2", "Checkpoint segments retained by journal pruning."),
    Knob("OPENSIM_JOURNAL_QUEUE", "int", "65536",
         "Journal writer queue bound; past it records drop (counted) and the next checkpoint re-anchors."),
    # the serving fleet (server/fleet.py)
    Knob("OPENSIM_WORKERS_FLEET", "int", "",
         "Fleet worker processes for `simon server` (the `--workers` flag wins; unset/0/1 = single process)."),
    Knob("OPENSIM_FLEET_PUBLISH_MS", "float", "50",
         "Twin-owner publish cadence: how often the owner checks the twin generation and republishes arena "
         "deltas over shared memory.", _float(1.0)),
    Knob("OPENSIM_FLEET_ATTACH_RETRIES", "int", "16",
         "Seqlock attach retries before a worker declares the publication torn (counted in "
         "simon_fleet_attach_retries_exhausted_total).", _int(1)),
    Knob("OPENSIM_FLEET_ADMIN_PORT", "int", "",
         "Fleet admin port (aggregated /metrics, /healthz, /api/fleet/status). Default: public port + 1."),
    Knob("OPENSIM_FLEET_ATTACH", "str", "",
         "INTERNAL: shared-memory control-block name a fleet worker attaches to (set by the fleet supervisor, "
         "never by operators)."),
    Knob("OPENSIM_FLEET_INTERNAL_PORT", "int", "",
         "INTERNAL: per-worker loopback listener port the fleet supervisor scrapes for /metrics aggregation."),
    # the HA control plane (server/fleet.py)
    Knob("OPENSIM_HA", "flag", "",
         "`1` enables the HA control plane: the fleet owner holds a fenced lease next to the journal and a "
         "`simon server --standby` process tails the journal, ready to take over."),
    Knob("OPENSIM_HA_LEASE_S", "float", "5",
         "HA lease duration in seconds: an owner that has not renewed within this window is considered dead "
         "and the standby takes over (renewal cadence is a third of it).", _float(0.0, exclusive=True)),
    Knob("OPENSIM_HA_TAIL_POLL_MS", "float", "50",
         "Standby journal tail-follow poll cadence in ms (also the lease-expiry check cadence).", _float(1.0)),
    Knob("OPENSIM_HA_HANDOVER_TIMEOUT_S", "float", "30",
         "Bound on an explicit handover drain (rolling upgrade): past it the requesting standby falls back to "
         "lease-expiry takeover.", _float(0.0, exclusive=True)),
    Knob("OPENSIM_FLEET_LEASE", "str", "",
         "INTERNAL: HA lease file path a fleet worker follows to re-resolve the owner's control block after a "
         "failover (set by the fleet supervisor, never by operators)."),
    # observability (obs/)
    Knob("OPENSIM_TRACE", "flag", "1", "`0` disables request tracing."),
    Knob("OPENSIM_FLIGHT_RECORDER_N", "int", "64", "Flight-recorder ring capacity (last N request traces)."),
    Knob("OPENSIM_EXPLAIN_STORE_N", "int", "512",
         "Per-trace cap on stored placement explanations (`?explain=1` audits)."),
    Knob("OPENSIM_MEM_TICKER_S", "float", "10",
         "Low-rate memory watermark sampling cadence in seconds (0 disables the ticker).", _float(0.0)),
    # the time-series ring and the SLO engine (obs/timeseries.py, obs/slo.py)
    Knob("OPENSIM_TS_INTERVAL_S", "float", "5",
         "Time-series ring sampling cadence: every registered metric family is sampled into the on-disk ring at "
         "this interval.", _float(0.0, exclusive=True)),
    Knob("OPENSIM_TS_WINDOWS", "int", "48",
         "Time-series ring bound: sealed delta-encoded windows kept on disk (oldest evicted first).", _int(2)),
    Knob("OPENSIM_TS_WINDOW_SAMPLES", "int", "60",
         "Samples per time-series window before it seals to disk (windows × window_samples × interval = "
         "retention).", _int(2)),
    Knob("OPENSIM_TS_DIR", "path", "",
         "Time-series ring directory (persists across restarts and is re-adopted on boot). Default: a private "
         "tempdir removed on shutdown."),
    Knob("OPENSIM_SLO", "spec", "availability:99.9,latency_p99:99:2.5,freshness:99:30",
         "Declarative SLOs: `name:target_pct[:threshold_s],...` with kinds availability/latency_p99/freshness "
         "(validated loudly)."),
    Knob("OPENSIM_SLO_WINDOWS", "spec", "5m,1h",
         "SLO burn-rate evaluation windows: `<number><s|m|h|d>,...` (multi-window burn-rate alerting)."),
    # capacity observatory (obs/capacity.py, obs/timeline.py)
    Knob("OPENSIM_CAPACITY_TOPK", "int", "10",
         "Per-node series cap for `simon_cluster_node_utilization` (cardinality governor)."),
    Knob("OPENSIM_CAPACITY_TIMELINE_N", "int", "512", "Capacity timeline ring capacity (generation-keyed samples)."),
    Knob("OPENSIM_HEADROOM_PROFILES", "spec", "small=500m:1Gi,large=4:8Gi",
         "Registered headroom probe profiles: `name=cpu:mem[:max_replicas],...` (validated loudly)."),
    # campaign planner (planner/campaign.py)
    Knob("OPENSIM_CAMPAIGN_EXEC", "enum", "warm",
         "Campaign execution mode (docs/campaigns.md): `warm` = one full prepare + prepcache deltas; `cold` = "
         "per-step full prepare (the verification mode the delta-equality gate compares against).",
         _enum("warm", "cold")),
    Knob("OPENSIM_CAMPAIGN_MAX_STEPS", "int", "256",
         "Campaign spec safety bound: specs with more steps are rejected at parse time.", _int(1)),
    Knob("OPENSIM_CAMPAIGN_MAX_WAVES", "int", "64",
         "Drain-wave runaway bound: cordon/evict/reschedule passes per drain step (blocked-eviction retries "
         "included).", _int(1)),
):
    register(_knob)
