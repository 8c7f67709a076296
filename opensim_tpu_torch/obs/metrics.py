"""Latency histograms and the Prometheus text format of ``/metrics`` — the
port's copy of ``opensim_tpu/obs/metrics.py``, with the families the
port's server renders.

It owns the ONE recording lock of the metrics surface: the REST layer's
counters, these histograms and the span sink all record under
:data:`RECORDER`'s RLock, so a scrape never interleaves with a recording.
Label values are escaped per the exposition format (``\\`` → ``\\\\``,
``"`` → ``\\"``, newline → ``\\n``).
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "BATCH_SIZE_BUCKETS",
    "CounterVec",
    "DEFAULT_BUCKETS",
    "FAMILIES",
    "FRESHNESS_BUCKETS",
    "HistogramVec",
    "MetricsRecorder",
    "RECORDER",
    "UTILIZATION_BUCKETS",
    "WATCH_APPLY_BUCKETS",
    "bucket_deltas",
    "counter_delta",
    "escape_label_value",
    "family_header",
    "histogram_quantile",
    "parse_metrics",
    "scrape_metrics",
]

# fixed bucket upper bounds in seconds (the +Inf bucket is implicit):
# sub-ms cache hits through multi-second cold 50k-pod plans
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

#: requests folded into one batched launch (the admission queue's
#: OPENSIM_BATCH_MAX defaults to 16)
BATCH_SIZE_BUCKETS: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)

#: watch-event application is µs-scale dict surgery; the request bucket
#: ladder would collapse the whole distribution into its first bucket
WATCH_APPLY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.5,
)

#: event-to-servable freshness (obs/fleetobs.py): the publish loop alone
#: adds up to OPENSIM_FLEET_PUBLISH_MS, so the ladder starts at ms scale
#: and reaches the minutes a wedged worker would show
FRESHNESS_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0,
)

#: per-node utilization is a ratio in [0, 1+] (requests can legitimately
#: exceed allocatable on over-committed nodes) — capacity-shaped buckets
UTILIZATION_BUCKETS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 0.625, 0.75, 0.875, 0.95, 1.0,
)

#: The metric-family registry: ``name -> (help, type)`` for every family the
#: port's server renders. Other modules emit headers through
#: :func:`family_header`, so an unregistered family fails at render time.
FAMILIES: Dict[str, Tuple[str, str]] = {
    # serving counters (server/rest.py)
    "simon_requests_total": ("Requests served by endpoint", "counter"),
    "simon_simulations_total": ("Successful simulations", "counter"),
    "simon_pods_scheduled_total": ("Pods placed across all simulations", "counter"),
    "simon_pods_unscheduled_total": ("Pods left unschedulable", "counter"),
    "simon_simulate_seconds_total": ("Wall seconds in successful simulations", "counter"),
    "simon_prepare_seconds_total": ("Host-side expand+encode seconds", "counter"),
    "simon_prep_cache_hits_total": ("Encode-cache hits", "counter"),
    "simon_prep_cache_misses_total": ("Encode-cache misses", "counter"),
    "simon_prep_cache_invalidations_total": ("Encode-cache invalidations", "counter"),
    # resilience
    "simon_request_timeouts_total": ("Requests 504ed at a deadline boundary", "counter"),
    "simon_snapshot_fetch_retries_total": ("Snapshot fetch retry attempts", "counter"),
    "simon_snapshot_stale_served_total": ("Requests served from a stale snapshot", "counter"),
    "simon_stale_prep_retries_total": ("Stale prep-cache internal retries", "counter"),
    "simon_faults_injected_total": ("Chaos faults injected by point", "counter"),
    # the admission queue (server/admission.py) — cardinality contract:
    # reason ∈ {queue_full, shutting_down, deadline}, lane ∈ {interactive,
    # bulk}, stage ∈ {prep, dispatch, decode}
    "simon_admission_queue_depth": ("Requests waiting in the admission queue", "gauge"),
    "simon_batches_total": ("Batched schedule launches", "counter"),
    "simon_shed_total": ("Requests shed at the admission queue by reason", "counter"),
    "simon_batch_size": ("Requests folded into one batched schedule launch", "histogram"),
    "simon_queue_wait_seconds": ("Real time-in-queue from admission to execution start", "histogram"),
    "simon_pipeline_stage_seconds": ("Per-batch pipeline stage latency by stage (prep/dispatch/decode)", "histogram"),
    "simon_pipeline_prep_overlap_seconds_total": (
        "Launch-busy seconds observed while a later batch's host prep ran (the measured overlap)", "counter",
    ),
    "simon_pipeline_overlapped_batches_total": (
        "Batches whose host prep overlapped another batch's launch", "counter",
    ),
    "simon_lane_depth": ("Admission queue depth by priority lane", "gauge"),
    "simon_lane_admitted_total": ("Requests admitted by priority lane", "counter"),
    "simon_lane_shed_total": ("Requests shed at the admission queue by lane and reason", "counter"),
    "simon_lane_starvation_promotions_total": (
        "Bulk requests promoted past the lane weight by the starvation bound", "counter",
    ),
    # latency and the decision audit (this module's RECORDER)
    "simon_phase_seconds": ("Per-phase latency from the request span trees", "histogram"),
    "simon_request_seconds": ("Whole-request latency by endpoint and outcome", "histogram"),
    "simon_filter_reject_total": (
        "Nodes rejected per filter plugin while attributing unschedulable pods", "counter",
    ),
    "simon_unschedulable_total": ("Unschedulable pods by primary (most-rejecting) reason code", "counter"),
    # capacity observatory (obs/capacity.py) — cardinality contract: every
    # family below is label-free or bounded (resource ∈ {cpu, memory, pods};
    # profile = registered headroom profiles; node series are capped at the
    # top-K hottest nodes)
    "simon_cluster_utilization": ("Per-node utilization distribution by resource", "histogram"),
    "simon_cluster_node_utilization": (
        "Top-K hottest node utilization by resource (cardinality-capped)", "gauge",
    ),
    "simon_cluster_utilization_ratio": ("Aggregate requested/allocatable by resource", "gauge"),
    "simon_cluster_allocatable": ("Cluster-wide allocatable by resource", "gauge"),
    "simon_cluster_requested": ("Cluster-wide requests of counted pods by resource", "gauge"),
    "simon_cluster_spread": ("Allocation spread: stddev/mean of per-node utilization", "gauge"),
    "simon_cluster_fragmentation": (
        "Free-capacity fragmentation: 1 - largest free node / total free", "gauge",
    ),
    "simon_cluster_headroom": (
        "Max additional replicas of a registered workload profile that still fit", "gauge",
    ),
    "simon_cluster_nodes": ("Nodes in the observed cluster", "gauge"),
    "simon_cluster_pods_bound": ("Counted pods bound to a node", "gauge"),
    "simon_cluster_pods_pending": ("Counted pods with no node (unschedulable pressure)", "gauge"),
    # the live twin (server/watch.py)
    "simon_watch_state": ("Live-twin state machine (one-hot)", "gauge"),
    "simon_watch_events_total": ("Watch events consumed by kind and resource", "counter"),
    "simon_watch_reconnects_total": ("Watch stream reconnect attempts", "counter"),
    "simon_watch_relists_total": ("Full relists (bootstrap/410/anti-entropy)", "counter"),
    "simon_watch_gone_total": ("410 Gone resourceVersion expiries", "counter"),
    "simon_twin_drift_total": ("Drifted objects repaired, by resource", "counter"),
    "simon_twin_resyncs_total": ("Anti-entropy passes that found drift", "counter"),
    "simon_twin_generation": ("Live-twin generation (bumps on every applied event)", "gauge"),
    "simon_watch_apply_seconds": ("Watch-pipeline latency: event receipt to twin applied", "histogram"),
    # the watch-event journal (server/journal.py); type is ev, rb or ck
    "simon_journal_records_total": ("Journal records written by type (ev/rb/ck)", "counter"),
    "simon_journal_bytes_total": ("Journal bytes written (framing included)", "counter"),
    "simon_journal_dropped_total": ("Records dropped at the bounded writer queue", "counter"),
    "simon_journal_fsync_seconds": ("Journal fsync latency", "histogram"),
    "simon_journal_recoveries_total": ("Journal recovery attempts by outcome", "counter"),
    # the memory observatory (obs/footprint.py) — cardinality contract:
    # dtype is one of the encoder policy's dtypes or "other"; ring is
    # flight_recorder, capacity_timeline or journal_queue; one device series
    # per card, kind in_use or peak
    "simon_mem_rss_bytes": ("Process resident set size", "gauge"),
    "simon_mem_rss_peak_bytes": ("Process RSS high watermark (VmHWM)", "gauge"),
    "simon_mem_device_bytes": ("Per-device accelerator memory by kind (in_use/peak)", "gauge"),
    "simon_mem_prepcache_bytes": ("Prep-cache host arena bytes (shared leaves counted once)", "gauge"),
    "simon_mem_prepcache_entries": ("Prep-cache entries resident", "gauge"),
    "simon_mem_prepcache_evictions_total": ("Prep-cache LRU evictions", "counter"),
    "simon_mem_prepcache_compactions_total": (
        "Twin-delta refusals at the drop-mask density threshold (full rebuild follows)", "counter",
    ),
    "simon_mem_arena_bytes": ("Prep-cache host arena bytes by encoder-policy dtype", "gauge"),
    "simon_mem_ring_entries": ("Bounded-ring occupancy by ring", "gauge"),
    "simon_mem_ring_capacity": ("Bounded-ring capacity by ring", "gauge"),
    # build telemetry of the kernel variants (obs/profile.py) — fn is a
    # variant name; cause is first or static; event is hit or miss
    "simon_compile_total": ("nvcc builds of kernel variants, by variant", "counter"),
    "simon_compile_seconds_total": ("Wall seconds of nvcc builds, by variant", "counter"),
    "simon_compile_cause_total": ("Variant builds by cause (first/static)", "counter"),
    "simon_backend_compile_seconds_total": ("Wall seconds of every nvcc build in the process", "counter"),
    "simon_backend_compile_total": ("nvcc builds in the process", "counter"),
    "simon_jitcache_persistent_files": ("Files in the kernel build directory", "gauge"),
    "simon_jitcache_persistent_bytes": ("Bytes in the kernel build directory", "gauge"),
    "simon_jitcache_events_total": ("Variant loads by build-directory outcome (hit/miss)", "counter"),
    # cumulative phase profiles (obs/profile.py) — span names are the fixed
    # instrumentation vocabulary
    "simon_phase_profile_calls_total": ("Spans folded into the cumulative profile, by span name", "counter"),
    "simon_phase_profile_seconds_total": ("Cumulative inclusive span seconds by span name", "counter"),
    "simon_phase_profile_exclusive_seconds_total": (
        "Cumulative exclusive span seconds (children subtracted) by span name", "counter",
    ),
    # the serving fleet (server/fleet.py): owner-side families and the
    # worker-side attach counters are label-free
    "simon_fleet_workers": ("Fleet worker processes currently alive", "gauge"),
    "simon_fleet_workers_target": ("Fleet worker processes configured", "gauge"),
    "simon_fleet_respawns_total": ("Fleet worker respawns after a crash", "counter"),
    "simon_fleet_publishes_total": ("Twin publications over shared memory", "counter"),
    "simon_fleet_generation": ("Last twin generation published over shared memory", "gauge"),
    "simon_fleet_shm_segments": ("Live shared-memory segments the publisher owns", "gauge"),
    "simon_fleet_shm_bytes": ("Bytes across live shared-memory segments", "gauge"),
    "simon_fleet_publish_seconds": ("Twin publication latency (delta segments + control swap)", "histogram"),
    "simon_fleet_attaches_total": ("Worker attaches to a published generation", "counter"),
    "simon_fleet_attach_retries_total": ("Seqlock retries during worker attach (torn reads)", "counter"),
    "simon_fleet_attach_retries_exhausted_total": (
        "Worker attaches abandoned after exhausting seqlock retries", "counter",
    ),
    "simon_fleet_attach_generation": ("Twin generation this worker last attached", "gauge"),
    "simon_fleet_segment_reuse_total": (
        "Segments reused across generations at attach (content-keyed delta hits)", "counter",
    ),
    # the HA control plane (server/fleet.py); reason is expired or handover
    "simon_fleet_takeovers_total": ("Standby-to-owner takeovers by reason (expired/handover)", "counter"),
    "simon_fleet_standby_tail_lag_records": (
        "Journal records the standby drained at its last tail poll (how far it had fallen behind)", "gauge",
    ),
    "simon_fleet_lease_age_seconds": ("Seconds since the HA lease was last renewed", "gauge"),
    "simon_fleet_fenced_writes_total": (
        "Publishes refused because the lease epoch moved (a deposed owner fenced out)", "counter",
    ),
    # event-to-servable freshness (obs/fleetobs.py): stage is journaled,
    # published (owner), attached or served (worker), each measured from
    # watch-event acceptance on the owner's wall clock
    "simon_fleet_freshness_seconds": (
        "Event-to-servable latency by pipeline stage, from watch-event acceptance", "histogram",
    ),
    # the time-series ring (obs/timeseries.py): sampling liveness and the
    # disk bound
    "simon_ts_samples_total": ("Time-series ring samples recorded", "counter"),
    "simon_ts_window_bytes": ("Bytes held by the on-disk time-series ring", "gauge"),
    "simon_ts_windows": ("Delta-encoded windows resident in the time-series ring", "gauge"),
    # the SLO engine (obs/slo.py): burn rate = observed bad fraction over the
    # window divided by the objective's error budget; slo and window are a
    # fixed small set
    "simon_slo_burn_rate": ("SLO burn rate by objective and evaluation window", "gauge"),
}


def exposition_headers(name: str, help_text: str, kind: str = "counter") -> List[str]:
    """The ``# HELP``/``# TYPE`` header pair every rendered family carries."""
    return [f"# HELP {name} {help_text}", f"# TYPE {name} {kind}"]


def family_header(name: str) -> List[str]:
    """``# HELP``/``# TYPE`` for a REGISTERED family; an unregistered one
    raises."""
    try:
        help_text, kind = FAMILIES[name]
    except KeyError:
        raise KeyError(f"metric family {name!r} is not registered in obs/metrics.py FAMILIES") from None
    return exposition_headers(name, help_text, kind)


def escape_label_value(value: str) -> str:
    """Prometheus exposition-format label escaping (text format §label
    values): backslash, double quote, and line feed."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else f"{bound:g}"


_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+([0-9eE+.\-]+|\+Inf|NaN)$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

MetricKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def parse_metrics(text: str) -> Dict[MetricKey, float]:
    """Exposition text → ``{(name, sorted label items): value}``: the
    inverse of the render path, for clients of ``/metrics``."""
    out: Dict[MetricKey, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            continue
        name, labels_body, value = m.groups()
        labels = tuple(sorted(
            (k, v.replace('\\"', '"').replace("\\\\", "\\")) for k, v in _LABEL.findall(labels_body or "")
        ))
        out[(name, labels)] = float(value)
    return out


def scrape_metrics(url: str, timeout_s: float = 10.0) -> Dict[MetricKey, float]:
    """One ``GET {url}/metrics``, parsed (:func:`parse_metrics`)."""
    import urllib.request

    with urllib.request.urlopen(f"{url}/metrics", timeout=timeout_s) as resp:
        return parse_metrics(resp.read().decode())


def _series_delta(after_v: float, before_v: float) -> float:
    """Cumulative-series delta with counter-reset handling (the PromQL
    ``rate()`` convention): a decrease means the process restarted and the
    counter began again at zero, so the post-reset value IS the delta."""
    d = after_v - before_v
    return after_v if d < 0 else d


def bucket_deltas(before: Dict[MetricKey, float], after: Dict[MetricKey, float], family: str,
                  match: Dict[str, str]) -> List[Tuple[float, float]]:
    """Sorted ``(le, cumulative delta)`` for one histogram family, summed
    over every series whose labels are a superset of ``match`` (the series
    share the bucket ladder). A series absent from ``before`` contributes
    its full ``after`` value; one that DECREASED is a counter reset and
    contributes its post-reset value."""
    sums: Dict[float, float] = {}
    for (name, labels), v in after.items():
        if name != f"{family}_bucket":
            continue
        ld = dict(labels)
        if any(ld.get(k) != want for k, want in match.items()):
            continue
        le = math.inf if ld.get("le") == "+Inf" else float(ld.get("le", "inf"))
        sums[le] = sums.get(le, 0.0) + _series_delta(v, before.get((name, labels), 0.0))
    return sorted(sums.items())


def histogram_quantile(before: Dict[MetricKey, float], after: Dict[MetricKey, float], family: str, q: float,
                       match: Optional[Dict[str, str]] = None) -> Optional[float]:
    """PromQL ``histogram_quantile`` over the scrape DELTA: linear
    interpolation inside the target bucket. None when the delta is empty."""
    buckets = bucket_deltas(before, after, family, match or {})
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    target = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in buckets:
        if cum >= target:
            if math.isinf(le):
                return prev_le  # tail bucket: the lower bound is the honest answer
            if cum == prev_cum:
                return le
            return prev_le + (le - prev_le) * (target - prev_cum) / (cum - prev_cum)
        prev_le, prev_cum = le, cum
    return buckets[-1][0]


def counter_delta(before: Dict[MetricKey, float], after: Dict[MetricKey, float], name: str,
                  match: Optional[Dict[str, str]] = None) -> float:
    """Summed counter delta across matching series, reset-safe (see
    :func:`bucket_deltas`)."""
    total = 0.0
    for (n, labels), v in after.items():
        if n != name:
            continue
        ld = dict(labels)
        if match and any(ld.get(k) != want for k, want in match.items()):
            continue
        total += _series_delta(v, before.get((n, labels), 0.0))
    return total


class CounterVec:
    """One counter family over a fixed label set, rendered with its
    ``# HELP``/``# TYPE`` header. Not self-locking: mutations happen under
    :data:`RECORDER`'s lock like everything else."""

    def __init__(self, name: str, label_names: Sequence[str]) -> None:
        help_text, kind = FAMILIES[name]  # KeyError = unregistered family
        if kind != "counter":
            raise ValueError(f"{name} is registered as {kind}, not counter")
        self.name = name
        self.label_names = tuple(label_names)
        self.help = help_text
        self._series: Dict[Tuple[str, ...], int] = {}  # guarded-by: RECORDER.lock

    def inc(self, labels: Tuple[str, ...], n: int = 1) -> None:
        self._series[labels] = self._series.get(labels, 0) + n

    def render_lines(self) -> List[str]:
        if not self._series:
            return []
        lines = exposition_headers(self.name, self.help, "counter")
        for labels in sorted(self._series):
            base = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in zip(self.label_names, labels))
            lines.append(f"{self.name}{{{base}}} {self._series[labels]}")
        return lines

    def reset(self) -> None:
        self._series.clear()


class HistogramVec:
    """One histogram family over a fixed label set. Not self-locking: every
    mutation and read happens under the owning :class:`MetricsRecorder`'s
    lock."""

    def __init__(self, name: str, label_names: Sequence[str], buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        help_text, kind = FAMILIES[name]  # KeyError = unregistered family
        if kind != "histogram":
            raise ValueError(f"{name} is registered as {kind}, not histogram")
        self.name = name
        self.label_names = tuple(label_names)
        self.buckets = tuple(buckets) + (math.inf,)
        self.help = help_text
        # label-values tuple -> [per-bucket counts..., count, sum]
        self._series: Dict[Tuple[str, ...], list] = {}  # guarded-by: RECORDER.lock

    def observe(self, seconds: float, labels: Tuple[str, ...]) -> None:
        series = self._series.get(labels)
        if series is None:
            series = self._series[labels] = [0] * len(self.buckets) + [0, 0.0]
        for i, bound in enumerate(self.buckets):
            if seconds <= bound:
                series[i] += 1
                break
        series[-2] += 1
        series[-1] += seconds

    def render_lines(self) -> List[str]:
        if not self._series:
            return []
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for labels in sorted(self._series):
            series = self._series[labels]
            base = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in zip(self.label_names, labels))
            sep = "," if base else ""
            wrap = f"{{{base}}}" if base else ""
            cum = 0
            for i, bound in enumerate(self.buckets):
                cum += series[i]
                lines.append(f'{self.name}_bucket{{{base}{sep}le="{_fmt_le(bound)}"}} {cum}')
            lines.append(f"{self.name}_sum{wrap} {series[-1]:.6f}")
            lines.append(f"{self.name}_count{wrap} {series[-2]}")
        return lines

    def reset(self) -> None:
        self._series.clear()


class MetricsRecorder:
    """The locked recorder every metrics mutation routes through: phase and
    request latency histograms fed from trace spans, plus the shared RLock
    the REST counters borrow."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.phase_seconds = HistogramVec("simon_phase_seconds", ("phase", "endpoint"))
        self.request_seconds = HistogramVec("simon_request_seconds", ("endpoint", "status"))
        # the decision audit: per-filter node rejects from the failure
        # attribution, and unschedulable pods by primary reason, bumped by
        # every simulate() in or out of explain mode
        self.filter_rejects = CounterVec("simon_filter_reject_total", ("filter",))
        self.unschedulable = CounterVec("simon_unschedulable_total", ("reason",))
        # the watch pipeline: event receipt to twin applied, fed from the
        # supervisor's dispatch (server/watch.py)
        self.watch_apply = HistogramVec("simon_watch_apply_seconds", (), buckets=WATCH_APPLY_BUCKETS)

    def observe_request(self, endpoint: str, seconds: float, status: str = "ok") -> None:
        """Whole-request latency, recorded for every outcome (labeled with
        the trace status), with or without tracing enabled."""
        with self.lock:
            self.request_seconds.observe(seconds, (endpoint, status))

    def observe_watch_apply(self, seconds: float) -> None:
        """One watch event's receipt→applied latency (``server/watch.py``
        dispatch, the twin's own lock included)."""
        with self.lock:
            self.watch_apply.observe(seconds, ())

    def count_filter_rejects(self, by_filter: Dict[str, int]) -> None:
        with self.lock:
            for name, n in by_filter.items():
                self.filter_rejects.inc((name,), int(n))

    def count_unschedulable(self, by_reason: Dict[str, int]) -> None:
        with self.lock:
            for name, n in by_reason.items():
                self.unschedulable.inc((name,), int(n))

    def observe_trace(self, trace) -> None:
        """The span sink: fold a finished trace's phase spans into the
        per-phase histograms, so the histograms and the flight-recorder
        tree are computed from the same span objects."""
        from .trace import PHASES

        phases = set(PHASES)
        with self.lock:
            for sp in trace.walk():
                if sp.name in phases:
                    self.phase_seconds.observe(sp.duration_s, (sp.name, trace.endpoint))

    def simulate_seconds_total(self) -> float:
        """``simon_simulate_seconds_total``, derived from the request
        histogram's ``status="ok"`` series."""
        with self.lock:
            return sum(s[-1] for labels, s in self.request_seconds._series.items() if labels[1] == "ok")

    def render_lines(self) -> List[str]:
        with self.lock:
            return (self.filter_rejects.render_lines() + self.unschedulable.render_lines()
                    + self.phase_seconds.render_lines() + self.request_seconds.render_lines()
                    + self.watch_apply.render_lines())

    def reset(self) -> None:
        with self.lock:
            self.phase_seconds.reset()
            self.request_seconds.reset()
            self.filter_rejects.reset()
            self.unschedulable.reset()
            self.watch_apply.reset()


RECORDER = MetricsRecorder()
