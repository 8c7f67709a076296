"""``simon loadgen`` — open/closed-loop load harness for the live server;
the port's copy of ``opensim_tpu/server/loadgen.py``.

The success metric of the concurrent serving core is a CLOSED LOOP, not a
microbench: drive the live server at a target concurrency (closed loop:
each worker waits for its response before issuing the next request) or a
target arrival rate (open loop: requests fire on a fixed schedule whether
or not earlier ones returned), and read the latency distribution straight
from the server's own ``simon_request_seconds_bucket`` histogram — the
same series a production dashboard scrapes — rather than trusting
client-side clocks alone. Both views are reported; disagreement between
them is itself a finding (client-side queueing).

Shed handling mirrors a well-behaved client: a 503 with ``Retry-After``
backs off for the advertised interval (capped), and sheds are reported
separately from errors — shedding under overload is the server WORKING,
and the report says how much traffic it cost.

Library surface: :func:`run_loadgen` returns the report dict, with the
reference's keys and their meaning; the CLI in ``cli/main.py`` prints it as
JSON. The servers the benchmarks boot are the port's ``simon server``
subprocesses, on the card unless a ``device`` is named (``"cpu"``), each
the leader of its own process group, stopped with everything it spawned.
"""

from __future__ import annotations

import json
import logging
import math
import re
import threading
import time
import urllib.request
from typing import List, Optional, Tuple

log = logging.getLogger("opensim_tpu_torch.loadgen")

__all__ = [
    "run_loadgen",
    "run_stub_benchmark",
    "run_fleet_benchmark",
    "run_pipeline_benchmark",
    "placement_parity",
    "parse_metrics",
    "histogram_quantile",
    "scrape_metrics",
]

# ---------------------------------------------------------------------------
# Prometheus text-format reading lives in obs/metrics.py (the fleet
# aggregator and the time-series ring share it); re-exported here
# ---------------------------------------------------------------------------

from ..obs.metrics import (  # noqa: E402  (re-export, see __all__)
    histogram_quantile,
    parse_metrics,
    scrape_metrics,
)
from ..obs.metrics import bucket_deltas as _bucket_deltas  # noqa: E402,F401
from ..obs.metrics import counter_delta as _counter_delta  # noqa: E402


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def _payload(worker: int, seq: int, replicas: int, cpu: str, mem: str) -> bytes:
    """Distinct-per-request deploy payload: identical repeated payloads
    would measure the full-key prep cache, not the serving core."""
    name = f"lg-{worker}-{seq}"
    reps = 1 + (seq % max(1, replicas))
    return json.dumps(
        {
            "deployments": [
                {
                    "apiVersion": "apps/v1",
                    "kind": "Deployment",
                    "metadata": {"name": name, "namespace": "default"},
                    "spec": {
                        "replicas": reps,
                        "selector": {"matchLabels": {"app": name}},
                        "template": {
                            "metadata": {"labels": {"app": name}},
                            "spec": {
                                "containers": [
                                    {
                                        "name": "c",
                                        "resources": {
                                            "requests": {"cpu": cpu, "memory": mem}
                                        },
                                    }
                                ]
                            },
                        },
                    },
                }
            ]
        }
    ).encode()


class _Stats:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.ok = 0
        self.shed = 0
        self.errors = 0
        self.latencies: List[float] = []

    def record(self, outcome: str, seconds: float) -> None:
        with self.lock:
            if outcome == "ok":
                self.ok += 1
                self.latencies.append(seconds)
            elif outcome == "shed":
                self.shed += 1
            else:
                self.errors += 1


class _Client:
    """One worker's persistent HTTP/1.1 connection (keep-alive): connection
    churn must not pollute the latency measurement — the server speaks
    HTTP/1.1 with Content-Length on every response."""

    def __init__(self, url: str, timeout_s: float) -> None:
        import urllib.parse

        parsed = urllib.parse.urlparse(url)
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or (443 if parsed.scheme == "https" else 80)
        self.timeout_s = timeout_s
        self.conn: Optional[object] = None

    def _connect(self):
        import http.client

        self.conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout_s
        )
        return self.conn

    def request(self, body: bytes) -> Tuple[str, float, float]:
        """POST one deploy; returns (outcome, latency_s, retry_after_s)."""
        t0 = time.monotonic()
        conn = self.conn or self._connect()
        try:
            conn.request(
                "POST", "/api/deploy-apps", body=body,
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            resp.read()
            lat = time.monotonic() - t0
            if resp.status == 503:
                try:
                    retry = float(resp.headers.get("Retry-After") or 1.0)
                except ValueError:
                    retry = 1.0
                return "shed", lat, retry
            if resp.status != 200:
                return "error", lat, 0.0
            return "ok", lat, 0.0
        except Exception as e:
            # drop the (possibly wedged) connection; the next request dials
            # fresh — a connection reset is an ERROR SAMPLE in the report,
            # never a crash of the harness
            log.debug("request failed: %s: %s", type(e).__name__, e)
            try:
                conn.close()
            except OSError as ce:
                log.debug("connection close failed: %s", ce)
            self.conn = None
            return "error", time.monotonic() - t0, 0.0

    def close(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError as ce:
                log.debug("connection close failed: %s", ce)
            self.conn = None


def _quantile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, max(0, int(math.ceil(q * len(sorted_vals))) - 1))
    return sorted_vals[idx]


def run_loadgen(
    url: str,
    mode: str = "closed",
    concurrency: int = 8,
    qps: float = 0.0,
    duration_s: float = 10.0,
    replicas: int = 3,
    cpu: str = "500m",
    mem: str = "1Gi",
    timeout_s: float = 60.0,
    warmup_requests: int = 1,
    metrics_url: str = "",
) -> dict:
    """Drive the server and report sustained QPS + latency percentiles.

    - ``closed``: ``concurrency`` workers, each issuing its next request
      only after the previous response (or after the advertised
      ``Retry-After`` on a shed) — throughput self-adjusts to the server's
      capacity, the honest "sustained QPS at bounded p99" measurement.
    - ``open``: requests fire every ``1/qps`` seconds regardless of
      completions (up to ``concurrency`` in flight; arrivals past that are
      counted ``dropped`` — client-side overload, reported, never silently
      skipped).

    ``metrics_url`` overrides where the server-side histograms are
    scraped: against a multi-worker fleet the public port lands on ONE
    worker per connection, so the scrape must hit the fleet admin
    endpoint (aggregated across workers) instead.
    """
    if mode not in ("closed", "open"):
        raise ValueError(f"mode must be closed|open, got {mode!r}")
    if mode == "open" and qps <= 0:
        raise ValueError("open loop needs --qps > 0")
    metrics_url = metrics_url or url

    # warmup outside the measured window: the first request pays the cold
    # prepare + engine compile and would dominate a short run
    wcli = _Client(url, timeout_s)
    for i in range(max(0, warmup_requests)):
        wcli.request(_payload(999, i, replicas, cpu, mem))
    wcli.close()

    before = scrape_metrics(metrics_url)
    stats = _Stats()
    stop = time.monotonic() + duration_s
    dropped = [0]

    def closed_worker(w: int) -> None:
        cli = _Client(url, timeout_s)
        seq = 0
        try:
            while time.monotonic() < stop:
                outcome, lat, retry = cli.request(
                    _payload(w, seq, replicas, cpu, mem)
                )
                stats.record(outcome, lat)
                seq += 1
                if outcome == "shed":
                    time.sleep(min(retry, max(0.0, stop - time.monotonic()), 2.0))
        finally:
            cli.close()

    def open_driver() -> None:
        interval = 1.0 / qps
        inflight = threading.Semaphore(concurrency)
        seq = 0
        next_at = time.monotonic()

        def fire(s: int) -> None:
            cli = _Client(url, timeout_s)
            try:
                outcome, lat, _ = cli.request(_payload(0, s, replicas, cpu, mem))
            finally:
                cli.close()
            stats.record(outcome, lat)
            inflight.release()

        while time.monotonic() < stop:
            now = time.monotonic()
            if now < next_at:
                time.sleep(min(interval, next_at - now))
                continue
            next_at += interval
            if not inflight.acquire(blocking=False):
                dropped[0] += 1
                continue
            threading.Thread(target=fire, args=(seq,), daemon=True).start()
            seq += 1

    t_start = time.monotonic()
    if mode == "closed":
        workers = [
            threading.Thread(target=closed_worker, args=(w,), daemon=True)
            for w in range(concurrency)
        ]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
    else:
        open_driver()
        # drain stragglers briefly so the final scrape sees them
        time.sleep(min(2.0, timeout_s))
    measured_s = time.monotonic() - t_start
    after = scrape_metrics(metrics_url)

    lats = sorted(stats.latencies)
    ok_match = {"endpoint": "deploy-apps", "status": "ok"}
    batches = _counter_delta(before, after, "simon_batches_total")
    batched_reqs = _counter_delta(before, after, "simon_batch_size_sum")
    shed_by_reason = {}
    for (name, labels), v in after.items():
        if name == "simon_shed_total":
            reason = dict(labels).get("reason", "")
            shed_by_reason[reason] = int(v - before.get((name, labels), 0.0))
    report = {
        "mode": mode,
        "duration_s": round(measured_s, 3),
        "concurrency": concurrency,
        "target_qps": qps if mode == "open" else None,
        "requests": stats.ok + stats.shed + stats.errors,
        "ok": stats.ok,
        "shed": stats.shed,
        "errors": stats.errors,
        "dropped": dropped[0],
        "qps": round(stats.ok / measured_s, 2) if measured_s > 0 else 0.0,
        "client_p50_s": _quantile(lats, 0.50),
        "client_p99_s": _quantile(lats, 0.99),
        # straight from the server's own exposition (the closed loop's
        # other half): simon_request_seconds_bucket over the run's delta
        "server_p50_s": histogram_quantile(
            before, after, "simon_request_seconds", 0.50, ok_match
        ),
        "server_p99_s": histogram_quantile(
            before, after, "simon_request_seconds", 0.99, ok_match
        ),
        "queue_wait_p99_s": histogram_quantile(
            before, after, "simon_queue_wait_seconds", 0.99
        ),
        "batches": int(batches),
        "batched_requests": int(batched_reqs),
        "mean_batch_size": round(batched_reqs / batches, 2) if batches else 0.0,
        "shed_total": shed_by_reason,
    }
    return report


# ---------------------------------------------------------------------------
# the closed loop against the stub apiserver
# ---------------------------------------------------------------------------


def _seed_stub(n_nodes: int, n_pods: int):
    """Stub apiserver seeded with a small live cluster (nodes + running
    pods) so the twin's warm base prep is non-trivial — the shape the
    request-axis batcher serves."""
    from ..models import fixtures as fx
    from .stubapi import StubApiServer

    stub = StubApiServer(bookmark_interval_s=0.2).start()
    stub.seed(
        "/api/v1/nodes",
        [fx.make_fake_node(f"n{i}", "16", "32Gi").raw for i in range(n_nodes)],
    )
    stub.seed(
        "/api/v1/pods",
        [
            {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {"name": f"seed-{i}", "namespace": "default"},
                "spec": {
                    "nodeName": f"n{i % n_nodes}",
                    "containers": [
                        {"name": "c", "resources": {"requests": {"cpu": "250m"}}}
                    ],
                },
                "status": {"phase": "Running"},
            }
            for i in range(n_pods)
        ],
    )
    for path in (
        "/apis/apps/v1/daemonsets", "/apis/policy/v1/poddisruptionbudgets",
        "/api/v1/services", "/apis/storage.k8s.io/v1/storageclasses",
        "/api/v1/persistentvolumeclaims", "/api/v1/configmaps",
    ):
        stub.seed(path, [])
    return stub


def _boot_server(kubeconfig: str, port: int, admission: bool, batch_max: int,
                 workers: int = 0, queue_bound: int = 0,
                 pipeline: "Optional[bool]" = None, device: Optional[str] = None):
    """The port's simon server as a SUBPROCESS: the loadgen client and the
    server must not share a GIL, or the measurement reports the client's
    contention as server latency. It serves on the card unless `device`
    names another (``"cpu"``), and leads a process group of its own, so
    :func:`_stop_server` stops its fleet workers with it. ``workers`` ≥ 2
    boots the multi-process fleet (``--workers N``); readiness then waits
    on the fleet admin ``/healthz`` reporting every worker alive (the
    public port is served by the workers via SO_REUSEPORT)."""
    import os
    import subprocess
    import sys

    from ..utils import jitcache
    from ..utils.procgroup import spawn_group

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = jitcache.export(dict(
        os.environ,
        OPENSIM_ADMISSION="on" if admission else "off",
        OPENSIM_BATCH_MAX=str(batch_max),
        PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
    ))
    if queue_bound:
        env["OPENSIM_QUEUE_BOUND"] = str(queue_bound)
    if pipeline is not None:
        env["OPENSIM_PIPELINE"] = "on" if pipeline else "off"
    cmd = [sys.executable, "-m", "opensim_tpu_torch", "server",
           "--kubeconfig", kubeconfig, "--port", str(port), "--watch", "auto"]
    if workers >= 2:
        cmd += ["--workers", str(workers)]
    if device:
        cmd += ["--device", str(device)]
    # Spool server output to a file, never a pipe: nobody drains the pipe
    # during the run, and at storm concurrency the 64 KiB buffer fills with
    # handler tracebacks (clients dropping mid-response), after which every
    # server thread that logs blocks in write() and the drain wedges.
    logf = open(os.path.join(os.path.dirname(kubeconfig) or ".",
                             f"server-{port}.log"), "w+b")
    proc = spawn_group(cmd, env=env, stdout=logf, stderr=subprocess.STDOUT)
    proc._simon_logf = logf  # closed by _stop_server
    url = f"http://127.0.0.1:{port}"
    ready_url = f"http://127.0.0.1:{port + 1}/healthz" if workers >= 2 else f"{url}/healthz"
    deadline = time.monotonic() + (240.0 if workers >= 2 else 120.0)
    attempt = 0
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            logf.flush()
            logf.seek(0)
            out = (logf.read() or b"").decode(errors="replace")
            _stop_server(proc, drain_s=0.0)  # closes the log, sweeps the group
            raise RuntimeError(f"server exited at boot (rc={proc.returncode}): {out[-2000:]}")
        try:
            with urllib.request.urlopen(ready_url, timeout=1.0) as resp:
                if workers >= 2:
                    body = json.loads(resp.read().decode())
                    if body.get("status") != "ok" or body.get("generation", -1) < 0:
                        raise OSError("fleet not ready")
                    # the admin endpoint is up and every worker process is
                    # alive; confirm the shared public port answers too
                    with urllib.request.urlopen(f"{url}/healthz", timeout=1.0):
                        pass
                return proc, url
        except (OSError, ValueError) as e:
            log.debug("healthz probe %d: %s", attempt, e)
            attempt += 1
            time.sleep(min(0.5, 0.05 * attempt))
    _stop_server(proc, drain_s=0.0)
    raise RuntimeError("server did not become healthy within the boot window")


def _stop_server(proc, drain_s: float = 60.0) -> None:
    """SIGTERM, bounded drain, then SIGKILL of the server's whole process
    group. The graceful drain is the normal path; the kill is insurance so
    one wedged server cannot hang an entire bench run in ``proc.wait()``,
    and it takes any fleet worker the server left behind with it."""
    from ..utils.procgroup import stop_group

    stop_group(proc, timeout_s=drain_s)
    logf = getattr(proc, "_simon_logf", None)
    if logf is not None:
        logf.close()


def _warm_concurrent(url: str, n: int, timeout_s: float) -> None:
    """Concurrent warmup burst: a serial warmup never exercises the BATCH
    path, whose first run pays its own caches."""
    def one(i: int) -> None:
        cli = _Client(url, timeout_s)
        try:
            cli.request(_payload(888, i, 3, "500m", "1Gi"))
        finally:
            cli.close()

    threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def run_stub_benchmark(
    concurrency: int = 32,
    duration_s: float = 8.0,
    n_nodes: int = 8,
    n_pods: int = 16,
    batch_max: int = 32,
    base_port: int = 18180,
    client_procs: int = 0,
    device: Optional[str] = None,
) -> dict:
    """The closed loop, end to end: stub apiserver → two live twin servers
    in subprocesses (single-flight vs admission queue) → closed-loop
    loadgen against each → one report carrying BOTH numbers.
    ``client_procs`` ≥ 2 shards the clients over loadgen subprocesses
    (mandatory fidelity at hundreds of clients). The servers run on
    `device` (the card unless named)."""
    import tempfile

    stub = _seed_stub(n_nodes, n_pods)
    tmp = tempfile.mkdtemp(prefix="loadgen-")
    kc = stub.kubeconfig(tmp)

    def drive(url: str) -> dict:
        if client_procs >= 2:
            return run_loadgen_sharded(url, concurrency, duration_s, client_procs)
        return run_loadgen(
            url, mode="closed", concurrency=concurrency, duration_s=duration_s
        )

    try:
        proc, url = _boot_server(kc, base_port, admission=False, batch_max=batch_max, device=device)
        try:
            _warm_concurrent(url, min(16, concurrency), 60.0)
            single = drive(url)
        finally:
            _stop_server(proc)
        proc, url = _boot_server(kc, base_port + 1, admission=True, batch_max=batch_max, device=device)
        try:
            _warm_concurrent(url, min(16, concurrency), 60.0)
            batched = drive(url)
        finally:
            _stop_server(proc)
    finally:
        stub.stop()
    speedup = (
        batched["qps"] / single["qps"] if single["qps"] > 0 else float("inf")
    )
    return {
        "concurrency": concurrency,
        "duration_s": duration_s,
        "nodes": n_nodes,
        "cluster_pods": n_pods,
        "qps_single_flight": single["qps"],
        "qps": batched["qps"],
        "speedup": round(speedup, 2),
        "p50_s": batched["server_p50_s"],
        "p99_s": batched["server_p99_s"],
        "p99_single_flight_s": single["server_p99_s"],
        "batches": batched["batches"],
        "mean_batch_size": batched["mean_batch_size"],
        "shed": batched["shed"],
        "shed_single_flight": single["shed"],
        "single_flight": single,
        "admission": batched,
    }


def run_pipeline_benchmark(
    concurrency: int = 32,
    duration_s: float = 8.0,
    n_nodes: int = 8,
    n_pods: int = 16,
    batch_max: int = 32,
    base_port: int = 18380,
    client_procs: int = 0,
    queue_bound: int = 0,
    device: Optional[str] = None,
) -> dict:
    """The pipeline closed loop: the SAME admission server booted twice —
    ``OPENSIM_PIPELINE=off`` (serial inline batches) vs ``on`` (staged
    prep/dispatch/decode) — driven by the same closed-loop loadgen, plus
    the end-to-end placement-parity gate between the two modes and the
    measured prep-under-dispatch overlap scraped from the pipelined
    server's own counters. ``client_procs`` ≥ 2 shards the clients over
    loadgen subprocesses (mandatory fidelity at hundreds of clients). The
    servers run on `device` (the card unless named)."""
    import os
    import tempfile

    stub = _seed_stub(n_nodes, n_pods)
    tmp = tempfile.mkdtemp(prefix="loadgen-pipe-")
    kc = stub.kubeconfig(tmp)
    qb = queue_bound or max(64, 2 * concurrency)

    def drive(url: str) -> dict:
        if client_procs >= 2:
            return run_loadgen_sharded(url, concurrency, duration_s, client_procs)
        return run_loadgen(
            url, mode="closed", concurrency=concurrency, duration_s=duration_s
        )

    try:
        proc, url = _boot_server(
            kc, base_port, admission=True, batch_max=batch_max,
            queue_bound=qb, pipeline=False, device=device,
        )
        try:
            _warm_concurrent(url, min(16, concurrency), 60.0)
            serial = drive(url)
        finally:
            _stop_server(proc)
        pproc, purl = _boot_server(
            kc, base_port + 2, admission=True, batch_max=batch_max,
            queue_bound=qb, pipeline=True, device=device,
        )
        try:
            _warm_concurrent(purl, min(16, concurrency), 60.0)
            before = scrape_metrics(purl)
            piped = drive(purl)
            after = scrape_metrics(purl)
            # parity gate between the two modes, against the same stub
            # cluster: a fresh non-pipelined server answers the same
            # probes the pipelined one does
            sproc, surl = _boot_server(
                kc, base_port + 40, admission=True, batch_max=batch_max,
                pipeline=False, device=device,
            )
            try:
                parity = placement_parity(surl, purl)
            finally:
                _stop_server(sproc)
        finally:
            _stop_server(pproc)
    finally:
        stub.stop()
    overlap_s = _counter_delta(
        before, after, "simon_pipeline_prep_overlap_seconds_total"
    )
    overlapped = _counter_delta(
        before, after, "simon_pipeline_overlapped_batches_total"
    )
    batches = _counter_delta(before, after, "simon_batches_total")
    speedup = piped["qps"] / serial["qps"] if serial["qps"] > 0 else float("inf")
    return {
        "concurrency": concurrency,
        "duration_s": duration_s,
        "nodes": n_nodes,
        "cluster_pods": n_pods,
        "client_procs": client_procs,
        "host_cores": os.cpu_count() or 1,
        "qps_non_pipelined": serial["qps"],
        "qps": piped["qps"],
        "vs_non_pipelined": round(speedup, 2),
        "p50_s": piped["server_p50_s"],
        "p99_s": piped["server_p99_s"],
        "p50_non_pipelined_s": serial["server_p50_s"],
        "p99_non_pipelined_s": serial["server_p99_s"],
        "batches": int(batches),
        "mean_batch_size": piped["mean_batch_size"],
        "overlapped_batches": int(overlapped),
        "prep_overlap_s": round(overlap_s, 4),
        "shed": piped["shed"],
        "errors": piped["errors"],
        "placements_identical": parity,
        "non_pipelined": serial,
        "pipelined": piped,
    }


def run_loadgen_sharded(
    url: str,
    concurrency: int,
    duration_s: float,
    procs: int,
    metrics_url: str = "",
    timeout_s: float = 60.0,
) -> dict:
    """The closed loop sharded over ``procs`` CLIENT PROCESSES: at
    hundreds of concurrent clients a single loadgen process's GIL throttles
    the offered load and bills client-side scheduling to the server.
    Each shard is one ``simon loadgen`` subprocess driving
    ``concurrency/procs`` workers; client-side QPS/shed/error counts sum
    across shards, and the server-side percentiles come from ONE
    before/after scrape of ``metrics_url`` around the whole run (the only
    view that covers every shard's traffic)."""
    import os
    import subprocess
    import sys

    metrics_url = metrics_url or url
    shares = [concurrency // procs] * procs
    for i in range(concurrency % procs):
        shares[i] += 1
    before = scrape_metrics(metrics_url)
    t_start = time.monotonic()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    children = [
        subprocess.Popen(
            [
                sys.executable, "-m", "opensim_tpu_torch", "loadgen", "--url", url,
                "--mode", "closed", "--concurrency", str(share),
                "--duration", str(duration_s), "--timeout", str(timeout_s),
            ],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        )
        for share in shares
        if share > 0
    ]
    reports = []
    try:
        for c in children:
            out, err = c.communicate(timeout=duration_s + 300.0)
            lines = [ln for ln in out.decode().strip().splitlines() if ln.strip()]
            if c.returncode != 0 or not lines:
                raise RuntimeError(
                    f"loadgen shard failed rc={c.returncode}: "
                    f"{(err or out)[-500:].decode(errors='replace')!r}"
                )
            reports.append(json.loads(lines[-1]))
    finally:
        # one failed/hung shard must not leave its siblings hammering the
        # server as orphans (they would skew every later measurement)
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    measured_s = time.monotonic() - t_start
    after = scrape_metrics(metrics_url)
    ok_match = {"endpoint": "deploy-apps", "status": "ok"}
    batches = _counter_delta(before, after, "simon_batches_total")
    batched_reqs = _counter_delta(before, after, "simon_batch_size_sum")
    return {
        "mode": "closed-sharded",
        "client_procs": len(children),
        "duration_s": round(measured_s, 3),
        "concurrency": concurrency,
        "requests": sum(r["requests"] for r in reports),
        "ok": sum(r["ok"] for r in reports),
        "shed": sum(r["shed"] for r in reports),
        "errors": sum(r["errors"] for r in reports),
        "qps": round(sum(r["qps"] for r in reports), 2),
        "client_p99_s": max(
            (r["client_p99_s"] for r in reports if r["client_p99_s"] is not None),
            default=None,
        ),
        "server_p50_s": histogram_quantile(
            before, after, "simon_request_seconds", 0.50, ok_match
        ),
        "server_p99_s": histogram_quantile(
            before, after, "simon_request_seconds", 0.99, ok_match
        ),
        "queue_wait_p99_s": histogram_quantile(
            before, after, "simon_queue_wait_seconds", 0.99
        ),
        "batches": int(batches),
        "batched_requests": int(batched_reqs),
        "mean_batch_size": round(batched_reqs / batches, 2) if batches else 0.0,
        "shards": reports,
    }


# ---------------------------------------------------------------------------
# the fleet closed loop: N worker processes vs one process
# ---------------------------------------------------------------------------


def _canon_response(body: dict) -> tuple:
    """Placement identity view of a deploy response: expanded pod names
    carry per-process random suffixes (NOTES invariant), so pods are
    canonicalized onto their owning workload (the name minus the final
    suffix segment) and compared as (node, workload, count) triples plus
    the unscheduled (workload, reason) set."""
    def canon(ref: str) -> str:
        # strip every trailing generated segment (10-hex expansion
        # counters): a Deployment pod carries TWO — the ReplicaSet's and
        # its own — and the counters are process-global, so they differ
        # across servers by design
        ns, _, name = ref.partition("/")
        parts = name.split("-")
        while len(parts) > 1 and re.fullmatch(r"[0-9a-f]{10}", parts[-1]):
            parts.pop()
        return f"{ns}/{'-'.join(parts)}"

    placed = sorted(
        (e["node"], sorted(canon(p) for p in e["pods"]))
        for e in body.get("nodeStatus", [])
    )
    unsched = sorted(
        (canon(u["pod"]), u["reason"]) for u in body.get("unscheduledPods", [])
    )
    return placed, unsched


def _post_deploy(url: str, payload: bytes, timeout_s: float = 60.0) -> dict:
    req = urllib.request.Request(
        f"{url}/api/deploy-apps", data=payload,
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def placement_parity(url_a: str, url_b: str, n_probes: int = 4) -> bool:
    """The fleet bit-identity gate, end to end over HTTP: the same deploy
    payloads against both servers must place onto the same nodes with the
    same per-workload counts and the same unschedulable reasons."""
    for i in range(n_probes):
        payload = _payload(777, i, 3, "500m", "1Gi")
        a = _canon_response(_post_deploy(url_a, payload))
        b = _canon_response(_post_deploy(url_b, payload))
        if a != b:
            log.warning("placement parity failed on probe %d: %r != %r", i, a, b)
            return False
    return True


def run_fleet_benchmark(
    workers: int = 2,
    concurrency: int = 64,
    duration_s: float = 8.0,
    n_nodes: int = 8,
    n_pods: int = 16,
    batch_max: int = 32,
    base_port: int = 18280,
    queue_bound: int = 0,
    client_procs: int = 0,
    device: Optional[str] = None,
) -> dict:
    """The fleet closed loop: stub apiserver → ONE single-process
    admission server and ONE ``--workers N`` fleet (twin owner + shm
    publication + SO_REUSEPORT workers), the same closed-loop loadgen
    against each, plus the end-to-end placement-parity gate between them.
    The fleet's server-side histograms come from the aggregated admin
    endpoint (scraping the public port would sample one worker).
    ``client_procs`` ≥ 2 shards the clients over that many loadgen
    subprocesses (``run_loadgen_sharded``) — mandatory fidelity at
    hundreds of concurrent clients, where one client process's GIL would
    throttle the offered load for both measurements equally but far below
    what the servers can actually sustain. The servers run on `device`
    (the card unless named)."""
    import tempfile

    stub = _seed_stub(n_nodes, n_pods)
    tmp = tempfile.mkdtemp(prefix="loadgen-fleet-")
    kc = stub.kubeconfig(tmp)
    qb = queue_bound or max(64, 2 * concurrency)

    def drive(url: str, metrics_url: str = "") -> dict:
        # a measured-length warm burst at full concurrency: each worker
        # process pays its first batches' one-time costs (the encode
        # cache's base entry, the attach of a new generation) here, not
        # inside the measured window. Applied to both servers — strictly
        # fair.
        run_loadgen(
            url, mode="closed", concurrency=min(concurrency, 96),
            duration_s=max(3.0, duration_s / 3.0), warmup_requests=0,
            metrics_url=metrics_url,
        )
        if client_procs >= 2:
            return run_loadgen_sharded(
                url, concurrency, duration_s, client_procs,
                metrics_url=metrics_url,
            )
        return run_loadgen(
            url, mode="closed", concurrency=concurrency,
            duration_s=duration_s, metrics_url=metrics_url,
        )

    try:
        proc, url = _boot_server(
            kc, base_port, admission=True, batch_max=batch_max, queue_bound=qb,
            device=device,
        )
        try:
            _warm_concurrent(url, min(16, concurrency), 60.0)
            single = drive(url)
        finally:
            _stop_server(proc)
        fproc, furl = _boot_server(
            kc, base_port + 2, admission=True, batch_max=batch_max,
            workers=workers, queue_bound=qb, device=device,
        )
        admin_url = f"http://127.0.0.1:{base_port + 3}"
        try:
            _warm_concurrent(furl, min(16, concurrency), 60.0)
            fleet = drive(furl, metrics_url=admin_url)
            fleet_metrics = scrape_metrics(admin_url)
            with urllib.request.urlopen(
                f"{admin_url}/api/fleet/status", timeout=5.0
            ) as resp:
                status = json.loads(resp.read().decode())
            # parity gate: re-boot a fresh single-process server so both
            # sides answer the same probes against the same stub cluster
            pproc, purl = _boot_server(
                kc, base_port + 40, admission=True, batch_max=batch_max,
                device=device,
            )
            try:
                parity = placement_parity(purl, furl)
            finally:
                _stop_server(pproc)
        finally:
            _stop_server(fproc)
    finally:
        stub.stop()
    torn = int(
        fleet_metrics.get(("simon_fleet_attach_retries_exhausted_total", ()), 0.0)
    )
    speedup = fleet["qps"] / single["qps"] if single["qps"] > 0 else float("inf")
    return {
        "workers": workers,
        "concurrency": concurrency,
        "duration_s": duration_s,
        "nodes": n_nodes,
        "cluster_pods": n_pods,
        "qps_single_process": single["qps"],
        "qps": fleet["qps"],
        "vs_single_process": round(speedup, 2),
        "p50_s": fleet["server_p50_s"],
        "p99_s": fleet["server_p99_s"],
        "p50_single_process_s": single["server_p50_s"],
        "p99_single_process_s": single["server_p99_s"],
        "batches": fleet["batches"],
        "mean_batch_size": fleet["mean_batch_size"],
        "shed": fleet["shed"],
        "errors": fleet["errors"],
        "placements_identical": parity,
        "torn_generation_exhausted": torn,
        "fleet_generation": int(
            fleet_metrics.get(("simon_fleet_generation", ()), -1.0)
        ),
        "fleet_publishes": int(
            fleet_metrics.get(("simon_fleet_publishes_total", ()), 0.0)
        ),
        "respawns": status.get("respawns_total", 0),
        "single_process": single,
        "fleet": fleet,
    }
