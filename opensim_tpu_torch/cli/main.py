"""simon CLI of the port — ``python -m opensim_tpu_torch {apply, explain,
defrag (drain), campaign, server, top, replay, version}``, the flags of
``opensim_tpu/cli/main.py`` (``cmd/apply/apply.go:27-36``,
``cmd/server/server.go``) plus ``--device`` where a subcommand simulates.
The run goes to the card unless ``--device cpu`` asks for the plain
versions on the CPU; without a card and without that flag each of those
subcommands fails (``server`` before it listens), and nothing falls back
to the CPU. ``top`` and ``campaign --url`` read a running server, which
simulates on its own device; ``replay`` simulates only with
``--schedule``. Log level comes from the ``LogLevel`` env
(``cmd/simon/simon.go:46-66``)."""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

from .. import __version__ as VERSION
from ..utils.validate import user_path

COMMIT_ID = os.environ.get("SIMON_COMMIT_ID", "unknown")

LOG_LEVELS = {
    "panic": logging.CRITICAL,
    "fatal": logging.CRITICAL,
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="simon",
        description="Simon: a cluster simulator for capacity planning, on an NVIDIA card",
    )
    sub = parser.add_subparsers(dest="command")
    apply_p = sub.add_parser(
        "apply", help="run a capacity-planning simulation",
        description="run a capacity-planning simulation (the reference's `simon apply`)",
    )
    apply_p.add_argument("-f", "--simon-config", required=True, help="path of simon config (Config CR yaml)")
    apply_p.add_argument(
        "-d", "--default-scheduler-config", default="",
        help="path of kube-scheduler config overrides (a KubeSchedulerConfiguration)",
    )
    apply_p.add_argument("-o", "--output-file", default="", help="redirect the report to a file")
    apply_p.add_argument("--use-greed", action="store_true", help="use greed algorithm to sort pods")
    apply_p.add_argument(
        "--enable-preemption", action="store_true",
        help="let unschedulable high-priority pods evict lower-priority ones (beyond-reference)",
    )
    apply_p.add_argument("-i", "--interactive", action="store_true", help="interactive add-node mode")
    apply_p.add_argument(
        "-e", "--extended-resources", default="",
        help="comma-separated extended resource reports (gpu,open-local)",
    )
    apply_p.add_argument("--max-new-nodes", type=int, default=128, help="upper bound for the node sweep")
    apply_p.add_argument("--report-pods", action="store_true", help="include the per-node Pod Info table")
    apply_p.add_argument(
        "--trace", default="", metavar="FILE",
        help="Chrome-trace JSON of the run's spans (not yet ported: ROADMAP Queue 1 item 10)",
    )
    apply_p.add_argument(
        "--tie-break", default="lowest", metavar="lowest|sample[:seed]",
        help="equal-score node selection: lowest index, or a seeded uniform draw among the best nodes",
    )
    apply_p.add_argument(
        "--explain", action="store_true",
        help="append the placement audit to the report: per-filter reject totals over every step plus a "
        "kube-style '0/N nodes are available' breakdown for every unschedulable pod",
    )
    device_help = "torch device to run on (default: the CUDA card, an error without one; cpu: the plain versions)"
    apply_p.add_argument("--device", default=None, help=device_help)

    explain_p = sub.add_parser(
        "explain", help="explain why a pod landed where it did (or why it is unschedulable)",
        description=(
            "run the simulation in explain mode and print one pod's placement explanation: the winning node "
            "with its per-plugin score breakdown and runner-up margin, or the kube-style '0/N nodes are "
            "available' per-filter rejection counts. Without a pod argument, prints the audit summary and "
            "every unschedulable pod's breakdown"
        ),
    )
    explain_p.add_argument("-f", "--simon-config", required=True, help="path of simon config (Config CR yaml)")
    explain_p.add_argument(
        "-d", "--default-scheduler-config", default="", help="path of kube-scheduler config overrides"
    )
    explain_p.add_argument(
        "pod", nargs="?", default="", help="pod to explain, as namespace/name (or bare name when unambiguous)"
    )
    explain_p.add_argument("--use-greed", action="store_true", help="use greed algorithm to sort pods")
    explain_p.add_argument("--json", action="store_true", help="emit the explanation(s) as JSON")
    explain_p.add_argument("--device", default=None, help=device_help)

    defrag_p = sub.add_parser(
        "defrag", aliases=["drain"],
        help="evaluate node-drain what-ifs (the README's Pods Migration feature, batch-evaluated)",
        description="evaluate node-drain what-ifs (Pods Migration), batch-evaluated as scenarios: one launch of "
        "the scenario grid on the card",
    )
    defrag_p.add_argument("-f", "--simon-config", required=True, help="path of simon config (Config CR yaml)")
    defrag_p.add_argument("--candidates", default="", help="comma-separated node names to evaluate (default: all)")
    defrag_p.add_argument(
        "--json", action="store_true",
        help="emit the drain plan as JSON (the same table rows the text renderer prints)",
    )
    defrag_p.add_argument("-o", "--output-file", default="", help="redirect the report to a file")
    defrag_p.add_argument("--device", default=None, help=device_help)

    campaign_p = sub.add_parser(
        "campaign", help="run a cluster-lifecycle campaign (drain waves, reclaim storms, scored what-ifs)",
        description=(
            "execute a declarative lifecycle campaign: an ordered list of typed steps — PDB-aware drain waves, "
            "spot reclaim storms, deploys/scales, add-nodes, scale-down safety checks, defrag plans — evaluated "
            "against the spec's cluster (or a live server with --url) with every step scored by the capacity "
            "observatory: placements delta, disruption budget consumed, utilization/fragmentation/headroom "
            "movement, and a bit-stable step fingerprint"
        ),
    )
    campaign_p.add_argument("spec", help="campaign spec yaml (kind: Campaign)")
    campaign_p.add_argument("--json", action="store_true", help="print the full result JSON instead of tables")
    campaign_p.add_argument(
        "--exec", dest="exec_mode", default="", choices=["", "warm", "cold"],
        help="execution mode override (default OPENSIM_CAMPAIGN_EXEC): warm = one full prepare + prepcache "
        "deltas; cold = per-step full prepare (the verification mode)",
    )
    campaign_p.add_argument(
        "--url", default="",
        help="POST the campaign's steps to a live server's /api/campaign and evaluate against its observed "
        "cluster instead of the spec's cluster section",
    )
    campaign_p.add_argument("--timeout", type=float, default=600.0, help="--url request timeout seconds")
    campaign_p.add_argument("-o", "--output-file", default="", help="also write the result to a file")
    campaign_p.add_argument("--device", default=None, help=device_help)

    server_p = sub.add_parser(
        "server", help="start the simon REST server",
        description="start the simon REST server (deploy-apps / scale-apps / healthz / metrics)",
    )
    server_p.add_argument("--kubeconfig", default="", help="kubeconfig of the real cluster")
    server_p.add_argument("--master", default="", help="apiserver address override")
    server_p.add_argument("--port", type=int, default=8080, help="listen port")
    server_p.add_argument(
        "--watch", default="auto", choices=["auto", "on", "off"],
        help="live-twin mode: consume the cluster's watch streams and keep an always-warm incremental snapshot. "
        "auto = watch, serving the polling snapshot (re-listed every 30 s) until the twin syncs; on = require "
        "the twin to sync at start; off = polling only",
    )
    server_p.add_argument(
        "--access-log", action="store_true",
        help="emit one JSON access-log line per request (request id, endpoint, status, duration) — same as "
        "OPENSIM_ACCESS_LOG=1",
    )
    server_p.add_argument("--workers", type=int, default=0,
                          help="serve through a multi-process fleet: a twin-owner process publishes its warm "
                          "snapshot over shared memory and N worker processes (2 or more) attach it and serve the "
                          "port via SO_REUSEPORT, each launching the kernels on the card (needs --kubeconfig and "
                          "the live twin; the owner's admin endpoint listens on port + 1; default "
                          "OPENSIM_WORKERS_FLEET, 0/1 = one process)")
    server_p.add_argument("--journal", default="",
                          help="crash-safe watch-event journal directory: the twin restores from its newest "
                          "checkpoint and the records after it at start, and records every accepted event "
                          "(needs the live twin)")
    server_p.add_argument("--standby", action="store_true",
                          help="run as the HA hot standby: tail the fleet owner's --journal and take over the "
                          "fleet, adopting its surviving workers, when the owner's lease (OPENSIM_HA=1) expires "
                          "or is handed over; admin endpoint on port + 16")
    server_p.add_argument("--handover", action="store_true",
                          help="with --standby: once the journal tail reaches parity, ask the live owner to hand "
                          "over (a rolling upgrade); without it the standby takes over only on lease expiry")
    server_p.add_argument("--device", default=None, help=device_help)

    top_p = sub.add_parser(
        "top", help="live cluster capacity view (utilization, headroom, fragmentation)",
        description=(
            "render a live capacity view of the cluster a simon server observes: per-resource "
            "utilization/spread/fragmentation, headroom per registered workload profile, the hottest nodes and "
            "pending pressure — read from GET /api/cluster/report, the same computation path as the text report "
            "tables. One shot by default; --watch refreshes in place like kubectl top"
        ),
    )
    top_p.add_argument("--url", required=True, help="base URL of the live server (http://host:port)")
    top_p.add_argument("--json", action="store_true", help="print the raw report JSON instead of tables")
    top_p.add_argument("--watch", action="store_true", help="refresh the view in place until interrupted (Ctrl-C exits)")
    top_p.add_argument("--interval", type=float, default=2.0, help="--watch refresh interval in seconds (default 2)")
    top_p.add_argument(
        "--no-headroom", action="store_true",
        help="skip the headroom probes (cheaper polling; utilization/fragmentation only)",
    )
    top_p.add_argument(
        "-e", "--extended-resources", default="", help="comma-separated extended resource sections (gpu,open-local)",
    )
    top_p.add_argument("--timeout", type=float, default=60.0, help="per-request client timeout seconds")
    replay_p = sub.add_parser(
        "replay", help="reconstruct and replay a recorded watch-event journal",
        description=(
            "replay a journal recorded by `simon server --journal`: reconstruct the live twin at any recorded "
            "generation and stream the accepted event history — at N× recorded speed or as fast as possible — "
            "through the apply path the live dispatch uses, feeding the capacity observatory as it goes. Prints "
            "one JSON summary line: record counts, final generation, the reconstructed twin's content "
            "fingerprint, event throughput and the final capacity sample. --schedule also places a probe "
            "Deployment on the reconstructed cluster through the kernel on the card"
        ),
    )
    replay_p.add_argument("journal", help="journal directory recorded by `simon server --journal`")
    replay_p.add_argument("--speed", type=float, default=0.0,
                          help="pace the stream at N× the recorded inter-event gaps (0 = as fast as possible, the "
                          "default; gaps clamp at 30s)")
    replay_p.add_argument("--at-generation", type=int, default=None, metavar="G",
                          help="stop once the twin reaches generation G (default: the full history)")
    replay_p.add_argument("--capacity", action=argparse.BooleanOptionalAction, default=True,
                          help="feed the capacity observatory during replay and include the final "
                          "utilization/fragmentation sample in the summary")
    replay_p.add_argument("--schedule", type=int, default=0, metavar="PODS",
                          help="after replay, schedule a Deployment of PODS replicas (100m, 256Mi) onto the "
                          "reconstructed cluster and report placements")
    replay_p.add_argument("--events", action="store_true",
                          help="also print one JSON line per replayed record (type, generation, resource) before the "
                          "summary")
    replay_p.add_argument("-o", "--output-file", default="", help="also write the JSON summary to a file")
    replay_p.add_argument("--device", default=None, help=device_help)
    sub.add_parser("version", help="print version", description="print version and commit id")
    return parser


def run_apply(args) -> int:
    from ..planner.apply import Applier, Options

    if args.trace:
        raise NotImplementedError("simon apply --trace: ROADMAP Queue 1 item 10, not yet ported")
    opts = Options(
        simon_config=user_path(args.simon_config, label="--simon-config"),
        default_scheduler_config=user_path(args.default_scheduler_config, label="--default-scheduler-config",
                                           allow_empty=True),
        output_file=user_path(args.output_file, label="--output-file", allow_empty=True),
        use_greed=args.use_greed,
        enable_preemption=args.enable_preemption,
        interactive=args.interactive,
        extended_resources=[r for r in args.extended_resources.split(",") if r],
        report_pods=args.report_pods,
        max_new_nodes=args.max_new_nodes,
        tie_break=args.tie_break,
        explain=args.explain,
        device=args.device,
    )
    return Applier(opts).run()


def _render_explanation(e, out) -> None:
    """One PlacementExplanation as ``simon explain`` prints it."""
    from ..engine import reasons

    print(f"pod {e.pod}: {e.status}" + (f" on {e.node}" if e.node else "")
          + (" (pre-bound; bypassed the scheduler)" if e.forced else ""), file=out)
    if e.message:
        print(f"  {e.message}", file=out)
    for line in reasons.count_lines(e.reasons):
        print(f"  {line}", file=out)
    if e.scores:
        print(f"  per-plugin score breakdown on {e.node}:", file=out)
        width = max(len(k) for k in e.scores)
        for k, v in e.scores.items():
            print(f"    {k:<{width}}  {v:10.4f}", file=out)
        print(f"    {'total':<{width}}  {e.score:10.4f}", file=out)
        if e.runner_up is not None:
            print(f"  margin {e.margin:.4f} over runner-up {e.runner_up}", file=out)


def run_explain(args) -> int:
    """``simon explain``: one simulation in explain mode, then the named
    pod's deep explanation (score breakdown or rejection counts) or,
    without a pod, the audit summary (``opensim_tpu/cli/main.py:1196-1264``)."""
    import json

    from ..engine import explain, reasons
    from ..engine.simulator import simulate
    from ..planner.apply import Applier, Options

    applier = Applier(Options(
        simon_config=user_path(args.simon_config, label="--simon-config"),
        default_scheduler_config=user_path(args.default_scheduler_config, label="--default-scheduler-config",
                                           allow_empty=True),
        use_greed=args.use_greed,
        device=args.device,
    ))
    result = simulate(applier.load_cluster(), applier.load_apps(), use_greed=args.use_greed,
                      sched_config=applier.sched_config, device=applier.device, explain=True)
    ctx = result.explain_ctx
    if ctx is None:
        print("simon explain: the simulation produced no decisions (no pods)", file=sys.stderr)
        return 1
    out = sys.stdout
    if args.pod:
        idx = ctx.index_of(args.pod)
        if idx is None:
            known = sorted(f"{p.metadata.namespace}/{p.metadata.name}" for p in ctx.prep.ordered)
            preview = ", ".join(known[:8]) + (", …" if len(known) > 8 else "")
            print(f"simon explain: no pod named {args.pod!r} in the simulated stream ({len(known)} pods: {preview})",
                  file=sys.stderr)
            return 1
        deep = explain.explain_pod(ctx, idx)
        if args.json:
            print(json.dumps(deep.to_dict(), indent=2))
        else:
            _render_explanation(deep, out)
        return 0
    bad = [e for e in result.explanations if e.status != "scheduled"]
    if args.json:
        print(json.dumps({"engine": result.engine, "filter_rejects": result.filter_rejects or {},
                          "unschedulable": [e.to_dict() for e in bad]}, indent=2))
        return 0
    print(f"engine: {result.engine}", file=out)
    if result.filter_rejects:
        print("filter rejects (nodes rejected per filter, all steps): " + reasons.format_rejects(result.filter_rejects),
              file=out)
    print(f"{len(result.explanations) - len(bad)} pod(s) scheduled, {len(bad)} not", file=out)
    for e in bad:
        _render_explanation(e, out)
    return 0


def run_defrag(args) -> int:
    """``simon defrag`` / ``simon drain``: batch-evaluated node-drain
    what-ifs, one launch of the scenario grid on the card. Text and
    ``--json`` both serialize the same rows (``report.drain_plan_rows``)."""
    import json

    from ..planner.apply import Applier, Options
    from ..planner.defrag import plan_drains
    from ..planner.report import _table, drain_plan_rows

    applier = Applier(Options(simon_config=user_path(args.simon_config, label="--simon-config"), device=args.device))
    cluster = applier.load_cluster()
    apps = applier.load_apps()
    candidates = [c.strip() for c in args.candidates.split(",") if c.strip()] or None
    if candidates:
        known = {n.metadata.name for n in cluster.nodes}
        unknown = [c for c in candidates if c not in known]
        if unknown:
            print(f"simon defrag: unknown node(s): {', '.join(unknown)}", file=sys.stderr)
            return 1
    result = plan_drains(cluster, apps, candidates=candidates, device=applier.device)
    rows = drain_plan_rows(result.plans)
    out = open(user_path(args.output_file, label="--output-file"), "w") if args.output_file else sys.stdout
    try:
        if args.json:
            print(json.dumps({"table": {"header": rows[0], "rows": rows[1:]}, "drainable": len(result.drainable()),
                              "total": len(result.plans)}, sort_keys=True), file=out)
        else:
            print("Drain Plan", file=out)
            _table(rows, out)
            print(f"\n{len(result.drainable())}/{len(result.plans)} node(s) drainable", file=out)
    finally:
        if args.output_file:
            out.close()
    return 0


def run_campaign_cmd(args) -> int:
    """``simon campaign <spec.yaml>``: execute a lifecycle campaign against
    the spec's cluster on this process's device, or — with ``--url`` —
    POST its steps to a live server's ``/api/campaign`` (evaluated against
    its observed cluster on its device). Text and ``--json`` both
    serialize the same table rows."""
    import json

    from ..planner import campaign as campaign_mod
    from ..planner.report import render_campaign

    spec_path = user_path(args.spec, label="spec")
    spec = campaign_mod.load_campaign(spec_path)
    if args.url:
        import urllib.error
        import urllib.request

        import yaml

        with open(spec_path) as fh:
            doc = yaml.safe_load(fh) or {}
        body = json.dumps({"name": spec.name, "steps": (doc.get("spec") or {}).get("steps") or [],
                           **({"mode": args.exec_mode} if args.exec_mode else {})}).encode()
        req = urllib.request.Request(f"{args.url.rstrip('/')}/api/campaign", data=body,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=args.timeout) as resp:
                result = json.load(resp)
        except urllib.error.HTTPError as e:
            try:
                detail = json.load(e)
            except ValueError:
                detail = {"error": str(e)}
            print(f"simon campaign: HTTP {e.code}: {detail.get('error', e)}", file=sys.stderr)
            return 1
    else:
        cluster = campaign_mod.load_campaign_cluster(spec)
        result = campaign_mod.run_campaign(cluster, spec, mode=args.exec_mode or None, device=args.device).to_dict()
    if args.json:
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        render_campaign(result, sys.stdout)
    if args.output_file:
        with open(user_path(args.output_file, label="--output-file"), "w") as fh:
            fh.write(json.dumps(result, sort_keys=True) + "\n")
    # a campaign that left evictions blocked or pods unschedulable is a
    # finding, not a failure: exit 0 with the verdict in the report
    return 0


def run_top(args) -> int:
    """``simon top``: the capacity observatory's view — fetch
    ``/api/cluster/report`` and render the same numbers the report tables
    carry (one shot, ``--json``, or a ``--watch`` refresh loop)."""
    import json
    import time
    import urllib.error
    import urllib.parse
    import urllib.request

    from ..obs.capacity import format_top

    params = {}
    if args.no_headroom:
        params["headroom"] = "0"
    extended = [e for e in args.extended_resources.split(",") if e]
    if extended:
        params["extended"] = ",".join(extended)
    url = f"{args.url.rstrip('/')}/api/cluster/report"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    while True:
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                report = json.load(resp)
        except (urllib.error.URLError, OSError, ValueError) as e:
            if args.watch:
                # a dashboard survives server restarts and transient blips
                # (watch(1)/kubectl top semantics): report in place, keep polling
                print(f"\x1b[2J\x1b[Hsimon top: {url}: {e} (retrying)", flush=True)
                time.sleep(max(0.1, args.interval))
                continue
            print(f"simon top: {url}: {e}", file=sys.stderr)
            return 1
        rendered = json.dumps(report, indent=2, sort_keys=True) if args.json else format_top(report).rstrip("\n")
        if not args.watch:
            print(rendered)
            return 0
        # clear + home, like watch(1)/kubectl top: the view refreshes in place
        print(f"\x1b[2J\x1b[H{rendered}", flush=True)
        time.sleep(max(0.1, args.interval))


def run_replay(args) -> int:
    """``simon replay <journal>``: stream the recorded accepted-event
    history through the live apply path, optionally paced, feeding the
    capacity observatory and, with ``--schedule``, ``simulate()`` on the
    card; one JSON summary line (``opensim_tpu/cli/main.py:1074-1160``)."""
    import json
    import time

    from ..server.journal import replay_events

    journal = user_path(args.journal, label="journal")
    if not os.path.isdir(journal):
        print(f"simon replay: {journal}: not a journal directory", file=sys.stderr)
        return 1
    capacity = None
    if args.capacity:
        from ..obs.capacity import CapacityEngine

        capacity = CapacityEngine()
    counts = {"ev": 0, "rb": 0, "ck": 0}
    twin = None
    t0 = time.time()
    for rec, twin, change in replay_events(journal, speed=args.speed, at_generation=args.at_generation):
        counts[str(rec.get("t"))] = counts.get(str(rec.get("t")), 0) + 1
        if capacity is not None:
            capacity.on_replay(rec, twin, change)
        if args.events:
            print(json.dumps({"type": rec.get("t"), "generation": rec.get("gen"), "resource": rec.get("f", ""),
                              "event": rec.get("k", "")}, sort_keys=True))
    wall_s = time.time() - t0
    if twin is None:
        print(f"simon replay: {journal}: no replayable records", file=sys.stderr)
        return 1
    summary = {
        "journal": args.journal,
        "records": sum(counts.values()),
        "events": counts.get("ev", 0),
        "rebases": counts.get("rb", 0),
        "checkpoints": counts.get("ck", 0),
        "generation": twin.generation,
        "fingerprint": twin.fingerprint(),
        "wall_s": round(wall_s, 3),
        "speed": args.speed,
        "events_per_s": round(counts.get("ev", 0) / wall_s, 1) if wall_s > 0 else 0.0,
    }
    if capacity is not None:
        s = capacity.sample()
        if s is not None:
            summary["capacity"] = {
                "nodes": s.nodes, "pods_bound": s.pods_bound, "pods_pending": s.pods_pending,
                "utilization": {k: round(v, 4) for k, v in s.utilization.items()},
                "fragmentation": {k: round(v, 4) for k, v in s.fragmentation.items()},
            }
    if args.schedule > 0:
        # the reconstructed twin is schedulable state, not a data dump: a
        # probe Deployment placed on it through the kernel
        from ..engine.simulator import AppResource, simulate
        from ..models import fixtures as fx
        from ..models.objects import ResourceTypes

        rt = ResourceTypes()
        rt.deployments.append(fx.make_fake_deployment("replay-probe", args.schedule, "100m", "256Mi"))
        t1 = time.time()
        result = simulate(twin.materialize(), [AppResource("replay", rt)], device=args.device)
        summary["schedule"] = {
            "requested": args.schedule,
            "scheduled": args.schedule - len(result.unscheduled_pods),
            "unscheduled": len(result.unscheduled_pods),
            "wall_s": round(time.time() - t1, 3),
        }
    line = json.dumps(summary, sort_keys=True)
    print(line)
    if args.output_file:
        with open(user_path(args.output_file, label="--output-file"), "w") as f:
            f.write(line + "\n")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    level = LOG_LEVELS.get(os.environ.get("LogLevel", "info").lower(), logging.INFO)
    logging.basicConfig(level=level, format="%(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    if args.command == "version":
        print(f"simon version: {VERSION}, commit: {COMMIT_ID}")
        return 0
    if args.command == "server":
        from ..server.rest import serve

        if args.access_log:
            os.environ["OPENSIM_ACCESS_LOG"] = "1"
        try:
            return serve(kubeconfig=args.kubeconfig, master=args.master, port=args.port, watch=args.watch,
                         journal=args.journal, workers=args.workers, standby=args.standby,
                         ha_handover=args.handover, device=args.device)
        except (OSError, ValueError, RuntimeError, NotImplementedError) as e:
            # a bad path, a busy port, no card without --device cpu,
            # --watch on without a kubeconfig or a twin that cannot sync:
            # refused before it listens
            print(f"simon server: {e}", file=sys.stderr)
            return 1
    if args.command == "top":
        try:
            return run_top(args)
        except KeyboardInterrupt:
            return 0
    runs = {"apply": run_apply, "explain": run_explain, "defrag": run_defrag, "drain": run_defrag,
            "campaign": run_campaign_cmd, "replay": run_replay}
    if args.command in runs:
        try:
            return runs[args.command](args)
        except (OSError, ValueError, RuntimeError, NotImplementedError) as e:
            # no card without --device cpu (RuntimeError) and the modes of
            # later slices (NotImplementedError) fail like a bad input
            print(f"simon {args.command}: {e}", file=sys.stderr)
            return 1
    build_parser().print_help()
    return 0
