"""simon CLI of the port — ``python -m opensim_tpu_torch {apply, explain,
version}``, the ``apply`` and ``explain`` flags of
``opensim_tpu/cli/main.py`` (``cmd/apply/apply.go:27-36``) plus
``--device``. The run goes to the card unless ``--device cpu`` asks for
the plain versions on the CPU; without a card and without that flag
``apply`` and ``explain`` fail, and nothing falls back to the CPU. Log
level comes from the ``LogLevel`` env (``cmd/simon/simon.go:46-66``)."""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

from .. import __version__ as VERSION

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
    sub.add_parser("version", help="print version", description="print version and commit id")
    return parser


def _user_path(p: str, label: str, allow_empty: bool = False) -> str:
    """Reject an empty required path and control characters in any path."""
    if not p:
        if allow_empty:
            return p
        raise ValueError(f"empty {label}")
    if any(ord(c) < 32 for c in p):
        raise ValueError(f"invalid {label}: control character in {p!r}")
    return p


def run_apply(args) -> int:
    from ..planner.apply import Applier, Options

    if args.trace:
        raise NotImplementedError("simon apply --trace: ROADMAP Queue 1 item 10, not yet ported")
    opts = Options(
        simon_config=_user_path(args.simon_config, "--simon-config"),
        default_scheduler_config=_user_path(args.default_scheduler_config, "--default-scheduler-config",
                                            allow_empty=True),
        output_file=_user_path(args.output_file, "--output-file", allow_empty=True),
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
        simon_config=_user_path(args.simon_config, "--simon-config"),
        default_scheduler_config=_user_path(args.default_scheduler_config, "--default-scheduler-config",
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


def main(argv: Optional[List[str]] = None) -> int:
    level = LOG_LEVELS.get(os.environ.get("LogLevel", "info").lower(), logging.INFO)
    logging.basicConfig(level=level, format="%(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    if args.command == "version":
        print(f"simon version: {VERSION}, commit: {COMMIT_ID}")
        return 0
    if args.command in ("apply", "explain"):
        try:
            return run_apply(args) if args.command == "apply" else run_explain(args)
        except (OSError, ValueError, RuntimeError, NotImplementedError) as e:
            # no card without --device cpu (RuntimeError) and the modes of
            # later slices (NotImplementedError) fail like a bad input
            print(f"simon {args.command}: {e}", file=sys.stderr)
            return 1
    build_parser().print_help()
    return 0
