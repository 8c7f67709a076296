"""simon CLI of the port — ``python -m opensim_tpu_torch {apply, version}``,
the ``apply`` flags of ``opensim_tpu/cli/main.py`` (``cmd/apply/apply.go:
27-36``) plus ``--device``. The run goes to the card unless ``--device
cpu`` asks for the plain versions on the CPU; without a card and without
that flag ``apply`` fails, and nothing falls back to the CPU. Log level
comes from the ``LogLevel`` env (``cmd/simon/simon.go:46-66``)."""

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
        help="path of kube-scheduler config overrides (not yet ported: ROADMAP Queue 1 item 5)",
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
        help="equal-score node selection: lowest index (sample is not yet ported: ROADMAP Queue 1 item 5)",
    )
    apply_p.add_argument(
        "--explain", action="store_true",
        help="append the placement audit to the report (not yet ported: ROADMAP Queue 1 item 5)",
    )
    apply_p.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the CUDA card, an error without one; cpu: the plain versions)",
    )
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


def main(argv: Optional[List[str]] = None) -> int:
    level = LOG_LEVELS.get(os.environ.get("LogLevel", "info").lower(), logging.INFO)
    logging.basicConfig(level=level, format="%(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    if args.command == "version":
        print(f"simon version: {VERSION}, commit: {COMMIT_ID}")
        return 0
    if args.command == "apply":
        try:
            return run_apply(args)
        except (OSError, ValueError, RuntimeError, NotImplementedError) as e:
            # no card without --device cpu (RuntimeError) and the modes of
            # later slices (NotImplementedError) fail like a bad input
            print(f"simon apply: {e}", file=sys.stderr)
            return 1
    build_parser().print_help()
    return 0
