"""Capacity planner — the port of ``opensim_tpu/planner/apply.py``, parity
with ``pkg/apply/apply.go``.

``Applier.run()`` mirrors ``Applier.Run`` (``apply.go:103-267``): load the
cluster (a YAML directory), render each app (a chart or a YAML
directory), load the candidate new-node template, then find the minimum
number of new nodes that schedules everything within the ``MaxCPU``/
``MaxMemory``/``MaxVG`` occupancy caps (``satisfyResourceSetting``,
``apply.go:689-775``).

Where the reference re-simulates one candidate count at a time behind an
interactive prompt (``apply.go:203-259``), the default mode evaluates a
batch of candidate counts as the scenarios of one sweep
(``parallel/scenarios.sweep_counts``: one launch of the bind-scan kernel's
scenario grid on a card), coarse then fine, and re-simulates the answer
over the same prepared input with the node axis masked.
``--interactive`` keeps the reference's prompt loop. With JAX_COORDINATOR
set, the run first joins the job of ranks (``parallel/multihost.py``), and
every one-config sweep splits over the ranks, each deciding from the
gathered result.

A scheduler config (``-d``, ``engine/schedconfig.py``) goes to the first
simulation, both sweeps and the re-simulation, all on the kernel; the
sampled tie-break (``--tie-break sample[:seed]``) to the simulations,
while the sweeps keep the lowest index, as the reference's planner does.
``--explain`` runs the first simulation and the re-simulation in explain
mode and appends the placement audit to the report (the interactive
loop's simulations run without it, as the reference's do). A
``kubeConfig`` cluster is listed from its apiserver
(``server/snapshot.cluster_from_kubeconfig``).
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, TextIO, Tuple

import numpy as np

from ..device import resolve_device
from ..encoding.vocab import RES_CPU, RES_MEMORY
from ..engine import prepcache, reasons
from ..engine.schedconfig import load_scheduler_config
from ..engine.simulator import (
    AppResource,
    SimulateResult,
    parse_tie_break,
    prepare,
    restore_bind_state,
    simulate,
    snapshot_bind_state,
)
from ..models import expand
from ..models.objects import ENV_MAX_CPU, ENV_MAX_MEMORY, ENV_MAX_VG, Node, ResourceTypes
from ..parallel import multihost, scenarios
from ..utils.progress import Spinner
from . import report as report_mod


@dataclass
class SimonConfig:
    """The simon/v1alpha1 Config CR (pkg/api/v1alpha1/types.go:3-29)."""

    name: str = ""
    custom_cluster: str = ""
    kube_config: str = ""
    app_list: List[dict] = field(default_factory=list)  # {name, path, chart}
    new_node: str = ""

    @classmethod
    def load(cls, path: str) -> "SimonConfig":
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f)
        if not isinstance(doc, dict) or doc.get("kind") != "Config":
            raise ValueError(f"{path}: not a simon Config CR")
        spec = doc.get("spec") or {}
        cluster = spec.get("cluster") or {}
        cfg = cls(
            name=(doc.get("metadata") or {}).get("name", ""),
            custom_cluster=cluster.get("customConfig", "") or "",
            kube_config=cluster.get("kubeConfig", "") or "",
            app_list=list(spec.get("appList") or []),
            new_node=spec.get("newNode", "") or "",
        )
        if not cfg.custom_cluster and not cfg.kube_config:
            raise ValueError("config: spec.cluster needs customConfig or kubeConfig")
        return cfg


@dataclass
class Options:
    simon_config: str = ""
    default_scheduler_config: str = ""
    output_file: str = ""
    use_greed: bool = False
    enable_preemption: bool = False
    interactive: bool = False
    extended_resources: List[str] = field(default_factory=list)
    report_pods: bool = False  # include the per-node Pod Info table
    max_new_nodes: int = 128  # sweep upper bound (auto mode)
    tie_break: str = "lowest"  # lowest | sample[:seed] (simulator.parse_tie_break)
    explain: bool = False  # append the placement audit (explain mode)
    device: Optional[str] = None  # None: the card (raises without one); "cpu": the plain versions


def _resolve(base: str, path: str) -> str:
    return path if os.path.isabs(path) or not base else os.path.join(base, path)


def resource_caps() -> tuple:
    """MaxCPU / MaxMemory / MaxVG env caps (apply.go:689-719): percentages,
    values outside [0, 100] fall back to 100."""
    caps = []
    for env in (ENV_MAX_CPU, ENV_MAX_MEMORY, ENV_MAX_VG):
        raw = os.environ.get(env, "")
        val = 100
        if raw:
            try:
                val = int(raw)
            except ValueError as e:
                raise ValueError(f"failed to convert env {env} to int: {e}")
            if val > 100 or val < 0:
                val = 100
        caps.append(val)
    return tuple(caps)


def satisfy_resource_setting(result: SimulateResult) -> tuple:
    """(ok, reason) — cluster-wide occupancy vs the env caps."""
    max_cpu, max_mem, max_vg = resource_caps()
    total_cpu = total_mem = used_cpu = used_mem = 0.0
    vg_cap = vg_req = 0.0
    for status in result.node_status:
        node = status.node
        total_cpu += node.allocatable.get("cpu", 0.0)
        total_mem += node.allocatable.get("memory", 0.0)
        for pod in status.pods:
            req = pod.resource_requests()
            used_cpu += req.get("cpu", 0.0)
            used_mem += req.get("memory", 0.0)
        anno = node.metadata.annotations.get("simon/node-local-storage")
        if anno:
            try:
                for vg in json.loads(anno).get("vgs") or []:
                    vg_cap += float(vg.get("capacity", 0) or 0)
                    vg_req += float(vg.get("requested", 0) or 0)
            except ValueError:
                pass
    if total_cpu > 0 and int(used_cpu / total_cpu * 100) > max_cpu:
        return False, (
            f"the average occupancy rate({int(used_cpu / total_cpu * 100)}%) of cpu "
            f"goes beyond the env setting({max_cpu}%)"
        )
    if total_mem > 0 and int(used_mem / total_mem * 100) > max_mem:
        return False, (
            f"the average occupancy rate({int(used_mem / total_mem * 100)}%) of memory "
            f"goes beyond the env setting({max_mem}%)"
        )
    if vg_cap > 0 and int(vg_req / vg_cap * 100) > max_vg:
        return False, (
            f"the average occupancy rate({int(vg_req / vg_cap * 100)}%) of vg "
            f"goes beyond the env setting({max_vg}%)"
        )
    return True, ""


class Applier:
    """One ``simon apply`` run. After :meth:`run`, ``timings`` holds the
    host-clock seconds of each step that ran (``load``, ``simulate``,
    ``delta re-encode`` or ``prepare``, ``sweep``, ``re-simulate``,
    ``report``), ``first_result`` the first simulation's result (its
    unscheduled pods are what the new nodes must place), ``sweeps`` each
    sweep's candidate counts and seconds in order, ``prep_full`` the prepared cluster with every candidate node
    that the sweeps and the masked re-simulation ran on, and ``n_new`` the
    new-node count found."""

    def __init__(self, opts: Options) -> None:
        self.opts = opts
        # the sampled tie-break applies to the simulations; the capacity
        # sweeps keep the lowest index (one packing per candidate count)
        self.tie_seed = parse_tie_break(opts.tie_break)
        self.sched_config = (load_scheduler_config(opts.default_scheduler_config)
                             if opts.default_scheduler_config else None)
        self.device = resolve_device(opts.device)
        self.config = SimonConfig.load(opts.simon_config)
        self.base = os.path.dirname(os.path.abspath(opts.simon_config))
        self.out: TextIO = sys.stdout
        # interactive-mode input source: prompts render through self.out
        # like every other line, and the line reader is injectable so
        # scripted runs and tests drive the survey loop without a
        # terminal. It raises EOFError when the source is exhausted (the
        # prompt loops treat EOF as Exit).
        self.input_fn: Callable[[], str] = input
        self.timings: Dict[str, float] = {}
        self.first_result: Optional[SimulateResult] = None
        self.sweeps: List[Tuple[List[int], float]] = []
        self.prep_full = None
        self.n_new: Optional[int] = None

    # -- input loading ------------------------------------------------------

    def load_cluster(self) -> ResourceTypes:
        if self.config.kube_config:
            from ..server.snapshot import cluster_from_kubeconfig

            return cluster_from_kubeconfig(_resolve(self.base, self.config.kube_config))
        return expand.load_cluster_from_dir(_resolve(self.base, self.config.custom_cluster))

    def load_apps(self) -> List[AppResource]:
        apps = []
        for app in self.config.app_list:
            path = _resolve(self.base, app.get("path", ""))
            if app.get("chart"):
                from ..chart.render import process_chart

                docs = expand.decode_yaml_strings(process_chart(app.get("name", ""), path))
            else:
                docs = expand.load_yaml_objects(path)
            rt, _ = expand.resources_from_dicts(docs)
            apps.append(AppResource(name=app.get("name", ""), resources=rt))
        return apps

    def load_new_node(self) -> Optional[Node]:
        if not self.config.new_node:
            return None
        rt = expand.load_cluster_from_dir(_resolve(self.base, self.config.new_node))
        return rt.nodes[0] if rt.nodes else None

    # -- capacity search ----------------------------------------------------

    def _cluster_with_new_nodes(self, cluster: ResourceTypes, template: Node, count: int) -> ResourceTypes:
        new_cluster = copy.copy(cluster)
        new_cluster.nodes = list(cluster.nodes) + expand.new_fake_nodes(template, count)
        return new_cluster

    def find_min_nodes_batched(self, prep, n_real: int) -> Optional[int]:
        """Evaluate candidate new-node counts 0..max as the scenarios of
        sweeps over an existing Prepared (the cluster plus `max_new_nodes`
        candidates); return the minimal feasible count (caps included), or
        None. A coarse geometric sweep finds the feasibility bracket, then
        one fine sweep searches inside it. Feasibility is usually monotone
        in the node count, but per-node DaemonSet load against the
        occupancy caps can break that, so a coarse sweep with no feasible
        count is followed by the remaining counts in ascending chunks."""
        kmax = self.opts.max_new_nodes
        if prep is None:
            return 0
        coarse = sorted({0, kmax} | {2**i for i in range(kmax.bit_length()) if 2**i <= kmax})
        ok = self._feasible_counts(prep, n_real, coarse)
        feasible_ks = [k for k, good in zip(coarse, ok) if good]
        if not feasible_ks:
            rest = [k for k in range(kmax + 1) if k not in set(coarse)]
            chunk = 32
            for lo in range(0, len(rest), chunk):
                batch = rest[lo : lo + chunk]
                ok = self._feasible_counts(prep, n_real, batch)
                feasible_rest = [k for k, good in zip(batch, ok) if good]
                if feasible_rest:
                    return min(feasible_rest)
            return None
        hi = min(feasible_ks)
        lo = max([k for k in coarse if k < hi], default=0)
        if hi == 0 or hi == lo + 1:
            return int(hi)
        fine = list(range(lo + 1, hi))
        ok = self._feasible_counts(prep, n_real, fine)
        for k, good in zip(fine, ok):
            if good:
                return int(k)
        return int(hi)

    def _feasible_counts(self, prep, n_real: int, ks: List[int]) -> List[bool]:
        """One sweep over candidate new-node counts; a count is feasible
        when everything schedules within the env caps."""
        t0 = time.perf_counter()
        res, node_valid = scenarios.sweep_counts(prep, n_real, ks, config=self.sched_config)
        self.sweeps.append((list(ks), time.perf_counter() - t0))
        max_cpu, max_mem, max_vg = resource_caps()
        alloc = np.asarray(prep.ec_np.alloc)
        vg_caps = np.asarray(prep.meta.node_vg_cap).sum(axis=-1)  # [N]
        out = []
        for s in range(len(ks)):
            if res.unscheduled[s] > 0:
                out.append(False)
                continue
            nv = node_valid[s]
            tot_cpu = float(alloc[nv, RES_CPU].sum())
            tot_mem = float(alloc[nv, RES_MEMORY].sum())
            cpu_occ = int(res.used[s, nv, RES_CPU].sum() / tot_cpu * 100) if tot_cpu else 0
            mem_occ = int(res.used[s, nv, RES_MEMORY].sum() / tot_mem * 100) if tot_mem else 0
            tot_vg = float(vg_caps[nv].sum())
            vg_occ = int(res.vg_used[s] / tot_vg * 100) if tot_vg else 0
            out.append(cpu_occ <= max_cpu and mem_occ <= max_mem and vg_occ <= max_vg)
        return out

    # -- run ----------------------------------------------------------------

    def run(self) -> int:
        close_out = False
        if self.opts.output_file:
            self.out = open(self.opts.output_file, "w")
            close_out = True
        try:
            return self._run_inner()
        finally:
            if close_out:
                self.out.close()

    def _step(self, name: str, t0: float) -> float:
        """Record the host-clock seconds of step `name` since `t0`; returns now."""
        t1 = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + (t1 - t0)
        return t1

    def _run_inner(self) -> int:
        multihost.initialize()  # a no-op unless JAX_COORDINATOR is set (ranks that split the sweeps)
        t = time.perf_counter()
        with Spinner("load cluster"):
            cluster = self.load_cluster()
        with Spinner(f"render {len(self.config.app_list)} app(s)"):
            apps = self.load_apps()
        template = self.load_new_node()
        t = self._step("load", t)

        if self.opts.interactive:
            return self._run_interactive(cluster, apps, template)

        # auto mode: batched capacity search. The first simulation's
        # Prepared is kept so that the sweep can delta re-encode the
        # candidate nodes into it (encode them once, each count a mask)
        # instead of preparing the whole cluster again.
        dev = self.device
        prep0 = snap0 = None
        if not self.opts.enable_preemption:  # prep reuse cannot serve preemption
            prep0 = prepare(cluster, apps, use_greed=self.opts.use_greed, device=dev)
            snap0 = snapshot_bind_state(prep0) if prep0 is not None else None
        with Spinner("schedule pods"):
            if prep0 is not None:
                result = simulate(cluster, apps, prep=prep0, sched_config=self.sched_config, tie_seed=self.tie_seed,
                                  explain=self.opts.explain)
            else:
                result = simulate(cluster, apps, use_greed=self.opts.use_greed, sched_config=self.sched_config,
                                  enable_preemption=self.opts.enable_preemption, tie_seed=self.tie_seed, device=dev,
                                  explain=self.opts.explain)
        t = self._step("simulate", t)
        self.first_result = result
        n_new = 0
        if result.unscheduled_pods or not satisfy_resource_setting(result)[0]:
            if template is None:
                print("Simulation failed: pods are unschedulable and no newNode is configured:", file=self.out)
                for i, up in enumerate(result.unscheduled_pods):
                    print(f"{i:4d} {up.pod.metadata.namespace}/{up.pod.metadata.name}: {up.reason}", file=self.out)
                return 1
            # one expansion and encode serves the whole sweep and the final
            # re-simulation: the candidates are encoded once into a fork of
            # the first encoder (prepcache.extend_with_nodes); the greedy
            # sort and app DaemonSets prepare afresh
            candidates = expand.new_fake_nodes(template, self.opts.max_new_nodes)
            full = copy.copy(cluster)
            full.nodes = list(cluster.nodes) + candidates
            with Spinner(f"capacity sweep (0..{self.opts.max_new_nodes} new nodes)"):
                prep_full = None
                if prep0 is not None:
                    restore_bind_state(prep0, snap0)  # decode wrote into the pods
                    prep_full = prepcache.extend_with_nodes(prep0, candidates, cluster, apps,
                                                            use_greed=self.opts.use_greed)
                    step = "delta re-encode"
                if prep_full is None:
                    prep_full = prepare(full, apps, use_greed=self.opts.use_greed, device=dev)
                    step = "prepare"
                self.prep_full = prep_full
                t = self._step(step, t)
                n_new = self.find_min_nodes_batched(prep_full, len(cluster.nodes))
                t = self._step("sweep", t)
            self.n_new = n_new
            if n_new is None:
                print(f"Simulation failed: still unschedulable after adding {self.opts.max_new_nodes} node(s)",
                      file=self.out)
                return 1
            sub = copy.copy(cluster)
            sub.nodes = list(cluster.nodes) + candidates[:n_new]
            with Spinner(f"re-simulate with {n_new} new node(s)"):
                if self.opts.enable_preemption or self.opts.use_greed or prep_full is None:
                    # preemption changes host state that prep reuse cannot
                    # share; greed_sort's order depends on the node totals,
                    # so the candidates' prep orders the stream differently
                    # from a fresh sort of the sub-cluster: re-expand
                    result = simulate(sub, apps, use_greed=self.opts.use_greed, sched_config=self.sched_config,
                                      enable_preemption=self.opts.enable_preemption, tie_seed=self.tie_seed,
                                      device=dev, explain=self.opts.explain)
                else:
                    mask = np.zeros(np.asarray(prep_full.ec_np.node_valid).shape[0], dtype=bool)
                    mask[: len(sub.nodes)] = True
                    result = simulate(sub, apps, prep=prep_full, node_valid=mask, sched_config=self.sched_config,
                                      tie_seed=self.tie_seed, explain=self.opts.explain)
            t = self._step("re-simulate", t)
        self.n_new = n_new
        print("Simulation success!", file=self.out)
        if n_new:
            print(f"(added {n_new} new node(s))", file=self.out)
        report_mod.report(
            result,
            extended_resources=self.opts.extended_resources,
            app_names=[a.name for a in apps],
            out=self.out,
            pod_nodes=[] if self.opts.report_pods else None,
        )
        if result.engine:
            print(f"Scheduling engine: {result.engine}", file=self.out)
        if self.opts.explain:
            self._print_placement_audit(result)
        self._step("report", t)
        return 0

    def _print_placement_audit(self, result: SimulateResult) -> None:
        """``--explain``: the per-filter reject totals over every audited
        step, and the kube-style breakdown of each pod that did not land
        (``opensim_tpu/planner/apply.py:414-440``)."""
        if result.explanations is None:
            return  # a run without pods audits nothing
        print("\nPlacement audit:", file=self.out)
        if result.filter_rejects:
            print("  filter rejects (nodes rejected per filter, all steps): "
                  + reasons.format_rejects(result.filter_rejects), file=self.out)
        bad = [e for e in result.explanations if e.status != "scheduled"]
        if not bad:
            print("  every pod scheduled; no rejection breakdowns to report", file=self.out)
            return
        for e in bad:
            print(f"  {e.pod}: {e.message}", file=self.out)
            for line in reasons.count_lines(e.reasons):
                print(f"    {line}", file=self.out)

    # survey.Select option labels (apply.go SurveyShowResults/AddNode/Exit)
    SURVEY_SHOW = "Show unschedulable pods"
    SURVEY_ADD = "Add nodes"
    SURVEY_EXIT = "Exit"

    def _input(self, prompt: str) -> str:
        """One interactive line: the prompt renders through ``self.out``
        and the reply comes from the injectable ``self.input_fn``. EOFError
        propagates to the caller."""
        print(prompt, end="", file=self.out, flush=True)
        return self.input_fn()

    def _survey_select(self, message: str, options: List[str]) -> str:
        """A terminal stand-in for the reference's pterm/survey selection
        (apply.go:219-248): numbered options, accepting the number, a
        unique prefix of the label, or the words show/add/exit."""
        print(message, file=self.out)
        for i, opt in enumerate(options, 1):
            print(f"  {i}) {opt}", file=self.out)
        legacy = {"show": self.SURVEY_SHOW, "add": self.SURVEY_ADD, "exit": self.SURVEY_EXIT}
        while True:
            try:
                raw = self._input("> ").strip()
            except EOFError:
                return self.SURVEY_EXIT
            if raw.isdigit() and 1 <= int(raw) <= len(options):
                return options[int(raw) - 1]
            lowered = raw.lower()
            if lowered in legacy and legacy[lowered] in options:
                return legacy[lowered]
            # one-shot "add N": stash the count so the number prompt is skipped
            parts = lowered.split()
            if (
                len(parts) == 2 and parts[0] == "add" and self.SURVEY_ADD in options
                and parts[1].lstrip("-").isdigit()
            ):
                self._pending_add = int(parts[1])
                return self.SURVEY_ADD
            matches = [o for o in options if o.lower().startswith(lowered)] if raw else []
            if len(matches) == 1:
                return matches[0]
            print(f"choose 1-{len(options)}", file=self.out)

    def _survey_int(self, message: str) -> Optional[int]:
        """survey.Input for 'input node number' (apply.go:235-241)."""
        pending = getattr(self, "_pending_add", None)
        if pending is not None:
            self._pending_add = None
            raw = str(pending)
        else:
            try:
                raw = self._input(f"{message} > ").strip()
            except EOFError:
                return None
        try:
            num = int(raw)
        except ValueError:
            print("not a number", file=self.out)
            return None
        if num < 1:
            print("node number must be >= 1", file=self.out)
            return None
        return num

    def _run_interactive(self, cluster, apps, template) -> int:
        """The reference's prompt loop (apply.go:203-259): re-simulate only
        when the node count changed (Show re-prompts over the same result),
        survey-style selection, separate node-number input."""
        n_new = 0
        result = None
        resimulate = True
        while True:
            if resimulate:
                with Spinner(f"schedule pods ({n_new} new node(s))"):
                    result = simulate(
                        self._cluster_with_new_nodes(cluster, template, n_new) if template else cluster,
                        apps,
                        use_greed=self.opts.use_greed,
                        sched_config=self.sched_config,
                        enable_preemption=self.opts.enable_preemption,
                        tie_seed=self.tie_seed,
                        device=self.device,
                    )
            resimulate = True
            if result.unscheduled_pods:
                choice = self._survey_select(
                    f"there are still {len(result.unscheduled_pods)} pod(s) that can "
                    f"not be scheduled when add {n_new} nodes, you can:",
                    [self.SURVEY_SHOW, self.SURVEY_ADD, self.SURVEY_EXIT],
                )
                if choice == self.SURVEY_SHOW:
                    for i, up in enumerate(result.unscheduled_pods):
                        print(f"{i:4d} {up.pod.metadata.namespace}/{up.pod.metadata.name}: {up.reason}",
                              file=self.out)
                    resimulate = False  # apply.go:204: Show re-prompts, no re-run
                elif choice == self.SURVEY_ADD:
                    if template is None:
                        print("no newNode template configured (spec.newNode); cannot add nodes", file=self.out)
                        resimulate = False
                        continue
                    num = self._survey_int("input node number")
                    if num is None:
                        resimulate = False
                    else:
                        n_new = num
                else:
                    return 1
            else:
                ok, reason = satisfy_resource_setting(result)
                if not ok:
                    print(reason, file=self.out)
                    if template is None:
                        # nothing can improve occupancy without a newNode
                        # template; looping would re-simulate forever
                        print("no newNode template configured (spec.newNode); cannot add nodes", file=self.out)
                        return 1
                    choice = self._survey_select(
                        "resource occupancy exceeds the env caps, you can:",
                        [self.SURVEY_ADD, self.SURVEY_EXIT],
                    )
                    if choice == self.SURVEY_ADD:
                        num = self._survey_int("input node number")
                        if num is None:
                            resimulate = False
                        else:
                            n_new = num
                    else:
                        return 1
                else:
                    break
        print("Simulation success!", file=self.out)
        # reportNodeInfo (apply.go:528-545) asks which nodes to detail
        try:
            nodes = self._input("nodes to report pods for (comma-separated, empty = all, '-' = none) > ").strip()
        except EOFError:
            nodes = "-"  # scripted input exhausted: skip the pod table
        pod_nodes = None if nodes == "-" else [n.strip() for n in nodes.split(",") if n.strip()]
        report_mod.report(
            result,
            extended_resources=self.opts.extended_resources,
            app_names=[a.name for a in apps],
            out=self.out,
            pod_nodes=pod_nodes,
        )
        if result.engine:
            print(f"Scheduling engine: {result.engine}", file=self.out)
        return 0
