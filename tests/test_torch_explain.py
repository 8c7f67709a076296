"""Explain mode through the port on the CPU (the plain versions and the
torch reference scan) against the JAX package's on its XLA scan
(``OPENSIM_DISABLE_NATIVE=1``, as tests/test_explain.py selects it):

- ``simulate(explain=True, device="cpu")``: every ``PlacementExplanation``
  (``to_dict()``, by stream index, pod names without their counters) and
  the per-filter reject totals, exactly; on tests/test_explain.py's small
  cluster and its fuzzed workloads, a masked run that drops DaemonSet
  pods, a two-profile scheduler config, a preemption pass and
  out-of-tree plugins; with ``explain=False`` nothing is attached and the
  placements and reasons are those of an explained run;
- ``explain_pod`` on scheduled, unschedulable and forced pods: scores to
  the reference's 4 decimals, the runner-up and the margin; ``index_of``;
- the reason registry's records and renderings;
- ``simon apply --explain`` and ``simon explain [<pod>] [--json]`` of the
  port's CLI against the JAX CLI on the example configs;
- ``extra_plugins``: tests/test_schedconfig.py's two cases with torch
  twins of their plugins, on the CPU; on the card the call raises before
  anything runs."""

import argparse
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from opensim_tpu.cli import main as ref_cli
from opensim_tpu.engine import explain as ref_explain, reasons as ref_reasons, schedconfig as ref_sc
from opensim_tpu.engine import simulator as ref_sim
from opensim_tpu.models import expand as ref_expand
from opensim_tpu.planner import apply as ref_apply
from opensim_tpu_torch.cli import main as cli
from opensim_tpu_torch.engine import explain, reasons, schedconfig, simulator as sim
from opensim_tpu_torch.models import expand, fixtures as fx
from opensim_tpu_torch.models.objects import ResourceTypes
from opensim_tpu_torch.ops import fast_scan as fs
from opensim_tpu_torch.planner import apply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [("simon-config.yaml", ()), ("simon-gpushare-config.yaml", ("gpu",)),
            ("simon-local-config.yaml", ("open-local",))]


@pytest.fixture(autouse=True)
def _xla_reference(monkeypatch):
    """The JAX package on its XLA scan, the engine its explain mode runs
    without the C++ one."""
    monkeypatch.setenv("OPENSIM_DISABLE_NATIVE", "1")


def _reference_copy(rt):
    """The same objects in the JAX package's object model, rebuilt from
    their manifests: only plain dicts cross between the packages."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def _names(text: str) -> str:
    """Pod and new-node names without their process-global counters."""
    return re.sub(r"-[0-9a-f]{10}\b", "-#", re.sub(r"simon-[0-9a-f]{8}\b", "simon-#", text))


def _canon(e) -> dict:
    return json.loads(_names(json.dumps(e.to_dict())))


def small_cluster(n=6):
    """tests/test_explain.py:31."""
    rt = ResourceTypes()
    for i in range(n):
        rt.nodes.append(fx.make_fake_node(f"n{i:02d}", "4", "8Gi", "110", fx.with_labels(
            {"topology.kubernetes.io/zone": f"z{i % 2}", "disk": "ssd" if i % 2 else "hdd"})))
    return rt


def mixed_apps():
    """tests/test_explain.py:49: schedulable and unschedulable workloads
    over fit, node affinity and spread."""
    rt = ResourceTypes()
    rt.deployments.append(fx.make_fake_deployment("fits", 3, "500m", "1Gi"))
    rt.deployments.append(fx.make_fake_deployment("bigcpu", 2, "16", "1Gi"))
    rt.deployments.append(fx.make_fake_deployment("ssd", 2, "100m", "128Mi", fx.with_node_selector({"disk": "ssd"})))
    rt.deployments.append(fx.make_fake_deployment("bigmem", 1, "100m", "100Gi"))
    rt.deployments.append(fx.make_fake_deployment("spread", 4, "100m", "64Mi", fx.with_topology_spread([{
        "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone", "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "spread"}}}])))
    return [("t", rt)]


def fuzz_case(seed):
    """tests/test_explain.py:220's random cluster and workloads."""
    rng = np.random.default_rng(seed)
    cluster = ResourceTypes()
    zones = [f"z{k}" for k in range(int(rng.integers(1, 4)))]
    for i in range(int(rng.integers(3, 9))):
        opts = [fx.with_labels({"topology.kubernetes.io/zone": str(rng.choice(zones)),
                                "tier": str(rng.choice(["web", "db", "cache"]))})]
        if rng.random() < 0.3:
            opts.append(fx.with_taints([{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]))
        cluster.nodes.append(fx.make_fake_node(f"fz{i:02d}", str(int(rng.integers(2, 9))),
                                               f"{int(rng.integers(4, 17))}Gi", "110", *opts))
    rt = ResourceTypes()
    for w in range(int(rng.integers(2, 6))):
        opts = []
        if rng.random() < 0.4:
            opts.append(fx.with_node_selector({"tier": str(rng.choice(["web", "db", "gone"]))}))
        if rng.random() < 0.4:
            opts.append(fx.with_topology_spread([{
                "maxSkew": int(rng.integers(1, 3)), "topologyKey": "topology.kubernetes.io/zone",
                "whenUnsatisfiable": str(rng.choice(["DoNotSchedule", "ScheduleAnyway"])),
                "labelSelector": {"matchLabels": {"app": f"fz-{w}"}}}]))
        cpu = str(rng.choice(["100m", "500m", "2", "12"]))
        mem = str(rng.choice(["128Mi", "1Gi", "4Gi", "64Gi"]))
        rt.deployments.append(fx.make_fake_deployment(f"fz-{w}", int(rng.integers(1, 5)), cpu, mem, *opts))
    return cluster, [("fuzz", rt)]


def _both(cluster, apps, port_kw=None, ref_kw=None, **kw):
    """The port's simulate(explain=True) on the CPU and the JAX package's
    on the same manifests; their results, the explanations held equal."""
    ref = ref_sim.simulate(_reference_copy(cluster), [ref_sim.AppResource(n, _reference_copy(a)) for n, a in apps],
                           explain=True, **kw, **(ref_kw or {}))
    port = sim.simulate(cluster, [sim.AppResource(n, a) for n, a in apps], device="cpu", explain=True, **kw,
                        **(port_kw or {}))
    assert ref.engine.name == "xla"
    _same_audit(port, ref.engine)
    return port, ref


def _same_audit(port, ref_engine):
    assert port.filter_rejects == ref_engine.filter_rejects
    assert [_canon(e) for e in port.explanations] == [_canon(e) for e in ref_engine.explanations]


def test_explanations_equal_jax_on_the_mixed_apps():
    port, ref = _both(small_cluster(), mixed_apps())
    msgs = [e.message for e in port.explanations if e.status == "unschedulable"]
    assert any("Insufficient cpu" in m for m in msgs) and any("Insufficient memory" in m for m in msgs)
    assert all(m.startswith("0/6 nodes are available") for m in msgs)
    assert port.engine == "fast_scan[explain] on cpu" and len(port.explanations) == len(port.explain_ctx.prep.ordered)
    # the totals count the binding steps' rejections too
    assert port.explain_ctx.fail_counts[port.placements >= 0].sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_explanations_equal_jax_on_fuzzed_workloads(seed):
    port, ref = _both(*fuzz_case(seed))
    cp, cr = port.explain_ctx, ref.engine.explain_ctx
    unforced = ~cp.prep.forced
    np.testing.assert_array_equal(cp.fail_counts[unforced], np.asarray(cr.fail_counts)[unforced])
    np.testing.assert_array_equal(cp.insufficient[unforced], np.asarray(cr.insufficient)[unforced])


def test_explain_off_attaches_nothing_and_places_alike():
    cluster, apps = small_cluster(), mixed_apps()
    off = sim.simulate(copy.deepcopy(cluster), [sim.AppResource(n, copy.deepcopy(a)) for n, a in apps], device="cpu")
    on = sim.simulate(copy.deepcopy(cluster), [sim.AppResource(n, copy.deepcopy(a)) for n, a in apps], device="cpu",
                      explain=True)
    assert off.explanations is None and off.filter_rejects is None and off.explain_ctx is None
    np.testing.assert_array_equal(off.placements, on.placements)
    assert [_names(u.reason) for u in off.unscheduled_pods] == [_names(u.reason) for u in on.unscheduled_pods]
    assert off.engine == "fast_scan on cpu" and on.engine == "fast_scan[explain] on cpu"


def _planner_cluster():
    """tests/test_planner.py:184's cluster under a DaemonSet, with 4 candidates."""
    cluster = ResourceTypes()
    for i in range(4):
        cluster.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi", "110",
                                               fx.with_labels({"topology.kubernetes.io/zone": f"z{i % 2}"})))
    cluster.daemon_sets.append(fx.make_fake_daemon_set("logger", "100m", "64Mi"))
    rt = ResourceTypes()
    rt.deployments.append(fx.make_fake_deployment("web", 40, "1", "2Gi"))
    return cluster, rt, expand.new_fake_nodes(fx.make_fake_node("tmpl", "16", "32Gi"), 4)


@pytest.mark.parametrize("k", [0, 2])
def test_masked_explanations_equal_jax_and_leave_dropped_pods_out(k):
    """The planner's masked re-simulation with k of 4 candidates: the
    DaemonSet pods of the masked-out candidates are left out of the
    explanations, the FitError counts the valid nodes."""
    cluster, rt, candidates = _planner_cluster()
    full = copy.copy(cluster)
    full.nodes = list(cluster.nodes) + candidates
    sub = copy.copy(cluster)
    sub.nodes = list(cluster.nodes) + candidates[:k]
    prep = sim.prepare(full, [sim.AppResource("web", rt)], device="cpu")
    mask = np.zeros(len(prep.meta.node_names), bool)
    mask[: len(sub.nodes)] = True
    port = sim.simulate(sub, [sim.AppResource("web", rt)], prep=prep, node_valid=mask, explain=True)
    full_ref, sub_ref = _reference_copy(full), _reference_copy(sub)
    apps_ref = [ref_sim.AppResource("web", _reference_copy(rt))]
    prep_ref = ref_sim.prepare(full_ref, apps_ref)
    mask_ref = np.zeros(np.asarray(prep_ref.ec_np.node_valid).shape[0], bool)
    mask_ref[: len(sub.nodes)] = True
    ref = ref_sim.simulate(sub_ref, apps_ref, prep=prep_ref, node_valid=mask_ref, explain=True)
    _same_audit(port, ref.engine)
    dropped = 4 - k
    assert len(port.explanations) == len(prep.ordered) - dropped
    assert all(e.message.startswith(f"0/{4 + k} nodes") for e in port.explanations if e.status == "unschedulable")
    assert port.explain_ctx.node_valid is not None


_TWO_PROFILES = """kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: default-scheduler
  - schedulerName: lean
    plugins:
      score:
        disabled:
          - name: NodeResourcesBalancedAllocation
        enabled:
          - name: NodeResourcesLeastAllocated
            weight: 4
      filter:
        disabled:
          - name: PodTopologySpread
"""


def _scheduler(workload, name):
    workload.template_spec.scheduler_name = name
    workload.raw["spec"]["template"].setdefault("spec", {})["schedulerName"] = name
    workload.template_raw.setdefault("spec", {})["schedulerName"] = name
    return workload


def test_two_profile_explanations_equal_jax(tmp_path):
    """Two profile segments, each launch in explain mode from the previous
    one's state, and a pod naming no profile."""
    path = tmp_path / "sched.yaml"
    path.write_text(_TWO_PROFILES)
    cluster, (name, rt) = small_cluster(), mixed_apps()[0]
    lean = ResourceTypes()
    lean.deployments.append(_scheduler(fx.make_fake_deployment("lean", 3, "1", "1Gi"), "lean"))
    lean.deployments.append(_scheduler(fx.make_fake_deployment("lost", 1, "100m", "64Mi"), "nobody"))
    port, ref = _both(cluster, [(name, rt), ("lean", lean)], {"sched_config": schedconfig.load_scheduler_config(str(path))},
                      {"sched_config": ref_sc.load_scheduler_config(str(path))})
    assert "segmented multi-profile" in port.engine and port.explain_ctx.segments
    assert any("no scheduler profile named 'nobody'" in e.message for e in port.explanations)


def test_preemption_explanations_equal_jax():
    """A priority pod that finds no node evicts lower-priority ones: the
    victims' records say which pod preempted them."""
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n0", "4", "8Gi"))
    low = ResourceTypes()
    low.deployments.append(fx.make_fake_deployment("low", 4, "1", "1Gi", fx.with_priority(1)))
    high = ResourceTypes()
    high.deployments.append(fx.make_fake_deployment("high", 1, "2", "1Gi", fx.with_priority(1000)))
    port, _ref = _both(cluster, [("low", low), ("high", high)], enable_preemption=True)
    assert sum(e.status == "preempted" for e in port.explanations) == 2


def test_sampled_explanations_place_as_the_sampled_run():
    cluster, apps = small_cluster(), mixed_apps()
    runs = [sim.simulate(copy.deepcopy(cluster), [sim.AppResource(n, copy.deepcopy(a)) for n, a in apps],
                         device="cpu", tie_seed=3, explain=on) for on in (False, True)]
    np.testing.assert_array_equal(runs[0].placements, runs[1].placements)
    assert runs[1].engine == "fast_scan[sample,explain] on cpu"


# --- the deep explainer -----------------------------------------------------------

def _pinned_cluster():
    cluster = small_cluster()
    cluster.pods.append(fx.make_fake_pod("pinned", "100m", "64Mi", fx.with_node_name("n03")))
    cluster.pods.append(fx.make_fake_pod("orphan", "100m", "64Mi", fx.with_node_name("no-such-node")))
    return cluster


def test_explain_pod_equals_jax_on_scheduled_unschedulable_and_forced_pods():
    port, ref = _both(_pinned_cluster(), mixed_apps())
    cp, cr = port.explain_ctx, ref.engine.explain_ctx
    scheduled = [i for i, e in enumerate(port.explanations) if e.status == "scheduled" and not e.forced]
    bad = [i for i, e in enumerate(port.explanations) if e.status == "unschedulable" and not e.forced]
    forced = [cp.index_of("default/pinned"), cp.index_of("default/orphan")]
    assert len(scheduled) >= 3 and bad and None not in forced
    for i in scheduled[:4] + bad[:2] + forced:
        deep = explain.explain_pod(cp, i)
        assert _canon(deep) == _canon(ref_explain.explain_pod(cr, i))
    deep = explain.explain_pod(cp, scheduled[0])
    assert deep.scores and abs(sum(deep.scores.values()) - deep.score) < 1e-2
    assert deep.runner_up is not None and deep.runner_up != deep.node and deep.margin >= 0.0
    assert explain.explain_pod(cp, forced[1]).message == 'node "no-such-node" not found'
    assert explain.explain_pod(cp, forced[0]).node == "n03"


def test_explain_pod_of_a_masked_run_scores_the_valid_nodes():
    cluster, rt, candidates = _planner_cluster()
    full = copy.copy(cluster)
    full.nodes = list(cluster.nodes) + candidates
    prep = sim.prepare(full, [sim.AppResource("web", rt)], device="cpu")
    mask = np.zeros(len(prep.meta.node_names), bool)
    mask[:5] = True
    sub = copy.copy(cluster)
    sub.nodes = list(cluster.nodes) + candidates[:1]
    res = sim.simulate(sub, [sim.AppResource("web", rt)], prep=prep, node_valid=mask, explain=True)
    i = next(i for i, p in enumerate(prep.ordered) if p.metadata.name.startswith("web"))
    step, _parts = explain.rescore(res.explain_ctx, i)
    assert not bool(step.feasible[5:].any()) and step.chosen == int(res.placements[i])


def test_index_of_and_its_ambiguity():
    port = sim.simulate(small_cluster(), [sim.AppResource(n, a) for n, a in mixed_apps()], device="cpu",
                        explain=True)
    ctx = port.explain_ctx
    first = ctx.prep.ordered[0]
    assert ctx.index_of(f"{first.metadata.namespace}/{first.metadata.name}") == 0
    assert ctx.index_of("nope/nothing") is None
    assert ctx.index_of("bigcpu") == next(i for i, p in enumerate(ctx.prep.ordered)
                                          if p.metadata.name.startswith("bigcpu-"))
    twin = ctx.prep.ordered[1]
    clone = copy.copy(twin)
    clone.metadata = copy.copy(twin.metadata)
    clone.metadata.namespace = "other"
    ctx.prep.ordered.append(clone)
    with pytest.raises(ValueError, match="ambiguous"):
        ctx.index_of(twin.metadata.name)


# --- the registry and the aggregates ------------------------------------------------

def test_reason_records_and_renderings_equal_the_reference():
    rows = [(reasons.Reason.FIT, 2, "cpu"), (reasons.Reason.TAINT, 2, ""), (reasons.Reason.SPREAD, 5, "")]
    ours = [reasons.ReasonCount(c, n, r) for c, n, r in rows]
    theirs = [ref_reasons.ReasonCount(ref_reasons.Reason[c.name], n, r) for c, n, r in rows]
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]
    assert reasons.count_lines(ours) == ref_reasons.count_lines(theirs)
    for k in (3, 2, 0):
        assert getattr(reasons.primary_code(ours[:k]), "name", None) == getattr(
            ref_reasons.primary_code(theirs[:k]), "name", None)
    vec = [0, 1, 3, 0, 0, 7, 2, 0, 0, 0, 4]
    assert reasons.rejects_dict(vec) == ref_reasons.rejects_dict(vec)
    assert reasons.format_rejects({"fit": 3, "affinity": 1}) == ref_reasons.format_rejects({"fit": 3, "affinity": 1})
    assert reasons.pending_observed() == ref_reasons.pending_observed()
    assert [f.name for f in dataclasses.fields(reasons.PlacementExplanation)] == [
        f.name for f in dataclasses.fields(ref_reasons.PlacementExplanation)]
    full = dict(pod="ns/p", status="scheduled", nodes_total=3, node="n1", forced=True, message="m",
                scores={"a": 1.5}, score=1.5, runner_up="n2", margin=0.25)
    assert reasons.PlacementExplanation(reasons=ours, **full).to_dict() == ref_reasons.PlacementExplanation(
        reasons=theirs, **full).to_dict()


def test_audit_aggregates_equal_the_reference():
    rng = np.random.default_rng(5)
    static_fail = rng.integers(0, 4, (9, 4)).astype(np.int32)
    fail_counts = rng.integers(0, 3, (9, 7)).astype(np.int32)
    fail_counts[4] = 0
    sf_rows = np.arange(9, dtype=np.int32)
    static_fail[4] = 0
    mask = rng.random(9) < 0.7
    np.testing.assert_array_equal(explain.audit_rejects(static_fail, sf_rows, fail_counts, mask),
                                  ref_explain.audit_rejects(static_fail, sf_rows, fail_counts, mask))
    idx = np.array([0, 2, 4, 7])
    assert explain.primary_reason_histogram(static_fail, sf_rows, fail_counts, idx) == \
        ref_explain.primary_reason_histogram(static_fail, sf_rows, fail_counts, idx)


# --- the CLI ------------------------------------------------------------------------

def _without_engine(text: str) -> str:
    return "\n".join(line for line in _names(text).splitlines()
                     if not line.startswith(("Scheduling engine: ", "engine: ", '  "engine": ')))


@pytest.mark.parametrize("config,extended", EXAMPLES)
def test_apply_explain_report_equals_jax(tmp_path, config, extended):
    texts = []
    for name, mod, extra in (("port", apply, {"device": "cpu"}), ("jax", ref_apply, {})):
        out = tmp_path / f"{name}.txt"
        rc = mod.Applier(mod.Options(simon_config=os.path.join(ROOT, "example", config), output_file=str(out),
                                     extended_resources=list(extended), explain=True, **extra)).run()
        assert rc == 0
        texts.append(out.read_text())
    assert _without_engine(texts[0]) == _without_engine(texts[1])
    assert "\nPlacement audit:\n" in texts[0]


def _ref_explain(config, pod="", as_json=False):
    return ref_cli.run_explain(argparse.Namespace(simon_config=config, default_scheduler_config="", pod=pod,
                                                  use_greed=False, json=as_json))


@pytest.mark.parametrize("config,extended", EXAMPLES)
@pytest.mark.parametrize("as_json", [False, True])
def test_simon_explain_summary_equals_jax(capsys, config, extended, as_json):
    path = os.path.join(ROOT, "example", config)
    assert cli.main(["explain", "-f", path, "--device", "cpu"] + (["--json"] if as_json else [])) == 0
    ours = capsys.readouterr().out
    assert _ref_explain(path, as_json=as_json) == 0
    theirs = capsys.readouterr().out
    assert _without_engine(ours) == _without_engine(theirs)
    assert ("fast_scan" in ours) and ("pod(s) scheduled" in ours or '"unschedulable"' in ours)


@pytest.mark.parametrize("as_json", [False, True])
@pytest.mark.parametrize("config,pod", [("simon-config.yaml", "demo-app/kv-store-0"),
                                        ("simon-config.yaml", "demo-app/kv-store-4"),
                                        ("simon-config.yaml", "demo-app/cache"),
                                        ("simon-gpushare-config.yaml", "ml/serving"),
                                        ("simon-local-config.yaml", "data/db-2")])
def test_simon_explain_of_one_pod_equals_jax(capsys, config, pod, as_json):
    """A scheduled pod (its breakdown and margin), an unschedulable one and
    a workload's pod by its prefix, on the three example configs."""
    path = os.path.join(ROOT, "example", config)
    assert cli.main(["explain", "-f", path, pod, "--device", "cpu"] + (["--json"] if as_json else [])) == 0
    ours = capsys.readouterr().out
    assert _ref_explain(path, pod, as_json) == 0
    theirs = capsys.readouterr().out
    assert _names(ours) == _names(theirs) and ours


def test_simon_explain_of_an_unknown_pod_fails(capsys):
    path = os.path.join(ROOT, "example", "simon-config.yaml")
    assert cli.main(["explain", "-f", path, "nope/nothing", "--device", "cpu"]) == 1
    assert "no pod named 'nope/nothing'" in capsys.readouterr().err


def test_simon_explain_as_a_module(tmp_path):
    out = subprocess.run([sys.executable, "-m", "opensim_tpu_torch", "explain", "-f",
                          os.path.join(ROOT, "example", "simon-config.yaml"), "--device", "cpu"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("engine: fast_scan[interpod,explain] on cpu\n")


# --- out-of-tree plugins ---------------------------------------------------------------

def _ban_node_zero(ec, st, u):
    return torch.arange(ec.node_valid.shape[0]) != 0


def _prefer_node_two(ec, st, u, feasible):
    return torch.where(torch.arange(ec.node_valid.shape[0]) == 2, 100.0, 0.0)


def _ban_all(ec, st, u):
    return torch.zeros(ec.node_valid.shape[0], dtype=torch.bool)


def _three_nodes():
    cluster = ResourceTypes()
    for i in range(3):
        cluster.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi"))
    app = ResourceTypes()
    app.deployments.append(fx.make_fake_deployment("w", 4, "100m", "128Mi"))
    return cluster, app


def test_extra_plugins_registry():
    """tests/test_schedconfig.py:61 through the port, on the torch
    reference scan: a filter and a heavy score plugin."""
    cluster, app = _three_nodes()
    res = sim.simulate(cluster, [sim.AppResource("a", app)], device="cpu",
                       extra_plugins=(("filter", _ban_node_zero), ("score", _prefer_node_two, 1000.0)))
    assert not res.unscheduled_pods and res.engine == "torch reference scan on cpu"
    placed = {ns.node.metadata.name: len(ns.pods) for ns in res.node_status}
    assert placed.get("n0", 0) == 0 and placed["n2"] == 4


def test_extra_plugins_validation_and_reason():
    """tests/test_schedconfig.py:89 through the port."""
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n0", "8", "16Gi"))
    app = ResourceTypes()
    app.pods.append(fx.make_fake_pod("p", "100m", "128Mi"))
    run = lambda plugins: sim.simulate(cluster, [sim.AppResource("a", app)], device="cpu", extra_plugins=plugins)
    for bad in ([("filter", lambda *a: None)], (("prefilter", lambda *a: None),), (("score", lambda *a: None),)):
        with pytest.raises(ValueError):
            run(bad)
    res = run((("filter", _ban_all),))
    assert len(res.unscheduled_pods) == 1 and "out-of-tree plugin" in res.unscheduled_pods[0].reason


def test_extra_plugins_explained_equal_jax():
    """Out-of-tree plugins in explain mode, the torch twins against the JAX
    plugins: the extra filter's rejections count in their own slot."""
    import jax.numpy as jnp

    ref_plugins = (("filter", lambda ec, st, u: jnp.arange(ec.node_valid.shape[0]) != 0),
                   ("score", lambda ec, st, u, f: jnp.where(jnp.arange(ec.node_valid.shape[0]) == 2, 100.0, 0.0),
                    1000.0))
    port, _ref = _both(small_cluster(), mixed_apps(),
                       {"extra_plugins": (("filter", _ban_node_zero), ("score", _prefer_node_two, 1000.0))},
                       {"extra_plugins": ref_plugins})
    assert port.filter_rejects.get("extra", 0) > 0


def test_extra_plugins_on_the_card_raise_before_anything_runs(monkeypatch):
    """No kernel runs a Python callable: with the card named, simulate()
    raises NotImplementedError before it prepares or launches anything;
    with no device and no card it raises as every entry point does."""
    cluster, app = _three_nodes()
    monkeypatch.setattr(sim, "prepare", lambda *a, **k: pytest.fail("prepared before the check"))
    before = fs.LAUNCHES
    with pytest.raises(NotImplementedError, match="Queue 1 item 5b"):
        sim.simulate(cluster, [sim.AppResource("a", app)], device="cuda", extra_plugins=(("filter", _ban_all),))
    assert fs.LAUNCHES == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.simulate(cluster, [sim.AppResource("a", app)], extra_plugins=(("filter", _ban_all),))
