"""`simon apply` through the port on the CPU (plain versions) against the
JAX package's: the report text of the three example configs and of a small
apply plan (new-node and pod names without their process-global counters,
the engine footer aside; otherwise equal as text), the cases of
tests/test_planner.py through the port's Applier, the chart renderer
against the JAX renderer, and the CLI's exit codes. The report equality is
exact: every cell of every table."""

import inspect
import io
import os
import re
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

import test_chart as chart_cases
from opensim_tpu.chart import render as ref_render
from opensim_tpu.planner import apply as ref_apply
from opensim_tpu_torch.chart import render
from opensim_tpu_torch.cli import main as cli
from opensim_tpu_torch.engine import simulator as sim
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.models.objects import ResourceTypes
from opensim_tpu_torch.planner import apply

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "example")


def _normalised(text: str) -> str:
    """The report without the engine footer, new-node and pod names
    without their counters (simon-<8 hex>, <name>-<10 hex>)."""
    text = re.sub(r"simon-[0-9a-f]{8}\b", "simon-#", text)
    text = re.sub(r"-[0-9a-f]{10}\b", "-#", text)
    return "\n".join(line for line in text.splitlines() if not line.startswith("Scheduling engine: "))


def _reports(tmp_path, config: str, extended=(), **opts):
    """(port Applier, its return code and report; the JAX Applier's)."""
    out = []
    for name, mod, extra in (("port", apply, {"device": "cpu"}), ("jax", ref_apply, {})):
        path = tmp_path / f"{name}.txt"
        applier = mod.Applier(mod.Options(simon_config=config, output_file=str(path),
                                          extended_resources=list(extended), **opts, **extra))
        out.append((applier, applier.run(), path.read_text()))
    return out


@pytest.mark.parametrize("config,extended,step", [
    ("simon-config.yaml", (), "prepare"),  # the chart's DaemonSet: no delta re-encode
    ("simon-gpushare-config.yaml", ("gpu",), None),  # fits as it is
    ("simon-local-config.yaml", ("open-local",), "delta re-encode"),
])
def test_example_report_equals_jax(tmp_path, config, extended, step):
    (port, rc, text), (_ref, ref_rc, ref_text) = _reports(tmp_path, os.path.join(EXAMPLE, config), extended)
    assert rc == ref_rc == 0
    assert _normalised(text) == _normalised(ref_text)
    assert "Simulation success!" in text
    engine = [line for line in text.splitlines() if line.startswith("Scheduling engine: ")]
    assert len(engine) == 1 and engine[0].endswith(" on cpu") and "fast_scan" in engine[0]
    if step is None:
        assert port.n_new == 0 and not port.sweeps
    else:  # two new nodes: the coarse sweep brackets 1 < k <= 2
        assert port.n_new == 2 and step in port.timings and [ks for ks, _s in port.sweeps][0][:3] == [0, 1, 2]


def test_small_apply_plan_report_equals_jax(tmp_path):
    """The apply plan at 40 nodes: 400 `bench` pods, then 46 `hog` pods of
    60 cores, one a node; the answer, 6 new nodes, needs the coarse sweep
    (bracket 4 < k <= 8) and the fine one (5, 6, 7)."""
    config = fx.write_apply_plan(tmp_path / "plan", 40, 400, 46)
    (port, rc, text), (_ref, ref_rc, ref_text) = _reports(tmp_path, config, max_new_nodes=16)
    assert rc == ref_rc == 0
    assert _normalised(text) == _normalised(ref_text)
    assert "(added 6 new node(s))" in text
    assert port.n_new == 6 and [ks for ks, _s in port.sweeps] == [[0, 1, 2, 4, 8, 16], [5, 6, 7]]
    assert set(port.timings) == {"load", "simulate", "delta re-encode", "sweep", "re-simulate", "report"}
    assert len(port.prep_full.meta.node_names) == 40 + 16
    # the first simulation's failures (Applier.first_result), in stream order: the hog pods that close it
    first = port.first_result.unscheduled_pods
    assert [u.reason for u in first] == ["0/40 nodes are available: 40 Insufficient cpu, 40 Insufficient memory."] * 6
    assert all(u.pod is p for u, p in zip(first, port.prep_full.ordered[-6:]))


def _write_config(tmp_path, node, deploy, newnode=None):
    """tests/test_planner.py's one-node cluster, one app and an optional
    new-node template, as YAML directories and a Config CR."""
    dirs = {"cluster": node, "app": deploy, "newnode": newnode}
    for name, obj in dirs.items():
        if obj is not None:
            (tmp_path / name).mkdir()
            (tmp_path / name / f"{name}.yaml").write_text(yaml.safe_dump(obj.raw))
    cfg = tmp_path / "config.yaml"
    cfg.write_text(textwrap.dedent(f"""\
        apiVersion: simon/v1alpha1
        kind: Config
        metadata: {{name: test}}
        spec:
          cluster: {{customConfig: {tmp_path / 'cluster'}}}
          appList:
            - name: app
              path: {tmp_path / 'app'}
        """) + (f"  newNode: {tmp_path / 'newnode'}\n" if newnode is not None else ""))
    return str(cfg)


def _adds_one(tmp_path):
    return _write_config(tmp_path, fx.make_fake_node("n1", "4", "8Gi"), fx.make_fake_deployment("big", 6, "2", "2Gi"),
                         fx.make_fake_node("tmpl", "8", "16Gi"))


def _no_room(tmp_path):
    return _write_config(tmp_path, fx.make_fake_node("n1", "1", "1Gi"), fx.make_fake_deployment("big", 2, "4", "8Gi"))


def test_applier_adds_nodes_until_schedulable(tmp_path):
    """tests/test_planner.py:33: 6 pods × 2 cores; n1 (4 cores) holds 2, one
    new 8-core node the other 4."""
    (port, rc, text), (_ref, ref_rc, ref_text) = _reports(tmp_path, _adds_one(tmp_path), max_new_nodes=8)
    assert rc == ref_rc == 0
    assert "added 1 new node(s)" in text and "√" in text
    assert _normalised(text) == _normalised(ref_text)


def test_applier_fails_without_new_node(tmp_path):
    """tests/test_planner.py:62: unschedulable pods and no newNode: exit 1
    with the pods and their reasons."""
    (_port, rc, text), (_ref, ref_rc, ref_text) = _reports(tmp_path, _no_room(tmp_path))
    assert rc == ref_rc == 1
    assert "Insufficient" in text and _normalised(text) == _normalised(ref_text)


def test_satisfy_resource_setting_caps(monkeypatch):
    """tests/test_planner.py:89."""
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n1", "4", "8Gi"))
    app = ResourceTypes()
    app.pods.append(fx.make_fake_pod("p", "3", "1Gi"))
    res = sim.simulate(cluster, [sim.AppResource("a", app)], device="cpu")
    assert apply.satisfy_resource_setting(res) == (True, "")
    monkeypatch.setenv("MaxCPU", "50")
    ok, reason = apply.satisfy_resource_setting(res)
    assert not ok and reason == "the average occupancy rate(75%) of cpu goes beyond the env setting(50%)"
    monkeypatch.setenv("MaxCPU", "x")
    with pytest.raises(ValueError, match="MaxCPU"):
        apply.resource_caps()


def test_occupancy_caps_drive_the_sweep(tmp_path, monkeypatch):
    """A cap the cluster breaks makes the planner add nodes until the
    occupancy is under it, as the JAX planner does."""
    cfg = _write_config(tmp_path, fx.make_fake_node("n1", "8", "8Gi"), fx.make_fake_deployment("web", 6, "1", "1Gi"),
                        fx.make_fake_node("tmpl", "8", "8Gi"))
    monkeypatch.setenv("MaxCPU", "40")
    (port, rc, text), (_ref, ref_rc, ref_text) = _reports(tmp_path, cfg, max_new_nodes=8)
    assert rc == ref_rc == 0 and port.n_new == 1
    assert _normalised(text) == _normalised(ref_text)


def _interactive(tmp_path, config, script):
    applier = apply.Applier(apply.Options(simon_config=config, interactive=True, device="cpu"))
    applier.out = io.StringIO()
    replies = iter(script)

    def reply():
        try:
            return next(replies)
        except StopIteration:
            raise EOFError from None

    applier.input_fn = reply
    return applier.run(), applier.out.getvalue()


def test_interactive_scripted_run_routes_through_out(tmp_path):
    """tests/test_planner.py:244: show the unschedulable pods, add 1 node,
    report every node; prompts and reasons go through `out`."""
    rc, text = _interactive(tmp_path, _adds_one(tmp_path), ["show", "add", "1", ""])
    assert rc == 0, text
    for want in ("you can:", "1) Show unschedulable pods", "input node number > ", "nodes to report pods for",
                 "Insufficient", "Simulation success!", "Pod Info"):
        assert want in text


def test_interactive_eof_exits_cleanly(tmp_path):
    """tests/test_planner.py:290: end of input selects Exit."""
    rc, text = _interactive(tmp_path, _no_room(tmp_path), [])
    assert rc == 1 and "can not be scheduled" in text


def test_chart_render_equals_jax():
    """process_chart on the example chart: the same manifests, in the same
    install order, as the JAX package's renderer."""
    path = os.path.join(EXAMPLE, "application", "charts", "obs-stack")
    docs = render.process_chart("obs", path)
    assert docs == ref_render.process_chart("obs", path)
    kinds = [yaml.safe_load(d).get("kind") for d in docs]
    assert kinds.index("StorageClass") < kinds.index("DaemonSet") < kinds.index("CronJob")
    assert "{{" not in "\n".join(docs)
    ctx = {"Values": {"a": {"b": "x"}, "flag": True, "n": 3}, "Release": {"Name": "r1"}}
    for tmpl in ("v: {{ .Values.a.b }}", "{{- if .Values.flag }}yes{{- else }}no{{- end }}",
                 "{{ int .Values.n }}", "{{ .Values.a.b | quote }}", "{{ .Release.Name }}"):
        assert render.render_template(tmpl, ctx) == ref_render.render_template(tmpl, ctx)


CHART_CASES = sorted(name for name in vars(chart_cases) if name.startswith("test_"))


@pytest.mark.parametrize("case", CHART_CASES)
def test_chart_cases_through_the_port(case, tmp_path, monkeypatch):
    """tests/test_chart.py's cases with the port's renderer in place of the
    JAX package's."""
    for name in ("process_chart", "render_template", "ChartError"):
        monkeypatch.setattr(chart_cases, name, getattr(render, name))
    fn = getattr(chart_cases, case)
    fn(**({"tmp_path": tmp_path} if "tmp_path" in inspect.signature(fn).parameters else {}))


@pytest.mark.parametrize("case", ["success", "unschedulable", "missing", "scheduler_config", "sample", "explain",
                                  "trace", "kubeconfig", "no_card"])
def test_cli_apply_exit_codes(tmp_path, capsys, monkeypatch, case):
    """0 on a plan that fits (after adding nodes), also under a scheduler
    config (`-d`), the sampled tie-break or with the placement audit
    (`--explain`); 1 on one that cannot, on a bad path, on the modes of
    later slices (naming their ROADMAP item) and without a card unless
    `--device cpu` is given."""
    args = ["apply", "-f", _adds_one(tmp_path), "--device", "cpu", "-o", str(tmp_path / "out.txt")]
    want, err = 1, None
    if case == "success":
        want = 0
    elif case == "unschedulable":
        (tmp_path / "room").mkdir()
        args[2] = _no_room(tmp_path / "room")
    elif case == "missing":
        args[2], err = str(tmp_path / "absent.yaml"), "No such file"
    elif case == "scheduler_config":
        sched = tmp_path / "sched.yaml"
        sched.write_text("kind: KubeSchedulerConfiguration\nprofiles:\n  - plugins:\n      score:\n"
                         "        disabled:\n          - name: NodeResourcesBalancedAllocation\n")
        args += ["-d", str(sched)]
        want = 0
    elif case == "sample":
        args += ["--tie-break", "sample:3"]
        want = 0
    elif case == "explain":
        args += ["--explain"]
        want = 0
    elif case == "trace":
        args += ["--trace", str(tmp_path / "t.json")]
        err = "Queue 1 item 10"
    elif case == "kubeconfig":
        cfg = tmp_path / "kube.yaml"
        cfg.write_text("apiVersion: simon/v1alpha1\nkind: Config\nspec:\n  cluster: {kubeConfig: /kube}\n")
        args[2], err = str(cfg), "Queue 1 item 6"
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        args = args[:3]
        err = "no CUDA device"
    assert cli.main(args) == want
    if err is not None:
        assert err in capsys.readouterr().err
    if want == 0:
        report = (tmp_path / "out.txt").read_text()
        assert "Simulation success!" in report
        assert ("\nPlacement audit:\n" in report) == (case == "explain")


def test_cli_version_and_usage(capsys):
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.startswith("simon version: ")
    with pytest.raises(SystemExit) as exit_:
        cli.main(["apply"])  # -f is required
    assert exit_.value.code == 2


def test_applier_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apply.Applier(apply.Options(simon_config=_adds_one(tmp_path)))



EXAMPLES = [("simon-config.yaml", ()), ("simon-gpushare-config.yaml", ("gpu",)),
            ("simon-local-config.yaml", ("open-local",))]


@pytest.mark.parametrize("config,extended", EXAMPLES)
def test_example_report_under_a_scheduler_config_equals_jax(tmp_path, config, extended):
    """`simon apply -d` on the example configs: the port's report equals
    the JAX package's under the same KubeSchedulerConfiguration (the
    apply plan's: no balanced score, least-allocated at 3, spread at 1),
    and the run takes the cfg variant."""
    sched = fx.write_scheduler_config(tmp_path / "sched.yaml", fx.SCHED_APPLY)
    (port, rc, text), (_ref, ref_rc, ref_text) = _reports(tmp_path, os.path.join(EXAMPLE, config), extended,
                                                          default_scheduler_config=sched)
    assert rc == ref_rc == 0 and "Simulation success!" in text
    assert _normalised(text) == _normalised(ref_text)
    engine = [line for line in text.splitlines() if line.startswith("Scheduling engine: ")]
    assert len(engine) == 1 and ("[cfg]" in engine[0] or ",cfg]" in engine[0])


def test_small_apply_plan_under_a_scheduler_config_equals_jax(tmp_path):
    """The 40-node apply plan under `-d`: the first simulation, both
    sweeps and the masked re-simulation take the config, and the report
    equals the JAX package's."""
    config = fx.write_apply_plan(tmp_path / "plan", 40, 400, 46)
    sched = fx.write_scheduler_config(tmp_path / "sched.yaml", fx.SCHED_APPLY)
    (port, rc, text), (_ref, ref_rc, ref_text) = _reports(tmp_path, config, max_new_nodes=16,
                                                          default_scheduler_config=sched)
    assert rc == ref_rc == 0 and _normalised(text) == _normalised(ref_text)
    assert port.n_new == 6 and len(port.sweeps) == 2 and port.sched_config is not None


def _replayed(tmp_path, config, placements):
    """Binds of `placements` (the port's first simulation) that the
    independent kube oracle of tests/test_k8s_oracle.py scores below the
    best feasible node, replayed over the JAX package's preparation of the
    same plan."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_k8s_oracle import _replay_with_scores

    from opensim_tpu.engine import simulator as ref_sim

    ref = ref_apply.Applier(ref_apply.Options(simon_config=config, output_file=str(tmp_path / "unused.txt")))
    cluster, apps = ref.load_cluster(), ref.load_apps()
    prep = ref_sim.prepare(cluster, apps)
    return _replay_with_scores(prep, cluster, placements)


@pytest.mark.parametrize("plan", ["example", "apply_plan"])
def test_sampled_apply_binds_stay_score_optimal(tmp_path, plan):
    """`simon apply --tie-break sample:3` through the CLI: the same exit
    and new-node count as the JAX package's run, and every bind of the
    first simulation score-optimal by the independent oracle (sampling
    permutes ties only, so its report is not compared line by line)."""
    if plan == "example":
        config, max_new = os.path.join(EXAMPLE, "simon-config.yaml"), 128
    else:
        config, max_new = fx.write_apply_plan(tmp_path / "plan", 40, 400, 46), 16
    out = tmp_path / "sampled.txt"
    assert cli.main(["apply", "-f", config, "--device", "cpu", "-o", str(out), "--tie-break", "sample:3",
                     "--max-new-nodes", str(max_new)]) == 0
    text = out.read_text()
    (port, rc, det), (_ref, ref_rc, ref_text) = _reports(tmp_path, config, max_new_nodes=max_new)
    added = lambda t: [line for line in t.splitlines() if line.startswith("(added")]
    assert rc == ref_rc == 0 and added(text) == added(ref_text)
    sampler = apply.Applier(apply.Options(simon_config=config, output_file=str(tmp_path / "again.txt"),
                                          tie_break="sample:3", max_new_nodes=max_new, device="cpu"))
    assert sampler.run() == 0 and sampler.tie_seed == 3
    first = sampler.first_result.placements
    assert not np.array_equal(first, port.first_result.placements)
    assert _replayed(tmp_path, config, first) == 0
