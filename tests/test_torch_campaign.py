"""The port's campaign planner (``planner/campaign.py``) on the CPU (the
plain versions) against the JAX package's (on the engine it picks, and on
its XLA scan, ``OPENSIM_DISABLE_NATIVE=1``, where the lowest index decides
ties): ``run_campaign(...).to_dict()`` equal,
step fingerprints included, in both execution modes; warm equal to cold in
the port; every typed spec error with the reference's step and field; the
carried state of a scheduling pass (``fastpath.carried_state``) against the
kernel's own state; the ``from-journal`` step over a journal the port
wrote;
``POST /api/campaign`` and ``simon campaign`` against the JAX package's.
Clusters are built once in the port's object model and copied into the
reference's from their manifests, so only plain dicts cross."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from opensim_tpu.cli import main as ref_cli
from opensim_tpu.models import expand as ref_expand
from opensim_tpu.planner import campaign as ref_cp
from opensim_tpu.server import rest as ref_rest
from opensim_tpu_torch.cli import main as cli
from opensim_tpu_torch.engine import fastpath, simulator as sim
from opensim_tpu_torch.engine.explain import replay_state
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.models.objects import PodDisruptionBudget, ResourceTypes
from opensim_tpu_torch.ops import fast_scan as fs
from opensim_tpu_torch.planner import campaign as cp
from opensim_tpu_torch.planner import report as report_mod
from opensim_tpu_torch.server import rest
from opensim_tpu_torch.utils import envknobs, validate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def xla_reference(monkeypatch):
    """The JAX package on its XLA scan, whose step the port's carried
    launches take (the cfg variant: ``kernels.pod_step``'s weighted sum)."""
    monkeypatch.setenv("OPENSIM_DISABLE_NATIVE", "1")


def _reference_copy(rt):
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def make_cluster(n_nodes=5, web=6, api=3, pdb_min_available=None, daemon=False, taint_last=False,
                 api_selector=False):
    """The reference tests' cluster (tests/test_campaign.py:20) in the
    port's objects; `daemon` adds a DaemonSet, `taint_last` a NoSchedule
    taint on the last node, `api_selector` a node selector on ``api`` that
    only the first node's label meets."""
    rt = ResourceTypes()
    for i in range(n_nodes):
        opts = [fx.with_labels({"slot": "first" if i == 0 else "other"})]
        if taint_last and i == n_nodes - 1:
            opts.append(fx.with_taints([{"key": "spot", "value": "yes", "effect": "NoSchedule"}]))
        rt.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi", "110", *opts))
    if web:
        rt.deployments.append(fx.make_fake_deployment("web", web, "1", "2Gi"))
    if api:
        opts = [fx.with_node_selector({"slot": "first"})] if api_selector else []
        rt.deployments.append(fx.make_fake_deployment("api", api, "500m", "1Gi", *opts))
    if daemon:
        rt.daemon_sets.append(fx.make_fake_daemon_set("agent", "100m", "128Mi"))
    if pdb_min_available is not None:
        rt.pdbs.append(PodDisruptionBudget.from_dict({
            "apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
            "metadata": {"name": "web-pdb", "namespace": "default"},
            "spec": {"minAvailable": pdb_min_available, "selector": {"matchLabels": {"app": "web"}}},
        }))
    return rt


def _canary(replicas=3, cpu="250m"):
    return {"name": "push", "type": "deploy", "app": {"name": "canary"},
            "resources": [fx.make_fake_deployment("canary", replicas, cpu, "512Mi").raw]}


MIXED_STEPS = [
    {"name": "upgrade", "type": "drain-wave", "nodes": ["n0", "n1"], "wave": 1},
    {"name": "storm", "type": "reclaim-storm", "nodes": ["n2"]},
    _canary(),
    {"name": "shrink", "type": "scale-down-check"},
]

#: (name, cluster kwargs or a builder, raw steps): each case runs through
#: both packages in warm mode and is compared whole.
CASES = {
    "pdb-blocked": (dict(n_nodes=3, web=3, api=0, pdb_min_available=3),
                    [{"type": "drain-wave", "nodes": ["n0"], "wave": 1}]),
    "pdb-recovers": (dict(n_nodes=4, web=4, api=0, pdb_min_available=3),
                     [{"type": "drain-wave", "nodes": ["n0", "n1"], "wave": 1}]),
    "reclaim-ignores-pdbs": (dict(n_nodes=3, web=3, api=0, pdb_min_available=3),
                             [{"type": "reclaim-storm", "nodes": ["n0"]}]),
    "scale-down-up": (dict(n_nodes=4, web=6, api=0),
                      [{"type": "scale", "workload": {"kind": "Deployment", "name": "web"}, "replicas": 2},
                       {"type": "scale", "workload": {"kind": "Deployment", "name": "web"}, "replicas": 5}]),
    "scale-up-deployed": (dict(n_nodes=4, web=2, api=0),
                          [_canary(), {"type": "scale", "workload": {"kind": "Deployment", "name": "canary"},
                                       "replicas": 6}]),
    "add-nodes": (dict(n_nodes=3, web=9, api=0),
                  [{"type": "reclaim-storm", "nodes": ["n1", "n2"]},
                   {"type": "add-nodes", "count": 2, "template": {"node": "n0"}}]),
    "daemonsets": (dict(n_nodes=4, web=4, api=0, daemon=True),
                   [{"type": "reclaim-storm", "nodes": ["n1"]},
                    {"type": "add-nodes", "count": 2, "template": {"node": "n0"}}]),
    "scale-down-check": (dict(n_nodes=4, web=4, api=2, pdb_min_available=4),
                         [{"type": "scale-down-check"}, {"type": "scale-down-check"}]),
    "defrag": (dict(n_nodes=5, web=3, api=0), [{"type": "defrag", "maxNodes": 2, "wave": 1}]),
    # pending pods whose reasons carry static-filter counts (a taint, a node
    # selector) that differ by template, besides the fit shortages
    "static-reasons": (dict(n_nodes=4, web=8, api=3, taint_last=True, api_selector=True),
                       [{"type": "reclaim-storm", "nodes": ["n0", "n1"]}, _canary(4, "3")]),
}


def _both(cluster, raw_steps, mode="warm"):
    """(port result dict, reference result dict) of one campaign."""
    want = ref_cp.run_campaign(_reference_copy(cluster), ref_cp.parse_steps(copy.deepcopy(raw_steps)),
                               mode=mode).to_dict()
    got = cp.run_campaign(cluster, cp.parse_steps(copy.deepcopy(raw_steps)), mode=mode, device="cpu").to_dict()
    return got, want


@pytest.mark.parametrize("mode", ["warm", "cold"])
def test_mixed_steps_equal_reference(mode):
    got, want = _both(make_cluster(pdb_min_available=4), MIXED_STEPS, mode)
    assert got == want
    assert got["steps"][1]["evicted"] > 0 and got["steps"][3]["podsAdded"] == 3
    assert got["fullPrepares"] == (1 if mode == "warm" else want["fullPrepares"])


def test_mixed_steps_equal_xla_scan(xla_reference):
    got, want = _both(make_cluster(pdb_min_available=4), MIXED_STEPS)
    assert got == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_equals_reference(name):
    kwargs, raw = CASES[name]
    got, want = _both(make_cluster(**kwargs), raw)
    assert got == want
    if name == "static-reasons":
        reasons = {u["reason"] for s in got["steps"] for u in s["unschedulable"]}
        assert any("taints" in r for r in reasons) and any("node affinity" in r for r in reasons), reasons
    if name == "pdb-blocked":
        assert got["steps"][1]["blocked"] and not got["steps"][1]["nodesDrained"]


def test_tie_deciding_fleet_equals_reference(xla_reference):
    """The capacity plan's fleet (identical nodes, zones, soft zone spread)
    at small size, where equal scores are the rule and the lowest index
    decides: every pass runs the cfg variant under the default config,
    whose placements must be the reference's XLA scan's."""
    cluster = fx.synthetic_cluster(8)
    for w in fx.synthetic_apps(160).deployments:
        cluster.deployments.append(w)
    raw = fx.campaign_steps(8, 160, canary=8, drain=2, drain_wave=1, reclaim=2, add=1, scale_up=4, check=2,
                            defrag=3, defrag_max=1, defrag_wave=1)
    got, want = _both(cluster, raw)
    assert got == want
    assert sum(s["rescheduled"] for s in got["steps"]) > 20


def test_example_campaign_equals_reference(capsys):
    spec = os.path.join(ROOT, "example", "campaign.yaml")
    assert ref_cli.main(["campaign", spec, "--json"]) == 0
    want = capsys.readouterr().out
    assert cli.main(["campaign", spec, "--json", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert ref_cli.main(["campaign", spec]) == 0
    want = capsys.readouterr().out
    assert cli.main(["campaign", spec, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want


def test_campaign_plan_fixture_equals_reference(tmp_path, capsys):
    """The smoke run's campaign plan, written by the fixture at small size,
    through both CLIs (file mode), and in the port's cold mode too."""
    spec = fx.write_campaign_plan(tmp_path, 10, 200, canary=6, drain=2, drain_wave=1, reclaim=2, add=1,
                                  scale_up=4, check=2, defrag=3, defrag_max=1, defrag_wave=1)
    assert ref_cli.main(["campaign", spec, "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(["campaign", spec, "--json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == want
    assert cli.main(["campaign", spec, "--json", "--exec", "cold", "--device", "cpu"]) == 0
    cold = json.loads(capsys.readouterr().out)
    assert [s["fingerprint"] for s in cold["steps"]] == [s["fingerprint"] for s in got["steps"]]
    assert [s["type"] for s in got["steps"]] == ["baseline", "deploy", "drain-wave", "reclaim-storm", "add-nodes",
                                                 "scale", "scale-down-check", "defrag"]


WARM_COLD = {"mixed": (dict(pdb_min_available=4), MIXED_STEPS), "daemonsets": CASES["daemonsets"],
             "pdb-recovers": CASES["pdb-recovers"], "scale-down-up": CASES["scale-down-up"]}


@pytest.mark.parametrize("name", sorted(WARM_COLD))
def test_warm_equals_cold(name):
    kwargs, raw = WARM_COLD[name]
    warm = cp.run_campaign(make_cluster(**kwargs), cp.parse_steps(raw), mode="warm", device="cpu")
    cold = cp.run_campaign(make_cluster(**kwargs), cp.parse_steps(raw), mode="cold", device="cpu")
    assert warm.full_prepares == 1 and cold.full_prepares > 1
    assert [s.fingerprint for s in warm.steps] == [s.fingerprint for s in cold.steps]
    assert warm.fingerprint == cold.fingerprint


def test_deterministic_across_runs():
    a = cp.run_campaign(make_cluster(pdb_min_available=4), cp.parse_steps(MIXED_STEPS), device="cpu")
    b = cp.run_campaign(make_cluster(pdb_min_available=4), cp.parse_steps(MIXED_STEPS), device="cpu")
    assert [s.fingerprint for s in a.steps] == [s.fingerprint for s in b.steps] and a.fingerprint == b.fingerprint


BAD_SPECS = {
    "unknown-type": [{"type": "explode"}],
    "unknown-field": [{"name": "d", "type": "drain-wave", "nodes": ["n0"], "wavee": 2}],
    "wave-zero": [{"type": "drain-wave", "nodes": ["n0"], "wave": 0}],
    "no-selection": [{"type": "drain-wave"}],
    "replicas": [{"type": "scale", "workload": {"name": "w"}, "replicas": "many"}],
    "template": [{"type": "add-nodes", "count": 2}],
    "not-a-list": "not-a-list",
    "count": [{"type": "reclaim-storm", "count": 0}],
    "percent": [{"type": "drain-wave", "percent": 150}],
    "selector": [{"type": "drain-wave", "selector": "x"}],
    "wave-percent": [{"type": "drain-wave", "nodes": ["n0"], "wavePercent": "x"}],
    "respect-pdbs": [{"type": "drain-wave", "nodes": ["n0"], "respectPdbs": "yes"}],
    "deploy-app": [{"type": "deploy"}],
    "deploy-path": [{"type": "deploy", "app": {"name": "a"}}],
    "workload": [{"type": "scale", "replicas": 1}],
    "max-nodes": [{"type": "defrag", "maxNodes": 0}],
    "journal": [{"type": "from-journal"}],
    "generations": [{"type": "from-journal", "journal": "j", "fromGeneration": "x"}],
    "step-mapping": [3],
    "missing-type": [{"name": "x"}],
}


@pytest.mark.parametrize("name", sorted(BAD_SPECS))
def test_spec_errors_name_the_references_step_and_field(name):
    with pytest.raises(ref_cp.CampaignError) as want:
        ref_cp.parse_steps(copy.deepcopy(BAD_SPECS[name]))
    with pytest.raises(cp.CampaignError) as got:
        cp.parse_steps(copy.deepcopy(BAD_SPECS[name]))
    assert (got.value.step, got.value.field, str(got.value)) == (want.value.step, want.value.field, str(want.value))


RUN_ERRORS = {
    "unknown-node": [{"type": "drain-wave", "nodes": ["ghost"]}],
    "unknown-workload": [{"type": "scale", "workload": {"kind": "Deployment", "name": "ghost"}, "replicas": 9}],
    "unknown-template-node": [{"type": "add-nodes", "template": {"node": "ghost"}}],
    "app-daemonset": [{"type": "deploy", "resources": [fx.make_fake_daemon_set("ds").raw]}],
}


@pytest.mark.parametrize("name", sorted(RUN_ERRORS))
def test_run_errors_name_the_references_step_and_field(name):
    with pytest.raises(ref_cp.CampaignError) as want:
        ref_cp.run_campaign(_reference_copy(make_cluster()), ref_cp.parse_steps(RUN_ERRORS[name]), mode="warm")
    with pytest.raises(cp.CampaignError) as got:
        cp.run_campaign(make_cluster(), cp.parse_steps(RUN_ERRORS[name]), mode="warm", device="cpu")
    assert (got.value.step, got.value.field, str(got.value)) == (want.value.step, want.value.field, str(want.value))


def test_wave_and_step_bounds(monkeypatch):
    monkeypatch.setenv("OPENSIM_CAMPAIGN_MAX_WAVES", "2")
    steps = cp.parse_steps([{"name": "big", "type": "drain-wave", "nodes": ["n0", "n1", "n2"], "wave": 1}])
    with pytest.raises(cp.CampaignError) as ei:
        cp.run_campaign(make_cluster(), steps, mode="warm", device="cpu")
    assert ei.value.field == "wave" and "MAX_WAVES" in str(ei.value)
    monkeypatch.setenv("OPENSIM_CAMPAIGN_MAX_STEPS", "2")
    with pytest.raises(cp.CampaignError) as ei:
        cp.parse_steps([{"type": "scale-down-check"}] * 3)
    assert ei.value.field == "steps"
    monkeypatch.setenv("OPENSIM_CAMPAIGN_EXEC", "tepid")
    with pytest.raises(ValueError):
        cp.exec_mode()
    with pytest.raises(cp.CampaignError) as ei:
        cp.run_campaign(make_cluster(), cp.parse_steps(MIXED_STEPS[:1]), mode="tepid", device="cpu")
    assert ei.value.field == "mode"


def test_env_knobs_registered():
    for name in ("OPENSIM_CAMPAIGN_EXEC", "OPENSIM_CAMPAIGN_MAX_STEPS", "OPENSIM_CAMPAIGN_MAX_WAVES",
                 "OPENSIM_CAPACITY_TOPK", "OPENSIM_CAPACITY_TIMELINE_N", "OPENSIM_HEADROOM_PROFILES"):
        assert name in envknobs.KNOBS
        envknobs.value(name)
    assert (cp.exec_mode(), cp.max_steps(), cp.max_waves()) == ("warm", 256, 64)


def _journal_pods(jdir):
    """tests/test_campaign.py's recorded range, written by the port's
    journal: four pods ADDED (two bound to n1), then the first DELETED."""
    from opensim_tpu_torch.server.journal import Journal

    j = Journal(jdir, policy={"fsync": "off"})
    try:
        rv, gen = 100, 10
        for i in range(4):
            rv, gen = rv + 1, gen + 1
            pod = {"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": f"j-{i}", "namespace": "default", "resourceVersion": str(rv)},
                   "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "500m",
                                                                                    "memory": "1Gi"}}}]},
                   "status": {"phase": "Pending"}}
            if i < 2:
                pod["spec"]["nodeName"] = "n1"
                pod["status"]["phase"] = "Running"
            j.record_event("pods", "ADDED", pod, gen)
        j.record_event("pods", "DELETED", {"metadata": {"name": "j-0", "namespace": "default",
                                                        "resourceVersion": str(rv + 1)}}, gen + 1)
    finally:
        j.close()


@pytest.mark.parametrize("mode", ["warm", "cold"])
def test_from_journal_step_equals_reference(xla_reference, tmp_path, mode):
    """A recorded generation range replays through the campaign's apply
    path as the JAX package replays it: the NET effect of the window (j-0
    added, then deleted inside it, never materializes), the bound add
    force-bound, the unbound adds scheduled; warm equal to cold."""
    jdir = str(tmp_path / "journal")
    _journal_pods(jdir)
    raw = [{"type": "from-journal", "journal": jdir, "fromGeneration": 10, "toGeneration": 15}]
    got, want = _both(make_cluster(n_nodes=3, web=2, api=0), raw, mode)
    assert got == want
    s = got["steps"][1]
    assert s["journalEvents"] == 5 and s["podsAdded"] == 3 and s["deleted"] == 0
    assert s["capacity"]["pods_bound"] == 2 + 3 and not s["unschedulable"]
    other = "cold" if mode == "warm" else "warm"
    again = cp.run_campaign(make_cluster(n_nodes=3, web=2, api=0), cp.parse_steps(raw), mode=other, device="cpu")
    assert again.fingerprint == got["fingerprint"]


def test_from_journal_node_modify_reported_not_silent(tmp_path):
    """A MODIFIED of a node the campaign tracks is outside the delta
    envelope: reported in the step, as the reference reports it."""
    from opensim_tpu_torch.server.journal import Journal

    jdir = str(tmp_path / "journal")
    j = Journal(jdir, policy={"fsync": "off"})
    try:
        node = json.loads(json.dumps(fx.make_fake_node("n0", "4", "8Gi").raw))
        node["metadata"]["resourceVersion"] = "7"
        j.record_event("nodes", "MODIFIED", node, 11)
    finally:
        j.close()
    got, want = _both(make_cluster(n_nodes=2, web=1, api=0),
                      [{"type": "from-journal", "journal": jdir, "fromGeneration": 10}])
    assert got == want
    s = got["steps"][1]
    assert s["journalEvents"] == 1 and any("MODIFIED skipped" in u["reason"] for u in s["unschedulable"])


def test_from_journal_generation_window():
    """A path that is no journal directory is the typed error on the
    ``journal`` field, as the reference's."""
    raw = [{"type": "from-journal", "journal": "/nonexistent", "fromGeneration": 1}]
    with pytest.raises(cp.CampaignError) as ei:
        cp.run_campaign(make_cluster(n_nodes=2, web=1, api=0), cp.parse_steps(raw), mode="warm", device="cpu")
    with pytest.raises(ref_cp.CampaignError) as ref_ei:
        ref_cp.run_campaign(_reference_copy(make_cluster(n_nodes=2, web=1, api=0)), ref_cp.parse_steps(raw),
                            mode="warm")
    assert ei.value.field == ref_ei.value.field == "journal"


def test_report_parity_and_drain_rows():
    import io

    d = cp.run_campaign(make_cluster(pdb_min_available=4), cp.parse_steps(MIXED_STEPS), device="cpu").to_dict()
    rows = report_mod.campaign_step_rows(d["steps"])
    assert [d["table"]["header"]] + d["table"]["rows"] == rows
    out = io.StringIO()
    report_mod.render_campaign(d, out)
    for row in rows:
        for cell in row:
            assert cell == "" or cell in out.getvalue()
    assert d["fingerprint"] in out.getvalue()
    from opensim_tpu_torch.planner.defrag import DrainPlan

    plans = [DrainPlan(node="n0", feasible=True, unscheduled=0, freed_cpu_milli=8000, freed_memory=2**34),
             DrainPlan(node="n1", feasible=False, unscheduled=3, freed_cpu_milli=4000, freed_memory=2**33)]
    assert report_mod.drain_plan_rows(plans) == [["Node", "Drainable", "Unscheduled", "Freed CPU", "Freed Memory"],
                                                 ["n0", "√", "0", "8", "16Gi"], ["n1", "", "3", "4", "8Gi"]]


def test_paths_are_validated():
    with pytest.raises(cp.CampaignError):
        cp._resolve_path("bad\tpath")
    with pytest.raises(cp.CampaignError):
        cp.load_campaign_cluster(cp.CampaignSpec(name="x", steps=[], cluster={"customConfig": "a\nb"}))
    assert cp._resolve_path("plain/relative.yaml") == "plain/relative.yaml"
    with cp.remote_spec_context():
        with pytest.raises(cp.CampaignError, match="REST"):
            cp._resolve_path("/etc/passwd")
    with pytest.raises(ValueError):
        validate.child_path("/specs/dir", "../../etc/passwd")
    assert validate.child_path("/specs/dir", "sub/app.yaml") == "/specs/dir/sub/app.yaml"
    assert validate.child_path("/specs/dir", "/abs/path.yaml") == "/abs/path.yaml"


def test_rest_campaign_equals_reference():
    """``POST /api/campaign`` of the port's server (on the CPU) against the
    JAX package's, on one fixed cluster: the same 200 body and the same
    typed 400s."""
    port = rest.SimonServer(base_cluster=make_cluster(pdb_min_available=4), device="cpu")
    ref = ref_rest.SimonServer(base_cluster=_reference_copy(make_cluster(pdb_min_available=4)), admission=False)
    try:
        for body in ({"name": "t", "steps": MIXED_STEPS}, {"steps": [{"type": "explode"}]},
                     {"steps": MIXED_STEPS, "mode": "tepid"},
                     {"steps": [{"type": "add-nodes", "template": {"path": "/etc"}}]}):
            got = port.run_campaign(copy.deepcopy(body))
            want = ref.run_campaign(copy.deepcopy(body))
            assert got == want
        assert got[0] == 400 and got[1]["field"] == "path"
        code, body = port.run_campaign({"name": "t", "steps": MIXED_STEPS})
        assert code == 200 and body["fullPrepares"] == 1 and len(body["steps"]) == 5
    finally:
        ref.close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal without a card")
def test_without_a_card_the_campaign_raises(capsys):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cp.run_campaign(make_cluster(), cp.parse_steps(MIXED_STEPS[:1]))
    assert cli.main(["campaign", os.path.join(ROOT, "example", "campaign.yaml")]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_carried_state_continues_the_scan(name):
    """A launch from ``carried_state`` of the host's replayed state (what a
    campaign pass starts from) places the rest of the stream as a launch
    from the kernel's own state does, and gives the same final state on
    every field the kernel reads: usage, GPU, port, volume-group and device
    state, and each count table under the keys that read it."""
    cluster, app, node_pad = fx.scan_case(name)
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device="cpu")
    P = len(prep.tmpl_ids)
    k = P // 2
    nv = np.asarray(prep.ec_np.node_valid, bool)
    fi, _meta = fastpath.build_inputs(prep, node_valid=nv, segment=True)
    stream = fastpath.pod_stream(prep)
    init0 = fastpath.carried_state(prep, fi, prep.st0_np)
    assert fs.variant(fi).cfg
    head = fs.fast_scan(fi, *(t[:k] for t in stream), init=init0)
    chosen = np.concatenate([head.chosen.numpy(), np.full(P - k, -1, np.int32)])
    gd = prep.st0_np.gpu_free.shape[1]
    take = head.gpu_take.numpy() if head.gpu_take.shape[1] else np.zeros((k, gd), np.float32)
    st = replay_state(prep, chosen, np.concatenate([take, np.zeros((P - k, gd), np.float32)]), upto=P)
    tail_kernel = fs.fast_scan(fi, *(t[k:] for t in stream), init=head.state)
    tail_carried = fs.fast_scan(fi, *(t[k:] for t in stream), init=fastpath.carried_state(prep, fi, st))
    for field in fs.FastOutputs._fields[:-1]:
        assert torch.equal(getattr(tail_kernel, field), getattr(tail_carried, field)), field
    whole = fs.fast_scan(fi, *stream, init=init0)
    assert torch.equal(whole.chosen[k:], tail_carried.chosen)
    a, b = fs.unpack_state(fi, tail_kernel.state), fs.unpack_state(fi, tail_carried.state)
    for field in ("used", "zone_cnt", "gpu_free", "port_used", "anti_zone", "vg_free", "dev_free"):
        assert torch.equal(a[field], b[field]), field
    topo = prep.meta.vocab.topo_keys.items()
    if fastpath.HOSTNAME in topo:
        assert torch.equal(a["node_cnt"], b["node_cnt"])
    assert torch.equal(fs.pack_state(fi, fs.unpack_state(fi, head.state)), head.state)


@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_schedule_from_the_prepared_state_as_a_carried_state(name):
    """``schedule(forced=, init=)`` (a campaign pass) from the prepared
    state rebuilt on the host, with the stream's own forced pods, gives what
    the same launch from the kernel's own initial state gives, on every
    output; the stream takes the caller's forced vector."""
    cluster, app, node_pad = fx.scan_case(name)
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device="cpu")
    P = len(prep.tmpl_ids)
    built = fastpath.build_inputs(prep, segment=True)
    want = fastpath.schedule(prep, [(built, 0, P)])
    got = fastpath.schedule(prep, [(built, 0, P)], forced=np.asarray(prep.forced, bool), init=prep.st0_np)
    for field, a, b in zip(fastpath.Scheduled._fields, want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)
    assert torch.equal(fastpath.pod_stream(prep, forced=np.asarray(prep.forced, bool))[2], fastpath.pod_stream(prep)[2])
    assert fastpath.pod_stream(prep, forced=np.zeros(P, bool))[2].sum() == 0
