"""Scheduler configs and the sampled tie-break through the port, on the CPU
(plain versions), against the JAX package.

- The config matrix: under changed weights, each dynamic filter disabled
  in turn, and fit-ignored resource columns, the port's plain bind scan
  equals the JAX package's XLA scan (``scheduler.schedule_pods(config=)``)
  on the placements, failure counts, shortages, GPU takes and final
  state, bit for bit; the static first-fail counts too. One small case
  per kind runs here; the whole matrix (``fixtures.SCAN_CASES``, the fuzz
  generators of tests/test_fastpath_fuzz.py and the ports, gpu, local and
  mixed seeds of tests/test_native.py) is ``slow``.
- A config equal to the default runs the default variant; a stream split
  into two launches with the state carried equals one launch.
- The cases of tests/test_schedconfig.py (but its two extra_plugins
  cases) through the port's simulate(), sweep_auto() and Applier: each
  node's pods in stream order and every reason string equal the JAX
  package's; its segmented and sweep cases too.
- The sampled tie-break: Philox-4x32-10's known answers, a chi-square test
  of the choice among six equal nodes over 600 seeds, the same seed giving
  the same placements, and every sampled bind score-optimal by the
  independent oracle of tests/test_k8s_oracle.py."""

import copy
import dataclasses
import pathlib
import random
import re
import sys

import numpy as np
import pytest
import torch

from opensim_tpu.engine import schedconfig as ref_sc, simulator as ref_sim
from opensim_tpu.engine.scheduler import pad_pod_stream, schedule_pods
from opensim_tpu.models import expand as ref_expand
from opensim_tpu.parallel import scenarios as ref_scenarios
from opensim_tpu.planner import apply as ref_apply
from opensim_tpu_torch.engine import fastpath, schedconfig, simulator as sim
from opensim_tpu_torch.models import expand, fixtures as fx
from opensim_tpu_torch.models.objects import ResourceTypes
from opensim_tpu_torch.ops import fast_scan as fs, kernels
from opensim_tpu_torch.parallel import scenarios
from opensim_tpu_torch.planner import apply

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_fast_scan import _port_prep, _ref_prep, _stream  # noqa: E402

CASES = [c[0] for c in fx.SCAN_CASES]


def _reference_copy(rt):
    """The same objects in the JAX package's object model, rebuilt from
    their manifests: only plain dicts cross between the packages."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


def _port_copy(rt):
    """The same objects in the port's object model, from their manifests."""
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    port, skipped = expand.resources_from_dicts(docs)
    assert not skipped
    return port


def _names(text: str) -> str:
    """Pod and new-node names without their process-global counters."""
    return re.sub(r"-[0-9a-f]{10}\b", "-#", re.sub(r"simon-[0-9a-f]{8}\b", "simon-#", text))


def _outcome(res):
    """Each node's pods in bucket (stream) order and the unscheduled pods
    with their reasons, names without counters."""
    nodes = [(ns.node.metadata.name, [_names(q.metadata.name) for q in ns.pods]) for ns in res.node_status]
    return nodes, [(_names(u.pod.metadata.name), _names(u.reason)) for u in res.unscheduled_pods]


# --- the config matrix ----------------------------------------------------------

#: The config kinds: changed weights (the static filters' switches with
#: them), each dynamic filter off in turn, a fit-ignored resource column.
KINDS = {
    "weights": dict(w_balanced=0.0, w_least=3.0, w_node_affinity=2.0, w_taint_toleration=5.0, w_interpod=2.0,
                    w_spread=1.0, w_prefer_avoid=0.0, w_simon=0.5, w_gpu_share=0.25, w_local=3.0, f_taints=False,
                    f_unschedulable=False),
    **{f"no_{f}": {f"f_{f}": False} for f in ("ports", "fit", "spread", "interpod", "gpu", "local")},
    "fit_ignored": dict(fit_ignored_cols=(0,)),
}


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.shape(got) == np.shape(want)


def _config_parity(ref, port, kw):
    """The port's plain version under config `kw` against the XLA scan on
    the same input: placements, failure counts, shortages, GPU takes, the
    final state and the static first-fail counts. Returns the placements."""
    P = len(ref.ordered)
    t, v, f = pad_pod_stream(ref.tmpl_ids, np.ones(P, bool), ref.forced)
    out = schedule_pods(ref.ec, ref.st0, t, v, f, features=ref.features, config=ref_sc.SchedulerConfig(**kw))
    fi, meta = fastpath.build_inputs(port, cfg=schedconfig.SchedulerConfig(**kw))
    assert fs.variant(fi).cfg
    got = fs.fast_scan_reference(fi, *_stream(port))
    chosen = np.asarray(out.chosen)[:P]
    _exact(got.chosen.numpy(), chosen)
    R = got.insufficient.shape[1]
    _exact(got.fail_counts.numpy(), np.asarray(out.fail_counts)[:P])
    _exact(got.insufficient.numpy(), np.asarray(out.insufficient)[:P, :R])
    assert not np.asarray(out.insufficient)[:, R:].any()
    _exact(meta["static_fail"], np.asarray(out.static_fail))
    st = out.final_state
    _exact(got.used.T.numpy(), st.used)
    Hp = got.port_used.shape[0]
    _exact(got.port_used.T.numpy(), np.asarray(st.port_used)[:, :Hp])
    if port.features.gpu:
        _exact(got.gpu_take.numpy(), np.asarray(out.gpu_take)[:P])
        _exact(got.gpu_free.T.numpy(), st.gpu_free)
    if port.features.local:
        _exact(got.vg_free.T.numpy(), st.vg_free)
        _exact(got.dev_free.T.numpy(), st.dev_free)
    return chosen


def _default_chosen(ref):
    P = len(ref.ordered)
    t, v, f = pad_pod_stream(ref.tmpl_ids, np.ones(P, bool), ref.forced)
    return np.asarray(schedule_pods(ref.ec, ref.st0, t, v, f, features=ref.features).chosen)[:P]


@pytest.mark.parametrize("kind,name", [("weights", "scores"), ("no_spread", "fail_spread"),
                                       ("fit_ignored", "fail_fit")])
def test_config_matches_xla_scan(kind, name):
    """One small case of each kind, chosen so that the config decides
    placements: the score tables under new weights, the hard spread
    constraint that failed pods, the cpu shortage that failed pods."""
    ref = _ref_prep(name)
    chosen = _config_parity(ref, _port_prep(name), KINDS[kind])
    assert not np.array_equal(chosen, _default_chosen(ref))


def _generated(source: str, seed: int):
    """(JAX prep, port prep) of a generated workload: tests/test_fastpath_fuzz.py's
    random cluster and app, or a tests/test_native.py fuzz case, both
    packages preparing the same manifests."""
    import test_native
    from test_fastpath_fuzz import random_app, random_cluster

    rng = random.Random(seed)
    if source == "fuzz":
        cluster, app = random_cluster(rng, rng.randrange(6, 14)), random_app(rng, rng.randrange(3, 7))
    else:
        cluster, app = getattr(test_native, f"_{source}_fuzz_case")(rng)
    ref = ref_sim.prepare(_reference_copy(cluster), [ref_sim.AppResource("a", _reference_copy(app))], node_pad=8)
    port = sim.prepare(_port_copy(cluster), [sim.AppResource("a", _port_copy(app))], node_pad=8, device="cpu")
    assert np.array_equal(ref.tmpl_ids, port.tmpl_ids)
    return ref, port


GENERATED = ([("fuzz", s) for s in (3, 17, 29)] + [("ports", s) for s in (211, 223, 251)]
             + [("gpu", s) for s in (307, 311, 331)] + [("local", s) for s in (401, 409, 419)]
             + [("storm", s) for s in (503, 509, 521)])


@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("name", CASES)
def test_config_matrix_on_the_small_cases(kind, name):
    _config_parity(_ref_prep(name), _port_prep(name), KINDS[kind])


@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("source,seed", GENERATED)
def test_config_matrix_on_generated_workloads(kind, source, seed):
    _config_parity(*_generated(source, seed), KINDS[kind])


def test_kernel_config_packs_the_reference_weights():
    cfg = schedconfig.SchedulerConfig(w_least=3.0, w_simon=0.1, w_gpu_share=0.6, f_gpu=False, fit_ignored_cols=(2, 0))
    kc = kernels.kernel_config(cfg, 4)
    # Simon + Open-Gpu-Share in double, then one rounding to float32
    assert kc.weights[kernels.SCORE_PARTS.index("share")] == float(np.float32(0.1 + 0.6)) != float(
        np.float32(np.float32(0.1) + np.float32(0.6)))
    assert kc.weights[:2] == (1.0, 3.0) and kc.fit_ignored == 0b101
    assert kc.filters == 0b101111  # all but gpu (bit F_GPU - F_PORTS)
    assert kernels.kernel_config(schedconfig.DEFAULT_CONFIG, 4) is None and kernels.kernel_config(None, 4) is None
    with pytest.raises(ValueError, match="fit_ignored_cols"):
        kernels.kernel_config(cfg._replace(fit_ignored_cols=(4,)), 4)
    assert list(kernels.SCORE_PARTS) == [w[len("w_"):] for w in fs._CFG_WEIGHTS]


def test_an_explicit_default_config_takes_the_default_variant():
    port = _port_prep("scores")
    fi, _ = fastpath.build_inputs(port, cfg=schedconfig.DEFAULT_CONFIG)
    assert fi.cfg is None and fs.variant_name(fi) == "fast_scan[na,tt,avoid]"
    cluster, app, pad = fx.scan_case("scores")
    a = sim.simulate(cluster, [sim.AppResource("a", app)], node_pad=pad, device="cpu",
                     sched_config=schedconfig.DEFAULT_CONFIG)
    cluster, app, pad = fx.scan_case("scores")
    b = sim.simulate(cluster, [sim.AppResource("a", app)], node_pad=pad, device="cpu")
    assert _outcome(a) == _outcome(b) and a.engine == b.engine == "fast_scan[na,tt,avoid] on cpu"


# --- carried state --------------------------------------------------------------

SPLIT_CASES = ["spread", "gpu_dyn", "interpod_terms", "ports", "local_rules", "fail_mixed"]
#: The final-state outputs (the rest are per pod).
STATE_ROWS = ("used", "gpu_free", "port_used", "vg_free", "dev_free", "state")


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_a_split_stream_with_carried_state_equals_one_launch(name):
    """The stream cut at three points into two launches, the second from
    the first's final state, under a config: equal to one launch on every
    output, the final state row included; the same for a grid of three
    drain scenarios, each scenario carrying its own state."""
    from opensim_tpu_torch.planner import defrag

    port = _port_prep(name)
    fi, _ = fastpath.build_inputs(port, cfg=schedconfig.SchedulerConfig(**KINDS["weights"]))
    tmpl, valid, forced = _stream(port)
    whole = fs.fast_scan_reference(fi, tmpl, valid, forced)
    P = tmpl.shape[0]
    for k in (1, P // 3, P - 1):
        a = fs.fast_scan_reference(fi, tmpl[:k], valid[:k], forced[:k])
        b = fs.fast_scan_reference(fi, tmpl[k:], valid[k:], forced[k:], init=a.state)
        for field in ("chosen", "gpu_take", "fail_counts", "insufficient"):
            assert torch.equal(torch.cat([getattr(a, field), getattr(b, field)]), getattr(whole, field)), (k, field)
        for field in STATE_ROWS:
            assert torch.equal(getattr(b, field), getattr(whole, field)), (k, field)
    grid = fastpath.sweep_inputs(port, *defrag.drain_masks(port, list(range(min(3, len(port.meta.node_names))))))
    tmpl_g, rest = grid[0], grid[1:]
    whole_g = fs.fast_scan_sweep_reference(fi, tmpl_g, *rest)
    k = P // 2
    cut = lambda sl: [t[:, sl].contiguous() for t in rest[:2]] + list(rest[2:])
    a = fs.fast_scan_sweep_reference(fi, tmpl_g[:k], *cut(slice(None, k)))
    b = fs.fast_scan_sweep_reference(fi, tmpl_g[k:], *cut(slice(k, None)), init=a.state)
    assert torch.equal(torch.cat([a.chosen, b.chosen], 1), whole_g.chosen)
    assert all(torch.equal(getattr(b, f), getattr(whole_g, f)) for f in STATE_ROWS)


def test_state_row_holds_the_selector_counts():
    port = _port_prep("interpod_terms")
    fi, _ = fastpath.build_inputs(port)
    out = fs.fast_scan_reference(fi, *_stream(port))
    rows = fs.unpack_state(fi, out.state)
    assert out.state.shape == (fs.state_width(fi),) and torch.equal(rows["used"], out.used)
    A = fi.matches_AU.shape[0]
    placed = int((out.chosen >= 0).sum())
    sel = rows["sel_total"]
    assert torch.equal(sel[:A], rows["node_cnt"].sum(1)) and sel.numel() == (fi.zone_idx.shape[0] + 1) * A
    assert rows["node_cnt"].sum() == (fi.matches_AU[:, port.tmpl_ids[out.chosen.numpy() >= 0]]).sum() and placed > 0


# --- the sampled tie-break --------------------------------------------------------

def test_philox_known_answers():
    """Random123's known answers for Philox-4x32-10: the first word at
    counter 0 and key 0, and the word for each (pod, node) as the full
    generator computes it."""
    assert int(fs.philox_draws(0, torch.tensor([0]), 1)[0, 0]) == 0x6627E8D5
    M = 0xFFFFFFFF

    def full(c, k):
        for r in range(10):
            if r:
                k = [(k[0] + 0x9E3779B9) & M, (k[1] + 0xBB67AE85) & M]
            p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
            c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & M, (p0 >> 32) ^ c[3] ^ k[1], p0 & M]
        return c

    assert full([M] * 4, [M, M]) == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    seed = -12345678901
    d = fs.philox_draws(seed, torch.arange(3, 8), 5)
    key = seed & (2 ** 64 - 1)
    assert [[int(x) for x in row] for row in d] == [
        [full([p, n, 0, 0], [key & M, key >> 32])[0] for n in range(5)] for p in range(3, 8)]


def _six_equal_nodes():
    cluster = ResourceTypes()
    for i in range(6):
        cluster.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi"))
    app = ResourceTypes()
    app.pods.append(fx.make_fake_pod("p", "100m", "128Mi"))
    return cluster, [sim.AppResource("a", app)]


def test_sampled_choice_is_uniform_over_the_maxima():
    """Six identical nodes, one pod, 600 seeds: every node is chosen, and
    the counts pass a chi-square test of uniformity at p > 1e-3 (5 degrees
    of freedom: statistic below 20.515)."""
    port = sim.prepare(*_six_equal_nodes(), node_pad=8, device="cpu")
    fi, _ = fastpath.build_inputs(port)
    stream = _stream(port)
    counts = np.zeros(8, np.int64)
    for seed in range(600):
        c = int(fs.fast_scan_reference(fi, *stream, tie_seed=seed).chosen[0])
        counts[c] += 1
    assert counts[6:].sum() == 0 and (counts[:6] > 0).all()
    chi2 = float((((counts[:6] - 100.0) ** 2) / 100.0).sum())
    assert chi2 < 20.515, counts


def test_tie_break_sample_covers_equal_score_set():
    """tests/test_schedconfig.py:385 through the port: over ten seeds the
    sampled choice leaves the lowest index, and simulate() with a seed
    still places the pod."""
    assert sim.parse_tie_break("lowest") is None and sim.parse_tie_break("sample") == 0
    assert sim.parse_tie_break("sample:7") == 7
    with pytest.raises(ValueError):
        sim.parse_tie_break("bogus")
    det = sim.simulate(*_six_equal_nodes(), node_pad=8, device="cpu")
    assert not det.unscheduled_pods and det.placements.tolist() == [0]
    port = sim.prepare(*_six_equal_nodes(), node_pad=8, device="cpu")
    fi, _ = fastpath.build_inputs(port)
    landed = {int(fs.fast_scan_reference(fi, *_stream(port), tie_seed=s).chosen[0]) for s in range(10)}
    assert len(landed) > 1 and min(landed) >= 0
    res = sim.simulate(*_six_equal_nodes(), node_pad=8, device="cpu", tie_seed=3)
    assert not res.unscheduled_pods and sum(len(ns.pods) for ns in res.node_status) == 1
    assert res.engine == "fast_scan[sample] on cpu"


@pytest.mark.parametrize("workload", ["oracle", "ties"])
def test_tie_break_sampled_binds_stay_score_optimal(workload):
    """tests/test_schedconfig.py:429 through the port: a sampled run on an
    affinity-bearing workload (its seed 29), and on the uniform fleet of
    ``fixtures.scan_case("ties")`` where most steps tie, keeps every bind
    score-optimal by the independent kube oracle; the same seed places the
    same way twice; the plain version's own record agrees (each choice
    among its step's maxima); on the uniform fleet the choices leave the
    lowest index's."""
    from test_k8s_oracle import _replay_with_scores, random_app, random_cluster

    if workload == "oracle":
        rng = random.Random(29)
        cluster, app = random_cluster(rng, 8), random_app(rng, 5)
        cluster, app = _port_copy(cluster), _port_copy(app)
    else:
        cluster, app, _pad = fx.scan_case("ties")
    ref_cluster, ref_app = _reference_copy(cluster), _reference_copy(app)
    ref = ref_sim.prepare(ref_cluster, [ref_sim.AppResource("oracle", ref_app)], node_pad=8)
    port = sim.prepare(cluster, [sim.AppResource("oracle", app)], node_pad=8, device="cpu")
    assert np.array_equal(ref.tmpl_ids, port.tmpl_ids)
    fi, _ = fastpath.build_inputs(port)
    stats = {}
    out = fs.fast_scan_reference(fi, *_stream(port), tie_seed=11, stats=stats)
    again = fs.fast_scan_reference(fi, *_stream(port), tie_seed=11)
    assert torch.equal(out.chosen, again.chosen)
    assert _replay_with_scores(ref, ref_cluster, out.chosen.numpy()) == 0
    assert bool(stats["at_max"].all())
    if workload == "ties":
        lowest = fs.fast_scan_reference(fi, *_stream(port)).chosen
        assert int(stats["ties"].max()) > 1 and (out.chosen != lowest).float().mean() > 0.25


# --- tests/test_schedconfig.py through the port -----------------------------------

def _write(tmp_path, text, name="sched.yaml"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _scheduler(obj, name):
    """Select profile `name` on a pod or a workload's pod template, in its
    manifest and in its parsed spec."""
    if hasattr(obj, "template_spec"):
        obj.template_spec.scheduler_name = name
        obj.raw["spec"]["template"].setdefault("spec", {})["schedulerName"] = name
        obj.template_raw.setdefault("spec", {})["schedulerName"] = name
    else:
        obj.spec.scheduler_name = name
        obj.raw.setdefault("spec", {})["schedulerName"] = name
    return obj


def _both(tmp_path, cluster, apps, config=None, kw=None, **opts):
    """The port's simulate() and the JAX package's on the same manifests
    and the same config (a file's text, or SchedulerConfig fields)."""
    if config is not None:
        path = _write(tmp_path, config)
        port_cfg, ref_cfg = schedconfig.load_scheduler_config(path), ref_sc.load_scheduler_config(path)
    elif kw is not None:
        port_cfg, ref_cfg = schedconfig.SchedulerConfig(**kw), ref_sc.SchedulerConfig(**kw)
    else:
        port_cfg = ref_cfg = None
    ref = ref_sim.simulate(_reference_copy(cluster), [ref_sim.AppResource(n, _reference_copy(a)) for n, a in apps],
                           sched_config=ref_cfg, **opts)
    port = sim.simulate(cluster, [sim.AppResource(n, a) for n, a in apps], sched_config=port_cfg, device="cpu",
                        **opts)
    assert _outcome(port) == _outcome(ref)
    return port, ref


_ONE_PROFILE = """apiVersion: kubescheduler.config.k8s.io/v1beta1
kind: KubeSchedulerConfiguration
profiles:
  - plugins:
      score:
        enabled:
          - name: NodeResourcesLeastAllocated
            weight: 5
        disabled:
          - name: PodTopologySpread
      filter:
        disabled:
          - name: TaintToleration
"""


def test_load_scheduler_config(tmp_path):
    path = _write(tmp_path, _ONE_PROFILE)
    cfg = schedconfig.load_scheduler_config(path)
    assert cfg._asdict() == ref_sc.load_scheduler_config(path)._asdict()
    assert cfg.w_least == 5.0 and cfg.w_spread == 0.0 and not cfg.f_taints and cfg.f_fit and cfg.w_balanced == 1.0


def _tainted(*more):
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("tainted", "8", "16Gi", "110",
                                           fx.with_taints([{"key": "d", "value": "x", "effect": "NoSchedule"}])))
    cluster.nodes.extend(more)
    return cluster


def test_disabled_taint_filter_schedules_onto_tainted_node(tmp_path):
    app = ResourceTypes()
    app.pods.append(fx.make_fake_pod("p", "100m", "128Mi"))
    blocked, _ = _both(tmp_path, _tainted(), [("a", app)])
    assert len(blocked.unscheduled_pods) == 1
    res, _ = _both(tmp_path, _tainted(), [("a", app)], kw=dict(f_taints=False))
    assert not res.unscheduled_pods and res.engine == "fast_scan[cfg] on cpu"


def test_default_config_file_is_identity(tmp_path):
    path = _write(tmp_path, "apiVersion: kubescheduler.config.k8s.io/v1beta1\nkind: KubeSchedulerConfiguration\n")
    assert schedconfig.load_scheduler_config(path) == schedconfig.DEFAULT_CONFIG


def test_node_prefer_avoid_pods(tmp_path):
    """An RS-owned pod avoids the annotated node; with the plugin's weight
    0 it no longer does."""
    import json as _json

    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("avoided", "8", "16Gi"))
    cluster.nodes.append(fx.make_fake_node("ok", "8", "16Gi"))
    rs = fx.make_fake_replica_set("web", 2, "100m", "128Mi", lambda d: d["metadata"].update(uid="rs-web"))
    cluster.nodes[0].raw["metadata"].setdefault("annotations", {})[
        "scheduler.alpha.kubernetes.io/preferAvoidPods"] = _json.dumps(
        {"preferAvoidPods": [{"podSignature": {"podController": {"kind": "ReplicaSet", "uid": "rs-web"}}}]})
    cluster = _port_copy(cluster)
    app = ResourceTypes()
    app.replica_sets.append(rs)
    res, _ = _both(tmp_path, cluster, [("a", app)])
    placed = {ns.node.metadata.name: len(ns.pods) for ns in res.node_status}
    assert placed == {"avoided": 0, "ok": 2}
    res, _ = _both(tmp_path, cluster, [("a", app)], kw=dict(w_prefer_avoid=0.0))
    assert {ns.node.metadata.name: len(ns.pods) for ns in res.node_status}["avoided"] == 1


def test_multi_profile_selects_by_scheduler_name(tmp_path):
    config = """apiVersion: kubescheduler.config.k8s.io/v1beta1
kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: custom-sched
    plugins:
      filter:
        disabled:
          - name: TaintToleration
  - schedulerName: default-scheduler
"""
    assert isinstance(schedconfig.load_scheduler_config(_write(tmp_path, config)), schedconfig.SchedulerProfiles)
    app = ResourceTypes()
    app.pods.append(fx.make_fake_pod("p", "100m", "128Mi"))
    res, _ = _both(tmp_path, _tainted(), [("a", app)], config)
    assert len(res.unscheduled_pods) == 1 and "taint" in res.unscheduled_pods[0].reason
    app2 = ResourceTypes()
    app2.pods.append(_scheduler(fx.make_fake_pod("p2", "100m", "128Mi"), "custom-sched"))
    res, _ = _both(tmp_path, _tainted(), [("a", app2)], config)
    assert not res.unscheduled_pods


def test_unknown_profile_pod_gets_explicit_reason(tmp_path):
    config = "kind: KubeSchedulerConfiguration\nprofiles:\n  - schedulerName: default-scheduler\n  - schedulerName: batch\n"
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n0", "8", "16Gi"))
    app = ResourceTypes()
    app.pods.append(_scheduler(fx.make_fake_pod("ghost", "100m", "128Mi"), "no-such-scheduler"))
    app.pods.append(fx.make_fake_pod("ok", "100m", "128Mi"))
    res, _ = _both(tmp_path, cluster, [("a", app)], config)
    assert len(res.unscheduled_pods) == 1
    assert "no scheduler profile named 'no-such-scheduler'" in res.unscheduled_pods[0].reason
    assert sum(len(ns.pods) for ns in res.node_status) == 1


def test_differing_referenced_profiles_schedule_segmented(tmp_path):
    config = """kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: default-scheduler
  - schedulerName: lean
    plugins:
      score:
        disabled:
          - name: "*"
"""
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n0", "8", "16Gi"))
    app = ResourceTypes()
    app.pods.append(fx.make_fake_pod("a1", "100m", "128Mi"))
    app.pods.append(_scheduler(fx.make_fake_pod("a2", "100m", "128Mi"), "lean"))
    res, _ = _both(tmp_path, cluster, [("a", app)], config)
    assert not res.unscheduled_pods and sum(len(ns.pods) for ns in res.node_status) == 2
    assert res.engine == "fast_scan[cfg] + fast_scan[cfg] (segmented multi-profile) on cpu"
    pods = [p for ns in res.node_status for p in ns.pods]
    with pytest.raises(ValueError, match="differing plugin configurations"):
        schedconfig.resolve_profiles(schedconfig.load_scheduler_config(_write(tmp_path, config)), pods,
                                     ["cpu", "memory"], forced=[False] * len(pods))


_WIDGET = """kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: default-scheduler
    pluginConfig:
      - name: NodeResourcesFit
        args:
          {field}:
            - {value}
"""


@pytest.mark.parametrize("field,value", [("ignoredResources", "example.com/widget"),
                                         ("ignoredResourceGroups", "example.com")])
def test_fit_ignored_resources(tmp_path, field, value):
    """tests/test_schedconfig.py:253 and :284: a pod over-requesting an
    ignored extended resource schedules; without the config it does not."""
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n0", "8", "16Gi"))
    app = ResourceTypes()
    app.pods.append(fx.make_fake_pod("widgety", "100m", "128Mi", fx.with_requests({"example.com/widget": "4"})))
    res, _ = _both(tmp_path, cluster, [("a", app)])
    assert len(res.unscheduled_pods) == 1 and "Insufficient example.com/widget" in res.unscheduled_pods[0].reason
    res, _ = _both(tmp_path, cluster, [("a", app)], _WIDGET.format(field=field, value=value))
    assert not res.unscheduled_pods


_LOUD = [
    ("unknown plugin 'Fancy'", "profiles:\n  - plugins:\n      score:\n        enabled:\n          - name: Fancy\n"),
    ("percentageOfNodesToScore=50", "percentageOfNodesToScore: 50\nprofiles:\n  - plugins: {}\n"),
    ("PodTopologySpread", "profiles:\n  - pluginConfig:\n      - name: PodTopologySpread\n        args:\n"
                          "          defaultConstraints:\n            - maxSkew: 1\n"),
    ("hardPodAffinityWeight=7", "profiles:\n  - pluginConfig:\n      - name: InterPodAffinity\n        args:\n"
                                "          hardPodAffinityWeight: 7\n"),
    ("extension point 'scorer'", "profiles:\n  - plugins:\n      scorer:\n        enabled:\n          - name: Simon\n"),
    ("duplicate profile", "profiles:\n  - schedulerName: default-scheduler\n  - schedulerName: default-scheduler\n"),
]


@pytest.mark.parametrize("match,body", _LOUD, ids=[m.split()[0] for m, _b in _LOUD])
def test_unsupported_fields_fail_loudly(tmp_path, match, body):
    path = _write(tmp_path, "kind: KubeSchedulerConfiguration\n" + body)
    with pytest.raises(ValueError, match=re.escape(match)) as ours:
        schedconfig.load_scheduler_config(path)
    with pytest.raises(ValueError) as theirs:
        ref_sc.load_scheduler_config(path)
    assert str(ours.value) == str(theirs.value)


def test_vacuous_plugin_args_accepted(tmp_path):
    path = _write(tmp_path, """kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: default-scheduler
    pluginConfig:
      - name: DefaultPreemption
        args:
          minCandidateNodesPercentage: 10
      - name: VolumeBinding
        args:
          bindTimeoutSeconds: 600
""")
    assert schedconfig.load_scheduler_config(path) == schedconfig.DEFAULT_CONFIG


_LEAN = """kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: default-scheduler
  - schedulerName: lean
    plugins:
      score:
        disabled:
          - name: "*"
"""


def test_forced_pod_scheduler_name_never_routes(tmp_path):
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n0", "8", "16Gi"))
    cluster.pods.append(_scheduler(fx.make_fake_pod("pre", "100m", "128Mi", fx.with_node_name("n0")), "lean"))
    app = ResourceTypes()
    app.pods.append(fx.make_fake_pod("new", "100m", "128Mi"))
    res, _ = _both(tmp_path, cluster, [("a", app)], _LEAN)
    assert not res.unscheduled_pods and sum(len(ns.pods) for ns in res.node_status) == 2


def _preps(cluster, apps, node_pad=8):
    ref = ref_sim.prepare(_reference_copy(cluster), [ref_sim.AppResource(n, _reference_copy(a)) for n, a in apps],
                          node_pad=node_pad)
    port = sim.prepare(cluster, [sim.AppResource(n, a) for n, a in apps], node_pad=node_pad, device="cpu")
    return ref, port


def _sweeps(tmp_path, cluster, apps, config, node_valid):
    """sweep_auto() of both packages under the config file `config`, every
    pod valid; their results."""
    path = _write(tmp_path, config)
    ref, port = _preps(cluster, apps)
    P = len(port.ordered)
    want = ref_scenarios.sweep_auto(ref, node_valid, np.ones((len(node_valid), P), bool),
                                    config=ref_sc.load_scheduler_config(path))
    got = scenarios.sweep_auto(port, node_valid, np.ones((len(node_valid), P), bool),
                               config=schedconfig.load_scheduler_config(path))
    for field in ("unscheduled", "chosen", "used", "vg_used"):
        _exact(getattr(got, field), np.asarray(getattr(want, field)))
    return port, got


def test_sweep_auto_masks_unknown_profile_pods(tmp_path):
    cluster = ResourceTypes()
    for i in range(3):
        cluster.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi"))
    app = ResourceTypes()
    app.pods.append(_scheduler(fx.make_fake_pod("ghost", "100m", "128Mi"), "nope"))
    app.pods.append(fx.make_fake_pod("ok", "100m", "128Mi"))
    node_valid = np.zeros((2, 8), bool)
    node_valid[:, :3] = True
    port, res = _sweeps(tmp_path, cluster, [("a", app)], "kind: KubeSchedulerConfiguration\nprofiles:\n"
                        "  - schedulerName: default-scheduler\n  - schedulerName: batch\n", node_valid)
    assert res.unscheduled.tolist() == [0, 0]
    ghost = [i for i, p in enumerate(port.ordered) if p.metadata.name == "ghost"][0]
    assert (res.chosen[:, ghost] == -1).all()


_PACKER = """apiVersion: kubescheduler.config.k8s.io/v1beta1
kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: default-scheduler
  - schedulerName: packer
    plugins:
      score:
        disabled:
          - name: NodeResourcesBalancedAllocation
          - name: NodeResourcesLeastAllocated
"""


def _two_apps(replicas, cpu, memory, third=None):
    rt = ResourceTypes()
    rt.deployments.append(fx.make_fake_deployment("default-app", replicas, cpu, memory))
    rt.deployments.append(_scheduler(fx.make_fake_deployment("packer-app", replicas, cpu, memory), "packer"))
    if third is not None:
        rt.deployments.append(_scheduler(fx.make_fake_deployment("lost", 1, cpu, memory), third))
    return rt


def test_segmented_two_differing_profiles_schedule(tmp_path):
    cluster = ResourceTypes()
    for i in range(4):
        cluster.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi"))
    res, _ = _both(tmp_path, cluster, [("a", _two_apps(6, "500m", "1Gi"))], _PACKER)
    assert not res.unscheduled_pods and "segmented multi-profile" in res.engine
    by_app = {}
    for ns in res.node_status:
        for p in ns.pods:
            by_app.setdefault(p.metadata.labels.get("app", ""), {}).setdefault(ns.node.metadata.name, 0)
            by_app[p.metadata.labels.get("app", "")][ns.node.metadata.name] += 1
    assert len(by_app["default-app"]) == 4 and max(by_app["packer-app"].values()) >= 4


def test_segmented_profiles_share_the_carry(tmp_path):
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n0", "8", "16Gi"))
    cluster.nodes.append(fx.make_fake_node("n1", "8", "16Gi"))
    rt = ResourceTypes()
    rt.deployments.append(fx.make_fake_deployment("filler", 2, "7", "1Gi"))
    rt.deployments.append(_scheduler(fx.make_fake_deployment("late", 2, "4", "1Gi"), "packer"))
    res, _ = _both(tmp_path, cluster, [("a", rt)], _PACKER)
    assert [u.reason for u in res.unscheduled_pods] == ["0/2 nodes are available: 2 Insufficient cpu."] * 2


def test_segmented_unknown_profile_reason(tmp_path):
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n0", "8", "16Gi"))
    res, _ = _both(tmp_path, cluster, [("a", _two_apps(1, "500m", "1Gi", third="no-such-profile"))], _PACKER)
    assert len(res.unscheduled_pods) == 1
    assert "no scheduler profile named 'no-such-profile'" in res.unscheduled_pods[0].reason


def test_non_segmentable_interleaving_raises(tmp_path):
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n0", "64", "64Gi"))
    rt = ResourceTypes()
    for i in range(schedconfig.MAX_PROFILE_SEGMENTS + 2):
        pod = fx.make_fake_pod(f"p{i}", "10m", "16Mi")
        rt.pods.append(_scheduler(pod, "packer") if i % 2 else pod)
    with pytest.raises(ValueError, match="non-segmentable"):
        sim.simulate(cluster, [sim.AppResource("a", rt)], device="cpu",
                     sched_config=schedconfig.load_scheduler_config(_write(tmp_path, _PACKER)))


def test_segmented_preemption_raises_as_the_reference(tmp_path):
    cluster = ResourceTypes()
    cluster.nodes.append(fx.make_fake_node("n0", "8", "16Gi"))
    with pytest.raises(ValueError, match="does not support enable_preemption"):
        sim.simulate(cluster, [sim.AppResource("a", _two_apps(1, "500m", "1Gi"))], device="cpu",
                     sched_config=schedconfig.load_scheduler_config(_write(tmp_path, _PACKER)),
                     enable_preemption=True)


def test_differing_profiles_capacity_sweep(tmp_path):
    """`simon apply -d` with differing profiles on a cluster that needs a
    new node: the report equals the JAX package's (names normalised,
    engine footer aside), through segmented grids."""
    import yaml as _yaml

    for name, obj in (("cluster", fx.make_fake_node("n0", "8", "16Gi")), ("newnode", fx.make_fake_node("tmpl", "16",
                                                                                                        "32Gi"))):
        (tmp_path / name).mkdir()
        (tmp_path / name / "node.yaml").write_text(_yaml.safe_dump(obj.raw))
    (tmp_path / "app").mkdir()
    rt = _two_apps(6, "2", "2Gi")
    (tmp_path / "app" / "apps.yaml").write_text("---\n".join(_yaml.safe_dump(w.raw) for w in rt.deployments))
    sched = _write(tmp_path, _PACKER, "profiles.yaml")
    cfg = tmp_path / "simon-config.yaml"
    cfg.write_text("apiVersion: simon/v1alpha1\nkind: Config\nmetadata: {name: t}\nspec:\n"
                   f"  cluster: {{customConfig: '{tmp_path / 'cluster'}'}}\n  newNode: '{tmp_path / 'newnode'}'\n"
                   f"  appList:\n    - {{name: apps, path: '{tmp_path / 'app'}'}}\n")
    texts = []
    for mod, extra in ((apply, {"device": "cpu"}), (ref_apply, {})):
        out = tmp_path / f"report-{len(texts)}.txt"
        applier = mod.Applier(mod.Options(simon_config=str(cfg), default_scheduler_config=sched,
                                          output_file=str(out), max_new_nodes=8, **extra))
        assert applier.run() == 0
        texts.append(out.read_text())
    assert "(added" in texts[0] and "segmented multi-profile" in texts[0]
    strip = lambda t: "\n".join(line for line in _names(t).splitlines() if not line.startswith("Scheduling engine"))
    assert strip(texts[0]) == strip(texts[1])


def test_sweep_auto_mixed_profiles_matches_solo_segmented(tmp_path):
    """Differing profiles in a sweep: one grid per segment carrying each
    scenario's state; every scenario equals the JAX package's and a solo
    segmented simulate() of its sub-cluster."""
    cluster = ResourceTypes()
    for i in range(6):
        cluster.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi"))
    ks = (3, 4, 6)
    node_valid = np.zeros((len(ks), 8), bool)
    for s, k in enumerate(ks):
        node_valid[s, :k] = True
    apps = [("a", _two_apps(5, "500m", "1Gi"))]
    port, res = _sweeps(tmp_path, cluster, apps, _PACKER, node_valid)
    cfg = schedconfig.load_scheduler_config(_write(tmp_path, _PACKER))
    snap = sim.snapshot_bind_state(port)
    for s, k in enumerate(ks):
        solo = sim.simulate(ResourceTypes(nodes=cluster.nodes[:k]), [], prep=port, node_valid=node_valid[s],
                            sched_config=cfg)
        sim.restore_bind_state(port, snap)
        assert len(solo.unscheduled_pods) == res.unscheduled[s]
        np.testing.assert_array_equal(solo.placements, res.chosen[s])


def test_sweep_auto_single_profile_still_routes_one_config(tmp_path, monkeypatch):
    """Referenced profiles that resolve alike run one grid, not segments."""
    monkeypatch.setattr(scenarios, "sweep_segmented", None)  # calling it would fail
    cluster = ResourceTypes()
    for i in range(4):
        cluster.nodes.append(fx.make_fake_node(f"n{i}", "8", "16Gi"))
    rt = ResourceTypes()
    rt.deployments.append(fx.make_fake_deployment("only-default", 4, "500m", "1Gi"))
    node_valid = np.zeros((2, 8), bool)
    node_valid[:, :4] = True
    _port, res = _sweeps(tmp_path, cluster, [("a", rt)], _PACKER, node_valid)
    assert res.unscheduled.tolist() == [0, 0]


# --- the card plans at a small size -----------------------------------------------

def test_config_plan_at_small_size_equals_jax(tmp_path):
    """The config plan (score-table fleet with every tenth node blocked, one
    Deployment asking a widget no node offers) at 80 nodes and 800 pods
    under its config file: equal to the JAX package's, one launch of the
    cfg variant, and unlike the default config's run, where the widget
    pods fail and the blocked nodes stay empty."""
    path = fx.write_scheduler_config(tmp_path / "sched.yaml", fx.SCHED_CONFIG_PLAN)
    cfg = schedconfig.load_scheduler_config(path)
    make = lambda: (fx.score_cluster(80, blocked=10), [("plan", fx.score_apps(800, widget=True))])
    res, _ = _both(tmp_path, *make(), fx.SCHED_CONFIG_PLAN)
    assert res.engine == "fast_scan[na,tt,avoid,cfg] on cpu" and not res.unscheduled_pods
    default, _ = _both(tmp_path, *make())
    assert len(default.unscheduled_pods) == 40 and "Insufficient example.com/widget" in default.unscheduled_pods[0].reason
    blocked = {f"node-{i:05d}" for i in range(0, 80, 10)}
    assert any(ns.pods for ns in res.node_status if ns.node.metadata.name in blocked)
    assert not any(ns.pods for ns in default.node_status if ns.node.metadata.name in blocked)
    assert isinstance(cfg, schedconfig.SchedulerProfiles)


def test_two_profile_plan_at_small_size_equals_jax(tmp_path):
    """The two-profile plan at 80 nodes and 800 pods: two contiguous
    segments, one launch each with the state carried, equal to the JAX
    package's segmented run."""
    res, _ = _both(tmp_path, fx.synthetic_cluster(80), fx.two_profile_apps(800), fx.SCHED_TWO_PROFILES)
    assert res.engine == "fast_scan[cfg] + fast_scan[cfg] (segmented multi-profile) on cpu"
    port = sim.prepare(fx.synthetic_cluster(80), [sim.AppResource(n, a) for n, a in fx.two_profile_apps(800)],
                       device="cpu")
    path = fx.write_scheduler_config(tmp_path / "two.yaml", fx.SCHED_TWO_PROFILES)
    segments, invalid = schedconfig.resolve_profile_segments(
        schedconfig.load_scheduler_config(path), port.ordered, port.meta.resource_names, forced=port.forced)
    assert [(lo, hi) for _c, lo, hi in segments] == [(0, 400), (400, 800)] and not invalid


def test_an_initial_state_runs_in_the_cfg_and_sampled_variants():
    """A default-config segment of a segmented run takes the cfg variant
    with the default weights (the reference's segments sum in score_parts
    order); the cfg variants, sampled or not, take an initial state, and
    the variants without a config, sampled or not, take none."""
    port = _port_prep("spread")
    fi, _ = fastpath.build_inputs(port, cfg=schedconfig.DEFAULT_CONFIG, segment=True)
    assert fs.variant_name(fi) == "fast_scan[cfg]" and fi.cfg.weights == (1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 1.0,
                                                                         10000.0)
    tmpl, valid, forced = _stream(port)
    state = fs.fast_scan(fi, tmpl, valid, forced).state
    fi0, _ = fastpath.build_inputs(port)
    fs.fast_scan(fi, tmpl, valid, forced, init=state, tie_seed=1)
    for seed in (None, 1):
        with pytest.raises(ValueError, match="runs in the cfg variants"):
            fs.fast_scan(fi0, tmpl, valid, forced, init=state, tie_seed=seed)
