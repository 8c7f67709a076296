"""The bind-scan kernel against its plain version on the card. It imports
nothing of JAX (the card's machine has none), so it runs there without the
suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_card.py -q

Here, without a card, every test skips."""

import pytest
import torch

from opensim_tpu_torch.engine import fastpath, simulator as sim
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.ops import fast_scan as fs
from opensim_tpu_torch.planner import defrag


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_kernel_matches_plain_version_on_card(name, cuda_device):
    cluster, app, node_pad = fx.scan_case(name)
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=cuda_device)
    fi, _ = fastpath.build_inputs(prep)
    stream = fastpath.pod_stream(prep)
    before = fs.LAUNCHES
    got = fs.fast_scan(fi, *stream)
    torch.cuda.synchronize()
    want = fs.fast_scan_reference(fi, *stream)
    assert fs.LAUNCHES == before + 1
    for field, g, w in zip(fs.FastOutputs._fields, got, want):
        assert torch.equal(g, w), field


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_sweep_kernel_matches_plain_sweep_on_card(name, cuda_device):
    """Three drain scenarios of each small case in one launch of the
    scenario grid, against the plain sweep."""
    cluster, app, node_pad = fx.scan_case(name)
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=cuda_device)
    fi, _ = fastpath.build_inputs(prep)
    grid = fastpath.sweep_inputs(prep, *defrag.drain_masks(prep, list(range(min(3, len(prep.meta.node_names))))))
    before = dict(fs.VARIANT_LAUNCHES)
    got = fs.fast_scan_sweep(fi, *grid)
    torch.cuda.synchronize()
    want = fs.fast_scan_sweep_reference(fi, *grid)
    assert fs.VARIANT_LAUNCHES[fs.sweep_name(fi)] == before.get(fs.sweep_name(fi), 0) + 1
    for field, g, w in zip(fs.FastOutputs._fields, got, want):
        assert torch.equal(g, w), field


def _cycling_grid(prep, S):
    """The sweep's inputs for S scenarios, scenario s draining node s mod
    n of the case's first n <= 3 nodes; and n."""
    n = min(3, len(prep.meta.node_names))
    return fastpath.sweep_inputs(prep, *defrag.drain_masks(prep, [s % n for s in range(S)])), n


@pytest.mark.cuda
@pytest.mark.parametrize("S", [3, 200, 1057])
@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_sweep_grid_rows_match_the_plain_sweep_of_their_drain_on_card(name, S, cuda_device):
    """S = 3, 200 and 1,057 scenarios run one, two and SWEEP_B_MAX to a
    block (1,057 is one more than a multiple of 2, 4 and 8, so the last
    block holds one); every row equals the plain sweep of its own drain on
    all seven outputs."""
    cluster, app, node_pad = fx.scan_case(name)
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=cuda_device)
    fi, _ = fastpath.build_inputs(prep)
    grid, n = _cycling_grid(prep, S)
    shape = fs.sweep_grid(S, fi.alloc_T.shape[1], torch.cuda.get_device_properties(0).multi_processor_count)
    assert shape.b == {3: 1, 200: 2, 1057: fs.SWEEP_B_MAX}[S] and shape.smem > 0
    got = fs.fast_scan_sweep(fi, *grid)
    torch.cuda.synchronize()
    assert fs.SWEEP_LAUNCHED[fs.sweep_name(fi)]["grid"] == shape
    want = fs.fast_scan_sweep_reference(fi, grid[0], *(t[:n] for t in grid[1:]))
    rows = torch.arange(S, device=cuda_device) % n
    for field, g, w in zip(fs.FastOutputs._fields, got, want):
        assert torch.equal(g, w[rows]), field


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_sweep_of_one_scenario_matches_one_scan_on_card(name, cuda_device):
    cluster, app, node_pad = fx.scan_case(name)
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=cuda_device)
    fi, _ = fastpath.build_inputs(prep)
    tmpl, valid, forced = fastpath.pod_stream(prep)
    got = fs.fast_scan_sweep(fi, tmpl, valid[None], forced[None], fi.node_valid[None], fi.spr_weight[None])
    want = fs.fast_scan(fi, tmpl, valid, forced)
    for field in fs.STATE_FIELDS:  # the grid does not count failures
        assert torch.equal(getattr(got, field)[0], getattr(want, field)), field
    assert got.fail_counts.shape == (1, tmpl.shape[0], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("node_pad, S", [(1 << 19, 140), (1 << 20, 3)])
def test_sweep_grid_past_shared_memory_on_card(node_pad, S, cuda_device):
    """Half a million node lanes leave room for one scenario's masks per
    block, a million for none: the masks then lie in global memory."""
    cluster, app, _ = fx.scan_case("ties")
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=cuda_device)
    fi, _ = fastpath.build_inputs(prep)
    shape = fs.sweep_grid(S, fi.alloc_T.shape[1], torch.cuda.get_device_properties(0).multi_processor_count)
    assert (shape.b, shape.smem > 0) == ((1, True) if node_pad == 1 << 19 else (1, False))
    grid, n = _cycling_grid(prep, S)
    got = fs.fast_scan_sweep(fi, *grid)
    torch.cuda.synchronize()
    want = fs.fast_scan_sweep_reference(fi, grid[0], *(t[:n] for t in grid[1:]))
    rows = torch.arange(S, device=cuda_device) % n
    for field, g, w in zip(fs.FastOutputs._fields, got, want):
        assert torch.equal(g, w[rows]), field


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["capacity", "gpu", "interpod", "local"])
def test_simulate_on_card_launches_once(plan, cuda_device):
    make = {
        "capacity": lambda: (fx.synthetic_cluster(64), fx.synthetic_apps(640)),
        "gpu": lambda: (fx.gpu_cluster(64), fx.gpu_apps(640)),
        "interpod": lambda: (fx.synthetic_cluster(64), fx.affinity_apps(640)),
        "local": lambda: (fx.local_pv_cluster(64), fx.local_pv_apps(640)),
    }[plan]
    cluster, apps = make()
    before = fs.LAUNCHES
    res = sim.simulate(cluster, [sim.AppResource("plan", apps)])
    assert fs.LAUNCHES == before + 1
    cluster, apps = make()
    cpu = sim.simulate(cluster, [sim.AppResource("plan", apps)], device="cpu")
    for field in ("placements", "used", "gpu_take", "gpu_free", "vg_free", "dev_free"):
        assert (getattr(res, field) == getattr(cpu, field)).all(), field
    if plan == "gpu":
        assert res.gpu_take.sum() > 0
    if plan == "local":
        assert (res.dev_free == 0).any()


@pytest.mark.cuda
def test_simulate_on_card_reports_the_plain_versions_reasons(cuda_device):
    """The over-subscribed plan at 64 nodes: one launch, whose counting
    passes give every unscheduled pod the reason string the CPU run gives."""
    def run(device=None):
        cluster, apps = fx.oversubscribed_cluster(64), fx.oversubscribed_apps(64, 640)
        return sim.simulate(cluster, [sim.AppResource(n, a) for n, a in apps], device=device)

    before = fs.LAUNCHES
    res = run()
    assert fs.LAUNCHES == before + 1
    passes = int(fs.SCAN_LAUNCHED["fast_scan"]["count_clock"][1])
    cpu = run("cpu")
    assert (res.placements == cpu.placements).all()
    assert [u.reason for u in res.unscheduled_pods] == [u.reason for u in cpu.unscheduled_pods]
    assert len(res.unscheduled_pods) == passes + 10  # the 10 forced strays run no counting pass


@pytest.mark.cuda
def test_plan_drains_on_card_launches_once(cuda_device):
    cluster, apps = fx.synthetic_cluster(64), fx.synthetic_apps(640)
    candidates = [n.metadata.name for n in cluster.nodes[:16]]
    before = fs.LAUNCHES
    got = defrag.plan_drains(cluster, [sim.AppResource("plan", apps)], candidates=candidates)
    assert fs.LAUNCHES == before + 1
    want = defrag.plan_drains(cluster, [sim.AppResource("plan", apps)], candidates=candidates, device="cpu")
    assert got == want and len(got.plans) == 16


@pytest.mark.cuda
def test_kernel_matches_plain_version_at_a_thousand_templates(cuda_device):
    """U = 1,000 templates at N = 5,000 nodes: the template tables the TPU
    kernel streams row by row are read from global memory here."""
    prep = sim.prepare(fx.synthetic_cluster(5000), [sim.AppResource("t", fx.bigu_apps(1000))], device=cuda_device)
    assert fastpath.why_not(prep) is None and prep.ec_np.req.shape[0] >= 1000
    fi, _ = fastpath.build_inputs(prep)
    stream = fastpath.pod_stream(prep)
    got = fs.fast_scan(fi, *stream)
    torch.cuda.synchronize()
    want = fs.fast_scan_reference(fi, *stream)
    assert torch.equal(got.chosen, want.chosen) and torch.equal(got.used, want.used)
    assert (got.chosen >= 0).all()


def _case_on_card(name, node_pad, device):
    cluster, app, _ = fx.scan_case(name)
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=device)
    fi, _ = fastpath.build_inputs(prep)
    return fi, fastpath.pod_stream(prep)


def _one_scan_matches_plain(fi, stream):
    got = fs.fast_scan(fi, *stream)
    torch.cuda.synchronize()
    want = fs.fast_scan_reference(fi, *stream)
    for field, g, w in zip(fs.FastOutputs._fields, got, want):
        assert torch.equal(g, w), field
    assert fs.SCAN_LAUNCHED[fs.variant_name(fi)]["shape"] == fs.scan_shape(fi)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_one_scan_over_unpadded_nodes_matches_plain_version_on_card(name, cuda_device):
    """Every small case on its own nodes, no padding: a few nodes to each
    CTA of the cluster (N < SCAN_CLUSTER leaves some CTAs none, 20 nodes do
    not divide among them), so equal scores tie across CTAs, hard spread's
    minimum and every range are reduced across them, and the lowest index
    must win across them."""
    fi, stream = _case_on_card(name, 1, cuda_device)
    shape = fs.scan_shape(fi)
    assert shape.resident and shape.nc == -(-fi.alloc_T.shape[1] // fs.SCAN_CLUSTER)
    _one_scan_matches_plain(fi, stream)


@pytest.mark.cuda
def test_one_scan_ties_resolve_to_the_lowest_index_across_the_cluster_on_card(cuda_device):
    """16 equal nodes, two to a CTA: every pod's best score is tied among
    nodes of several CTAs, and the first placements walk the nodes in
    order, CTA by CTA."""
    fi, stream = _case_on_card("ties", 1, cuda_device)
    assert fs.scan_shape(fi).nc == 2
    got = _one_scan_matches_plain(fi, stream)
    assert got.chosen[:16].tolist() == list(range(16))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ties", "spread", "scores", "ports"])
def test_one_scan_with_several_nodes_a_thread_matches_plain_version_on_card(name, cuda_device):
    """Three nodes a thread, the slices still in shared memory: the first
    nodes' pass-2 values stay in registers, the third is judged afresh in
    pass 3."""
    pad = fs.SCAN_CLUSTER * fs.SCAN_THREADS * 3
    fi, stream = _case_on_card(name, pad, cuda_device)
    shape = fs.scan_shape(fi)
    assert shape.resident and shape.nc == 3 * fs.SCAN_THREADS
    _one_scan_matches_plain(fi, stream)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ties", "spread", "gpu_dyn", "interpod", "ports", "local"])
def test_one_scan_with_state_in_global_memory_matches_plain_version_on_card(name, cuda_device):
    """Half a million node lanes: a slice does not fit in shared memory, so
    the state stays in global memory and each CTA keeps its copy of the
    small state in the scratch buffer."""
    fi, stream = _case_on_card(name, 1 << 19, cuda_device)
    assert not fs.scan_shape(fi).resident
    _one_scan_matches_plain(fi, stream)


#: A config under which every setting decides something on the small
#: cases: new weights, the static taint filter and the fit filter's cpu
#: row off (tests/test_torch_schedconfig.py holds the plain version under
#: it and under each dynamic filter off against the JAX package).
CARD_CONFIGS = {
    "weights": dict(w_balanced=0.0, w_least=3.0, w_node_affinity=2.0, w_taint_toleration=5.0, w_interpod=2.0,
                    w_spread=1.0, w_prefer_avoid=0.0, w_simon=0.5, w_gpu_share=0.25, w_local=3.0, f_taints=False),
    "filters_off": dict(f_ports=False, f_spread=False, f_interpod=False, f_gpu=False, f_local=False),
    "fit_ignored": dict(f_fit=True, fit_ignored_cols=(0,)),
}


def _cfg_case_on_card(name, kind, device):
    from opensim_tpu_torch.engine import schedconfig

    cluster, app, node_pad = fx.scan_case(name)
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=device)
    fi, _ = fastpath.build_inputs(prep, cfg=schedconfig.SchedulerConfig(**CARD_CONFIGS[kind]))
    assert fs.variant(fi).cfg
    return prep, fi


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(CARD_CONFIGS))
@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_cfg_kernel_matches_plain_version_on_card(name, kind, cuda_device):
    """The cfg variant of each case's kernel against its plain version on
    every output: the one scan, and the grid of three drains."""
    prep, fi = _cfg_case_on_card(name, kind, cuda_device)
    _one_scan_matches_plain(fi, fastpath.pod_stream(prep))
    grid = fastpath.sweep_inputs(prep, *defrag.drain_masks(prep, list(range(min(3, len(prep.meta.node_names))))))
    got = fs.fast_scan_sweep(fi, *grid)
    torch.cuda.synchronize()
    want = fs.fast_scan_sweep_reference(fi, *grid)
    for field, g, w in zip(fs.FastOutputs._fields, got, want):
        assert torch.equal(g, w), field


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_carried_state_on_card(name, cuda_device):
    """The stream cut in two, the second launch from the first's state:
    equal to one launch (one scan and grid), and to the plain version from
    the same state, on every output."""
    prep, fi = _cfg_case_on_card(name, "weights", cuda_device)
    tmpl, valid, forced = fastpath.pod_stream(prep)
    P = tmpl.shape[0]
    k = P // 2
    whole = fs.fast_scan(fi, tmpl, valid, forced)
    a = fs.fast_scan(fi, tmpl[:k], valid[:k], forced[:k])
    b = fs.fast_scan(fi, tmpl[k:], valid[k:], forced[k:], init=a.state)
    torch.cuda.synchronize()
    want = fs.fast_scan_reference(fi, tmpl[k:], valid[k:], forced[k:], init=a.state)
    for field, g, w in zip(fs.FastOutputs._fields, b, want):
        assert torch.equal(g, w), field
    assert torch.equal(torch.cat([a.chosen, b.chosen]), whole.chosen) and torch.equal(b.state, whole.state)
    grid = fastpath.sweep_inputs(prep, *defrag.drain_masks(prep, list(range(min(3, len(prep.meta.node_names))))))
    tmpl_g, rest = grid[0], grid[1:]
    cut = lambda sl: [t[:, sl].contiguous() for t in rest[:2]] + list(rest[2:])
    whole_g = fs.fast_scan_sweep(fi, *grid)
    a_g = fs.fast_scan_sweep(fi, tmpl_g[:k], *cut(slice(None, k)))
    b_g = fs.fast_scan_sweep(fi, tmpl_g[k:], *cut(slice(k, None)), init=a_g.state)
    torch.cuda.synchronize()
    want_g = fs.fast_scan_sweep_reference(fi, tmpl_g[k:], *cut(slice(k, None)), init=a_g.state)
    for field, g, w in zip(fs.FastOutputs._fields, b_g, want_g):
        assert torch.equal(g, w), field
    assert torch.equal(torch.cat([a_g.chosen, b_g.chosen], 1), whole_g.chosen)
    assert torch.equal(b_g.state, whole_g.state)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [None, "weights"])
@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_sampled_kernel_matches_plain_version_on_card(name, cfg, cuda_device):
    """The sampled variant (with and without a config) against its plain
    version on every output, over the stream and, with a config, from a
    carried state, its second half with the draws' pod counter going on
    (without a config the variant takes no initial state)."""
    if cfg is None:
        cluster, app, node_pad = fx.scan_case(name)
        prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=cuda_device)
        fi, _ = fastpath.build_inputs(prep)
    else:
        prep, fi = _cfg_case_on_card(name, cfg, cuda_device)
    tmpl, valid, forced = fastpath.pod_stream(prep)
    got = fs.fast_scan(fi, tmpl, valid, forced, tie_seed=7)
    torch.cuda.synchronize()
    want = fs.fast_scan_reference(fi, tmpl, valid, forced, tie_seed=7)
    for field, g, w in zip(fs.FastOutputs._fields, got, want):
        assert torch.equal(g, w), field
    assert fs.variant_name(fi, sample=True) in fs.SCAN_LAUNCHED
    k = tmpl.shape[0] // 2
    a = fs.fast_scan(fi, tmpl[:k], valid[:k], forced[:k], tie_seed=7)
    if cfg is None:
        with pytest.raises(ValueError, match="runs in the cfg variants"):
            fs.fast_scan(fi, tmpl[k:], valid[k:], forced[k:], init=a.state, tie_seed=7, draw_base=k)
        return
    b = fs.fast_scan(fi, tmpl[k:], valid[k:], forced[k:], init=a.state, tie_seed=7, draw_base=k)
    assert torch.equal(torch.cat([a.chosen, b.chosen]), got.chosen) and torch.equal(b.state, got.state)


@pytest.mark.cuda
def test_sampled_choice_on_card_leaves_the_lowest_index(cuda_device):
    """On the uniform fleet most steps tie: the sampled placements differ
    from the lowest-index run's, and each seed repeats itself."""
    cluster, app, _ = fx.scan_case("ties")
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=1, device=cuda_device)
    fi, _ = fastpath.build_inputs(prep)
    stream = fastpath.pod_stream(prep)
    lowest = fs.fast_scan(fi, *stream).chosen
    a, b = (fs.fast_scan(fi, *stream, tie_seed=3).chosen for _ in range(2))
    assert torch.equal(a, b) and (a != lowest).float().mean() > 0.25


#: Small cases of explain mode under a config, sampled, and from a carried state.
EXPLAIN_MIXED = ["ties", "spread", "gpu_dyn", "interpod_terms", "ports", "local_rules", "fail_mixed"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stream", "masked"])
@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_explain_kernel_matches_plain_version_on_card(name, mode, cuda_device):
    """The [explain] variant against the plain version counting every step
    (count_all) on all ten outputs: over the stream, and over a masked node
    axis with two pods of every three invalid (an invalid pod that is not
    forced is counted and binds nothing). Its placements and state are
    the default variant's, whose counts it holds on the failing pods; each
    pod not forced runs one counting pass."""
    cluster, app, node_pad = fx.scan_case(name)
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=cuda_device)
    if mode == "stream":
        fi, _ = fastpath.build_inputs(prep)
        stream = fastpath.pod_stream(prep)
    else:
        node_valid = prep.ec_np.node_valid.copy()
        node_valid[min(1, len(node_valid) - 1)] = False
        fi, _ = fastpath.build_inputs(prep, node_valid)
        stream = fastpath.pod_stream(prep, torch.arange(len(prep.tmpl_ids)).numpy() % 3 == 0)
    got = fs.fast_scan(fi, *stream, explain=True)
    torch.cuda.synchronize()
    want = fs.fast_scan_reference(fi, *stream, count_all=True)
    for field, g, w in zip(fs.FastOutputs._fields, got, want):
        assert torch.equal(g, w), field
    row = fs.variant_name(fi, explain=True)
    assert int(fs.SCAN_LAUNCHED[row]["count_clock"][1]) == int((stream[2] == 0).sum())
    default = fs.fast_scan(fi, *stream)
    for field in fs.STATE_FIELDS:
        assert torch.equal(getattr(got, field), getattr(default, field)), field
    failing = (default.chosen < 0) & (stream[1] != 0) & (stream[2] == 0)
    assert torch.equal(got.fail_counts[failing], default.fail_counts[failing])
    assert torch.equal(got.insufficient[failing], default.insufficient[failing])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cfg", "sample", "cfg_sample"])
@pytest.mark.parametrize("name", EXPLAIN_MIXED)
def test_explain_kernel_under_a_config_and_sampled_on_card(name, mode, cuda_device):
    """[cfg,explain], [sample,explain] and [cfg,sample,explain] against the
    plain version on every output; under a config also cut in two, the
    second launch from the first's state, equal to one launch."""
    if mode == "sample":
        cluster, app, node_pad = fx.scan_case(name)
        prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=cuda_device)
        fi, _ = fastpath.build_inputs(prep)
    else:
        prep, fi = _cfg_case_on_card(name, "weights", cuda_device)
    seed = None if mode == "cfg" else 7
    tmpl, valid, forced = fastpath.pod_stream(prep)
    got = fs.fast_scan(fi, tmpl, valid, forced, tie_seed=seed, explain=True)
    torch.cuda.synchronize()
    want = fs.fast_scan_reference(fi, tmpl, valid, forced, tie_seed=seed, count_all=True)
    for field, g, w in zip(fs.FastOutputs._fields, got, want):
        assert torch.equal(g, w), field
    assert fs.variant_name(fi, seed is not None, explain=True) in fs.SCAN_LAUNCHED
    if mode == "sample":
        return
    k = tmpl.shape[0] // 2
    a = fs.fast_scan(fi, tmpl[:k], valid[:k], forced[:k], tie_seed=seed, explain=True)
    b = fs.fast_scan(fi, tmpl[k:], valid[k:], forced[k:], init=a.state, tie_seed=seed, draw_base=k, explain=True)
    for field in ("chosen", "gpu_take", "fail_counts", "insufficient"):
        assert torch.equal(torch.cat([getattr(a, field), getattr(b, field)]), getattr(got, field)), field
    assert torch.equal(b.state, got.state)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ties", "interpod", "local"])
def test_explain_kernel_with_state_in_global_memory_on_card(name, cuda_device):
    """Explain mode with the slices in global memory (half a million node lanes)."""
    fi, stream = _case_on_card(name, 1 << 19, cuda_device)
    assert not fs.scan_shape(fi).resident
    got = fs.fast_scan(fi, *stream, explain=True)
    torch.cuda.synchronize()
    want = fs.fast_scan_reference(fi, *stream, count_all=True)
    for field, g, w in zip(fs.FastOutputs._fields, got, want):
        assert torch.equal(g, w), field


@pytest.mark.cuda
def test_the_grid_refuses_explain_mode_on_card(cuda_device):
    cluster, app, node_pad = fx.scan_case("ties")
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=cuda_device)
    fi, _ = fastpath.build_inputs(prep)
    tmpl, valid, forced = fastpath.pod_stream(prep)
    with pytest.raises(ValueError, match="explain mode"):
        fs._launch(fi, tmpl, valid[None], forced[None], fi.node_valid[None], fi.spr_weight[None], sweep=True,
                   explain=True)
