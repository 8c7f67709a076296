"""The torch reference scan (``engine/scheduler.py`` over the torch step of
``ops/kernels.py``) against the JAX package's XLA scan
(``opensim_tpu.engine.scheduler.schedule_pods``) on the same prepared
input, and the kernel's plain version in explain mode against it.

- The scan: placements, failure counts, shortages, GPU takes, the static
  first-fail counts and every field of the final state, bit for bit, with
  ``explain`` off and on; a few small cases here, and the whole matrix
  (``fixtures.SCAN_CASES`` and the generated workloads of
  tests/test_fastpath_fuzz.py and tests/test_native.py, under the default
  config and each config kind of tests/test_torch_schedconfig.py) is
  ``slow``. Pods that are not valid run the pipeline and keep their
  counts, as in the reference.
- ``score_parts``: each plugin's weighted score on every node equals the
  reference's, part by part, bit for bit.
- ``fast_scan_reference(count_all=True)`` (the plain version of the
  ``[explain]`` variants) equals the torch scan in explain mode on every
  pod's counts: over the stream, a masked node axis and pod stream, a
  stream cut in two with the state carried, and sampled.
All counts are integers and every float op is the reference's: compared
exactly."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from opensim_tpu.engine import schedconfig as ref_sc
from opensim_tpu.engine.scheduler import pad_pod_stream, schedule_pods
from opensim_tpu.ops import kernels as ref_kernels
from opensim_tpu_torch.encoding.state import EncodedCluster, ScanState, to_device
from opensim_tpu_torch.engine import fastpath, schedconfig, scheduler
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.ops import fast_scan as fs, kernels

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_fast_scan import _port_prep, _ref_prep  # noqa: E402
from test_torch_schedconfig import GENERATED, KINDS, _generated  # noqa: E402

CASES = [c[0] for c in fx.SCAN_CASES]
#: The tier-1 cases: hard spread, the dynamic gpu-count, inter-pod terms,
#: host ports, the local-storage rules, and failures mid-stream.
TIER1 = ["spread", "gpu_dyn", "interpod_terms", "ports", "local_rules", "fail_mixed"]


def _on_torch(ref, node_valid=None):
    """The JAX prep's encoded cluster and start state as the port's tensors
    on the CPU (the same arrays), the node axis masked by `node_valid`."""
    ec_np = EncodedCluster(*ref.ec_np)
    if node_valid is not None:
        ec_np = ec_np._replace(node_valid=node_valid)
    return to_device(ec_np, ScanState(*(np.asarray(a) for a in ref.st0)), "cpu")


def _exact(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _scan_parity(ref, kw=None, explain=False, pod_valid=None, node_valid=None):
    """The torch scan against the XLA scan on `ref` under config `kw`
    (SchedulerConfig fields; None: the default), `pod_valid` ([P] bool,
    None: all) and `node_valid` ([N] bool, None: the encoded validity), on
    every output. Returns the torch scan's output."""
    import jax.numpy as jnp

    P = len(ref.ordered)
    valid = np.ones(P, bool) if pod_valid is None else pod_valid
    t, v, f = pad_pod_stream(ref.tmpl_ids, valid, ref.forced)
    ec_ref = ref.ec if node_valid is None else ref.ec._replace(node_valid=jnp.asarray(node_valid))
    out = schedule_pods(ec_ref, ref.st0, t, v, f, features=ref.features,
                        config=None if kw is None else ref_sc.SchedulerConfig(**kw), explain=explain)
    ec, st0 = _on_torch(ref, node_valid)
    got = scheduler.schedule_pods(ec, st0, ref.tmpl_ids, valid, ref.forced, features=kernels.Features(*ref.features),
                                  config=None if kw is None else schedconfig.SchedulerConfig(**kw), explain=explain)
    for field in ("chosen", "fail_counts", "insufficient", "gpu_take"):
        _exact(getattr(got, field).numpy(), np.asarray(getattr(out, field))[:P], field)
    _exact(got.static_fail.numpy(), np.asarray(out.static_fail), "static_fail")
    for field in ScanState._fields:
        _exact(getattr(got.final_state, field).numpy(), np.asarray(getattr(out.final_state, field)), field)
    return got


@pytest.mark.parametrize("explain", [False, True])
@pytest.mark.parametrize("name", TIER1)
def test_reference_scan_matches_xla_scan(name, explain):
    ref = _ref_prep(name)
    got = _scan_parity(ref, explain=explain)
    counted = got.fail_counts.any(1) | got.insufficient.any(1)
    assert not bool(counted[torch.from_numpy(ref.forced)].any())  # forced pods skip the pipeline
    if not explain:
        assert not bool((counted & (got.chosen >= 0)).any())


@pytest.mark.parametrize("explain", [False, True])
def test_reference_scan_on_a_masked_axis_matches_xla_scan(explain):
    """A node masked out and two pods of every three invalid: the invalid
    pods run the pipeline, keep their counts (without explain mode too,
    where one finds no node: the reference counts under its lax.cond,
    whether the pod is valid or not) and bind nowhere."""
    ref = _ref_prep("fail_mixed")
    node_valid = np.asarray(ref.ec_np.node_valid).copy()
    node_valid[1] = False
    pod_valid = np.arange(len(ref.ordered)) % 3 == 0
    got = _scan_parity(ref, explain=explain, pod_valid=pod_valid, node_valid=node_valid)
    assert not bool((got.chosen[~torch.from_numpy(pod_valid)] >= 0).any())
    assert not bool((got.chosen == 1).any())
    invalid = ~torch.from_numpy(pod_valid | ref.forced)
    assert bool(got.fail_counts[invalid].any())


@pytest.mark.parametrize("kind", ["weights", "no_spread", "fit_ignored"])
def test_reference_scan_under_a_config_matches_xla_scan(kind):
    name = {"weights": "scores", "no_spread": "fail_spread", "fit_ignored": "fail_fit"}[kind]
    _scan_parity(_ref_prep(name), KINDS[kind], explain=True)


@pytest.mark.slow
@pytest.mark.parametrize("kind", [None] + sorted(KINDS))
@pytest.mark.parametrize("name", CASES)
def test_reference_scan_matrix_on_the_small_cases(name, kind):
    ref = _ref_prep(name)
    for explain in (False, True):
        _scan_parity(ref, None if kind is None else KINDS[kind], explain=explain)


@pytest.mark.slow
@pytest.mark.parametrize("kind", [None] + sorted(KINDS))
@pytest.mark.parametrize("source,seed", GENERATED)
def test_reference_scan_matrix_on_generated_workloads(source, seed, kind):
    ref, _port = _generated(source, seed)
    for explain in (False, True):
        _scan_parity(ref, None if kind is None else KINDS[kind], explain=explain)


def _half_state(ref):
    """The XLA scan's state after the first half of the stream, and the
    pod that comes next."""
    P = len(ref.ordered)
    k = P // 2
    valid = np.arange(P) < k
    t, v, f = pad_pod_stream(ref.tmpl_ids, valid, ref.forced & valid)
    out = schedule_pods(ref.ec, ref.st0, t, v, f, features=ref.features)
    return out.final_state, k


@pytest.mark.parametrize("cfg", [None, "weights"])
@pytest.mark.parametrize("name", ["spread", "gpu_dyn", "scores", "interpod_terms", "local", "two_keys"])
def test_score_parts_match_the_reference(name, cfg):
    """Mid-stream, each plugin's weighted score of the next pod over every
    node equals the reference's ``kernels.score_parts``, and so does the
    step's feasibility, score and choice."""
    import jax.numpy as jnp

    ref = _ref_prep(name)
    st_ref, k = _half_state(ref)
    u = int(ref.tmpl_ids[k])
    ref_cfg = None if cfg is None else ref_sc.SchedulerConfig(**KINDS[cfg])
    port_cfg = None if cfg is None else schedconfig.SchedulerConfig(**KINDS[cfg])
    stat_ref = ref_kernels.precompute_static(ref.ec, ref_cfg)
    res_ref = ref_kernels.pod_step(ref.ec, stat_ref, st_ref, jnp.int32(u), ref.features, ref_cfg)
    parts_ref = ref_kernels.score_parts(ref.ec, stat_ref, st_ref, jnp.int32(u), res_ref.feasible, ref.features,
                                        ref_cfg)
    ec, _ = _on_torch(ref)
    st = ScanState(*(torch.from_numpy(np.array(a)) for a in st_ref))
    stat = kernels.static_tables(ec, port_cfg)
    feat = kernels.Features(*ref.features)
    res = kernels.pod_step(ec, stat, st, u, feat, port_cfg)
    parts = kernels.score_parts(ec, stat, st, u, res.feasible, feat, port_cfg)
    assert list(parts) == list(parts_ref) and len(parts) >= 3
    for key in parts:
        _exact(parts[key].numpy(), np.asarray(parts_ref[key]), key)
    _exact(res.feasible.numpy(), np.asarray(res_ref.feasible), "feasible")
    _exact(res.score.numpy(), np.asarray(res_ref.score), "score")
    assert res.chosen == int(res_ref.chosen)
    for field in kernels.StaticTables._fields:
        _exact(getattr(stat, field).numpy(), np.asarray(getattr(stat_ref, field)), field)


def test_extra_plugins_enter_the_step_in_their_slots():
    """An out-of-tree filter counts in the F_EXTRA slot, after every
    in-tree filter, and a score plugin adds its weighted part last."""
    port = _port_prep("ties")
    feat = port.features
    stat = kernels.static_tables(port.ec)
    ban_even = ("filter", lambda ec, st, u: torch.arange(ec.node_valid.shape[0]) % 2 == 1)
    last = ("score", lambda ec, st, u, feasible: torch.where(torch.arange(ec.node_valid.shape[0]) == 5, 100.0, 0.0),
            1000.0)
    res = kernels.pod_step(port.ec, stat, port.st0, 0, feat, extra=(ban_even, last), count_all=True)
    parts = kernels.score_parts(port.ec, stat, port.st0, 0, res.feasible, feat, extra=(ban_even, last))
    assert list(parts)[-1] == "Extra[1]" and res.chosen == 5
    n_valid = int(port.ec.node_valid.sum())
    assert int(res.fail_counts[kernels.F_EXTRA - kernels.F_PORTS]) == n_valid - n_valid // 2
    assert not bool(res.feasible[0::2].any())


def _plain_explain(fi, tmpl, valid, forced, **kw):
    return fs.fast_scan_reference(fi, tmpl, valid, forced, count_all=True, **kw)


def _torch_scan(port, kw=None, pod_valid=None, node_valid=None, lo=0, hi=None, st0=None, tie_seed=None):
    ec = port.ec if node_valid is None else port.ec._replace(node_valid=torch.from_numpy(node_valid))
    P = len(port.tmpl_ids)
    valid = np.ones(P, bool) if pod_valid is None else pod_valid
    hi = P if hi is None else hi
    return scheduler.schedule_pods(ec, port.st0 if st0 is None else st0, port.tmpl_ids[lo:hi], valid[lo:hi],
                                   port.forced[lo:hi], features=port.features,
                                   config=None if kw is None else schedconfig.SchedulerConfig(**kw), explain=True,
                                   tie_seed=tie_seed, draw_base=lo)


def _same_counts(plain, scan, what):
    _exact(plain.chosen.numpy(), scan.chosen.numpy(), f"{what}: chosen")
    _exact(plain.fail_counts.numpy(), scan.fail_counts.numpy(), f"{what}: fail_counts")
    _exact(plain.insufficient.numpy(), scan.insufficient.numpy(), f"{what}: insufficient")


EXPLAIN_CASES = ["ties", "spread", "forced", "gpu_dyn", "gpu_forced", "interpod_terms", "ports", "local_rules",
                 "fail_ports", "fail_fit", "fail_spread", "fail_interpod", "fail_gpu", "fail_local", "fail_mixed"]


@pytest.mark.parametrize("mode", ["stream", "masked", "segmented", "sampled"])
@pytest.mark.parametrize("name", EXPLAIN_CASES)
def test_plain_explain_counts_equal_the_reference_scan(name, mode):
    """The [explain] variants' plain version counts every pod not forced as
    the torch scan in explain mode does: over the stream; on a masked node
    axis with two pods of every three invalid; cut in two with the state
    carried under a config (the cfg variant, whose sum is the scan's); and
    sampled under that config (the same Philox draw)."""
    port = _port_prep(name)
    tmpl, valid, forced = fastpath.pod_stream(port)
    if mode == "stream":
        fi, _ = fastpath.build_inputs(port)
        _same_counts(_plain_explain(fi, tmpl, valid, forced), _torch_scan(port), name)
    elif mode == "masked":
        node_valid = np.asarray(port.ec_np.node_valid).copy()
        node_valid[min(1, len(node_valid) - 1)] = False
        pod_valid = np.arange(len(port.tmpl_ids)) % 3 == 0
        fi, _ = fastpath.build_inputs(port, node_valid)
        tmpl, valid, forced = fastpath.pod_stream(port, pod_valid)
        _same_counts(_plain_explain(fi, tmpl, valid, forced), _torch_scan(port, None, pod_valid, node_valid), name)
    else:
        kw = KINDS["weights"]
        fi, _ = fastpath.build_inputs(port, cfg=schedconfig.SchedulerConfig(**kw))
        seed = 5 if mode == "sampled" else None
        k = len(port.tmpl_ids) // 2
        a = _plain_explain(fi, tmpl[:k], valid[:k], forced[:k], tie_seed=seed)
        b = _plain_explain(fi, tmpl[k:], valid[k:], forced[k:], init=a.state, tie_seed=seed, draw_base=k)
        sa = _torch_scan(port, kw, hi=k, tie_seed=seed)
        sb = _torch_scan(port, kw, lo=k, st0=sa.final_state, tie_seed=seed)
        _same_counts(a, sa, f"{name}, first half")
        _same_counts(b, sb, f"{name}, second half")


@pytest.mark.parametrize("P", [0, 5, 256, 300])
def test_pad_pod_stream_equals_the_reference(P):
    rng = np.random.default_rng(P)
    args = (rng.integers(0, 4, P).astype(np.int32), rng.random(P) < 0.8, rng.random(P) < 0.2)
    for got, want in zip(scheduler.pad_pod_stream(*args), pad_pod_stream(*args)):
        _exact(got, want, "padded stream")


@pytest.mark.parametrize("name", ["scores", "gpu_dyn", "interpod_terms", "local_rules", "fail_mixed"])
def test_per_template_kernels_equal_the_reference_and_the_static_tables(name):
    """The torch static filters and raw scores of each template equal the
    reference's traced kernels and the rows of the static tables the
    torch step reads (``precompute_static_np``)."""
    import jax.numpy as jnp

    ref = _ref_prep(name)
    ec, _ = _on_torch(ref)
    stat = kernels.static_tables(ec)
    for u in range(ec.req.shape[0]):
        for fn in ("taint_filter", "node_affinity_filter", "node_affinity_raw", "taint_toleration_raw", "share_raw"):
            got = getattr(kernels, fn)(ec, u).numpy()
            _exact(got, np.asarray(getattr(ref_kernels, fn)(ref.ec, jnp.int32(u))), f"{fn}[{u}]")
        _exact(kernels.share_raw(ec, u).numpy(), stat.share_raw[u].numpy(), f"share_raw table[{u}]")
        _exact(kernels.node_affinity_raw(ec, u).numpy(), stat.na_raw[u].numpy(), f"na_raw table[{u}]")
        _exact(kernels.taint_toleration_raw(ec, u).numpy(), stat.tt_raw[u].numpy(), f"tt_raw table[{u}]")
        _exact(kernels.node_affinity_filter(ec, u).numpy(), stat.aff_mask[u].numpy(), f"aff_mask[{u}]")
