"""The port's request batch (``engine/reqbatch.py``) and the grid's counting
variants' plain version on the CPU, against the JAX package: the batch's
lanes (chosen by stream index, first-fail counts, shortages) and each
rider's answer (placements, reasons, the explain rider's audit) equal
``opensim_tpu.engine.reqbatch``'s on mixed riders (deploys, a scale, an
unschedulable deploy, an explain rider, a rider whose deadline died
before the launch); and ``fast_scan_sweep_reference(count=True)`` and
``(explain=True)`` equal the JAX ``_batched_schedule`` (its XLA scan
under ``jax.vmap``, with ``count_fails`` or ``count_all``) lane by lane
on every ``fixtures.SCAN_CASES`` case. Counts are integers: compared
exactly."""

import copy
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

from opensim_tpu.engine import prepcache as ref_prepcache, reqbatch as ref_reqbatch
from opensim_tpu.engine.scheduler import pad_pod_stream
from opensim_tpu.engine.simulator import AppResource as RefAppResource, prepare as ref_prepare
from opensim_tpu.models import expand as ref_expand
from opensim_tpu.resilience.deadline import Deadline as RefDeadline, DeadlineExceeded as RefDeadlineExceeded
from opensim_tpu_torch.engine import fastpath, prepcache, reqbatch
from opensim_tpu_torch.engine.simulator import AppResource, prepare
from opensim_tpu_torch.models import ResourceTypes, fixtures as fx
from opensim_tpu_torch.ops import fast_scan as fs
from opensim_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_fast_scan import _port_prep, _ref_prep  # noqa: E402


def _reference_copy(rt):
    docs = [copy.deepcopy(o.raw) for f in dataclasses.fields(rt) for o in getattr(rt, f.name)]
    ref, skipped = ref_expand.resources_from_dicts(docs)
    assert not skipped
    return ref


#: The riders: (name, kind, replicas, cpu, explain, deadline dead before the launch).
RIDERS = [
    ("app-0", "deploy", 3, "500m", False, False),
    ("web", "scale", 3, "200m", False, False),
    ("huge", "deploy", 2, "640", False, False),
    ("xp", "deploy", 2, "6", True, False),
    ("late", "deploy", 2, "500m", False, True),
    ("app-1", "deploy", 4, "2", False, False),
]


def _apps():
    """(kind, app) of each rider, in the port's objects."""
    apps = []
    for name, kind, reps, cpu, _explain, _late in RIDERS:
        rt = ResourceTypes()
        rt.add(fx.make_fake_deployment(name, reps, cpu, "1Gi"))
        apps.append((kind, rt))
    return apps


def _run(package_side: str, monkeypatch):
    """One batch of RIDERS on the admission cluster through one package:
    (dispatch, results, derived prep)."""
    cluster = fx.admission_cluster()
    if package_side == "port":
        monkeypatch.delenv("OPENSIM_BATCH_ENGINE", raising=False)
        pc, rb, app_cls, dl = prepcache, reqbatch, AppResource, Deadline
        base = pc.CacheEntry("b|base", prepare(cluster, [], device="cpu"))
        apps = [app_cls(k, rt) for k, rt in _apps()]
    else:
        monkeypatch.setenv("OPENSIM_BATCH_ENGINE", "xla")  # the JAX package's vmapped XLA scan
        pc, rb, app_cls, dl = ref_prepcache, ref_reqbatch, RefAppResource, RefDeadline
        cluster = _reference_copy(cluster)
        base = pc.CacheEntry("b|base", ref_prepare(cluster, []))
        apps = [app_cls(k, _reference_copy(rt)) for k, rt in _apps()]
    with base.lock:
        base.restore()
        derived, slices = pc.derive_with_app_slices(base.prep, cluster, apps, base_entry=base)
        items = []
        for s, (name, kind, _r, _c, explain, late) in enumerate(RIDERS):
            drops = set()
            if kind == "scale":
                owned = lambda p: any(r.kind == "Deployment" and r.name == name for r in p.metadata.owner_references)
                drops = {i for i in range(derived.n_bare) if owned(derived.ordered[i])}
            items.append(rb.BatchItem(cluster=cluster, apps=[apps[s]], lo=slices[s][0], hi=slices[s][1], drops=drops,
                                      explain=explain, deadline=dl.after(0.0) if late else None))
        try:
            dispatch = rb.dispatch_request_batch(derived, items)
            results = rb.decode_request_batch(derived, items, dispatch)
        finally:
            base.restore()
    return dispatch, results, derived


def _canon_pod(pod) -> str:
    name = pod.metadata.name
    best = max((w for w, *_ in RIDERS + [("web",)] if name.startswith(w)), key=len, default=name)
    return f"{pod.metadata.namespace}/{best}"


def test_request_batch_equals_jax_request_batch(monkeypatch):
    port_d, port_r, port_prep = _run("port", monkeypatch)
    ref_d, ref_r, ref_prep_ = _run("jax", monkeypatch)
    assert len(port_prep.ordered) == len(ref_prep_.ordered)
    assert np.array_equal(port_d.pod_valid, ref_d.pod_valid)
    late = [s for s, r in enumerate(RIDERS) if r[5]]
    assert sorted(port_d.shed) == sorted(ref_d.shed) == late
    for s, (name, _kind, _r, _c, explain, _late) in enumerate(RIDERS):
        if s in late:
            assert isinstance(port_r[s], DeadlineExceeded) and port_r[s].phase == "schedule"
            assert isinstance(ref_r[s], RefDeadlineExceeded)
            continue
        got, want = port_d.outs[s], ref_d.outs[s]
        P = len(port_prep.ordered)
        np.testing.assert_array_equal(got.chosen, np.asarray(want.chosen)[:P], err_msg=name)
        np.testing.assert_array_equal(got.fail_counts, np.asarray(want.fail_counts)[:P], err_msg=name)
        R = got.insufficient.shape[1]
        np.testing.assert_array_equal(got.insufficient, np.asarray(want.insufficient)[:P, :R], err_msg=name)
        a, b = port_r[s], ref_r[s]
        assert sorted((_canon_pod(u.pod), u.reason) for u in a.unscheduled_pods) == sorted(
            (_canon_pod(u.pod), u.reason) for u in b.unscheduled_pods), name
        placed = lambda r: sorted((ns.node.metadata.name, sorted(_canon_pod(p) for p in ns.pods))
                                  for ns in r.node_status)
        assert placed(a) == placed(b), name
        if explain:
            assert a.filter_rejects == b.engine.filter_rejects
            strip = lambda e: {k: v for k, v in e.to_dict().items() if k != "pod"}
            assert sorted(map(str, map(strip, a.explanations))) == sorted(map(str, map(strip, b.engine.explanations)))
    assert any(u.reason for u in port_r[2].unscheduled_pods)  # the unschedulable rider's reasons


@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_counting_plain_sweep_equals_jax_batched_schedule(name):
    """Three lanes of distinct pod masks, every node valid: the plain
    sweep's [explain] and [count] variants against the JAX batch's vmapped
    XLA scan counting every step (``count_all``), lane by lane, on chosen,
    first-fail counts and shortages. In [count] a lane's row is the pod's
    own step's count where its pod is valid, not forced and finds no node
    (``count_fails`` computes the row ``count_all`` does, on the same
    state), and zero elsewhere: the XLA scan's ``count_fails`` also counts
    a pod invalid in the lane that would find no node, a row no decode
    reads, which the kernel skips."""
    ref = _ref_prep(name)
    P = len(ref.ordered)
    pv = fx.lane_masks(P, 3)
    t, _v, f = pad_pod_stream(ref.tmpl_ids, pv[0], ref.forced)
    pv_all = np.zeros((pv.shape[0], len(t)), dtype=bool)
    pv_all[:, :P] = pv
    import jax.numpy as jnp

    out = ref_reqbatch._batched_schedule(ref.ec, ref.st0, jnp.asarray(t), jnp.asarray(pv_all), jnp.asarray(f),
                                         features=ref.features, unroll=1, explain=True)
    chosen = np.asarray(out.chosen)[:, :P]
    want_fc, want_in = np.asarray(out.fail_counts)[:, :P], np.asarray(out.insufficient)[:, :P]
    port = _port_prep(name)
    assert np.array_equal(port.tmpl_ids, ref.tmpl_ids) and np.array_equal(port.forced, ref.forced)
    fi, _ = fastpath.build_inputs(port)
    S = pv.shape[0]
    grid = fastpath.batch_inputs(port, fi, pv)
    for mode in ("explain", "count"):
        got = fs.fast_scan_sweep_reference(fi, *grid, **{mode: True})
        R = got.insufficient.shape[-1]
        assert not want_in[:, :, R:].any()
        for s in range(S):
            failing = pv[s] & ~port.forced & (chosen[s] < 0)
            rows = ~port.forced if mode == "explain" else failing
            np.testing.assert_array_equal(got.chosen[s].numpy(), chosen[s])
            np.testing.assert_array_equal(got.fail_counts[s].numpy()[rows], want_fc[s][rows], err_msg=mode)
            np.testing.assert_array_equal(got.insufficient[s].numpy()[rows], want_in[s, :, :R][rows], err_msg=mode)
            assert not got.fail_counts[s].numpy()[~rows].any() and not got.insufficient[s].numpy()[~rows].any()
