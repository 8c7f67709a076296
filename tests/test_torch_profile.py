"""The cumulative phase profiles, the kernels' build telemetry, the
Chrome-trace export and the profiler route of the port (``obs/profile.py``,
``obs/trace.py``, ``utils/trace.py``), on the CPU, against the JAX
package's where it has the same thing: the same synthetic span trees fold
into equal profile snapshots and ``/metrics`` lines, ``/api/debug/profile``
and ``simon profile`` carry the JAX server's keys and table columns. The
build telemetry runs ``fast_scan.build`` against a stand-in compiler, so
no library is ever loaded."""

import contextlib
import io
import json
import os
import stat
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from opensim_tpu.cli import main as ref_cli
from opensim_tpu.models import ResourceTypes as RefResourceTypes
from opensim_tpu.models import fixtures as ref_fx
from opensim_tpu.obs import profile as ref_profile, trace as ref_tracing
from opensim_tpu.server import rest as ref_rest
from opensim_tpu_torch.cli import main as cli
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.models.objects import ResourceTypes
from opensim_tpu_torch.obs import profile, trace as tracing
from opensim_tpu_torch.ops import fast_scan as fs
from opensim_tpu_torch.server import rest
from opensim_tpu_torch.utils import jitcache

#: (endpoint, [(span name, start, end, parent index or None)]) per trace:
#: fixed times, so both packages fold the same durations
TRACES = [
    ("deploy-apps", [("deploy-apps", 0.0, 0.120, None), ("prepare", 0.001, 0.040, 0), ("encode", 0.002, 0.030, 1),
                     ("schedule", 0.041, 0.100, 0), ("engine.kernel", 0.050, 0.095, 3), ("decode", 0.100, 0.118, 0)]),
    ("deploy-apps", [("deploy-apps", 0.0, 2.5, None), ("prepare", 0.0, 1.9, 0), ("encode", 0.1, 1.7, 1),
                     ("schedule", 1.9, 2.4, 0), ("decode", 2.4, 2.5, 0)]),
    ("scale-apps", [("scale-apps", 0.0, 0.004, None), ("schedule", 0.0, 0.003, 0), ("decode", 0.003, 0.004, 0)]),
]


def _trace(tr_mod, endpoint, spans):
    tr = tr_mod.TraceContext(endpoint)
    made = []
    for name, start, end, parent in spans:
        sp = tr.root if parent is None else tr_mod.Span(name, start)
        sp.start, sp.end = start, end
        if parent is not None:
            made[parent].children.append(sp)
        made.append(sp)
    return tr


def test_phase_profile_equals_the_reference():
    """Snapshots (counts, inclusive and exclusive seconds, p50/p99, max,
    per endpoint) and the ``simon_phase_profile_*`` lines are equal."""
    got, want = profile.PhaseProfile(), ref_profile.PhaseProfile()
    for endpoint, spans in TRACES:
        got.observe_trace(_trace(tracing, endpoint, spans))
        want.observe_trace(_trace(ref_tracing, endpoint, spans))
    snap = got.snapshot()
    assert snap == want.snapshot()
    assert snap["traces"] == 3 and snap["spans"]["prepare"]["exclusive_seconds"] < snap["spans"]["prepare"]["seconds"]
    assert got.metrics_lines() == want.metrics_lines()
    got.reset()
    assert got.snapshot()["traces"] == 0 and got.metrics_lines() == []


def test_chrome_export_round_trips(tmp_path):
    """``to_chrome``/``write_chrome``, as the JAX package's round-trip test
    reads them: every span an "X" event inside the root's window."""
    tr = tracing.start_trace("bench", force=True)
    with tracing.trace_scope(tr):
        with tracing.span("prepare", pods=3):
            with tracing.span("encode"):
                pass
        with tracing.span("schedule") as sp:
            sp.child_from_seconds("kernel.a", 0.25, steps=10)
            sp.child_from_seconds("kernel.b", 0.05, steps=10)
    tr.finish()
    out = tmp_path / "trace.json"
    tracing.write_chrome(tr, str(out))
    doc = json.loads(out.read_text())
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    by_name = {e["name"]: e for e in events}
    assert {"bench", "prepare", "encode", "schedule", "kernel.a", "kernel.b"} <= set(by_name)
    assert all(e["ts"] >= 0 for e in events)
    assert by_name["kernel.b"]["ts"] >= by_name["kernel.a"]["ts"] + by_name["kernel.a"]["dur"] - 1e-3
    assert by_name["bench"]["dur"] >= by_name["prepare"]["dur"]
    assert by_name["schedule"]["args"]["status"] == "ok" and by_name["prepare"]["args"]["pods"] == 3
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "M"] == \
        [e["name"] for e in ref_tracing.TraceContext("x").to_chrome()["traceEvents"] if e["ph"] == "M"]


# ---------------------------------------------------------------------------
# build telemetry
# ---------------------------------------------------------------------------


class _FakeLib:
    """What ``ctypes.CDLL`` would return: only attributes are set on it."""

    def __init__(self, path):
        self.path = path
        self.fast_scan_launch = type("F", (), {})()
        self.fast_scan_sweep_launch = type("F", (), {})()


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """``fast_scan.build`` into a fresh directory with a stand-in compiler
    (it writes the ``-o`` file and a ptxas-like report) and a stand-in
    loader; a fresh :class:`CompileWatch` records what it does."""
    script = tmp_path / "nvcc"
    script.write_text(f"#!{sys.executable}\nimport sys\nargs = sys.argv[1:]\n"
                      "open(args[args.index('-o') + 1], 'w').write('lib')\n"
                      "sys.stderr.write('ptxas info    : Used 40 registers\\n')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    watch = profile.CompileWatch()
    monkeypatch.setattr(fs, "_nvcc", lambda: str(script))
    monkeypatch.setattr(jitcache, "_DIR", tmp_path / "_build")
    monkeypatch.setattr(fs, "_LIBS", {})
    monkeypatch.setattr(fs, "_PTXAS", {})
    monkeypatch.setattr(fs, "BUILD_LOG", {"seconds": None, "variants": {}})
    monkeypatch.setattr(fs.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(fs, "COMPILES", watch)
    return watch


def test_build_telemetry_counts_nvcc_runs_and_cache_hits(fake_nvcc, monkeypatch):
    """Two variants built by nvcc (causes first, static), then, as in a
    process that has loaded none, both libraries found in the build
    directory (two hits); the snapshot agrees with BUILD_LOG and the
    metrics carry it."""
    fs.build(["fast_scan", "fast_scan[explain]"])
    log = fs.BUILD_LOG["variants"]
    snap = fake_nvcc.snapshot()
    assert set(snap) == set(ref_profile.CompileWatch().snapshot())
    assert set(snap["boundaries"]) == {"fast_scan", "fast_scan[explain]"}
    assert sum(b["compiles"] for b in snap["boundaries"].values()) == snap["backend"]["compiles"] == 2
    assert sorted(c for b in snap["boundaries"].values() for c in b["causes"]) == ["first", "static"]
    for name, b in snap["boundaries"].items():
        assert b["seconds"] == round(log[name]["seconds"], 6) and b["distinct_signatures"] == 1
    assert snap["cache_events"] == {"miss": 2}
    assert snap["persistent_cache"]["files"] == 4  # two libraries, two ptxas reports
    assert snap["persistent_cache"]["dir"] == str(jitcache.build_dir())
    fs.build(["fast_scan"])  # loaded: nothing happens
    assert fake_nvcc.snapshot()["cache_events"] == {"miss": 2}
    monkeypatch.setattr(fs, "_LIBS", {})
    fs.build(["fast_scan", "fast_scan[explain]"])
    snap = fake_nvcc.snapshot()
    assert snap["cache_events"] == {"hit": 2, "miss": 2} and snap["backend"]["compiles"] == 2
    assert all(v["seconds"] is None for v in fs.BUILD_LOG["variants"].values())  # BUILD_LOG: this call only
    text = "\n".join(fake_nvcc.metrics_lines())
    for line in ('simon_compile_total{fn="fast_scan"} 1', 'simon_jitcache_events_total{event="hit"} 2',
                 "simon_backend_compile_total 2", "simon_jitcache_persistent_files 4"):
        assert line in text
    assert 'simon_compile_cause_total{cause="first",fn="' in text
    fake_nvcc.reset()
    assert fake_nvcc.snapshot()["backend"] == {"compiles": 0, "seconds": 0.0}


def test_compile_watch_without_builds(tmp_path, monkeypatch):
    """Before any build: no boundary, no build directory, the backend
    totals at zero, as the JAX package's watch reports a process that
    compiled nothing."""
    monkeypatch.setattr(jitcache, "_DIR", tmp_path / "not-built-yet")
    watch = profile.CompileWatch()
    snap = watch.snapshot()
    assert snap == {"boundaries": {}, "backend": {"compiles": 0, "seconds": 0.0}, "cache_events": {},
                    "persistent_cache": None}
    assert watch.metrics_lines() == ["# HELP simon_backend_compile_total nvcc builds in the process",
                                     "# TYPE simon_backend_compile_total counter", "simon_backend_compile_total 0",
                                     "# HELP simon_backend_compile_seconds_total Wall seconds of every nvcc build "
                                     "in the process", "# TYPE simon_backend_compile_seconds_total counter",
                                     "simon_backend_compile_seconds_total 0.000000"]


# ---------------------------------------------------------------------------
# the surfaces: GET /api/debug/profile, simon profile, GET /debug/profiler
# ---------------------------------------------------------------------------


def _cluster(fxm, rt_cls):
    rt = rt_cls()
    for i in range(6):
        rt.nodes.append(fxm.make_fake_node(f"n{i}", "16", "64Gi"))
    return rt


def _payload(fxm):
    return {"deployments": [fxm.make_fake_deployment("web", 3, "250m", "512Mi").raw]}


@contextlib.contextmanager
def _http(server, make_handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def _get(url, body=None):
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.load(resp)


def _stdout(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _header(text, first):
    return next(line for line in text.splitlines() if line.startswith(first))


def test_debug_profile_route_and_simon_profile_equal_the_reference():
    """Both servers answer one deploy over HTTP; ``/api/debug/profile`` has
    the JAX server's keys (its ``native`` block reports the C++ engine
    the port does not have), the admission pipeline's block and one
    ``schedule`` call; ``simon profile`` prints the JAX CLI's table columns."""
    port = rest.SimonServer(base_cluster=_cluster(fx, ResourceTypes), device="cpu")
    ref = ref_rest.SimonServer(base_cluster=_cluster(ref_fx, RefResourceTypes))
    profile.PROFILE.reset()
    try:
        with _http(port, rest.make_handler) as url, _http(ref, ref_rest.make_handler) as ref_url:
            _get(f"{url}/api/deploy-apps", _payload(fx))
            _get(f"{ref_url}/api/deploy-apps", _payload(ref_fx))
            got, want = _get(f"{url}/api/debug/profile"), _get(f"{ref_url}/api/debug/profile")
            assert set(got) == set(want) - {"native"} and "pipeline" in got
            for key in ("phases", "compiles"):
                assert set(got[key]) == set(want[key]), key
            assert set(got["pipeline"]) == set(want["pipeline"])
            spans = got["phases"]["spans"]
            assert got["phases"]["traces"] == 1 and spans["schedule"]["count"] == 1
            assert {"prepare", "schedule", "engine.kernel", "decode"} <= set(spans)
            assert set(spans["schedule"]) == set(want["phases"]["spans"]["schedule"])
            rc, text = _stdout(cli.main, ["profile", "--url", url])
            ref_rc, ref_text = _stdout(ref_cli.main, ["profile", "--url", ref_url])
            assert rc == ref_rc == 0
            assert "phase profile over 1 recorded trace(s):" in text
            assert _header(text, "Span").split() == _header(ref_text, "Span").split()
            rc, text = _stdout(cli.main, ["profile", "--url", url, "--json"])
            assert rc == 0 and json.loads(text)["phases"]["traces"] == 1
            text = urllib.request.urlopen(f"{url}/metrics", timeout=60).read().decode()
            assert 'simon_phase_profile_calls_total{span="schedule"} 1' in text
            assert "simon_backend_compile_total" in text and "simon_mem_rss_bytes" in text
        assert cli.main(["profile", "--url", "http://127.0.0.1:9", "--timeout", "2"]) == 1
    finally:
        port.close()
        ref.close()


def test_profiler_route_records_a_request_and_exports_it(tmp_path):
    """``/debug/profiler`` starts a session over every thread (a second
    start answers the same session), one request is served meanwhile,
    ``?stop=1`` writes a Chrome trace holding the simulation's operators
    and the handler thread's spans; a stop without a session is a 409."""
    port = rest.SimonServer(base_cluster=_cluster(fx, ResourceTypes), admission=False, device="cpu")
    port.profile_dir = str(tmp_path / "prof")
    try:
        with _http(port, rest.make_handler) as url:
            first = _get(f"{url}/debug/profiler")
            assert first["profiler"] == "running" and first["activities"] == ["cpu"]
            assert _get(f"{url}/debug/profiler") == first
            _get(f"{url}/api/deploy-apps", _payload(fx))
            done = _get(f"{url}/debug/profiler?stop=1")
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(f"{url}/debug/profiler?stop=1")
            assert ei.value.code == 409
    finally:
        port.close()
    assert done["profiler"] == "stopped" and os.path.dirname(done["trace"]) == port.profile_dir
    events = json.load(open(done["trace"]))["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert any(n.startswith("aten::") for n in ops)
    assert threading.main_thread().native_id not in {e.get("tid") for e in events if e.get("cat") == "cpu_op"}
