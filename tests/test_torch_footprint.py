"""The memory observatory of the port (``obs/footprint.py``) against the JAX
package's, on the CPU: the cases of ``tests/test_footprint.py``, each run
through both packages' servers and encode caches on the same cluster and
requests. The cluster has 128 nodes: the JAX package pads the node axis
to a multiple of 128 and the port does not pad it, so at 128 nodes both
encode the same arena shapes and every entry's fields, bytes, dtypes and
shapes compare exactly."""

import contextlib
import io
import json
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import torch

from opensim_tpu.cli import main as ref_cli
from opensim_tpu.engine import prepcache as ref_prepcache
from opensim_tpu.models import ResourceTypes as RefResourceTypes
from opensim_tpu.models import fixtures as ref_fx
from opensim_tpu.obs import capacity as ref_capacity, footprint as ref_footprint
from opensim_tpu.server import rest as ref_rest
from opensim_tpu_torch.cli import main as cli
from opensim_tpu_torch.engine import prepcache
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.models.objects import ResourceTypes
from opensim_tpu_torch.obs import capacity, footprint
from opensim_tpu_torch.server import rest

N_NODES = 128


def _cluster(fxm, rt_cls, nodes=N_NODES, bound=12):
    rt = rt_cls()
    for i in range(nodes):
        rt.nodes.append(fxm.make_fake_node(f"n{i}", "16", "64Gi"))
    for i in range(bound):
        rt.pods.append(fxm.make_fake_pod(f"b{i:02d}", "500m", "1Gi", fxm.with_node_name(f"n{i % nodes}")))
    return rt


def _payload(fxm, name="web", replicas=3):
    return {"deployments": [fxm.make_fake_deployment(name, replicas, "250m", "512Mi").raw]}


def _servers(nodes=N_NODES, bound=12):
    """(port server, JAX server) on the same cluster, single-flight."""
    port = rest.SimonServer(base_cluster=_cluster(fx, ResourceTypes, nodes, bound), admission=False, device="cpu")
    ref = ref_rest.SimonServer(base_cluster=_cluster(ref_fx, RefResourceTypes, nodes, bound), admission=False)
    return port, ref


def _deploy(port, ref, name="web"):
    assert port.deploy_apps(_payload(fx, name))[0] == 200
    assert ref.deploy_apps(_payload(ref_fx, name))[0] == 200


def _comparable(entry):
    """An entry's footprint without its cache key (the keys hold each
    package's fingerprints)."""
    return {k: v for k, v in entry.items() if k != "key"}


def _base(server):
    key = next(e.key for e in server.prep_cache.entries_snapshot() if e.key.endswith("|base"))
    return server.prep_cache.get(key)


# ---------------------------------------------------------------------------
# arena accounting
# ---------------------------------------------------------------------------


def test_entry_footprint_equals_the_reference():
    """Every entry's fields (bytes, dtype, shape), totals, dtype classes,
    lineage depth, drop density and pods equal the JAX package's."""
    port, ref = _servers()
    _deploy(port, ref)
    got = footprint.prepcache_footprint(port.prep_cache, include_fields=True)
    want = ref_footprint.prepcache_footprint(ref.prep_cache, include_fields=True)
    assert got["entries"] and len(got["entries"]) == len(want["entries"])
    assert [_comparable(e) for e in got["entries"]] == [_comparable(e) for e in want["entries"]]
    entry = got["entries"][0]
    assert entry["fields"]["alloc"]["dtype"] == "float32"
    assert set(entry["dtypes"]) <= {"float32", "int32", "int64", "bool", "other"}
    assert "off_policy_fields" not in entry
    assert sum(entry["dtypes"].values()) == entry["bytes"]


def test_cache_totals_reconcile_and_count_shared_leaves_once():
    port, ref = _servers()
    for k in range(3):
        _deploy(port, ref, f"app-{k}")
    got = footprint.prepcache_footprint(port.prep_cache)
    want = ref_footprint.prepcache_footprint(ref.prep_cache)
    assert len(got["entries"]) >= 2
    assert got["total_bytes"] == sum(e["unique_bytes"] for e in got["entries"])
    assert got["shared_bytes"] > 0
    assert sum(got["dtypes"].values()) == got["total_bytes"]
    for key in ("total_bytes", "shared_bytes", "dtypes", "stats"):
        assert got[key] == want[key], key


def test_twin_deltas_report_lineage_and_drop_density_as_the_reference():
    """Two generations of twin deltas with a drop mask: depth 1 then 2,
    the drop density and the pods equal the JAX package's; the port's
    entries keep no base (the lineage is a number)."""
    port, ref = _servers()
    _deploy(port, ref)
    fps = []
    for mod, pc, fxm, server in ((prepcache, prepcache, fx, port), (ref_prepcache, ref_prepcache, ref_fx, ref)):
        base = _base(server)
        out = []
        with base.lock:
            base.restore()
            first = pc.twin_pod_delta(base, base.key + "|churn", [fxm.make_fake_pod("new-pod", "250m", "512Mi")],
                                      {("default", "b00"), ("default", "b01")})
            assert first is not None
            second = pc.twin_pod_delta(first, base.key + "|churn2", [], {("default", "b02")})
            assert second is not None
        for entry in (first, second):
            fp = (footprint if mod is prepcache else ref_footprint).entry_footprint(entry)
            out.append({k: fp[k] for k in ("lineage_depth", "drop_density", "pods", "bytes", "dtypes", "fields")})
        fps.append(out)
        if mod is prepcache:
            assert not hasattr(second, "base")
    assert [f["lineage_depth"] for f in fps[0]] == [1, 2]
    assert fps[0][1]["drop_density"] > fps[0][0]["drop_density"] > 0
    assert fps[0] == fps[1]


def test_compaction_counter_bumps_on_density_refusal():
    port, ref = _servers(nodes=N_NODES, bound=80)
    _deploy(port, ref)
    removed = {("default", f"b{i:02d}") for i in range(70)}  # past the 64-row floor
    for pc, server in ((prepcache, port), (ref_prepcache, ref)):
        base = _base(server)
        before = pc.compactions_total()
        with base.lock:
            base.restore()
            assert pc.twin_pod_delta(base, base.key + "|x", [], removed) is None
        assert pc.compactions_total() == before + 1


def test_process_memory_and_watermark():
    proc = footprint.process_memory()
    assert proc["rss_bytes"] > 0 and proc["rss_peak_bytes"] >= proc["rss_bytes"]
    assert set(proc) == set(ref_footprint.process_memory())
    obs = footprint.MemoryObservatory()
    first = obs.sample_process()
    assert obs.sample_process()["rss_peak_bytes"] >= first["rss_peak_bytes"]  # a monotone peak


def test_memory_rows_parity_with_cluster_report_and_top():
    """The ``?mem=1`` report block's rows are what ``simon top --mem``
    prints, and their labels and the prep-cache row equal the JAX
    package's; without ``?mem=1`` the block is absent."""
    port, ref = _servers()
    _deploy(port, ref)
    report = port.cluster_report(probe_headroom=False, include_memory=True)
    want = ref.cluster_report(probe_headroom=False, include_memory=True)
    rows = report["memory"]["rows"]
    assert rows == footprint.memory_rows(report["memory"]["summary"])
    assert [r[0] for r in rows] == [r[0] for r in want["memory"]["rows"]]
    assert dict(rows)["prep cache"] == dict(want["memory"]["rows"])["prep cache"]
    assert set(report["memory"]["summary"]) == set(want["memory"]["summary"])
    text = capacity.format_top(report)
    assert all(cell in text for row in rows for cell in row)
    assert "process RSS" in ref_capacity.format_top(want)
    bare = port.cluster_report(probe_headroom=False)
    assert "memory" not in bare and "process RSS" not in capacity.format_top(bare)


def test_mem_ticker_env_knob(monkeypatch):
    monkeypatch.setenv("OPENSIM_MEM_TICKER_S", "0")
    obs = footprint.MemoryObservatory()
    obs.start_ticker()
    assert obs._ticker is None  # 0 disables
    monkeypatch.setenv("OPENSIM_MEM_TICKER_S", "not-a-number")
    assert footprint.mem_ticker_s() == ref_footprint.mem_ticker_s() == 10.0  # a typo degrades to the default
    monkeypatch.setenv("OPENSIM_MEM_TICKER_S", "0.05")
    obs.start_ticker()
    try:
        assert obs._ticker is not None and obs._ticker.is_alive()
    finally:
        obs.stop()
    assert obs._ticker is None


def test_device_memory_on_the_cpu_creates_no_cuda_context():
    """On the CPU there is no device series, and neither a read nor the
    observatory creates a CUDA context; a process that has not imported
    torch does not import it to read."""
    assert footprint.device_memory() == {} == ref_footprint.device_memory()
    obs = footprint.MemoryObservatory()
    assert obs.debug_payload()["devices"] == {}
    assert not torch.cuda.is_initialized()
    probe = ("import sys; from opensim_tpu_torch.obs import footprint as f; "
             "assert f.device_memory() == {}; f.MemoryObservatory().sample_process(); "
             "assert 'torch' not in sys.modules")
    subprocess.run([sys.executable, "-c", probe], check=True, timeout=120)


# ---------------------------------------------------------------------------
# the surfaces: GET /api/debug/memory and simon mem
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _http(server, make_handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.load(resp)


def _stdout(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_debug_memory_route_and_simon_mem_equal_the_reference():
    """``/api/debug/memory`` (with and without ``?fields=0``) has the JAX
    server's keys and prep-cache view; ``simon mem`` prints the JAX CLI's
    lines and table columns, ``--json`` its keys; ``simon top --mem``
    prints the memory rows."""
    port, ref = _servers()
    _deploy(port, ref)
    try:
        with _http(port, rest.make_handler) as url, _http(ref, ref_rest.make_handler) as ref_url:
            mem, want = _get(f"{url}/api/debug/memory"), _get(f"{ref_url}/api/debug/memory")
            assert set(mem) == set(want) and set(mem["prepcache"]) == set(want["prepcache"])
            assert mem["process"]["rss_bytes"] > 0 and mem["devices"] == {}
            assert [_comparable(e) for e in mem["prepcache"]["entries"]] == \
                [_comparable(e) for e in want["prepcache"]["entries"]]
            assert "fields" in mem["prepcache"]["entries"][0]
            lean = _get(f"{url}/api/debug/memory?fields=0")
            assert "fields" not in lean["prepcache"]["entries"][0]
            assert lean["prepcache"]["total_bytes"] == want["prepcache"]["total_bytes"]
            rc, text = _stdout(cli.main, ["mem", "--url", url])
            ref_rc, ref_text = _stdout(ref_cli.main, ["mem", "--url", ref_url])
            assert rc == ref_rc == 0
            assert "prep cache:" in text and "process: RSS" in text
            lines, ref_lines = text.splitlines(), ref_text.splitlines()
            for head in ("Entry", "Ring"):
                assert [ln for ln in lines if ln.startswith(head)] == [ln for ln in ref_lines if ln.startswith(head)]
            # the compaction counts are each package's, process-wide: the
            # tests that ran before this one in the process move them
            cache_line = lambda ls, n: [ln.replace(f", {n} compaction(s)", ", N compaction(s)")
                                        for ln in ls if ln.startswith("prep cache:")]
            got_line = cache_line(lines, prepcache.compactions_total())
            assert got_line == cache_line(ref_lines, ref_prepcache.compactions_total())
            assert len(got_line) == 1 and got_line[0].endswith(", N compaction(s)")
            rc, text = _stdout(cli.main, ["mem", "--url", url, "--json", "--fields"])
            assert rc == 0 and set(json.loads(text)) == set(want)
            rc, text = _stdout(cli.main, ["top", "--url", url, "--mem", "--no-headroom"])
            assert rc == 0 and "process RSS" in text and "prep cache" in text
        assert cli.main(["mem", "--url", "http://127.0.0.1:9", "--timeout", "2"]) == 1
    finally:
        port.close()
        ref.close()
