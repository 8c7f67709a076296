"""The port's kernel build cache (``opensim_tpu_torch/utils/jitcache.py``)
against the JAX package's ``utils/jitcache.py``: the four settings of
``OPENSIM_JIT_CACHE`` (unset, ``1``, a path, ``0``) and an unwritable
directory; ``0``'s directory removed when its process exits, a failed
build's exit too (child processes); ``cache_stats()`` equal to the JAX
package's on the same directory, and what ``/api/debug/profile`` and the
``simon_jitcache_persistent_*`` lines report; the resolved directory in
the environment of the processes the port spawns (a fleet worker, a
loadgen-booted server). Only the tests import both packages; the JAX
module imported here is framework-free."""

import contextlib
import json
import logging
import os
import subprocess
import sys
import threading
import types
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

from opensim_tpu.utils import jitcache as ref_jitcache
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.models.objects import ResourceTypes
from opensim_tpu_torch.obs import profile
from opensim_tpu_torch.server import fleet, loadgen, rest
from opensim_tpu_torch.utils import jitcache, procgroup

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 60


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """An unresolved cache with the knob unset; a cold directory, if one is
    made, under `tmp_path` instead of a new temporary directory."""
    monkeypatch.delenv("OPENSIM_JIT_CACHE", raising=False)
    monkeypatch.setattr(jitcache, "_DIR", None)
    monkeypatch.setattr(jitcache, "_COLD", tmp_path / "cold")
    return tmp_path


@pytest.mark.parametrize("setting", ["unset", "1", "path"])
def test_a_reused_directory(fresh, monkeypatch, setting):
    """Unset and ``1`` name the default directory, a path that path; each
    is made, returned and built into."""
    want = jitcache.DEFAULT_DIR
    if setting == "path":
        want = fresh / "shared" / "build"
        monkeypatch.setenv("OPENSIM_JIT_CACHE", str(want))
    elif setting == "1":
        monkeypatch.setenv("OPENSIM_JIT_CACHE", "1")
    assert jitcache.maybe_enable(default=True) == str(want)
    assert jitcache.build_dir() == want and want.is_dir()
    if setting != "path":  # a caller's path takes the default directory's place
        assert jitcache.maybe_enable(path=str(fresh / "mine")) == str(fresh / "mine")
        assert jitcache.build_dir() == fresh / "mine"


def test_nothing_reused(fresh, monkeypatch):
    """``0``, and the knob unset for a caller that does not default on: no
    directory reused, the build goes into the process's cold one."""
    assert jitcache.maybe_enable() is None
    assert jitcache.build_dir() == fresh / "cold"
    monkeypatch.setenv("OPENSIM_JIT_CACHE", "0")
    assert jitcache.maybe_enable(default=True, path=str(fresh / "mine")) is None
    assert jitcache.build_dir() == fresh / "cold"
    assert jitcache.cache_stats() is None  # the cold directory was never made here


def test_an_unwritable_directory_warns_and_builds_cold(fresh, monkeypatch, caplog):
    blocker = fresh / "a-file"
    blocker.write_text("")
    monkeypatch.setenv("OPENSIM_JIT_CACHE", str(blocker / "build"))
    with caplog.at_level(logging.WARNING, logger="opensim_tpu_torch"):
        assert jitcache.maybe_enable(default=True) is None
    assert jitcache.build_dir() == fresh / "cold"
    assert any("kernel build cache disabled" in r.getMessage() and str(blocker) in r.getMessage()
               for r in caplog.records)


def test_build_dir_resolves_as_the_cli_does(fresh, monkeypatch):
    """A library caller that never called maybe_enable gets the CLI's
    directory on its first build."""
    monkeypatch.setenv("OPENSIM_JIT_CACHE", str(fresh / "lib"))
    assert jitcache.build_dir() == fresh / "lib"


_CHILD = """
import sys
sys.path.insert(0, {root!r})
from opensim_tpu_torch.utils import jitcache
d = jitcache.build_dir()
(d / "fast_scan-x.so.123.tmp").write_text("half a library")
print(d, flush=True)
if sys.argv[1] == "fail":
    raise RuntimeError("fast_scan: nvcc failed for fast_scan (1)")
"""


@pytest.mark.parametrize("end", ["exit", "fail"])
def test_cold_directory_is_removed_at_exit(tmp_path, end):
    """Under ``0`` a process builds into a directory of its own, which is
    gone once it exits, after a failed build too."""
    env = dict(os.environ, OPENSIM_JIT_CACHE="0", TMPDIR=str(tmp_path))
    proc = procgroup.spawn_group([sys.executable, "-c", _CHILD.format(root=str(ROOT)), end], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
    finally:
        procgroup.stop_group(proc, timeout_s=5.0)
    cold = Path(out.strip())
    assert proc.returncode == (0 if end == "exit" else 1), err
    assert cold.parent == tmp_path and cold.name.startswith("opensim-torch-build-")
    assert not cold.exists()
    assert ("nvcc failed" in err) == (end == "fail")


def _fill(path):
    path.mkdir()
    (path / "fast_scan-0123456789ab-v0.so").write_bytes(b"\0" * 1000)
    (path / "fast_scan-0123456789ab-v0.ptxas").write_text("ptxas info    : Used 40 registers\n")
    (path / "smoke").mkdir()  # a subdirectory is not a cached library
    (path / "smoke" / "plan.yaml").write_text("x" * 50)


def test_cache_stats_equal_the_reference(tmp_path, monkeypatch):
    d = tmp_path / "build"
    _fill(d)
    monkeypatch.setattr(jitcache, "_DIR", d)
    monkeypatch.setattr(ref_jitcache, "_ACTIVE_DIR", str(d))
    got = jitcache.cache_stats()
    assert got == ref_jitcache.cache_stats()
    assert got == {"dir": str(d), "files": 2, "bytes": 1000 + len("ptxas info    : Used 40 registers\n")}
    monkeypatch.setattr(jitcache, "_DIR", tmp_path / "missing")
    monkeypatch.setattr(ref_jitcache, "_ACTIVE_DIR", str(tmp_path / "missing"))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jitcache.cache_stats() is None and ref_jitcache.cache_stats() is None


@contextlib.contextmanager
def _http(server):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), rest.make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_debug_profile_reads_the_build_directory(tmp_path, monkeypatch):
    """``/api/debug/profile``'s ``persistent_cache`` and the
    ``simon_jitcache_persistent_*`` lines are ``cache_stats()`` of the
    resolved directory, whatever the process built."""
    d = tmp_path / "build"
    _fill(d)
    monkeypatch.setattr(jitcache, "_DIR", d)
    rt = ResourceTypes()
    rt.nodes.append(fx.make_fake_node("n0", "16", "64Gi"))
    server = rest.SimonServer(base_cluster=rt, device="cpu")
    with _http(server) as url, urllib.request.urlopen(f"{url}/api/debug/profile", timeout=60) as resp:
        got = json.load(resp)["compiles"]["persistent_cache"]
    assert got == jitcache.cache_stats() == profile.COMPILES.snapshot()["persistent_cache"]
    assert got["files"] == 2
    lines = profile.COMPILES.metrics_lines()
    assert "simon_jitcache_persistent_files 2" in lines and f"simon_jitcache_persistent_bytes {got['bytes']}" in lines


def test_a_fleet_worker_is_handed_the_build_directory(fresh, monkeypatch):
    """The owner's resolved directory reaches its worker's environment, a
    cold one (``0``) too: the worker loads what the owner built."""
    monkeypatch.setenv("OPENSIM_JIT_CACHE", "0")
    jitcache.maybe_enable(default=True)
    spawned = []

    class FakePopen:
        pid = 4242

        def __init__(self, argv, env):
            spawned.append((argv, env))

    monkeypatch.setattr(fleet.subprocess, "Popen", FakePopen)
    owner = types.SimpleNamespace(publisher=types.SimpleNamespace(control=types.SimpleNamespace(name="ctl")),
                                  lease=None, port=8080, device=torch.device("cpu"))
    fleet.FleetSupervisor._spawn(owner, fleet._Worker(0, 9000))
    (argv, env), = spawned
    assert env["OPENSIM_JIT_CACHE"] == str(fresh / "cold") == str(jitcache.build_dir())
    assert argv[-2:] == ["--device", "cpu"] and os.environ["OPENSIM_JIT_CACHE"] == "0"


def test_a_booted_server_is_handed_the_build_directory(fresh, monkeypatch):
    monkeypatch.setenv("OPENSIM_JIT_CACHE", str(fresh / "shared"))
    seen = {}

    def no_spawn(cmd, env, **_kw):
        seen.update(env)
        raise OSError("not started in this test")

    monkeypatch.setattr(procgroup, "spawn_group", no_spawn)
    with pytest.raises(OSError, match="not started"):
        loadgen._boot_server(str(fresh / "kube.yaml"), 0, admission=True, batch_max=4, device="cpu")
    assert seen["OPENSIM_JIT_CACHE"] == str(fresh / "shared")
