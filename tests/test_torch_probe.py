"""The port's CUDA probe (``opensim_tpu_torch/utils/probe.py``) against
the JAX package's ``utils/probe.py``: here, without a card, the verdict is
False and cached as "dead"; the cached verdict's TTL, its ownership check
and ``fresh=True`` decide as the reference's do; a child that outlives
the timeout is killed and gives False within timeout + 5 s; the CLI's
subcommands that simulate probe first when no ``--device`` is given, and
a failed probe ends them with its message, never on the CPU; with
``--device cpu`` no probe child starts. Every child process has a time
limit of its own."""

import os
import subprocess
import time

import pytest
import torch
import yaml

from opensim_tpu.utils import probe as ref_probe
from opensim_tpu_torch.cli import main as cli
from opensim_tpu_torch.engine import simulator
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.planner import apply
from opensim_tpu_torch.utils import procgroup, probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 60
no_card = pytest.mark.skipif(torch.cuda.is_available(), reason="the verdict without a card")


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """One verdict file for both packages' probes."""
    path = tmp_path / "verdict"
    monkeypatch.setenv("OPENSIM_PROBE_CACHE", str(path))
    monkeypatch.setattr(ref_probe, "_PROBE_CACHE", str(path))
    return path


@no_card
def test_without_a_card_the_verdict_is_false_and_cached(cache):
    t0 = time.monotonic()
    ok, why = probe.probe(timeout_s=CHILD_TIMEOUT_S, fresh=True)
    assert not ok and time.monotonic() - t0 < CHILD_TIMEOUT_S
    assert "\n" not in why and why
    assert cache.read_text() == "dead"
    assert probe.accelerator_reachable(timeout_s=CHILD_TIMEOUT_S) is False  # the cached verdict
    with pytest.raises(RuntimeError, match=r"^no CUDA device reachable: .*--device cpu") as err:
        probe.ensure_card()
    assert "\n" not in str(err.value)


@pytest.mark.parametrize("case", ["recent_ok", "recent_dead", "stale_ok", "foreign_ok", "fresh_flag"])
def test_cached_verdict_decides_as_the_reference(cache, monkeypatch, case):
    """Each package reads the same file and, where it must probe, runs a
    stand-in child that finds no card: the verdicts, the children run and
    the verdict left in the file are equal."""
    cache.write_text("dead" if case == "recent_dead" else "ok")
    if case == "stale_ok":
        old = time.time() - probe._PROBE_TTL_S - 1
        os.utime(cache, (old, old))
    if case == "foreign_ok":
        monkeypatch.setattr(os, "getuid", lambda: os.stat(cache).st_uid + 1)
    assert probe._PROBE_TTL_S == ref_probe._PROBE_TTL_S
    fresh = case == "fresh_flag"
    runs = {"port": 0, "ref": 0}

    def port_child(timeout_s):
        runs["port"] += 1
        return False, "stand-in: no card"

    def ref_child(*_a, **_kw):
        runs["ref"] += 1
        return subprocess.CompletedProcess([], 1, "", "stand-in: no card")

    monkeypatch.setattr(probe, "_run_child", port_child)
    monkeypatch.setattr(ref_probe.subprocess, "run", ref_child)
    before, st = cache.read_text(), os.stat(cache)
    got = probe.accelerator_reachable(fresh=fresh)
    after_port = cache.read_text()
    cache.write_text(before)  # the file as the port found it, for the reference
    os.utime(cache, ns=(st.st_atime_ns, st.st_mtime_ns))
    want = ref_probe.accelerator_reachable(fresh=fresh)
    assert after_port == cache.read_text()
    assert got == want == (case == "recent_ok")
    assert runs["port"] == runs["ref"] == (0 if case.startswith("recent") else 1)


@pytest.mark.parametrize("xdg", [True, False], ids=["xdg_runtime_dir", "no_xdg_runtime_dir"])
def test_the_verdict_file_lies_where_the_reference_puts_its_own(tmp_path, monkeypatch, xdg):
    """Without ``OPENSIM_PROBE_CACHE`` the verdict lies in
    ``XDG_RUNTIME_DIR`` when that is set, else in the temporary directory:
    the reference's directory (``opensim_tpu/utils/probe.py:23-31``), under
    the port's own file name; the knob, where set, comes first."""
    monkeypatch.delenv("OPENSIM_PROBE_CACHE", raising=False)
    monkeypatch.setattr(probe.tempfile, "gettempdir", lambda: str(tmp_path / "tmp"))
    if xdg:
        monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path / "run"))
    else:
        monkeypatch.delenv("XDG_RUNTIME_DIR", raising=False)
    got = probe.cache_path()
    want = ref_probe._default_cache_path()
    assert os.path.dirname(got) == os.path.dirname(want) == str(tmp_path / ("run" if xdg else "tmp"))
    assert os.path.basename(got) == f"opensim-tpu-torch-probe-{os.getuid()}" != os.path.basename(want)
    monkeypatch.setenv("OPENSIM_PROBE_CACHE", str(tmp_path / "verdict"))
    assert probe.cache_path() == str(tmp_path / "verdict")


def test_a_child_past_the_timeout_is_killed(cache, tmp_path, monkeypatch):
    pid_file = tmp_path / "pid"
    monkeypatch.setattr(probe, "_PROBE_CODE",
                        f"import os, time; open({str(pid_file)!r}, 'w').write(str(os.getpid())); time.sleep(120)")
    t0 = time.monotonic()
    ok, why = probe.probe(timeout_s=2, fresh=True)
    assert not ok and time.monotonic() - t0 < 2 + 5
    assert why == "a trivial CUDA op did not finish within 2 s"
    assert procgroup.pid_gone(int(pid_file.read_text()))
    assert cache.read_text() == "dead"


@pytest.mark.parametrize("argv, probes", [
    (["apply", "-f", "c.yaml"], True),
    (["apply", "-f", "c.yaml", "--device", "cpu"], False),
    (["apply", "-f", "c.yaml", "--device", "cuda"], False),
    (["explain", "-f", "c.yaml"], True),
    (["defrag", "-f", "c.yaml"], True),
    (["drain", "-f", "c.yaml"], True),
    (["server"], True),
    (["server", "--device", "cpu"], False),
    (["campaign", "spec.yaml"], True),
    (["campaign", "spec.yaml", "--url", "http://127.0.0.1:9"], False),
    (["replay", "journal"], False),
    (["replay", "journal", "--schedule", "5"], True),
    (["loadgen", "--url", "http://127.0.0.1:9"], False),
    (["top", "--url", "http://127.0.0.1:9"], False),
    (["version"], False),
    (["gen-doc"], False),
])
def test_which_subcommands_probe(argv, probes):
    assert cli._probes_the_card(cli.build_parser().parse_args(argv)) is probes


def _refuse(*_a, **_kw):
    raise AssertionError("ran after a failed probe")


@pytest.mark.parametrize("argv", [
    ["apply", "-f", "example/simon-config.yaml"],
    ["explain", "-f", "example/simon-config.yaml"],
    ["defrag", "-f", "example/simon-config.yaml"],
    ["campaign", "example/campaign.yaml"],
    ["replay", "journal", "--schedule", "5"],
    ["server", "--port", "0"],
])
def test_a_failed_probe_ends_the_subcommand(cache, monkeypatch, capsys, argv):
    """With a dead verdict cached, the subcommand prints the probe's reason
    as it prints its other errors and exits 1 before it loads anything."""
    cache.write_text("dead")
    monkeypatch.setattr(apply, "Applier", _refuse)
    monkeypatch.setattr(simulator, "simulate", _refuse)
    monkeypatch.setattr(simulator, "prepare", _refuse)
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert err.startswith(f"simon {argv[0]}: no CUDA device reachable: a probe ") and err.count("\n") == 1


@no_card
def test_apply_without_device_exits_with_the_probe_message(cache, monkeypatch, capsys):
    """The real probe's child, here where no card is: ``simon apply``
    without ``--device`` exits non-zero with its reason and runs nothing
    on the CPU."""
    monkeypatch.setattr(apply, "Applier", _refuse)
    monkeypatch.setattr(simulator, "simulate", _refuse)
    assert cli.main(["apply", "-f", os.path.join(ROOT, "example", "simon-config.yaml")]) == 1
    err = capsys.readouterr().err
    assert err.startswith("simon apply: no CUDA device reachable: ") and "--device cpu" in err
    assert cache.read_text() == "dead"


def test_device_cpu_starts_no_probe(cache, tmp_path, monkeypatch, capsys):
    def no_child(timeout_s):
        raise AssertionError("a probe child started under --device cpu")

    monkeypatch.setattr(probe, "_run_child", no_child)
    cluster, app = tmp_path / "cluster", tmp_path / "app"
    cluster.mkdir()
    app.mkdir()
    for i in range(2):
        (cluster / f"n{i}.yaml").write_text(yaml.safe_dump(fx.make_fake_node(f"n{i}", "8", "16Gi").raw))
    (app / "d.yaml").write_text(yaml.safe_dump(fx.make_fake_deployment("d", 3, "1", "1Gi").raw))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"apiVersion: simon/v1alpha1\nkind: Config\nmetadata: {{name: t}}\n"
                   f"spec:\n  cluster: {{customConfig: {cluster}}}\n  appList:\n    - name: a\n      path: {app}\n")
    out = tmp_path / "out.txt"
    assert cli.main(["apply", "-f", str(cfg), "--device", "cpu", "-o", str(out)]) == 0
    assert "Simulation success!" in out.read_text()
    assert not cache.exists()
