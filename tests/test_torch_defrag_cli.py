"""``simon defrag`` (alias ``drain``) of the port on the CPU (the plain
scenario grid) against ``python -m opensim_tpu defrag`` in-process: the
three example configs' ``--json`` and text reports equal byte for byte,
``--candidates`` and ``-o``; one grid call per run (one launch on a card);
an unknown candidate and a missing card refused."""

import os

import pytest
import torch

from opensim_tpu.cli import main as ref_cli
from opensim_tpu_torch.cli import main as cli
from opensim_tpu_torch.engine import fastpath

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("simon-config.yaml", "simon-gpushare-config.yaml", "simon-local-config.yaml")


def _example(name: str) -> str:
    return os.path.join(ROOT, "example", name)


@pytest.mark.parametrize("flags", [["--json"], [], ["--json", "--candidates", "worker-1,cp-2"]],
                         ids=["json", "text", "candidates"])
@pytest.mark.parametrize("config", EXAMPLES)
def test_defrag_equals_reference(config, flags, capsys, monkeypatch):
    if flags[-1:] == ["worker-1,cp-2"] and config != "simon-config.yaml":
        flags = ["--json"] + ["--candidates", _first_nodes(config)]
    assert ref_cli.main(["defrag", "-f", _example(config), *flags]) == 0
    want = capsys.readouterr().out
    grids = []
    real = fastpath.fast_scan_sweep
    monkeypatch.setattr(fastpath, "fast_scan_sweep", lambda *a, **kw: grids.append(a[2].shape[0]) or real(*a, **kw))
    assert cli.main(["defrag", "-f", _example(config), *flags, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert len(grids) == 1


def _first_nodes(config: str) -> str:
    from opensim_tpu_torch.planner.apply import Applier, Options

    nodes = Applier(Options(simon_config=_example(config), device="cpu")).load_cluster().nodes
    return ",".join(n.metadata.name for n in nodes[:2])


def test_drain_alias_and_output_file(tmp_path, capsys):
    out = tmp_path / "plan.txt"
    assert cli.main(["drain", "-f", _example(EXAMPLES[0]), "-o", str(out), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ""
    assert ref_cli.main(["defrag", "-f", _example(EXAMPLES[0])]) == 0
    assert out.read_text() == capsys.readouterr().out


def test_unknown_candidate_refused(capsys):
    assert cli.main(["defrag", "-f", _example(EXAMPLES[0]), "--candidates", "ghost", "--device", "cpu"]) == 1
    assert "unknown node(s): ghost" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal without a card")
def test_without_a_card_defrag_refuses(capsys):
    assert cli.main(["defrag", "-f", _example(EXAMPLES[0])]) == 1
    assert "no CUDA device" in capsys.readouterr().err
