"""``simon gen-doc`` of the port against the JAX package's: the
assertions of ``tests/test_misc.py::test_gen_doc``; the port's file set is
the reference's but ``simon_lint.md`` (``simon lint`` is not ported); each
shared subcommand takes the reference's option strings, ``--device`` in
the place of ``--backend`` (and beside ``replay``'s, which simulates on the
card with ``--schedule``); the default directory is the port's own, never
the reference's ``docs/commandline``. ``COLUMNS`` is fixed, since argparse
wraps its help to the terminal's width."""

import argparse
import os

import pytest

from opensim_tpu.cli import main as ref_cli
from opensim_tpu_torch.cli import main as cli


@pytest.fixture(autouse=True)
def columns(monkeypatch):
    monkeypatch.setenv("COLUMNS", "100")


def _subparsers(parser):
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sp in action.choices.items():
                out.setdefault(id(sp), (name, sp))
    return dict(out.values())


def test_gen_doc(tmp_path):
    out_dir = tmp_path / "docs"
    assert cli.gen_doc(cli.build_parser(), str(out_dir)) == 0
    text = (out_dir / "simon.md").read_text()
    for cmd in ("apply", "defrag", "server", "version", "gen-doc"):
        assert f"simon {cmd}" in text
        per_cmd = (out_dir / f"simon_{cmd.replace('-', '_')}.md").read_text()
        assert f"# simon {cmd}" in per_cmd
    assert "--use-greed" in (out_dir / "simon_apply.md").read_text()


def test_file_set_is_the_references_but_lint(tmp_path, capsys):
    assert cli.main(["gen-doc", "--output-dir", str(tmp_path / "port")]) == 0
    assert ref_cli.gen_doc(ref_cli.build_parser(), str(tmp_path / "ref")) == 0
    port, ref = (sorted(os.listdir(tmp_path / d)) for d in ("port", "ref"))
    assert port == [f for f in ref if f != "simon_lint.md"] and "simon_lint.md" in ref
    assert capsys.readouterr().out.startswith(f"docs written to {tmp_path / 'port'}: simon.md, simon_apply.md")
    for name in port:  # each file in the reference's layout
        got, want = (tmp_path / "port" / name).read_text(), (tmp_path / "ref" / name).read_text()
        assert got.splitlines()[0] == want.splitlines()[0]
        assert got.count("```") == want.count("```") == 2
        if name != "simon.md":
            assert got.endswith("```\n\n[simon](simon.md)\n") and want.endswith("```\n\n[simon](simon.md)\n")
    index = (tmp_path / "port" / "simon.md").read_text()
    assert "usage: simon [-h]" in index and "## Commands" in index and "simon lint" not in index


def test_shared_subcommands_take_the_references_options():
    port, ref = _subparsers(cli.build_parser()), _subparsers(ref_cli.build_parser())
    assert set(port) == set(ref) - {"lint"}
    for name, sp in port.items():
        got = {o for a in sp._actions for o in a.option_strings} - {"--device"}
        want = {o for a in ref[name]._actions for o in a.option_strings} - {"--backend"}
        assert got == want, name
        if name in ("apply", "explain", "defrag", "campaign", "server", "replay"):
            assert any("--device" in a.option_strings for a in sp._actions), name


def test_default_directory_is_the_ports_own(tmp_path, monkeypatch):
    parser = cli.build_parser()
    assert parser.parse_args(["gen-doc"]).output_dir == "docs/commandline_torch"
    assert ref_cli.build_parser().parse_args(["gen-doc"]).output_dir == "docs/commandline"
    monkeypatch.chdir(tmp_path)
    assert cli.main(["gen-doc"]) == 0
    assert (tmp_path / "docs" / "commandline_torch" / "simon_gen_doc.md").is_file()
    assert not (tmp_path / "docs" / "commandline").exists()


def test_help_is_the_terminals_width(tmp_path, monkeypatch):
    """At a fixed width the same parser writes the same files; another
    width writes other files."""
    first, second, narrow = tmp_path / "a", tmp_path / "b", tmp_path / "narrow"
    assert cli.gen_doc(cli.build_parser(), str(first)) == 0
    assert cli.gen_doc(cli.build_parser(), str(second)) == 0
    monkeypatch.setenv("COLUMNS", "60")
    assert cli.gen_doc(cli.build_parser(), str(narrow)) == 0
    for name in os.listdir(first):
        text = (first / name).read_text()
        assert text == (second / name).read_text()
    assert (first / "simon_apply.md").read_text() != (narrow / "simon_apply.md").read_text()


def test_an_unwritable_output_dir_is_an_error(tmp_path, capsys):
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    assert cli.main(["gen-doc", "--output-dir", str(blocker / "docs")]) == 1
    assert capsys.readouterr().err.startswith("simon gen-doc: ")
