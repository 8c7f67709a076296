"""The port stands alone: no module of opensim_tpu_torch/ and not
chip_smoke.py imports JAX or anything of the JAX package, and none imports
a module by a name computed at run time, which the check could not see."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "opensim_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "opensim_tpu")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _dynamic_imports(tree):
    """`importlib` imports and `__import__`/`import_module` calls."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("__import__", "import_module"):
                yield name
    for name in _imports(tree):
        if name == "importlib" or name.startswith("importlib."):
            yield name


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imports(tree) if _forbidden(n)]
    assert not bad, f"{path.name} imports {bad}"
    dynamic = list(_dynamic_imports(tree))
    assert not dynamic, f"{path.name} imports by computed name: {dynamic}"


def test_the_checker_sees_both_kinds():
    tree = ast.parse("import jax.numpy\nfrom opensim_tpu.models import fixtures\nimport opensim_tpu_torch\n")
    assert [n for n in _imports(tree) if _forbidden(n)] == ["jax.numpy", "opensim_tpu.models"]


def test_the_checker_sees_dynamic_imports():
    tree = ast.parse(
        "import importlib\nimportlib.import_module('opensim_tpu.models')\n"
        "__import__('jax')\nfrom importlib import import_module\n"
    )
    assert sorted(_dynamic_imports(tree)) == ["__import__", "import_module", "importlib", "importlib"]


@pytest.mark.parametrize("module", ["server/watch.py", "server/journal.py", "obs/fleetobs.py", "server/fleet.py",
                                    "obs/timeseries.py", "obs/slo.py"])
def test_the_live_twin_modules_are_checked(module):
    """The live twin's and the serving fleet's modules, framework-free in
    the JAX package, are the port's own copies, held by the check above."""
    path = ROOT / "opensim_tpu_torch" / module
    assert path in FILES
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not [n for n in _imports(tree) if _forbidden(n)]


def test_fleet_workers_are_spawned_from_the_port():
    """A fleet owner spawns its workers as fresh interpreters of the port's
    package (never ``-m opensim_tpu``), naming the device only off the
    card."""
    import torch

    from opensim_tpu_torch.server import fleet

    for device, tail in ((torch.device("cuda"), []), (torch.device("cpu"), ["--device", "cpu"])):
        argv = fleet.worker_argv(8080, device)
        assert argv[1:3] == ["-m", "opensim_tpu_torch"] and "opensim_tpu" not in argv
        assert argv[3:] == ["server", "--port", "8080", "--watch", "off", *tail]
    tree = ast.parse((ROOT / "opensim_tpu_torch" / "server" / "fleet.py").read_text())
    literals = {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert "opensim_tpu" not in literals
