"""The port's graft entry points (``opensim_tpu_torch/graft_entry.py``)
against ``__graft_entry__.py``, as tests/test_graft_entry.py runs it:
``entry()``'s scan equals the reference's jitted scan (placements exactly,
usage with rtol=0, atol=0 on the real nodes, the reference's padded rows
empty), and ``dryrun_multichip`` split over eight CPU entries prints and
returns what the reference's prints over its eight virtual devices."""

import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as ref_graft  # noqa: E402
from opensim_tpu_torch import graft_entry  # noqa: E402
from opensim_tpu_torch.parallel import scenarios  # noqa: E402

LINE = re.compile(r"^dryrun_multichip: (\d+) devices, (\d+) scenarios, unscheduled per scenario=(\[.*\]), best=(\d+)$")


def test_entry_equals_the_reference_scan():
    fn, args = graft_entry.entry(device="cpu")
    chosen, used = fn(*args)
    assert chosen.device.type == used.device.type == "cpu"
    ref_fn, ref_args = ref_graft.entry()
    want_chosen, want_used = (np.asarray(a) for a in jax.jit(ref_fn)(*ref_args))
    np.testing.assert_array_equal(chosen.numpy(), want_chosen)
    N = used.shape[0]
    np.testing.assert_allclose(used.numpy(), want_used[:N], rtol=0, atol=0)
    assert not want_used[N:].any()  # the reference pads the node axis with empty nodes
    assert (chosen >= 0).all() and len(set(chosen.tolist())) == N


def test_entry_without_a_device_runs_on_the_card(monkeypatch):
    """Like every entry point: the card unless the caller names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def _line(text: str):
    lines = [m.groups() for m in map(LINE.match, text.splitlines()) if m]
    assert len(lines) == 1, text
    return lines[0]


def test_dryrun_multichip_equals_the_reference(capsys):
    n = len(jax.devices())
    assert n == 8
    ref_graft.dryrun_multichip(n)
    want = _line(capsys.readouterr().out)
    unscheds, best = graft_entry.dryrun_multichip(n, devices=[torch.device("cpu")] * n)
    got = _line(capsys.readouterr().out)
    assert got == want
    assert (str(unscheds).replace(" ", ""), str(best)) == (want[2].replace(" ", ""), want[3])
    assert len(unscheds) == 2 * n


def test_dryrun_multichip_split_equals_unsplit(monkeypatch):
    """The dry run over three CPU entries (S = 4: the last shard padded)
    sweeps exactly as one unsplit sweep of the same masks."""
    seen = {}
    real = scenarios.sweep_auto

    def keep(prep, *args, **kw):
        seen["prep"], seen["args"], seen["res"] = prep, args, real(prep, *args, **kw)
        return seen["res"]

    monkeypatch.setattr(scenarios, "sweep_auto", keep)
    unscheds, best = graft_entry.dryrun_multichip(2, devices=["cpu"] * 3)
    whole = real(seen["prep"], *seen["args"])
    for field in scenarios.SweepResult._fields:
        np.testing.assert_array_equal(getattr(seen["res"], field), getattr(whole, field))
    assert unscheds == whole.unscheduled.tolist() and len(unscheds) == 4 and best == 0


def test_dryrun_multichip_needs_its_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices, have 0"):
        graft_entry.dryrun_multichip(2)
