"""The bind-scan kernel against its plain version on the card. It imports
nothing of JAX (the card's machine has none), so it runs there without the
suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_card.py -q

Here, without a card, every test skips."""

import pytest
import torch

from opensim_tpu_torch.engine import fastpath, simulator as sim
from opensim_tpu_torch.models import fixtures as fx
from opensim_tpu_torch.ops import fast_scan as fs


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in fx.SCAN_CASES])
def test_kernel_matches_plain_version_on_card(name, cuda_device):
    cluster, app, node_pad = fx.scan_case(name)
    prep = sim.prepare(cluster, [sim.AppResource("a", app)], node_pad=node_pad, device=cuda_device)
    fi, _ = fastpath.build_inputs(prep)
    stream = fastpath.pod_stream(prep)
    before = fs.LAUNCHES
    got = fs.fast_scan(fi, *stream)
    torch.cuda.synchronize()
    want = fs.fast_scan_reference(fi, *stream)
    assert fs.LAUNCHES == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_simulate_on_card_launches_once(cuda_device):
    cluster, apps = fx.synthetic_cluster(64), fx.synthetic_apps(640)
    before = fs.LAUNCHES
    res = sim.simulate(cluster, [sim.AppResource("plan", apps)])
    assert fs.LAUNCHES == before + 1
    cpu = sim.simulate(fx.synthetic_cluster(64), [sim.AppResource("plan", fx.synthetic_apps(640))], device="cpu")
    assert (res.placements == cpu.placements).all() and (res.used == cpu.used).all()
