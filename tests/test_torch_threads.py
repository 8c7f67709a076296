"""One intra-op thread for torch in every test process.

A tier-1 run spreads the tests over worker processes that share the
host's cores with JAX's thread pools and the servers the end-to-end tests
spawn. Torch's intra-op pool, one thread a core by default, lets a single
port test take every core for a tensor op, which starves the timing-bound
tests of other workers (the watch tests wait a bounded time for each
step). The port's tests gain no wall time from it: their tensors are small.
This module is collected in every test process before any test runs, so
the cap holds for the whole session; the spawned servers get it from
``OMP_NUM_THREADS=1`` in their environment.
"""

import torch

torch.set_num_threads(1)


def test_torch_runs_one_intra_op_thread():
    assert torch.get_num_threads() == 1
