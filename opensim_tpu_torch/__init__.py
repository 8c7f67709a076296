"""PyTorch/CUDA port of the cluster simulator.

The library entry point is :func:`opensim_tpu_torch.engine.simulator.simulate`:
it expands a cluster and its applications into a pod stream, encodes it,
and places the whole stream with one hand-written Hopper kernel
(``ops/csrc/fast_scan.cu``). Entry points run on the card unless the caller
passes ``device="cpu"``, where each kernel's plain PyTorch version runs.
"""

__version__ = "0.1.0"
