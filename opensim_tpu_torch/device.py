"""Device selection for the port's entry points.

Entry points run on the card unless the caller names another device. With
no card and no explicit device they raise: nothing slips onto the CPU
silently, so a CPU number is never taken for a card number.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``, and raises when there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
