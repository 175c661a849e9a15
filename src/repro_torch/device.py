"""Device resolution for the port's entry points.

The port runs on the CUDA card.  An entry point given no device uses
``cuda`` and raises when no card is present: it never falls back to the CPU
quietly.  The CPU is used only when the caller asks for it by name, as the
tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        if device is None:
            raise RuntimeError(
                "no CUDA device is available and no device was given; pass "
                "device='cpu' to run on the CPU explicitly")
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not "
                           "available")
    return dev
