"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Asking for CUDA on a machine without a
    usable GPU raises instead of quietly running on the CPU: a caller that
    wants the CPU says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def cpu_generator(seed: int) -> torch.Generator:
    """A seeded CPU generator: parameters and data are drawn on the CPU and
    moved to the target device, so one seed gives the same values on every
    device."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return g
