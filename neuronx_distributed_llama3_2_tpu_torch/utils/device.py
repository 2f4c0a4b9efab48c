"""Device selection for the port's entry points.

Every entry point (model, weight loader, engine) runs on the card unless
the caller names another device. Asking for CUDA on a machine without it
raises here instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "explicitly to run the plain PyTorch path on the CPU"
        )
    return dev
