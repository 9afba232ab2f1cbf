"""Device selection: the card by default, the CPU only when asked for.

There is no silent fallback.  A caller that does not name a device gets
``cuda``; if no card is visible that is an error, because a CPU run of the
port measures PyTorch's CPU kernels, not the program this package is for.
The CPU path exists for the test suite, which asks for it by name.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["default_device", "resolve_device", "configure_numerics"]

DeviceLike = Union[str, torch.device, None]


def configure_numerics() -> None:
    """f32 products in IEEE f32 on the card: TF32 off for matmuls and cuDNN
    (the reference runs with full-precision f32 dots)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """``cuda``; raises ``RuntimeError`` when no CUDA device is available."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the port's plain PyTorch versions on the CPU")
    configure_numerics()
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> :func:`default_device`; ``"cpu"`` -> the CPU; a CUDA
    device is checked for availability (and TF32 is switched off)."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        configure_numerics()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
