"""Device selection: the card by default, the CPU only when asked for.

There is no silent fallback.  A caller that does not name a device gets
``cuda``; if no card is visible that is an error, because a CPU run of the
port measures PyTorch's CPU kernels, not the program this package is for.
The CPU path exists for the test suite, which asks for it by name; the
``meta`` device, asked for by name too, gives shapes without data (the
sharding specs of a full-size model or decode state).
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["default_device", "resolve_device", "configure_numerics", "move"]

DeviceLike = Union[str, torch.device, None]


def configure_numerics() -> None:
    """f32 products in IEEE f32 on the card: TF32 off for matmuls and cuDNN
    (the reference runs with full-precision f32 dots)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The current card, with its index (so devices compare with ``==``);
    raises ``RuntimeError`` when no CUDA device is available."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the port's plain PyTorch versions on the CPU")
    configure_numerics()
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> :func:`default_device`; ``"cpu"`` -> the CPU; a CUDA
    device is checked for availability (and TF32 is switched off), and
    ``cuda`` without an index becomes the current card."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        configure_numerics()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' "
                         "('meta' for shapes without data)")
    return dev


def move(t: torch.Tensor, device, non_blocking: bool = False
         ) -> torch.Tensor:
    """``t`` on ``device``.  With ``non_blocking`` a CPU tensor bound for a
    card is copied from pinned host memory (pinned first, one copy, if it
    is not) and the host does not wait for the copy: the caller orders the
    streams."""
    if (non_blocking and t.device.type == "cpu"
            and torch.device(device).type == "cuda" and not t.is_pinned()):
        t = t.pin_memory()
    return t.to(device, non_blocking=non_blocking)
