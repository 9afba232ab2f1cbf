"""Fused relu + top-t threshold mask on the card, in Triton (port of
``repro.kernels.project_mask``).

Replaces the Pallas TPU kernel
``repro/kernels/project_mask.py::_project_mask_kernel`` (launched by
``_project_mask_impl``): ``y = max(x, 0); out = where(y >= tau, y, 0)`` in
one elementwise pass.  Bound by one read and one write of the factor; the
design keeps it to exactly that, and reads ``tau`` through a device pointer,
so the bisection that produced it and this mask run with no host sync in
between.  For CPU tensors the wrapper runs ``kernels.ref.project_mask_ref``
(bitwise the same function); for CUDA tensors it launches or raises.
"""
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.autotune import DEFAULT_TILES

__all__ = ["project_mask"]

#: triton.language, bound at the first launch (the package imports no
#: triton at import time, so the CPU test suite can import it)
tl = None


@functools.cache
def _kernel():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def project_mask_kernel(x_ptr, tau_ptr, out_ptr, numel,
                            BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        inside = offs < numel
        x = tl.load(x_ptr + offs, mask=inside, other=0.0)
        tau = tl.load(tau_ptr)
        y = tl.maximum(x, 0.0)
        tl.store(out_ptr + offs, tl.where(y >= tau, y, 0.0), mask=inside)

    return project_mask_kernel


def project_mask(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """relu + threshold mask of a 2-D factor; ``tau`` is a 0-d tensor on
    ``x``'s device."""
    if not _build.on_card(x, tau):
        return ref.project_mask_ref(x, tau)
    if x.dtype == torch.bfloat16:
        raise NotImplementedError("bf16 project_mask is not ported yet")
    if x.dtype != torch.float32 or tau.dtype != torch.float32:
        raise TypeError(f"x and tau must be float32, got {x.dtype}, "
                        f"{tau.dtype}")
    if tau.numel() != 1:
        raise ValueError(f"tau must hold one value, got {tuple(tau.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    numel = x.numel()
    if numel == 0:
        return out
    block = DEFAULT_TILES.mask_block
    _kernel()[(-(-numel // block),)](x, tau, out, numel, BLOCK=block)
    _build.count_launch("project_mask")
    return out
