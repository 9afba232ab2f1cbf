"""Gram matrix G = U^T U on the card, in Triton (port of
``repro.kernels.gram``).

Replaces the Pallas TPU kernel ``repro/kernels/gram.py::_gram_kernel``
(launched by ``_gram_impl``), which streamed (bm, k) row slabs through VMEM
and accumulated into one k x k output across its sequential grid.  U is tall
and skinny (n rows, k of about 5), so the product is bound by one read of U:
at PubMed size 0.4 MB, a fraction of a microsecond at 3.35 TB/s, which
means launch time dominates.  Blocks on the card run in no order, so each
Triton program reduces a ``gram_bm``-row slab (k padded to a power of two
and masked) into its own f32 partial, and a second launch sums the partials
in program order: deterministic, with no float atomics.  For CPU tensors the
wrapper runs ``kernels.ref.gram_ref``; for CUDA tensors it launches or
raises.
"""
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.autotune import DEFAULT_TILES

__all__ = ["gram"]

#: triton.language, bound at the first launch (the package imports no
#: triton at import time, so the CPU test suite can import it)
tl = None


@functools.cache
def _kernels():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def gram_partial_kernel(u_ptr, part_ptr, n, k, BLOCK_N: tl.constexpr,
                            SUB: tl.constexpr, KP: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, KP)
        acc = tl.zeros((KP, KP), dtype=tl.float32)
        for r0 in range(0, BLOCK_N, SUB):
            rows = pid * BLOCK_N + r0 + tl.arange(0, SUB)
            x = tl.load(u_ptr + rows[:, None] * k + cols[None, :],
                        mask=(rows[:, None] < n) & (cols[None, :] < k),
                        other=0.0)
            acc += tl.sum(x[:, :, None] * x[:, None, :], axis=0)
        tl.store(part_ptr + pid * KP * KP + cols[:, None] * KP
                 + cols[None, :], acc)

    @triton.jit
    def gram_reduce_kernel(part_ptr, out_ptr, nparts, k, KP: tl.constexpr):
        cols = tl.arange(0, KP)
        offs = cols[:, None] * KP + cols[None, :]
        acc = tl.zeros((KP, KP), dtype=tl.float32)
        for p in range(0, nparts):
            acc += tl.load(part_ptr + p * KP * KP + offs)
        tl.store(out_ptr + cols[:, None] * k + cols[None, :], acc,
                 mask=(cols[:, None] < k) & (cols[None, :] < k))

    return gram_partial_kernel, gram_reduce_kernel


def _check(u: torch.Tensor) -> None:
    if u.dtype == torch.bfloat16:
        raise NotImplementedError("bf16 gram is not ported yet")
    if u.dtype != torch.float32:
        raise TypeError(f"u must be float32, got {u.dtype}")
    if u.dim() != 2 or u.shape[1] < 1:
        raise ValueError(f"u must be (n, k>=1), got {tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


def gram(u: torch.Tensor) -> torch.Tensor:
    """``U^T @ U`` (k, k) in f32 for an (n, k) ``U``."""
    if not _build.on_card(u):
        return ref.gram_ref(u)
    _check(u)
    n, k = u.shape
    block_n = DEFAULT_TILES.gram_bm
    kp = max(triton_next_pow2(k), 2)
    # rows per inner step: keep the (SUB, KP, KP) product near 4096 values
    sub = max(min(block_n, 4096 // (kp * kp)), 1)
    partial_kernel, reduce_kernel = _kernels()
    nprog = max(-(-n // block_n), 1)
    part = torch.empty((nprog, kp, kp), dtype=torch.float32, device=u.device)
    out = torch.empty((k, k), dtype=torch.float32, device=u.device)
    partial_kernel[(nprog,)](u, part, n, k, BLOCK_N=block_n, SUB=sub, KP=kp)
    reduce_kernel[(1,)](part, out, nprog, k, KP=kp)
    _build.count_launch("gram")
    return out


def triton_next_pow2(x: int) -> int:
    """Smallest power of two >= ``x``."""
    return 1 << max(int(x) - 1, 0).bit_length()
