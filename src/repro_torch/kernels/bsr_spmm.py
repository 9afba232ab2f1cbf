"""Block-sparse product Y = A @ U on the card (port of
``repro.kernels.bsr_spmm``).

Replaces the Pallas TPU kernel ``repro/kernels/bsr_spmm.py::_spmm_kernel``
(launched by ``_bsr_spmm_impl``) with the CUDA C++ kernel in
``csrc/bsr_spmm.cu``, built for ``sm_90a`` and called through ``ctypes``.
It is bound by the bytes of the stored tiles, each read once; the design
notes are in the source.  For CPU tensors the wrapper runs the plain version
(``kernels.ref.bsr_spmm_ref``); for CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.bsr import BSR, BSROperand

__all__ = ["bsr_spmm", "bsr_spmm_t", "check_operands"]

#: widest BSR tile column count the kernel takes (32 lanes x 4 columns)
MAX_BK = 128


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("bsr_spmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bsr_spmm_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.bsr_spmm_f32.restype = i
    lib.bsr_spmm_gram_f32.argtypes = [p, p, p, p, p, p, p,
                                      i, i, i, i, i, i, i, p]
    lib.bsr_spmm_gram_f32.restype = i
    return lib


def check_operands(a: BSR, u: torch.Tensor) -> None:
    """What the CUDA kernels take: f32 tiles and factor, int32 block
    columns, contiguous, ``u`` of shape (m, k) with k >= 1, ``bk`` at most
    :data:`MAX_BK`.  bf16 is not ported yet."""
    for name, t in (("tiles", a.tiles), ("u", u)):
        if t.dtype == torch.bfloat16:
            raise NotImplementedError(
                f"bf16 {name}: the port's BSR kernels are f32 only for now")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.block_cols.dtype != torch.int32 or not a.block_cols.is_contiguous():
        raise TypeError("block_cols must be contiguous int32")
    if u.dim() != 2 or u.shape[0] != a.shape[1] or u.shape[1] < 1:
        raise ValueError(f"u must be ({a.shape[1]}, k>=1) for A of shape "
                         f"{a.shape}, got {tuple(u.shape)}")
    if a.bk > MAX_BK:
        raise ValueError(f"bk={a.bk} exceeds the kernel's {MAX_BK}")


def bsr_spmm(a: BSR, u: torch.Tensor) -> torch.Tensor:
    """``dense(A) @ U`` for BSR ``A`` (n x m) and dense ``U`` (m x k)."""
    if not _build.on_card(a.tiles, a.block_cols, u):
        return ref.bsr_spmm_ref(a, u)
    check_operands(a, u)
    n, m = a.shape
    k = u.shape[1]
    y = torch.empty((n, k), dtype=torch.float32, device=u.device)
    rc = _lib().bsr_spmm_f32(
        a.tiles.data_ptr(), a.block_cols.data_ptr(), u.data_ptr(),
        y.data_ptr(), n, m, k, a.nrb, a.bcap, a.bm, a.bk,
        _build.stream_ptr(u.device))
    _build.check_rc(rc, "bsr_spmm")
    _build.count_launch("bsr_spmm")
    return y


def bsr_spmm_t(a, u: torch.Tensor) -> torch.Tensor:
    """``dense(A)^T @ U`` via the transposed-format copy built at ingest;
    ``a`` is a :class:`BSROperand` or the transposed :class:`BSR` itself."""
    a_t = a.bsr_t if isinstance(a, BSROperand) else a
    return bsr_spmm(a_t, u)
