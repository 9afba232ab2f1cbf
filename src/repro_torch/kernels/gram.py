"""Gram matrix G = U^T U on the card, in one CUDA launch for any k (port of
``repro.kernels.gram``).

Replaces the Pallas TPU kernel ``repro/kernels/gram.py::_gram_kernel``
(launched by ``_gram_impl``), which streamed (bm, k) row slabs through VMEM
and accumulated into one k x k output across its sequential grid, with the
CUDA C++ kernel in ``csrc/gram.cu``, built for ``sm_90a`` and called through
``ctypes``.  U is tall and skinny (n rows, k of about 5), so the product is
bound by one read of U: at PubMed size 0.4 MB of f32, a fraction of a
microsecond at 3.35 TB/s, which means the host's cost per call dominates.  So the call
is one launch: blocks reduce their rows into f32 partials of one output
tile each (one tile up to k = 224, 128 x 128 tiles above it), and for each
tile the last block to take an integer ticket sums them in block order
(deterministic, no float atomics; design notes in the source).  The wrapper
keeps the tickets and the partials' scratch per device and allocates only
G.  U is f32 or bf16 (widened as it is staged); G is f32 either way.  For
CPU tensors it runs ``kernels.ref.gram_ref``; for CUDA tensors it launches
or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build, ref

__all__ = ["gram"]

#: per CUDA device: [tickets (int32, one per output tile, 0 between calls),
#: partials' scratch, SM count]
_SCRATCH: Dict[torch.device, list] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("gram")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.gram_f32, lib.gram_bf16):
        fn.argtypes = [p, p, p, p, i, i, i, p]
        fn.restype = i
    lib.gram_plan.argtypes = [i, i, p, p, p]
    lib.gram_plan.restype = i
    return lib


@functools.cache
def _plan(k: int, n_sm: int) -> tuple:
    """(tiles, scratch floats) of a call at this k, from the kernel's own
    plan."""
    tile, tiles, floats = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    rc = _lib().gram_plan(k, n_sm, ctypes.byref(tile), ctypes.byref(tiles),
                          ctypes.byref(floats))
    _build.check_rc(rc, "gram_plan")
    return tiles.value, floats.value


def _scratch(dev: torch.device, k: int) -> list:
    """The tickets, the partials' scratch and the SM count of ``dev``;
    created at the first call, grown when k needs more."""
    entry = _SCRATCH.get(dev)
    if entry is None:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        entry = _SCRATCH[dev] = [
            torch.zeros(0, dtype=torch.int32, device=dev),
            torch.empty(0, dtype=torch.float32, device=dev), n_sm]
    tiles, floats = _plan(k, entry[2])
    if entry[0].numel() < tiles:
        entry[0] = torch.zeros(tiles, dtype=torch.int32, device=dev)
    if entry[1].numel() < floats:
        entry[1] = torch.empty(floats, dtype=torch.float32, device=dev)
    return entry


def _check(u: torch.Tensor) -> None:
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    if u.dim() != 2 or u.shape[1] < 1:
        raise ValueError(f"u must be (n, k>=1), got {tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


def gram(u: torch.Tensor) -> torch.Tensor:
    """``U^T @ U`` (k, k) in f32 for an (n, k) f32 or bf16 ``U`` (bf16
    entries widened, f32 accumulation)."""
    if not _build.on_card(u):
        return ref.gram_ref(u)
    _check(u)
    lib = _lib()
    n, k = u.shape
    tickets, part, n_sm = _scratch(u.device, k)
    g = torch.empty((k, k), dtype=torch.float32, device=u.device)
    fn = lib.gram_bf16 if u.dtype == torch.bfloat16 else lib.gram_f32
    rc = fn(u.data_ptr(), g.data_ptr(), part.data_ptr(), tickets.data_ptr(),
            n, k, n_sm, _build.stream_ptr(u.device))
    _build.check_rc(rc, "gram")
    _build.count_launch("gram")
    return g
