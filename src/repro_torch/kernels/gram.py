"""Gram matrix G = U^T U on the card, in one CUDA launch (port of
``repro.kernels.gram``).

Replaces the Pallas TPU kernel ``repro/kernels/gram.py::_gram_kernel``
(launched by ``_gram_impl``), which streamed (bm, k) row slabs through VMEM
and accumulated into one k x k output across its sequential grid, with the
CUDA C++ kernel in ``csrc/gram.cu``, built for ``sm_90a`` and called through
``ctypes``.  U is tall and skinny (n rows, k of about 5), so the product is
bound by one read of U: at PubMed size 0.4 MB, a fraction of a microsecond
at 3.35 TB/s, which means the host's cost per call dominates.  So the call
is one launch: blocks reduce their rows into f32 partials, and the last
block to take an integer ticket sums them in block order (deterministic,
no float atomics; design notes in the source).  The wrapper keeps the ticket
and the partials' scratch per device and allocates only G.  For CPU tensors
it runs ``kernels.ref.gram_ref``; for CUDA tensors it launches or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build, ref

__all__ = ["gram", "MAX_K"]

#: widest U the kernel takes: its k x k f32 partial, a pass's group sums and
#: a 16 KB chunk of U fit in the 227 KB of shared memory a block may hold
MAX_K = 224

#: per CUDA device: [ticket (one int32, 0 between calls), partials' scratch,
#: SM count]
_SCRATCH: Dict[torch.device, list] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("gram")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gram_f32.argtypes = [p, p, p, p, i, i, i, p]
    lib.gram_f32.restype = i
    return lib


def _scratch(dev: torch.device, k: int) -> list:
    """The ticket, a scratch of at least one k x k partial per SM, and the
    SM count of ``dev``; created at the first call, grown when k grows."""
    entry = _SCRATCH.get(dev)
    if entry is None:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        entry = _SCRATCH[dev] = [
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.empty(0, dtype=torch.float32, device=dev), n_sm]
    if entry[1].numel() < entry[2] * k * k:
        entry[1] = torch.empty(entry[2] * k * k, dtype=torch.float32,
                               device=dev)
    return entry


def _check(u: torch.Tensor) -> None:
    if u.dtype == torch.bfloat16:
        raise NotImplementedError("bf16 gram is not ported yet")
    if u.dtype != torch.float32:
        raise TypeError(f"u must be float32, got {u.dtype}")
    if u.dim() != 2 or u.shape[1] < 1:
        raise ValueError(f"u must be (n, k>=1), got {tuple(u.shape)}")
    if u.shape[1] > MAX_K:
        raise ValueError(f"the gram kernel takes k <= {MAX_K}, got "
                         f"{u.shape[1]}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


def gram(u: torch.Tensor) -> torch.Tensor:
    """``U^T @ U`` (k, k) in f32 for an (n, k) ``U``."""
    if not _build.on_card(u):
        return ref.gram_ref(u)
    _check(u)
    lib = _lib()
    n, k = u.shape
    ticket, part, n_sm = _scratch(u.device, k)
    g = torch.empty((k, k), dtype=torch.float32, device=u.device)
    rc = lib.gram_f32(u.data_ptr(), g.data_ptr(), part.data_ptr(),
                      ticket.data_ptr(), n, k, n_sm,
                      _build.stream_ptr(u.device))
    _build.check_rc(rc, "gram")
    _build.count_launch("gram")
    return g
