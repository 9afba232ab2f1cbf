"""Block-sparse product Y = A @ U on the card (port of
``repro.kernels.bsr_spmm``).

Replaces the Pallas TPU kernel ``repro/kernels/bsr_spmm.py::_spmm_kernel``
(launched by ``_bsr_spmm_impl``) with the CUDA C++ kernel in
``csrc/bsr_spmm.cu``, built for ``sm_90a`` and called through ``ctypes``.

At a small rank it is bound by the bytes of the stored tiles, each read
once (0.61 GB of f32 per orientation at PubMed size, 0.18 ms at 3.35 TB/s;
half that in bf16).  Tiles and factor are f32 or bf16 (one dtype); the
product comes back in the factor's dtype, accumulated in f32.  A persistent
grid of one block per SM streams the flattened (row-block, slot) stream in
equal runs fixed at ingest (``BSR.plan``); in each block a producer warp
keeps a ring of whole tiles in flight by bulk copy (``cp.async.bulk``, with
the U slab in f32 on the stage's mbarrier) and seven consumer warps read
them.  A factor wider than the column chunk ``kb`` (8, 32 or 64, from the
tile ledger) streams the tiles once per chunk.  A row-block cut by a run
boundary is finished by the last of its runs, which adds their partials in
run order: no float atomics, bitwise repeatable.  The design notes are in
the source.

For CPU tensors the wrapper runs the plain version
(``kernels.ref.bsr_spmm_ref``); for CUDA tensors it launches the kernel or
raises; for meta tensors (an operand moved to ``meta`` keeps its shapes and
its occupied-tile count) it returns an empty product and records the launch
and its :func:`cost`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.autotune import (
    KB_WIDTHS, MAX_BK, MAX_BM, column_chunk, device_kind, resolve_tiles,
)
from repro_torch.kernels.bsr import BSR, BSROperand
from repro_torch.scan import record_kernel

__all__ = ["bsr_spmm", "bsr_spmm_t", "check_operands", "resolve_kb", "cost"]

#: the operand dtypes the kernels take (tiles and factor of one dtype)
DTYPES = (torch.float32, torch.bfloat16)

#: per device: zeroed int32 tickets (the kernels reset the ones they take)
#: and f32 scratch for the partials, grown on demand
_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("bsr_spmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bsr_spmm_run.argtypes = [p] * 9 + [i] * 10 + [p]
    lib.bsr_spmm_run.restype = i
    lib.bsr_spmm_gram_run.argtypes = [p] * 12 + [i] * 10 + [p]
    lib.bsr_spmm_gram_run.restype = i
    return lib


def check_operands(a: BSR, u: torch.Tensor) -> None:
    """What the CUDA kernels take: f32 or bf16 tiles and factor of one
    dtype, int32 block columns, contiguous, ``u`` of shape (m, k) with
    k >= 1, ``bm`` at most :data:`MAX_BM`, ``bk`` at most :data:`MAX_BK`
    with a tile row of whole 16-byte vectors (a multiple of 4 in f32, of 8
    in bf16), tiles 16-byte aligned (a tile is one bulk copy)."""
    for name, t in (("tiles", a.tiles), ("u", u)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.tiles.dtype != u.dtype:
        raise TypeError(f"tiles ({a.tiles.dtype}) and u ({u.dtype}) must "
                        "have one dtype")
    if a.block_cols.dtype != torch.int32 or not a.block_cols.is_contiguous():
        raise TypeError("block_cols must be contiguous int32")
    if u.dim() != 2 or u.shape[0] != a.shape[1] or u.shape[1] < 1:
        raise ValueError(f"u must be ({a.shape[1]}, k>=1) for A of shape "
                         f"{a.shape}, got {tuple(u.shape)}")
    vec = 16 // u.element_size()
    if a.bk > MAX_BK or a.bk % vec:
        raise ValueError(f"bk={a.bk}: the kernel takes a multiple of {vec} "
                         f"up to {MAX_BK} in {u.dtype}")
    if a.bm > MAX_BM:
        raise ValueError(f"bm={a.bm} exceeds the kernel's {MAX_BM}")
    if a.tiles.data_ptr() % 16:
        raise ValueError("tiles must start on a 16-byte boundary (each tile "
                         "is one bulk copy)")
    if a.plan.rb_runs.shape[0] != a.nrb or a.plan.runs > a.nrb * a.bcap:
        raise ValueError("the operand's split plan does not match its "
                         "tiles")


def resolve_kb(a: BSR, u: torch.Tensor, kb: Optional[int]) -> int:
    """``kb`` as given, or, for ``None``, the tile ledger's for this call
    (the operand's own shape and the factor's rank, on ``u``'s device)."""
    if kb is None:
        kb = resolve_tiles(a.shape[0], a.shape[1], u.shape[1],
                           device=device_kind(u.device)).kb
    if kb not in KB_WIDTHS:
        raise ValueError(f"kb={kb}: the kernel is built for column chunks "
                         f"{KB_WIDTHS}")
    return kb


def chunks(k: int, kb: int) -> int:
    """Column chunks of a rank-k factor at chunk ``kb``: the grid's second
    dimension."""
    return -(-k // column_chunk(k, kb))


def scratch(a: BSR, k: int, kb: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The device's tickets and f32 scratch, grown to what a call on ``a``
    with rank ``k`` needs: ``(tickets, part, gram_part)``, ``part`` the
    (runs, 2, bm, k) partials of cut row-blocks and ``gram_part`` the
    fused kernel's (runs, k, k) Gram partials."""
    dev = a.device
    n_tickets = a.nrb * chunks(k, kb) + 1
    n_part = a.plan.runs * 2 * a.bm * k
    n_floats = n_part + a.plan.runs * k * k
    tickets, floats = _SCRATCH.get(dev, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
    if floats is None or floats.numel() < n_floats:
        floats = torch.empty(n_floats, dtype=torch.float32, device=dev)
    _SCRATCH[dev] = (tickets, floats)
    return tickets, floats[:n_part], floats[n_part:n_floats]


def stamps_ptr(a: BSR, stamps: Optional[torch.Tensor]) -> Optional[int]:
    """The address of a (runs, 2) int64 buffer on ``a``'s card for the
    blocks' start and end times, or None."""
    if stamps is None:
        return None
    if (stamps.dtype != torch.int64 or stamps.device != a.device
            or tuple(stamps.shape) != (a.plan.runs, 2)
            or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be a contiguous ({a.plan.runs}, 2) "
                         f"int64 tensor on {a.device}")
    return stamps.data_ptr()


def cost(a: BSR, u: torch.Tensor, gram_out: bool = False) -> tuple:
    """``(flops, bytes)`` of ``A @ U`` over the tiles ``a`` holds: its
    occupied tiles (``a.occupied``, counted at ingest and kept on
    ``meta``), 2 k FLOPs an entry of each; those tiles, the block columns
    of every slot and U read once, the product written once.  With
    ``gram_out`` (the fused kernel) also ``U^T U``: ``m k (k + 1)`` FLOPs
    over its distinct entries and the f32 k x k result written once."""
    k = u.shape[1]
    tiles = a.occupied
    flops = 2.0 * tiles * a.bm * a.bk * k
    nbytes = (tiles * a.bm * a.bk * a.tiles.element_size()
              + 4 * a.nrb * a.bcap
              + u.numel() * u.element_size()
              + a.shape[0] * k * u.element_size())
    if gram_out:
        flops += float(u.shape[0]) * k * (k + 1)
        nbytes += 4 * k * k
    return flops, float(nbytes)


def bsr_spmm(a: BSR, u: torch.Tensor, kb: Optional[int] = None,
             stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dense(A) @ U`` for BSR ``A`` (n x m) and dense ``U`` (m x k), in
    ``U``'s dtype (f32 accumulation).  ``kb`` is the column chunk (one of
    :data:`~repro_torch.kernels.autotune.KB_WIDTHS`); ``None`` resolves it
    through the tile ledger.  Given ``stamps`` (a (runs, 2) int64 tensor on
    the card), the kernel writes each block's start and end time there
    (ns, ``%globaltimer``)."""
    where = _build.on_card(a.tiles, a.block_cols, a.plan.bounds, u)
    if not where:
        return ref.bsr_spmm_ref(a, u)
    check_operands(a, u)
    if where is _build.META:
        y = torch.empty((a.shape[0], u.shape[1]), dtype=u.dtype,
                        device=u.device)
        record_kernel("bsr_spmm", *cost(a, u))
        return y
    kb = resolve_kb(a, u, kb)
    n, m = a.shape
    k = u.shape[1]
    y = torch.empty((n, k), dtype=u.dtype, device=u.device)
    tickets, part, _ = scratch(a, k, kb)
    rc = _lib().bsr_spmm_run(
        a.tiles.data_ptr(), a.block_cols.data_ptr(), u.data_ptr(),
        y.data_ptr(), part.data_ptr(), a.plan.bounds.data_ptr(),
        a.plan.rb_runs.data_ptr(), tickets.data_ptr(), stamps_ptr(a, stamps),
        n, m, k, a.nrb, a.bcap, a.bm, a.bk, a.plan.runs, kb,
        int(u.dtype == torch.bfloat16), _build.stream_ptr(u.device))
    _build.check_rc(rc, "bsr_spmm")
    _build.count_launch("bsr_spmm")
    return y


def bsr_spmm_t(a, u: torch.Tensor, kb: Optional[int] = None) -> torch.Tensor:
    """``dense(A)^T @ U`` via the transposed-format copy built at ingest;
    ``a`` is a :class:`BSROperand` or the transposed :class:`BSR` itself."""
    a_t = a.bsr_t if isinstance(a, BSROperand) else a
    return bsr_spmm(a_t, u, kb=kb)
