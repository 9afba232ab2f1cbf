"""Causal online-softmax attention with grouped KV heads on the card (port
of ``repro.kernels.flash_attention``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
_flash_kernel`` (launched by ``flash_attention``) with two CUDA C++ kernels
in ``csrc/flash_attention.cu``, built for ``sm_90a`` and called through
``ctypes``.  The work is bound by operations (0.275 TFLOP at the llama3.2-1b
prefill shape).  bf16, the model's type, runs on the tensor cores: wgmma for
Q K^T and P V, TMA copies of Q, K and V from a producer warp into a
two-stage ring.  f32 runs on the CUDA cores in IEEE f32 (tensor-core f32
would be TF32).  The design notes are in the source.  For CPU tensors the
wrapper runs the plain version (``kernels.ref.flash_attention_ref``); for
CUDA tensors it launches a kernel or raises; for meta tensors it returns an
empty output and records the launch and its :func:`cost`.  The kernels have
no backward (the reference has none either), so the wrapper refuses
operands that need a gradient.

The kernels read q, k and v through their strides, so the model hands them
the transposed views of its (B, S, H, hd) projections without a copy, and
the output is allocated as (B, Sq, H, hd) and returned as its (B, H, Sq, hd)
view: the model's transpose back is free.  TMA takes such views as they are
if each base pointer is 16-byte aligned and every stride but the last is a
multiple of 16 bytes; the wrapper refuses bf16 operands that are not.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.scan import record_kernel

__all__ = ["flash_attention", "check_operands", "cost", "HEAD_DIMS"]

#: head sizes the kernel is built for (112, zamba2-7b's, on 128's layout)
HEAD_DIMS = (16, 32, 64, 112, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [i, i, p, p, p, p, i, i, i, i, i, i,
                                        ctypes.c_float,
                                        ctypes.POINTER(ctypes.c_longlong), p,
                                        p]
    lib.flash_attention_fwd.restype = i
    return lib


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   groups: int) -> None:
    """What the kernels take: q (B, H, Sq, hd), k and v (B, Hkv, T, hd)
    with ``H == groups * Hkv`` and T >= 1, one dtype (float32 or bfloat16),
    ``hd`` in :data:`HEAD_DIMS`, the last axis contiguous; in bfloat16 (the
    TMA copies) each base pointer 16-byte aligned and every other stride a
    multiple of 16 bytes."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Sq, hd) and k, v (B, Hkv, T, hd),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[2] < 1:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if groups < 1 or h != groups * k.shape[1]:
        raise ValueError(f"H={h} is not groups={groups} x Hkv={k.shape[1]}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} is not one the kernel is built for"
                         f" {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along its last "
                             "axis")
        if x.dtype != torch.bfloat16:
            continue
        if x.data_ptr() % 16:
            raise ValueError(f"{name}'s base pointer is not 16-byte aligned,"
                             " which the TMA copies need")
        nbytes = [st * x.element_size() for st in x.stride()[:3]]
        if any(st % 16 for st in nbytes):
            raise ValueError(f"{name}'s batch, head and row strides "
                             f"{nbytes} bytes are not all multiples of 16, "
                             "which the TMA copies need")


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         causal: bool = True, lse: bool = False) -> tuple:
    """``(flops, bytes)`` of the attention function: 4 hd FLOPs (Q K^T and
    P V, a multiply-add each) for every (row, key) pair the mask keeps
    (row i keeps keys 0..min(i, T - 1) when causal: S (S + 1) / 2 pairs at
    S = T), every head; q, k, v read once and the output written once
    (and with ``lse`` the (B, H, Sq) f32 log-sum-exp)."""
    b, h, sq, hd = q.shape
    t = k.shape[2]
    if causal:
        m = min(sq, t)
        pairs = m * (m + 1) // 2 + (sq - m) * t
    else:
        pairs = sq * t
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    if lse:
        nbytes += 4 * b * h * sq
    return 4.0 * b * h * hd * pairs, float(nbytes)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, groups: int = 1, lse: bool = False):
    """Attention of q (B, H, Sq, hd) over k, v (B, Hkv, T, hd); query head
    h reads KV head ``h // groups``.  Returns (B, H, Sq, hd) in q's dtype;
    with ``lse`` also each row's log-sum-exp of its scaled scores, (B, H,
    Sq) in f32 (natural log; -inf for a row with no kept key), so that
    launches over slices of the keys merge exactly.  Without ``lse`` the
    output and the launch are as they were before it existed."""
    where = _build.on_card(q, k, v)
    if where is _build.META:
        check_operands(q, k, v, groups)
        b, h, sq, hd = q.shape
        out = torch.empty((b, sq, h, hd), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        record_kernel("flash_attention", *cost(q, k, v, causal, lse))
        if lse:
            return out, torch.empty((b, h, sq), dtype=torch.float32,
                                    device=q.device)
        return out
    if not where:
        return ref.flash_attention_ref(q, k, v, causal=causal, groups=groups,
                                       lse=lse)
    check_operands(q, k, v, groups)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError("the flash kernel has no backward; run "
                                  "it under torch.no_grad()")
    b, h, sq, hd = q.shape
    t = k.shape[2]
    out = torch.empty((b, sq, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    rows = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
            if lse else None)
    if out.numel() == 0:
        return (out, rows) if lse else out
    strides = (ctypes.c_longlong * 12)(*(
        s for x in (q, k, v, out) for s in x.stride()[:3]))
    rc = _lib().flash_attention_fwd(
        _DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, h, sq, t, groups, int(causal), hd ** -0.5,
        strides, _build.stream_ptr(q.device),
        None if rows is None else rows.data_ptr())
    _build.check_rc(rc, "flash_attention")
    _build.count_launch("flash_attention")
    return (out, rows) if lse else out
