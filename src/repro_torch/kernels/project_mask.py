"""The relu + top-t epilogue on the card, in one CUDA launch (port of
``repro.kernels.project_mask`` and of the bisection around it in
``repro.core.topk.FusedReluTopK``).

Replaces the Pallas TPU kernel
``repro/kernels/project_mask.py::_project_mask_kernel`` (launched by
``_project_mask_impl``): ``y = max(x, 0); out = where(y >= tau, y, 0)``.
On the TPU, XLA fused the 40-step bisection that finds ``tau`` into the ALS
scan around that kernel; run eagerly it is ~290 launches per epilogue.  So
the CUDA C++ kernel in ``csrc/project_mask.cu`` (built for ``sm_90a``,
called through ``ctypes``) does both: one thread-block cluster (or, for a
factor beyond its shared memory, one block per SM) holds the factor on chip,
counts it at each round's midpoints and exchanges the integer counts
(through distributed shared memory, or global memory across the grid), then
writes the mask and ``tau`` (design notes in the source).  One template, two
functions:

* :func:`relu_topk` — ``FusedReluTopK``'s whole function, ``(out, tau)``,
  bitwise ``kernels.ref.relu_topk_ref`` on f32 and bf16 input (bf16 is
  widened as it is read, bisected in f32, ``tau`` rounded to bf16);
* :func:`project_mask` — the TPU kernel's own function, ``tau`` given.

For CPU tensors each runs its plain version; for CUDA tensors it launches
or raises.  Neither synchronises with the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, ref

__all__ = ["relu_topk", "project_mask", "relu_topk_plan", "STEPS_PER_ROUND"]

#: bisection steps one count round of :func:`relu_topk` resolves (the
#: kernel's ``kSteps``: 2^3 - 1 midpoints counted a round, 15 barriers for
#: 40 steps)
STEPS_PER_ROUND = 3
#: counts a block publishes per round: the midpoints and the incoming hi
_COUNTS = 2 ** STEPS_PER_ROUND
#: the slice a block owns is an ``int`` in the kernel
_MAX_NUMEL = 2 ** 31 - 1

#: per CUDA device: the grid exchange's scratch (int32; its first two words,
#: the barrier's arrivals and exit tickets, are 0 between calls)
_SYNC: Dict[torch.device, torch.Tensor] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("project_mask")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.relu_topk_f32, lib.relu_topk_bf16):
        fn.argtypes = [p, p, p, p, ll, ll, ll, i, p]
        fn.restype = i
    for fn in (lib.project_mask_f32, lib.project_mask_bf16):
        fn.argtypes = [p, p, p, ll, p]
        fn.restype = i
    lib.relu_topk_plan.argtypes = [ll, p]
    lib.relu_topk_plan.restype = i
    return lib


def _sync(dev: torch.device) -> torch.Tensor:
    """The grid exchange's scratch on ``dev``: two counters and two rounds
    of counts for one block per SM; created zeroed at the first call."""
    buf = _SYNC.get(dev)
    if buf is None:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        buf = _SYNC[dev] = torch.zeros(2 + 2 * n_sm * _COUNTS,
                                       dtype=torch.int32, device=dev)
    return buf


def _check(x: torch.Tensor, name: str) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() > _MAX_NUMEL:
        raise ValueError(f"{name} takes at most {_MAX_NUMEL} elements, got "
                         f"{x.numel()}")


def relu_topk(x: torch.Tensor, t: int, num_steps: int = 40
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, tau)``: ``tau`` the ``num_steps``-step bisection threshold of
    ``relu(x)`` for a budget of ``t`` entries (a 0-d tensor on ``x``'s
    device) and ``out = where(relu(x) >= tau, relu(x), 0)``, both in ``x``'s
    dtype (f32 or bf16; a bf16 ``x`` is bisected in f32 and ``tau`` rounded
    to bf16 at the end, as the reference does).  The kernel picks how many
    blocks share ``x`` from ``x.numel()`` (:func:`relu_topk_plan`)."""
    if not _build.on_card(x):
        return ref.relu_topk_ref(x, t, num_steps)
    _check(x, "relu_topk")
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    if x.numel() == 0:
        raise ValueError("relu_topk needs a non-empty x")
    lib = _lib()
    out = torch.empty_like(x)
    tau = torch.empty((), dtype=x.dtype, device=x.device)
    sync = _sync(x.device)
    fn = lib.relu_topk_bf16 if x.dtype == torch.bfloat16 else lib.relu_topk_f32
    rc = fn(x.data_ptr(), out.data_ptr(), tau.data_ptr(), sync.data_ptr(),
            sync.numel(), x.numel(), int(t), int(num_steps),
            _build.stream_ptr(x.device))
    _build.check_rc(rc, "relu_topk")
    _build.count_launch("relu_topk")
    return out, tau


def project_mask(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """relu + threshold mask of a factor; ``tau`` is a 0-d f32 (or, for a
    bf16 ``x``, bf16) tensor on ``x``'s device, cast to ``x``'s dtype before
    the comparison as the reference casts it."""
    if not _build.on_card(x, tau):
        return ref.project_mask_ref(x, tau)
    _check(x, "project_mask")
    if tau.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"tau must be float32 or {x.dtype}, got {tau.dtype}")
    if tau.numel() != 1:
        raise ValueError(f"tau must hold one value, got {tuple(tau.shape)}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib()
    fn = (lib.project_mask_bf16 if x.dtype == torch.bfloat16
          else lib.project_mask_f32)
    tau = tau.float()  # the kernel reads f32 (bf16 widens exactly)
    rc = fn(x.data_ptr(), tau.data_ptr(), out.data_ptr(), x.numel(),
            _build.stream_ptr(x.device))
    _build.check_rc(rc, "project_mask")
    _build.count_launch("project_mask")
    return out


def relu_topk_plan(numel: int) -> Dict[str, object]:
    """How :func:`relu_topk` runs ``numel`` floats on the current card: the
    blocks that share the factor and how they exchange their counts
    (``"cluster"``: one thread-block cluster, through distributed shared
    memory; ``"grid"``: one block per SM, through global memory), the slice
    each block owns, how much of it stays in shared memory, and so the path
    (``"resident"``, or ``"streamed"`` when part of every slice is re-read
    from global memory each round)."""
    plan = (ctypes.c_int * 5)()
    rc = _lib().relu_topk_plan(int(numel), ctypes.addressof(plan))
    _build.check_rc(rc, "relu_topk_plan")
    blocks, grid, slice_, resident, smem = plan
    return dict(blocks=blocks, exchange="grid" if grid else "cluster",
                slice=slice_, resident=resident, smem_bytes=smem,
                path="resident" if resident >= slice_ else "streamed")
