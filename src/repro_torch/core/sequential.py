"""Sequential ALS NMF, paper Algorithm 3 (port of
``repro.core.sequential``).

Topics converge one block (typically one column) at a time.  With the
converged topics in U1 (n, k) / V1 (m, k), zero-padded to full width, the
block update rules (paper Eqs. 4.7/4.8) are:

    V2 = relu( (A^T U2 - V1 (U1^T U2)) (U2^T U2)^{-1} );  top-t_v
    U2 = relu( (A V2 - U1 (V1^T V2)) (V2^T V2)^{-1} );    top-t_u

Block width 1 makes the inverse a scalar division (the paper's Fig. 9 speed
win); any width ``k2`` runs the same code.  The reference's two nested
``lax.scan`` loops are Python loops here that write each pass's residual
into a preallocated device tensor: nothing reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import metrics as M
from repro_torch.core import topk
from repro_torch.core.nmf import (
    Matrix, _matmul, _matmul_t, _relative_error, _sqnorm, solve_gram,
)

__all__ = ["SequentialResult", "sequential_als_nmf"]


class SequentialResult(NamedTuple):
    u: torch.Tensor          # (n, k)
    v: torch.Tensor          # (m, k)
    residual: torch.Tensor   # (blocks, iters)
    error: torch.Tensor      # (blocks,) error once each block converged
    max_nnz: torch.Tensor    # 0-d int32


def sequential_als_nmf(
    a: Matrix,
    u0: torch.Tensor,
    k2: int = 1,
    blocks: int = 5,
    iters: int = 20,
    t_u: Optional[int] = None,
    t_v: Optional[int] = None,
    track_error: bool = True,
    backend: Optional[str] = None,
    total_blocks: Optional[int] = None,
    carry_u: Optional[torch.Tensor] = None,
    carry_v: Optional[torch.Tensor] = None,
    start_block: int = 0,
) -> SequentialResult:
    """Converge ``blocks`` topic blocks of width ``k2``, each from the
    initial guess ``u0`` (n, k2).  For a checkpointing solver
    ``total_blocks`` fixes the full width ``k2 * total_blocks``,
    ``carry_u`` / ``carry_v`` resume the zero-padded converged factors of
    earlier blocks and ``start_block`` offsets the block indices this call
    converges; each block update reads only ``(a, u0, U1, V1)``, so a
    resumed group is the computation one long run would make."""
    n, m = a.shape
    k = k2 * (blocks if total_blocks is None else total_blocks)
    dtype, dev = u0.dtype, u0.device
    a_sqnorm = _sqnorm(a)

    def sp_u(x):
        return topk.topk_project_bisect(x, t_u) if t_u is not None else x

    def sp_v(x):
        return topk.topk_project_bisect(x, t_v) if t_v is not None else x

    u1 = (torch.zeros((n, k), dtype=dtype, device=dev) if carry_u is None
          else carry_u.clone())
    v1 = (torch.zeros((m, k), dtype=dtype, device=dev) if carry_v is None
          else carry_v.clone())
    residual = torch.zeros((blocks, iters), dtype=torch.float32, device=dev)
    error = torch.zeros(blocks, dtype=torch.float32, device=dev)
    max_nnz = torch.sum(u0 != 0).to(torch.int32)
    for b in range(blocks):
        u2 = u0
        v2 = torch.zeros((m, k2), dtype=dtype, device=dev)
        nnz1 = torch.sum(u1 != 0) + torch.sum(v1 != 0)
        for it in range(iters):
            rhs_v = _matmul_t(a, u2, backend) - v1 @ (u1.T @ u2)
            v2 = sp_v(torch.clamp_min(solve_gram(u2.T @ u2, rhs_v), 0.0))
            rhs_u = _matmul(a, v2, backend) - u1 @ (v1.T @ v2)
            u2_new = sp_u(torch.clamp_min(solve_gram(v2.T @ v2, rhs_u), 0.0))
            residual[b, it] = M.relative_residual(u2_new, u2)
            max_nnz = torch.maximum(
                max_nnz, (nnz1 + torch.sum(u2_new != 0)
                          + torch.sum(v2 != 0)).to(torch.int32))
            u2 = u2_new
        # the converged block goes into columns [blk*k2, (blk+1)*k2)
        lo = (start_block + b) * k2
        u1[:, lo:lo + k2] = u2
        v1[:, lo:lo + k2] = v2
        if track_error:
            error[b] = _relative_error(a, u1, v1, a_sqnorm)
    return SequentialResult(u1, v1, residual, error, max_nnz)
