"""Projected ALS NMF (paper Algorithm 1) and the shared ALS engine (port of
``repro.core.nmf``).

The engine runs a fixed number of iterations and records the paper's
metrics per iteration: relative residual R, relative error E, NNZ of both
factors, the running max NNZ(U)+NNZ(V) (Fig. 6), and a health index (the
first iteration whose factors went non-finite or whose residual exploded).
Sparsity enforcement (Algorithm 2) is injected as ``sparsify_u`` /
``sparsify_v`` callables; identity recovers Algorithm 1.

The reference's ``lax.scan`` is a Python loop here that writes each
iteration's metrics into preallocated device tensors: nothing in the loop
reads a value back to the host, so the card is never made to wait on the
CPU inside a fit.  The products dispatch through the matmul-backend layer
(:mod:`repro_torch.backend`), whose reduction hooks are identity on one
device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core import metrics as M
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.bsr import BSROperand
from repro_torch.sparse.csr import SpCSR

Sparsifier = Callable[[torch.Tensor], torch.Tensor]
Matrix = Union[torch.Tensor, SpCSR, BSROperand]

__all__ = ["NMFResult", "init_u0", "als_nmf", "solve_gram"]


class NMFResult(NamedTuple):
    u: torch.Tensor          # (n, k)
    v: torch.Tensor          # (m, k)
    residual: torch.Tensor   # (iters,) R per iteration
    error: torch.Tensor      # (iters,) E per iteration
    max_nnz: torch.Tensor    # scalar — max NNZ(U)+NNZ(V) over the run
    nnz_u: torch.Tensor      # (iters,)
    nnz_v: torch.Tensor      # (iters,)
    health: torch.Tensor     # scalar int32: first unhealthy iteration, -1 ok


#: relative-residual ceiling of the health monitor: R sits in [0, O(1)] for
#: any sane trajectory, so crossing this means the factors are diverging
_RESIDUAL_BLOWUP = 1e6


def init_u0(generator: torch.Generator, n: int, k: int,
            nnz: Optional[int] = None, device: DeviceLike = None
            ) -> torch.Tensor:
    """Random non-negative initial guess, uniform in [0, 1), with ``nnz``
    nonzeros (paper Fig. 6 varies the initial-guess sparsity).  Drawn from
    a CPU ``generator`` so a seed gives the same guess on every device; the
    reference's ``jax.random`` stream cannot be reproduced, so parity
    checks pass both packages one explicit ``u0``."""
    u0 = torch.rand((n, k), generator=generator, dtype=torch.float32)
    u0 = u0.to(resolve_device(device))
    if nnz is not None and nnz < n * k:
        from repro_torch.core.topk import topk_project_exact

        u0 = topk_project_exact(u0, nnz)
    return u0


def solve_gram(gram: torch.Tensor, rhs: torch.Tensor,
               ridge: float = 1e-8) -> torch.Tensor:
    """Solve ``X @ gram = rhs`` for X via Cholesky with a scale-aware ridge
    (gram is k x k PSD, k small).  ``cholesky_ex`` does not check for
    failure on the host (``cholesky`` would sync); a failed factorization
    becomes NaN instead, which the engine's health monitor reports, as the
    reference's NaN factor does.  Returns a contiguous (m, k) tensor."""
    k = gram.shape[0]
    jitter = ridge * (torch.trace(gram) / k + 1e-30)
    g = gram + jitter * torch.eye(k, dtype=gram.dtype, device=gram.device)
    chol, info = torch.linalg.cholesky_ex(g)
    chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
    # gram is symmetric: solve gram @ X^T = rhs^T
    return torch.cholesky_solve(rhs.T, chol).T.contiguous()


def _resolve(a: Matrix, backend):
    """Backend for ``a``: a registry name, a backend instance, or ``None``
    for type-based selection."""
    if backend is not None and not isinstance(backend, str):
        return backend
    from repro_torch.backend import resolve_backend

    return resolve_backend(a, backend)


def _matmul_t(a: Matrix, u: torch.Tensor, backend=None) -> torch.Tensor:
    """A^T @ u through the backend layer."""
    return _resolve(a, backend).matmul_t(a, u)


def _matmul(a: Matrix, v: torch.Tensor, backend=None) -> torch.Tensor:
    """A @ v through the backend layer."""
    return _resolve(a, backend).matmul(a, v)


def _sqnorm(a: Matrix) -> torch.Tensor:
    """||A||_F^2 without densifying sparse operands."""
    if isinstance(a, (SpCSR, BSROperand)):
        return a.sqnorm()
    return torch.sum(a.float() ** 2)


def _bsr_relative_error(a: BSROperand, u: torch.Tensor, v: torch.Tensor,
                        a_sqnorm: torch.Tensor) -> torch.Tensor:
    """||A - UV^T||_F / ||A||_F with the cross term contracted tile-wise."""
    from repro_torch.kernels.bsr import bsr_dot_uv

    uf = u.float()
    vf = v.float()
    cross = bsr_dot_uv(a.bsr, u, v)
    approx_sq = torch.sum((uf.T @ uf) * (vf.T @ vf))
    err_sq = torch.clamp_min(a_sqnorm - 2.0 * cross + approx_sq, 0.0)
    return torch.sqrt(err_sq) / torch.sqrt(torch.clamp_min(a_sqnorm, 1e-30))


def _relative_error(a: Matrix, u: torch.Tensor, v: torch.Tensor,
                    a_sqnorm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """E = ||A - U V^T||_F / ||A||_F for any operand type."""
    if a_sqnorm is None:
        a_sqnorm = _sqnorm(a)
    if isinstance(a, BSROperand):
        return _bsr_relative_error(a, u, v, a_sqnorm)
    if isinstance(a, SpCSR):
        rows = torch.arange(a.n, device=a.device)[:, None].expand(
            a.cols.shape)
        return M.relative_error_sparse(
            a.values.reshape(-1), rows.reshape(-1), a.cols.reshape(-1).long(),
            a_sqnorm, u, v)
    return M.relative_error(a, u, v)


def _epilogue(x: torch.Tensor, sparsify: Optional[Sparsifier]
              ) -> torch.Tensor:
    """Non-negativity projection + sparsity enforcement; sparsifiers that
    declare ``fuses_relu`` own the relu too."""
    if sparsify is None:
        return torch.clamp_min(x, 0.0)
    if getattr(sparsify, "fuses_relu", False):
        return sparsify(x)
    return sparsify(torch.clamp_min(x, 0.0))


def als_nmf(
    a: Matrix,
    u0: torch.Tensor,
    iters: int = 75,
    sparsify_u: Optional[Sparsifier] = None,
    sparsify_v: Optional[Sparsifier] = None,
    track_error: bool = True,
    backend=None,
) -> NMFResult:
    """Projected ALS (Alg. 1) / Enforced Sparsity ALS (Alg. 2).

    One iteration:
      V = relu(A^T U (U^T U)^{-1});  V = sparsify_v(V)
      U = relu(A V (V^T V)^{-1});    U = sparsify_u(U)

    ``backend`` is a registered backend name, a backend instance, or
    ``None`` to select from the operand type.  Runs on ``u0``'s device.
    """
    be = _resolve(a, backend)
    n, k = u0.shape
    m = a.shape[1]
    dev = u0.device
    a_sqnorm = be.sqnorm(a)

    residual = torch.zeros(iters, dtype=torch.float32, device=dev)
    error = torch.zeros(iters, dtype=torch.float32, device=dev)
    nnz_u = torch.zeros(iters, dtype=torch.int32, device=dev)
    nnz_v = torch.zeros(iters, dtype=torch.int32, device=dev)
    health = torch.full((), -1, dtype=torch.int32, device=dev)
    max_nnz = be.reduce_u(torch.sum(u0 != 0)).to(torch.int32)

    u = u0
    v = torch.zeros((m, k), dtype=u0.dtype, device=dev)
    for it in range(iters):
        # each half-step's sparse product and Gram read the same factor, so
        # they come from one backend hook (one fused kernel on cuda-bsr)
        atu, gu = be.matmul_t_with_gram(a, u)
        v = _epilogue(solve_gram(be.reduce_u(gu), atu), sparsify_v)
        av, gv = be.matmul_with_gram(a, v)
        u_new = _epilogue(solve_gram(be.reduce_v(gv), av), sparsify_u)

        num = be.reduce_u(torch.sum(torch.square(u_new - u)))
        den = be.reduce_u(torch.sum(torch.square(u_new)))
        r = torch.sqrt(num) / torch.clamp_min(torch.sqrt(den), 1e-30)
        nu = be.reduce_u(torch.sum(u_new != 0)).to(torch.int32)
        nv = be.reduce_v(torch.sum(v != 0)).to(torch.int32)
        max_nnz = torch.maximum(max_nnz, nu + nv)

        # health monitor: first iteration with non-finite factors or an
        # exploding residual
        bad_u = be.reduce_u(torch.sum(~torch.isfinite(u_new)))
        bad_v = be.reduce_v(torch.sum(~torch.isfinite(v)))
        bad = ((bad_u + bad_v > 0) | ~torch.isfinite(r)
               | (r > _RESIDUAL_BLOWUP))
        health = torch.where((health < 0) & bad, it, health)

        residual[it] = r
        if track_error:
            error[it] = be.relative_error(a, u_new, v, a_sqnorm)
        nnz_u[it] = nu
        nnz_v[it] = nv
        u = u_new
    return NMFResult(u, v, residual, error, max_nnz, nnz_u, nnz_v, health)
