"""Krylov solvers on complex fields (port of mugiq_tpu.solvers cg and
cgne): the multigrid null-vector setup and the Schur solve use them.

The iteration runs on the host loop; with tol > 0 each step reads the
residual norm back to decide whether to stop, with tol = 0 (a fixed
number of steps, as the null-vector setup asks) nothing is read back.
A leading batch axis (batched=True) runs one independent CG per vector
with its own step sizes, as jax.vmap of the JAX solve does.
"""

from typing import Callable, NamedTuple

import torch


class SolveResult(NamedTuple):
    x: torch.Tensor
    resid: torch.Tensor      # final relative residual (per vector)
    iters: int


def _dot(a, b, batched):
    """<a, b>, per leading vector when batched."""
    if batched:
        return torch.sum(a.conj() * b, dim=tuple(range(1, a.ndim)))
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def cg(matvec: Callable, b: torch.Tensor, x0=None, tol: float = 1e-8,
       maxiter: int = 1000, batched: bool = False) -> SolveResult:
    """Conjugate gradients for a Hermitian positive-definite operator."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()

    def bc(s):
        return s.reshape(s.shape + (1,) * (b.ndim - s.ndim))

    b_norm = torch.sqrt(_dot(b, b, batched).real)
    r = b - matvec(x)
    p = r
    rs = _dot(r, r, batched)
    k = 0
    while k < maxiter:
        if tol > 0 and bool(torch.all(torch.sqrt(rs.real)
                                      <= tol * b_norm)):
            break
        ap = matvec(p)
        alpha = rs / _dot(p, ap, batched)
        x = x + bc(alpha) * p
        r = r - bc(alpha) * ap
        rs_new = _dot(r, r, batched)
        p = r + bc(rs_new / rs) * p
        rs = rs_new
        k += 1
    return SolveResult(x=x, resid=torch.sqrt(rs.real) / b_norm, iters=k)


def cgne(matvec_M: Callable, matvec_Mdag: Callable, b: torch.Tensor,
         x0=None, tol: float = 1e-8, maxiter: int = 1000) -> SolveResult:
    """M x = b through the normal equations M^dag M x = M^dag b."""
    return cg(lambda v: matvec_Mdag(matvec_M(v)), matvec_Mdag(b), x0=x0,
              tol=tol, maxiter=maxiter)
