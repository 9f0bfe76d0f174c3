"""Krylov solvers (port of mugiq_tpu.solvers cg, cgne and cg_realpair):
the multigrid null-vector setup, the Schur solve and the API stochastic
trace run cg on complex fields; the production stochastic trace runs
cg_realpair on real kernel-layout fields.

The iteration runs on the host loop; with tol > 0 each step reads the
residual norm back to decide whether to stop, with tol = 0 (a fixed
number of steps, as the null-vector setup asks) nothing is read back.
A leading batch axis (batched=True) runs one independent CG per vector
with its own step sizes, as jax.vmap of the JAX solve does.
"""

from typing import Callable, NamedTuple, Optional

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


def cg_realpair(matvec: Callable, b: torch.Tensor, x0=None, tol: float = 1e-8,
                maxiter: int = 1000,
                reduce: Optional[Callable] = None) -> SolveResult:
    """CG for a Hermitian positive-definite operator on real-pair fields
    (the kernel layout, real and imaginary parts in separate rows): every
    CG scalar of an HPD system is real, so plain real dots over the whole
    array suffice.  reduce: the sum over ranks of a sharded field (the
    sharded operator's mesh.all_reduce), applied to every dot.  The
    iteration reads one scalar back to the host per step (the residual
    norm of its stopping test); the scalars stay on the device."""
    red = reduce or (lambda v: v)

    def dot(a, c):
        return red(torch.sum(a * c))

    x = torch.zeros_like(b) if x0 is None else x0.clone()
    b_norm = float(torch.sqrt(dot(b, b)))
    r = b - matvec(x) if x0 is not None else b.clone()
    p = r.clone()
    rs = dot(r, r)
    k = 0
    while k < maxiter and float(torch.sqrt(rs)) > tol * b_norm:
        ap = matvec(p)
        alpha = rs / dot(p, ap)
        x.add_(alpha * p)
        r.sub_(alpha * ap)
        rs_new = dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        k += 1
    return SolveResult(x=x, resid=torch.sqrt(rs) / b_norm, iters=k)
