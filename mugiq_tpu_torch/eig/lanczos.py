"""Chebyshev acceleration, spectral-edge estimate and the complex
thick-restart Lanczos of the API path (port of mugiq_tpu.eig.lanczos).

lanczos_hermitian keeps the JAX algorithm step for step: the basis
V [n_kr+1, n] in the start vector's complex dtype, CGS2 full
reorthogonalisation, the projected Hermitian matrix filled column by
column (thick restarts make it arrow-shaped), thick restart to
k = min(n_ev + max(1, (m - n_ev)//2), m - 2) Ritz vectors, and the same
convergence test.  The projected matrix is eigh'd on the host in
complex128, as the port's production Lanczos does.
"""

from typing import Callable, Optional

import numpy as np
import torch

from ..lanczos import LanczosResult, norm


def estimate_spectral_edge(matvec: Callable, v0: torch.Tensor,
                           iters: int = 25,
                           reduce: Optional[Callable] = None) -> float:
    """Upper spectral edge of a Hermitian PSD operator by power iteration,
    padded by 10% (auto a_max for Chebyshev acceleration), on real-pair
    or complex fields.  reduce: the
    sum over ranks for a sharded field (lanczos_hermitian_realpair)."""
    v = v0 / norm(v0, reduce)
    for _ in range(iters):
        w = matvec(v)
        v = w / norm(w, reduce)
    dot = torch.sum(v.conj() * matvec(v)).real
    return float(dot if reduce is None else reduce(dot)) * 1.10


def chebyshev_op(matvec: Callable, poly_deg: int, a_min: float,
                 a_max: float) -> Callable:
    """p(A): the degree-poly_deg Chebyshev polynomial of A mapped so that
    [a_min, a_max] -> [-1, 1]; eigenvalues below a_min grow exponentially
    in poly_deg and become the largest of p(A) (QUDA's poly_deg / a_min /
    a_max, include/eigsolve_mugiq.h:27-30).  The chain keeps the input's
    dtype: its Python-float scalars keep a bf16 field (a vector of a bf16
    Krylov basis) bf16, as JAX's weak-typed scalars do, and it takes a
    leading batch axis when the operator does."""
    d = 0.5 * (a_max - a_min)
    c = 0.5 * (a_max + a_min)

    def scaled(v):
        return (matvec(v) - c * v) / d

    def apply(v):
        if poly_deg == 0:
            return matvec(v)
        tkm1, tk = v, scaled(v)
        for _ in range(1, poly_deg):
            tkm1, tk = tk, 2.0 * scaled(tk) - tkm1
        return tk

    return apply


def vnorm(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The 2-norm of a complex field in the field's real dtype.  On the
    CPU it is summed in float64: a complex64 norm of 10^5 terms through
    the CPU's reduction is off by ~3e-6 relative, which a Rayleigh
    quotient of the normalised vector inherits twice.  The card's
    reduction needs no upcast."""
    dt = torch.complex128 if x.device.type == "cpu" else None
    return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim,
                                    dtype=dt).to(x.real.dtype)


def _cycle(matvec: Callable, V: torch.Tensor, Tmat: torch.Tensor, j0: int,
           hermitian: bool = True) -> float:
    """Extend the Lanczos (hermitian) or Arnoldi factorisation from row j0
    to m = Tmat.shape[0]: V[j+1] the normalised CGS2 residual of
    matvec(V[j]), column j of Tmat the projections (mirrored into row j
    when hermitian), beta on the subdiagonal.  Returns beta_m."""
    m = Tmat.shape[0]
    beta = torch.zeros((), dtype=V.real.dtype, device=V.device)
    for j in range(j0, m):
        w = matvec(V[j])
        Vp = V[:j + 1]
        d = Vp.conj() @ w
        w = w - d @ Vp
        d2 = Vp.conj() @ w
        w = w - d2 @ Vp
        col = d + d2
        Tmat[:j + 1, j] = col
        if hermitian:
            Tmat[j, :j + 1] = col.conj()
        beta = vnorm(w)
        V[j + 1] = w / torch.clamp(beta, min=torch.finfo(w.real.dtype).tiny)
        if j + 1 < m:
            Tmat[j + 1, j] = beta
            if hermitian:
                Tmat[j, j + 1] = beta
    return float(beta)


def lanczos_hermitian(
    matvec: Callable,
    v0: torch.Tensor,
    n_ev: int,
    n_kr: int,
    tol: float = 1e-8,
    max_restarts: int = 100,
    which: str = "SR",
    check_interval: int = 1,
    n_keep: Optional[int] = None,
) -> LanczosResult:
    """n_ev extremal eigenpairs ("SR" smallest, "LR" largest) of a
    Hermitian operator on complex fields shaped like v0 (matvec takes and
    returns that shape)."""
    if which not in ("SR", "LR"):
        raise ValueError(f"spectrum {which}: only SR/LR supported by "
                         "Lanczos")
    shape = tuple(v0.shape)
    dtype, dev = v0.dtype, v0.device
    n = v0.numel()
    m = n_kr
    if not n_ev < m <= n:
        raise ValueError(f"need n_ev < n_kr <= field size: {n_ev}, {m}, {n}")
    k = max(n_keep or min(n_ev + max(1, (m - n_ev) // 2), m - 2), n_ev)

    def matvec_flat(w):
        return matvec(w.reshape(shape)).reshape(-1)

    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
    v0f = v0.reshape(-1)
    V[0] = v0f / vnorm(v0f)
    Tmat = torch.zeros((m, m), dtype=dtype, device=dev)

    j0 = 0
    converged = False
    sel = (np.arange(k) if which == "SR"
           else np.arange(m - 1, m - 1 - k, -1))
    for restart in range(max_restarts):
        beta_m = _cycle(matvec_flat, V, Tmat, j0)
        # the lower triangle, as eigh reads it
        theta, q = np.linalg.eigh(Tmat.cpu().numpy().astype(np.complex128))
        if (restart + 1) % check_interval == 0 or restart == max_restarts - 1:
            resid = np.abs(beta_m * q[m - 1, sel[:n_ev]])
            if np.all(resid < tol * np.maximum(1.0,
                                               np.abs(theta[sel[:n_ev]]))):
                converged = True
                break
        if restart == max_restarts - 1:
            break     # theta, q stay consistent with the unrotated V
        Q = torch.as_tensor(q[:, sel], dtype=dtype, device=dev)
        V[:k] = Q.T @ V[:m]
        V[k] = V[m]
        Tmat.zero_()
        idx = torch.arange(k, device=dev)
        Tmat[idx, idx] = torch.as_tensor(theta[sel], dtype=dtype, device=dev)
        j0 = k

    Q = torch.as_tensor(q[:, sel[:n_ev]], dtype=dtype, device=dev)
    evecs = Q.T @ V[:m]
    evecs = evecs / vnorm(evecs, dim=1, keepdim=True)
    return LanczosResult(
        evals=theta[sel[:n_ev]],
        evecs=evecs.reshape((n_ev,) + shape),
        resids=np.abs(beta_m * q[m - 1, sel[:n_ev]]),
        n_restarts=restart + 1,
        converged=converged,
    )
