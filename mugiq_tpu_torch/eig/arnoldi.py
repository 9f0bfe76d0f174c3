"""Krylov-Schur (restarted Arnoldi) eigensolver for the non-normal M and
M^dag on complex fields (port of mugiq_tpu.eig.arnoldi).

The Arnoldi factorisation extends on the device (lanczos._cycle without
the Hermitian mirror); the m x m Hessenberg eig and the sorted complex
Schur form that contracts the factorisation to the wanted subspace run on
the host with numpy and scipy, as in the JAX function.
"""

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .lanczos import _cycle, vnorm

_KEY = {"SR": lambda x: x.real, "LR": lambda x: -x.real,
        "SM": np.abs, "LM": lambda x: -np.abs(x),
        "SI": lambda x: x.imag, "LI": lambda x: -x.imag}


@dataclass
class ArnoldiResult:
    evals: np.ndarray        # complex Ritz values, wanted end first
    evecs: torch.Tensor      # [n_ev, *shape]
    resids: np.ndarray
    n_restarts: int
    converged: bool


def _select(evals: np.ndarray, which: str) -> np.ndarray:
    """Indices sorted so that the wanted end comes first."""
    return np.argsort(_KEY[which](evals), kind="stable")


def arnoldi_krylov_schur(
    matvec: Callable,
    v0: torch.Tensor,
    n_ev: int,
    n_kr: int,
    tol: float = 1e-8,
    max_restarts: int = 200,
    which: str = "SM",
    check_interval: int = 1,
) -> ArnoldiResult:
    """n_ev eigenpairs at the `which` end (SR, LR, SM, LM, SI, LI) of a
    general operator on complex fields shaped like v0."""
    import scipy.linalg as sla

    shape = tuple(v0.shape)
    dtype, dev = v0.dtype, v0.device
    n = v0.numel()
    m = n_kr
    if not n_ev < m <= n:
        raise ValueError(f"need n_ev < n_kr <= field size: {n_ev}, {m}, {n}")
    k = min(n_ev + max(1, (m - n_ev) // 2), m - 2)

    def matvec_flat(w):
        return matvec(w.reshape(shape)).reshape(-1)

    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
    v0f = v0.reshape(-1)
    V[0] = v0f / vnorm(v0f)
    H = torch.zeros((m, m), dtype=dtype, device=dev)

    j0 = 0
    converged = False
    key = _KEY[which]
    for restart in range(max_restarts):
        beta = _cycle(matvec_flat, V, H, j0, hermitian=False)
        H_host = H.cpu().numpy().astype(np.complex128)
        theta, y = np.linalg.eig(H_host)
        sel = _select(theta, which)
        resid = np.abs(beta * y[m - 1, sel])
        if (restart + 1) % check_interval == 0 or restart == max_restarts - 1:
            if np.all(resid[:n_ev] < tol * np.maximum(
                    1.0, np.abs(theta[sel][:n_ev]))):
                converged = True
                break
        if restart == max_restarts - 1:
            break
        # ordered Schur form, wanted Ritz values leading (scipy has no
        # ordschur: a cutoff on the selection key; ties may grow the
        # block, and any leading k columns of a Schur form span a nested
        # invariant subspace)
        cutoff = np.sort(key(theta))[k - 1]
        T, Q, _ = sla.schur(H_host, output="complex",
                            sort=lambda x: bool(key(x) <= cutoff))
        Qk = torch.as_tensor(Q[:, :k], dtype=dtype, device=dev)
        V[:k] = Qk.T @ V[:m]
        V[k] = V[m]
        Hn = np.zeros((m, m), dtype=np.complex128)
        Hn[:k, :k] = T[:k, :k]
        Hn[k, :k] = beta * Q[m - 1, :k]
        H = torch.as_tensor(Hn, dtype=dtype, device=dev)
        j0 = k

    Y = torch.as_tensor(y[:, sel[:n_ev]], dtype=dtype, device=dev)
    evecs = Y.T @ V[:m]
    evecs = evecs / vnorm(evecs, dim=1, keepdim=True)
    return ArnoldiResult(
        evals=theta[sel[:n_ev]],
        evecs=evecs.reshape((n_ev,) + shape),
        resids=np.abs(beta * y[m - 1, sel[:n_ev]]),
        n_restarts=restart + 1,
        converged=converged,
    )
