"""Krylov-Schur Arnoldi on real-pair fields, the production eigensolver of
the non-normal operators M and M^dag (port of
mugiq_tpu.eig.arnoldi_realpair.arnoldi_krylov_schur_realpair).

The device work (operator, CGS2 orthogonalisation, the restart rotation)
is the Lanczos cycle of lanczos.py recording the Hessenberg matrix
(krylov_cycle with hermitian=False), as the JAX function reuses
_make_cycle(..., hermitian=False); the m x m Hessenberg eig and the
sorted complex Schur form run on the host with numpy and scipy.
`reduce` sums the inner products of a sharded field over the ranks.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..lanczos import _rotate, _unitize, krylov_cycle, norm

#: ordering keys of the reference's spectrum menu (enum_mugiq.h:20-27)
_KEY = {"SR": lambda x: x.real, "LR": lambda x: -x.real,
        "SM": np.abs, "LM": lambda x: -np.abs(x),
        "SI": lambda x: x.imag, "LI": lambda x: -x.imag}


@dataclass
class ArnoldiRealpairResult:
    evals: np.ndarray          # complex
    evecs: torch.Tensor        # [n_ev, *field]
    resids: np.ndarray
    n_restarts: int
    converged: bool


def _select(evals, which):
    return np.argsort(_KEY[which](evals), kind="stable")


def arnoldi_krylov_schur_realpair(
    matvec: Callable,
    v0: torch.Tensor,
    n_ev: int,
    n_kr: int,
    re_im_axis: int = 0,
    tol: float = 1e-6,
    max_restarts: int = 200,
    which: str = "SM",
    check_interval: int = 1,
    reduce: Optional[Callable] = None,
) -> ArnoldiRealpairResult:
    """n_ev eigenpairs of a general (non-normal) operator on real-pair
    fields, selected by `which` (SR, LR, SM, LM, SI, LI), by Krylov-Schur
    restarted Arnoldi with basis V [n_kr+1, *field] in v0's dtype."""
    import scipy.linalg as sla

    if which not in _KEY:
        raise ValueError(f"spectrum '{which}' unsupported: one of "
                         f"{sorted(_KEY)}")
    shape = v0.shape
    ax = re_im_axis
    if shape[ax] % 2:
        raise ValueError(f"re_im_axis {ax} has odd extent {shape[ax]}")
    dev, rdtype = v0.device, v0.dtype
    m = n_kr
    k = min(n_ev + max(1, (m - n_ev) // 2), m - 2)
    key = _KEY[which]

    V = torch.zeros((m + 1,) + tuple(shape), dtype=rdtype, device=dev)
    V[0] = v0 / norm(v0, reduce)
    H = torch.zeros((m, m, 2), dtype=rdtype, device=dev)

    j0 = 0
    converged = False
    theta = y = sel = None
    beta = 0.0
    for restart in range(max_restarts):
        beta = float(krylov_cycle(matvec, V, H, j0, ax, reduce,
                                  hermitian=False))
        H2 = H.double().cpu().numpy()
        H_host = H2[..., 0] + 1j * H2[..., 1]
        theta, y = np.linalg.eig(H_host)
        sel = _select(theta, which)
        resid = np.abs(beta * y[m - 1, sel])
        if (restart + 1) % check_interval == 0 or restart == max_restarts - 1:
            if np.all(resid[:n_ev]
                      < tol * np.maximum(1.0, np.abs(theta[sel][:n_ev]))):
                converged = True
                break
        if restart == max_restarts - 1:
            break
        # Krylov-Schur restart: the k wanted Schur vectors, sorted to the
        # front, span the kept space; H = their Schur block plus the
        # residual coupling row beta * Q[m-1, :k]
        cutoff = np.sort(key(theta))[k - 1]
        T, Q, _ = sla.schur(H_host, output="complex",
                            sort=lambda x: bool(key(x) <= cutoff))
        Vk = _rotate(V[:m], torch.as_tensor(Q[:, :k].real, dtype=rdtype,
                                            device=dev),
                     torch.as_tensor(Q[:, :k].imag, dtype=rdtype,
                                     device=dev), ax)
        V[:k] = Vk
        del Vk
        V[k] = V[m]
        Hn = np.zeros((m, m), dtype=np.complex128)
        Hn[:k, :k] = T[:k, :k]
        Hn[k, :k] = beta * Q[m - 1, :k]
        H = torch.as_tensor(np.stack([Hn.real, Hn.imag], -1), dtype=rdtype,
                            device=dev)
        j0 = k

    sel_np = sel[:n_ev]
    Ys = y[:, sel_np]
    evecs = _unitize(_rotate(
        V[:m], torch.as_tensor(Ys.real, dtype=rdtype, device=dev),
        torch.as_tensor(Ys.imag, dtype=rdtype, device=dev), ax), reduce)
    del V, H
    return ArnoldiRealpairResult(
        evals=theta[sel_np],
        evecs=evecs,
        resids=np.abs(beta * y[m - 1, sel_np]),
        n_restarts=restart + 1,
        converged=converged,
    )
