"""Clover (Sheikholeslami-Wohlert) term on complex full-site fields
(port of mugiq_tpu.clover).

    F_mu_nu = (Q_mu_nu - Q_mu_nu^dag) / (8 i),  Q the four clover leaves
    A = 1 + (csw kappa / 2) sum_{mu<nu} sigma_mu_nu F_mu_nu

F and A are built once per gauge by the host code the kernel path uses
(clover_np, complex128) and moved to the links' device and dtype; A is a
dense [T, Z, Y, X, 4, 3, 4, 3] site matrix.
"""

import numpy as np
import torch

from .clover_np import clover_field_np, field_strength_plane_np


def _host(U: torch.Tensor) -> np.ndarray:
    return U.detach().cpu().numpy()


def field_strength(U: torch.Tensor) -> torch.Tensor:
    """F[mu, nu, T, Z, Y, X, 3, 3], Hermitian in colour, antisymmetric in
    (mu, nu), from the (phased) links."""
    u = _host(U)
    F = np.zeros((4, 4) + u.shape[1:], dtype=np.complex128)
    for mu in range(4):
        for nu in range(mu + 1, 4):
            F[mu, nu] = field_strength_plane_np(u, mu, nu)
            F[nu, mu] = -F[mu, nu]
    return torch.as_tensor(F).to(U.device, U.dtype)


def clover_field(U: torch.Tensor, kappa: float, csw: float) -> torch.Tensor:
    """A[T, Z, Y, X, 4, 3, 4, 3] from the (phased) links."""
    return torch.as_tensor(clover_field_np(_host(U), kappa, csw)).to(
        U.device, U.dtype)


def apply_clover(A: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """A(x) psi(x), the dense 12x12 site matrix; psi may carry leading
    batch axes.  An elementwise product and sum, not a 12x12 GEMV per
    site."""
    sh = A.shape[:4]
    out = (A.reshape(sh + (12, 12))
           * psi.reshape(psi.shape[:-2] + (1, 12))).sum(-1)
    return out.reshape(psi.shape)


def clover_inverse(A: torch.Tensor) -> torch.Tensor:
    """The site-wise inverse of A (for the even-odd Schur complement)."""
    sh = A.shape[:4]
    return torch.linalg.inv(A.reshape(sh + (12, 12))).reshape(A.shape)
