"""Neighbour shifts, boundary phases and inner products on full-site
fields (port of mugiq_tpu.fields; the gauge factories are
io.gauge_io.load_gauge_np).

Fields keep the JAX layouts: spinors [..., T, Z, Y, X, 4, 3] and links
[4, T, Z, Y, X, 3, 3], complex64 or complex128.  Every lattice axis is
counted from the end, so a field may carry leading batch axes (the
eigenvector index, a Galerkin probe) and one shift serves spinors and
links alike.
"""

import torch

#: lattice direction mu (x, y, z, t) -> array axis of a [..., T, Z, Y, X,
#: a, b] field, counted from the end
MU_TO_AXIS = (-3, -4, -5, -6)


def shift(field: torch.Tensor, mu: int, sign: int) -> torch.Tensor:
    """field(x + sign*mu_hat) with periodic wrap (sign=+1 fetches the
    forward neighbour).  Fermion boundary phases live in the links
    (apply_boundary_phase), not here."""
    return torch.roll(field, -sign, dims=MU_TO_AXIS[mu])


def apply_boundary_phase(U: torch.Tensor,
                         antiperiodic_t: bool = True) -> torch.Tensor:
    """The links with the t-links of the last time slice times -1 for an
    antiperiodic fermion field (QUDA_ANTI_PERIODIC_T); the operator then
    uses plain periodic shifts."""
    if not antiperiodic_t:
        return U
    U = U.clone()
    U[3, -1] *= -1
    return U


def inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> = sum conj(a) b (QUDA blas::cDotProduct)."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def norm2(a: torch.Tensor) -> torch.Tensor:
    """||a||^2 (QUDA blas::norm2)."""
    return inner(a, a).real
