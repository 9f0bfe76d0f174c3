"""Wilson / Wilson-clover Dirac operators M, M^dag, M^dag M, M M^dag on
complex full-site fields (port of mugiq_tpu.dirac).

    Wilson:        M = 1 - kappa D_hop
    Wilson-clover: M = A - kappa D_hop

in QUDA's kappa normalisation, DeGrand-Rossi basis, with the
antiperiodic time boundary folded into the links.  The operators take
spinors [..., T, Z, Y, X, 4, 3] with any leading batch axes.
"""

from typing import Callable, Optional

import torch

from .clover import apply_clover, clover_field
from .fields import apply_boundary_phase
from .ops.dslash import _hop_term, dslash_hop, g5, hop_links
from .params import DslashType, EigOperator, GaugeParam, InvertParam


class WilsonDirac(torch.nn.Module):
    """Wilson(-clover) operator; U the phased links [4, T, Z, Y, X, 3, 3],
    A the clover matrix of clover.clover_field (None: plain Wilson).  The
    eight directed links of the hop (ops.dslash.hop_links) are kept."""

    def __init__(self, U: torch.Tensor, kappa: float,
                 A: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("U", U)
        self.register_buffer("A", A)
        self.register_buffer("links", hop_links(U))
        self.kappa = kappa

    def M(self, psi):
        return self.diag_term(psi) - self.kappa * dslash_hop(
            self.U, psi, self.links)

    # -- term-wise interface (the multigrid Galerkin probing) --

    def diag_term(self, psi):
        """Site-diagonal part of M: 1 (Wilson) or the clover A."""
        return psi if self.A is None else apply_clover(self.A, psi)

    def hop_term(self, mu: int, sign: int, psi):
        """Directed hop of M, -kappa included: sign=+1 -kappa (1-g_mu)
        U_mu(x) psi(x+mu); sign=-1 -kappa (1+g_mu) U_mu^dag(x-mu)
        psi(x-mu)."""
        return -self.kappa * _hop_term(self.U[mu], psi, mu,
                                       forward=sign > 0)

    def Mdag(self, psi):
        """M^dag = g5 M g5 (g5-hermiticity of Wilson-clover)."""
        return g5(self.M(g5(psi)))

    def MdagM(self, psi):
        return self.Mdag(self.M(psi))

    def MMdag(self, psi):
        return self.M(self.Mdag(psi))

    def operator(self, which: EigOperator) -> Callable:
        return {EigOperator.M: self.M, EigOperator.Mdag: self.Mdag,
                EigOperator.MdagM: self.MdagM,
                EigOperator.MMdag: self.MMdag}[which]

    @property
    def field_shape(self):
        return tuple(self.U.shape[1:5]) + (4, 3)

    @property
    def dtype(self):
        return self.U.dtype


def make_dirac(U_unphased: torch.Tensor, gauge: GaugeParam,
               inv: InvertParam) -> WilsonDirac:
    """The operator of an unphased gauge field: boundary phase, spatial
    links / anisotropy xi (kappa = 1/(2(1 + 3/xi + m)),
    tests/eigensolve.cpp:144-151) and, for clover, A from the phased
    links.  Computes in U's dtype on U's device."""
    U = apply_boundary_phase(U_unphased, gauge.antiperiodic_t)
    if gauge.anisotropy != 1.0:
        scale = torch.tensor([1.0 / gauge.anisotropy] * 3 + [1.0],
                             dtype=U.real.dtype, device=U.device)
        U = U * scale.reshape(4, 1, 1, 1, 1, 1, 1)
    A = None
    if inv.dslash_type == DslashType.CLOVER_WILSON:
        if gauge.anisotropy != 1.0:
            raise NotImplementedError("anisotropic clover not supported")
        A = clover_field(U, inv.kappa, inv.csw)
    return WilsonDirac(U, inv.kappa, A)


def dense_matrix(op: Callable, field_shape, dtype,
                 device="cuda") -> torch.Tensor:
    """op as a dense matrix, column i = op(e_i) (tests; small lattices)."""
    n = 1
    for d in field_shape:
        n *= int(d)
    eye = torch.eye(n, dtype=dtype, device=device)
    return op(eye.reshape((n,) + tuple(field_shape))).reshape(n, n).T
