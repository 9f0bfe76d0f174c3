"""Even-odd (Schur-complement) preconditioned Dirac operator on complex
full-site fields (port of mugiq_tpu.schur).

With M in parity blocks [[A_ee, -kappa D_eo], [-kappa D_oe, A_oo]], the
even-even Schur complements are

    asymmetric: M_pc = A_ee - kappa^2 D_eo A_oo^-1 D_oe
    symmetric:  M_pc = 1 - kappa^2 A_ee^-1 D_eo A_oo^-1 D_oe

(A = 1 for Wilson).  Fields stay in the full layout with the odd sites
zero: the parity masks are elementwise products.
"""

from typing import Callable, Optional

import numpy as np
import torch

from .clover import apply_clover, clover_inverse
from .ops.dslash import dslash_hop, g5, hop_links
from .params import EigOperator


def parity_masks(shape_tzyx, dtype, device="cuda"):
    """(even, odd) 0/1 masks of shape [T, Z, Y, X, 1, 1]; a site's parity
    is (x + y + z + t) % 2."""
    par = np.indices(tuple(shape_tzyx)).sum(axis=0) % 2
    even = torch.as_tensor((1 - par)[..., None, None], dtype=dtype,
                           device=device)
    return even, 1.0 - even


class SchurDirac:
    """Even-even preconditioned Wilson(-clover) operator on full-layout
    fields supported on even sites (the odd part of an input is
    ignored); `symmetric` selects QUDA_MATPC_EVEN_EVEN, else
    asymmetric."""

    def __init__(self, U: torch.Tensor, kappa: float,
                 A: Optional[torch.Tensor] = None,
                 Ainv: Optional[torch.Tensor] = None,
                 symmetric: bool = False,
                 links: Optional[torch.Tensor] = None):
        self.U, self.kappa, self.A, self.symmetric = U, kappa, A, symmetric
        self.Ainv = (clover_inverse(A) if A is not None and Ainv is None
                     else Ainv)
        self.even, self.odd = parity_masks(U.shape[1:5], U.real.dtype,
                                           U.device)
        # the eight directed links (ops.dslash.hop_links); from_dirac
        # shares the WilsonDirac's
        self.links = hop_links(U) if links is None else links

    @classmethod
    def from_dirac(cls, dirac, symmetric: bool = False) -> "SchurDirac":
        return cls(dirac.U, dirac.kappa, dirac.A, symmetric=symmetric,
                   links=dirac.links)

    def _hop(self, psi):
        return dslash_hop(self.U, psi, self.links)

    @property
    def field_shape(self):
        return tuple(self.U.shape[1:5]) + (4, 3)

    @property
    def dtype(self):
        return self.U.dtype

    def project_even(self, psi):
        return self.even * psi

    def _apply_A(self, psi):
        return psi if self.A is None else apply_clover(self.A, psi)

    def _apply_Ainv(self, psi):
        return psi if self.A is None else apply_clover(self.Ainv, psi)

    def M(self, psi):
        pe = self.even * psi
        d_oe = self.odd * self._hop(pe)
        hop_back = self.even * self._hop(self._apply_Ainv(d_oe))
        if self.symmetric:
            return pe - self.kappa ** 2 * self._apply_Ainv(hop_back)
        return self._apply_A(pe) - self.kappa ** 2 * hop_back

    def Mdag(self, psi):
        if self.symmetric and self.A is not None:
            # symmetric clover pc is not g5-hermitian (A_ee^-1 on the
            # left): (1 - k^2 Ainv_e D Ainv_o D)^dag built term by term
            pe = self.even * psi
            w = self.even * self._apply_Ainv(pe)
            d_oe = self.odd * g5(self._hop(g5(w)))
            w = self._apply_Ainv(d_oe)
            w = self.even * g5(self._hop(g5(w)))
            return pe - self.kappa ** 2 * w
        return g5(self.M(g5(psi)))

    def MdagM(self, psi):
        return self.Mdag(self.M(psi))

    def MMdag(self, psi):
        return self.M(self.Mdag(psi))

    def operator(self, which: EigOperator) -> Callable:
        return {EigOperator.M: self.M, EigOperator.Mdag: self.Mdag,
                EigOperator.MdagM: self.MdagM,
                EigOperator.MMdag: self.MMdag}[which]

    def solve_full(self, full_dirac, b, tol=1e-10, maxiter=2000):
        """M_full x = b through the Schur complement: x_e from CG on the
        pc normal equations, then x_o = A_oo^-1 (b_o + kappa D_oe x_e)."""
        from .solvers import cg

        be = self.even * b
        bo = self.odd * b
        rhs = be + self.kappa * (self.even * self._hop(
            self._apply_Ainv(bo)))
        if self.symmetric:
            rhs = self._apply_Ainv(rhs)
        res = cg(self.MdagM, self.Mdag(rhs), tol=tol, maxiter=maxiter)
        xe = self.even * res.x
        xo = self._apply_Ainv(bo + self.kappa
                              * (self.odd * self._hop(xe)))
        return xe + xo
