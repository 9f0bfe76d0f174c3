"""Galerkin coarse operator of the API path on complex fields (port of
mugiq_tpu.mg.coarse): a nearest-neighbour stencil with dense links,

    (D_c phi)(X) = D[X] phi(X) + sum_mu [ Yp[mu][X] phi(X+mu)
                                        + Ym[mu][X] phi(X-mu) ]

built as D_c = R A P term by term: each directed hop of the fine
operator applied to the probes P e_{sigma,v}, restricted, split by the
block-face masks into the diagonal and the hopping links.  The fine
operator only needs diag_term / hop_term, which StencilOperator has too,
so coarsening recurses for 3 and 4 levels.
"""

from dataclasses import dataclass
from typing import Callable, List

import torch

from ..params import EigOperator
from .transfer import Transfer, block_edge_mask

#: coarse direction mu -> axis of a [..., Tc, Zc, Yc, Xc, n] field and of
#: a [Tc, Zc, Yc, Xc, n, n] link, counted from the end
_FIELD_AXIS = (-2, -3, -4, -5)
_LINK_AXIS = (-3, -4, -5, -6)


def _ct(link):
    return link.transpose(-1, -2).conj()


def _apply(link, f):
    """link [..., n, n] times f [..., n, 1] per site, as an elementwise
    product and sum (not one n x n GEMV per site)."""
    return (link * f.transpose(-1, -2)).sum(-1, keepdim=True)


@dataclass
class StencilOperator:
    """Nearest-neighbour operator with dense links on [..., T, Z, Y, X, ns,
    nc] fields."""
    D: torch.Tensor              # [T, Z, Y, X, n, n], n = ns * nc
    Yp: List[torch.Tensor]       # 4 x [T, Z, Y, X, n, n]: couples phi(X+mu)
    Ym: List[torch.Tensor]       # 4 x [T, Z, Y, X, n, n]: couples phi(X-mu)
    ns: int
    nc: int

    @property
    def field_shape(self):
        return tuple(self.D.shape[:4]) + (self.ns, self.nc)

    @property
    def dtype(self):
        return self.D.dtype

    def _flat(self, phi):
        return phi.reshape(phi.shape[:-2] + (self.ns * self.nc, 1))

    def _unflat(self, f):
        return f.reshape(f.shape[:-2] + (self.ns, self.nc))

    def M(self, phi):
        f = self._flat(phi)
        out = _apply(self.D, f)
        for mu in range(4):
            ax = _FIELD_AXIS[mu] - 1
            out = out + _apply(self.Yp[mu], torch.roll(f, -1, dims=ax))
            out = out + _apply(self.Ym[mu], torch.roll(f, +1, dims=ax))
        return self._unflat(out)

    def Mdag(self, phi):
        """(D^dag phi)(X) = D[X]^H phi(X) + sum_mu Ym[mu][X+mu]^H phi(X+mu)
        + Yp[mu][X-mu]^H phi(X-mu)."""
        f = self._flat(phi)
        out = _apply(_ct(self.D), f)
        for mu in range(4):
            ax, lax_ = _FIELD_AXIS[mu] - 1, _LINK_AXIS[mu]
            out = out + _apply(_ct(torch.roll(self.Ym[mu], -1, dims=lax_)),
                               torch.roll(f, -1, dims=ax))
            out = out + _apply(_ct(torch.roll(self.Yp[mu], +1, dims=lax_)),
                               torch.roll(f, +1, dims=ax))
        return self._unflat(out)

    def MdagM(self, phi):
        return self.Mdag(self.M(phi))

    def MMdag(self, phi):
        return self.M(self.Mdag(phi))

    def operator(self, which: EigOperator) -> Callable:
        return {EigOperator.M: self.M, EigOperator.Mdag: self.Mdag,
                EigOperator.MdagM: self.MdagM,
                EigOperator.MMdag: self.MMdag}[which]

    # -- term-wise interface for recursive Galerkin coarsening --

    def diag_term(self, phi):
        return self._unflat(_apply(self.D, self._flat(phi)))

    def hop_term(self, mu: int, sign: int, phi):
        link = self.Yp[mu] if sign > 0 else self.Ym[mu]
        f = torch.roll(self._flat(phi), -sign, dims=_FIELD_AXIS[mu] - 1)
        return self._unflat(_apply(link, f))


def galerkin_coarse_operator(fine_op, transfer: Transfer) -> StencilOperator:
    """R A P of a fine operator with diag_term / hop_term, materialised
    by probing."""
    g = transfer.geom
    ns_c, n_vec = g.ns_coarse, transfer.V.shape[-1]
    n = ns_c * n_vec
    dev = transfer.V.device
    probes = transfer.probe_fine_vectors()      # [n, T, Z, Y, X, ns, nc]

    def restrict_cols(fields, mask=None):
        """[n_col, fine] -> link matrices [Tc, Zc, Yc, Xc, n_row, n_col],
        the row dof sigma * n_vec + v (the probes' order)."""
        r = (transfer.restrict(fields) if mask is None
             else transfer.restrict_masked(fields, mask))
        r = torch.movedim(r, 0, -1)              # [..., ns_c, n_vec, n_col]
        return r.reshape(r.shape[:4] + (n, n))

    dia = restrict_cols(fine_op.diag_term(probes))
    Yp, Ym = [], []
    for mu in range(4):
        h_fwd = fine_op.hop_term(mu, +1, probes)
        h_bwd = fine_op.hop_term(mu, -1, probes)
        mask_fwd = block_edge_mask(g, mu, +1, device=dev)
        mask_bwd = block_edge_mask(g, mu, -1, device=dev)
        Yp.append(restrict_cols(h_fwd, mask_fwd))
        Ym.append(restrict_cols(h_bwd, mask_bwd))
        dia = dia + restrict_cols(h_fwd, 1.0 - mask_fwd) \
            + restrict_cols(h_bwd, 1.0 - mask_bwd)
    return StencilOperator(D=dia, Yp=Yp, Ym=Ym, ns=ns_c, nc=n_vec)
