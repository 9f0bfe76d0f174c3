"""Block geometry of an MG level and the complex block transfer of the
API path (port of mugiq_tpu.mg.transfer).

Geometric blocks (bx, by, bz, bt) aggregate fine sites; the finest level
aggregates spin chirally (spin_block=2: fine spins {0,1} and {2,3} -> 2
coarse spins, preserving g5), coarser levels keep their 2 spins
(spin_block=1).  An aggregate has agg = block_vol * spin_block * nc_fine
components, flattened in the order (bt, bz, by, bx, spin-within-block,
colour).

Transfer holds the block-orthonormal basis V [Tc, Zc, Yc, Xc, ns_c, agg,
n_vec] of n_vec null vectors (one batched QR) and applies P and R as
batched [agg, n_vec] products over the blocks, a batch of fields as the
rows of each block's product (V is read once, not copied per vector).
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class BlockGeometry:
    fine_dims: Tuple[int, int, int, int]    # (X, Y, Z, T) extents
    block: Tuple[int, int, int, int]        # (bx, by, bz, bt)
    ns_fine: int
    nc_fine: int
    spin_block: int

    def __post_init__(self):
        for d, b in zip(self.fine_dims, self.block):
            if d % b:
                raise ValueError(f"block {self.block} must divide dims "
                                 f"{self.fine_dims}")
        if self.ns_fine % self.spin_block:
            raise ValueError(f"spin_block {self.spin_block} must divide "
                             f"ns {self.ns_fine}")

    @property
    def coarse_dims(self):
        return tuple(d // b for d, b in zip(self.fine_dims, self.block))

    @property
    def ns_coarse(self):
        return self.ns_fine // self.spin_block

    @property
    def block_vol(self):
        bx, by, bz, bt = self.block
        return bx * by * bz * bt

    @property
    def agg(self):
        return self.block_vol * self.spin_block * self.nc_fine


def block_edge_mask(g: BlockGeometry, mu: int, sign: int,
                    device="cuda") -> torch.Tensor:
    """[agg] 0/1 mask of aggregate components whose `sign*mu` neighbour
    lies in the adjacent block (fine coordinate at the block face)."""
    bx, by, bz, bt = g.block
    bdims = (bt, bz, by, bx)                 # order of agg flattening
    axis_of_mu = {0: 3, 1: 2, 2: 1, 3: 0}[mu]
    coords = np.indices(bdims)[axis_of_mu]
    edge = (coords == bdims[axis_of_mu] - 1) if sign > 0 else (coords == 0)
    full = np.broadcast_to(edge[..., None, None],
                           bdims + (g.spin_block, g.nc_fine))
    return torch.from_numpy(full.reshape(-1).astype(np.float32)).to(device)


def _block_agg(psi: torch.Tensor, g: BlockGeometry) -> torch.Tensor:
    """[..., T, Z, Y, X, ns, nc] -> [..., Tc, Zc, Yc, Xc, ns_c, agg], agg
    flattened as (bt, bz, by, bx, spin within block, colour)."""
    lead = psi.shape[:-6]
    T, Z, Y, X = psi.shape[-6:-2]
    bx, by, bz, bt = g.block
    r = psi.reshape(lead + (T // bt, bt, Z // bz, bz, Y // by, by, X // bx,
                            bx, g.ns_coarse, g.spin_block, g.nc_fine))
    b = len(lead)
    perm = tuple(range(b)) + tuple(b + i for i in
                                   (0, 2, 4, 6, 8, 1, 3, 5, 7, 9, 10))
    r = r.permute(perm)
    return r.reshape(r.shape[:b + 5] + (g.agg,))


def _unblock_agg(phi: torch.Tensor, g: BlockGeometry) -> torch.Tensor:
    """Inverse of _block_agg."""
    lead = phi.shape[:-6]
    Tc, Zc, Yc, Xc = phi.shape[-6:-2]
    bx, by, bz, bt = g.block
    r = phi.reshape(lead + (Tc, Zc, Yc, Xc, g.ns_coarse, bt, bz, by, bx,
                            g.spin_block, g.nc_fine))
    b = len(lead)
    perm = tuple(range(b)) + tuple(b + i for i in
                                   (0, 5, 1, 6, 2, 7, 3, 8, 4, 9, 10))
    return r.permute(perm).reshape(lead + (Tc * bt, Zc * bz, Yc * by,
                                           Xc * bx, g.ns_fine, g.nc_fine))


def apply_R(h: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """h [..., Tc, Zc, Yc, Xc, ns_c, agg] (blocked fields, any leading
    batch) times conj(V) [Tc, Zc, Yc, Xc, ns_c, agg, n_vec] per block:
    one batched product over the blocks, the batch as its rows (a
    broadcast matmul would copy V once per batch vector)."""
    return torch.einsum("...tzyxsa,tzyxsav->...tzyxsv", h, V.conj())


@dataclass
class Transfer:
    """Orthonormal block transfer P / R between a fine and a coarse level
    (QUDA's Transfer, mg_mugiq.h:40-53)."""
    geom: BlockGeometry
    V: torch.Tensor     # [Tc, Zc, Yc, Xc, ns_c, agg, n_vec]

    @classmethod
    def build(cls, null_vecs: torch.Tensor, block: Tuple[int, int, int, int],
              spin_block: int) -> "Transfer":
        """null_vecs [n_vec, T, Z, Y, X, ns, nc]: block-orthonormalised per
        (block, coarse spin) aggregate by one batched reduced QR."""
        n_vec = null_vecs.shape[0]
        T, Z, Y, X, ns, nc = null_vecs.shape[1:]
        g = BlockGeometry(fine_dims=(X, Y, Z, T), block=tuple(block),
                          ns_fine=ns, nc_fine=nc, spin_block=spin_block)
        if g.agg < n_vec:
            raise ValueError(f"aggregate size {g.agg} must be >= n_vec "
                             f"{n_vec}")
        Vraw = torch.movedim(_block_agg(null_vecs, g), 0, -1)
        q, _ = torch.linalg.qr(Vraw)
        return cls(geom=g, V=q)

    @property
    def coarse_field_shape(self):
        Xc, Yc, Zc, Tc = self.geom.coarse_dims
        return (Tc, Zc, Yc, Xc, self.geom.ns_coarse, self.V.shape[-1])

    def restrict(self, psi: torch.Tensor) -> torch.Tensor:
        """R psi: [..., T, Z, Y, X, ns, nc] -> [..., Tc, Zc, Yc, Xc, ns_c,
        n_vec]."""
        return apply_R(_block_agg(psi, self.geom), self.V)

    def restrict_masked(self, psi: torch.Tensor,
                        mask_agg: torch.Tensor) -> torch.Tensor:
        """R (mask * psi), mask over the aggregate components."""
        h = _block_agg(psi, self.geom) * mask_agg.to(psi.real.dtype)
        return apply_R(h, self.V)

    def prolong(self, phi: torch.Tensor) -> torch.Tensor:
        """P phi: [..., Tc, Zc, Yc, Xc, ns_c, n_vec] -> [..., T, Z, Y, X,
        ns, nc]."""
        h = torch.einsum("tzyxsav,...tzyxsv->...tzyxsa", self.V, phi)
        return _unblock_agg(h, self.geom)

    def probe_fine_vectors(self) -> torch.Tensor:
        """P of the coarse unit vectors e_{sigma, v} (1 at every coarse
        site), [ns_c * n_vec, T, Z, Y, X, ns, nc] in the order sigma *
        n_vec + v: the Galerkin probes."""
        ns_c, n_vec = self.geom.ns_coarse, self.V.shape[-1]
        e = torch.eye(ns_c * n_vec, dtype=self.V.dtype, device=self.V.device)
        e = e.reshape((ns_c * n_vec, 1, 1, 1, 1, ns_c, n_vec))
        return self.prolong(e.expand((ns_c * n_vec,)
                                     + self.coarse_field_shape))
