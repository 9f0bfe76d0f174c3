"""Block geometry of an MG level (port of mugiq_tpu.mg.transfer
BlockGeometry and block_edge_mask).

Geometric blocks (bx, by, bz, bt) aggregate fine sites; the finest level
aggregates spin chirally (spin_block=2: fine spins {0,1} and {2,3} -> 2
coarse spins, preserving g5), coarser levels keep their 2 spins
(spin_block=1).  An aggregate has agg = block_vol * spin_block * nc_fine
components, flattened in the order (bt, bz, by, bx, spin-within-block,
colour).
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
