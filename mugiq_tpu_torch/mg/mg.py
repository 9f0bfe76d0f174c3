"""Multigrid environment of the API path — the MG_Mugiq analog (port of
mugiq_tpu.mg.mg): null vectors -> Transfer -> Galerkin coarse operator,
recursively for 2-4 levels (mg_mugiq.h:40-53), and the recursive
prolongation of coarse eigenvectors (prolongateEvec,
lib/loop_mugiq.cpp:276-319)."""

from dataclasses import dataclass
from typing import List

import torch

from ..params import MGParam
from ..utils import log, phase_timer
from .coarse import galerkin_coarse_operator
from .setup import setup_null_vectors
from .transfer import Transfer


@dataclass
class MGEnv:
    """level_ops[0] is the fine Dirac operator, level_ops[-1] the coarsest
    StencilOperator; transfers[l] maps level l + 1 to level l."""
    level_ops: List[object]
    transfers: List[Transfer]
    params: MGParam

    @classmethod
    def build(cls, fine_dirac, params: MGParam) -> "MGEnv":
        n_coarse = params.n_level - 1
        if len(params.geo_block_size) < n_coarse:
            raise ValueError("need a geo_block_size per coarse level")
        if len(params.n_vec) < n_coarse:
            raise ValueError("need an n_vec per coarse level")
        level_ops = [fine_dirac]
        transfers = []
        dev = fine_dirac.U.device
        for lev in range(n_coarse):
            op = level_ops[-1]
            fshape = op.field_shape
            spin_block = 2 if fshape[4] == 4 else 1
            with phase_timer(f"mg-null-vectors-l{lev}"):
                B = setup_null_vectors(
                    op.MdagM, fshape, op.dtype, params.n_vec[lev],
                    iters=params.setup_iters, seed=params.setup_seed + lev,
                    device=dev)
            with phase_timer(f"mg-transfer-l{lev}"):
                tr = Transfer.build(B, params.geo_block_size[lev],
                                    spin_block)
            with phase_timer(f"mg-galerkin-l{lev}"):
                coarse = galerkin_coarse_operator(op, tr)
            log(f"MGEnv: level {lev + 1} built — coarse dims "
                f"{tr.geom.coarse_dims}, ns={coarse.ns}, nc={coarse.nc}")
            transfers.append(tr)
            level_ops.append(coarse)
        return cls(level_ops=level_ops, transfers=transfers, params=params)

    @property
    def coarsest_op(self):
        return self.level_ops[-1]

    @property
    def n_coarse_levels(self):
        return len(self.transfers)

    def prolongate(self, phi: torch.Tensor) -> torch.Tensor:
        """Coarsest-level field(s) -> fine (the Transfer::P chain); leading
        batch axes allowed."""
        for tr in reversed(self.transfers):
            phi = tr.prolong(phi)
        return phi

    def restrict(self, psi: torch.Tensor) -> torch.Tensor:
        """Fine field(s) -> coarsest level (the Transfer::R chain)."""
        for tr in self.transfers:
            psi = tr.restrict(psi)
        return psi
