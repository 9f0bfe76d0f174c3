"""Loop-slot bookkeeping and the API path's loop measurement (port of
mugiq_tpu.loop): for the ultra-local slot and each displacement length,
the 16-gamma trace of the eigenvectors with their covariantly displaced
copies, then the g5 output remap and the momentum projection
(computeCoarseLoop + performMomentumProjection,
lib/loop_mugiq.cpp:440-525, 322-434)."""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from .lattice import LatticeGeometry
from .params import CalcType, LoopParam, parse_disp_entry

N_GAMMA = 16


@dataclass
class LoopComputeParam:
    """Derived bookkeeping (mirrors LoopComputeParam, loop_mugiq.h:141-271):
    slot 0 is the ultra-local loop, then one slot per displacement length
    of each entry."""
    geom: LatticeGeometry
    n_mom: int
    disp_entries: List[Tuple[str, int, int]] = field(default_factory=list)
    n_loop_per_entry: List[int] = field(default_factory=list)
    n_loop_offset: List[int] = field(default_factory=list)
    n_loop: int = 1
    n_data: int = N_GAMMA

    @classmethod
    def build(cls, geom: LatticeGeometry, lp: LoopParam):
        if lp.calc_type != CalcType.OPT_KERNEL:
            raise ValueError(
                f"loop calc_type {lp.calc_type.name} is not implemented "
                "(the reference supports only OPT_KERNEL)")
        entries = ([parse_disp_entry(e) for e in lp.disp_entries]
                   if lp.do_nonlocal else [])
        per = [stop - start + 1 for (_, start, stop) in entries]
        offs = []
        acc = 1
        for p in per:
            offs.append(acc)
            acc += p
        return cls(geom=geom, n_mom=len(list(lp.momenta)),
                   disp_entries=entries, n_loop_per_entry=per,
                   n_loop_offset=offs, n_loop=acc, n_data=acc * N_GAMMA)

    def slot_labels(self) -> List[str]:
        """HDF5 disp-group label per loop slot ('disp_0', 'disp_+z_1', ...;
        loop_mugiq.cpp:598-609)."""
        labels = ["disp_0"]
        for (dstr, start, stop) in self.disp_entries:
            for idisp in range(start, stop + 1):
                labels.append(f"disp_{dstr}_{idisp}")
        return labels


@dataclass
class LoopResult:
    data_pos: torch.Tensor           # [nLoop, 16, T, Z, Y, X] traces T(G)
    data_mom: Optional[np.ndarray]   # [Nmom, nLoop, 16, T] after g5 map+FT
    cparam: LoopComputeParam
    momenta: List[Tuple[int, int, int]]


class LoopComputer:
    """The loop measurement of a set of fine-level complex eigenvectors.
    U_disp: the unphased gauge of the covariant displacements (the
    smeared 'loop gauge'), required when loop_param.do_nonlocal."""

    def __init__(self, geom: LatticeGeometry, loop_param: LoopParam,
                 U_disp: Optional[torch.Tensor] = None):
        self.geom = geom
        self.lp = loop_param
        self.cparam = LoopComputeParam.build(geom, loop_param)
        self.U_disp = U_disp
        if loop_param.do_nonlocal and U_disp is None:
            raise ValueError("do_nonlocal requires a displacement gauge "
                             "field")

    def compute(self, evecs: torch.Tensor, sigma) -> LoopResult:
        """evecs [nEv, T, Z, Y, X, 4, 3]; sigma [nEv] singular values (the
        trace is weighted by 1/sigma)."""
        from .displace import covariant_displace
        from .ops.contract import loop_contract

        cp = self.cparam
        inv_sigma = torch.as_tensor(1.0 / np.asarray(sigma),
                                    device=evecs.device)
        slots = [loop_contract(evecs, evecs, inv_sigma)]
        for dstr, start, stop in cp.disp_entries:
            vR = evecs
            for idisp in range(1, stop + 1):
                vR = covariant_displace(self.U_disp, vR, dstr)
                if idisp >= start:
                    slots.append(loop_contract(evecs, vR, inv_sigma))
        data_pos = torch.stack(slots)
        data_mom = (self.momentum_projection(data_pos)
                    if self.lp.do_mom_proj else None)
        return LoopResult(data_pos=data_pos, data_mom=data_mom, cparam=cp,
                          momenta=[tuple(m) for m in self.lp.momenta])

    def momentum_projection(self, data_pos: torch.Tensor) -> np.ndarray:
        """g5 remap + spatial Fourier projection, as host [Nmom, nLoop, 16,
        T] (the index order of the reference's dataMom_bcast,
        loop_mugiq.cpp:415-418)."""
        from .phase import map_gamma_g5, momentum_project, phase_matrix

        ph = phase_matrix(self.geom, self.lp.momenta, int(self.lp.ft_sign),
                          data_pos.dtype, data_pos.device)
        lgtp = momentum_project(map_gamma_g5(data_pos), ph)
        return lgtp.permute(3, 0, 1, 2).cpu().numpy()
