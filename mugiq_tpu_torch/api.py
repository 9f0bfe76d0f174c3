"""Public interface — the mugiq.h / interface_mugiq.cpp analog (port of
mugiq_tpu.api), on complex full-site fields in complex64 or complex128.

* compute_evecs_mugiq     <-> computeEvecsMuGiq (fine operator)
* compute_evecs_mugiq_mg  <-> computeEvecsMuGiq_MG (MG coarse operator)
* compute_loop            <-> computeLoop<Float>

Each takes the unphased gauge U [4, T, Z, Y, X, 3, 3] (numpy or torch),
`dtype` (torch.complex64, the CLIs' --prec single, or torch.complex128,
--prec double) and `device` (the card unless the caller asks for the
CPU).  The operators are plain PyTorch: no TPU kernel reaches this path
in the JAX package either (its XLA stencil, ops/dslash.py).
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .dirac import WilsonDirac, make_dirac
from .eig.eigsolve import Eigensolver, EigsolveOutput
from .lattice import LatticeGeometry
from .loop import LoopComputer, LoopResult
from .params import EigParam, GaugeParam, InvertParam, LoopParam, MGParam
from .utils import log, phase_timer, resolve_device

DTYPES = (torch.complex64, torch.complex128)


@dataclass
class EigsolveResult:
    output: EigsolveOutput
    dirac: WilsonDirac
    geom: LatticeGeometry
    mg_env: Optional[object] = None   # MGEnv when the coarse path ran

    @property
    def evecs(self):
        return self.output.evecs

    @property
    def evals(self):
        return self.output.evals

    @property
    def sigma(self):
        return self.output.sigma

    def print_evals(self):
        """printEvals analog (lib/eigsolve_mugiq.cpp:317-335)."""
        if not self.output.converged:
            log(f"WARNING: eigensolver did NOT converge to tolerance in "
                f"{self.output.n_restarts} restarts; residuals below are "
                f"as-is (raise n_kr / max_restarts)")
        for i, (lam, r) in enumerate(zip(self.output.evals,
                                         self.output.resids)):
            log(f"Mugiq: Eval[{i:04d}] = {lam.real:+.16e} {lam.imag:+.16e} , "
                f"Residual = {r:+.16e}")
        if self.output.sigma is not None:
            for i, s in enumerate(self.output.sigma):
                log(f"Mugiq: Sigma[{i:04d}] = {s:+.16e}")


def _dirac(U, gauge: GaugeParam, inv: InvertParam, dtype, device):
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be torch.complex64 or "
                         f"torch.complex128, not {dtype}")
    dev = resolve_device(device)
    return make_dirac(torch.as_tensor(U).to(dev, dtype), gauge, inv), dev


def compute_evecs_mugiq(U, gauge: GaugeParam, inv: InvertParam,
                        eig: EigParam, even_odd: bool = False,
                        dtype=torch.complex64,
                        device="cuda") -> EigsolveResult:
    """Eigenpairs of the fine Dirac matrix (computeEvecsMuGiq,
    lib/interface_mugiq.cpp:122-156).  even_odd=True eigensolves the
    even-even Schur-preconditioned operator (the pc_solve path,
    lib/eigsolve_mugiq.cpp:169-181); its eigenvectors live on the even
    sites of the full-layout field."""
    dirac, dev = _dirac(U, gauge, inv, dtype, device)
    op_src, v0_transform = dirac, None
    if even_odd:
        from .schur import SchurDirac
        op_src = SchurDirac.from_dirac(dirac)
        v0_transform = op_src.project_even
    with phase_timer("eigensolve"):
        out = Eigensolver(op_src.operator(eig.operator), op_src.field_shape,
                          dtype, eig, inv, v0_transform=v0_transform,
                          device=dev).solve()
    return EigsolveResult(output=out, dirac=dirac,
                          geom=LatticeGeometry(gauge.dims))


def compute_evecs_mugiq_mg(U, gauge: GaugeParam, inv: InvertParam,
                           eig: EigParam, mg: MGParam,
                           dtype=torch.complex64,
                           device="cuda") -> EigsolveResult:
    """Eigenpairs of the MG coarse operator (computeEvecsMuGiq_MG,
    lib/interface_mugiq.cpp:79-118)."""
    from .mg.mg import MGEnv

    dirac, dev = _dirac(U, gauge, inv, dtype, device)
    with phase_timer("mg-setup"):
        mg_env = MGEnv.build(dirac, mg)
    coarse = mg_env.coarsest_op
    with phase_timer("eigensolve"):
        out = Eigensolver(coarse.operator(eig.operator), coarse.field_shape,
                          dtype, eig, inv, device=dev).solve()
    return EigsolveResult(output=out, dirac=dirac,
                          geom=LatticeGeometry(gauge.dims), mg_env=mg_env)


def compute_loop(U, gauge: GaugeParam, inv: InvertParam, eig: EigParam,
                 loop_param: LoopParam, compute_coarse: bool = False,
                 use_mg: bool = False, mg: Optional[MGParam] = None,
                 U_loop=None, dtype=torch.complex64,
                 device="cuda") -> Tuple[LoopResult, EigsolveResult]:
    """Disconnected loops with (MG-deflated) eigenvectors (computeLoop,
    lib/interface_mugiq.cpp:175-248): the fine or MG-coarse eigensolve,
    the coarse eigenvectors prolongated, the loop measurement and the
    momentum- and position-space HDF5 (both g5-mapped).  U_loop: the
    separate (smeared) gauge of the displacements (tests/loop.cpp:901-918),
    default the unphased U."""
    if use_mg and compute_coarse:
        if mg is None:
            raise ValueError("use_mg requires MGParam")
        eig_res = compute_evecs_mugiq_mg(U, gauge, inv, eig, mg, dtype,
                                         device)
        with phase_timer("prolongate"):
            fine_evecs = eig_res.mg_env.prolongate(eig_res.evecs)
    else:
        eig_res = compute_evecs_mugiq(U, gauge, inv, eig, dtype=dtype,
                                      device=device)
        fine_evecs = eig_res.evecs

    if eig_res.sigma is None:
        raise ValueError("loop measurement requires the normal-operator "
                         "sigma weights (eig.operator MdagM/MMdag)")

    U_disp = torch.as_tensor(U if U_loop is None else U_loop).to(
        fine_evecs.device, dtype)
    computer = LoopComputer(eig_res.geom, loop_param, U_disp=U_disp)
    with phase_timer("loop-contraction"):
        result = computer.compute(fine_evecs, eig_res.sigma)

    if loop_param.do_mom_proj and (loop_param.write_mom_space_hdf5
                                   or loop_param.fname_mom_h5):
        fname = loop_param.fname_mom_h5
        if not fname:
            raise ValueError("write_mom_space_hdf5 set but fname_mom_h5 "
                             "empty")
        from .io.hdf5io import write_loops_hdf5_mom
        write_loops_hdf5_mom(fname, result.data_mom, result.momenta,
                             result.cparam.slot_labels())
        log(f"compute_loop: momentum-space loop data written to {fname}")
    if loop_param.write_pos_space_hdf5:
        fname = loop_param.fname_pos_h5
        if not fname:
            raise ValueError("write_pos_space_hdf5 set but fname_pos_h5 "
                             "empty")
        from .io.hdf5io import write_loops_hdf5_pos
        from .phase import map_gamma_g5
        write_loops_hdf5_pos(fname, map_gamma_g5(result.data_pos).cpu()
                             .numpy(), result.cparam.slot_labels())
        log(f"compute_loop: position-space loop data written to {fname}")
    return result, eig_res
