"""The single-device production loop on a CUDA device (port of
mugiq_tpu.production: build_kernel_dirac, build_packed_schur,
compute_evecs_production, compute_loop_production,
_measure_production_kernel, _measure_tail).

Eigensolve of MdagM (or MMdag) of the full operator, or of the packed
even-odd preconditioned one, with thick-restart Lanczos, optionally
Chebyshev-filtered and then Rayleigh-Ritz refined; the computeEvals tail;
the measurement on the kernel layout (K2 contraction, K3 displacement
chains); the g5 map, momentum-projection GEMM and HDF5 output.  The
MG-deflated loop (use_mg=True, _compute_loop_production_mg) eigensolves
the Galerkin coarse operator of an MG hierarchy (mg/) and prolongates its
eigenvectors to the fine lattice before the same measurement.  Complex
setup (gauge phases, clover) stays in numpy on the host.

Options outside this slice raise NotImplementedError naming the ROADMAP
item that ports them.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .dirac_kernel import WilsonDiracKernel
from .io.hdf5io import write_loops_hdf5_mom
from .kernels.contract import covariant_displace, gamma_project, loop_contract
from .lanczos import lanczos_hermitian_realpair, rayleigh_ritz_refine
from .lattice import LatticeGeometry
from .layout import kernel_gauge_np
from .schur_kernel import SchurDiracKernelPacked
from .loop import LoopComputeParam
from .mg.rc_mg import MGEnvRC
from .params import (DslashType, EigOperator, EigParam, GaugeParam,
                     InvertParam, LoopParam, MassNormalization, MGParam,
                     parse_disp_str)
from .phase import (map_gamma_g5_planar, momentum_project_production,
                    phase_matrix_planar)
from .utils import log, phase_timer, resolve_device


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to mugiq_tpu_torch yet "
                              f"(ROADMAP queue 1, {item})")


def build_kernel_dirac(U_np: np.ndarray, gauge: GaugeParam, inv: InvertParam,
                       precision: str = "f32",
                       device="cuda") -> WilsonDiracKernel:
    """Kernel-layout operator from a complex numpy gauge: phased links
    (antiperiodic t folded into the last t-slice) and, for clover, the
    chiral blocks of the phased clover field."""
    dev = resolve_device(device)
    geom = LatticeGeometry(gauge.dims)
    U_k = torch.from_numpy(kernel_gauge_np(U_np, gauge.antiperiodic_t,
                                           gauge.anisotropy)).to(dev)
    A_blocks = None
    if inv.dslash_type == DslashType.CLOVER_WILSON:
        from .clover_np import clover_chiral_blocks_np, clover_field_np
        u = np.asarray(U_np).copy()
        if gauge.antiperiodic_t:
            u[3, -1] *= -1.0
        A = clover_field_np(u, inv.kappa, inv.csw)
        A_blocks = torch.from_numpy(clover_chiral_blocks_np(A)).to(dev)
    return WilsonDiracKernel(U_k=U_k, kappa=inv.kappa, Y=geom.dims[1],
                             A_blocks=A_blocks, precision=precision)


def build_packed_schur(U_np: np.ndarray, gauge: GaugeParam,
                       inv: InvertParam, precision: str = "f32",
                       device="cuda") -> SchurDiracKernelPacked:
    """Packed even-odd Schur operator (half-volume fields) from a complex
    numpy gauge (reference pc_solve, eigsolve_mugiq.cpp:169-181).  Clover:
    the asymmetric even-even Schur complement, with the A_oo block inverse
    computed on the host."""
    dev = resolve_device(device)
    geom = LatticeGeometry(gauge.dims)
    U_k = torch.from_numpy(kernel_gauge_np(U_np, gauge.antiperiodic_t,
                                           gauge.anisotropy)).to(dev)
    A_blocks = Ainv_blocks = None
    if inv.dslash_type == DslashType.CLOVER_WILSON:
        from .clover_np import (clover_chiral_blocks_np, clover_field_np,
                                invert_chiral_blocks_np)
        u = np.asarray(U_np).copy()
        if gauge.antiperiodic_t:
            u[3, -1] *= -1.0
        A_np = clover_chiral_blocks_np(clover_field_np(u, inv.kappa,
                                                       inv.csw))
        Ainv_blocks = torch.from_numpy(invert_chiral_blocks_np(A_np)).to(dev)
        A_blocks = torch.from_numpy(A_np).to(dev)
    return SchurDiracKernelPacked(U_k=U_k, kappa=inv.kappa, Y=geom.dims[1],
                                  A_blocks=A_blocks, Ainv_blocks=Ainv_blocks,
                                  precision=precision)


@dataclass
class ProductionResult:
    evals: np.ndarray
    sigma: np.ndarray
    resids: np.ndarray
    data_mom: Optional[np.ndarray]        # complex [Nmom, nLoop, 16, T]
    data_pos: Optional[np.ndarray]        # complex [nLoop, 16, T, Z, Y, X]
    converged: bool
    n_restarts: int


def compute_evecs_production(U_np: np.ndarray, gauge: GaugeParam,
                             inv: InvertParam, eig: EigParam,
                             seed: int = 1234, precision: str = "f32",
                             even_odd: bool = False,
                             basis_precision: str = "f32", device="cuda"):
    """Eigensolve of MdagM/MMdag on the kernel layout (computeEvecsMuGiq,
    lib/interface_mugiq.cpp:122-156): thick-restart Lanczos (+ optional
    Chebyshev and Rayleigh-Ritz refine), then the computeEvals analog
    (Rayleigh quotient, mass-normalization rescale, residuals, sigma).
    even_odd=True eigensolves the packed even-odd preconditioned operator
    (pc_solve): half-volume evecs [n, T, 24, Z, Y*X/2].
    Returns (LanczosResult, evals, sigma, resids)."""
    if eig.block_size > 1:
        _not_ported("block Lanczos (block_size > 1)", "item 8")
    if eig.operator in (EigOperator.M, EigOperator.Mdag):
        _not_ported("the Arnoldi eigensolve of M / Mdag", "item 8")
    if basis_precision != "f32":
        _not_ported(f"basis_precision={basis_precision!r}", "item 3")
    dev = resolve_device(device)
    build = build_packed_schur if even_odd else build_kernel_dirac
    with phase_timer("operator-setup"):
        op = build(U_np, gauge, inv, precision=precision, device=dev)

    # start vector drawn on the host exactly as the JAX package draws it
    rng = np.random.default_rng(seed)
    v0 = torch.from_numpy(rng.standard_normal(op.field_shape).astype(
        np.float32)).to(dev)

    base = op.operator(eig.operator)
    it_fn = base
    which = eig.spectrum.value
    if eig.use_poly_acc:
        from .eig.lanczos import chebyshev_op, estimate_spectral_edge
        a_max = eig.a_max
        if a_max <= 0:
            a_max = estimate_spectral_edge(base, v0)
        it_fn = chebyshev_op(base, eig.poly_deg, eig.a_min, a_max)
        which = "LR"
        log(f"production eigensolve: Chebyshev deg={eig.poly_deg} "
            f"window=[{eig.a_min}, {a_max:.4f}]")

    with phase_timer("eigensolve"):
        res = lanczos_hermitian_realpair(
            it_fn, v0, n_ev=eig.n_ev, n_kr=eig.n_kr, re_im_axis=1,
            tol=eig.tol, max_restarts=eig.max_restarts, which=which,
            check_interval=eig.check_interval)
    log(f"production eigensolve: converged={res.converged} "
        f"restarts={res.n_restarts}")

    scale = (0.25 / inv.kappa ** 2
             if inv.mass_normalization == MassNormalization.MASS else 1.0)
    if eig.use_poly_acc:
        # Ritz vectors of the filtered operator floor at the cluster width;
        # a Rayleigh-Ritz pass on the original operator resolves them
        with phase_timer("rayleigh-ritz-refine"):
            refined, theta, rs_abs = rayleigh_ritz_refine(base, res.evecs,
                                                          re_im_axis=1)
        res.evecs = refined
        evals = np.asarray(theta[:eig.n_ev]) * scale
        sigma = np.sqrt(np.maximum(evals, 0.0))
        return res, evals, sigma, list(np.asarray(rs_abs[:eig.n_ev]) * scale)

    # Rayleigh quotient <v,Mv>/<v,v> (computeEvals, eigsolve_mugiq.cpp:300-307)
    lams, rs = [], []
    for i in range(eig.n_ev):
        v = res.evecs[i]
        w = base(v) * scale
        lam = torch.sum(v * w) / torch.sum(v * v)
        lams.append(float(lam))
        rs.append(float(torch.linalg.vector_norm(lam * v - w)))
    evals = np.asarray(lams)
    sigma = np.sqrt(np.maximum(evals, 0.0))
    return res, evals, sigma, rs


def compute_loop_production(U_np: np.ndarray, gauge: GaugeParam,
                            inv: InvertParam, eig: EigParam,
                            loop_param: LoopParam,
                            U_loop_np: Optional[np.ndarray] = None,
                            keep_pos: bool = False,
                            use_mg: bool = False, mg: MGParam = None,
                            mesh=None, precision: str = "f32",
                            basis_precision: str = "f32",
                            seed: int = 1234, mg_setup: str = "auto",
                            device="cuda") -> ProductionResult:
    """Deflated disconnected loops on one device: eigensolve, measurement
    on the kernel layout, g5 map + momentum projection + HDF5.

    use_mg=True eigensolves the Galerkin coarse operator of the MG
    hierarchy that `mg` describes and prolongates its eigenvectors (the
    reference's computeCoarse path).  Its fine level is the kernel-layout
    formulation at every volume (mg_setup "auto" or "kernel"); the JAX
    package's "host", "split" and "agg" setups are TPU workarounds."""
    if mesh is not None:
        _not_ported("the sharded production path (mesh)", "item 14")
    if loop_param.write_pos_space_hdf5:
        _not_ported("the position-space HDF5 writer", "item 4")
    dev = resolve_device(device)
    if use_mg:
        if mg_setup not in ("auto", "kernel"):
            raise NotImplementedError(
                f"mg_setup={mg_setup!r} is a TPU workaround that is not "
                f"ported (ROADMAP queue 1, 'Not ported'); the kernel "
                f"formulation serves every volume")
        if basis_precision != "f32":
            log("note: basis_precision is ignored on the MG-deflated path "
                "(the coarse-operator basis is small)")
        return _compute_loop_production_mg(U_np, gauge, inv, eig, loop_param,
                                           mg, U_loop_np, keep_pos, seed,
                                           precision, dev)
    geom = LatticeGeometry(gauge.dims)
    cp = LoopComputeParam.build(geom, loop_param)
    res, evals, sigma, rs = compute_evecs_production(
        U_np, gauge, inv, eig, seed=seed, precision=precision,
        basis_precision=basis_precision, device=dev)

    evecs = res.evecs
    res.evecs = None
    U_meas = U_loop_np if U_loop_np is not None else np.asarray(U_np)
    data_mom, pos_np = _measure_production_kernel(
        geom, loop_param, cp, evecs, sigma, U_meas, keep_pos)
    return ProductionResult(
        evals=evals, sigma=sigma, resids=np.asarray(rs),
        data_mom=data_mom, data_pos=pos_np,
        converged=res.converged, n_restarts=res.n_restarts)


def _compute_loop_production_mg(U_np, gauge, inv, eig, loop_param, mg,
                                U_loop_np, keep_pos, seed, precision,
                                device) -> ProductionResult:
    """MG-deflated loops: the hierarchy (null vectors smoothed with K1,
    kernel-layout transfer, Galerkin stencils probed with K5), an unfiltered
    thick-restart Lanczos of the coarsest MdagM, the computeEvals tail on
    the coarse operator, prolongation of the coarse evecs to the fine
    kernel layout, then the measurement of the non-MG path."""
    if mg is None:
        raise ValueError("use_mg requires MGParam")
    geom = LatticeGeometry(gauge.dims)
    cp = LoopComputeParam.build(geom, loop_param)
    with phase_timer("operator-setup"):
        fast_op = build_kernel_dirac(U_np, gauge, inv, precision=precision,
                                     device=device)
    log("MG setup on the device (kernel-layout transfer/Galerkin)")
    with phase_timer("mg-setup"):
        if mg.vec_infile:
            env = MGEnvRC.load(mg.vec_infile, fast_op, mg, device=device)
        else:
            env = MGEnvRC.build(fast_op, mg)
            if mg.vec_outfile:
                env.save(mg.vec_outfile)
    coarse = env.coarsest_op

    rng = np.random.default_rng(seed)
    v0 = torch.from_numpy(rng.standard_normal(coarse.field_shape).astype(
        np.float32)).to(device)
    if eig.use_poly_acc:
        log("note: the Chebyshev filter (--eig-use-poly-acc) is ignored on "
            "the MG-deflated path: the coarse eigensolve runs unfiltered")
    with phase_timer("eigensolve"):
        res = lanczos_hermitian_realpair(
            coarse.MdagM, v0, n_ev=eig.n_ev, n_kr=eig.n_kr,
            re_im_axis=v0.ndim - 1, tol=eig.tol,
            max_restarts=eig.max_restarts, which=eig.spectrum.value,
            check_interval=eig.check_interval)
    log(f"production MG eigensolve: converged={res.converged} "
        f"restarts={res.n_restarts}")

    scale = (0.25 / inv.kappa ** 2
             if inv.mass_normalization == MassNormalization.MASS else 1.0)
    lams, rs = [], []
    for v in res.evecs:
        w = coarse.MdagM(v) * scale
        lam = torch.sum(v * w) / torch.sum(v * v)
        lams.append(float(lam))
        rs.append(float(torch.linalg.vector_norm(lam * v - w)))
    evals = np.asarray(lams)
    sigma = np.sqrt(np.maximum(evals, 0.0))

    with phase_timer("prolongate"):
        fine = env.prolongate_batch(res.evecs)
    # the hierarchy and the fine operator are dead past the prolongation:
    # free them before the measurement
    del env, fast_op, coarse
    res.evecs = None
    U_meas = U_loop_np if U_loop_np is not None else np.asarray(U_np)
    data_mom, pos_np = _measure_production_kernel(
        geom, loop_param, cp, fine, sigma, U_meas, keep_pos)
    return ProductionResult(
        evals=evals, sigma=sigma, resids=np.asarray(rs),
        data_mom=data_mom, data_pos=pos_np,
        converged=res.converged, n_restarts=res.n_restarts)


def _measure_production_kernel(geom, loop_param, cp, evecs_k, sigma,
                               U_loop_np, keep_pos):
    """Kernel-layout measurement: the evec batch [n, T, 24, Z, Y*X] stays
    in the eigensolver's layout; K2 contracts, K3 displaces.

    Each displacement chain ping-pongs between two buffers: the first step
    writes a new buffer, so the evec batch survives as the L side."""
    dev = evecs_k.device
    Y = geom.Ly
    inv_sigma = torch.as_tensor(1.0 / np.asarray(sigma), dtype=torch.float32,
                                device=dev)
    # the displacement gauge is UNPHASED (no fermion boundary phase)
    U_loop_k = torch.from_numpy(kernel_gauge_np(U_loop_np, False)).to(dev)

    def contract(vR):
        return gamma_project(loop_contract(evecs_k, vR, inv_sigma), Y)

    slots = [None] * cp.n_loop
    with phase_timer("loop-contraction"):
        slots[0] = contract(evecs_k)
        for ie, (dstr, start, stop) in enumerate(cp.disp_entries):
            mu, sgn = parse_disp_str(dstr)
            bufs = [torch.empty_like(evecs_k), torch.empty_like(evecs_k)]
            vR = evecs_k
            count = 0
            for idisp in range(1, stop + 1):
                vR = covariant_displace(vR, U_loop_k, mu, sgn, Y,
                                        out=bufs[idisp % 2])
                if start <= idisp <= stop:
                    slots[cp.n_loop_offset[ie] + count] = contract(vR)
                    count += 1
            del bufs, vR
        data_pos = torch.stack(slots)          # [l, 2, 16, T, Z, Y, X]
        del slots
    del U_loop_k
    return _measure_tail(geom, loop_param, cp, data_pos, keep_pos)


def _measure_tail(geom, loop_param, cp, data_pos, keep_pos):
    """g5 map + momentum projection + HDF5 + keep_pos epilogue."""
    data_mom = None
    if loop_param.do_mom_proj:
        ph = phase_matrix_planar(geom, loop_param.momenta,
                                 int(loop_param.ft_sign),
                                 device=data_pos.device)
        with phase_timer("momentum-projection"):
            mapped = map_gamma_g5_planar(data_pos)
            lgtp = momentum_project_production(mapped, ph)
        arr = lgtp.cpu().numpy()               # [l, 2, 16, T, P]
        cplx = arr[:, 0] + 1j * arr[:, 1]
        data_mom = np.transpose(cplx, (3, 0, 1, 2))   # [P, l, 16, T]
        if loop_param.write_mom_space_hdf5 or loop_param.fname_mom_h5:
            if not loop_param.fname_mom_h5:
                raise ValueError("write_mom_space_hdf5 set but fname_mom_h5 "
                                 "empty")
            write_loops_hdf5_mom(loop_param.fname_mom_h5, data_mom,
                                 [tuple(m) for m in loop_param.momenta],
                                 cp.slot_labels())
            log(f"production loop data written to {loop_param.fname_mom_h5}")

    pos_np = None
    if keep_pos:
        a = data_pos.cpu().numpy()
        pos_np = a[:, 0] + 1j * a[:, 1]
    return data_mom, pos_np
