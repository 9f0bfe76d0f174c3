"""The production loop on a CUDA device, or sharded over ranks (port of
mugiq_tpu.production: build_kernel_dirac, build_packed_schur,
compute_evecs_production, compute_loop_production,
_measure_production_kernel, _measure_tail).

Eigensolve of MdagM (or MMdag) of the full operator, or of the packed
even-odd preconditioned one, with thick-restart Lanczos or block Lanczos
(block_size > 1; one batched launch per block step), optionally
Chebyshev-filtered and then Rayleigh-Ritz refined, with the Krylov basis
in f32 or bf16 (on one device or under a mesh); of M or M^dag with the
Krylov-Schur Arnoldi; the computeEvals tail;
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

from .block_lanczos import block_lanczos_hermitian_realpair
from .dirac_kernel import WilsonDiracKernel
from .io.hdf5io import (write_loops_hdf5_mom, write_loops_hdf5_pos,
                        write_loops_hdf5_pos_sharded)
from .kernels.contract import covariant_displace, gamma_project, loop_contract
from .lanczos import (lanczos_hermitian_realpair, norm,
                      rayleigh_ritz_refine)
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


def build_sharded_operator(U_np: np.ndarray, gauge: GaugeParam,
                           inv: InvertParam, mesh, precision: str = "f32",
                           even_odd: bool = False):
    """The rank's block of the operator on a LatticeMesh: the single-device
    operator's fields built on the host (build_kernel_dirac or
    build_packed_schur with device="cpu"), sliced with mesh.local_block and
    moved to the rank's device (parallel/shard_op.py)."""
    from .parallel.shard_op import (ShardedSchurKernelPacked,
                                    ShardedWilsonKernel, check_even_block)
    if even_odd:
        check_even_block(mesh)
        host = build_packed_schur(U_np, gauge, inv, precision=precision,
                                  device="cpu")
        return ShardedSchurKernelPacked.from_packed_op(mesh, host)
    host = build_kernel_dirac(U_np, gauge, inv, precision=precision,
                              device="cpu")
    return ShardedWilsonKernel.from_kernel_op(mesh, host)


def compute_evecs_production(U_np: np.ndarray, gauge: GaugeParam,
                             inv: InvertParam, eig: EigParam,
                             seed: int = 1234, precision: str = "f32",
                             even_odd: bool = False,
                             basis_precision: str = "f32", mesh=None,
                             device="cuda"):
    """Eigensolve on the kernel layout (computeEvecsMuGiq,
    lib/interface_mugiq.cpp:122-156), dispatched as the JAX function does:
    MdagM/MMdag by thick-restart Lanczos, or block Lanczos for
    eig.block_size > 1 (+ optional Chebyshev and Rayleigh-Ritz refine),
    then the computeEvals analog (Rayleigh quotient, mass-normalization
    rescale, residuals, sigma); M/Mdag by the Krylov-Schur Arnoldi,
    sigma = |evals|.  even_odd=True eigensolves the packed even-odd
    preconditioned operator (pc_solve): half-volume evecs
    [n, T, 24, Z, Y*X/2].  basis_precision="bf16" stores the Lanczos
    basis in bf16 (f32 algebra; residuals floor near bf16 eps).
    mesh (a parallel.mesh.LatticeMesh): the sharded solve on the rank's
    block, on mesh.device; every inner product is reduced over the ranks
    and the evecs returned are the rank's blocks.  A bf16 basis runs
    under a mesh too: the stored bf16 vectors go through the exchange and
    the halo kernels in bf16, as on one device.
    Returns (result, evals, sigma, resids)."""
    if basis_precision not in ("f32", "bf16"):
        raise ValueError(f"basis_precision must be f32|bf16: "
                         f"{basis_precision}")
    bdtype = torch.bfloat16 if basis_precision == "bf16" else None
    nonnormal = eig.operator in (EigOperator.M, EigOperator.Mdag)
    if nonnormal:
        # makeChecks: poly acceleration needs a normal operator
        # (eigsolve_mugiq.cpp:210-221)
        if eig.use_poly_acc:
            raise ValueError("Chebyshev acceleration requires a normal "
                             "operator (MdagM/MMdag)")
        if bdtype is not None:
            raise ValueError("basis_precision='bf16' is implemented for "
                             "the Hermitian Lanczos only (MdagM/MMdag)")
    dev = resolve_device(device) if mesh is None else mesh.device
    reduce = None if mesh is None else mesh.all_reduce
    with phase_timer("operator-setup"):
        if mesh is None:
            build = build_packed_schur if even_odd else build_kernel_dirac
            op = build(U_np, gauge, inv, precision=precision, device=dev)
        else:
            op = build_sharded_operator(U_np, gauge, inv, mesh, precision,
                                        even_odd)

    # start vector drawn on the host exactly as the JAX package draws it:
    # the global field on every rank, which keeps its block, so that one
    # seed gives one start vector on any mesh.  Block Lanczos: the block's
    # other b - 1 vectors continue the same stream (the JAX production
    # path draws them from a fresh generator of the same seed, so its
    # second start vector repeats the first and the QR fills it from
    # rounding noise; ROADMAP reference caveats)
    X, Y, Z, T = gauge.dims
    b = eig.block_size
    rng = np.random.default_rng(seed)
    W0 = rng.standard_normal((b, T, 24, Z, Y * X // (2 if even_odd else 1))
                             ).astype(np.float32)
    if mesh is not None:
        W0 = np.ascontiguousarray(mesh.local_block(W0, lead=1))
    W0 = torch.from_numpy(W0).to(dev)
    v0 = W0[0]

    base = op.operator(eig.operator)
    scale = (0.25 / inv.kappa ** 2
             if inv.mass_normalization == MassNormalization.MASS else 1.0)
    if nonnormal:
        from .eig.arnoldi_realpair import arnoldi_krylov_schur_realpair
        with phase_timer("eigensolve"):
            res = arnoldi_krylov_schur_realpair(
                base, v0, n_ev=eig.n_ev, n_kr=eig.n_kr, re_im_axis=1,
                tol=eig.tol, max_restarts=eig.max_restarts,
                which=eig.spectrum.value, check_interval=eig.check_interval,
                reduce=reduce)
        log(f"production eigensolve (Arnoldi, {eig.operator.name}): "
            f"converged={res.converged} restarts={res.n_restarts}")
        _check_branch(res, mesh)
        evals = np.asarray(res.evals) * scale
        # |lambda|: sigma = sqrt(lambda) only for a normal operator
        return res, evals, np.abs(evals), list(np.asarray(res.resids))

    it_fn = base
    which = eig.spectrum.value
    if eig.use_poly_acc:
        from .eig.lanczos import chebyshev_op, estimate_spectral_edge
        a_max = eig.a_max
        if a_max <= 0:
            a_max = estimate_spectral_edge(base, v0, reduce=reduce)
        it_fn = chebyshev_op(base, eig.poly_deg, eig.a_min, a_max)
        which = "LR"
        log(f"production eigensolve: Chebyshev deg={eig.poly_deg} "
            f"window=[{eig.a_min}, {a_max:.4f}]")

    with phase_timer("eigensolve"):
        if b > 1:
            # the operators (and the Chebyshev filter) take the batch axis:
            # one launch per block application
            res = block_lanczos_hermitian_realpair(
                it_fn, W0, n_ev=eig.n_ev, n_kr=eig.n_kr, block_size=b,
                re_im_axis=1, tol=eig.tol, max_restarts=eig.max_restarts,
                which=which, check_interval=eig.check_interval,
                matvec_batch=it_fn, v0_is_block=True, reduce=reduce,
                basis_dtype=bdtype)
        else:
            res = lanczos_hermitian_realpair(
                it_fn, v0, n_ev=eig.n_ev, n_kr=eig.n_kr, re_im_axis=1,
                tol=eig.tol, max_restarts=eig.max_restarts, which=which,
                check_interval=eig.check_interval, reduce=reduce,
                basis_dtype=bdtype)
    del W0, v0
    log(f"production eigensolve: converged={res.converged} "
        f"restarts={res.n_restarts}")
    _check_branch(res, mesh)

    if eig.use_poly_acc:
        # Ritz vectors of the filtered operator floor at the cluster width;
        # a Rayleigh-Ritz pass on the original operator resolves them
        with phase_timer("rayleigh-ritz-refine"):
            refined, theta, rs_abs = rayleigh_ritz_refine(
                base, res.evecs, re_im_axis=1, reduce=reduce)
        res.evecs = refined
        evals = np.asarray(theta[:eig.n_ev]) * scale
        sigma = np.sqrt(np.maximum(evals, 0.0))
        return res, evals, sigma, list(np.asarray(rs_abs[:eig.n_ev]) * scale)

    # Rayleigh quotient <v,Mv>/<v,v> (computeEvals, eigsolve_mugiq.cpp:300-307)
    red = reduce or (lambda x: x)
    lams, rs = [], []
    for i in range(eig.n_ev):
        v = res.evecs[i]
        w = base(v) * scale
        lam = red(torch.sum(v * w)) / red(torch.sum(v * v))
        lams.append(float(lam))
        rs.append(float(norm(lam * v - w, reduce)))
    evals = np.asarray(lams)
    sigma = np.sqrt(np.maximum(evals, 0.0))
    return res, evals, sigma, rs


def _check_branch(res, mesh) -> None:
    """Under a mesh every rank must take the same convergence branch."""
    if mesh is None:
        return
    from .parallel.distributed import gather_global
    seen = gather_global((res.n_restarts, res.converged))
    if len(set(seen)) != 1:
        raise RuntimeError(f"the ranks took different convergence "
                           f"branches (restarts, converged): {seen}")


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
    package's "host", "split" and "agg" setups are TPU workarounds.

    mesh (a parallel.mesh.LatticeMesh): the sharded loop, one rank's block
    per process on mesh.device (compute_evecs_production's mesh, then
    _measure_production_sharded); data_mom is the global result on every
    rank and only the primary writes the momentum-space file; keep_pos
    returns the global data_pos on every rank, and the position-space
    file is one per rank (<fname_pos_h5>.proc<rank>.h5).  With use_mg the
    fine level of the hierarchy is sharded alike and the coarse eigensolve
    runs on every rank (_compute_loop_production_mg)."""
    dev = resolve_device(device) if mesh is None else mesh.device
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
                                           precision, dev, mesh)
    geom = LatticeGeometry(gauge.dims)
    cp = LoopComputeParam.build(geom, loop_param)
    res, evals, sigma, rs = compute_evecs_production(
        U_np, gauge, inv, eig, seed=seed, precision=precision,
        basis_precision=basis_precision, mesh=mesh, device=dev)

    evecs = res.evecs
    res.evecs = None
    U_meas = U_loop_np if U_loop_np is not None else np.asarray(U_np)
    if mesh is None:
        data_mom, pos_np = _measure_production_kernel(
            geom, loop_param, cp, evecs, sigma, U_meas, keep_pos)
    else:
        data_mom, pos_np = _measure_production_sharded(
            geom, loop_param, cp, evecs, sigma, U_meas, mesh, keep_pos)
    return ProductionResult(
        evals=evals, sigma=sigma, resids=np.asarray(rs),
        data_mom=data_mom, data_pos=pos_np,
        converged=res.converged, n_restarts=res.n_restarts)


def _compute_loop_production_mg(U_np, gauge, inv, eig, loop_param, mg,
                                U_loop_np, keep_pos, seed, precision,
                                device, mesh=None) -> ProductionResult:
    """MG-deflated loops: the hierarchy (null vectors smoothed with K1,
    kernel-layout transfer, Galerkin stencils probed with K5), an unfiltered
    thick-restart Lanczos of the coarsest MdagM, the computeEvals tail on
    the coarse operator, prolongation of the coarse evecs to the fine
    kernel layout, then the measurement of the non-MG path.

    mesh: the fine level on the rank's block (smoothing on the sharded
    operator, K7a; the Galerkin probes across the rank edges, K5), the
    coarse operator gathered to every rank and eigensolved there, each
    rank the same (replicated, as the JAX package keeps it), the rank's
    block of the prolongated evecs measured as the sharded non-MG loop."""
    from .mg.kernel_mg import check_blocks_divide

    if mg is None:
        raise ValueError("use_mg requires MGParam")
    if mesh is not None and mg.geo_block_size:
        # before the sharded operator, whose links are exchanged
        check_blocks_divide(mesh, mg.geo_block_size[0])
    geom = LatticeGeometry(gauge.dims)
    cp = LoopComputeParam.build(geom, loop_param)
    with phase_timer("operator-setup"):
        if mesh is None:
            fast_op = build_kernel_dirac(U_np, gauge, inv,
                                         precision=precision, device=device)
        else:
            fast_op = build_sharded_operator(U_np, gauge, inv, mesh,
                                             precision)
    log("MG setup on the device (kernel-layout transfer/Galerkin)")
    with phase_timer("mg-setup"):
        if mg.vec_infile:
            env = MGEnvRC.load(mg.vec_infile, fast_op, mg, device=device,
                               mesh=mesh)
        else:
            env = MGEnvRC.build(fast_op, mg, mesh=mesh)
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
    _check_branch(res, mesh)

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
    if mesh is None:
        data_mom, pos_np = _measure_production_kernel(
            geom, loop_param, cp, fine, sigma, U_meas, keep_pos)
    else:
        data_mom, pos_np = _measure_production_sharded(
            geom, loop_param, cp, fine, sigma, U_meas, mesh, keep_pos)
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


def _measure_production_sharded(geom, loop_param, cp, evecs_k, sigma,
                                U_loop_np, mesh, keep_pos=False):
    """The measurement of one rank's block [n, Tl, 24, Zl, Yl*X]: K2 on the
    local batch (site-local); a displacement step along an axis that the
    mesh partitions runs K3 on the batch extended by one halo slice along
    that axis, with links extended alike, and keeps the interior (with one
    halo slice, K3's periodic wrap never reaches an interior row); along an
    axis the rank holds whole, K3 as on one device.  The tail projects the
    rank's sites on its block of the phases and sums the ranks' t rows;
    keep_pos returns the global position-space loops (gathered)."""
    from .parallel.halo import HaloExchange
    from .parallel.shard_dslash import extend_along, partitioned_dirs

    dev = evecs_k.device
    Yl = mesh.local["y"]
    inv_sigma = torch.as_tensor(1.0 / np.asarray(sigma), dtype=torch.float32,
                                device=dev)
    U_loop_k = torch.from_numpy(np.ascontiguousarray(mesh.local_block(
        kernel_gauge_np(U_loop_np, False)))).to(dev)
    halo = HaloExchange(mesh)
    split = partitioned_dirs(mesh, lead=1)      # the batch [n, Tl, ...]
    U_ext = {mu: extend_along(halo, U_loop_k, a, du, w)
             for mu, (a, du, _, w) in split.items()}

    def displace(vR, mu, sgn, out):
        if mu not in split:
            return covariant_displace(vR, U_loop_k, mu, sgn, Yl, out=out)
        a, _, d, w = split[mu]
        ext = extend_along(halo, vR, a, d, w)
        res = covariant_displace(ext, U_ext[mu], mu, sgn,
                                 Yl + 2 if a == "y" else Yl)
        return out.copy_(res.narrow(d, w, vR.shape[d]))

    def contract(vR):
        return gamma_project(loop_contract(evecs_k, vR, inv_sigma), Yl)

    slots = [None] * cp.n_loop
    with phase_timer("loop-contraction"):
        slots[0] = contract(evecs_k)
        for ie, (dstr, start, stop) in enumerate(cp.disp_entries):
            mu, sgn = parse_disp_str(dstr)
            bufs = [torch.empty_like(evecs_k), torch.empty_like(evecs_k)]
            vR = evecs_k
            count = 0
            for idisp in range(1, stop + 1):
                vR = displace(vR, mu, sgn, bufs[idisp % 2])
                if start <= idisp <= stop:
                    slots[cp.n_loop_offset[ie] + count] = contract(vR)
                    count += 1
            del bufs, vR
        data_pos = torch.stack(slots)          # [l, 2, 16, Tl, Zl, Yl, X]
        del slots
    del U_loop_k, U_ext
    return _measure_tail(geom, loop_param, cp, data_pos, keep_pos, mesh)


def _measure_tail(geom, loop_param, cp, data_pos, keep_pos, mesh=None):
    """g5 map + momentum projection + HDF5 + keep_pos epilogue.  mesh:
    data_pos is a rank's block; its projection fills the rank's t rows of
    the global result, summed over the ranks, and the primary writes the
    momentum-space file; the g5-mapped position-space loops go to one
    file per rank (write_loops_hdf5_pos_sharded) under a mesh of more
    than one rank, and keep_pos returns the global data_pos, gathered."""
    data_mom = None
    mapped = None
    if loop_param.do_mom_proj:
        if mesh is None:
            ph = phase_matrix_planar(geom, loop_param.momenta,
                                     int(loop_param.ft_sign),
                                     device=data_pos.device)
        else:
            ph = phase_matrix_planar(geom, loop_param.momenta,
                                     int(loop_param.ft_sign), device="cpu")
            z0, y0 = mesh.origin["z"], mesh.origin["y"]
            ph = ph[:, z0:z0 + mesh.local["z"], y0:y0 + mesh.local["y"]
                    ].to(data_pos.device).contiguous()
        with phase_timer("momentum-projection"):
            mapped = map_gamma_g5_planar(data_pos)
            lgtp = momentum_project_production(mapped, ph)
            if mesh is not None:
                l, _, g, Tl, P = lgtp.shape
                full = torch.zeros((l, 2, g, geom.Lt, P), dtype=lgtp.dtype,
                                   device=lgtp.device)
                t0 = mesh.origin["t"]
                full[:, :, :, t0:t0 + Tl] = lgtp
                lgtp = mesh.all_reduce(full)
        arr = lgtp.cpu().numpy()               # [l, 2, 16, T, P]
        cplx = arr[:, 0] + 1j * arr[:, 1]
        data_mom = np.transpose(cplx, (3, 0, 1, 2))   # [P, l, 16, T]
        if (loop_param.write_mom_space_hdf5 or loop_param.fname_mom_h5) \
                and (mesh is None or mesh.is_primary):
            if not loop_param.fname_mom_h5:
                raise ValueError("write_mom_space_hdf5 set but fname_mom_h5 "
                                 "empty")
            write_loops_hdf5_mom(loop_param.fname_mom_h5, data_mom,
                                 [tuple(m) for m in loop_param.momenta],
                                 cp.slot_labels())
            log(f"production loop data written to {loop_param.fname_mom_h5}")

    if loop_param.write_pos_space_hdf5 and loop_param.fname_pos_h5:
        # g5-mapped, as the API path writes it (the momentum-space
        # output's convention)
        if mapped is None:
            mapped = map_gamma_g5_planar(data_pos)
        a = mapped.cpu().numpy()               # [l, 2, 16, T, Z, Y, X]
        if mesh is not None and mesh.world > 1:
            path = write_loops_hdf5_pos_sharded(loop_param.fname_pos_h5, a,
                                                cp.slot_labels(), mesh)
            log(f"production pos-space loop shard written to {path}")
        else:
            write_loops_hdf5_pos(loop_param.fname_pos_h5,
                                 a[:, 0] + 1j * a[:, 1], cp.slot_labels())
            log(f"production pos-space loop data written to "
                f"{loop_param.fname_pos_h5}")
        del a
    del mapped

    pos_np = None
    if keep_pos:
        if mesh is not None:
            # [l, 2, 16, Tl, Zl, Yl, X] -> the fused y*x axis that
            # gather_field assembles, and back
            l, two, g, Tl, Zl, Yl, X = data_pos.shape
            data_pos = mesh.gather_field(
                data_pos.reshape(l, two, g, Tl, Zl, Yl * X), lead=3
            ).reshape(l, two, g, geom.Lt, geom.Lz, geom.Ly, X)
        a = data_pos.cpu().numpy()
        pos_np = a[:, 0] + 1j * a[:, 1]
    return data_mom, pos_np
