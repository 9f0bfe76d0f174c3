"""Disconnected-loop CLI on the GPU (port of mugiq_tpu.cli.loop).

As the JAX CLI, it runs the production path with --production and the
API path (api.compute_loop, complex fields) without it.

The production path:

    python -m mugiq_tpu_torch.cli.loop --dims 32 32 32 64 --gauge random \
        --gauge-seed 1 --kappa 0.12 --eig-nev 8 --eig-nkr 24 --eig-tol 1e-5 \
        --eig-max-restarts 30 --eig-use-poly-acc --eig-poly-deg 16 \
        --eig-amin 0.25 --momenta-filename moms.txt --loop-do-nonlocal yes \
        --displace-entry-string +z:1 --loop-write-mom-space yes \
        --loop-mom-space-filename loops.h5 --production

--mugiq-use-mg yes runs the MG-deflated loop with the JAX CLI's MG flags:

    python -m mugiq_tpu_torch.cli.loop --dims 32 32 32 64 --gauge random \
        --gauge-seed 1 --kappa 0.12 --eig-nev 8 --eig-nkr 24 --eig-tol 1e-6 \
        --eig-max-restarts 120 --mugiq-use-mg yes --mg-levels 2 \
        --mg-block-size 4 4 4 4 --mg-nvec 12 --mg-setup-iters 8 \
        --link-precision bf16 --production

--mesh NT NZ [NY] runs the sharded loop, one process per rank (NCCL with
a card per rank; gloo on the CPU or when ranks share a card), with or
without --mugiq-use-mg yes (the MG blocks must then divide each rank's
block along the partitioned axes):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m mugiq_tpu_torch.cli.loop --dims 8 8 8 16 ... --production \
        --mesh 2 1

--basis-precision bf16 stores the Krylov basis in bf16, on one device
and under --mesh (the halo kernels then take bf16 spinors);
--eig-block-size B > 1 runs block Lanczos.  The production path reads no
--prec (f32, as in the JAX CLI; --prec double is logged).

The API path, in complex64 (--prec single) or complex128 (--prec
double), on one device (--mesh is a usage error there), with
--mugiq-use-mg yes --mugiq-compute-coarse yes for the MG-coarse
eigensolve and prolongated eigenvectors:

    python -m mugiq_tpu_torch.cli.loop --dims 16 16 16 32 --gauge random \
        --gauge-seed 3 --kappa 0.12 --eig-nev 8 --eig-nkr 24 \
        --eig-tol 1e-10 --eig-max-restarts 150 --eig-use-poly-acc \
        --eig-poly-deg 16 --eig-amin 0.25 --prec double

The parser defines every flag of the JAX CLI with its choices and
default, so each of its invocations parses here.  --platform,
--compile-cache, --autotune (and on the production path --loop-calc-type)
drive JAX-only machinery and are logged with no other effect.
--loop-write-pos-space yes writes the g5-mapped position-space loops
(--loop-pos-space-filename; under --mesh one file per rank,
<name>.proc<rank>.h5, io.hdf5io.assemble_loops_hdf5_pos joins them).
--loop-coarse-ulocal yes (API path, with --mugiq-use-mg yes
--mugiq-compute-coarse yes) assembles the coarse-space ultra-local loop
and logs its shape and |L|_max, as the JAX CLI does; with --production it
is logged and ignored.  Values that need unported work raise
NotImplementedError naming their ROADMAP item: --serve (item 13).
"""

import argparse
import sys
import time

from .common import (MESH_NEEDS_PRODUCTION, add_dirac_args, add_eig_args,
                     add_lattice_args, add_mg_args, add_parallel_args,
                     add_production_args, api_dtype, build_mesh,
                     build_mg_param, build_params, log_jax_only,
                     log_production_prec, quiet_unless_primary,
                     read_momenta_file)
from ..utils import not_ported

# the JAX CLI's message (mugiq_tpu/cli/loop.py:150-151)
COARSE_ULOCAL_NEEDS_MG = ("--loop-coarse-ulocal requires --mugiq-use-mg yes "
                          "--mugiq-compute-coarse yes (coarse eigenvectors)")


def _parse(argv):
    """(parser, parsed args) after the checks of the JAX CLI."""
    p = argparse.ArgumentParser(
        prog="mugiq-loop-torch",
        description="Disconnected quark loops with deflation eigenvectors "
                    "on a CUDA device (computeLoop)")
    add_lattice_args(p)
    add_dirac_args(p)
    add_eig_args(p)
    add_mg_args(p)
    add_parallel_args(p)
    g = p.add_argument_group("loop")
    g.add_argument("--momenta-filename", default="",
                   help="file with 'px py pz' per line; default p=0 only")
    g.add_argument("--loop-ft-sign", choices=["plus", "minus"],
                   default="minus")
    g.add_argument("--loop-calc-type", choices=["blas", "opt", "basic"],
                   default="opt",
                   help="the JAX validation path's contraction form: "
                        "accepted, no effect (the production path runs K2)")
    g.add_argument("--loop-write-mom-space", choices=["yes", "no"],
                   default="no")
    g.add_argument("--loop-write-pos-space", choices=["yes", "no"],
                   default="no",
                   help="position-space HDF5 (g5-mapped; one file per "
                        "rank under --mesh)")
    g.add_argument("--loop-do-momproj", choices=["yes", "no"], default="yes")
    g.add_argument("--loop-do-nonlocal", choices=["yes", "no"], default="no")
    g.add_argument("--displace-entry-string", default="",
                   help="e.g. '+z:1,8;-x:3'")
    g.add_argument("--loop-mom-space-filename", default="")
    g.add_argument("--loop-pos-space-filename", default="")
    g.add_argument("--loop-gauge-filename", default="",
                   help="separate (smeared) gauge for displacements")
    g.add_argument("--loop-coarse-ulocal", choices=["yes", "no"],
                   default="no",
                   help="the coarse-space ultra-local loop of the MG-coarse "
                        "eigenvectors (logged; the API path only)")
    add_production_args(g)
    g.add_argument("--serve", default="", metavar="DIR",
                   help="the resident server mode (not ported)")
    args = p.parse_args(argv)
    if args.loop_do_nonlocal == "yes" and not args.displace_entry_string:
        p.error("--loop-do-nonlocal yes requires --displace-entry-string")
    if (args.loop_write_mom_space == "yes"
            and not args.loop_mom_space_filename):
        p.error("--loop-write-mom-space yes requires "
                "--loop-mom-space-filename")
    if (args.loop_write_pos_space == "yes"
            and not args.loop_pos_space_filename):
        p.error("--loop-write-pos-space yes requires "
                "--loop-pos-space-filename")
    return p, args


def parse_args(argv=None):
    return _parse(argv)[1]


def run(argv=None):
    """Parse, run the production loop (--production) or the API path, log
    as the JAX CLI does; returns the ProductionResult, or the API path's
    (LoopResult, EigsolveResult), and with --loop-coarse-ulocal yes the
    triple (LoopResult, EigsolveResult, coarse loop), the coarse loop the
    complex128 numpy array [P, 16, T] of mg.coarse_loop.coarse_loop_ulocal
    (with --production the flag is logged and ignored, as the JAX CLI
    ignores it there)."""
    p, args = _parse(argv)
    if args.mesh is not None and not args.production:
        p.error(MESH_NEEDS_PRODUCTION)
    if args.serve:
        not_ported("--serve (the resident production server)", "item 13")
    if (args.loop_coarse_ulocal == "yes" and not args.production
            and not (args.mugiq_use_mg == "yes"
                     and args.mugiq_compute_coarse == "yes")):
        p.error(COARSE_ULOCAL_NEEDS_MG)
    from ..io.gauge_io import load_gauge_np, plaquette
    from ..lattice import LatticeGeometry
    from ..params import CalcType, FTSign, LoopParam
    from ..production import compute_loop_production
    from ..utils import log, print_profile

    gp, ip, ep = build_params(args)
    use_mg = args.mugiq_use_mg == "yes"
    mesh, device = build_mesh(args, gp.dims)
    quiet_unless_primary(mesh)
    mg = build_mg_param(args) if use_mg else None
    geom = LatticeGeometry(gp.dims)
    U = load_gauge_np(args.gauge, geom, seed=args.gauge_seed)
    momenta = (read_momenta_file(args.momenta_filename)
               if args.momenta_filename else [(0, 0, 0)])
    lp = LoopParam(
        momenta=momenta,
        ft_sign=FTSign.MINUS if args.loop_ft_sign == "minus" else FTSign.PLUS,
        write_mom_space_hdf5=args.loop_write_mom_space == "yes",
        do_mom_proj=args.loop_do_momproj == "yes",
        do_nonlocal=args.loop_do_nonlocal == "yes",
        disp_entries=[e for e in args.displace_entry_string.split(";") if e],
        fname_mom_h5=args.loop_mom_space_filename,
        write_pos_space_hdf5=args.loop_write_pos_space == "yes",
        fname_pos_h5=args.loop_pos_space_filename,
        calc_type=(CalcType(args.loop_calc_type) if not args.production
                   else CalcType.OPT_KERNEL),
    )
    U_loop = None
    if args.loop_gauge_filename:
        U_loop = load_gauge_np(args.loop_gauge_filename, geom,
                               seed=args.gauge_seed)

    tot, sp, tm = plaquette(U, device)
    log(f"Computed plaquette is {tot:.8f} "
        f"(spatial = {sp:.8f}, temporal = {tm:.8f})")
    log_jax_only(args, production=args.production)
    if not args.production:
        return _run_api(args, U, gp, ip, ep, lp, U_loop, use_mg, mg, device)
    log_production_prec(args)
    if args.loop_coarse_ulocal == "yes":
        log("--loop-coarse-ulocal yes applies to the API path (without "
            "--production); the production loop ignores it, as mugiq-loop "
            "does")
    if args.solve_type == "direct-pc":
        log("--solve-type direct-pc applies to the eigensolve CLI; the loop "
            "eigensolves the full operator, as mugiq-loop does")

    t0 = time.time()
    res = compute_loop_production(U, gp, ip, ep, lp, U_loop_np=U_loop,
                                  use_mg=use_mg, mg=mg, mesh=mesh,
                                  precision=args.link_precision,
                                  basis_precision=args.basis_precision,
                                  seed=ep.seed, device=device)
    for i, (lam, r) in enumerate(zip(res.evals, res.resids)):
        log(f"Mugiq: Eval[{i:04d}] = {lam:+.16e} , Residual = {r:+.16e}")
    for i, s in enumerate(res.sigma):
        log(f"Mugiq: Sigma[{i:04d}] = {s:+.16e}")
    if not res.converged:
        log("WARNING: production eigensolve did NOT converge to tolerance")
    log(f"Time for solution = {time.time() - t0:.3f} s")
    print_profile()
    return res


def _run_api(args, U, gp, ip, ep, lp, U_loop, use_mg, mg, device):
    """The JAX CLI's branch without --production: api.compute_loop."""
    from .. import api
    from ..utils import log, phase_timer, print_profile

    t0 = time.time()
    result, eig_res = api.compute_loop(
        U, gp, ip, ep, lp, compute_coarse=args.mugiq_compute_coarse == "yes",
        use_mg=use_mg, mg=mg, U_loop=U_loop, dtype=api_dtype(args),
        device=device)
    eig_res.print_evals()
    coarse_loop = None
    if args.loop_coarse_ulocal == "yes":
        import numpy as np

        from ..mg.coarse_loop import coarse_loop_ulocal
        lam = np.asarray(eig_res.evals).real
        with phase_timer("coarse-loop"):
            coarse_loop = coarse_loop_ulocal(
                eig_res.mg_env, eig_res.evecs, 1.0 / lam, eig_res.geom,
                lp.momenta, int(lp.ft_sign))
        log(f"coarse-space ultra-local loop assembled: shape "
            f"{coarse_loop.shape}, |L|_max = "
            f"{np.abs(coarse_loop).max():.6e}")
    log(f"Time for solution = {time.time() - t0:.3f} s")
    print_profile()
    if coarse_loop is not None:
        return result, eig_res, coarse_loop
    return result, eig_res


def main(argv=None):
    from ..parallel.distributed import shutdown_distributed
    try:
        run(argv)
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
