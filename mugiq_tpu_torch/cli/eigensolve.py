"""Eigensolve CLI on the GPU (port of mugiq_tpu.cli.eigensolve, the
tests/eigensolve.cpp program analog).

As the JAX CLI, it runs the production path with --production and the
API path (api.compute_evecs_mugiq / compute_evecs_mugiq_mg, complex
fields) without it.  The production path:

    python -m mugiq_tpu_torch.cli.eigensolve --dims 32 32 32 64 \
        --gauge random --gauge-seed 1 --kappa 0.12 --eig-nev 8 \
        --eig-nkr 24 --eig-tol 1e-5 --eig-max-restarts 30 \
        --eig-use-poly-acc --eig-poly-deg 16 --eig-amin 0.5 \
        --solve-type direct-pc --production

--solve-type direct eigensolves MdagM of the full operator (K1),
direct-pc that of the packed even-odd preconditioned operator (K6).
--mesh NT NZ [NY] runs the sharded solve, one process per rank, with the
halo-extended kernels (K7a, K7b):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m mugiq_tpu_torch.cli.eigensolve ... --solve-type direct-pc \
        --production --mesh 2 1

--basis-precision bf16 stores the Krylov basis in bf16, on one device
and under --mesh (K7a or K7b then take bf16 spinors);
--eig-block-size B > 1 runs block Lanczos with one batched launch per
block step (under --mesh, one vector at a time).  The production path
reads neither --prec (f32; double is logged) nor the MG flags, as in the
JAX CLI.

The API path runs in complex64 (--prec single) or complex128 (--prec
double) on one device (--mesh is a usage error there): the full or the
masked even-even Schur operator (--solve-type), or with --mugiq-use-mg
yes --mugiq-compute-coarse yes the MG coarse operator:

    python -m mugiq_tpu_torch.cli.eigensolve --dims 8 8 8 16 \
        --gauge weak:0.5 --gauge-seed 1 --kappa 0.13 --eig-nev 4 \
        --eig-nkr 24 --eig-tol 1e-10 --prec double --mugiq-use-mg yes \
        --mg-block-size 2 2 2 2 --mg-nvec 6 --mg-setup-iters 6

The parser defines every flag of the JAX CLI with its choices and
default, so each of its invocations parses here.  --platform,
--compile-cache and --autotune drive JAX-only machinery and are logged
with no other effect.
"""

import argparse
import sys
import time

import numpy as np

from .common import (MESH_NEEDS_PRODUCTION, add_dirac_args, add_eig_args,
                     add_lattice_args, add_mg_args, add_parallel_args,
                     add_production_args, api_dtype, build_mesh,
                     build_mg_param, build_params, log_jax_only,
                     log_production_prec, quiet_unless_primary)


def _parser():
    p = argparse.ArgumentParser(
        prog="mugiq-eigensolve-torch",
        description="Eigenpairs of the Dirac operator on a CUDA device "
                    "(computeEvecsMuGiq)")
    add_lattice_args(p)
    add_dirac_args(p)
    add_eig_args(p)
    add_mg_args(p)
    add_production_args(p.add_argument_group("production"))
    add_parallel_args(p)
    return p


def parse_args(argv=None):
    return _parser().parse_args(argv)


def run(argv=None):
    """Parse, eigensolve, log as the JAX CLI does, save or load the evecs;
    returns (result, evals, sigma, resids): the production path's
    LanczosResult or the API path's EigsolveResult.  With
    --eig-vec-infile it loads the checkpoint instead of solving and the
    first item is None."""
    p = _parser()
    args = p.parse_args(argv)
    if args.mesh is not None and not args.production:
        p.error(MESH_NEEDS_PRODUCTION)

    from ..io.gauge_io import load_evecs, load_gauge_np, plaquette, save_evecs
    from ..lattice import LatticeGeometry
    from ..production import compute_evecs_production
    from ..utils import log, print_profile

    gp, ip, ep = build_params(args)
    mesh, device = build_mesh(args, gp.dims)
    quiet_unless_primary(mesh)
    geom = LatticeGeometry(gp.dims)
    U = load_gauge_np(args.gauge, geom, seed=args.gauge_seed)
    tot, sp, tm = plaquette(U, device)
    log(f"Computed plaquette is {tot:.8f} "
        f"(spatial = {sp:.8f}, temporal = {tm:.8f})")

    if args.eig_vec_infile:
        evecs, evals, sigma, resids, attrs = load_evecs(args.eig_vec_infile)
        log(f"Loaded {evecs.shape[0]} eigenvectors from "
            f"{args.eig_vec_infile} (attrs: {dict(attrs)})")
        for i, lam in enumerate(evals):
            lam = complex(lam)
            log(f"Mugiq: Eval[{i:04d}] = {lam.real:+.16e} {lam.imag:+.16e}")
        return None, evals, sigma, resids

    log_jax_only(args)
    if not args.production:
        return _run_api(args, U, gp, ip, ep, geom, device)
    log_production_prec(args)
    if args.mugiq_use_mg == "yes":
        log("--mugiq-use-mg yes: the production eigensolve solves the fine "
            "operator, as the JAX CLI's does; drop --production for the MG "
            "coarse eigensolve")
    t0 = time.time()
    res, evals, sigma, resids = compute_evecs_production(
        U, gp, ip, ep, seed=ep.seed, precision=args.link_precision,
        even_odd=args.solve_type == "direct-pc",
        basis_precision=args.basis_precision, mesh=mesh, device=device)
    if not res.converged:
        log("WARNING: production eigensolve did NOT converge to tolerance")
    for i in range(len(evals)):
        lam = complex(evals[i])
        log(f"Mugiq: Eval[{i:04d}] = {lam.real:+.16e} "
            f"{lam.imag:+.16e} , Residual = {resids[i]:+.16e}")
    for i in range(len(sigma)):
        log(f"Mugiq: Sigma[{i:04d}] = {sigma[i]:+.16e}")
    log(f"Time for solution = {time.time() - t0:.3f} s")
    print_profile()
    if args.eig_vec_outfile:
        # under a mesh the ranks' blocks are gathered and the primary
        # writes the single-device file
        evecs = (res.evecs if mesh is None
                 else mesh.gather_field(res.evecs, lead=1))
        if mesh is None or mesh.is_primary:
            save_evecs(args.eig_vec_outfile, evecs.cpu().numpy(), evals,
                       sigma=sigma, resids=np.asarray(resids),
                       attrs={"dims": str(geom.dims), "kappa": str(ip.kappa),
                              "layout": "kernel-realpair"})
            log(f"Eigenvectors saved to {args.eig_vec_outfile}")
        del evecs
    return res, evals, sigma, resids


def _run_api(args, U, gp, ip, ep, geom, device):
    """The JAX CLI's branch without --production."""
    from .. import api
    from ..io.gauge_io import save_evecs
    from ..utils import log, print_profile

    t0 = time.time()
    dtype = api_dtype(args)
    if args.mugiq_use_mg == "yes" and args.mugiq_compute_coarse == "yes":
        res = api.compute_evecs_mugiq_mg(U, gp, ip, ep, build_mg_param(args),
                                         dtype=dtype, device=device)
    else:
        res = api.compute_evecs_mugiq(
            U, gp, ip, ep, even_odd=args.solve_type == "direct-pc",
            dtype=dtype, device=device)
    res.print_evals()
    log(f"Time for solution = {time.time() - t0:.3f} s")
    print_profile()
    if args.eig_vec_outfile:
        save_evecs(args.eig_vec_outfile, res.evecs.cpu().numpy(), res.evals,
                   sigma=res.sigma, resids=res.output.resids,
                   attrs={"dims": str(geom.dims), "kappa": str(ip.kappa)})
        log(f"Eigenvectors saved to {args.eig_vec_outfile}")
    return res, res.evals, res.sigma, res.output.resids


def main(argv=None):
    from ..parallel.distributed import shutdown_distributed
    try:
        run(argv)
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
