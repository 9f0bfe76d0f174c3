"""Shared CLI flags (port of the flags mugiq_tpu.cli.common gives the
loop and the eigensolve, with the multigrid and parallel flags), plus
--device and --dist-backend.  Both CLIs define every flag of their JAX
counterparts with the same choices and defaults; flags that drive
JAX-only machinery are accepted and logged (log_jax_only).

As in the JAX CLIs, --production runs the production path (the kernel
layout, f32 or bf16) and its absence the API path (api.py, complex64 for
--prec single or complex128 for --prec double).  The API path runs on
one device: --mesh without --production is a usage error (the JAX API
branch ignores --mesh).
"""

import argparse

from ..params import (DslashType, EigOperator, EigParam, GaugeParam,
                      InvertParam, MassNormalization, MGParam, Spectrum)


def add_lattice_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("lattice")
    g.add_argument("--dims", type=int, nargs=4, metavar=("X", "Y", "Z", "T"),
                   default=[8, 8, 8, 16], help="global lattice dims")
    g.add_argument("--gauge", default="weak:0.2",
                   help="gauge source: unit | random | weak[:eps] | "
                        "<nersc file>")
    g.add_argument("--gauge-seed", type=int, default=0)
    g.add_argument("--periodic-t", action="store_true",
                   help="periodic (instead of antiperiodic) fermion time BC")
    g.add_argument("--prec", choices=["single", "double"], default="single",
                   help="the API path's precision: complex64 or "
                        "complex128 (the production path runs f32)")
    g.add_argument("--platform", default=None,
                   help="the JAX platform override: accepted, no effect "
                        "(the port runs on --device)")
    g.add_argument("--compile-cache", choices=["yes", "no"], default="yes",
                   help="the JAX executable cache: accepted, no effect "
                        "(PyTorch runs eagerly)")
    g.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); cuda without "
                        "CUDA is an error")


def add_dirac_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("dirac operator")
    g.add_argument("--dslash-type", choices=["wilson", "clover"],
                   default="wilson")
    g.add_argument("--kappa", type=float, default=None)
    g.add_argument("--mass", type=float, default=None)
    g.add_argument("--csw", type=float, default=1.0, help="clover coefficient")
    g.add_argument("--anisotropy", type=float, default=1.0)
    g.add_argument("--mass-normalization", choices=["kappa", "mass"],
                   default="kappa")
    g.add_argument("--solve-type", choices=["direct", "direct-pc"],
                   default="direct",
                   help="direct-pc eigensolves the even-odd preconditioned "
                        "operator (QUDA_DIRECT_PC_SOLVE analog)")


def add_eig_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("eigensolver")
    g.add_argument("--eig-nev", type=int, default=16)
    g.add_argument("--eig-nkr", type=int, default=48)
    g.add_argument("--eig-tol", type=float, default=1e-8)
    g.add_argument("--eig-max-restarts", type=int, default=200)
    g.add_argument("--eig-spectrum", choices=["SR", "LR"], default="SR")
    g.add_argument("--eig-operator", choices=["MdagM", "MMdag"],
                   default="MdagM")
    g.add_argument("--eig-use-poly-acc", action="store_true")
    g.add_argument("--eig-poly-deg", type=int, default=50)
    g.add_argument("--eig-amin", type=float, default=0.1)
    g.add_argument("--eig-amax", type=float, default=0.0,
                   help="0 = auto-estimate")
    g.add_argument("--eig-seed", type=int, default=1234,
                   help="seed of the eigensolver's start vector")
    g.add_argument("--eig-block-size", type=int, default=1,
                   help="block thick-restart Lanczos block size (>1: one "
                        "batched operator launch per block step)")
    g.add_argument("--eig-vec-outfile", default="",
                   help="save eigenvectors/values (HDF5)")
    g.add_argument("--eig-vec-infile", default="",
                   help="load eigenvectors/values instead of solving "
                        "(checkpoint resume)")


def add_parallel_args(p: argparse.ArgumentParser):
    g = p.add_argument_group(
        "parallel (the reference's --gridsize / initComms, "
        "tests/eigensolve.cpp:683)")
    g.add_argument("--mesh", type=int, nargs="+", default=None, metavar="N",
                   help="rank grid over the (t, z[, y]) lattice axes, e.g. "
                        "--mesh 2 1, one process per rank; launch with "
                        "python -m torch.distributed.run --nproc-per-node N")
    g.add_argument("--dist-coordinator", default=None,
                   help="host:port of the process group's rendezvous "
                        "(omit under torch.distributed.run)")
    g.add_argument("--dist-num-processes", type=int, default=None)
    g.add_argument("--dist-process-id", type=int, default=None)
    g.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl for cuda, gloo for cpu; ranks that "
                        "share a card need gloo")


def add_production_args(g):
    """The production flags both JAX CLIs define (--production, --autotune,
    --link-precision, --basis-precision)."""
    g.add_argument("--production", action="store_true",
                   help="run the production path (kernel layout, f32, the "
                        "hand-written CUDA kernels) instead of the complex "
                        "API path")
    g.add_argument("--autotune", action="store_true",
                   help="the JAX variant autotuner: accepted, no effect "
                        "(one kernel per operator, nothing to tune)")
    g.add_argument("--link-precision", choices=("f32", "bf16"),
                   default="f32",
                   help="link/clover storage precision (arithmetic f32)")
    g.add_argument("--basis-precision", choices=("f32", "bf16"),
                   default="f32",
                   help="Krylov-basis storage precision (bf16: the stored "
                        "vectors feed the operator as they are; arithmetic "
                        "f32; deflation-grade residuals)")


#: flags that drive JAX-only machinery, with their defaults
_JAX_ONLY = (("platform", None), ("compile_cache", "yes"),
             ("autotune", False), ("loop_calc_type", "opt"))


def log_jax_only(args, production: bool = True) -> None:
    """Log, once, the JAX-only flags given at other than their default
    (the platform override, the executable cache, the variant autotuner,
    and on the production path the loop's calc type, which the API path
    reads): the port accepts them and has nothing for them to do."""
    from ..utils import log

    given = [f"--{k.replace('_', '-')} {getattr(args, k)}"
             for k, d in _JAX_ONLY if getattr(args, k, d) != d
             and (production or k != "loop_calc_type")]
    if given:
        log(f"{', '.join(given)}: JAX-only machinery, accepted with no "
            f"effect here")


MESH_NEEDS_PRODUCTION = ("--mesh runs the production path only: give "
                         "--production (the API path, without it, runs on "
                         "one device)")


def api_dtype(args):
    """The API path's complex dtype for --prec."""
    import torch
    return torch.complex128 if args.prec == "double" else torch.complex64


def log_production_prec(args) -> None:
    """The production path reads no --prec (as in the JAX CLIs): say so
    once when double is asked for."""
    if args.prec == "double":
        from ..utils import log
        log("--prec double: the production path computes in f32 (as the "
            "JAX CLI's does); drop --production for complex128")


def build_mesh(args, dims):
    """Start the process group (if the flags or torch.distributed.run ask
    for one) and build this rank's LatticeMesh; returns (mesh or None, the
    rank's device).  Without --mesh nothing is started."""
    from ..utils import resolve_device

    if args.mesh is None:
        return None, resolve_device(args.device)
    from ..parallel.distributed import init_distributed
    from ..parallel.mesh import make_lattice_mesh

    dev = init_distributed(args.dist_coordinator, args.dist_num_processes,
                           args.dist_process_id, args.dist_backend,
                           device=args.device)
    return make_lattice_mesh(args.mesh, dims, device=dev), dev


def quiet_unless_primary(mesh) -> None:
    """Only the primary rank logs (the Mugiq:, timing and PROFILE lines)."""
    import logging
    if mesh is not None and not mesh.is_primary:
        logging.getLogger("mugiq_tpu_torch").setLevel(logging.WARNING)


def add_mg_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("multigrid")
    g.add_argument("--mugiq-use-mg", choices=["yes", "no"], default="no")
    g.add_argument("--mugiq-compute-coarse", choices=["yes", "no"],
                   default="yes",
                   help="with --mugiq-use-mg yes on the API path: eigensolve "
                        "the coarse operator (no: the fine one); the "
                        "production MG path always eigensolves the coarse "
                        "operator")
    g.add_argument("--mg-levels", type=int, default=2)
    g.add_argument("--mg-block-size", type=int, nargs="+",
                   default=[4, 4, 4, 4], metavar="B",
                   help="geo block per level, 4 ints per level")
    g.add_argument("--mg-nvec", type=int, nargs="+", default=[24])
    g.add_argument("--mg-setup-iters", type=int, default=50)
    g.add_argument("--mg-vec-outfile", default="",
                   help="save the built MG hierarchy (transfer bases + "
                        "Galerkin stencils, npz; mg_vec_outfile analog)")
    g.add_argument("--mg-vec-infile", default="",
                   help="load a saved hierarchy instead of running the "
                        "null-vector setup (mg_vec_infile analog)")


def build_mg_param(args) -> MGParam:
    n_coarse = args.mg_levels - 1
    if n_coarse < 1:
        raise ValueError(f"--mg-levels {args.mg_levels}: at least 2")
    bs = args.mg_block_size
    if len(bs) == 4:
        blocks = [tuple(bs)] * n_coarse
    elif len(bs) == 4 * n_coarse:
        blocks = [tuple(bs[4 * i:4 * i + 4]) for i in range(n_coarse)]
    else:
        raise ValueError(f"--mg-block-size needs 4 ints per level "
                         f"({4 * n_coarse}), got {len(bs)}")
    nv = args.mg_nvec
    if len(nv) == 1:
        nv = nv * n_coarse
    elif len(nv) != n_coarse:
        raise ValueError(f"--mg-nvec needs 1 or {n_coarse} values")
    return MGParam(n_level=args.mg_levels, geo_block_size=blocks,
                   n_vec=list(nv), setup_iters=args.mg_setup_iters,
                   vec_outfile=args.mg_vec_outfile,
                   vec_infile=args.mg_vec_infile)


def build_params(args):
    gp = GaugeParam(dims=tuple(args.dims), antiperiodic_t=not args.periodic_t,
                    anisotropy=args.anisotropy)
    kappa, mass = args.kappa, args.mass
    if kappa is None and mass is None:
        kappa = 0.12
    ip = InvertParam(
        dslash_type=(DslashType.CLOVER_WILSON if args.dslash_type == "clover"
                     else DslashType.WILSON),
        kappa=kappa, mass=mass, csw=args.csw, anisotropy=args.anisotropy,
        mass_normalization=(MassNormalization.MASS
                            if args.mass_normalization == "mass"
                            else MassNormalization.KAPPA))
    ep = EigParam(n_ev=args.eig_nev, n_kr=args.eig_nkr, tol=args.eig_tol,
                  max_restarts=args.eig_max_restarts,
                  spectrum=Spectrum[args.eig_spectrum],
                  operator=EigOperator[args.eig_operator],
                  use_poly_acc=args.eig_use_poly_acc,
                  poly_deg=args.eig_poly_deg, a_min=args.eig_amin,
                  a_max=args.eig_amax, seed=args.eig_seed,
                  block_size=args.eig_block_size)
    return gp, ip, ep


def read_momenta_file(path: str):
    """Momenta file: one 'px py pz' triple per line (tests/loop.cpp:723-746)."""
    moms = []
    with open(path) as f:
        for i, line in enumerate(f):
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 3:
                raise ValueError(f"{path}: bad momenta line {i}: {line!r}")
            moms.append(tuple(int(x) for x in parts[:3]))
    if not moms:
        raise ValueError(f"{path}: no momenta found")
    return moms
