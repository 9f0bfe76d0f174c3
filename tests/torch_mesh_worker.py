"""One rank of sharded runs of the port, for tests/test_torch_mesh.py:

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tests/torch_mesh_worker.py OUTDIR JOBS.json

JOBS.json lists {"name", "mode" ("loop", "eig", "arnoldi", "loop-pos",
"stoch" or "loop-mg"), "argv"} jobs whose CLI flags share one --mesh
("loop-mg": the MG-deflated loop CLI, its hierarchy written or read by
its own --mg-vec-outfile or --mg-vec-infile; "arnoldi": the
eigensolve CLI's flags, solved for EigOperator.M by
production.compute_evecs_production, which no CLI reaches; "loop-pos":
the loop CLI's flags, run by production.compute_loop_production with
keep_pos and the position-space writer, one file per rank; "stoch": the
loop CLI's lattice, gauge and kappa, the deflated stochastic trace of
stochastic_production on the rank's block, see stoch()).  For each CLI
job the rank checks its sharded operator on a random field against the
single-device operator's block of the same field (M, M^dag, M^dag M: the
full operator for "loop", the packed one for "eig --solve-type
direct-pc"; for "loop" also the bare hop _hop / _hop_dag
against K4's twin on the global field) and the interior/boundary split
against the single pass, bit for bit (with --basis-precision bf16 on a
bf16 field, the operators' outputs bf16); then runs the loop or eigensolve
CLI's run() and writes its results to OUTDIR/<name>.rank<r>.npz.  A "pc"
job also saves its evecs with parallel.distributed.save_evecs_sharded
(OUTDIR/evecs_<name>.proc<r>.npz), loads them back and records whether
the round trip was bitwise and the file's keys.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mugiq_tpu_torch.cli import eigensolve as cli_eig  # noqa: E402
from mugiq_tpu_torch.cli import loop as cli_loop  # noqa: E402
from mugiq_tpu_torch.cli.common import build_mesh, build_params  # noqa: E402
from mugiq_tpu_torch.io.gauge_io import load_gauge_np  # noqa: E402
from mugiq_tpu_torch.kernels.wilson import dslash_hop  # noqa: E402
from mugiq_tpu_torch.lattice import LatticeGeometry  # noqa: E402
from mugiq_tpu_torch.parallel.distributed import (  # noqa: E402
    shutdown_distributed)
from mugiq_tpu_torch.parallel.shard_op import (  # noqa: E402
    ShardedSchurKernelPacked, ShardedWilsonKernel)
from mugiq_tpu_torch.production import (build_kernel_dirac,  # noqa: E402
                                        build_packed_schur)


def op_check(cli, argv):
    """(max rel err of the sharded operator against the single-device
    block, overlap split bit-identical to the single pass, max rel err of
    the bare hop against K4 on the global field (full operator only, else
    0), the field's dtype if every output has it (else "mixed"), mesh).
    The field is bf16 with --basis-precision bf16 (what the operator sees
    of a bf16 basis), then M and M^dag only: M^dag M would compound two
    bf16 roundings."""
    args = cli.parse_args(argv)
    gp, ip, _ = build_params(args)
    mesh, _ = build_mesh(args, gp.dims)
    U = load_gauge_np(args.gauge, LatticeGeometry(gp.dims),
                      seed=args.gauge_seed)
    pc = getattr(args, "solve_type", "direct") == "direct-pc"
    if pc:
        single = build_packed_schur(U, gp, ip, precision=args.link_precision,
                                    device="cpu")
        ops = [ShardedSchurKernelPacked.from_packed_op(mesh, single,
                                                       overlap=o)
               for o in (True, False)]
    else:
        single = build_kernel_dirac(U, gp, ip, precision=args.link_precision,
                                    device="cpu")
        ops = [ShardedWilsonKernel.from_kernel_op(mesh, single, overlap=o)
               for o in (True, False)]
    psi = torch.from_numpy(np.random.default_rng(7).standard_normal(
        single.field_shape).astype(np.float32))
    bf16 = args.basis_precision == "bf16"
    if bf16:
        psi = psi.bfloat16()
    loc = ops[0].place(psi)
    err, same, dtype_ok = 0.0, True, True
    for name in ("M", "Mdag") + (() if bf16 else ("MdagM",)):
        want = mesh.local_block(getattr(single, name)(psi))
        got = [getattr(op, name)(loc) for op in ops]
        err = max(err, float((got[0].float() - want.float()).abs().max()
                             / want.float().abs().max()))
        same = same and torch.equal(got[0], got[1])
        dtype_ok = dtype_ok and got[0].dtype == want.dtype == psi.dtype
    hop_err = 0.0
    if not pc:
        for dagger, name in ((False, "_hop"), (True, "_hop_dag")):
            want = mesh.local_block(dslash_hop(psi, single.U_k, dagger,
                                               single.Y))
            got = [getattr(op, name)(loc) for op in ops]
            hop_err = max(hop_err, float((got[0].float() - want.float())
                                         .abs().max()
                                         / want.float().abs().max()))
            same = same and torch.equal(got[0], got[1])
            dtype_ok = dtype_ok and got[0].dtype == psi.dtype
    return err, same, hop_err, str(psi.dtype) if dtype_ok else "mixed", mesh


def arnoldi(argv, mesh):
    """The Arnoldi eigensolve of M with the eigensolve CLI's flags on the
    mesh (smallest modulus, unfiltered)."""
    from mugiq_tpu_torch.params import EigOperator, Spectrum
    from mugiq_tpu_torch.production import compute_evecs_production

    args = cli_eig.parse_args(argv)
    gp, ip, ep = build_params(args)
    ep.operator, ep.spectrum, ep.use_poly_acc = (EigOperator.M, Spectrum.SM,
                                                 False)
    U = load_gauge_np(args.gauge, LatticeGeometry(gp.dims),
                      seed=args.gauge_seed)
    return compute_evecs_production(U, gp, ip, ep, seed=ep.seed, mesh=mesh,
                                    device=args.device)


# the deflated stochastic trace of the "stoch" job (the JAX test
# test_stochastic_trace_sharded_matches_single's recipe, with a deflation
# space of seeded random vectors): noises, solver tol, maxiter, seed, the
# deflation space's size and eigenvalues
STOCH = dict(n_noise=2, solver_tol=1e-5, solver_maxiter=500, seed=5)
STOCH_EVALS = (0.5, 0.6, 0.7, 0.8)


def stoch_deflation(op, field_shape, mesh=None):
    """The "stoch" job's deflation space: the rank's block (or, without a
    mesh, all) of 4 seeded random kernel-layout vectors of unit norm."""
    from mugiq_tpu_torch.stochastic_production import DeflationSpaceKernel

    V = np.random.default_rng(9).standard_normal(
        (len(STOCH_EVALS),) + tuple(field_shape))
    V /= np.linalg.norm(V.reshape(len(V), -1), axis=1).reshape(
        (-1,) + (1,) * len(field_shape))
    V = torch.from_numpy(V.astype(np.float32))
    if mesh is not None:
        V = mesh.local_block(V, lead=1).contiguous()
    return DeflationSpaceKernel.build(op, V, np.asarray(STOCH_EVALS))


def stoch(argv, mesh):
    """The deflated stochastic trace on this rank's block: the operator's
    block of the global kernel operator of the flags' gauge and kappa."""
    from mugiq_tpu_torch.stochastic_production import (
        stochastic_loop_trace_production)

    args = cli_loop.parse_args(argv)
    gp, ip, _ = build_params(args)
    geom = LatticeGeometry(gp.dims)
    U = load_gauge_np(args.gauge, geom, seed=args.gauge_seed)
    single = build_kernel_dirac(U, gp, ip, device="cpu")
    op = ShardedWilsonKernel.from_kernel_op(mesh, single)
    ds = stoch_deflation(op, single.field_shape, mesh)
    return stochastic_loop_trace_production(op, geom, deflation=ds, **STOCH)


def loop_pos(argv, mesh, out):
    """The loop CLI's flags through compute_loop_production with keep_pos
    and the position-space writer (OUT/pos.proc<r>.h5)."""
    from mugiq_tpu_torch.cli.common import read_momenta_file
    from mugiq_tpu_torch.params import LoopParam
    from mugiq_tpu_torch.production import compute_loop_production

    args = cli_loop.parse_args(argv)
    gp, ip, ep = build_params(args)
    U = load_gauge_np(args.gauge, LatticeGeometry(gp.dims),
                      seed=args.gauge_seed)
    lp = LoopParam(momenta=read_momenta_file(args.momenta_filename),
                   do_nonlocal=True,
                   disp_entries=args.displace_entry_string.split(";"),
                   write_pos_space_hdf5=True, fname_pos_h5=str(out / "pos"))
    return compute_loop_production(U, gp, ip, ep, lp, keep_pos=True,
                                   mesh=mesh, seed=ep.seed,
                                   device=args.device)


def evec_roundtrip(out, name, res, evals, mesh):
    """save_evecs_sharded then load_evecs_sharded of the rank's evecs:
    (bitwise, the file's keys)."""
    from mugiq_tpu_torch.parallel.distributed import (load_evecs_sharded,
                                                      save_evecs_sharded)

    path = save_evecs_sharded(str(out / f"evecs_{name}"), res.evecs, evals,
                              mesh)
    back, ev = load_evecs_sharded(str(out / f"evecs_{name}"), mesh,
                                  device=mesh.device)
    with np.load(path) as z:
        keys = sorted(z.files)
    same = (torch.equal(back, res.evecs.cpu())
            and np.array_equal(ev, np.asarray(evals)))
    return same, keys


def main():
    out = Path(sys.argv[1])
    for job in json.loads(Path(sys.argv[2]).read_text()):
        if job["mode"] in ("loop-pos", "stoch"):
            args = cli_loop.parse_args(job["argv"])
            mesh, _ = build_mesh(args, build_params(args)[0].dims)
            if job["mode"] == "stoch":
                got = {"data": stoch(job["argv"], mesh).numpy()}
            else:
                res = loop_pos(job["argv"], mesh, out)
                got = {"data_pos": res.data_pos, "data_mom": res.data_mom,
                       "n_restarts": res.n_restarts}
            np.savez(out / f"{job['name']}.rank{mesh.rank}.npz", **got)
            continue
        if job["mode"] == "loop-mg":
            res = cli_loop.run(job["argv"])
            rank = torch.distributed.get_rank()
            np.savez(out / f"{job['name']}.rank{rank}.npz",
                     evals=res.evals, resids=res.resids,
                     data_mom=res.data_mom, n_restarts=res.n_restarts,
                     converged=res.converged)
            continue
        cli = cli_loop if job["mode"] == "loop" else cli_eig
        err, same, hop_err, op_dtype, mesh = op_check(cli, job["argv"])
        if job["mode"] == "loop":
            res = cli.run(job["argv"])
            evals, sigma, resids = res.evals, res.sigma, res.resids
            data_mom, shape = res.data_mom, ()
        else:
            res, evals, sigma, resids = (
                cli.run(job["argv"]) if job["mode"] == "eig"
                else arnoldi(job["argv"], mesh))
            data_mom, shape = np.zeros(0), tuple(res.evecs.shape)
        extra = {}
        if job["name"] == "pc":
            same, keys = evec_roundtrip(out, job["name"], res, evals, mesh)
            extra = {"evec_roundtrip": same, "evec_keys": keys}
        np.savez(out / f"{job['name']}.rank{mesh.rank}.npz",
                 evals=np.asarray(evals), sigma=np.asarray(sigma),
                 resids=np.asarray(resids), data_mom=data_mom,
                 n_restarts=res.n_restarts, converged=res.converged,
                 op_err=err, overlap_same=same, hop_err=hop_err,
                 op_dtype=op_dtype,
                 evec_shape=np.asarray(shape),
                 local_dims=np.asarray(mesh.local_dims), **extra)
    shutdown_distributed()


if __name__ == "__main__":
    main()
