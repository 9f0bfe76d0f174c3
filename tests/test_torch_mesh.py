"""The sharded production path (--mesh) of the port on the CPU, over real
ranks: ``python -m torch.distributed.run --standalone --nproc-per-node N``
subprocesses with --device cpu (gloo; tests/torch_mesh_worker.py is each
rank), at (X, Y, Z, T) = (4, 4, 4, 8):

* the loop CLI over --mesh 2 1, 2 2 and 2 2 2 (2, 4 and 8 ranks); the pc
  eigensolve CLI (--solve-type direct-pc) over 2 1 and 2 2 2; one clover
  case (the pc eigensolve, csw 1.1, over 2 2).  The three launches (one
  per mesh) run at once, beside the references.
* Every rank's output against the JAX package's single-device numbers,
  the fp64 validation path converged to 1e-9 on the same gauge (numpy
  weak:0.5, seed 1; kappa 0.13): eigenvalues 1e-5 relative, data_mom 1e-4
  of its max (the tolerances of tests/test_torch_production.py).  n_ev = 4
  ends at a gap of each spectrum (full Wilson 0.05027 | 0.05101, pc Wilson
  0.16415 | 0.16726, pc clover 0.16766 | 0.16923).
* Against the port's own single-device run of the same flags: the same
  restart count on every rank, eigenvalues 1e-6 relative and data_mom 1e-5
  of max (the reductions sum in another order).
* Each rank's sharded operator on a random field against the
  single-device operator's block (1e-6 of max; the same f32 arithmetic
  per site), and the interior/boundary split (overlap=True) against the
  single pass (overlap=False), bit for bit.  On the loop's meshes (2 1,
  2 2, 2 2 2) also the sharded bare hop (ShardedWilsonKernel._hop and
  _hop_dag, K4-halo over the exchange) against K4's twin on the global
  field, 1e-6 of max, split and single pass bit for bit.
* Over 2 1 also the bf16 Krylov basis (--basis-precision bf16; the
  stored bf16 vectors go through the exchange and the halo kernels' twins
  in bf16): the loop CLI with bf16 links (the JAX time_production32
  recipe) and the pc eigensolve CLI with f32 links, tol 1e-3 (a bf16
  basis floors near bf16 eps).  Every rank against the port's
  single-device bf16 run, eigenvalues 1e-3 relative (the basis rounds
  after sums in another order, so the runs agree in eigenvalues, not bit
  for bit), against the JAX fp64 numbers 3e-2 relative (the JAX bound
  for a bf16 basis, tests/test_production.py:317-320), residuals < 0.1,
  data_mom finite; its sharded operator on a bf16 field against the
  single-device operator's block within 2^-7 of max |out|, bf16 out.
* Over 2 1 also block Lanczos (the pc eigensolve CLI with
  --eig-block-size 2: each rank applies the sharded operator to the
  block one vector at a time) and the Krylov-Schur Arnoldi of M
  (compute_evecs_production with EigOperator.M, smallest modulus, which
  no CLI reaches; every inner product reduced over the ranks), each rank
  against the port's single-device run: the same restarts, eigenvalues
  1e-6; block Lanczos also against the JAX pc eigenvalues.
* The MG-deflated loop (--mugiq-use-mg yes; tests/test_torch_mg.py's
  MG, EIG and MOMENTA: three levels, kappa 0.12, with +z:1) over 2 1 and
  2 2 2, and its clover form (csw 1.1) over 2 2, each rank against the
  port's single-device MG run of the same flags (eigenvalues 1e-5
  relative, data_mom 1e-4 of max, the tolerances of test_torch_mg.py,
  which holds that run to JAX; the same restarts on every rank); the
  primary's --mg-vec-outfile against the single-device file: the
  level-1 stencils every rank holds, gathered, within 2e-5 and the basis
  V0, each rank's block of it too, within 2e-6 (test_torch_mg.py's
  STENCIL_ATOL and transfer bound), the coarser level within 2e-5; and a
  second 2 1 run that loads it (--mg-vec-infile) equal to the first bit
  for bit.
* In process: --mesh 1 1 on one rank without a process group equals the
  single-device run (rtol 1e-7), and with a bf16 basis (both CLIs)
  matches the single-device bf16 run in eigenvalues (1e-3); the MG loop
  over --mesh 1 1 built (K7a's twin rounds apart from K1's) and loaded
  from the single-device hierarchy (exactly); the errors (NCCL with
  ranks sharing a card, odd local extents with direct-pc, MG blocks that
  straddle two ranks, bad mesh shapes).
Slow: the same runs against the JAX production path itself
(compute_loop_production / compute_evecs_production, interpret-mode
Pallas; minutes), the bf16 loop against JAX compute_loop_production with
bf16 links and a bf16 basis on a 2-device t mesh (the recipe of
tests/test_flagship_recipes.py test_production_recipe_bf16_mesh), the
Wilson MG runs against JAX compute_loop_production(use_mg=True) on a
(t 4, z 2) mesh of the 8 virtual devices (JAX's bounds,
tests/test_rc_mg.py:160-189).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu_torch.cli import eigensolve as cli_eig
from mugiq_tpu_torch.cli import loop as cli_loop

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DIMS = (4, 4, 4, 8)
MOMENTA = [(0, 0, 0), (1, 0, 0), (0, 1, 1)]
DISP = ["+z:1,2", "-t:1", "+y:1"]
BASE = ["--dims", *map(str, DIMS), "--gauge", "weak:0.5", "--gauge-seed",
        "1", "--kappa", "0.13", "--eig-nev", "4", "--eig-nkr", "16",
        "--eig-tol", "1e-6", "--eig-max-restarts", "100",
        "--eig-use-poly-acc", "--eig-poly-deg", "8", "--production",
        "--device", "cpu"]
# Chebyshev windows above each spectrum's wanted part
LOOP = BASE + ["--eig-amin", "0.09", "--loop-do-nonlocal", "yes",
               "--displace-entry-string", ";".join(DISP)]
PC = BASE + ["--eig-amin", "0.3", "--solve-type", "direct-pc"]
CLOVER = ["--dslash-type", "clover", "--csw", "1.1"]
# the bf16 Krylov basis: tol 1e-3, as a bf16 basis reaches it
BF16_BASIS = ["--basis-precision", "bf16", "--eig-tol", "1e-3",
              "--eig-max-restarts", "30"]
# the MG-deflated loop: tests/test_torch_mg.py's MG, EIG and MOMENTA on
# this file's gauge, with one displacement (K3 on the MG evecs across the
# z edge of 2 2 and 2 2 2)
MG_MOMENTA = [(0, 0, 0), (1, 0, 0)]
MG_LOOP = ["--dims", *map(str, DIMS), "--gauge", "weak:0.5", "--gauge-seed",
           "1", "--kappa", "0.12", "--eig-nev", "4", "--eig-nkr", "16",
           "--eig-tol", "1e-6", "--eig-max-restarts", "200",
           "--mugiq-use-mg", "yes", "--mg-levels", "3", "--mg-block-size",
           "2", "2", "2", "2", "1", "1", "1", "2", "--mg-nvec", "4", "4",
           "--mg-setup-iters", "6", "--loop-do-nonlocal", "yes",
           "--displace-entry-string", "+z:1", "--production", "--device",
           "cpu"]
STENCIL_ATOL = 2e-5
V0_ATOL = 2e-6
# mesh -> jobs (name, mode); one torch.distributed.run per mesh
LAUNCHES = {"2 1": [("loop", "loop"), ("pc", "eig"), ("block", "eig"),
                    ("arnoldi", "arnoldi"), ("loop-bf16", "loop"),
                    ("pc-bf16", "eig"), ("loop-pos", "loop-pos"),
                    ("stoch", "stoch"), ("loop-mg", "loop-mg"),
                    ("loop-mg-load", "loop-mg")],
            "2 2": [("loop", "loop"), ("pc-clover", "eig"),
                    ("loop-mg-clover", "loop-mg")],
            "2 2 2": [("loop", "loop"), ("pc", "eig"),
                      ("loop-mg", "loop-mg")]}
# the f32 CLI runs, held to the single device bit for bit in their
# restarts (the keep_pos loop and the stochastic trace have tests of their
# own)
RUNS = [(m, name) for m, jobs in LAUNCHES.items() for name, mode in jobs
        if not name.endswith("-bf16") and mode in ("loop", "eig", "arnoldi")]
BF16_RUNS = [(m, name) for m, jobs in LAUNCHES.items() for name, _ in jobs
             if name.endswith("-bf16")]
# the MG jobs that build their hierarchy (each writes --mg-vec-outfile)
MG_RUNS = [(m, name) for m, jobs in LAUNCHES.items() for name, mode in jobs
           if mode == "loop-mg" and name != "loop-mg-load"]
# the Arnoldi of M has no JAX reference at this size (a 6144^2 dense eig)
JAX_RUNS = [r for r in RUNS if r[1] != "arnoldi"]
# the unfiltered Arnoldi of M: its smallest-modulus eigenvalues
ARNOLDI = BASE[:BASE.index("--eig-use-poly-acc")] + BASE[
    BASE.index("--eig-poly-deg") + 2:] + ["--eig-nkr", "48"]
# the stochastic trace's lattice, gauge and kappa (JAX
# test_stochastic_trace_sharded_matches_single's, the port's numpy gauge)
STOCH_DIMS = (8, 4, 4, 8)
STOCH = ["--dims", *map(str, STOCH_DIMS), "--gauge", "weak:0.3",
         "--gauge-seed", "33", "--kappa", "0.10", "--production",
         "--device", "cpu"]


def _argv(name, mom):
    loop = LOOP + ["--momenta-filename", str(mom)]
    mg = MG_LOOP + ["--momenta-filename", str(mom.parent / "moms_mg.txt")]
    return {"loop": loop, "pc": PC, "pc-clover": PC + CLOVER,
            "loop-mg": mg, "loop-mg-load": mg, "loop-mg-clover": mg + CLOVER,
            "block": PC + ["--eig-block-size", "2"],
            "arnoldi": ARNOLDI,
            "loop-bf16": loop + BF16_BASIS + ["--link-precision", "bf16"],
            "pc-bf16": PC + BF16_BASIS, "loop-pos": loop,
            "stoch": STOCH}[name]


def _evec_file(out):
    """Where the pc job of a launch writes its evecs (gathered to the
    primary under the mesh)."""
    return out / "evecs.h5"


def _mg_file(out, name):
    """Where an MG job writes its hierarchy (--mg-vec-outfile; the 2 1
    launch's loop-mg-load reads the loop-mg file)."""
    return out / f"{name.replace('-load', '')}.npz"


def _extra_argv(out, name):
    """A job's output flags: the pc job's evecs, the MG jobs' hierarchy."""
    if name == "pc":
        return ["--eig-vec-outfile", str(_evec_file(out))]
    if name == "loop-mg-load":
        return ["--mg-vec-infile", str(_mg_file(out, name))]
    if name.startswith("loop-mg"):
        return ["--mg-vec-outfile", str(_mg_file(out, name))]
    return []


def _gauge():
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    return load_gauge_np("weak:0.5", LatticeGeometry(DIMS), seed=1)


def _jax_refs():
    """The JAX fp64 validation numbers: (loop evals, data_mom), pc evals
    Wilson and clover."""
    from mugiq_tpu import params as jp
    from mugiq_tpu.api import compute_evecs_mugiq, compute_loop

    U = jnp.asarray(_gauge())
    gp = jp.GaugeParam(dims=DIMS)
    lp = jp.LoopParam(momenta=MOMENTA, do_nonlocal=True, disp_entries=DISP)
    res, eig = compute_loop(U, gp, jp.InvertParam(kappa=0.13),
                            jp.EigParam(n_ev=4, n_kr=16, tol=1e-9,
                                        max_restarts=500), lp)
    out = {"loop": (np.sort(eig.evals.real), np.asarray(res.data_mom))}
    for name, clover in (("pc", False), ("pc-clover", True)):
        ip = jp.InvertParam(kappa=0.13, csw=1.1 if clover else 0.0,
                            dslash_type=(jp.DslashType.CLOVER_WILSON
                                         if clover else jp.DslashType.WILSON))
        r = compute_evecs_mugiq(U, gp, ip, jp.EigParam(n_ev=4, n_kr=24,
                                                        tol=1e-9,
                                                        max_restarts=500),
                                even_odd=True)
        out[name] = (np.sort(r.evals.real), None)
    out["block"] = out["pc"]
    return out


def _single_extra(mom, out):
    """The single-device references of the keep_pos loop (its data_pos and
    its position-space file, OUT/pos_single.h5) and of the stochastic
    trace."""
    from torch_mesh_worker import loop_pos, stoch_deflation
    from torch_mesh_worker import STOCH as STOCH_KW

    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.params import GaugeParam, InvertParam
    from mugiq_tpu_torch.production import build_kernel_dirac
    from mugiq_tpu_torch.stochastic_production import (
        stochastic_loop_trace_production)
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np

    d = out / "single"
    d.mkdir()
    res = loop_pos(_argv("loop-pos", mom), None, d)
    geom = LatticeGeometry(STOCH_DIMS)
    op = build_kernel_dirac(load_gauge_np("weak:0.3", geom, seed=33),
                            GaugeParam(dims=STOCH_DIMS),
                            InvertParam(kappa=0.10), device="cpu")
    trace = stochastic_loop_trace_production(
        op, geom, deflation=stoch_deflation(op, op.field_shape), **STOCH_KW)
    return {"loop-pos": (res, d / "pos"), "stoch": trace.numpy()}


def _single_mg(mom, out):
    """The port's single-device MG runs and their hierarchies: {name:
    (result, the --mg-vec-outfile arrays)}."""
    d = out / "single_mg"
    d.mkdir()
    refs = {}
    for name in ("loop-mg", "loop-mg-clover"):
        res = cli_loop.run(_argv(name, mom) + _extra_argv(d, name))
        with np.load(_mg_file(d, name)) as z:
            refs[name] = (res, dict(z))
    return refs


def _single(name, mom):
    """The port's single-device run: (evals, data_mom, restarts, evecs)."""
    argv = _argv(name, mom)
    if name.startswith("loop"):
        r = cli_loop.run(argv)
        return r.evals, r.data_mom, r.n_restarts, None
    if name == "arnoldi":
        from torch_mesh_worker import arnoldi
        res, evals, _, _ = arnoldi(argv, None)
    else:
        res, evals, _, _ = cli_eig.run(argv)
    return evals, None, res.n_restarts, res.evecs.numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the three launches, compute the references meanwhile, then
    load every rank's results: {(mesh, name): [rank dicts]}, refs."""
    d = tmp_path_factory.mktemp("mesh")
    mom = d / "moms.txt"
    mom.write_text("".join(f"{p[0]} {p[1]} {p[2]}\n" for p in MOMENTA))
    (d / "moms_mg.txt").write_text("".join(f"{p[0]} {p[1]} {p[2]}\n"
                                           for p in MG_MOMENTA))
    env = dict(os.environ, MUGIQ_LOG_LEVEL="WARNING", OMP_NUM_THREADS="1")
    procs = {}
    for mesh, jobs in LAUNCHES.items():
        out = d / mesh.replace(" ", "")
        out.mkdir()
        spec = out / "jobs.json"
        spec.write_text(json.dumps([
            {"name": n, "mode": mode,
             "argv": _argv(n, mom) + ["--mesh", *mesh.split()]
             + _extra_argv(out, n)}
            for n, mode in jobs]))
        n = int(np.prod([int(v) for v in mesh.split()]))
        log = open(out / "log.txt", "w")
        procs[mesh] = (subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n),
             str(REPO / "tests" / "torch_mesh_worker.py"), str(out),
             str(spec)], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT), out, n, log)
    try:
        refs = {"jax": _jax_refs(),
                "port": {n: _single(n, mom) for n in ("loop", "pc",
                                                      "pc-clover", "block",
                                                      "arnoldi", "loop-bf16",
                                                      "pc-bf16")},
                "extra": _single_extra(mom, d),
                "mg": _single_mg(mom, d)}
    finally:
        for p, _, _, log in procs.values():
            try:
                p.wait(timeout=600)
            except subprocess.TimeoutExpired:
                p.terminate()           # the launcher stops its ranks
                p.wait(timeout=60)
            log.close()
    got = {}
    for mesh, (p, out, n, _) in procs.items():
        assert p.returncode == 0, (out / "log.txt").read_text()[-4000:]
        for name, mode in LAUNCHES[mesh]:
            got[(mesh, name)] = [dict(np.load(out / f"{name}.rank{r}.npz"))
                                 for r in range(n)]
            if name == "pc":
                got[(mesh, name)][0]["file"] = _evec_file(out)
            if mode == "loop-mg" and name != "loop-mg-load":
                with np.load(_mg_file(out, name)) as z:
                    got[(mesh, name)][0]["mg_file"] = dict(z)
    return got, refs


@pytest.mark.parametrize("run", JAX_RUNS, ids=lambda r: f"{r[1]}-{r[0]}")
def test_mesh_matches_jax_single_device(runs, run):
    got, refs = runs
    evals, data_mom = refs["jax"][run[1]]
    for r, res in enumerate(got[run]):
        assert bool(res["converged"]), r
        np.testing.assert_allclose(res["evals"], evals, rtol=1e-5,
                                   err_msg=f"rank {r}")
        if data_mom is not None:
            assert res["data_mom"].shape == data_mom.shape == (3, 5, 16, 8)
            np.testing.assert_allclose(res["data_mom"], data_mom,
                                       atol=1e-4 * np.abs(data_mom).max(),
                                       err_msg=f"rank {r}")


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[1]}-{r[0]}")
def test_mesh_matches_port_single_device(runs, run):
    """The same restart count on every rank as on one device: every rank
    takes the single device's convergence branch."""
    got, refs = runs
    evals, data_mom, restarts, _ = refs["port"][run[1]]
    for r, res in enumerate(got[run]):
        assert bool(res["converged"]), r
        assert int(res["n_restarts"]) == restarts, r
        np.testing.assert_allclose(res["evals"], evals, rtol=1e-6)
        if data_mom is not None:
            np.testing.assert_allclose(res["data_mom"], data_mom,
                                       atol=1e-5 * np.abs(data_mom).max())


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[1]}-{r[0]}")
def test_mesh_operator_and_overlap(runs, run):
    got, _ = runs
    for res in got[run]:
        assert float(res["op_err"]) <= 1e-6
        assert bool(res["overlap_same"])


@pytest.mark.parametrize("run", [r for r in RUNS if r[1] == "loop"],
                         ids=lambda r: f"{r[1]}-{r[0]}")
def test_mesh_bare_hop(runs, run):
    got, _ = runs
    for res in got[run]:
        assert float(res["hop_err"]) <= 1e-6
        assert bool(res["overlap_same"])


@pytest.mark.parametrize("run", BF16_RUNS, ids=lambda r: f"{r[1]}-{r[0]}")
def test_mesh_bf16_basis(runs, run):
    """The bf16 basis over 2 1: every rank within 1e-3 of the port's
    single-device bf16 run and 3e-2 of the JAX fp64 eigenvalues, max
    residual < 0.1, data_mom finite; the rank's sharded operator on a
    bf16 field within 2^-7 of the single-device operator's block (bf16
    out), the split equal to the single pass."""
    got, refs = runs
    name = run[1]
    evals, data_mom, _, _ = refs["port"][name]
    jax_evals, jax_mom = refs["jax"][name[:-len("-bf16")]]
    for r, res in enumerate(got[run]):
        assert bool(res["converged"]), r
        np.testing.assert_allclose(res["evals"], evals, rtol=1e-3,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(res["evals"], jax_evals, rtol=3e-2,
                                   err_msg=f"rank {r}")
        assert float(np.max(res["resids"])) < 0.1, r
        if jax_mom is not None:
            assert res["data_mom"].shape == jax_mom.shape
            assert np.all(np.isfinite(res["data_mom"])), r
        assert float(res["op_err"]) <= 2.0 ** -7
        assert bool(res["overlap_same"])
        assert str(res["op_dtype"]) == "torch.bfloat16"


@pytest.mark.parametrize("name", ["loop-bf16", "pc-bf16"])
def test_one_rank_mesh_bf16_basis(runs, tmp_path, name):
    """--mesh 1 1 with a bf16 basis in one process, both CLIs: the
    eigenvalues of the single-device bf16 run, 1e-3 relative."""
    mom = tmp_path / "moms.txt"
    mom.write_text("".join(f"{p[0]} {p[1]} {p[2]}\n" for p in MOMENTA))
    argv = _argv(name, mom) + ["--mesh", "1", "1"]
    if name == "loop-bf16":
        res = cli_loop.run(argv)
        evals = res.evals
        assert np.all(np.isfinite(res.data_mom))
    else:
        res, evals, _, _ = cli_eig.run(argv)
    assert res.converged
    np.testing.assert_allclose(evals, runs[1]["port"][name][0], rtol=1e-3)


@pytest.mark.parametrize("run", [r for r in RUNS if r[1] != "loop"],
                         ids=lambda r: f"{r[1]}-{r[0]}")
def test_mesh_evecs_are_rank_blocks(runs, run):
    got, _ = runs
    packed = 1 if run[1] == "arnoldi" else 2
    for res in got[run]:
        X, Yl, Zl, Tl = res["local_dims"]
        assert tuple(res["evec_shape"]) == (4, Tl, 24, Zl,
                                            Yl * X // packed)


@pytest.mark.parametrize("mesh", [m for m, jobs in LAUNCHES.items()
                                  if ("pc", "eig") in jobs])
def test_mesh_evec_outfile_is_the_global_field(runs, mesh):
    """--eig-vec-outfile under a mesh: the primary writes the gathered
    global evecs in the single-device file layout; they span the
    single-device evecs' space (every singular value of the overlap
    within 1e-5 of 1)."""
    from mugiq_tpu_torch.io.gauge_io import load_evecs

    got, refs = runs
    evecs, evals, _, _, _ = load_evecs(str(got[(mesh, "pc")][0]["file"]))
    ref_evals, _, _, ref = refs["port"]["pc"]
    assert evecs.shape == ref.shape == (4, 8, 24, 4, 8)
    np.testing.assert_allclose(np.real(evals), ref_evals, rtol=1e-6)

    def cplx(v):
        return (v[:, :, :12] + 1j * v[:, :, 12:]).reshape(len(v), -1)

    s = np.linalg.svd(cplx(ref).conj() @ cplx(evecs).T, compute_uv=False)
    np.testing.assert_allclose(s, 1.0, atol=1e-5)


def test_mesh_keep_pos_is_the_single_device_data_pos(runs):
    """keep_pos over 2 1 returns the global position-space loops on every
    rank: the single-device data_pos within 1e-5 of its max (the
    tolerance of the sharded loop's data_mom); the ranks' position-space
    files assemble into the g5-mapped data_pos, bit for bit, and into the
    single-device file's data within 1e-5 of its max."""
    import h5py

    from mugiq_tpu_torch.gamma import GAMMA_NAMES
    from mugiq_tpu_torch.io.hdf5io import assemble_loops_hdf5_pos
    from mugiq_tpu_torch.phase import map_gamma_g5

    got, refs = runs
    ref, single_file = refs["extra"]["loop-pos"]
    want = ref.data_pos
    assert want.shape == (5, 16, 8, 4, 4, 4)
    ranks = got[("2 1", "loop-pos")]
    for r, res in enumerate(ranks):
        assert int(res["n_restarts"]) == ref.n_restarts, r
        assert res["data_pos"].shape == want.shape
        np.testing.assert_allclose(res["data_pos"], want,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(res["data_pos"], ranks[0]["data_pos"])
    labels = ["disp_0", "disp_+z_1", "disp_+z_2", "disp_-t_1", "disp_+y_1"]
    # the 2 1 launch's directory, beside the single-device run's
    prefix = str(single_file.parent.parent / "21" / "pos")
    files = assemble_loops_hdf5_pos(prefix, "", labels)
    mapped = map_gamma_g5(torch.from_numpy(ranks[0]["data_pos"])).numpy()
    assert files.tobytes() == mapped.tobytes()
    with h5py.File(single_file) as f:
        g5 = f["disp_+z_2/g5/loop"][()]
    np.testing.assert_allclose(files[2, GAMMA_NAMES.index("g5")],
                               g5[..., 0] + 1j * g5[..., 1],
                               atol=1e-5 * np.abs(g5).max())


@pytest.mark.parametrize("mesh", [m for m, jobs in LAUNCHES.items()
                                  if ("pc", "eig") in jobs])
def test_mesh_evecs_sharded_round_trip(runs, mesh):
    """save_evecs_sharded / load_evecs_sharded on every rank: the rank's
    evecs back bit for bit, under the JAX package's npz keys."""
    got, _ = runs
    for r, res in enumerate(got[(mesh, "pc")]):
        assert bool(res["evec_roundtrip"]), r
        assert sorted(res["evec_keys"]) == ["evals", "global_shape",
                                            "index0", "shard0"]


def test_mesh_stochastic_trace_matches_single_device(runs):
    """stochastic_loop_trace_production on ShardedWilsonKernel over 2 1 at
    (8, 4, 4, 8), deflated: every rank's block of [2, 16, T, Z, Y, X]
    equals the single-device estimate's block (JAX's rtol 1e-4, atol
    1e-5; same noise, reductions in another order)."""
    from mugiq_tpu_torch.parallel.mesh import LatticeMesh

    got, refs = runs
    ref = refs["extra"]["stoch"]
    assert ref.shape == (2, 16, 8, 4, 4, 8)
    for r, res in enumerate(got[("2 1", "stoch")]):
        m = LatticeMesh((2, 1), STOCH_DIMS, rank=r, device="cpu")
        o, lo = m.origin, m.local
        want = ref[:, :, o["t"]:o["t"] + lo["t"], o["z"]:o["z"] + lo["z"],
                   o["y"]:o["y"] + lo["y"]]
        assert res["data"].shape == want.shape
        np.testing.assert_allclose(res["data"], want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"rank {r}")


def test_one_rank_mesh_equals_single_device(tmp_path):
    """--mesh 1 1 in one process without a group: every sharded code path
    but the transfer (halos are local periodic copies)."""
    mom = tmp_path / "moms.txt"
    mom.write_text("".join(f"{p[0]} {p[1]} {p[2]}\n" for p in MOMENTA))
    a = cli_loop.run(_argv("loop", mom))
    b = cli_loop.run(_argv("loop", mom) + ["--mesh", "1", "1"])
    assert a.n_restarts == b.n_restarts
    np.testing.assert_allclose(b.evals, a.evals, rtol=1e-7)
    np.testing.assert_allclose(b.data_mom, a.data_mom,
                               atol=1e-6 * np.abs(a.data_mom).max())


def test_evecs_sharded_files_match_jax(tmp_path):
    """save_evecs_sharded / load_evecs_sharded in one process, rank by rank
    (LatticeMesh geometry without a group): every rank's block back bit
    for bit under the JAX package's keys; a mesh of another shape raises;
    one-rank files pass between the packages both ways."""
    import jax
    from jax.sharding import SingleDeviceSharding

    from mugiq_tpu.parallel import distributed as jdist
    from mugiq_tpu_torch.parallel.distributed import (load_evecs_sharded,
                                                      save_evecs_sharded)
    from mugiq_tpu_torch.parallel.mesh import LatticeMesh

    rng = np.random.default_rng(4)
    V = torch.from_numpy(rng.standard_normal((3, 8, 24, 4, 16)).astype(
        np.float32))
    ev = rng.uniform(size=3)
    prefix = str(tmp_path / "ev")
    for shape in ((2, 1), (2, 2, 2)):
        for r in range(int(np.prod(shape))):
            m = LatticeMesh(shape, DIMS, rank=r, device="cpu")
            blk = m.local_block(V, lead=1).contiguous()
            path = save_evecs_sharded(prefix, blk, ev, m)
            with np.load(path) as z:
                assert sorted(z.files) == ["evals", "global_shape", "index0",
                                           "shard0"]
                assert tuple(z["global_shape"]) == tuple(V.shape)
            got, got_ev = load_evecs_sharded(prefix, m, device="cpu")
            assert torch.equal(got, blk) and np.array_equal(got_ev, ev)
    with pytest.raises(ValueError, match="saving run's shape"):
        load_evecs_sharded(prefix, LatticeMesh((2, 2), DIMS, rank=0,
                                               device="cpu"), device="cpu")
    # one-rank files: JAX's loader reads the port's, and back
    save_evecs_sharded(str(tmp_path / "one"), V, ev)
    arr, jev = jdist.load_evecs_sharded(
        str(tmp_path / "one"), SingleDeviceSharding(jax.devices()[0]))
    assert np.array_equal(np.asarray(arr), V.numpy())
    assert np.array_equal(jev, ev)
    jdist.save_evecs_sharded(str(tmp_path / "jax"), jnp.asarray(V.numpy()),
                             ev)
    got, got_ev = load_evecs_sharded(str(tmp_path / "jax"), device="cpu")
    assert torch.equal(got, V) and np.array_equal(got_ev, ev)


def test_nccl_with_shared_cards_raises(monkeypatch):
    from mugiq_tpu_torch.parallel import distributed as dd

    with pytest.raises(ValueError, match="several ranks on one card"):
        dd.check_backend("nccl", "cuda", 2, 1)
    dd.check_backend("gloo", "cuda", 8, 1)
    dd.check_backend("nccl", "cuda", 2, 2)
    with pytest.raises(ValueError, match="needs CUDA"):
        cli_loop.run(LOOP + ["--mesh", "1", "1", "--dist-backend", "nccl"])
    # two ranks of torch.distributed.run on a one-card host: raises before
    # any process group starts
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="several ranks on one card"):
        dd.init_distributed(backend="nccl", device="cuda")


def test_pc_with_odd_local_extents_raises():
    from mugiq_tpu_torch.params import EigParam, GaugeParam, InvertParam
    from mugiq_tpu_torch.parallel.mesh import LatticeMesh
    from mugiq_tpu_torch.production import compute_evecs_production

    dims = (4, 4, 6, 4)                 # Z = 6 over 2 ranks: Z_loc = 3
    mesh = LatticeMesh((1, 2), dims, device="cpu")
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    U = load_gauge_np("weak:0.5", LatticeGeometry(dims), seed=1)
    with pytest.raises(ValueError, match="even local extents"):
        compute_evecs_production(U, GaugeParam(dims=dims),
                                 InvertParam(kappa=0.13),
                                 EigParam(n_ev=2, n_kr=8), even_odd=True,
                                 mesh=mesh)


@pytest.mark.parametrize("run", MG_RUNS, ids=lambda r: f"{r[1]}-{r[0]}")
def test_mesh_mg_matches_port_single_device(runs, run):
    """The MG loop on every rank: converged, the same restarts on every
    rank, the single-device coarse eigenvalues within 1e-5 relative and
    data_mom within 1e-4 of its max."""
    got, refs = runs
    ref, _ = refs["mg"][run[1]]
    assert ref.converged and ref.data_mom.shape == (2, 2, 16, 8)
    for r, res in enumerate(got[run]):
        assert bool(res["converged"]), r
        assert int(res["n_restarts"]) == int(got[run][0]["n_restarts"]), r
        np.testing.assert_allclose(res["evals"], ref.evals, rtol=1e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(res["data_mom"], ref.data_mom,
                                   atol=1e-4 * np.abs(ref.data_mom).max(),
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("run", MG_RUNS, ids=lambda r: f"{r[1]}-{r[0]}")
def test_mesh_mg_checkpoint_is_the_single_device_file(runs, run, level):
    """--mg-vec-outfile under a mesh: the primary writes the global file
    one device writes.  Level 1: the level-1 stencils (the ones every rank
    holds after the all-gather) within 2e-5 of the single-device ones,
    V0 within 2e-6, and each rank's block of it (local_coarse_block, the
    block the rank's transfer holds) of the rank's coarse extents.
    Level 2: the same keys, geometries and shapes, V1 and the level-2
    stencils within 2e-5."""
    from mugiq_tpu_torch.parallel.mesh import LatticeMesh

    got, refs = runs
    _, want = refs["mg"][run[1]]
    z = got[run][0]["mg_file"]
    if level == 2:
        assert sorted(z) == sorted(want)
        for k in want:
            assert z[k].shape == want[k].shape, k
            if k.startswith(("geom", "nsnc", "n_level")):
                np.testing.assert_array_equal(z[k], want[k], err_msg=k)
        for k in ["V1", "D1"] + [f"{y}1_{mu}" for y in ("Yp", "Ym")
                                 for mu in range(4)]:
            np.testing.assert_allclose(z[k], want[k], atol=STENCIL_ATOL,
                                       err_msg=k)
        return
    for k in ["D0"] + [f"{y}0_{mu}" for y in ("Yp", "Ym") for mu in range(4)]:
        np.testing.assert_allclose(z[k], want[k], atol=STENCIL_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(z["V0"], want["V0"], atol=V0_ATOL)
    shape = tuple(int(v) for v in run[0].split())
    for r in range(len(got[run])):
        m = LatticeMesh(shape, DIMS, rank=r, device="cpu")
        block = m.local_coarse_block(z["V0"])
        # coarse (Tc, Zc, Yc) = (4, 2, 2), split as the lattice
        assert block.shape[:3] == (4 // shape[0], 2 // shape[1],
                                   2 // (shape + (1,))[2]), r
        np.testing.assert_allclose(block, m.local_coarse_block(want["V0"]),
                                   atol=V0_ATOL, err_msg=f"rank {r}")


def test_mesh_mg_checkpoint_reloads_bit_for_bit(runs):
    """The 2 1 launch's second MG run loads the first's file
    (--mg-vec-infile: no smoothing, no probes) and reproduces its
    eigenvalues and data_mom on every rank bit for bit."""
    got, _ = runs
    built, loaded = got[("2 1", "loop-mg")], got[("2 1", "loop-mg-load")]
    for r, (a, b) in enumerate(zip(built, loaded)):
        assert int(a["n_restarts"]) == int(b["n_restarts"]), r
        np.testing.assert_array_equal(b["evals"], a["evals"])
        np.testing.assert_array_equal(b["data_mom"], a["data_mom"])


def test_one_rank_mesh_mg_equals_single_device(runs, tmp_path, caplog):
    """The MG loop over --mesh 1 1 in one process: built on the one-rank
    sharded operator, the single device's restarts, eigenvalues within
    1e-6 and data_mom within 1e-5 of max (K7a's twin rounds apart from
    K1's, ~5e-7 of max |M psi|, through the smoothing); loaded from the
    single-device hierarchy file, exactly the single-device run (the
    replicated coarse eigensolve, the prolongation and the sharded
    measurement); --loop-coarse-ulocal yes logged as a no-op."""
    import logging

    ref, hierarchy = runs[1]["mg"]["loop-mg"]
    (tmp_path / "moms_mg.txt").write_text(
        "".join(f"{p[0]} {p[1]} {p[2]}\n" for p in MG_MOMENTA))
    argv = _argv("loop-mg", tmp_path / "moms.txt") + ["--mesh", "1", "1"]
    with caplog.at_level(logging.INFO, logger="mugiq_tpu_torch"):
        built = cli_loop.run(argv + ["--loop-coarse-ulocal", "yes"])
    assert "the production loop ignores it" in caplog.text
    assert built.n_restarts == ref.n_restarts
    np.testing.assert_allclose(built.evals, ref.evals, rtol=1e-6)
    np.testing.assert_allclose(built.data_mom, ref.data_mom,
                               atol=1e-5 * np.abs(ref.data_mom).max())
    np.savez(tmp_path / "single.npz", **hierarchy)
    loaded = cli_loop.run(argv + ["--mg-vec-infile",
                                  str(tmp_path / "single.npz")])
    assert loaded.n_restarts == ref.n_restarts
    np.testing.assert_array_equal(loaded.evals, ref.evals)
    np.testing.assert_array_equal(loaded.data_mom, ref.data_mom)


@pytest.mark.parametrize("shape, block, axis, local", [
    ((2, 1), (2, 2, 2, 8), "t", 4), ((1, 2), (2, 2, 4, 2), "z", 2),
    ((1, 1, 2), (2, 4, 2, 2), "y", 2)])
def test_mg_block_straddling_ranks_raises(shape, block, axis, local):
    """Under a mesh an MG block must lie inside one rank's block: a block
    that divides the global extent but not the local one raises before
    any exchange, naming the mesh axis, the local extent and the block;
    the block of the MG jobs (2^4) passes on the same mesh."""
    import re

    from mugiq_tpu_torch.mg.kernel_mg import check_blocks_divide
    from mugiq_tpu_torch.params import (EigParam, GaugeParam, InvertParam,
                                        LoopParam, MGParam)
    from mugiq_tpu_torch.parallel.mesh import LatticeMesh
    from mugiq_tpu_torch.production import compute_loop_production

    mesh = LatticeMesh(shape, DIMS, rank=0, device="cpu")
    match = (re.escape(str(block)) + f".*mesh axis {axis} the local extent "
             f"{local} .*block's {block['xyzt'.index(axis)]}")
    with pytest.raises(ValueError, match=match):
        compute_loop_production(
            _gauge(), GaugeParam(dims=DIMS), InvertParam(kappa=0.12),
            EigParam(n_ev=2, n_kr=8), LoopParam(), use_mg=True,
            mg=MGParam(n_level=2, geo_block_size=[block], n_vec=[4]),
            mesh=mesh, device="cpu")
    check_blocks_divide(mesh, (2, 2, 2, 2))


@pytest.mark.parametrize("shape, match", [
    ((2,), "2 or 3"), ((2, 2, 2, 1), "2 or 3"), ((3, 1), "does not divide"),
    ((1, 0), "2 or 3")])
def test_bad_mesh_shapes_raise(shape, match):
    from mugiq_tpu_torch.parallel.mesh import LatticeMesh
    with pytest.raises(ValueError, match=match):
        LatticeMesh(shape, DIMS)


def test_mesh_geometry_matches_jax_rank_order():
    """Rank (it*nz + iz)*ny + iy, as the JAX device array reshaped to the
    mesh shape; blocks tile the lattice; neighbours wrap."""
    from jax.sharding import Mesh as JMesh

    from mugiq_tpu_torch.parallel.mesh import LatticeMesh

    shape = (2, 2, 2)
    ids = np.arange(8).reshape(shape)
    assert JMesh(np.asarray(ids, dtype=object), ("t", "z", "y")).devices \
        .tolist() == ids.tolist()
    field = torch.arange(8 * 24 * 4 * 16.).reshape(8, 24, 4, 16)
    seen = torch.zeros_like(field)
    for r in range(8):
        m = LatticeMesh(shape, DIMS, rank=r)
        it, iz, iy = np.argwhere(ids == r)[0]
        assert (m.coords["t"], m.coords["z"], m.coords["y"]) == (it, iz, iy)
        seen[m._block(field.shape, 0, r)] += 1
        assert m.neighbours("t") == (ids[(it - 1) % 2, iz, iy],
                                     ids[(it + 1) % 2, iz, iy])
    assert torch.equal(seen, torch.ones_like(field))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["loop", "pc"])
def test_mesh_matches_jax_production(runs, name):
    """JAX compute_loop_production / compute_evecs_production (f32,
    interpret-mode Pallas) on the same gauge and recipe: evals 1e-5,
    data_mom 1e-4 of max, for every rank of every mesh."""
    from mugiq_tpu import params as jp
    from mugiq_tpu.production import (compute_evecs_production,
                                      compute_loop_production)

    gp = jp.GaugeParam(dims=DIMS)
    ip = jp.InvertParam(kappa=0.13)
    if name == "loop":
        ep = jp.EigParam(n_ev=4, n_kr=16, tol=1e-6, max_restarts=100,
                         use_poly_acc=True, poly_deg=8, a_min=0.09)
        lp = jp.LoopParam(momenta=MOMENTA, do_nonlocal=True,
                          disp_entries=DISP)
        ref = compute_loop_production(_gauge(), gp, ip, ep, lp)
        evals, data_mom = ref.evals, ref.data_mom
    else:
        ep = jp.EigParam(n_ev=4, n_kr=16, tol=1e-6, max_restarts=100,
                         use_poly_acc=True, poly_deg=8, a_min=0.3)
        _, evals, _, _ = compute_evecs_production(_gauge(), gp, ip, ep,
                                                  even_odd=True)
        data_mom = None
    got, _ = runs
    for run in [r for r in RUNS if r[1] == name]:
        for res in got[run]:
            np.testing.assert_allclose(res["evals"], evals, rtol=1e-5)
            if data_mom is not None:
                np.testing.assert_allclose(
                    res["data_mom"], data_mom,
                    atol=1e-4 * np.abs(data_mom).max())


@pytest.mark.slow
def test_mesh_bf16_matches_jax_production(runs):
    """JAX compute_loop_production with precision="bf16",
    basis_precision="bf16" on a 2-device 't' mesh (interpret-mode Pallas
    halo kernels on bf16 spinors), the loop-bf16 recipe: every rank of the
    port's 2 1 run within 3e-2 of its eigenvalues (the JAX bound for a
    bf16 basis), data_mom finite of the same shape."""
    import jax
    from jax.sharding import Mesh

    from mugiq_tpu import params as jp
    from mugiq_tpu.production import compute_loop_production

    ep = jp.EigParam(n_ev=4, n_kr=16, tol=1e-3, max_restarts=30,
                     use_poly_acc=True, poly_deg=8, a_min=0.09)
    lp = jp.LoopParam(momenta=MOMENTA, do_nonlocal=True, disp_entries=DISP)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("t",))
    ref = compute_loop_production(_gauge(), jp.GaugeParam(dims=DIMS),
                                  jp.InvertParam(kappa=0.13), ep, lp,
                                  mesh=mesh, precision="bf16",
                                  basis_precision="bf16")
    got, _ = runs
    for r, res in enumerate(got[("2 1", "loop-bf16")]):
        np.testing.assert_allclose(res["evals"], np.asarray(ref.evals),
                                   rtol=3e-2, err_msg=f"rank {r}")
        assert res["data_mom"].shape == np.asarray(ref.data_mom).shape
        assert np.all(np.isfinite(res["data_mom"]))


@pytest.mark.slow
def test_mesh_mg_matches_jax_production(runs):
    """JAX compute_loop_production(use_mg=True) on a (t 4, z 2) mesh of the
    8 virtual devices (its sharded smoothing, probes and measurement;
    interpret-mode Pallas), the Wilson MG recipe: every rank of the port's
    2 1 and 2 2 2 runs within JAX's bounds for its sharded MG loop against
    its unsharded one (tests/test_rc_mg.py:160-189): eigenvalues rtol
    1e-4, data_mom rtol 5e-3, atol 2e-3."""
    import jax
    from jax.sharding import Mesh

    from mugiq_tpu import params as jp
    from mugiq_tpu.production import compute_loop_production

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("t", "z"))
    ref = compute_loop_production(
        _gauge(), jp.GaugeParam(dims=DIMS), jp.InvertParam(kappa=0.12),
        jp.EigParam(n_ev=4, n_kr=16, tol=1e-6, max_restarts=200),
        jp.LoopParam(momenta=MG_MOMENTA, do_nonlocal=True,
                     disp_entries=["+z:1"]),
        use_mg=True, mg=jp.MGParam(n_level=3,
                                   geo_block_size=[(2, 2, 2, 2),
                                                   (1, 1, 1, 2)],
                                   n_vec=[4, 4], setup_iters=6),
        mesh=mesh)
    assert ref.converged
    got, _ = runs
    for run in [r for r in MG_RUNS if r[1] == "loop-mg"]:
        for r, res in enumerate(got[run]):
            np.testing.assert_allclose(res["evals"], np.asarray(ref.evals),
                                       rtol=1e-4, err_msg=f"{run} rank {r}")
            np.testing.assert_allclose(res["data_mom"],
                                       np.asarray(ref.data_mom), rtol=5e-3,
                                       atol=2e-3, err_msg=f"{run} rank {r}")
