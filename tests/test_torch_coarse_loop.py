"""The coarse-space ultra-local loop of the port
(mugiq_tpu_torch.mg.coarse_loop) against the JAX package's, on the CPU.

The MG pieces are carried across as in tests/test_torch_api_mg.py: the
JAX null vectors (inverse iteration on the JAX fine operator) build both
packages' transfers, and MGEnv([...], [transfer], params) wraps them.
Random coarse vectors stand in for the coarse eigenvectors, because the
loop is linear in each of them.  Tolerances (max |port - ref| / max
|ref|, complex128): against JAX coarse_loop_ulocal 1e-12; against the
fine factorized formula of tests/test_coarse_loop.py (R = P^dag) 1e-12;
the one-time-row restriction against the full one 1e-13.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu import params as jp
from mugiq_tpu.dirac import make_dirac as jax_make
from mugiq_tpu.lattice import LatticeGeometry as JGeom
from mugiq_tpu.mg import coarse_loop as jcl
from mugiq_tpu.mg import mg as jmg
from mugiq_tpu.mg import setup as jsetup
from mugiq_tpu.mg import transfer as jtransfer

from mugiq_tpu_torch.cli import loop as cli_loop
from mugiq_tpu_torch.io.gauge_io import load_gauge_np
from mugiq_tpu_torch.lattice import LatticeGeometry
from mugiq_tpu_torch.mg import coarse_loop as cl
from mugiq_tpu_torch.mg.mg import MGEnv
from mugiq_tpu_torch.mg.transfer import Transfer
from mugiq_tpu_torch.params import MGParam

torch.set_num_threads(2)

DIMS = (4, 4, 4, 4)
BLOCK = (2, 2, 2, 2)
NVEC = 4
N_EV = 3
MOMS = [(0, 0, 0), (1, 0, 0), (0, 1, 1)]


def rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


def cfield(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def envs():
    """(port MGEnv, JAX MGEnv, coarse vectors, weights) from the JAX null
    vectors of weak:0.3 at 4^4."""
    U = load_gauge_np("weak:0.3", LatticeGeometry(DIMS), seed=2)
    jd = jax_make(jnp.asarray(U), jp.GaugeParam(dims=DIMS),
                  jp.InvertParam(kappa=0.125))
    B = jsetup.setup_null_vectors(jd.MdagM, jd.field_shape, jd.dtype, NVEC,
                                  iters=6, seed=3)
    jtr = jtransfer.Transfer.build(B, BLOCK, spin_block=2)
    tr = Transfer.build(torch.from_numpy(np.array(B)), BLOCK, spin_block=2)
    env = MGEnv([None, None], [tr], MGParam(n_level=2,
                                            geo_block_size=[BLOCK],
                                            n_vec=[NVEC]))
    jenv = jmg.MGEnv([jd, None], [jtr], jp.MGParam(
        n_level=2, geo_block_size=[BLOCK], n_vec=[NVEC]))
    rng = np.random.default_rng(11)
    u = cfield(rng, (N_EV,) + tr.coarse_field_shape)
    w = 1.0 / rng.uniform(0.05, 0.2, N_EV)
    return env, jenv, u, w


def test_coarse_loop_matches_jax(envs):
    env, jenv, u, w = envs
    got = cl.coarse_loop_ulocal(env, torch.from_numpy(u), w,
                                LatticeGeometry(DIMS), MOMS, ft_sign=-1)
    ref = jcl.coarse_loop_ulocal(jenv, jnp.asarray(u), w, JGeom(DIMS),
                                 MOMS, ft_sign=-1)
    assert got.dtype == np.complex128 and got.shape == (3, 16, DIMS[3])
    assert rel(got, ref) <= 1e-12


def fine_factorized(env, u, w, dims, moms, sign):
    """The loop of tests/test_coarse_loop.py evaluated in fine space with
    psi_m = P u_m."""
    psis = env.prolongate(torch.from_numpy(u)).numpy()
    units = cl._unit_generators_np(dims)
    gco = cl._gcoeff_np()
    geom = LatticeGeometry(dims)
    out = np.zeros((len(moms), 16, dims[3]), dtype=np.complex128)
    for ip, mom in enumerate(moms):
        ph = cl._phase_np(geom, mom, sign)
        for t in range(dims[3]):
            for m, psi in enumerate(psis):
                A = np.asarray([np.vdot(psi, units[i]) for i in range(12)])
                B = np.asarray([np.vdot(units[j][t] * ph[t][..., None, None],
                                        psi[t]) for j in range(12)])
                out[ip, :, t] += w[m] * np.einsum("nij,i,j->n", gco, A, B)
    return out


def test_coarse_loop_equals_fine_factorized(envs):
    env, _, u, w = envs
    got = cl.coarse_loop_ulocal(env, torch.from_numpy(u), w,
                                LatticeGeometry(DIMS), MOMS, ft_sign=+1)
    assert rel(got, fine_factorized(env, u, w, DIMS, MOMS, +1)) <= 1e-12


def test_numpy_helpers_match_jax():
    assert np.array_equal(cl._gcoeff_np(), jcl._gcoeff_np())
    assert np.array_equal(cl._unit_generators_np(DIMS),
                          jcl._unit_generators_np(DIMS))
    for mom in MOMS:
        assert np.array_equal(
            cl._phase_np(LatticeGeometry(DIMS), mom, -1),
            jcl._phase_np(JGeom(DIMS), mom, -1))


@pytest.mark.parametrize("blocks", [[(2, 2, 2, 2)], [(2, 2, 2, 2),
                                                      (1, 1, 1, 2)],
                                    [(2, 1, 2, 4)]],
                         ids=["2-level", "3-level", "bt4"])
def test_restrict_rows_equals_full_restriction(blocks):
    """restrict_rows of a field living on one coarsest time row equals that
    row of the full restriction, and every other row of it is zero."""
    dims = (4, 2, 4, 8)
    rng = np.random.default_rng(5)
    X, Y, Z, T = dims
    trs, shape, spin_block = [], (T, Z, Y, X, 4, 3), 2
    for blk in blocks:
        B = torch.from_numpy(cfield(rng, (3,) + shape))
        trs.append(Transfer.build(B, blk, spin_block))
        shape, spin_block = trs[-1].coarse_field_shape, 1
    env = MGEnv([None] * (len(trs) + 1), trs, None)
    rows = cl.time_rows(env)
    assert rows == int(np.prod([b[3] for b in blocks]))
    for t0 in range(0, T, rows):
        psi = np.zeros((2, T, Z, Y, X, 4, 3), dtype=np.complex128)
        psi[:, t0:t0 + rows] = cfield(rng, (2, rows, Z, Y, X, 4, 3))
        full = env.restrict(torch.from_numpy(psi)).numpy()
        got = cl.restrict_rows(env, torch.from_numpy(psi[:, t0:t0 + rows]),
                               t0).numpy()
        tc = t0 // rows
        assert got.shape == full[:, tc:tc + 1].shape
        assert rel(got, full[:, tc:tc + 1]) <= 1e-13
        assert np.abs(np.delete(full, tc, axis=1)).max() == 0.0


# the API path's MG-coarse eigensolve in fp64 at 4^4 (the MG recipe of
# tests/test_torch_cli_flags.py), with two momenta
MG = ["--dims", *map(str, DIMS), "--gauge", "weak:0.5", "--gauge-seed",
      "1", "--kappa", "0.13", "--eig-nev", "4", "--eig-nkr", "16",
      "--eig-tol", "1e-10", "--prec", "double", "--eig-max-restarts", "400",
      "--mg-block-size", "2", "2", "2", "2", "--mg-nvec", "4",
      "--mg-setup-iters", "6", "--device", "cpu"]


def test_cli_coarse_loop(tmp_path):
    """--loop-coarse-ulocal yes on the API path with the MG-coarse
    eigensolve: run() returns the [P, 16, T] loop beside its result, the
    coarse loop of its eigenpairs with weights 1/Re(lambda)."""
    mom = tmp_path / "moms.txt"
    mom.write_text("0 0 0\n1 0 0\n")
    got = cli_loop.run(MG + ["--mugiq-use-mg", "yes", "--loop-coarse-ulocal",
                             "yes", "--momenta-filename", str(mom)])
    result, eig_res, coarse = got
    assert eig_res.output.converged and eig_res.mg_env is not None
    assert coarse.shape == (2, 16, DIMS[3]) and coarse.dtype == np.complex128
    assert np.all(np.isfinite(coarse))
    want = cl.coarse_loop_ulocal(eig_res.mg_env, eig_res.evecs,
                                 1.0 / np.asarray(eig_res.evals).real,
                                 eig_res.geom, [(0, 0, 0), (1, 0, 0)])
    assert np.array_equal(coarse, want)
    assert result.data_mom.shape == (2, 1, 16, DIMS[3])


def test_cli_coarse_loop_needs_mg(capsys):
    """Without the MG-coarse eigensolve the flag is a usage error with the
    JAX CLI's message."""
    with pytest.raises(SystemExit) as e:
        cli_loop.run(MG + ["--loop-coarse-ulocal", "yes"])
    assert e.value.code == 2
    assert cli_loop.COARSE_ULOCAL_NEEDS_MG in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli_loop.run(MG + ["--mugiq-use-mg", "yes", "--mugiq-compute-coarse",
                           "no", "--loop-coarse-ulocal", "yes"])


def test_cli_coarse_loop_with_production_is_logged(caplog):
    """With --production the flag is logged and ignored, as the JAX CLI
    ignores it there."""
    caplog.set_level("INFO", logger="mugiq_tpu_torch")
    res = cli_loop.run(["--dims", *map(str, DIMS), "--gauge", "weak:0.5",
                        "--gauge-seed", "1", "--kappa", "0.13", "--eig-nev",
                        "2", "--eig-nkr", "8", "--eig-max-restarts", "2",
                        "--production", "--device", "cpu",
                        "--loop-coarse-ulocal", "yes"])
    assert res.data_mom.shape == (1, 1, 16, DIMS[3])
    assert "--loop-coarse-ulocal yes applies to the API path" in caplog.text
