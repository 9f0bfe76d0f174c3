"""The port's API-path multigrid (mugiq_tpu_torch.mg transfer, setup,
coarse, mg and api.compute_evecs_mugiq_mg) against the JAX package's, on
the CPU, complex128 at 4^4 (x64 from tests/conftest.py).

The JAX null vectors (jax.random starts, which the port cannot draw) are
carried across as numpy: the port's Transfer.build and
galerkin_coarse_operator take them, MGEnv(level_ops, transfers, params)
is built from those pieces, and the coarse eigensolve starts from the
JAX start vector.  The port's own setup_null_vectors is held to the JAX
batched CG on the same starts.

Tolerances (max |port - jax| / max |jax|): transfer basis, P, R and the
Galerkin links 1e-12 (fp64, the same LAPACK QR on both sides); coarse
Ritz values from the same v0 at the same restart count 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu import params as jp
from mugiq_tpu.dirac import make_dirac as jax_make
from mugiq_tpu.mg import coarse as jcoarse
from mugiq_tpu.mg import mg as jmg
from mugiq_tpu.mg import setup as jsetup
from mugiq_tpu.mg import transfer as jtransfer

from mugiq_tpu_torch import api
from mugiq_tpu_torch.dirac import make_dirac
from mugiq_tpu_torch.io.gauge_io import load_gauge_np
from mugiq_tpu_torch.lattice import LatticeGeometry
from mugiq_tpu_torch.mg.coarse import galerkin_coarse_operator
from mugiq_tpu_torch.mg.mg import MGEnv
from mugiq_tpu_torch.mg.setup import setup_null_vectors
from mugiq_tpu_torch.mg.transfer import Transfer
from mugiq_tpu_torch.params import (EigOperator, EigParam, GaugeParam,
                                    InvertParam, MGParam)

torch.set_num_threads(2)

DIMS = (4, 4, 4, 4)
KAPPA = 0.125
BLOCK = (2, 2, 2, 2)
NVEC = 4
OP_RTOL = 1e-12
C128 = torch.complex128


def rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    """The JAX fine operator, null vectors (20 CG steps), transfer and
    Galerkin operator, and the port's fine operator."""
    U = load_gauge_np("weak:0.3", LatticeGeometry(DIMS), seed=2)
    jd = jax_make(jnp.asarray(U), jp.GaugeParam(dims=DIMS),
                  jp.InvertParam(kappa=KAPPA))
    B = jsetup.setup_null_vectors(jd.MdagM, jd.field_shape, jd.dtype, NVEC,
                                  iters=20, seed=3)
    jtr = jtransfer.Transfer.build(B, BLOCK, spin_block=2)
    jc = jcoarse.galerkin_coarse_operator(jd, jtr)
    d = make_dirac(t(U), GaugeParam(dims=DIMS), InvertParam(kappa=KAPPA))
    return dict(U=U, jd=jd, B=np.asarray(B), jtr=jtr, jc=jc, d=d)


@pytest.fixture(scope="module")
def port_mg(setup):
    tr = Transfer.build(t(setup["B"]), BLOCK, spin_block=2)
    return tr, galerkin_coarse_operator(setup["d"], tr)


def test_transfer_matches_jax(setup, port_mg):
    tr, _ = port_mg
    jtr = setup["jtr"]
    assert rel(tr.V, jtr.V) < OP_RTOL
    assert tr.coarse_field_shape == tuple(jtr.coarse_field_shape)
    rng = np.random.default_rng(4)
    phi = (rng.standard_normal(tr.coarse_field_shape)
           + 1j * rng.standard_normal(tr.coarse_field_shape))
    assert rel(tr.prolong(t(phi)), jtr.prolong(jnp.asarray(phi))) < OP_RTOL
    psi = np.asarray(jtr.prolong(jnp.asarray(phi))) + 0.3
    assert rel(tr.restrict(t(psi)), jtr.restrict(jnp.asarray(psi))) < OP_RTOL
    mask = jtransfer.block_edge_mask(jtr.geom, 2, -1)
    assert rel(tr.restrict_masked(t(psi), t(mask)),
               jtr.restrict_masked(jnp.asarray(psi), mask)) < OP_RTOL
    assert rel(tr.probe_fine_vectors(), jtr.probe_fine_vectors()) < OP_RTOL


def test_null_vector_setup_matches_jax_cg(setup):
    """setup_null_vectors: its numpy starts through a batched CG, held to
    the JAX vmap'd CG of the same starts and the same normalisation."""
    from mugiq_tpu.solvers import cg as jax_cg

    jd, d = setup["jd"], setup["d"]
    got = setup_null_vectors(d.MdagM, d.field_shape, C128, NVEC, iters=6,
                             seed=5, device="cpu")
    rng = np.random.default_rng(5)
    shape = (NVEC,) + d.field_shape
    b = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    def solve_one(rhs):
        x = jax_cg(jd.MdagM, rhs, tol=0.0, maxiter=6).x
        return x / jnp.linalg.norm(x.reshape(-1))

    assert rel(got, jax.vmap(solve_one)(jnp.asarray(b))) < 1e-11


def test_galerkin_matches_jax(setup, port_mg):
    _, c = port_mg
    jc = setup["jc"]
    assert rel(c.D, jc.D) < OP_RTOL
    for mu in range(4):
        assert rel(c.Yp[mu], jc.Yp[mu]) < OP_RTOL
        assert rel(c.Ym[mu], jc.Ym[mu]) < OP_RTOL
    rng = np.random.default_rng(6)
    phi = (rng.standard_normal(c.field_shape)
           + 1j * rng.standard_normal(c.field_shape))
    for which in EigOperator:
        assert rel(c.operator(which)(t(phi)),
                   jc.operator(jp.EigOperator[which.name])(
                       jnp.asarray(phi))) < OP_RTOL
    for mu in range(4):
        for sign in (+1, -1):
            assert rel(c.hop_term(mu, sign, t(phi)),
                       jc.hop_term(mu, sign, jnp.asarray(phi))) < OP_RTOL


def test_mg_env_and_coarse_eigensolve_match_jax(setup, port_mg):
    """MGEnv from the carried pieces: prolongate / restrict, and the
    coarse MdagM eigensolve from the JAX start vector."""
    from mugiq_tpu.eig.eigsolve import Eigensolver as JE
    from mugiq_tpu_torch.eig.eigsolve import Eigensolver

    tr, c = port_mg
    params = MGParam(n_level=2, geo_block_size=[BLOCK], n_vec=[NVEC])
    env = MGEnv([setup["d"], c], [tr], params)
    jenv = jmg.MGEnv([setup["jd"], setup["jc"]], [setup["jtr"]],
                     jp.MGParam(n_level=2, geo_block_size=[BLOCK],
                                n_vec=[NVEC]))
    assert env.coarsest_op is c and env.n_coarse_levels == 1
    rng = np.random.default_rng(7)
    phis = (rng.standard_normal((3,) + c.field_shape)
            + 1j * rng.standard_normal((3,) + c.field_shape))
    assert rel(env.prolongate(t(phis)),
               jenv.prolongate_batch(jnp.asarray(phis))) < OP_RTOL
    psi = np.asarray(jenv.prolongate(jnp.asarray(phis[0])))
    assert rel(env.restrict(t(psi)), jenv.restrict(jnp.asarray(psi))) \
        < OP_RTOL

    kw = dict(n_ev=4, n_kr=16, tol=1e-10, max_restarts=100)
    je = JE(setup["jc"].MdagM, setup["jc"].field_shape, jnp.complex128,
            jp.EigParam(**kw))
    v0 = np.asarray(je._start_vector())
    ref = je.solve()
    e = Eigensolver(c.MdagM, c.field_shape, C128, EigParam(**kw),
                    device="cpu")
    e.start_vector = lambda: t(v0)
    got = e.solve()
    assert got.n_restarts == ref.n_restarts
    np.testing.assert_allclose(got.evals, ref.evals, rtol=1e-9)
    np.testing.assert_allclose(got.sigma, ref.sigma, rtol=1e-9)


def test_compute_evecs_mugiq_mg_runs(setup):
    """The MG entry point from its own null vectors: a converged coarse
    eigensolve of a g5-hermitian coarse operator, its eigenvectors
    prolongated to fine-level vectors of the right shape."""
    eig = EigParam(n_ev=4, n_kr=16, tol=1e-10, max_restarts=200)
    mg = MGParam(n_level=2, geo_block_size=[BLOCK], n_vec=[NVEC],
                 setup_iters=20)
    res = api.compute_evecs_mugiq_mg(setup["U"], GaugeParam(dims=DIMS),
                                     InvertParam(kappa=KAPPA), eig, mg,
                                     dtype=C128, device="cpu")
    assert res.output.converged
    assert res.output.resids.max() < 1e-8
    fine = res.mg_env.prolongate(res.evecs)
    assert fine.shape == (4,) + res.dirac.field_shape
    np.testing.assert_allclose(
        torch.linalg.vector_norm(fine.reshape(4, -1), dim=1).numpy(), 1.0,
        atol=1e-12)


@pytest.mark.slow
def test_three_levels_match_jax(setup, port_mg):
    """A second coarsening (block (1, 1, 2, 2) of the coarse lattice) from
    JAX null vectors of the coarse operator."""
    tr, c = port_mg
    jc = setup["jc"]
    B2 = jsetup.setup_null_vectors(jc.MdagM, jc.field_shape, jc.dtype, 3,
                                   iters=10, seed=4)
    jtr2 = jtransfer.Transfer.build(B2, (1, 1, 2, 2), spin_block=1)
    jc2 = jcoarse.galerkin_coarse_operator(jc, jtr2)
    tr2 = Transfer.build(t(B2), (1, 1, 2, 2), spin_block=1)
    c2 = galerkin_coarse_operator(c, tr2)
    assert rel(c2.D, jc2.D) < OP_RTOL
    for mu in range(4):
        assert rel(c2.Yp[mu], jc2.Yp[mu]) < OP_RTOL
        assert rel(c2.Ym[mu], jc2.Ym[mu]) < OP_RTOL
