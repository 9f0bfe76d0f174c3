"""The Krylov-Schur Arnoldi of the port (eig/arnoldi_realpair.py), the
production eigensolver of M and M^dag, against the JAX package.

* arnoldi_krylov_schur_realpair on a dense non-normal complex matrix
  (150 x 150, tests/test_arnoldi_realpair.py's) in real-pair form [2, n],
  fp64, LM and SR, against JAX arnoldi_krylov_schur_realpair on the same
  matrix and v0: the same eigenvalues (1e-7 absolute, both converged to
  1e-9) and the dense eigenvalues; residuals < 1e-6.
* compute_evecs_production with EigOperator.M and Mdag at 4x4x2x4 (Wilson,
  kappa 0.12, weak gauge) against numpy's dense eig of the JAX validation
  operator M (make_dirac, fp64): every eigenvalue within 1e-5 relative of
  one of the dense ones, M^dag's the conjugates, residuals < 1e-4 (f32
  operator, tol 1e-6); sigma = |lambda|.
* The JAX function's validation: an unknown selector raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu_torch.eig.arnoldi_realpair import arnoldi_krylov_schur_realpair

torch.set_num_threads(2)


def _dense(n=150):
    rng = np.random.default_rng(17)
    A = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
    v0 = np.stack([rng.standard_normal(n), rng.standard_normal(n)])
    return A, v0


@pytest.mark.parametrize("which", ["LM", "SR"])
def test_arnoldi_matches_jax_dense(which):
    from mugiq_tpu.eig.arnoldi_realpair import (
        arnoldi_krylov_schur_realpair as jax_arnoldi)

    A, v0 = _dense()
    At = torch.from_numpy(A)
    Ar, Ai = jnp.asarray(A.real), jnp.asarray(A.imag)

    def port(v):
        c = At @ torch.complex(v[0], v[1])
        return torch.stack([c.real, c.imag])

    def jax(v):
        return jnp.stack([Ar @ v[0] - Ai @ v[1], Ar @ v[1] + Ai @ v[0]])

    kw = dict(n_ev=6, n_kr=40, re_im_axis=0, tol=1e-9, max_restarts=400,
              which=which)
    res = arnoldi_krylov_schur_realpair(port, torch.from_numpy(v0), **kw)
    ref = jax_arnoldi(jax, jnp.asarray(v0), **kw)
    assert res.converged and ref.converged
    np.testing.assert_allclose(res.evals, ref.evals, atol=1e-7)
    dense = np.linalg.eigvals(A)
    for i, lam in enumerate(res.evals):
        assert np.min(np.abs(dense - lam)) < 1e-7
        v = res.evecs[i].numpy()
        v = v[0] + 1j * v[1]
        assert np.linalg.norm(A @ v - lam * v) < 1e-6


def test_arnoldi_rejects_unknown_selector():
    with pytest.raises(ValueError, match="unsupported"):
        arnoldi_krylov_schur_realpair(lambda v: v, torch.ones(2, 4), 2, 8,
                                      which="XX")


DIMS = (4, 4, 2, 4)


def _gauge():
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    return load_gauge_np("weak:0.5", LatticeGeometry(DIMS), seed=1)


@pytest.fixture(scope="module")
def dense_m():
    """The eigenvalues of the JAX validation operator M (fp64, dense)."""
    from mugiq_tpu import params as jp
    from mugiq_tpu.dirac import dense_matrix, make_dirac

    d = make_dirac(jnp.asarray(_gauge()), jp.GaugeParam(dims=DIMS),
                   jp.InvertParam(kappa=0.12))
    return np.linalg.eigvals(np.asarray(dense_matrix(d.M, d.field_shape,
                                                     jnp.complex128)))


@pytest.mark.parametrize("operator", ["M", "Mdag"])
def test_production_arnoldi_matches_dense_eig(operator, dense_m):
    from mugiq_tpu_torch.params import (EigOperator, EigParam, GaugeParam,
                                        InvertParam, Spectrum)
    from mugiq_tpu_torch.production import compute_evecs_production

    ep = EigParam(n_ev=4, n_kr=24, tol=1e-6, max_restarts=300,
                  operator=EigOperator[operator], spectrum=Spectrum.SM)
    res, evals, sigma, resids = compute_evecs_production(
        _gauge(), GaugeParam(dims=DIMS), InvertParam(kappa=0.12), ep,
        device="cpu")
    assert res.converged
    ref = dense_m if operator == "M" else dense_m.conj()
    for lam in evals:
        assert np.min(np.abs(ref - lam)) < 1e-5 * abs(lam)
    # the four smallest |lambda| of the dense spectrum
    np.testing.assert_allclose(np.sort(np.abs(evals)),
                               np.sort(np.abs(ref))[:4], rtol=1e-5)
    np.testing.assert_allclose(sigma, np.abs(evals))
    assert max(resids) < 1e-4
