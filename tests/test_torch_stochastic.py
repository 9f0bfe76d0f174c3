"""The deflated stochastic trace of the port (mugiq_tpu_torch.stochastic,
the API form on complex fields, and .stochastic_production, K1 and K2 on
the kernel layout) against the JAX package's, on the CPU.

The gauge comes from the port's numpy factory (weak:0.3, seed 31), the
deflation space from a dense eigendecomposition of M^dag M.  The JAX API
form draws its noise from jax.random, which the port cannot reproduce
(the port draws from numpy default_rng(seed + i)): the test hands the
port's noise to JAX by patching mugiq_tpu.stochastic.z4_noise, and no
JAX file changes.  Tolerances (max |port - ref| / max |ref|): Z4 kernel
noise bitwise; API form vs JAX at 2^4, complex128, 1e-10; full deflation
vs the dense inverse 1e-9 absolute (JAX test_full_deflation_is_exact);
the production form (f32, through the twins) vs the port's API form on
the same noise 1e-5; slow: vs JAX stochastic_loop_trace_production
(interpret-mode Pallas) at (4, 4, 2, 4), 1e-5.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu import stochastic as jstoch
from mugiq_tpu import stochastic_production as jsp
from mugiq_tpu.dirac import make_dirac as jax_make
from mugiq_tpu.params import GaugeParam as JGP
from mugiq_tpu.params import InvertParam as JIP

from mugiq_tpu_torch import stochastic as stoch
from mugiq_tpu_torch import stochastic_production as sp
from mugiq_tpu_torch.dirac import dense_matrix, make_dirac
from mugiq_tpu_torch.gamma import gamma_basis
from mugiq_tpu_torch.io.gauge_io import load_gauge_np
from mugiq_tpu_torch.lattice import LatticeGeometry
from mugiq_tpu_torch.params import GaugeParam, InvertParam
from mugiq_tpu_torch.production import build_kernel_dirac

torch.set_num_threads(2)

KAPPA = 0.10


def rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


@functools.lru_cache(maxsize=None)
def setup(dims, dtype=torch.complex128):
    """(gauge, port dirac, dense M^dag M eigenpairs as fields), built once
    per lattice (the tests only read them)."""
    U = load_gauge_np("weak:0.3", LatticeGeometry(dims), seed=31)
    d = make_dirac(torch.from_numpy(U).to(dtype), GaugeParam(dims=dims),
                   InvertParam(kappa=KAPPA))
    A = dense_matrix(d.MdagM, d.field_shape, torch.complex128, "cpu").numpy()
    evals, evecs = np.linalg.eigh((A + A.conj().T) / 2)
    return U, d, evals, evecs.T.reshape((-1,) + d.field_shape)


@pytest.mark.parametrize("dims, seed", [((4, 4, 2, 4), 0), ((2, 2, 2, 2), 5),
                                        ((8, 4, 4, 8), 7)])
def test_z4_kernel_noise_is_jax_bitwise(dims, seed):
    got = sp.z4_noise_kernel_np(dims, seed)
    ref = jsp.z4_noise_kernel_np(dims, seed)
    assert got.dtype == ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()


def test_z4_noise_properties():
    eta = stoch.z4_noise(0, (1000, 12), torch.complex128, "cpu").numpy()
    np.testing.assert_allclose(np.abs(eta), 1.0, atol=1e-14)
    assert np.abs(eta.mean()) < 0.1
    assert np.array_equal(eta, stoch.z4_noise(0, (1000, 12),
                                              torch.complex128,
                                              "cpu").numpy())


@pytest.mark.parametrize("deflated", [True, False],
                         ids=["deflated", "plain"])
def test_api_trace_matches_jax(monkeypatch, deflated):
    """stochastic_loop_trace at 2^4 (JAX tests/test_stochastic.py's
    lattice) in complex128, 24 deflated low modes, the same noise."""
    dims, n_noise, seed = (2, 2, 2, 2), 4, 5
    U, d, evals, vecs = setup(dims)
    jd = jax_make(jnp.asarray(U), JGP(dims=dims), JIP(kappa=KAPPA))
    noise = [stoch.z4_noise(seed + i, d.field_shape, torch.complex128,
                            "cpu").numpy() for i in range(n_noise)]
    calls = []

    def fake(key, shape, dtype):
        calls.append(key)
        return jnp.asarray(noise[len(calls) - 1], dtype=dtype)

    monkeypatch.setattr(jstoch, "z4_noise", fake)
    ds = jds = None
    if deflated:
        ds = stoch.DeflationSpace.build(d.M, torch.from_numpy(vecs[:24]),
                                        evals[:24])
        jds = jstoch.DeflationSpace.build(jd.M, jnp.asarray(vecs[:24]),
                                          evals[:24])
    got = stoch.stochastic_loop_trace(d, n_noise, deflation=ds,
                                      solver_tol=1e-12, seed=seed)
    ref = jstoch.stochastic_loop_trace(jd, n_noise, deflation=jds,
                                       solver_tol=1e-12, seed=seed)
    assert len(calls) == n_noise
    assert got.shape == (16,) + tuple(d.field_shape[:4])
    assert rel(got, ref) <= 1e-10


def exact_trace(d, dims):
    """Per-site Tr[Gamma M^-1] [16, T, Z, Y, X] from the dense inverse."""
    A = dense_matrix(d.M, d.field_shape, torch.complex128, "cpu").numpy()
    n = A.shape[0]
    blocks = np.linalg.inv(A).reshape(n // 12, 12, n // 12, 12)
    diag = np.einsum("iaib->iab", blocks).reshape(
        (dims[3], dims[2], dims[1], dims[0], 4, 3, 4, 3))
    return np.einsum("gab,tzyxbcac->gtzyx", gamma_basis(), diag)


def test_full_deflation_is_exact():
    """With the whole eigenbasis the deflated trace alone is the exact
    per-site trace (the JAX test of the same name)."""
    dims = (2, 2, 2, 2)
    _, d, evals, vecs = setup(dims)
    ds = stoch.DeflationSpace.build(d.M, torch.from_numpy(vecs), evals)
    np.testing.assert_allclose(ds.trace_contribution().numpy(),
                               exact_trace(d, dims), atol=1e-9)


def kernel_of(c):
    """complex [.., T, Z, Y, X, 4, 3] -> kernel layout [.., T, 24, Z, Y*X]
    f32 (rows r*12 + s*3 + c)."""
    c = np.asarray(c)
    lead = c.shape[:-6]
    T, Z, Y, X = c.shape[-6:-2]
    p = np.stack([c.real, c.imag], axis=-3)     # [.., T, Z, Y, X, 2, 4, 3]
    p = np.moveaxis(p.reshape(lead + (T, Z, Y * X, 24)), -1, -3)
    return torch.from_numpy(np.ascontiguousarray(p, dtype=np.float32))


def complex_of(k, dims):
    """kernel layout [.., T, 24, Z, Y*X] -> complex [.., T, Z, Y, X, 4, 3]."""
    k = np.asarray(k)
    X, Y, Z, T = dims
    q = np.moveaxis(k, -3, -1).reshape(k.shape[:-4] + (T, Z, Y, X, 2, 4, 3))
    return q[..., 0, :, :] + 1j * q[..., 1, :, :]


def test_production_trace_matches_api_form(monkeypatch):
    """stochastic_loop_trace_production through the twins of K1 and K2
    (f32) against the port's API form in complex128 on the same noise
    (the kernel noise mapped to full-site fields), deflated by the 16
    lowest modes and plain: the estimate within 1e-5 of max."""
    dims, n_noise, seed = (4, 4, 2, 4), 3, 2
    U, d, evals, vecs = setup(dims)
    op = build_kernel_dirac(U, GaugeParam(dims=dims),
                            InvertParam(kappa=KAPPA), device="cpu")
    geom = LatticeGeometry(dims)
    calls = []

    def fake(s, shape, dtype, device):
        calls.append(s)
        return torch.as_tensor(complex_of(sp.z4_noise_kernel_np(dims, s),
                                          dims), dtype=dtype, device=device)

    monkeypatch.setattr(stoch, "z4_noise", fake)
    for n_defl in (16, 0):
        ds = dsk = None
        if n_defl:
            ds = stoch.DeflationSpace.build(
                d.M, torch.from_numpy(vecs[:n_defl]), evals[:n_defl])
            dsk = sp.DeflationSpaceKernel.build(op, kernel_of(vecs[:n_defl]),
                                                evals[:n_defl])
        solves = []
        got = sp.stochastic_loop_trace_production(
            op, geom, n_noise, deflation=dsk, solver_tol=1e-6, seed=seed,
            solves=solves)
        ref = stoch.stochastic_loop_trace(d, n_noise, deflation=ds,
                                          solver_tol=1e-12, seed=seed)
        assert got.dtype == torch.float32
        assert got.shape == (2, 16, 4, 2, 4, 4)
        assert len(solves) == n_noise and max(r for _, r in solves) <= 1e-6
        assert rel(got[0] + 1j * got[1], ref) <= 1e-5, n_defl
    assert calls == [seed + i for i in range(n_noise)] * 2


def test_deflation_kernel_apply_inv_matches_api_form():
    """DeflationSpaceKernel.apply_inv (two GEMMs with the re/im swap) on
    the kernel layout against DeflationSpace.apply_inv on complex fields."""
    dims = (4, 4, 2, 4)
    U, d, evals, vecs = setup(dims)
    op = build_kernel_dirac(U, GaugeParam(dims=dims),
                            InvertParam(kappa=KAPPA), device="cpu")
    dsk = sp.DeflationSpaceKernel.build(op, kernel_of(vecs[:8]), evals[:8])
    ds = stoch.DeflationSpace.build(d.M, torch.from_numpy(vecs[:8]),
                                    evals[:8])
    rng = np.random.default_rng(3)
    rhs = (rng.standard_normal(d.field_shape)
           + 1j * rng.standard_normal(d.field_shape))
    got = dsk.apply_inv(kernel_of(rhs))
    assert rel(complex_of(got, dims), ds.apply_inv(torch.from_numpy(rhs))) \
        <= 1e-5


@pytest.mark.slow
def test_production_trace_matches_jax_production():
    """The production form through the twins against JAX
    stochastic_loop_trace_production (interpret-mode Pallas K1 and K2) at
    (4, 4, 2, 4): the same gauge, deflation space and noise."""
    from mugiq_tpu.pallas.dirac_kernel import WilsonDiracKernel as JWK
    from mugiq_tpu.lattice import LatticeGeometry as JGeom

    dims = (4, 4, 2, 4)
    U, _, evals, vecs = setup(dims)
    op = build_kernel_dirac(U, GaugeParam(dims=dims),
                            InvertParam(kappa=KAPPA), device="cpu")
    jop = JWK(U_k=jnp.asarray(op.U_k.numpy()), kappa=KAPPA, Y=dims[1])
    V = kernel_of(vecs[:16])
    dsk = sp.DeflationSpaceKernel.build(op, V, evals[:16])
    jdsk = jsp.DeflationSpaceKernel.build(jop, jnp.asarray(V.numpy()),
                                          evals[:16])
    got = sp.stochastic_loop_trace_production(
        op, LatticeGeometry(dims), 2, deflation=dsk, solver_tol=1e-6, seed=4)
    ref = jsp.stochastic_loop_trace_production(
        jop, JGeom(dims), 2, deflation=jdsk, solver_tol=1e-6, seed=4)
    assert rel(got, ref) <= 1e-5
