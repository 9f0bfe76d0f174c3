"""The bf16 Krylov basis (basis_dtype=torch.bfloat16, --basis-precision
bf16) and the bf16-spinor forms of K1 and K6, against the JAX package.

* Thick-restart Lanczos with a bf16 basis against JAX
  planar.lanczos.lanczos_hermitian_realpair(basis_dtype=jnp.bfloat16) on
  test_torch_lanczos.py's dense operator in the kernel layout, same v0:
  the operator sees only the stored bf16 vectors (checked), and both
  packages' eigenvalues sit within 2e-2 relative of each other and of the
  dense ones (the bf16 storage floor with ||A|| = 9: measured 8.7e-3
  between the packages, 4.4e-3 port and 9.7e-3 JAX against the dense).
* chebyshev_op keeps a bf16 field bf16 through the chain, as JAX's
  weak-typed scalars do; the two chains agree to one bf16 ulp.
* K1's twin on a bf16 psi rounds once, at the end, and K6's twin pair
  (the packed M) twice, d_oe between the passes and the result: exactly
  the f32 twins on the upcast inputs, rounded at those points.  Slow
  (interpret mode, ~20 s each): against JAX wilson_m_pallas (bf16 in,
  bf16 out) and the JAX packed M on a bf16 pe, within one bf16 ulp of max
  |out| (2^-7; both round f32 sums that differ in their last bits).
* The bf16-basis production eigensolve at (4, 4, 2, 4) against the JAX
  fp64 validation eigenvalues, rtol 3e-2 (the JAX package's own bound
  for a bf16 basis, tests/test_production.py:317-320; measured 7e-4),
  residuals < 0.1 (measured 8.3e-3);
  slow: against JAX compute_evecs_production(basis_precision="bf16").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu_torch.eig.lanczos import chebyshev_op
from mugiq_tpu_torch.lanczos import lanczos_hermitian_realpair
from test_torch_lanczos import SHAPE, _matrix, _spectrum, _v0
from torch_ref import jax_operator, port_operator, rand

torch.set_num_threads(2)

BF16 = torch.bfloat16
ULP = 2.0 ** -7


def _dense_pair(A):
    """(port matvec, JAX matvec) of the dense A on real-pair [*SHAPE]
    fields, both returning f32 whatever the input's dtype; the port's
    records the dtypes it was fed."""
    At = torch.from_numpy(A).to(torch.complex128)
    Aj = jnp.asarray(A)
    seen = []

    def port(v):
        seen.append(v.dtype)
        c = torch.complex(v[:, :12].double(), v[:, 12:].double()).reshape(-1)
        r = (At @ c).reshape(SHAPE[0], 12, *SHAPE[2:])
        return torch.cat([r.real, r.imag], 1).float()

    def jax(v):
        v = v.astype(jnp.float64)
        c = (v[:, :12] + 1j * v[:, 12:]).reshape(-1)
        r = (Aj @ c).reshape(SHAPE[0], 12, *SHAPE[2:])
        return jnp.concatenate([r.real, r.imag], 1).astype(jnp.float32)

    return port, jax, seen


def test_bf16_basis_lanczos_matches_jax():
    from mugiq_tpu.planar.lanczos import lanczos_hermitian_realpair as jl

    A = _matrix()
    port, jax, seen = _dense_pair(A)
    kw = dict(n_ev=4, n_kr=24, re_im_axis=1, tol=1e-3, max_restarts=40,
              which="SR")
    res = lanczos_hermitian_realpair(port, _v0(), basis_dtype=BF16, **kw)
    ref = jl(jax, jnp.asarray(_v0().numpy()), basis_dtype=jnp.bfloat16,
             **kw)
    assert set(seen) == {BF16}
    assert res.evecs.dtype == torch.float32
    want = np.sort(_spectrum())[:4]
    np.testing.assert_allclose(res.evals, ref.evals, rtol=2e-2)
    np.testing.assert_allclose(res.evals, want, rtol=2e-2)
    np.testing.assert_allclose(ref.evals, want, rtol=2e-2)


def test_chebyshev_chain_stays_bf16():
    from mugiq_tpu.eig import lanczos as jl

    v = rand(SHAPE, 3)
    got = chebyshev_op(lambda x: 1.5 * x, 6, 0.5, 4.0)(
        torch.from_numpy(v).to(BF16))
    ref = jl.chebyshev_op(lambda x: 1.5 * x, 6, 0.5, 4.0)(
        jnp.asarray(v).astype(jnp.bfloat16))
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=ULP * np.abs(ref).max())


def _ops():
    """The port's full and packed Wilson-clover operators on a 4^3x4
    weak gauge (csw 1.1), carried over from the JAX package's."""
    from mugiq_tpu import fields
    from mugiq_tpu import params as jp
    from mugiq_tpu.lattice import LatticeGeometry
    from mugiq_tpu.production import build_packed_schur

    from torch_ref import port_packed_operator

    dims = (4, 4, 4, 4)
    U = np.asarray(fields.weak_gauge(LatticeGeometry(dims), eps=0.4, seed=11,
                                     dtype=jnp.complex128))
    jop, gp, ip = jax_operator(U, dims, 0.12, True)
    return port_operator(jop), port_packed_operator(
        build_packed_schur(U, gp, ip))


@pytest.mark.parametrize("dagger", [False, True])
def test_bf16_spinor_twins_round_at_the_jax_points(dagger):
    full, packed = _ops()
    psi = torch.from_numpy(rand(full.field_shape, 5)).to(BF16)
    op = full.Mdag if dagger else full.M
    assert torch.equal(op(psi), op(psi.float()).to(BF16))
    pe = torch.from_numpy(rand(packed.field_shape, 6)).to(BF16)
    from mugiq_tpu_torch.kernels.parity import parity_hop
    p = packed
    d_oe = parity_hop(pe.float(), p.U_o, p.U_e, p.Y, 1, dagger,
                      A_post=p.Ainv_o).to(BF16)
    want = parity_hop(d_oe.float(), p.U_e, p.U_o, p.Y, 0, dagger,
                      kappa2=p.kappa ** 2, psi_out=pe.float(),
                      A_comb=p.A_e).to(BF16)
    assert torch.equal((p.Mdag if dagger else p.M)(pe), want)


@pytest.mark.slow
def test_k1_twin_bf16_spinor_matches_pallas():
    import mugiq_tpu.pallas.dslash_kernel as dk
    from mugiq_tpu import fields
    from mugiq_tpu.lattice import LatticeGeometry

    dims = (4, 4, 4, 4)
    U = np.asarray(fields.weak_gauge(LatticeGeometry(dims), eps=0.4, seed=11,
                                     dtype=jnp.complex128))
    jop, _, _ = jax_operator(U, dims, 0.12, True)
    op = port_operator(jop)
    psi = torch.from_numpy(rand((4, 24, 4, 16), seed=5)).to(BF16)
    ref = dk.wilson_m_pallas(jnp.asarray(psi.float().numpy()).astype(
        jnp.bfloat16), jop.U_k, jop.Ut_k, jop._A144, Y=4, kappa=0.12,
        dagger=False, has_clover=True, ps=True)
    got = op.M(psi)
    assert ref.dtype == jnp.bfloat16 and got.dtype == BF16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=ULP * np.abs(ref).max())


@pytest.mark.slow
def test_k6_twin_pair_bf16_matches_jax_packed_m():
    from mugiq_tpu import fields
    from mugiq_tpu import params as jp
    from mugiq_tpu.lattice import LatticeGeometry
    from mugiq_tpu.production import build_packed_schur

    from torch_ref import port_packed_operator

    dims = (4, 4, 2, 4)
    U = np.asarray(fields.weak_gauge(LatticeGeometry(dims), eps=0.4, seed=12,
                                     dtype=jnp.complex128))
    jop = build_packed_schur(U, jp.GaugeParam(dims=dims),
                             jp.InvertParam(kappa=0.12))
    op = port_packed_operator(jop)
    pe = torch.from_numpy(rand(op.field_shape, 9)).to(BF16)
    ref = jop.M(jnp.asarray(pe.float().numpy()).astype(jnp.bfloat16))
    got = op.M(pe)
    assert ref.dtype == jnp.bfloat16 and got.dtype == BF16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=ULP * np.abs(ref).max())


DIMS = (4, 4, 2, 4)


def _gauge():
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    return load_gauge_np("weak:0.5", LatticeGeometry(DIMS), seed=1)


def _port_bf16_solve():
    from mugiq_tpu_torch.params import EigParam, GaugeParam, InvertParam
    from mugiq_tpu_torch.production import compute_evecs_production

    ep = EigParam(n_ev=4, n_kr=16, tol=1e-3, max_restarts=30,
                  use_poly_acc=True, poly_deg=8, a_min=0.15)
    return compute_evecs_production(_gauge(), GaugeParam(dims=DIMS),
                                    InvertParam(kappa=0.13), ep,
                                    basis_precision="bf16", device="cpu")


def test_bf16_basis_production_matches_jax_f32():
    from mugiq_tpu import params as jp
    from mugiq_tpu.api import compute_evecs_mugiq

    res, evals, sigma, resids = _port_bf16_solve()
    assert res.converged
    ref = compute_evecs_mugiq(jnp.asarray(_gauge()), jp.GaugeParam(dims=DIMS),
                              jp.InvertParam(kappa=0.13),
                              jp.EigParam(n_ev=4, n_kr=16, tol=1e-8,
                                          max_restarts=500))
    np.testing.assert_allclose(evals, np.sort(ref.evals.real), rtol=3e-2)
    assert max(resids) < 0.1
    assert res.evecs.dtype == torch.float32


@pytest.mark.slow
def test_bf16_basis_production_matches_jax_bf16():
    """JAX compute_evecs_production with a bf16 basis (interpret-mode
    Pallas in every matvec): eigenvalues within 3e-2 of each other."""
    from mugiq_tpu import params as jp
    from mugiq_tpu.production import compute_evecs_production

    _, evals, _, _ = _port_bf16_solve()
    ep = jp.EigParam(n_ev=4, n_kr=16, tol=1e-3, max_restarts=30,
                     use_poly_acc=True, poly_deg=8, a_min=0.15)
    _, ref, _, _ = compute_evecs_production(
        _gauge(), jp.GaugeParam(dims=DIMS), jp.InvertParam(kappa=0.13), ep,
        basis_precision="bf16")
    np.testing.assert_allclose(evals, ref, rtol=3e-2)
