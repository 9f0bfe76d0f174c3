"""Block thick-restart Lanczos of the port (block_lanczos.py) against the
JAX package's block_lanczos_hermitian_realpair, on the cases of
tests/test_block_lanczos.py, and the batched twins of K1 and K6.

* The degenerate free field (unit gauge, 4x4x2x4, kappa 0.12): the lowest
  MdagM eigenvalue is many-fold degenerate; the port (kernel layout, K1's
  twin applied to the block) and JAX (its planar operator) resolve the
  whole cluster: eigenvalues within 2e-4 relative of each other (the JAX
  test's bound against dense eigh at tol 1e-5).
* b = 2 against b = 1 on a random gauge (kappa 0.11): 1e-4 relative, as
  the JAX test; the JAX b = 2 solve too.
* The validation errors of the JAX function.
* A bf16 basis on the dense Hermitian 96 x 96 matrix of the JAX test:
  eigenvalues within 5e-2 absolute of eigh, as the JAX test, and of the
  JAX bf16-basis block solve.
* The batched twins (a block [b, T, 24, Z, Y*X] through one call) equal
  the per-vector twins exactly, f32 and bf16, K1 and K6; the operators
  take the batch axis.
* Production: compute_evecs_production with block_size 4 equals the
  block_size 1 solve (Chebyshev + refine; eigenvalues 1e-5 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu import fields
from mugiq_tpu.lattice import LatticeGeometry
from mugiq_tpu_torch.block_lanczos import block_lanczos_hermitian_realpair
from mugiq_tpu_torch.lanczos import lanczos_hermitian_realpair
from torch_ref import jax_operator, port_operator, rand

torch.set_num_threads(2)

DIMS = (4, 4, 2, 4)
GEOM = LatticeGeometry(DIMS)


def _ops(U, kappa):
    """(port operator on the kernel layout, JAX planar operator, the JAX
    complex spinor -> port v0 map)."""
    import mugiq_tpu.pallas.dslash_kernel as dk
    from mugiq_tpu import params as jp
    from mugiq_tpu.dirac import make_dirac
    from mugiq_tpu.planar.convert import spinor_to_planar
    from mugiq_tpu.planar.dirac import WilsonDiracPlanar

    jop, _, _ = jax_operator(np.asarray(U), DIMS, kappa, False)
    d = make_dirac(jnp.asarray(U), jp.GaugeParam(dims=DIMS),
                   jp.InvertParam(kappa=kappa))
    planar = WilsonDiracPlanar.from_complex(d)

    def v0s(psi):
        pl = spinor_to_planar(psi).astype(jnp.float32)
        return pl, torch.from_numpy(np.array(dk.to_kernel_spinor(pl)))

    return port_operator(jop), planar, v0s


def test_block_lanczos_degenerate_free_field():
    from mugiq_tpu.planar.block_lanczos import (
        block_lanczos_hermitian_realpair as jax_block)

    op, planar, v0s = _ops(fields.unit_gauge(GEOM), 0.12)
    jv0, v0 = v0s(fields.random_spinor(GEOM, seed=3, dtype=jnp.complex64))
    kw = dict(n_ev=6, n_kr=24, block_size=4, tol=1e-5, max_restarts=80,
              which="SR")
    res = block_lanczos_hermitian_realpair(op.MdagM, v0, re_im_axis=1,
                                           matvec_batch=op.MdagM, **kw)
    ref = jax_block(planar.MdagM, jv0, re_im_axis=0, **kw)
    assert res.converged and ref.converged
    want = np.sort(ref.evals)
    assert want[1] - want[0] < 1e-6          # a degenerate cluster
    np.testing.assert_allclose(np.sort(res.evals), want, rtol=2e-4)


def test_block_lanczos_matches_nonblock():
    from mugiq_tpu.planar.block_lanczos import (
        block_lanczos_hermitian_realpair as jax_block)

    U = fields.random_gauge(GEOM, seed=5, dtype=jnp.complex64)
    op, planar, v0s = _ops(np.asarray(U, np.complex128), 0.11)
    jv0, v0 = v0s(fields.random_spinor(GEOM, seed=4, dtype=jnp.complex64))
    kw = dict(n_ev=4, n_kr=24, tol=1e-5, max_restarts=100, which="SR")
    res_b = block_lanczos_hermitian_realpair(op.MdagM, v0, block_size=2,
                                             re_im_axis=1, **kw)
    res_1 = lanczos_hermitian_realpair(op.MdagM, v0, re_im_axis=1, **kw)
    ref = jax_block(planar.MdagM, jv0, block_size=2, re_im_axis=0, **kw)
    assert res_b.converged and res_1.converged and ref.converged
    np.testing.assert_allclose(np.sort(res_b.evals), np.sort(res_1.evals),
                               rtol=1e-4)
    np.testing.assert_allclose(np.sort(res_b.evals), np.sort(ref.evals),
                               rtol=1e-4)


@pytest.mark.parametrize("kw, match", [
    (dict(v0=torch.ones((2, 4)), n_kr=4, re_im_axis=0), "too small"),
    (dict(v0=torch.ones((3, 2, 4)), n_kr=16, re_im_axis=1,
          v0_is_block=True), "block has"),
    (dict(v0=torch.ones((2, 4)), n_kr=9, re_im_axis=0, n_ev=6), "keep=")])
def test_block_lanczos_validation(kw, match):
    kw = dict(kw)
    n_ev = kw.pop("n_ev", 2)
    with pytest.raises(ValueError, match=match):
        block_lanczos_hermitian_realpair(lambda p: p, n_ev=n_ev,
                                         block_size=4, **kw)


def test_block_lanczos_bf16_basis():
    from mugiq_tpu.planar.block_lanczos import (
        block_lanczos_hermitian_realpair as jax_block)

    rng = np.random.default_rng(5)
    n = 96
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = (A + A.conj().T) / 2
    Ar = np.block([[A.real, -A.imag], [A.imag, A.real]]).astype(np.float32)
    v0 = rng.standard_normal(2 * n).astype(np.float32)
    At = torch.from_numpy(Ar)
    seen = []

    def mv(v):
        seen.append(v.dtype)
        return At @ v.float()

    kw = dict(n_ev=4, n_kr=32, block_size=4, re_im_axis=0, tol=1e-4,
              max_restarts=200, which="SR")
    res = block_lanczos_hermitian_realpair(mv, torch.from_numpy(v0),
                                           basis_dtype=torch.bfloat16, **kw)
    Aj = jnp.asarray(Ar)
    ref = jax_block(lambda v: Aj @ v.astype(jnp.float32), jnp.asarray(v0),
                    basis_dtype=jnp.bfloat16, **kw)
    assert set(seen) == {torch.bfloat16}
    want = np.linalg.eigvalsh(A)[:4]
    np.testing.assert_allclose(res.evals[:4], want, atol=5e-2)
    np.testing.assert_allclose(res.evals[:4], ref.evals[:4], atol=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_twins_equal_per_vector(dtype):
    from mugiq_tpu_torch.kernels.parity import parity_hop
    from mugiq_tpu_torch.production import build_packed_schur
    from mugiq_tpu_torch.params import DslashType, GaugeParam, InvertParam

    U = np.asarray(fields.weak_gauge(GEOM, eps=0.4, seed=2,
                                     dtype=jnp.complex128))
    op = port_operator(jax_operator(U, DIMS, 0.12, True)[0])
    blk = torch.from_numpy(rand((3,) + op.field_shape, 4)).to(dtype)
    for name in ("M", "Mdag", "MdagM"):
        f = getattr(op, name)
        assert torch.equal(f(blk), torch.stack([f(v) for v in blk]))
    pc = build_packed_schur(U, GaugeParam(dims=DIMS), InvertParam(
        kappa=0.12, csw=1.1, dslash_type=DslashType.CLOVER_WILSON),
        device="cpu")
    pe = torch.from_numpy(rand((3,) + pc.field_shape, 5)).to(dtype)
    for name in ("M", "MdagM"):
        f = getattr(pc, name)
        assert torch.equal(f(pe), torch.stack([f(v) for v in pe]))
    one = parity_hop(pe, pc.U_e, pc.U_o, pc.Y, 0, False, kappa2=0.01,
                     psi_out=pe)
    assert torch.equal(one, torch.stack([
        parity_hop(v, pc.U_e, pc.U_o, pc.Y, 0, False, kappa2=0.01,
                   psi_out=v) for v in pe]))


def test_production_block_matches_single_vector():
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.params import EigParam, GaugeParam, InvertParam
    from mugiq_tpu_torch.production import compute_evecs_production

    U = load_gauge_np("weak:0.5", LatticeGeometry(DIMS), seed=1)
    out = {}
    for b in (1, 4):
        ep = EigParam(n_ev=4, n_kr=16, tol=1e-6, max_restarts=100,
                      use_poly_acc=True, poly_deg=8, a_min=0.15,
                      block_size=b)
        res, evals, _, resids = compute_evecs_production(
            U, GaugeParam(dims=DIMS), InvertParam(kappa=0.13), ep,
            device="cpu")
        assert res.converged and max(resids) < 1e-5
        out[b] = evals
    np.testing.assert_allclose(out[4], out[1], rtol=1e-5)
