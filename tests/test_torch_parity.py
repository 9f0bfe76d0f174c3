"""K6 and the packed even-odd operator (mugiq_tpu_torch.schur_kernel,
kernels/parity.py) on the CPU, against the JAX package.

* pack_parity / unpack_parities / pack_parity_gauge and
  invert_chiral_blocks_np against the JAX functions: exact (the same
  selections, the same numpy inverse);
* the port's SchurDiracKernelPacked (K6's twin), built by
  production.build_packed_schur, against the JAX complex validation
  operator mugiq_tpu.schur.SchurDirac (asymmetric, fp64) on the even
  sites: M, Mdag, MdagM, MMdag, Wilson and clover csw 1.1, at the shape of
  tests/test_schur_packed.py; the port runs f32, so 2e-5 of max |out|, the
  tolerance of the JAX packed-vs-validation test;
* the identity that ties K6 to K1: with psi_o = A_oo^-1 kappa D_oe psi_e
  (from K1 applied to (psi_e, 0)), K1(psi_e, psi_o) has the even half
  M_pc psi_e and a vanishing odd half; f32 sums in two orders, 1e-6 of
  max |M_pc psi_e|;
* one slow test against JAX SchurDiracKernelPacked itself (interpret-mode
  Pallas), Wilson, clover and bf16 links: both run f32 arithmetic on the
  same (bf16-rounded) links and blocks, 1e-5 of max |out|.

Extents are even and distinct (the checkerboard needs even ones).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu_torch import schur_kernel as sk
from mugiq_tpu_torch.kernels.parity import parity_hop
from mugiq_tpu_torch.kernels.wilson import clover_apply_plain, wilson_m_plain
from mugiq_tpu_torch.params import (DslashType, EigOperator, GaugeParam,
                                    InvertParam)

from torch_ref import port_packed_operator, rand

torch.set_num_threads(2)

SHAPE = (4, 2, 6, 8)           # T, Z, Y, X: even and distinct
KAPPA = 0.12
OPS = ("M", "Mdag", "MdagM", "MMdag")


def _gauge(dims, seed=11):
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    return load_gauge_np("weak:0.3", LatticeGeometry(dims), seed=seed)


def _inv(clover):
    return InvertParam(kappa=KAPPA, csw=1.1 if clover else 0.0,
                       dslash_type=(DslashType.CLOVER_WILSON if clover
                                    else DslashType.WILSON))


def test_pack_unpack_match_jax():
    import mugiq_tpu.pallas.schur_kernel as jsk

    T, Z, Y, X = SHAPE
    f = rand((T, 24, Z, Y * X), 1)
    for parity in (0, 1):
        np.testing.assert_array_equal(
            sk.pack_parity(torch.from_numpy(f), Y, parity).numpy(),
            np.asarray(jsk.pack_parity(jnp.asarray(f), Y, parity)))
    e = rand((T, 24, Z, Y * X // 2), 2)
    o = rand((T, 24, Z, Y * X // 2), 3)
    full = sk.unpack_parities(torch.from_numpy(e), torch.from_numpy(o), Y)
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(jsk.unpack_parities(jnp.asarray(e),
                                                     jnp.asarray(o), Y)))
    np.testing.assert_array_equal(
        sk.unpack_parities(sk.pack_parity(torch.from_numpy(f), Y, 0),
                           sk.pack_parity(torch.from_numpy(f), Y, 1),
                           Y).numpy(), f)
    U = rand((T, 4, 18, Z, Y * X), 4)
    for parity in (0, 1):
        np.testing.assert_array_equal(
            sk.pack_parity_gauge(torch.from_numpy(U), Y, parity).numpy(),
            np.asarray(jsk.pack_parity_gauge(jnp.asarray(U), Y, parity)))


def test_invert_chiral_blocks_matches_jax():
    from mugiq_tpu.clover_np import invert_chiral_blocks_np
    from mugiq_tpu_torch.clover_np import (clover_chiral_blocks_np,
                                           clover_field_np,
                                           invert_chiral_blocks_np as port)

    T, Z, Y, X = SHAPE
    A = clover_chiral_blocks_np(clover_field_np(_gauge((X, Y, Z, T)),
                                                KAPPA, 1.1))
    np.testing.assert_array_equal(port(A), invert_chiral_blocks_np(A))


def _complex_to_kernel(c):
    """complex [T, Z, Y, X, 4, 3] -> [T, 24, Z, Y*X]."""
    T, Z, Y, X = c.shape[:4]
    q = np.transpose(c, (0, 4, 5, 1, 2, 3))           # [T,4,3,Z,Y,X]
    return np.stack([q.real, q.imag], 1).reshape(T, 24, Z, Y * X)


@pytest.mark.parametrize("clover", [False, True])
def test_packed_operator_matches_validation(clover):
    from mugiq_tpu import params as jp
    from mugiq_tpu.dirac import make_dirac
    from mugiq_tpu.schur import SchurDirac
    from mugiq_tpu_torch.production import build_packed_schur

    dims = (4, 4, 2, 4)                # the shape of test_schur_packed.py
    U = _gauge(dims)
    gp = GaugeParam(dims=dims)
    op = build_packed_schur(U, gp, _inv(clover), device="cpu")
    jip = jp.InvertParam(kappa=KAPPA, csw=1.1 if clover else 0.0,
                         dslash_type=(jp.DslashType.CLOVER_WILSON if clover
                                      else jp.DslashType.WILSON))
    ref_op = SchurDirac.from_dirac(make_dirac(jnp.asarray(U),
                                              jp.GaugeParam(dims=dims), jip))
    T, Z, Y, X = dims[3], dims[2], dims[1], dims[0]
    g = np.random.default_rng(5)
    psi = (g.standard_normal((T, Z, Y, X, 4, 3))
           + 1j * g.standard_normal((T, Z, Y, X, 4, 3)))
    pe = op.pack_even(torch.from_numpy(
        _complex_to_kernel(psi).astype(np.float32)))
    for name in OPS:
        ref = _complex_to_kernel(np.asarray(getattr(ref_op, name)(
            jnp.asarray(psi))))
        got = op.unpack_even(getattr(op, name)(pe)).numpy()
        np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max(),
                                   err_msg=name)


@pytest.mark.parametrize("clover", [False, True])
@pytest.mark.parametrize("dagger", [False, True])
def test_k6_k1_identity(clover, dagger):
    from mugiq_tpu_torch.clover_np import invert_chiral_blocks_np
    from mugiq_tpu_torch.production import build_kernel_dirac

    T, Z, Y, X = SHAPE
    U = _gauge((X, Y, Z, T), seed=2)
    gp = GaugeParam(dims=(X, Y, Z, T))
    full = build_kernel_dirac(U, gp, _inv(clover), device="cpu")
    ainv = None
    if clover:
        blocks = full.A144.reshape(T, 2, 6, 6, 2, Z, Y * X).numpy()
        ainv = sk.pack_parity(torch.from_numpy(invert_chiral_blocks_np(
            blocks)).reshape(T, 144, Z, Y * X), Y, 1)
    pc = sk.SchurDiracKernelPacked(
        full.U_k, KAPPA, Y,
        A_blocks=(None if not clover
                  else full.A144.reshape(T, 2, 6, 6, 2, Z, Y * X)))
    pe = torch.from_numpy(rand(pc.field_shape, 7))
    k1 = full.Mdag if dagger else full.M
    # odd half of K1(psi_e, 0) is -kappa D_oe psi_e
    psi_o = -sk.pack_parity(k1(sk.unpack_parities(pe, torch.zeros_like(pe),
                                                  Y)), Y, 1)
    if clover:
        psi_o = clover_apply_plain(ainv, psi_o)
    r = k1(sk.unpack_parities(pe, psi_o, Y))
    mpc = (pc.Mdag if dagger else pc.M)(pe)
    scale = float(mpc.abs().max())
    assert float((sk.pack_parity(r, Y, 0) - mpc).abs().max()) <= 1e-6 * scale
    assert float(sk.pack_parity(r, Y, 1).abs().max()) <= 1e-6 * scale


def test_parity_hop_twin_is_the_full_hop_restricted():
    """Mode 0 of the twin equals the odd half of the full operator's hop
    term: -(M psi - psi) / kappa on an input supported on even sites."""
    T, Z, Y, X = SHAPE
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 3, 0.5))
    pe = torch.from_numpy(rand((T, 24, Z, Y * X // 2), 4))
    full = sk.unpack_parities(pe, torch.zeros_like(pe), Y)
    hop = -(wilson_m_plain(full, U, None, 0.5, False, Y) - full) / 0.5
    got = parity_hop(pe, sk.pack_parity_gauge(U, Y, 1),
                     sk.pack_parity_gauge(U, Y, 0), Y, 1, False)
    np.testing.assert_allclose(got.numpy(), sk.pack_parity(hop, Y, 1).numpy(),
                               atol=1e-5 * float(hop.abs().max()))


def test_parity_hop_rejects_bad_arguments():
    T, Z, Y, X = SHAPE
    pe = torch.zeros((T, 24, Z, Y * X // 2))
    U = torch.zeros((T, 4, 18, Z, Y * X // 2))
    A = torch.zeros((T, 144, Z, Y * X // 2))
    with pytest.raises(ValueError, match="even extents"):
        parity_hop(torch.zeros((3, 24, Z, Y * X // 2)),
                   torch.zeros((3, 4, 18, Z, Y * X // 2)),
                   torch.zeros((3, 4, 18, Z, Y * X // 2)), Y, 0, False)
    with pytest.raises(ValueError, match="psi_out"):
        parity_hop(pe, U, U, Y, 0, False, kappa2=0.1)
    with pytest.raises(ValueError, match="first-pass"):
        parity_hop(pe, U, U, Y, 0, False, kappa2=0.1, psi_out=pe, A_post=A)
    with pytest.raises(ValueError, match="combine"):
        parity_hop(pe, U, U, Y, 0, False, A_comb=A)
    with pytest.raises(ValueError, match="parity_out"):
        parity_hop(pe, U, U, Y, 2, False)
    m = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        parity_hop(pe.to(m), U.to(m), U.to(m), Y, 0, False)
    with pytest.raises(ValueError, match="even extents"):
        sk.SchurDiracKernelPacked(torch.zeros((4, 4, 18, 2, 3 * 4)), 0.1, 3)


@pytest.mark.slow
@pytest.mark.parametrize("clover,precision", [(False, "f32"), (True, "f32"),
                                              (True, "bf16")])
def test_packed_operator_matches_pallas(clover, precision):
    import mugiq_tpu.pallas.schur_kernel as jsk
    from mugiq_tpu.production import build_packed_schur

    from mugiq_tpu import params as jp

    dims = (8, 6, 2, 4)
    jip = jp.InvertParam(kappa=KAPPA, csw=1.1 if clover else 0.0,
                         dslash_type=(jp.DslashType.CLOVER_WILSON if clover
                                      else jp.DslashType.WILSON))
    jop = build_packed_schur(_gauge(dims), jp.GaugeParam(dims=dims), jip,
                             precision=precision)
    assert isinstance(jop, jsk.SchurDiracKernelPacked)
    op = port_packed_operator(jop)
    pe = rand(op.field_shape, 9)
    for name in OPS:
        ref = np.asarray(getattr(jop, name)(jnp.asarray(pe)))
        got = op.operator(EigOperator[name])(torch.from_numpy(pe)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)
