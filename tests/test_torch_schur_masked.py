"""The masked even-even preconditioned operator (dirac_kernel.py
SchurDiracKernel, M_pc = 1 - kappa^2 P_e D P_o D with two K4 hops per
application) against the JAX package, at 4^4, Wilson.

* Against the JAX SchurDiracKernel (pallas/dirac_kernel.py:59), whose
  hops are the Pallas kernel dslash_hop_pallas in interpret mode, on the
  same numpy-seeded kernel-layout links and field: 1e-5 of max |out| (f32
  summation order), M, M^dag and M^dag M.  Slow: each compiles an
  interpret-mode kernel, ~30 s of CPU (K4's twin against that kernel runs
  by default in tests/test_torch_hop.py).
* Against the JAX complex validation operator (schur.SchurDirac, the
  reference tests/test_pallas.py:92 holds the JAX kernel operator to) on
  a weak SU(3) gauge: M, M^dag, M^dag M, 1e-5 of max |out|.
* Tied to the port's packed operator (SchurDiracKernelPacked, K6's twin)
  on even fields: the masked output is unpack(packed output), 1e-6 of
  max; the parity masks equal the JAX parity_masks_kernel; the masked
  operator computes at odd extents, where the packed one raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu_torch.dirac_kernel import SchurDiracKernel, parity_masks_kernel
from mugiq_tpu_torch.kernels.wilson import dslash_hop_plain
from mugiq_tpu_torch.params import EigOperator
from mugiq_tpu_torch.schur_kernel import (SchurDiracKernelPacked, pack_parity,
                                          unpack_parities)

from torch_ref import rand

torch.set_num_threads(2)

T, Z, Y, X = 4, 4, 4, 4
KAPPA = 0.13


def _fields():
    U = rand((T, 4, 18, Z, Y * X), 2, 0.5)
    psi = rand((T, 24, Z, Y * X), 3)
    return U, psi


def _close(got, want, tol):
    """max |got - want| <= tol max |want|, real or complex."""
    want = np.asarray(want).astype(np.complex128)
    err = np.abs(np.asarray(got).astype(np.complex128) - want).max()
    assert err <= tol * np.abs(want).max(), err / np.abs(want).max()


def _vs_jax_kernel(names):
    from mugiq_tpu.pallas.dirac_kernel import SchurDiracKernel as JSchur

    U, psi = _fields()
    jop = JSchur(U_k=jnp.asarray(U), kappa=KAPPA, Y=Y)
    op = SchurDiracKernel(torch.from_numpy(U), KAPPA, Y)
    assert op.field_shape == tuple(jop.field_shape)
    assert op.dtype == torch.float32
    for name in names:
        want = getattr(jop, name)(jnp.asarray(psi))
        got = getattr(op, name)(torch.from_numpy(psi))
        _close(got.numpy(), want, 1e-5)


@pytest.mark.slow
def test_masked_matches_jax_schur_kernel():
    _vs_jax_kernel(["M", "Mdag", "MdagM"])


def test_masked_matches_jax_complex_schur():
    from mugiq_tpu import fields
    from mugiq_tpu.dirac import make_dirac
    from mugiq_tpu.lattice import LatticeGeometry
    from mugiq_tpu.pallas.dslash_kernel import (from_kernel_spinor,
                                                to_kernel_gauge,
                                                to_kernel_spinor)
    from mugiq_tpu.params import DslashType, GaugeParam, InvertParam
    from mugiq_tpu.planar.convert import (gauge_to_planar,
                                          spinor_from_planar,
                                          spinor_to_planar)
    from mugiq_tpu.schur import SchurDirac

    geom = LatticeGeometry((X, Y, Z, T))
    d = make_dirac(fields.weak_gauge(geom, eps=0.4, seed=8,
                                     dtype=jnp.complex64),
                   GaugeParam(dims=geom.dims),
                   InvertParam(dslash_type=DslashType.WILSON, kappa=KAPPA))
    ref = SchurDirac.from_dirac(d)
    op = SchurDiracKernel(torch.from_numpy(np.array(
        to_kernel_gauge(gauge_to_planar(d.U)))), KAPPA, Y)
    psi = fields.random_spinor(geom, seed=5, dtype=jnp.complex64)
    psi_k = torch.from_numpy(np.array(to_kernel_spinor(
        spinor_to_planar(psi))))
    for name in ("M", "Mdag", "MdagM"):
        want = np.asarray(getattr(ref, name)(psi))
        got = spinor_from_planar(from_kernel_spinor(
            jnp.asarray(getattr(op, name)(psi_k).numpy()), Y=Y))
        _close(got, want, 1e-5)


@pytest.mark.parametrize("name", ["M", "Mdag", "MdagM", "MMdag"])
def test_masked_ties_packed_operator(name):
    U, psi = (torch.from_numpy(a) for a in _fields())
    masked = SchurDiracKernel(U, KAPPA, Y)
    packed = SchurDiracKernelPacked(U, KAPPA, Y)
    pe = pack_parity(psi, Y, 0)
    zero = torch.zeros_like(pe)
    got = masked.operator(EigOperator[name])(unpack_parities(pe, zero, Y))
    want = unpack_parities(packed.operator(EigOperator[name])(pe), zero, Y)
    _close(got.numpy(), want.numpy(), 1e-6)
    assert torch.equal(masked.project_even(got), got)


def test_parity_masks_match_jax():
    from mugiq_tpu.pallas.dirac_kernel import parity_masks_kernel as jmasks

    for dims in ((4, 4, 4, 4), (3, 5, 2, 6)):
        even, odd = parity_masks_kernel(*dims, device="cpu")
        je, jo = jmasks(*dims)
        assert torch.equal(even, torch.from_numpy(np.array(je)))
        assert torch.equal(odd, torch.from_numpy(np.array(jo)))


def test_masked_computes_at_odd_extents():
    """At (T, Z, Y, X) = (3, 5, 2, 6) the masked operator is its
    definition, pe - kappa^2 P_e D P_o D pe (the packed one raises)."""
    t, z, y, x = 3, 5, 2, 6
    U = torch.from_numpy(rand((t, 4, 18, z, y * x), 4, 0.5))
    psi = torch.from_numpy(rand((t, 24, z, y * x), 5))
    op = SchurDiracKernel(U, KAPPA, y)
    e, o = parity_masks_kernel(t, z, y, x, device="cpu")
    for dagger, name in ((False, "M"), (True, "Mdag")):
        pe = e * psi
        want = pe - KAPPA ** 2 * e * dslash_hop_plain(
            o * dslash_hop_plain(pe, U, dagger, y), U, dagger, y)
        assert torch.equal(getattr(op, name)(psi), want)
    with pytest.raises(ValueError):
        SchurDiracKernelPacked(U, KAPPA, y)
