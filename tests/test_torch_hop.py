"""K4 (the bare Wilson hop D psi, kernels/wilson.py dslash_hop): the port's
plain twin against the JAX package, and K4's twin against every TPU tiling
of the hop and K1's twin against every tiling of the fused operator.

* Against the JAX complex operator (mugiq_tpu.ops.dslash dslash_hop and
  dslash_hop_dagger, XLA on the CPU) on a weak SU(3) gauge at (X, Y, Z,
  T) = (8, 4, 4, 8), the JAX Pallas tests' lattice: 1e-5 of max |out| (f32
  summation order).
* Against the JAX Pallas kernel dslash_hop_pallas in interpret mode, as
  tests/test_pallas.py runs it, on the same numpy-seeded kernel-layout
  inputs at 4^4: f32 1e-5 of max |out|.  By default the project-then-shift
  body (ps=True, the headline hop of bench.py); the rest is the slow
  sweep (each case compiles an interpret-mode kernel, 10-40 s of CPU):
  ps=False, the grouped-lane dslash_hop_pallas_gl (by=2), both daggers,
  bf16 spinor and links, out_dtype=bf16.  bf16 outputs: both round f32
  sums to bf16, so they differ by at most one bf16 ulp of the largest
  output (2^-7 of max |out|).
* The TPU tilings (slow, 30-140 s each): K4's twin against
  dslash_hop_pallas_glt, _yb, _win (and its gl_by form),
  dslash_block_kernel's _db and _blocked; K1's twin against
  wilson_m_pallas_glt, _yb and _win (and gl_by), Wilson and clover, both
  daggers, at the shapes tests/test_pallas.py and test_pallas_win.py run:
  1e-5 of max |out|.  They compute K4's or K1's function in other TPU
  block structures, so K4 and K1 are their port.
* On the CPU without JAX: K4 equals the sum of the eight directed hops of
  K5's twin and psi - kappa K4 psi equals K1's twin (1e-6 of max); a bf16
  output is the f32 result rounded to nearest even; the wrapper rejects
  what the kernel does not take.  K4 itself is held to the twin on the
  card in tests/test_torch_gpu.py.
"""

import contextlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu_torch.kernels.hop_dir import dslash_hop_dir_plain
from mugiq_tpu_torch.kernels.wilson import (dslash_hop, dslash_hop_plain,
                                            wilson_m_plain)

from torch_ref import rand

torch.set_num_threads(2)

T, Z, Y, X = 4, 4, 4, 4
BF16 = {"f32": None, "bf16": jnp.bfloat16}


def _inputs(seed=1):
    psi = rand((T, 24, Z, Y * X), seed)
    U = rand((T, 4, 18, Z, Y * X), seed + 1, 0.5)
    return psi, U


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol * np.abs(want).max(), err / np.abs(want).max()


def test_twin_matches_jax_complex_operator():
    """D and D^dag of the JAX complex validation operator (the references
    tests/test_pallas.py holds the Pallas kernel to)."""
    from mugiq_tpu import fields
    from mugiq_tpu.lattice import LatticeGeometry
    from mugiq_tpu.ops.dslash import dslash_hop as jhop
    from mugiq_tpu.ops.dslash import dslash_hop_dagger as jhop_dag
    from mugiq_tpu.pallas.dslash_kernel import (to_kernel_gauge,
                                                to_kernel_spinor)
    from mugiq_tpu.planar.convert import gauge_to_planar, spinor_to_planar

    geom = LatticeGeometry((8, 4, 4, 8))
    U = fields.weak_gauge(geom, eps=0.4, seed=3, dtype=jnp.complex64)
    psi = fields.random_spinor(geom, seed=4, dtype=jnp.complex64)
    U_k = torch.from_numpy(np.array(to_kernel_gauge(gauge_to_planar(U))))
    psi_k = torch.from_numpy(np.array(to_kernel_spinor(
        spinor_to_planar(psi))))
    for dagger, ref in ((False, jhop), (True, jhop_dag)):
        want = np.asarray(to_kernel_spinor(spinor_to_planar(ref(U, psi))))
        _close(dslash_hop(psi_k, U_k, dagger, 4).numpy(), want, 1e-5)


def _vs_pallas(kind, dagger, psi_t, link_t, out_t):
    import mugiq_tpu.pallas.dslash_kernel as dk

    psi, U = _inputs()
    jp = jnp.asarray(psi) if BF16[psi_t] is None else \
        jnp.asarray(psi).astype(jnp.bfloat16)
    ju = jnp.asarray(U) if BF16[link_t] is None else \
        jnp.asarray(U).astype(jnp.bfloat16)
    kw = dict(Y=Y, dagger=dagger, out_dtype=BF16[out_t])
    if kind == "gl":
        want = dk.dslash_hop_pallas_gl(jp, ju, ju[:, 3], by=2, ps=True, **kw)
    else:
        want = dk.dslash_hop_pallas(jp, ju, ju[:, 3], ps=kind == "ps", **kw)
    tp = torch.from_numpy(np.array(jp.astype(jnp.float32)))
    tu = torch.from_numpy(np.array(ju.astype(jnp.float32)))
    if psi_t == "bf16":
        tp = tp.to(torch.bfloat16)
    if link_t == "bf16":
        tu = tu.to(torch.bfloat16)
    odt = None if out_t == "f32" else torch.bfloat16
    got = dslash_hop(tp, tu, dagger, Y, out_dtype=odt)
    assert got.dtype == (odt or tp.dtype)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           2.0 ** -7 if out_t == "bf16" else 1e-5)


# (body, dagger, psi, links, out): ps = project-then-shift, base, gl
PALLAS_DEFAULT = [("ps", False, "f32", "f32", "f32")]
PALLAS_SWEEP = [c for c in
                [(k, d, "f32", "f32", "f32") for k in ("base", "ps", "gl")
                 for d in (False, True)]
                + [("ps", True, "bf16", "bf16", "bf16"),
                   ("base", False, "f32", "bf16", "f32"),
                   ("gl", False, "bf16", "f32", "bf16"),
                   ("base", True, "f32", "f32", "bf16")]
                if c not in PALLAS_DEFAULT]


@pytest.mark.parametrize("case", PALLAS_DEFAULT,
                         ids=lambda c: "-".join(map(str, c)))
def test_twin_matches_pallas_hop(case):
    _vs_pallas(*case)


@pytest.mark.slow
@pytest.mark.parametrize("case", PALLAS_SWEEP,
                         ids=lambda c: "-".join(map(str, c)))
def test_twin_matches_pallas_hop_sweep(case):
    _vs_pallas(*case)


# ---------------------------------------------------------------------------
# the TPU tilings of K4 and K1 (the shapes of tests/test_pallas.py and
# tests/test_pallas_win.py: X=8, Y=4, Z=4, T=8)
# ---------------------------------------------------------------------------

TT, TZ, TY, TX = 8, 4, 4, 8


def _tiling_inputs():
    psi = rand((TT, 24, TZ, TY * TX), 11)
    U = rand((TT, 4, 18, TZ, TY * TX), 12, 0.5)
    A = rand((TT, 144, TZ, TY * TX), 13, 0.2)
    return psi, U, A


HOP_TILINGS = {
    "glt": lambda dk, p, u, d: dk.dslash_hop_pallas_glt(
        p, u, u[:, 3], Y=TY, by=2, bt=2, dagger=d),
    "yb": lambda dk, p, u, d: dk.dslash_hop_pallas_yb(
        p, u, u[:, 3], Y=TY, by=2, dagger=d),
    "win": lambda dk, p, u, d: _win().dslash_hop_pallas_win(
        p, u, u[:, 3], Y=TY, bt=2, dagger=d),
    "win-gl": lambda dk, p, u, d: _win().dslash_hop_pallas_win(
        p, u, u[:, 3], Y=TY, bt=2, gl_by=2, dagger=d),
    "db": lambda dk, p, u, d: _block().dslash_hop_pallas_db(
        p, u, u[:, 3], Y=TY, bt=2),
    "blocked": lambda dk, p, u, d: _block().dslash_hop_pallas_blocked(
        p, u, u[:, 3], Y=TY, bt=2),
}
# db and blocked have no dagger form
HOP_CASES = [(k, d) for k in HOP_TILINGS for d in (False, True)
             if not (k in ("db", "blocked") and d)]


def _win():
    import mugiq_tpu.pallas.dslash_win_kernel as dwk
    return dwk


def _block():
    import mugiq_tpu.pallas.dslash_block_kernel as dbk
    return dbk


@pytest.mark.slow
@pytest.mark.parametrize("case", HOP_CASES,
                         ids=lambda c: f"{c[0]}-dagger{int(c[1])}")
def test_hop_twin_matches_tiling(case):
    import mugiq_tpu.pallas.dslash_kernel as dk

    kind, dagger = case
    psi, U, _ = _tiling_inputs()
    # the db kernel's slot arithmetic (lax.rem of the int32 program id by
    # a Python int) traces only with 64-bit types off, as on the TPU; the
    # test suite turns them on
    with (jax.enable_x64(False) if kind == "db"
          else contextlib.nullcontext()):
        want = HOP_TILINGS[kind](dk, jnp.asarray(psi), jnp.asarray(U),
                                 dagger)
    got = dslash_hop(torch.from_numpy(psi), torch.from_numpy(U), dagger, TY)
    _close(got.numpy(), want, 1e-5)


M_TILINGS = {
    "glt": lambda dk, p, u, a, d, c: dk.wilson_m_pallas_glt(
        p, u, u[:, 3], a, Y=TY, kappa=0.12, by=2, bt=2, dagger=d,
        has_clover=c),
    "yb": lambda dk, p, u, a, d, c: dk.wilson_m_pallas_yb(
        p, u, u[:, 3], a, Y=TY, kappa=0.12, by=2, dagger=d, has_clover=c),
    "win": lambda dk, p, u, a, d, c: _win().wilson_m_pallas_win(
        p, u, u[:, 3], a, Y=TY, kappa=0.12, bt=2, dagger=d, has_clover=c),
    "win-gl": lambda dk, p, u, a, d, c: _win().wilson_m_pallas_win(
        p, u, u[:, 3], a, Y=TY, kappa=0.12, bt=2, gl_by=2, dagger=d,
        has_clover=c),
}
M_CASES = list(itertools.product(M_TILINGS, [False, True], [False, True]))


@pytest.mark.slow
@pytest.mark.parametrize("case", M_CASES, ids=lambda c: (
    f"{c[0]}-dagger{int(c[1])}-clover{int(c[2])}"))
def test_wilson_m_twin_matches_tiling(case):
    import mugiq_tpu.pallas.dslash_kernel as dk

    kind, dagger, clover = case
    psi, U, A = _tiling_inputs()
    ja = jnp.asarray(A) if clover else jnp.zeros((1,), jnp.float32)
    want = M_TILINGS[kind](dk, jnp.asarray(psi), jnp.asarray(U), ja, dagger,
                           clover)
    got = wilson_m_plain(torch.from_numpy(psi), torch.from_numpy(U),
                         torch.from_numpy(A) if clover else None, 0.12,
                         dagger, TY)
    _close(got.numpy(), want, 1e-5)


# ---------------------------------------------------------------------------
# without JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dagger", [False, True])
def test_hop_is_the_sum_of_directed_hops_and_k1(dagger):
    psi, U = (torch.from_numpy(a) for a in _inputs(seed=5))
    hop = dslash_hop(psi, U, dagger, Y)
    acc = sum(dslash_hop_dir_plain(psi, U, mu, sg, dagger, Y)
              for mu in range(4) for sg in (1, -1))
    scale = float(hop.abs().max())
    assert float((hop - acc).abs().max()) <= 1e-6 * scale
    k1 = wilson_m_plain(psi, U, None, 0.13, dagger, Y)
    assert float((psi - 0.13 * hop - k1).abs().max()) <= \
        1e-6 * float(k1.abs().max())


@pytest.mark.parametrize("psi_t, link_t", [("f32", "bf16"), ("bf16", "f32"),
                                           ("bf16", "bf16")])
def test_bf16_types(psi_t, link_t):
    """bf16 inputs upcast exactly; the output defaults to psi's dtype and a
    bf16 output is the f32 result rounded to nearest even."""
    psi, U = (torch.from_numpy(a) for a in _inputs(seed=7))
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    p, u = psi.to(dt[psi_t]), U.to(dt[link_t])
    f32 = dslash_hop(p, u, False, Y, out_dtype=torch.float32)
    assert torch.equal(f32, dslash_hop_plain(p.float(), u.float(), False, Y))
    out = dslash_hop(p, u, False, Y)
    assert out.dtype == dt[psi_t]
    b = dslash_hop(p, u, False, Y, out_dtype=torch.bfloat16)
    assert b.dtype == torch.bfloat16 and torch.equal(b, f32.bfloat16())


def test_wrapper_rejects_bad_input():
    psi = torch.zeros((2, 24, 2, 4))
    U = torch.zeros((2, 4, 18, 2, 4))
    m = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        dslash_hop(psi.to(m), U.to(m), False, 2)
    with pytest.raises(ValueError, match="no kernel"):
        dslash_hop(psi.to(m), U.to(m), False, 2, out_dtype=torch.float16)
