"""K7a, K4-halo and K7b (the halo-extended Wilson operator, bare hop and
parity hop of one rank's block, kernels/wilson.py wilson_m_halo and
dslash_hop_halo, kernels/parity.py parity_hop_halo): their plain PyTorch
twins on the CPU.

* Slab ties, without JAX: a global (X, Y, Z, T) = (4, 4, 4, 8) field is
  split into the blocks of every mesh kind ((2, 1) t only, (4, 1) with a
  t extent of 2 per rank, i.e. boundary rows only, (2, 2) t and z,
  (2, 2, 2) t, z and y, and (1, 1) one rank); each block's halos are
  filled from the global field (LatticeMesh.ext_block, what the exchange
  gives) and the K7 outputs, concatenated, equal K1's / K6's twin on the
  global field to 1e-6 of max |out| (the same f32 arithmetic per site;
  in practice exact).  Every variant: M / M^dag, Wilson / clover, f32 /
  bf16 links; K4-halo's D / D^dag against K4's twin; K7b's four modes,
  both output parities.  The interior and boundary row launches give the
  single pass bit for bit.
* The same with bf16 spinors (the bf16 Krylov basis under --mesh): every
  mesh kind, each kernel's variants with f32 and bf16 links, the bf16
  block outputs (bf16 tensors, as the JAX out_shape) against the bf16-psi
  K1 / K4 / K6 twins on the global field within 2^-7 of max |out| (both
  round an f32 result once; summation orders differ), the split equal to
  the single pass bit for bit.
* Against the JAX package: wilson_m_pallas_ext, wilson_m_pallas_ext2,
  _pallas_ext3, _m_interior_call, _m_boundary_call
  (parallel/shard_dslash.py) and parity_hop_pallas_ext,
  parity_hop_pallas_extzy (pallas/schur_kernel.py) in interpret mode, as
  tests/test_shard_dslash.py runs them, on the same extended inputs
  sliced from one seeded global field as a rank sees them: 2e-5 of max
  |out| (f32 summation order; both upcast the same bf16 links).  The
  3D form of each runs by default; the other functions and the full
  variant sweep are marked slow: each case compiles an interpret-mode
  kernel, ~20-30 s each on a CPU.  K4-halo's twin against
  dslash_hop_pallas_ext, dslash_hop_pallas_ext2 and the kappa=None forms
  of _pallas_ext3, _m_interior_call and _m_boundary_call is slow in every
  case (its slab tie to K4's twin, which tests/test_torch_hop.py holds to
  dslash_hop_pallas, runs by default).  On a bf16 psi_ext the JAX kernels
  write bf16 and the twins are held within 2^-7 of max |out|: one default
  case each for _pallas_ext3 (K7a) and parity_hop_pallas_extzy (K7b), the
  rest of the sweep (K4-halo's included) slow.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu_torch.kernels.parity import parity_hop_halo, parity_hop_plain
from mugiq_tpu_torch.kernels.wilson import (dslash_hop_halo,
                                            dslash_hop_plain, wilson_m_halo,
                                            wilson_m_plain)
from mugiq_tpu_torch.parallel.mesh import LatticeMesh
from mugiq_tpu_torch.schur_kernel import pack_parity, pack_parity_gauge

from torch_ref import rand

torch.set_num_threads(2)

DIMS = (4, 4, 4, 8)                    # X, Y, Z, T
X, Y, Z, T = DIMS
XH = X // 2
KAPPA = 0.12
MESHES = [(2, 1), (4, 1), (2, 2), (2, 2, 2), (1, 1)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


#: a bf16 output against its reference: one bf16 ulp (2^-8 relative) of
#: the largest output either way of a rounding boundary
BF16_TOL = 2.0 ** -7


def _fields(prec, psi_prec="f32"):
    dt = DTYPES[prec]
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 2, 0.5)).to(dt)
    A = torch.from_numpy(rand((T, 144, Z, Y * X), 3, 0.2)).to(dt)
    psi = torch.from_numpy(rand((T, 24, Z, Y * X), 1)).to(DTYPES[psi_prec])
    return psi, U, A


def _ut_shift(U):
    """Ut_shift[t] = U_t(t - 1) on the global lattice."""
    return torch.roll(U[:, 3], 1, 0)


def _rank_inputs(m, psi, U, A, clover):
    """What K7a gets on rank m: the extended spinor and links, the shifted
    t-links, the interior clover blocks."""
    ze, ye = m.z_ext, m.y_ext
    return (m.ext_block(psi, t=True, z=ze, y=ye),
            m.ext_block(U, t=False, z=ze, y=ye),
            m.ext_block(_ut_shift(U), t=False, z=ze, y=ye),
            m.local_block(A).contiguous() if clover else None)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("clover", [False, True])
@pytest.mark.parametrize("dagger", [False, True])
def test_k7a_slab_tie(mesh, prec, clover, dagger):
    psi, U, A = _fields(prec)
    ref = wilson_m_plain(psi, U, A if clover else None, KAPPA, dagger, Y)
    got = torch.zeros_like(ref)
    for r in range(LatticeMesh(mesh, DIMS).world):
        m = LatticeMesh(mesh, DIMS, rank=r)
        args = _rank_inputs(m, psi, U, A, clover)
        Yl, Tl = m.local["y"], m.local["t"]
        full = wilson_m_halo(*args, KAPPA, dagger, Yl, m.z_ext, m.y_ext)
        split = torch.full_like(full, float("nan"))
        if Tl > 2:
            wilson_m_halo(*args, KAPPA, dagger, Yl, m.z_ext, m.y_ext,
                          rows=(1, Tl - 2, 1), out=split)
        wilson_m_halo(*args, KAPPA, dagger, Yl, m.z_ext, m.y_ext,
                      rows=(0, 2, Tl - 1) if Tl > 1 else (0, 1, 1),
                      out=split)
        assert torch.equal(split, full)
        m.local_block(got)[...] = full
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-6


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("dagger", [False, True])
def test_k4_halo_slab_tie(mesh, prec, dagger):
    psi, U, A = _fields(prec)
    ref = dslash_hop_plain(psi, U, dagger, Y)
    got = torch.zeros_like(ref)
    for r in range(LatticeMesh(mesh, DIMS).world):
        m = LatticeMesh(mesh, DIMS, rank=r)
        args = _rank_inputs(m, psi, U, A, False)[:3]
        Yl, Tl = m.local["y"], m.local["t"]
        full = dslash_hop_halo(*args, dagger, Yl, m.z_ext, m.y_ext)
        split = torch.full_like(full, float("nan"))
        if Tl > 2:
            dslash_hop_halo(*args, dagger, Yl, m.z_ext, m.y_ext,
                            rows=(1, Tl - 2, 1), out=split)
        dslash_hop_halo(*args, dagger, Yl, m.z_ext, m.y_ext,
                        rows=(0, 2, Tl - 1) if Tl > 1 else (0, 1, 1),
                        out=split)
        assert torch.equal(split, full)
        m.local_block(got)[...] = full
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-6


def _packed_fields(prec, parity_out, psi_prec="f32"):
    psi, U, A = _fields(prec, psi_prec)
    pin = 1 - parity_out
    Uo = pack_parity_gauge(U, Y, parity_out)
    Ui = pack_parity_gauge(U, Y, pin)
    return dict(psi_in=pack_parity(psi, Y, pin),
                psi_out=torch.from_numpy(rand((T, 24, Z, Y * XH), 5)).to(
                    DTYPES[psi_prec]),
                U_out=Uo, U_in=Ui, Ut_in=torch.roll(Ui[:, 3], 1, 0),
                A=pack_parity(A, Y, parity_out))


MODES = {"pass1": lambda f: {}, "pass1+A_post": lambda f: dict(A_post=f["A"]),
         "pass2": lambda f: dict(kappa2=KAPPA ** 2, psi_out=f["psi_out"]),
         "pass2+A_comb": lambda f: dict(kappa2=KAPPA ** 2,
                                        psi_out=f["psi_out"], A_comb=f["A"])}


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dagger", [False, True])
def test_k7b_slab_tie(mesh, prec, mode, dagger):
    for parity_out in (0, 1):
        f = _packed_fields(prec, parity_out)
        kw = MODES[mode](f)
        ref = parity_hop_plain(f["psi_in"], f["U_out"], f["U_in"], Y,
                               parity_out, dagger, **kw)
        got = torch.zeros_like(ref)
        for r in range(LatticeMesh(mesh, DIMS).world):
            m = LatticeMesh(mesh, DIMS, rank=r)
            ze, ye = m.z_ext, m.y_ext
            Tl = m.local["t"]
            loc = {k: (m.local_block(v) if torch.is_tensor(v) else v)
                   for k, v in kw.items()}
            args = (m.ext_block(f["psi_in"], t=True, z=ze, y=ye),
                    m.ext_block(f["U_out"], t=False, z=ze, y=ye),
                    m.ext_block(f["U_in"], t=False, z=ze, y=ye),
                    m.ext_block(f["Ut_in"], t=False, z=ze, y=ye),
                    m.local["y"], parity_out, dagger, ze, ye)
            full = parity_hop_halo(*args, **loc)
            split = torch.full_like(full, float("nan"))
            if Tl > 2:
                parity_hop_halo(*args, **loc, rows=(1, Tl - 2, 1), out=split)
            parity_hop_halo(*args, **loc, rows=(0, 2, Tl - 1), out=split)
            assert torch.equal(split, full)
            m.local_block(got)[...] = full
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        assert err <= 1e-6, (parity_out, err)


def _bf16_tie(got, ref):
    assert got.dtype == ref.dtype == torch.bfloat16
    err = float((got.float() - ref.float()).abs().max())
    assert err <= BF16_TOL * float(ref.float().abs().max()), err


def _blocks(mesh, rank_out, like):
    """The blocks of every rank of `mesh`, rank_out(m) -> (single pass,
    the interior and boundary launches into one output), concatenated;
    each rank's two forms equal bit for bit."""
    got = torch.zeros_like(like)
    for r in range(LatticeMesh(mesh, DIMS).world):
        m = LatticeMesh(mesh, DIMS, rank=r)
        full, split = rank_out(m)
        assert full.dtype == torch.bfloat16 and torch.equal(split, full)
        m.local_block(got)[...] = full
    return got


def _split(fn, m):
    """fn(rows=, out=) as a single pass and as the interior / boundary
    launches into one output."""
    Tl = m.local["t"]
    full = fn()
    split = torch.full_like(full, float("nan"))
    if Tl > 2:
        fn(rows=(1, Tl - 2, 1), out=split)
    fn(rows=(0, 2, Tl - 1), out=split)
    return full, split


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("kernel", ["k7a", "k4h", "k7b"])
def test_bf16_psi_slab_tie(mesh, kernel):
    """bf16 halo-extended spinors: the blocks of every rank against the
    bf16-psi K1 / K4 / K6 twins on the global field, f32 and bf16 links,
    each kernel's variants (K7a: M / M^dag, Wilson / clover; K4-halo: D /
    D^dag; K7b: its four modes, both output parities, one dagger each)."""
    for prec in ("f32", "bf16"):
        psi, U, A = _fields(prec, "bf16")
        if kernel == "k7b":
            for (mode, dagger), po in itertools.product(
                    zip(MODES, (False, True, True, False)), (0, 1)):
                f = _packed_fields(prec, po, "bf16")
                kw = MODES[mode](f)
                ref = parity_hop_plain(f["psi_in"], f["U_out"], f["U_in"], Y,
                                       po, dagger, **kw)

                def rank_out(m):
                    ext = dict(z=m.z_ext, y=m.y_ext)
                    loc = {k: (m.local_block(v) if torch.is_tensor(v)
                               else v) for k, v in kw.items()}
                    args = (m.ext_block(f["psi_in"], t=True, **ext),
                            m.ext_block(f["U_out"], t=False, **ext),
                            m.ext_block(f["U_in"], t=False, **ext),
                            m.ext_block(f["Ut_in"], t=False, **ext),
                            m.local["y"], po, dagger, m.z_ext, m.y_ext)
                    return _split(lambda **k: parity_hop_halo(*args, **loc,
                                                              **k), m)

                _bf16_tie(_blocks(mesh, rank_out, ref), ref)
            continue
        for clover, dagger in itertools.product(
                (False, True) if kernel == "k7a" else (False,),
                (False, True)):
            if kernel == "k7a":
                ref = wilson_m_plain(psi, U, A if clover else None, KAPPA,
                                     dagger, Y)
            else:
                ref = dslash_hop_plain(psi, U, dagger, Y)

            def rank_out(m):
                pe, Ue, Ute, Al = _rank_inputs(m, psi, U, A, clover)
                Yl = m.local["y"]
                if kernel == "k7a":
                    return _split(lambda **k: wilson_m_halo(
                        pe, Ue, Ute, Al, KAPPA, dagger, Yl, m.z_ext, m.y_ext,
                        **k), m)
                return _split(lambda **k: dslash_hop_halo(
                    pe, Ue, Ute, dagger, Yl, m.z_ext, m.y_ext, **k), m)

            _bf16_tie(_blocks(mesh, rank_out, ref), ref)


def test_halo_wrappers_check_their_inputs():
    psi, U, A = _fields("f32")
    m = LatticeMesh((2, 2, 2), DIMS, rank=3)
    pe, Ue, Ute, _ = _rank_inputs(m, psi, U, A, False)
    with pytest.raises(ValueError, match="z-extended too"):
        wilson_m_halo(pe, Ue, Ute, None, KAPPA, False, 2, False, True)
    with pytest.raises(ValueError, match="rows"):
        wilson_m_halo(pe, Ue, Ute, None, KAPPA, False, 2, True, True,
                      rows=(3, 2, 1))
    odd = LatticeMesh((2, 1), (4, 4, 4, 6))
    pk = pack_parity(torch.from_numpy(rand((6, 24, 4, 16), 1)), 4, 1)
    Uk = pack_parity_gauge(torch.from_numpy(rand((6, 4, 18, 4, 16), 2)), 4, 0)
    with pytest.raises(ValueError, match="even block extents"):
        parity_hop_halo(odd.ext_block(pk), odd.local_block(Uk),
                        odd.local_block(Uk), odd.local_block(Uk[:, 3]), 4, 0,
                        False, False, False)


# ---------------------------------------------------------------------------
# against the JAX package (interpret-mode Pallas)
# ---------------------------------------------------------------------------

def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jx(t, prec):
    a = jnp.asarray(_np(t))
    return a.astype(jnp.bfloat16) if prec == "bf16" else a


def _close(got, want, psi_prec="f32"):
    """2e-5 of max |out| (f32 summation order); a bf16 psi_ext gives bf16
    out on both sides, held to BF16_TOL."""
    tol = 2e-5
    if psi_prec == "bf16":
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        tol = BF16_TOL
    want = np.asarray(want, np.float32)
    err = np.abs(_np(got) - want).max() / np.abs(want).max()
    assert err <= tol, err


def _k7a_vs_jax(form, prec, clover, dagger, psi_prec="f32"):
    """form: ext (t mesh), ext2 (t x z), ext3 (t x z x y), interior and
    boundary (t mesh and t x z mesh halves of the overlap split); prec the
    links' and clover's, psi_prec the spinors' (and the output's)."""
    import mugiq_tpu.parallel.shard_dslash as sd

    psi, U, A = _fields(prec, psi_prec)
    mesh = {"ext": (2, 1), "ext2": (2, 2), "ext3": (2, 2, 2),
            "interior": (2, 2), "boundary": (2, 1)}[form]
    m = LatticeMesh(mesh, DIMS, rank=m_rank(mesh))
    pe, Ue, Ute, Al = _rank_inputs(m, psi, U, A, clover)
    Yl, Tl = m.local["y"], m.local["t"]
    got = wilson_m_halo(pe, Ue, Ute, Al, KAPPA, dagger, Yl, m.z_ext,
                        m.y_ext)
    jA = None if Al is None else _jx(Al, prec)
    kw = dict(kappa=KAPPA, dagger=dagger, has_clover=clover)
    if form == "ext":
        want = sd.wilson_m_pallas_ext(_jx(pe, psi_prec), _jx(Ue, prec),
                                      _jx(Ute, prec), jA, Y=Yl, **kw)
    elif form == "ext2":
        want = sd.wilson_m_pallas_ext2(_jx(pe, psi_prec),
                                       _jx(Ue, prec), _jx(Ute, prec), jA,
                                       Y=Yl, **kw)
    elif form == "ext3":
        want = sd._pallas_ext3(_jx(pe, psi_prec), _jx(Ue, prec),
                               _jx(Ute, prec), jA, Y=Yl, **kw)
    else:
        # the split's inputs: the z-extended block without t halos, the
        # unshifted t-links, and (boundary) the halos and the previous
        # rank's last t-link row
        z = m.z_ext
        psi_loc = _jx(pe[1:-1], psi_prec)
        ut_loc = _jx(m.ext_block(U[:, 3], t=False, z=z), prec)
        if form == "interior":
            want = sd._m_interior_call(psi_loc, _jx(Ue, prec), ut_loc, jA,
                                       Yl, KAPPA, dagger, clover, z_ext=z)
            got = got[1:Tl - 1]
        else:
            want = sd._m_boundary_call(
                psi_loc, _jx(pe[:1], psi_prec),
                _jx(pe[-1:], psi_prec), _jx(Ue, prec), ut_loc,
                _jx(Ute[:1], prec), jA, Yl, KAPPA, dagger, clover, z_ext=z)
            got = got[[0, Tl - 1]]
    _close(got, want, psi_prec)


def _k4h_vs_jax(form, prec, dagger, psi_prec="f32"):
    """K4-halo's twin against the hop forms of the JAX halo kernels: ext
    (t mesh), ext2 (t x z), ext3 (t x z x y), interior and boundary (t x z
    and t halves of the overlap split), kappa=None."""
    import mugiq_tpu.parallel.shard_dslash as sd

    psi, U, A = _fields(prec, psi_prec)
    mesh = {"ext": (2, 1), "ext2": (2, 2), "ext3": (2, 2, 2),
            "interior": (2, 2), "boundary": (2, 1)}[form]
    m = LatticeMesh(mesh, DIMS, rank=m_rank(mesh))
    pe, Ue, Ute, _ = _rank_inputs(m, psi, U, A, False)
    Yl, Tl = m.local["y"], m.local["t"]
    got = dslash_hop_halo(pe, Ue, Ute, dagger, Yl, m.z_ext, m.y_ext)
    jp = _jx(pe, psi_prec)
    if form == "ext":
        want = sd.dslash_hop_pallas_ext(jp, _jx(Ue, prec), _jx(Ute, prec),
                                        Y=Yl, dagger=dagger)
    elif form == "ext2":
        want = sd.dslash_hop_pallas_ext2(jp, _jx(Ue, prec), _jx(Ute, prec),
                                         Y=Yl, dagger=dagger)
    elif form == "ext3":
        want = sd._pallas_ext3(jp, _jx(Ue, prec), _jx(Ute, prec), None,
                               Y=Yl, kappa=None, dagger=dagger)
    else:
        z = m.z_ext
        psi_loc = _jx(pe[1:-1], psi_prec)
        ut_loc = _jx(m.ext_block(U[:, 3], t=False, z=z), prec)
        if form == "interior":
            want = sd._m_interior_call(psi_loc, _jx(Ue, prec), ut_loc, None,
                                       Yl, None, dagger, False, z_ext=z)
            got = got[1:Tl - 1]
        else:
            want = sd._m_boundary_call(
                psi_loc, _jx(pe[:1], psi_prec),
                _jx(pe[-1:], psi_prec), _jx(Ue, prec), ut_loc,
                _jx(Ute[:1], prec), None, Yl, None, dagger, False, z_ext=z)
            got = got[[0, Tl - 1]]
    _close(got, want, psi_prec)


def m_rank(mesh):
    """A rank away from the origin on every partitioned axis, so that a
    wrong neighbour or halo cannot hide behind the periodic wrap."""
    shape = tuple(mesh) + (1,) * (3 - len(mesh))
    return LatticeMesh(mesh, DIMS).rank_of(
        {"t": shape[0] - 1, "z": shape[1] - 1, "y": shape[2] - 1})


def _k7b_vs_jax(form, prec, mode, dagger, parity_out,
                psi_prec="f32"):
    import mugiq_tpu.pallas.schur_kernel as jsk

    f = _packed_fields(prec, parity_out, psi_prec)
    kw = MODES[mode](f)
    mesh = (2, 1) if form == "ext" else (2, 2, 2)
    m = LatticeMesh(mesh, DIMS, rank=m_rank(mesh))
    ze, ye = m.z_ext, m.y_ext
    Yl = m.local["y"]
    ext = dict(z=ze, y=ye)
    pe = m.ext_block(f["psi_in"], t=True, **ext)
    Uo = m.ext_block(f["U_out"], t=False, **ext)
    Ui = m.ext_block(f["U_in"], t=False, **ext)
    Ut = m.ext_block(f["Ut_in"], t=False, **ext)
    loc = {k: (m.local_block(v).contiguous() if torch.is_tensor(v) else v)
           for k, v in kw.items()}
    got = parity_hop_halo(pe, Uo, Ui, Ut, Yl, parity_out, dagger, ze, ye,
                          **loc)
    off = torch.from_numpy(np.array(jsk.offset_mask(T, Z, Y, XH,
                                                    parity_out)))
    jkw = dict(dagger=dagger, kappa2=loc.get("kappa2"),
               psi_out=(None if "psi_out" not in loc
                        else _jx(loc["psi_out"], psi_prec)),
               A_post=(None if "A_post" not in loc
                       else _jx(loc["A_post"], prec)),
               A_comb=(None if "A_comb" not in loc
                       else _jx(loc["A_comb"], prec)))
    args = (_jx(pe, psi_prec), _jx(Uo, prec), _jx(Ui, prec),
            _jx(Ut, prec), jnp.asarray(m.ext_block(off, t=False,
                                                   **ext).numpy()))
    if form == "ext":
        want = jsk.parity_hop_pallas_ext(*args, Y=Yl, **jkw)
    else:
        want = jsk.parity_hop_pallas_extzy(*args, Y=Yl, z_ext=ze, y_ext=ye,
                                           **jkw)
    _close(got, want, psi_prec)


# by default the most general form of each (t, z and y halos; clover,
# M^dag, bf16 links); the other forms and variants are the slow sweep
K7A_DEFAULT = [("ext3", "bf16", True, True)]
K7B_DEFAULT = [("extzy", "bf16", "pass2+A_comb", True, 0)]
K4H_DEFAULT = [("ext3", "f32", False)]
# bf16 spinors (the bf16 basis under --mesh, bf16 links as its
# configuration runs): the 3D forms by default
K7A_BF16_DEFAULT = [("ext3", "bf16", True, True, "bf16")]
K7B_BF16_DEFAULT = [("extzy", "bf16", "pass2+A_comb", True, 0, "bf16")]


@pytest.mark.parametrize("case", K7A_DEFAULT, ids=lambda c: "-".join(
    map(str, c)))
def test_k7a_matches_jax(case):
    _k7a_vs_jax(*case)


@pytest.mark.parametrize("case", K7B_DEFAULT, ids=lambda c: "-".join(
    map(str, c)))
def test_k7b_matches_jax(case):
    _k7b_vs_jax(*case)


@pytest.mark.parametrize("case", K4H_DEFAULT, ids=lambda c: "-".join(
    map(str, c)))
def test_k4_halo_matches_jax(case):
    _k4h_vs_jax(*case)


@pytest.mark.parametrize("case", K7A_BF16_DEFAULT + K7B_BF16_DEFAULT,
                         ids=lambda c: "-".join(map(str, c)))
def test_bf16_psi_matches_jax(case):
    """bf16 psi_ext into the JAX halo kernels and the twins: bf16 out on
    both sides, within 2^-7 of max |out|."""
    (_k7a_vs_jax if len(case) == 5 else _k7b_vs_jax)(*case)


@pytest.mark.slow
@pytest.mark.parametrize("case", [
    c + ("bf16",) for c in itertools.product(
        ["ext", "ext2", "ext3", "interior", "boundary"], ["f32", "bf16"],
        [False, True], [False, True])
    if c + ("bf16",) not in K7A_BF16_DEFAULT] + [
    c + ("bf16",) for c in itertools.product(
        ["ext", "extzy"], ["f32", "bf16"], list(MODES), [False, True], [0, 1])
    if c + ("bf16",) not in K7B_BF16_DEFAULT],
    ids=lambda c: "-".join(map(str, c)))
def test_bf16_psi_matches_jax_sweep(case):
    (_k7a_vs_jax if len(case) == 5 else _k7b_vs_jax)(*case)


@pytest.mark.slow
@pytest.mark.parametrize("case", itertools.product(
    ["ext", "ext2", "ext3", "interior", "boundary"], ["f32", "bf16"],
    [False, True], ["bf16"]), ids=lambda c: "-".join(map(str, c)))
def test_k4_halo_bf16_psi_matches_jax_sweep(case):
    _k4h_vs_jax(*case)


@pytest.mark.slow
@pytest.mark.parametrize("case", [
    c for c in itertools.product(["ext", "ext2", "ext3", "interior",
                                  "boundary"], ["f32", "bf16"],
                                 [False, True], [False, True])
    if c not in K7A_DEFAULT], ids=lambda c: "-".join(map(str, c)))
def test_k7a_matches_jax_sweep(case):
    _k7a_vs_jax(*case)


@pytest.mark.slow
@pytest.mark.parametrize("case", [
    c for c in itertools.product(["ext", "ext2", "ext3", "interior",
                                  "boundary"], ["f32", "bf16"],
                                 [False, True])
    if c not in K4H_DEFAULT], ids=lambda c: "-".join(map(str, c)))
def test_k4_halo_matches_jax_sweep(case):
    _k4h_vs_jax(*case)


@pytest.mark.slow
@pytest.mark.parametrize("case", [
    c for c in itertools.product(["ext", "extzy"], ["f32", "bf16"],
                                 list(MODES), [False, True], [0, 1])
    if c not in K7B_DEFAULT], ids=lambda c: "-".join(map(str, c)))
def test_k7b_matches_jax_sweep(case):
    _k7b_vs_jax(*case)
