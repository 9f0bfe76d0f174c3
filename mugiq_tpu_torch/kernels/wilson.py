"""The Wilson stencil kernels on the kernel layout.

* K1 :func:`wilson_m` (``csrc/wilson_m.cu`` and its pair and block-tile
  sources, chosen by :func:`launch_plan`; kernels in ``csrc/wilson_m.cuh``):
  the fused Wilson(-clover) operator M / M^dag,
  f32 or bf16 spinors (the output in psi's dtype), one field or a batch
  of them in one launch; replaces
  ``mugiq_tpu/pallas/dslash_kernel.py`` ``wilson_m_pallas`` (:395) and
  ``wilson_m_pallas_gl`` (:747), and their vmap over a block.
* K4 :func:`dslash_hop` (``csrc/dslash_hop.cu`` and its pair source;
  kernel in ``csrc/dslash_hop.cuh``): the bare hopping term D psi /
  D^dag psi, f32 or bf16 in and out; replaces ``dslash_hop_pallas``
  (:436) and ``dslash_hop_pallas_gl`` (:726).
* K7a :func:`wilson_m_halo` and K4-halo :func:`dslash_hop_halo`
  (``csrc/wilson_m_halo.cuh``, a source per spinor type and pair form):
  the same on one rank's halo-extended block, f32 or bf16 spinors (the
  output in psi's dtype); replace the kernels of
  ``mugiq_tpu/parallel/shard_dslash.py``.

:func:`launch_plan` picks each call's instance (two sites a thread for
bf16 spinors where that is legal, block tiles for a batch).

Each launches its CUDA kernel for CUDA tensors and runs its plain PyTorch
twin (``*_plain``) for CPU tensors; any other device raises.  All are
memory-bound (~1-6 flop/byte against an f32 ridge of ~20); see the
sources for their design.
"""

import ctypes
from typing import NamedTuple

import torch

from ..gamma import gamma_matrices
from . import build

#: Wilson hopping term flop count per site (8 hops, half-spinor form)
FLOP_PER_SITE = 1320

_P, _I = ctypes.c_void_p, ctypes.c_int
#: the C entry points of K1's sources: psi, U, A, out, T, Z, Y, X, kappa,
#: dagger, clover, link_bf16, batch, stream
ENTRY_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I,
                  _I, _I, _P]


#: spinor dtypes of the stencils (the output takes the input's)
SPINOR_DTYPES = (torch.float32, torch.bfloat16)

#: the source suffix of each stencil's one-site bf16-spinor instance; K4's
#: one-site source holds every type
ONE_SITE_BF16 = {"wilson_m": "_bf16", "parity_hop": "_bf16",
                 "dslash_hop": "", "wilson_m_halo": "_psi_bf16",
                 "dslash_hop_halo": "_psi_bf16"}
#: the stencils that take a batch of fields in one launch
BATCHED = ("wilson_m", "parity_hop")


class LaunchPlan(NamedTuple):
    """Which instance of a stencil runs a call (one launch)."""
    kernel: str
    spinor_bf16: bool
    #: two x-adjacent sites a thread, bf16 planes read four bytes at a time
    pair: bool
    #: block tiles of vectors that share the staged links (the kernel
    #: tiles the batch); else one vector a thread, the batch in grid y
    tiled: bool

    @property
    def source(self) -> str:
        """The kernel source (``csrc/<source>.cu``) that runs the plan."""
        if self.tiled:
            return f"{self.kernel}_staged" + ("_pair" if self.pair else "")
        if self.pair:
            return f"{self.kernel}_pair"
        return self.kernel + (ONE_SITE_BF16[self.kernel] if self.spinor_bf16
                              else "")


def launch_plan(kernel: str, batch: int, x_extent: int, spinor_bf16: bool,
                aligned: bool) -> LaunchPlan:
    """The launch of a call of `kernel` (K1 wilson_m, K6 parity_hop, K4
    dslash_hop, K7a wilson_m_halo, K4-halo dslash_hop_halo) on `batch`
    vectors whose x extent is x_extent (Xh for K6): pairs for bf16
    spinors where x_extent is even and every operand's base is two words
    aligned; block tiles for a batch of K1 or K6 (of pairs, for bf16); one
    site a thread for f32 spinors and for bf16 spinors that cannot pair."""
    if kernel not in ONE_SITE_BF16:
        raise ValueError(f"no launch plan for kernel {kernel!r}")
    if batch < 1:
        raise ValueError(f"empty batch: {batch}")
    if batch > 1 and kernel not in BATCHED:
        raise ValueError(f"{kernel} takes one field, not a batch of {batch}")
    pair = spinor_bf16 and x_extent % 2 == 0 and aligned
    tiled = batch > 1 and (pair or not spinor_bf16)
    return LaunchPlan(kernel, bool(spinor_bf16), pair, tiled)


def aligned_pairs(*ts) -> bool:
    """Every tensor's base two words aligned (the pair form's loads)."""
    return all(t.data_ptr() % (2 * t.element_size()) == 0
               for t in ts if t is not None)


def batch_shape(psi, what: str):
    """(batch, T, Z, last) of a field [T, 24, Z, last] (batch 1) or a
    batch of them [b, T, 24, Z, last]."""
    if psi.ndim not in (4, 5) or psi.shape[-3] != 24:
        raise ValueError(f"{what}: spinor shape {tuple(psi.shape)}, expected "
                         f"[T, 24, Z, .] or [b, T, 24, Z, .]")
    b = psi.shape[0] if psi.ndim == 5 else 1
    if b < 1:
        raise ValueError(f"{what}: empty batch")
    T, _, Z, last = psi.shape[-4:]
    return b, T, Z, last


# lattice direction -> axis of a [T, 4|3, 3, Z, Y, X] complex field
_AXIS = {0: 5, 1: 4, 2: 3, 3: 0}


def _cspinor(psi, Y):
    """[T, 24, Z, Y*X] -> complex [T, 4, 3, Z, Y, X]."""
    T, _, Z, YX = psi.shape
    p = psi.float().reshape(T, 2, 4, 3, Z, Y, YX // Y)
    return torch.complex(p[:, 0], p[:, 1])


def _rspinor(c):
    """complex [T, 4, 3, Z, Y, X] -> [T, 24, Z, Y*X]."""
    T, _, _, Z, Y, X = c.shape
    return torch.stack([c.real, c.imag], 1).reshape(T, 24, Z, Y * X)


def _clinks(U, Y):
    """[T, 4, 18, Z, Y*X] (f32|bf16) -> complex [T, 4, 3, 3, Z, Y, X]."""
    T, _, _, Z, YX = U.shape
    u = U.float().reshape(T, 4, 2, 3, 3, Z, Y, YX // Y)
    return torch.complex(u[:, :, 0], u[:, :, 1])


def hop_dir_complex(p, u, mu: int, sign: int, dagger: bool):
    """One directed hop on complex fields, with torch.roll neighbours and
    the full 4x4 spin projector: (1 - g_mu) U_mu(x) p(x+mu) for sign +1,
    (1 + g_mu) U_mu(x-mu)^dag p(x-mu) for sign -1; dagger (D^dag = g5 D g5)
    swaps the projectors.  p [T, 4, 3, Z, Y, X], u [T, 4, 3, 3, Z, Y, X]."""
    g = torch.as_tensor(gamma_matrices()[mu], dtype=p.dtype, device=p.device)
    eye = torch.eye(4, dtype=p.dtype, device=p.device)
    ax = _AXIS[mu]
    um = u[:, mu]                                       # [T, 3, 3, Z, Y, X]
    if sign > 0:
        v = torch.einsum("tabzyx,tsbzyx->tsazyx", um, torch.roll(p, -1, ax))
        sg = 1.0 if dagger else -1.0
    else:
        v = torch.einsum("tbazyx,tsbzyx->tsazyx",
                         torch.roll(um, 1, ax).conj(), torch.roll(p, 1, ax))
        sg = -1.0 if dagger else 1.0
    return torch.einsum("rs,tsazyx->trazyx", eye + sg * g, v)


def dslash_hop_plain(psi, U, dagger: bool, Y: int, out_dtype=None):
    """The hopping term D psi (dagger: D^dag psi) in plain PyTorch, the sum
    of hop_dir_complex over the 8 directed hops; spinor and links upcast to
    f32, f32 arithmetic, the result cast to out_dtype (default psi's
    dtype; bf16 rounds to nearest even, as XLA's astype).
    psi [T, 24, Z, Y*X], U [T, 4, 18, Z, Y*X] -> [T, 24, Z, Y*X]."""
    p = _cspinor(psi, Y)
    u = _clinks(U, Y)
    hop = torch.zeros_like(p)
    for mu in range(4):
        for sign in (1, -1):
            hop += hop_dir_complex(p, u, mu, sign, dagger)
    return _rspinor(hop).to(out_dtype or psi.dtype)


def clover_apply_plain(A144, psi):
    """Site-wise chiral 6x6 clover blocks times a spinor: A144 [T, 144, Z, V]
    (f32|bf16, upcast), psi [T, 24, Z, V] -> [T, 24, Z, V] f32, for any
    site axis V (full or packed volume)."""
    T, _, Z, V = psi.shape
    a = A144.float().reshape(T, 2, 6, 6, 2, Z, V)
    ac = torch.complex(a[:, :, :, :, 0], a[:, :, :, :, 1])
    p = psi.float().reshape(T, 2, 12, Z, V)
    # chiral blocks: spins (2 chi, 2 chi + 1) x colour, contiguous
    pv = torch.complex(p[:, 0], p[:, 1]).reshape(T, 2, 6, Z, V)
    d = torch.einsum("tckjzv,tcjzv->tckzv", ac, pv).reshape(T, 12, Z, V)
    return torch.cat([d.real, d.imag], 1)


def wilson_m_plain(psi, U, A144, kappa: float, dagger: bool, Y: int):
    """Plain PyTorch twin of the kernel: A psi - kappa D psi with the hop of
    dslash_hop_plain; spinor, links and clover upcast to f32 as in the
    kernel, the f32 result rounded once to psi's dtype (bf16: to nearest
    even); a batch [b, T, 24, Z, Y*X] one field at a time."""
    if psi.ndim == 5:
        return torch.stack([wilson_m_plain(p, U, A144, kappa, dagger, Y)
                            for p in psi])
    diag = psi.float() if A144 is None else clover_apply_plain(A144, psi)
    return (diag - kappa * dslash_hop_plain(psi, U, dagger, Y,
                                            torch.float32)).to(psi.dtype)


def wilson_m(psi, U, A144, kappa: float, dagger: bool, Y: int, out=None):
    """out = A psi - kappa D psi (M), or with the projectors swapped (M^dag).

    psi [T, 24, Z, Y*X] or a batch [b, T, 24, Z, Y*X], f32 or bf16 (out
    in psi's dtype, f32 arithmetic; a batch is one launch); U
    [T, 4, 18, Z, Y*X] phased links, f32 or bf16; A144 [T, 144, Z, Y*X]
    clover chiral blocks of U's dtype, or None for Wilson.  CUDA tensors
    launch the kernel (launch_plan picks its instance), CPU tensors run
    the twin.
    """
    if psi.device.type == "cpu":
        res = wilson_m_plain(psi, U, A144, kappa, dagger, Y)
        return res if out is None else out.copy_(res)
    if psi.device.type != "cuda":
        raise ValueError(f"wilson_m: no kernel for device {psi.device}")
    b, T, Z, YX = batch_shape(psi, "wilson_m")
    if YX % Y:
        raise ValueError(f"wilson_m: Y={Y} does not divide Y*X={YX}")
    dev = psi.device
    build.require(psi, "psi", psi.shape, SPINOR_DTYPES, dev)
    build.require(U, "U", (T, 4, 18, Z, YX), (torch.float32, torch.bfloat16),
                  dev)
    if A144 is not None:
        build.require(A144, "A144", (T, 144, Z, YX), (U.dtype,), dev)
    if out is None:
        out = torch.empty_like(psi)
    build.require(out, "out", psi.shape, (psi.dtype,), dev)
    if out.data_ptr() == psi.data_ptr():
        raise ValueError("wilson_m: out must not alias psi (neighbour reads)")
    bf = torch.bfloat16
    plan = launch_plan("wilson_m", b, YX // Y, psi.dtype == bf,
                       aligned_pairs(psi, U, A144, out))
    with torch.cuda.device(dev):
        rc = build.entry(plan.source, ENTRY_ARGTYPES)(
            psi.data_ptr(), U.data_ptr(),
            None if A144 is None else A144.data_ptr(), out.data_ptr(), T, Z,
            Y, YX // Y, float(kappa), int(dagger), int(A144 is not None),
            int(U.dtype == bf), b, build.stream_handle(dev))
    build.check(rc, "wilson_m")
    wilson_m.launches += 1
    return out


wilson_m.launches = 0


# ---------------------------------------------------------------------------
# K4: the bare hopping term
# ---------------------------------------------------------------------------

_HOP_DTYPES = (torch.float32, torch.bfloat16)
#: the C entry points of K4's sources: psi, U, out, T, Z, Y, X, dagger,
#: psi_bf16, link_bf16, out_bf16, stream
HOP_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]


def dslash_hop(psi, U, dagger: bool, Y: int, out_dtype=None, out=None):
    """K4: out = D psi (dagger: D^dag psi), the Wilson hopping term with no
    diagonal and no kappa.

    psi [T, 24, Z, Y*X] f32 or bf16; U [T, 4, 18, Z, Y*X] phased links, f32
    or bf16; the result in out_dtype (default: out's dtype if out is given,
    else psi's), f32 arithmetic.  CUDA tensors launch the kernel
    (launch_plan picks its instance), CPU tensors run the twin."""
    odt = out_dtype or (psi.dtype if out is None else out.dtype)
    if psi.device.type == "cpu":
        res = dslash_hop_plain(psi, U, dagger, Y, odt)
        return res if out is None else out.copy_(res)
    if psi.device.type != "cuda":
        raise ValueError(f"dslash_hop: no kernel for device {psi.device}")
    T, _, Z, YX = psi.shape
    if YX % Y:
        raise ValueError(f"dslash_hop: Y={Y} does not divide Y*X={YX}")
    dev = psi.device
    build.require(psi, "psi", (T, 24, Z, YX), _HOP_DTYPES, dev)
    build.require(U, "U", (T, 4, 18, Z, YX), _HOP_DTYPES, dev)
    if odt not in _HOP_DTYPES:
        raise ValueError(f"dslash_hop: out_dtype {odt}, expected one of "
                         f"{_HOP_DTYPES}")
    if out is None:
        out = torch.empty(psi.shape, dtype=odt, device=dev)
    build.require(out, "out", psi.shape, (odt,), dev)
    if out.data_ptr() == psi.data_ptr():
        raise ValueError("dslash_hop: out must not alias psi (neighbour "
                         "reads)")
    bf = torch.bfloat16
    plan = launch_plan("dslash_hop", 1, YX // Y, psi.dtype == bf,
                       aligned_pairs(psi, U, out))
    with torch.cuda.device(dev):
        rc = build.entry(plan.source, HOP_ARGTYPES)(
            psi.data_ptr(), U.data_ptr(), out.data_ptr(), T, Z, Y, YX // Y,
            int(dagger), int(psi.dtype == bf), int(U.dtype == bf),
            int(odt == bf), build.stream_handle(dev))
    build.check(rc, "dslash_hop")
    dslash_hop.launches += 1
    return out


dslash_hop.launches = 0


# ---------------------------------------------------------------------------
# K7a and K4-halo: the halo-extended forms of one rank's block
# ---------------------------------------------------------------------------

#: the C entry points of K7a's sources: psi_ext, U, Ut, A, out, Zl, Yl, X,
#: t0, nrows, tstep, ext, kappa, dagger, clover, link_bf16, stream
HALO_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                 ctypes.c_float, _I, _I, _I, _P]
#: and of K4-halo's: psi_ext, U, Ut, out, Zl, Yl, X, t0, nrows, tstep,
#: ext, dagger, link_bf16, stream
HOP_HALO_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]


def halo_rows(rows, Tl: int) -> list:
    """The output rows of a launch: rows = (t0, nrows, tstep) gives
    t0 + k*tstep for k < nrows; None gives every row 0..Tl-1."""
    if rows is None:
        return list(range(Tl))
    t0, n, step = (int(v) for v in rows)
    out = [t0 + k * step for k in range(n)]
    if n < 1 or min(out) < 0 or max(out) >= Tl:
        raise ValueError(f"rows {rows} outside the block's {Tl} t-rows")
    return out


def halo_shapes(psi_ext, Y: int, z_ext: bool, y_ext: bool, Tl: int):
    """(Zl, Zp, Yp, W) of a halo-extended field [Tl+2, C, Zp, Yp*W] whose
    interior y extent is Y."""
    if y_ext and not z_ext:
        raise ValueError("a y-extended block is z-extended too (the JAX 3D "
                         "form)")
    Tp, _, Zp, YWp = psi_ext.shape
    Yp = Y + 2 if y_ext else Y
    if Tp != Tl + 2 or YWp % Yp:
        raise ValueError(f"extended field {tuple(psi_ext.shape)} does not fit "
                         f"Tl={Tl}, Y={Y}, y_ext={y_ext}")
    return (Zp - 2 if z_ext else Zp), Zp, Yp, YWp // Yp


def _interior(a, z_ext: bool, y_ext: bool, Yp: int):
    """The interior sites of [R, C, Zp, Yp*W] -> [R, C, Zl, Yl*W]."""
    R, C, Zp, YWp = a.shape
    a = a.reshape(R, C, Zp, Yp, YWp // Yp)
    if z_ext:
        a = a[:, :, 1:-1]
    if y_ext:
        a = a[:, :, :, 1:-1]
    return a.reshape(R, C, a.shape[2], -1)


def dslash_hop_halo_plain(psi_ext, U, Ut_shift, dagger: bool, Y: int,
                          z_ext: bool, y_ext: bool, rows=None,
                          out_dtype=None):
    """The hopping term at the interior sites of the given rows of a block,
    from halo-extended inputs, in plain PyTorch: neighbours by slicing the
    halo rows where an axis is extended and by torch.roll where it is not;
    the eight hops stacked, explicit products and sums (no batched GEMM),
    so that every output element's arithmetic is the same for any row set.
    psi_ext [Tl+2, 24, Zp, Yp*X] f32 or bf16, U [Tl, 4, 18, Zp, Yp*X],
    Ut_shift [Tl, 18, Zp, Yp*X] (U_t of global t-1), upcast to f32 ->
    [R, 24, Zl, Y*X], the f32 result rounded once to out_dtype (default
    psi_ext's dtype, as the TPU kernels' out_shape)."""
    Tl = U.shape[0]
    _, _, Yp, _ = halo_shapes(psi_ext, Y, z_ext, y_ext, Tl)
    r = torch.as_tensor(halo_rows(rows, Tl), device=psi_ext.device)
    p = _cspinor(psi_ext, Yp)                       # [Tl+2, 4, 3, Zp, Yp, X]
    pm, pc, pp = p[r], p[r + 1], p[r + 2]
    u = _clinks(U[r], Yp)                           # [R, 4, 3, 3, Zp, Yp, X]
    R, _, Zp, YXp = Ut_shift[r].shape
    ut = Ut_shift[r].float().reshape(R, 2, 3, 3, Zp, Yp, YXp // Yp)
    ut = torch.complex(ut[:, 0], ut[:, 1])          # [R, 3, 3, Zp, Yp, X]

    def at(a, d=(0, 0, 0)):
        """a at the interior sites displaced by d = (dz, dy, dx)."""
        for dim, s, ext in ((-3, d[0], z_ext), (-2, d[1], y_ext),
                            (-1, d[2], False)):
            if ext:
                a = a.narrow(dim, 1 + s, a.shape[dim] - 2)
            elif s:
                a = torch.roll(a, -s, dim)
        return a

    # the eight directed hops at once: neighbour spinors, the links that
    # multiply them (adjoint for backward hops), spin projectors
    fwd = ((0, 0, 1), (0, 1, 0), (1, 0, 0))
    nbr = ([at(pc, d) for d in fwd] + [at(pp)]
           + [at(pc, tuple(-v for v in d)) for d in fwd] + [at(pm)])
    lnk = ([at(u[:, mu]) for mu in range(4)]
           + [at(u[:, mu], tuple(-v for v in d)).transpose(1, 2).conj()
              for mu, d in enumerate(fwd)] + [at(ut).transpose(1, 2).conj()])
    g = torch.as_tensor(gamma_matrices(), dtype=p.dtype, device=p.device)
    eye = torch.eye(4, dtype=p.dtype, device=p.device)
    sf = 1.0 if dagger else -1.0                    # forward projector sign
    P = torch.cat([eye + sf * g, eye - sf * g])     # [8, 4, 4]
    V = torch.stack(nbr)                            # [8, R, 4, 3, Zl, Yl, X]
    L = torch.stack(lnk)                            # [8, R, 3, 3, Zl, Yl, X]
    # explicit products and sums: sum_b L[a, b] V[s, b], then sum_s P[r, s]
    w = (L.unsqueeze(2) * V.unsqueeze(3)).sum(4)
    h = (P.reshape(8, 1, 4, 4, 1, 1, 1, 1) * w.unsqueeze(2)).sum(3)
    return _rspinor(h.sum(0)).to(out_dtype or psi_ext.dtype)


def wilson_m_halo_plain(psi_ext, U, Ut_shift, A144, kappa: float,
                        dagger: bool, Y: int, z_ext: bool, y_ext: bool,
                        rows=None):
    """Plain PyTorch twin of K7a on the given rows: A psi - kappa D psi at
    the interior sites, with the hop of dslash_hop_halo_plain; A144
    [Tl, 144, Zl, Y*X] or None.  Returns [R, 24, Zl, Y*X], the f32 result
    rounded once to psi_ext's dtype (bf16: to nearest even), as
    wilson_m_plain."""
    Tl = U.shape[0]
    _, _, Yp, _ = halo_shapes(psi_ext, Y, z_ext, y_ext, Tl)
    r = torch.as_tensor(halo_rows(rows, Tl), device=psi_ext.device)
    pc = _interior(psi_ext[r + 1], z_ext, y_ext, Yp).float()
    diag = pc if A144 is None else clover_apply_plain(A144[r], pc)
    hop = dslash_hop_halo_plain(psi_ext, U, Ut_shift, dagger, Y, z_ext,
                                y_ext, rows, torch.float32)
    return (diag - kappa * hop).to(psi_ext.dtype)


def _halo_cpu(res, U, rows, out):
    """A twin's output rows placed as the kernel leaves them: the result
    itself for every row, else written into out (zeros of the twin's
    dtype if None)."""
    if out is None and rows is None:
        return res
    if out is None:
        out = torch.zeros((U.shape[0],) + tuple(res.shape[1:]),
                          dtype=res.dtype)
    out[halo_rows(rows, U.shape[0])] = res
    return out


def _halo_cuda(what, psi_ext, U, Ut_shift, Y, z_ext, y_ext, rows, out):
    """The operands K7a and K4-halo share, checked, and out allocated;
    returns (out, (t0, nrows, tstep), ext, Zl, X) for the launch."""
    Tl = U.shape[0]
    Zl, Zp, Yp, X = halo_shapes(psi_ext, Y, z_ext, y_ext, Tl)
    halo_rows(rows, Tl)
    if psi_ext.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {psi_ext.device}")
    dev = psi_ext.device
    build.require(psi_ext, "psi_ext", (Tl + 2, 24, Zp, Yp * X),
                  SPINOR_DTYPES, dev)
    build.require(U, "U", (Tl, 4, 18, Zp, Yp * X),
                  (torch.float32, torch.bfloat16), dev)
    build.require(Ut_shift, "Ut_shift", (Tl, 18, Zp, Yp * X), (U.dtype,), dev)
    oshape = (Tl, 24, Zl, Y * X)
    if out is None:
        out = torch.empty(oshape, dtype=psi_ext.dtype, device=dev)
    build.require(out, "out", oshape, (psi_ext.dtype,), dev)
    if out.data_ptr() == psi_ext.data_ptr():
        raise ValueError(f"{what}: out must not alias psi_ext")
    rows = (0, Tl, 1) if rows is None else tuple(int(v) for v in rows)
    return out, rows, 2 if y_ext else int(z_ext), Zl, X


def halo_plan(kernel, psi_ext, X, *operands) -> LaunchPlan:
    """The launch plan of a halo kernel's call (one field)."""
    return launch_plan(kernel, 1, X, psi_ext.dtype == torch.bfloat16,
                       aligned_pairs(psi_ext, *operands))


def wilson_m_halo(psi_ext, U, Ut_shift, A144, kappa: float, dagger: bool,
                  Y: int, z_ext: bool, y_ext: bool, rows=None, out=None):
    """K7a: out[rows] = (A psi - kappa D psi)[rows] (M, or M^dag) of one
    rank's block from its halo-extended input.

    psi_ext [Tl+2, 24, Zp, Yp*X] f32 or bf16 (Zp = Zl+2 if z_ext, Yp =
    Y+2 if y_ext; Y is the block's interior y extent); U [Tl, 4, 18, Zp,
    Yp*X]
    phased links with their z/y halos, f32 or bf16; Ut_shift [Tl, 18, Zp,
    Yp*X] with Ut_shift[t] = U_t(global t - 1); A144 [Tl, 144, Zl, Y*X] of
    U's dtype or None.  rows (t0, nrows, tstep) or None for all; out
    [Tl, 24, Zl, Y*X] in psi_ext's dtype (f32 arithmetic; rows outside
    the launch are left as they are).  CUDA tensors launch the kernel
    (launch_plan picks its instance), CPU tensors run the twin."""
    if psi_ext.device.type == "cpu":
        return _halo_cpu(wilson_m_halo_plain(psi_ext, U, Ut_shift, A144,
                                             kappa, dagger, Y, z_ext, y_ext,
                                             rows), U, rows, out)
    out, (t0, n, step), ext, Zl, X = _halo_cuda(
        "wilson_m_halo", psi_ext, U, Ut_shift, Y, z_ext, y_ext, rows, out)
    dev = out.device
    if A144 is not None:
        build.require(A144, "A144", (U.shape[0], 144, Zl, Y * X), (U.dtype,),
                      dev)
    plan = halo_plan("wilson_m_halo", psi_ext, X, U, Ut_shift, A144, out)
    with torch.cuda.device(dev):
        rc = build.entry(plan.source, HALO_ARGTYPES)(
            psi_ext.data_ptr(), U.data_ptr(), Ut_shift.data_ptr(),
            None if A144 is None else A144.data_ptr(), out.data_ptr(), Zl, Y,
            X, t0, n, step, ext, float(kappa), int(dagger),
            int(A144 is not None), int(U.dtype == torch.bfloat16),
            build.stream_handle(dev))
    build.check(rc, "wilson_m_halo")
    count_halo_launch(wilson_m_halo, psi_ext)
    return out


def count_halo_launch(kernel, psi_ext) -> None:
    """One launch of a halo kernel: its count, and that of its bf16-spinor
    form (`bf16_launches`, a part of `launches`)."""
    kernel.launches += 1
    kernel.bf16_launches += int(psi_ext.dtype == torch.bfloat16)


wilson_m_halo.launches = 0
wilson_m_halo.bf16_launches = 0


def dslash_hop_halo(psi_ext, U, Ut_shift, dagger: bool, Y: int, z_ext: bool,
                    y_ext: bool, rows=None, out=None):
    """K4-halo: out[rows] = (D psi)[rows] (dagger: D^dag psi) of one rank's
    block from its halo-extended input, with no diagonal and no kappa.

    The operands, halo forms and row sets of :func:`wilson_m_halo` (f32 or
    bf16 spinors, f32 or bf16 links, the output in the spinors' dtype).
    CUDA tensors launch the kernel (launch_plan picks its instance), CPU
    tensors run the twin."""
    if psi_ext.device.type == "cpu":
        return _halo_cpu(dslash_hop_halo_plain(psi_ext, U, Ut_shift, dagger,
                                               Y, z_ext, y_ext, rows),
                         U, rows, out)
    out, (t0, n, step), ext, Zl, X = _halo_cuda(
        "dslash_hop_halo", psi_ext, U, Ut_shift, Y, z_ext, y_ext, rows, out)
    dev = out.device
    plan = halo_plan("dslash_hop_halo", psi_ext, X, U, Ut_shift, out)
    with torch.cuda.device(dev):
        rc = build.entry(plan.source, HOP_HALO_ARGTYPES)(
            psi_ext.data_ptr(), U.data_ptr(), Ut_shift.data_ptr(),
            out.data_ptr(), Zl, Y, X, t0, n, step, ext, int(dagger),
            int(U.dtype == torch.bfloat16), build.stream_handle(dev))
    build.check(rc, "dslash_hop_halo")
    count_halo_launch(dslash_hop_halo, psi_ext)
    return out


dslash_hop_halo.launches = 0
dslash_hop_halo.bf16_launches = 0
