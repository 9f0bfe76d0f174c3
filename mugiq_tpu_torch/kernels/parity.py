"""K6: the packed even-odd parity hop on half-volume fields.

:func:`parity_hop` launches the CUDA kernel ``csrc/parity_hop.cu`` (or
its pair and block-tile sources, chosen by ``wilson.launch_plan``;
kernels in ``csrc/parity_hop.cuh``) for CUDA tensors and runs its
plain PyTorch twin :func:`parity_hop_plain` for CPU tensors; any other
device raises.  The kernel replaces the TPU kernel
``mugiq_tpu/pallas/schur_kernel.py`` ``parity_hop_pallas`` (:350), and
its vmap over a block: f32 or bf16 spinors (the output in psi_in's
dtype), one field or a batch of them in one launch.  It is
memory-bound (768 B per packed site and pass against 1320 flop); see the
source for its design.

Packed layout (``schur_kernel.pack_parity``): site (t, z, y, xh) of parity
p is x = 2*xh + (t+z+y+p) % 2, so the checkerboard needs all four extents
even; both paths raise on an odd one.
"""

import ctypes

import torch

from . import build
from .wilson import (SPINOR_DTYPES, aligned_pairs, batch_shape,
                     clover_apply_plain, dslash_hop_plain, launch_plan)

#: kernel modes of csrc/parity_hop.cu
_HOP, _POST, _COMB, _COMB_CLOVER = 0, 1, 2, 3


_P, _I = ctypes.c_void_p, ctypes.c_int
#: the C entry points of K6's sources: psi_in, U_out, U_in, A_post,
#: psi_out, A_comb, out, T, Z, Y, Xh, parity_out, dagger, mode, kappa2,
#: link_bf16, batch, stream
ENTRY_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                  ctypes.c_float, _I, _I, _P]


def _mode(kappa2, psi_out, A_post, A_comb) -> int:
    """Which of the kernel's four passes the optional arguments select."""
    if kappa2 is None:
        if psi_out is not None or A_comb is not None:
            raise ValueError("parity_hop: psi_out and A_comb belong to the "
                             "combine pass (kappa2)")
        return _HOP if A_post is None else _POST
    if psi_out is None:
        raise ValueError("parity_hop: the combine pass (kappa2) needs psi_out")
    if A_post is not None:
        raise ValueError("parity_hop: A_post is a first-pass option; the "
                         "combine pass takes A_comb")
    return _COMB if A_comb is None else _COMB_CLOVER


def _extents(psi_in, Y: int):
    _, T, Z, YXh = batch_shape(psi_in, "parity_hop")
    if YXh % Y:
        raise ValueError(f"parity_hop: Y={Y} does not divide Y*Xh={YXh}")
    Xh = YXh // Y
    if T % 2 or Z % 2 or Y % 2:
        raise ValueError(f"parity_hop: the even-odd checkerboard needs even "
                         f"extents, got T={T} Z={Z} Y={Y} X={2 * Xh}")
    return T, Z, Xh


def parity_hop_plain(psi_in, U_out, U_in, Y: int, parity_out: int,
                     dagger: bool, kappa2=None, psi_out=None, A_post=None,
                     A_comb=None):
    """Plain PyTorch twin, formulated at full volume so that it shares no
    index arithmetic with the kernel: unpack the input spinor (zero on the
    output parity) and both link parities, apply the full-volume hop
    (dslash_hop_plain, torch.roll neighbours), keep the output parity, then
    apply A_post or the combine.  Spinors upcast to f32; the f32 result is
    rounded once to psi_in's dtype; a batch one field at a time."""
    # imported here: schur_kernel imports this module for its operator
    from ..schur_kernel import pack_parity, unpack_parities

    _mode(kappa2, psi_out, A_post, A_comb)
    if psi_in.ndim == 5:
        return torch.stack([
            parity_hop_plain(p, U_out, U_in, Y, parity_out, dagger, kappa2,
                             None if psi_out is None else psi_out[i], A_post,
                             A_comb) for i, p in enumerate(psi_in)])
    T, Z, Xh = _extents(psi_in, Y)
    zero = torch.zeros_like(psi_in)
    links = [u.reshape(T, 72, Z, Y * Xh) for u in (U_out, U_in)]
    if parity_out == 0:
        psi = unpack_parities(zero, psi_in, Y)
        U = unpack_parities(links[0], links[1], Y)
    else:
        psi = unpack_parities(psi_in, zero, Y)
        U = unpack_parities(links[1], links[0], Y)
    full = dslash_hop_plain(psi, U.reshape(T, 4, 18, Z, 2 * Y * Xh), dagger, Y,
                            torch.float32)
    hop = pack_parity(full, Y, parity_out)
    if A_post is not None:
        hop = clover_apply_plain(A_post, hop)
    if kappa2 is not None:
        diag = (psi_out.float() if A_comb is None
                else clover_apply_plain(A_comb, psi_out))
        hop = diag - kappa2 * hop
    return hop.to(psi_in.dtype)


def parity_hop(psi_in, U_out, U_in, Y: int, parity_out: int, dagger: bool,
               kappa2=None, psi_out=None, A_post=None, A_comb=None, out=None):
    """Hop from the input parity (1 - parity_out) to the output parity.

    psi_in [T, 24, Z, Y*Xh] or a batch [b, T, 24, Z, Y*Xh], f32 or bf16
    (psi_out and out alike: the same shape and dtype; f32 arithmetic; a
    batch is one launch); U_out / U_in [T, 4, 18, Z, Y*Xh] the links
    based at output- / input-parity sites (phased, f32 or bf16).
    kappa2 + psi_out: out = psi_out - kappa2 * hop, or with A_comb
    [T, 144, Z, Y*Xh] out = A_comb psi_out - kappa2 * hop; A_post (without
    kappa2): out = A_post hop.  out must alias neither psi_in nor psi_out.
    CUDA tensors launch the kernel, CPU tensors run the twin.
    """
    if parity_out not in (0, 1):
        raise ValueError(f"parity_hop: parity_out must be 0 or 1: "
                         f"{parity_out}")
    if psi_in.device.type == "cpu":
        res = parity_hop_plain(psi_in, U_out, U_in, Y, parity_out, dagger,
                               kappa2, psi_out, A_post, A_comb)
        return res if out is None else out.copy_(res)
    if psi_in.device.type != "cuda":
        raise ValueError(f"parity_hop: no kernel for device {psi_in.device}")
    mode = _mode(kappa2, psi_out, A_post, A_comb)
    T, Z, Xh = _extents(psi_in, Y)
    YXh = Y * Xh
    dev = psi_in.device
    build.require(psi_in, "psi_in", psi_in.shape, SPINOR_DTYPES, dev)
    same = (psi_in.dtype,)
    build.require(U_out, "U_out", (T, 4, 18, Z, YXh),
                  (torch.float32, torch.bfloat16), dev)
    build.require(U_in, "U_in", U_out.shape, (U_out.dtype,), dev)
    for name, a in (("A_post", A_post), ("A_comb", A_comb)):
        if a is not None:
            build.require(a, name, (T, 144, Z, YXh), (U_out.dtype,), dev)
    if psi_out is not None:
        build.require(psi_out, "psi_out", psi_in.shape, same, dev)
    if out is None:
        out = torch.empty_like(psi_in)
    build.require(out, "out", psi_in.shape, same, dev)
    if out.data_ptr() == psi_in.data_ptr() or (
            psi_out is not None and out.data_ptr() == psi_out.data_ptr()):
        raise ValueError("parity_hop: out must alias neither psi_in nor "
                         "psi_out")

    def ptr(a):
        return None if a is None else a.data_ptr()

    bf = torch.bfloat16
    b = psi_in.shape[0] if psi_in.ndim == 5 else 1
    plan = launch_plan("parity_hop", b, Xh, psi_in.dtype == bf,
                       aligned_pairs(psi_in, U_out, U_in, A_post, psi_out,
                                     A_comb, out))
    with torch.cuda.device(dev):
        rc = build.entry(plan.source, ENTRY_ARGTYPES)(
            psi_in.data_ptr(), U_out.data_ptr(), U_in.data_ptr(),
            ptr(A_post), ptr(psi_out), ptr(A_comb), out.data_ptr(), T, Z, Y,
            Xh, int(parity_out), int(dagger), mode, float(kappa2 or 0.0),
            int(U_out.dtype == bf), b, build.stream_handle(dev))
    build.check(rc, "parity_hop")
    parity_hop.launches += 1
    return out


parity_hop.launches = 0


# ---------------------------------------------------------------------------
# K7b: the halo-extended form of one rank's block
# ---------------------------------------------------------------------------

#: K7b's source for (bf16 spinors, bf16 links): four sources, built in
#: parallel (csrc/parity_hop_halo.cuh says why)
HALO_SOURCES = {(False, False): "parity_hop_halo",
                (False, True): "parity_hop_halo_bf16",
                (True, False): "parity_hop_halo_psi_bf16",
                (True, True): "parity_hop_halo_all_bf16"}
#: their C entry points: psi_ext, U_out, U_in, Ut, A_post, psi_out,
#: A_comb, out, Zl, Yl, Xh, parity_out, t0, nrows, tstep, ext, dagger,
#: mode, kappa2, stream
HALO_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                 _I, _I, _I, ctypes.c_float, _P]


def _unpack_one(packed, Y: int, parity: int, shift: int):
    """Full-volume field holding `packed` on its parity's sites and zero on
    the others, for an array whose site (a, b, c) of (t, z, y) has the
    true parity offset (a + b + c + shift) % 2 (a halo-extended block
    starts one row before the block, whose origin is even)."""
    from ..schur_kernel import unpack_parities

    zero = torch.zeros_like(packed)
    if (parity + shift) % 2 == 0:
        return unpack_parities(packed, zero, Y)
    return unpack_parities(zero, packed, Y)


def parity_hop_halo_plain(psi_ext, U_out, U_in, Ut_in_shift, Y: int,
                          parity_out: int, dagger: bool, z_ext: bool,
                          y_ext: bool, kappa2=None, psi_out=None, A_post=None,
                          A_comb=None, rows=None):
    """Plain PyTorch twin of K7b on the given rows, formulated at full
    volume so that it shares no index arithmetic with the kernel: unpack
    the extended input spinor (zero on the output parity), both link
    parities and the shifted t-links, apply the halo-extended full-volume
    hop (wilson.dslash_hop_halo_plain), keep the output parity of each
    row, then apply A_post or the combine.  Spinors upcast to f32; returns
    [R, 24, Zl, Y*Xh], the f32 result rounded once to psi_ext's dtype (as
    the TPU kernels' out_shape and parity_hop_plain)."""
    from ..schur_kernel import pack_parity
    from .wilson import dslash_hop_halo_plain, halo_rows, halo_shapes

    _mode(kappa2, psi_out, A_post, A_comb)
    Tl = U_out.shape[0]
    _, Zp, Yp, Xh = halo_shapes(psi_ext, Y, z_ext, y_ext, Tl)
    r = halo_rows(rows, Tl)
    pin = 1 - parity_out
    o = int(z_ext) + int(y_ext)        # z/y origin of the extended arrays
    psi = _unpack_one(psi_ext, Yp, pin, 1 + o)
    links = [_unpack_one(u.reshape(Tl, 72, Zp, Yp * Xh), Yp, par, o)
             for u, par in ((U_out, parity_out), (U_in, pin))]
    U = (links[0] + links[1]).reshape(Tl, 4, 18, Zp, Yp * 2 * Xh)
    Ut = _unpack_one(Ut_in_shift, Yp, pin, 1 + o)
    full = dslash_hop_halo_plain(psi, U, Ut, dagger, Y, z_ext, y_ext, rows,
                                 torch.float32)
    hop = torch.cat([pack_parity(full[k:k + 1], Y, (parity_out + t) % 2)
                     for k, t in enumerate(r)])
    ri = torch.as_tensor(r, device=hop.device)
    if A_post is not None:
        hop = clover_apply_plain(A_post[ri], hop)
    if kappa2 is not None:
        pe = psi_out[ri]
        diag = (pe.float() if A_comb is None
                else clover_apply_plain(A_comb[ri], pe))
        hop = diag - kappa2 * hop
    return hop.to(psi_ext.dtype)


def parity_hop_halo(psi_ext, U_out, U_in, Ut_in_shift, Y: int,
                    parity_out: int, dagger: bool, z_ext: bool, y_ext: bool,
                    kappa2=None, psi_out=None, A_post=None, A_comb=None,
                    rows=None, out=None):
    """K7b: K6's hop from the input parity (1 - parity_out) to the output
    parity, on the given rows of one rank's block, from its halo-extended
    input-parity spinor.

    psi_ext [Tl+2, 24, Zp, Yp*Xh] f32 or bf16 (Zp = Zl+2 if z_ext, Yp =
    Y+2 if y_ext; psi_out and out in its dtype, f32 arithmetic, as K6);
    U_out / U_in [Tl, 4, 18, Zp, Yp*Xh] links based at output- /
    input-parity sites with their z/y halos (f32 or bf16); Ut_in_shift
    [Tl, 18, Zp, Yp*Xh] the input-parity t-links of global t - 1;
    psi_out, A_post, A_comb interior [Tl, *, Zl, Y*Xh]; the modes as
    parity_hop's.  The block's origin must have even t + z + y.  rows
    (t0, nrows, tstep) or None for all; out [Tl, 24, Zl, Y*Xh] (rows
    outside the launch are left as they are).  CUDA tensors launch the
    kernel, CPU tensors run the twin."""
    from .wilson import count_halo_launch, halo_rows, halo_shapes

    if parity_out not in (0, 1):
        raise ValueError(f"parity_hop_halo: parity_out must be 0 or 1: "
                         f"{parity_out}")
    mode = _mode(kappa2, psi_out, A_post, A_comb)
    Tl = U_out.shape[0]
    Zl, Zp, Yp, Xh = halo_shapes(psi_ext, Y, z_ext, y_ext, Tl)
    if Tl % 2 or Zl % 2 or Y % 2:
        raise ValueError(f"parity_hop_halo: the even-odd checkerboard needs "
                         f"even block extents, got T={Tl} Z={Zl} Y={Y}")
    r = halo_rows(rows, Tl)
    oshape = (Tl, 24, Zl, Y * Xh)
    if psi_ext.device.type == "cpu":
        res = parity_hop_halo_plain(psi_ext, U_out, U_in, Ut_in_shift, Y,
                                    parity_out, dagger, z_ext, y_ext, kappa2,
                                    psi_out, A_post, A_comb, rows)
        if out is None and rows is None:
            return res
        if out is None:
            out = torch.zeros(oshape, dtype=res.dtype)
        out[r] = res
        return out
    if psi_ext.device.type != "cuda":
        raise ValueError(f"parity_hop_halo: no kernel for device "
                         f"{psi_ext.device}")
    dev = psi_ext.device
    build.require(psi_ext, "psi_ext", (Tl + 2, 24, Zp, Yp * Xh),
                  SPINOR_DTYPES, dev)
    same = (psi_ext.dtype,)
    build.require(U_out, "U_out", (Tl, 4, 18, Zp, Yp * Xh),
                  (torch.float32, torch.bfloat16), dev)
    build.require(U_in, "U_in", U_out.shape, (U_out.dtype,), dev)
    build.require(Ut_in_shift, "Ut_in_shift", (Tl, 18, Zp, Yp * Xh),
                  (U_out.dtype,), dev)
    for name, a in (("A_post", A_post), ("A_comb", A_comb)):
        if a is not None:
            build.require(a, name, (Tl, 144, Zl, Y * Xh), (U_out.dtype,), dev)
    if psi_out is not None:
        build.require(psi_out, "psi_out", oshape, same, dev)
    if out is None:
        out = torch.empty(oshape, dtype=psi_ext.dtype, device=dev)
    build.require(out, "out", oshape, same, dev)
    if out.data_ptr() == psi_ext.data_ptr() or (
            psi_out is not None and out.data_ptr() == psi_out.data_ptr()):
        raise ValueError("parity_hop_halo: out must alias neither psi_ext "
                         "nor psi_out")

    def ptr(a):
        return None if a is None else a.data_ptr()

    t0, n, step = (0, Tl, 1) if rows is None else rows
    ext = 2 if y_ext else int(z_ext)
    bf = torch.bfloat16
    with torch.cuda.device(dev):
        rc = build.entry(HALO_SOURCES[psi_ext.dtype == bf,
                                      U_out.dtype == bf], HALO_ARGTYPES)(
            psi_ext.data_ptr(), U_out.data_ptr(), U_in.data_ptr(),
            Ut_in_shift.data_ptr(), ptr(A_post), ptr(psi_out), ptr(A_comb),
            out.data_ptr(), Zl, Y, Xh, int(parity_out), int(t0), int(n),
            int(step), ext, int(dagger), mode, float(kappa2 or 0.0),
            build.stream_handle(dev))
    build.check(rc, "parity_hop_halo")
    count_halo_launch(parity_hop_halo, psi_ext)
    return out


parity_hop_halo.launches = 0
parity_hop_halo.bf16_launches = 0
