"""K6: the packed even-odd parity hop on half-volume fields.

:func:`parity_hop` launches the CUDA kernel ``csrc/parity_hop.cu`` for
CUDA tensors and runs its plain PyTorch twin :func:`parity_hop_plain` for
CPU tensors; any other device raises.  The kernel replaces the TPU kernel
``mugiq_tpu/pallas/schur_kernel.py`` ``parity_hop_pallas`` (:350).  It is
memory-bound (768 B per packed site and pass against 1320 flop); see the
source for its design.

Packed layout (``schur_kernel.pack_parity``): site (t, z, y, xh) of parity
p is x = 2*xh + (t+z+y+p) % 2, so the checkerboard needs all four extents
even; both paths raise on an odd one.
"""

import ctypes

import torch

from . import build
from .wilson import clover_apply_plain, dslash_hop_plain

_fn = None

#: kernel modes of csrc/parity_hop.cu
_HOP, _POST, _COMB, _COMB_CLOVER = 0, 1, 2, 3


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("parity_hop").mugiq_parity_hop
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                       ctypes.c_float, I, P]
        fn.restype = I
        _fn = fn
    return _fn


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
    T, _, Z, YXh = psi_in.shape
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
    apply A_post or the combine."""
    # imported here: schur_kernel imports this module for its operator
    from ..schur_kernel import pack_parity, unpack_parities

    _mode(kappa2, psi_out, A_post, A_comb)
    T, Z, Xh = _extents(psi_in, Y)
    zero = torch.zeros_like(psi_in)
    links = [u.reshape(T, 72, Z, Y * Xh) for u in (U_out, U_in)]
    if parity_out == 0:
        psi = unpack_parities(zero, psi_in, Y)
        U = unpack_parities(links[0], links[1], Y)
    else:
        psi = unpack_parities(psi_in, zero, Y)
        U = unpack_parities(links[1], links[0], Y)
    full = dslash_hop_plain(psi, U.reshape(T, 4, 18, Z, 2 * Y * Xh), dagger, Y)
    hop = pack_parity(full, Y, parity_out)
    if A_post is not None:
        hop = clover_apply_plain(A_post, hop)
    if kappa2 is None:
        return hop
    diag = psi_out.float() if A_comb is None else clover_apply_plain(A_comb,
                                                                     psi_out)
    return diag - kappa2 * hop


def parity_hop(psi_in, U_out, U_in, Y: int, parity_out: int, dagger: bool,
               kappa2=None, psi_out=None, A_post=None, A_comb=None, out=None):
    """Hop from the input parity (1 - parity_out) to the output parity.

    psi_in [T, 24, Z, Y*Xh] f32; U_out / U_in [T, 4, 18, Z, Y*Xh] the links
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
    f32 = (torch.float32,)
    build.require(psi_in, "psi_in", (T, 24, Z, YXh), f32, dev)
    build.require(U_out, "U_out", (T, 4, 18, Z, YXh),
                  (torch.float32, torch.bfloat16), dev)
    build.require(U_in, "U_in", U_out.shape, (U_out.dtype,), dev)
    for name, a in (("A_post", A_post), ("A_comb", A_comb)):
        if a is not None:
            build.require(a, name, (T, 144, Z, YXh), (U_out.dtype,), dev)
    if psi_out is not None:
        build.require(psi_out, "psi_out", psi_in.shape, f32, dev)
    if out is None:
        out = torch.empty_like(psi_in)
    build.require(out, "out", psi_in.shape, f32, dev)
    if out.data_ptr() == psi_in.data_ptr() or (
            psi_out is not None and out.data_ptr() == psi_out.data_ptr()):
        raise ValueError("parity_hop: out must alias neither psi_in nor "
                         "psi_out")

    def ptr(a):
        return None if a is None else a.data_ptr()

    with torch.cuda.device(dev):
        rc = _entry()(psi_in.data_ptr(), U_out.data_ptr(), U_in.data_ptr(),
                      ptr(A_post), ptr(psi_out), ptr(A_comb), out.data_ptr(),
                      T, Z, Y, Xh, int(parity_out), int(dagger), mode,
                      float(kappa2 or 0.0), int(U_out.dtype == torch.bfloat16),
                      build.stream_handle(dev))
    build.check(rc, "parity_hop")
    parity_hop.launches += 1
    return out


parity_hop.launches = 0
