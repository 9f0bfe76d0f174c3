"""K5: the hopping term of one directed hop on the kernel layout.

:func:`dslash_hop_dir` launches the CUDA kernel ``csrc/hop_dir.cu`` for
CUDA tensors and runs its plain PyTorch twin :func:`dslash_hop_dir_plain`
for CPU tensors; any other device raises.  The kernel replaces the TPU
kernel ``mugiq_tpu/pallas/dslash_kernel.py`` ``dslash_hop_pallas_gl_dir``
(:736), the per-direction probe of the MG Galerkin build.  It takes its
direction set as an 8-bit mask (bit 2*mu for the forward hop, 2*mu + 1
for the backward one); this wrapper sets one bit.  Memory-bound (~0.6
flop/byte); see the source for its design.
"""

import ctypes

import torch

from . import build
from .wilson import _clinks, _cspinor, _rspinor, hop_dir_complex

#: flop per site of one directed hop (the Wilson hop's 1320 over 8)
FLOP_PER_SITE = 165

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("hop_dir").mugiq_hop_dir
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, I, I, I, I, I, P]
        fn.restype = I
        _fn = fn
    return _fn


def _check_dir(mu: int, sign: int):
    if mu not in (0, 1, 2, 3) or sign not in (1, -1):
        raise ValueError(f"direction (mu={mu}, sign={sign}): mu in 0..3, "
                         f"sign +1 or -1")


def dslash_hop_dir_plain(psi, U, mu: int, sign: int, dagger: bool, Y: int):
    """Plain PyTorch twin of the kernel: the one directed hop of
    wilson.hop_dir_complex (torch.roll neighbours, full 4x4 projector);
    links upcast to f32.  psi [T, 24, Z, Y*X], U [T, 4, 18, Z, Y*X] ->
    [T, 24, Z, Y*X] f32."""
    _check_dir(mu, sign)
    return _rspinor(hop_dir_complex(_cspinor(psi, Y), _clinks(U, Y), mu,
                                    sign, dagger))


def dslash_hop_dir(psi, U, mu: int, sign: int, dagger: bool, Y: int,
                   out=None):
    """out = (1 -/+ g_mu) U psi(x +/- mu) for the one hop (mu, sign), with
    no -kappa and no diagonal (dagger: the projectors swapped).

    psi [T, 24, Z, Y*X] f32; U [T, 4, 18, Z, Y*X] phased links, f32 or
    bf16.  CUDA tensors launch the kernel, CPU tensors run the twin."""
    _check_dir(mu, sign)
    if psi.device.type == "cpu":
        res = dslash_hop_dir_plain(psi, U, mu, sign, dagger, Y)
        return res if out is None else out.copy_(res)
    if psi.device.type != "cuda":
        raise ValueError(f"dslash_hop_dir: no kernel for device {psi.device}")
    T, _, Z, YX = psi.shape
    if YX % Y:
        raise ValueError(f"dslash_hop_dir: Y={Y} does not divide Y*X={YX}")
    dev = psi.device
    build.require(psi, "psi", (T, 24, Z, YX), (torch.float32,), dev)
    build.require(U, "U", (T, 4, 18, Z, YX), (torch.float32, torch.bfloat16),
                  dev)
    if out is None:
        out = torch.empty_like(psi)
    build.require(out, "out", psi.shape, (torch.float32,), dev)
    if out.data_ptr() == psi.data_ptr():
        raise ValueError("dslash_hop_dir: out must not alias psi "
                         "(neighbour reads)")
    mask = 1 << (2 * mu + (1 if sign < 0 else 0))
    with torch.cuda.device(dev):
        rc = _entry()(psi.data_ptr(), U.data_ptr(), out.data_ptr(), T, Z, Y,
                      YX // Y, mask, int(dagger),
                      int(U.dtype == torch.bfloat16), build.stream_handle(dev))
    build.check(rc, "dslash_hop_dir")
    dslash_hop_dir.launches += 1
    return out


dslash_hop_dir.launches = 0
