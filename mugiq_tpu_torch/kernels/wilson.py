"""K1: the fused Wilson(-clover) operator M / M^dag on the kernel layout.

:func:`wilson_m` launches the CUDA kernel ``csrc/wilson_m.cu`` for CUDA
tensors and runs its plain PyTorch twin :func:`wilson_m_plain` for CPU
tensors; any other device raises.  The kernel replaces the TPU kernels
``mugiq_tpu/pallas/dslash_kernel.py`` ``wilson_m_pallas`` (:395) and
``wilson_m_pallas_gl`` (:747).  It is memory-bound (~1 flop/byte against
an f32 ridge of ~20); see the source for its design.
"""

import ctypes

import torch

from ..gamma import gamma_matrices
from . import build

#: Wilson hopping term flop count per site (8 hops, half-spinor form)
FLOP_PER_SITE = 1320

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("wilson_m").mugiq_wilson_m
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, ctypes.c_float, I, I, I, P]
        fn.restype = I
        _fn = fn
    return _fn


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


def dslash_hop_plain(psi, U, dagger: bool, Y: int):
    """The hopping term D psi (dagger: D^dag psi) in plain PyTorch, the sum
    of hop_dir_complex over the 8 directed hops; links upcast to f32.
    psi [T, 24, Z, Y*X], U [T, 4, 18, Z, Y*X] -> [T, 24, Z, Y*X] f32."""
    p = _cspinor(psi, Y)
    u = _clinks(U, Y)
    hop = torch.zeros_like(p)
    for mu in range(4):
        for sign in (1, -1):
            hop += hop_dir_complex(p, u, mu, sign, dagger)
    return _rspinor(hop)


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
    dslash_hop_plain; links and clover upcast to f32 as in the kernel."""
    diag = psi.float() if A144 is None else clover_apply_plain(A144, psi)
    return diag - kappa * dslash_hop_plain(psi, U, dagger, Y)


def wilson_m(psi, U, A144, kappa: float, dagger: bool, Y: int, out=None):
    """out = A psi - kappa D psi (M), or with the projectors swapped (M^dag).

    psi [T, 24, Z, Y*X] f32; U [T, 4, 18, Z, Y*X] phased links, f32 or
    bf16; A144 [T, 144, Z, Y*X] clover chiral blocks of U's dtype, or None
    for Wilson.  CUDA tensors launch the kernel, CPU tensors run the twin.
    """
    if psi.device.type == "cpu":
        res = wilson_m_plain(psi, U, A144, kappa, dagger, Y)
        return res if out is None else out.copy_(res)
    if psi.device.type != "cuda":
        raise ValueError(f"wilson_m: no kernel for device {psi.device}")
    T, _, Z, YX = psi.shape
    if YX % Y:
        raise ValueError(f"wilson_m: Y={Y} does not divide Y*X={YX}")
    dev = psi.device
    build.require(psi, "psi", (T, 24, Z, YX), (torch.float32,), dev)
    build.require(U, "U", (T, 4, 18, Z, YX), (torch.float32, torch.bfloat16),
                  dev)
    if A144 is not None:
        build.require(A144, "A144", (T, 144, Z, YX), (U.dtype,), dev)
    if out is None:
        out = torch.empty_like(psi)
    build.require(out, "out", psi.shape, (torch.float32,), dev)
    if out.data_ptr() == psi.data_ptr():
        raise ValueError("wilson_m: out must not alias psi (neighbour reads)")
    with torch.cuda.device(dev):
        rc = _entry()(psi.data_ptr(), U.data_ptr(),
                      None if A144 is None else A144.data_ptr(),
                      out.data_ptr(), T, Z, Y, YX // Y, float(kappa),
                      int(dagger), int(A144 is not None),
                      int(U.dtype == torch.bfloat16), build.stream_handle(dev))
    build.check(rc, "wilson_m")
    wilson_m.launches += 1
    return out


wilson_m.launches = 0
