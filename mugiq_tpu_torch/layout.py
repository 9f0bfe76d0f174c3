"""Layout converters between the host complex fields, the planar real-pair
layout and the kernel layout (port of pallas/dslash_kernel.py:47-69,
production._planar_gauge_np and the loop-gauge host relayout,
production.py:503-507), and the carry-over of a JAX-package operator
(full or packed even-odd).

Kernel layouts (sites minor, so one thread per site reads coalesced):

* spinor  [T, 24, Z, Y*X]      comp = r*12 + s*3 + c   (r: re/im)
* links   [T, 4, 18, Z, Y*X]   comp = r*9 + a*3 + b
* clover  [T, 144, Z, Y*X]     idx = ((chi*6 + k)*6 + j)*2 + r
"""

import numpy as np
import torch


def to_kernel_spinor(p: torch.Tensor) -> torch.Tensor:
    """planar [2,4,3,T,Z,Y,X] -> [T, 24, Z, Y*X] with comp = r*12 + s*3 + c."""
    _, _, _, T, Z, Y, X = p.shape
    return p.permute(3, 0, 1, 2, 4, 5, 6).reshape(T, 24, Z, Y * X)


def from_kernel_spinor(k: torch.Tensor, Y: int) -> torch.Tensor:
    """[T, 24, Z, Y*X] -> planar [2,4,3,T,Z,Y,X]."""
    T, _, Z, YX = k.shape
    q = k.reshape(T, 2, 4, 3, Z, Y, YX // Y)
    return q.permute(1, 2, 3, 0, 4, 5, 6)


def to_kernel_gauge(u: torch.Tensor) -> torch.Tensor:
    """planar [2,4,3,3,T,Z,Y,X] -> [T, 4, 18, Z, Y*X], comp = r*9 + a*3 + b."""
    _, _, _, _, T, Z, Y, X = u.shape
    return u.permute(4, 1, 0, 2, 3, 5, 6, 7).reshape(T, 4, 18, Z, Y * X)


def planar_gauge_np(U_np: np.ndarray, antiperiodic_t: bool,
                    anisotropy: float = 1.0) -> np.ndarray:
    """Complex U[4,T,Z,Y,X,3,3] -> planar f32 [2,4,3,3,T,Z,Y,X].

    antiperiodic_t folds the fermion boundary phase into the last t-slice
    of the t-links (operator links only: the loop gauge stays unphased);
    anisotropy scales the spatial hops by 1/xi."""
    u = np.asarray(U_np).copy()
    if antiperiodic_t:
        u[3, -1] *= -1.0
    if anisotropy != 1.0:
        u[:3] *= 1.0 / anisotropy
    p = np.stack([u.real, u.imag])
    return np.transpose(p, (0, 1, 6, 7, 2, 3, 4, 5)).astype(np.float32)


def kernel_gauge_np(U_np: np.ndarray, antiperiodic_t: bool,
                    anisotropy: float = 1.0) -> np.ndarray:
    """Complex U[4,T,Z,Y,X,3,3] -> kernel-layout f32 [T, 4, 18, Z, Y*X],
    relaid on the host (a device-side transpose would hold two copies of
    the planar gauge at once)."""
    up = planar_gauge_np(U_np, antiperiodic_t, anisotropy)
    T, Z, Y, X = up.shape[4:]
    return np.ascontiguousarray(
        np.transpose(up, (4, 1, 0, 2, 3, 5, 6, 7)).reshape(
            T, 4, 18, Z, Y * X))


def _tensor(a, device):
    """numpy (f32, or bf16 through ml_dtypes: exact) -> f32 tensor."""
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def from_jax_numpy(U_k, A_blocks, kappa: float, Y: int,
                   precision: str = "f32", device="cuda"):
    """The JAX package's WilsonDiracKernel state, as numpy (U_k
    [T,4,18,Z,YX], A_blocks [T,2,6,6,2,Z,YX] or None, kappa, Y,
    precision), as this package's operator on `device`."""
    from .dirac_kernel import WilsonDiracKernel

    A = None if A_blocks is None else _tensor(A_blocks, device)
    return WilsonDiracKernel(U_k=_tensor(U_k, device), kappa=float(kappa),
                             Y=int(Y), A_blocks=A, precision=precision)


def from_jax_packed_numpy(U_k, A_blocks, Ainv_blocks, kappa: float, Y: int,
                          precision: str = "f32", device="cuda"):
    """The JAX package's SchurDiracKernelPacked state, as numpy (full U_k
    [T,4,18,Z,YX], A_blocks and Ainv_blocks [T,2,6,6,2,Z,YX] or None,
    kappa, Y, precision), as this package's packed operator on `device`."""
    from .schur_kernel import SchurDiracKernelPacked

    A = None if A_blocks is None else _tensor(A_blocks, device)
    Ainv = None if Ainv_blocks is None else _tensor(Ainv_blocks, device)
    return SchurDiracKernelPacked(U_k=_tensor(U_k, device),
                                  kappa=float(kappa), Y=int(Y), A_blocks=A,
                                  Ainv_blocks=Ainv, precision=precision)
