"""Host-side (numpy) clover term construction (port of mugiq_tpu.clover_np).

A = 1 + (csw kappa / 2) sum_{mu<nu} sigma_{mu nu} F_{mu nu} from the clover
leaves of a (phased) gauge field, packed into the two 6x6 chiral blocks the
Wilson kernel applies, and their site-wise inverse.
"""

import numpy as np

from .gamma import sigma_munu


def _roll(a, mu, sign):
    axis = {0: 3, 1: 2, 2: 1, 3: 0}[mu]
    return np.roll(a, -sign, axis=axis)


def _mm(a, b):
    return np.einsum("...ab,...bc->...ac", a, b)


def _dag(a):
    return np.conj(np.swapaxes(a, -1, -2))


def _leaf_np(U, mu, nu):
    u_mu, u_nu = U[mu], U[nu]
    p1 = _mm(_mm(u_mu, _roll(u_nu, mu, +1)),
             _mm(_dag(_roll(u_mu, nu, +1)), _dag(u_nu)))
    p2 = _mm(_mm(u_nu, _dag(_roll(_roll(u_mu, nu, +1), mu, -1))),
             _mm(_dag(_roll(u_nu, mu, -1)), _roll(u_mu, mu, -1)))
    p3 = _mm(_mm(_dag(_roll(u_mu, mu, -1)),
                 _dag(_roll(_roll(u_nu, mu, -1), nu, -1))),
             _mm(_roll(_roll(u_mu, mu, -1), nu, -1), _roll(u_nu, nu, -1)))
    p4 = _mm(_mm(_dag(_roll(u_nu, nu, -1)), _roll(u_mu, nu, -1)),
             _mm(_roll(_roll(u_nu, mu, +1), nu, -1), _dag(u_mu)))
    return p1 + p2 + p3 + p4


def field_strength_plane_np(U: np.ndarray, mu: int, nu: int) -> np.ndarray:
    """F_mu_nu = (Q - Q^dag) / (8 i), Q the four clover leaves:
    [T, Z, Y, X, 3, 3], Hermitian in colour."""
    q = _leaf_np(np.asarray(U), mu, nu)
    return (q - _dag(q)) / 8.0j


def clover_field_np(U: np.ndarray, kappa: float, csw: float) -> np.ndarray:
    """A[T,Z,Y,X,4,3,4,3] complex from a (phased) numpy gauge field."""
    U = np.asarray(U)
    sig = sigma_munu()
    shape = U.shape[1:5]
    sf = np.zeros(shape + (4, 3, 4, 3), dtype=np.complex128)
    for mu in range(4):
        for nu in range(mu + 1, 4):
            f = field_strength_plane_np(U, mu, nu)
            sf += np.einsum("su,tzyxab->tzyxsaub", sig[mu, nu], f)
    eye = np.einsum("su,ab->saub", np.eye(4), np.eye(3))
    return eye[None, None, None, None] + (csw * kappa * 0.5) * sf


def clover_chiral_blocks_np(A: np.ndarray) -> np.ndarray:
    """Pack the chirality-block-diagonal clover matrix as real
    [T, 2chiral, 6, 6, 2rc, Z, Y*X] float32.

    Chirality blocks are spins {0,1} and {2,3}; inside a block the 6 dofs
    are (s_in * 3 + c), so each block is a contiguous range of the kernel
    component order comp = r*12 + s*3 + c.
    """
    T, Z, Y, X = A.shape[:4]
    out = np.empty((T, 2, 6, 6, 2, Z, Y * X), dtype=np.float32)
    for chi in range(2):
        s0 = 2 * chi
        blk = A[:, :, :, :, s0:s0 + 2, :, s0:s0 + 2, :]   # [T,Z,Y,X,2,3,2,3]
        blk = blk.reshape(T, Z, Y * X, 6, 6)
        blk = np.moveaxis(blk, (3, 4), (1, 2))            # [T,6,6,Z,YX]
        out[:, chi, :, :, 0] = blk.real
        out[:, chi, :, :, 1] = blk.imag
    return out


def invert_chiral_blocks_np(A_blocks: np.ndarray) -> np.ndarray:
    """Site-wise inverse of packed chiral clover blocks: [T, 2, 6, 6, 2, Z,
    YX] -> the same layout holding A^-1 (per-site 6x6 complex inverses in
    complex128, cast to f32; the Schur complement's A_oo^-1, the reference's
    cloverInvert).  Host-side set-up, once per gauge."""
    A_blocks = np.asarray(A_blocks, dtype=np.float32)
    out = np.empty_like(A_blocks)
    for chi in range(2):
        blk = (A_blocks[:, chi, :, :, 0].astype(np.complex128)
               + 1j * A_blocks[:, chi, :, :, 1])          # [T,6,6,Z,YX]
        blk = np.moveaxis(blk, (1, 2), (3, 4))            # [T,Z,YX,6,6]
        inv = np.moveaxis(np.linalg.inv(blk), (3, 4), (1, 2))
        out[:, chi, :, :, 0] = inv.real.astype(np.float32)
        out[:, chi, :, :, 1] = inv.imag.astype(np.float32)
    return out
