"""The stream's gauge configurations: hot (random) SU(3) links made on the
device from a seed, and the ensemble the stream is drawn from.

The arithmetic of the program's host factory (``io/gauge_io._project_su3``:
Gaussian complex 3x3 matrices, QR with a real-positive diagonal of R, which
makes Q Haar-distributed in U(3), then the determinant's phase removed),
rewritten in torch so that a 32^3x64 field takes a fraction of a second on
the card rather than numpy's minute.  Gram-Schmidt of the columns is the QR
with a positive diagonal, so it gives that Q directly.
"""

import numpy as np
import torch

#: purposes of the derived seeds (derive_seed's last word)
GAUGE, START_VECTOR, MG_SETUP, SAMPLE, WARMUP, ORDER = 0, 1, 2, 3, 4, 5


def derive_seed(seed: int, index: int, purpose: int) -> int:
    """A 63-bit seed for one purpose of configuration `index` of a run."""
    words = (seed, seed // 2 ** 64, index, purpose)
    ss = np.random.SeedSequence([w % 2 ** 64 for w in words])
    return int(ss.generate_state(2, np.uint32).astype(np.uint64)
               @ np.array([1, 2 ** 32], np.uint64)) >> 1


def member_seeds(ensemble_seed: int, k: int) -> dict:
    """The seeds of member k of an ensemble: its gauge, the eigensolver's
    start vector and the MG set-up's null vectors."""
    return {"gauge": derive_seed(ensemble_seed, k, GAUGE),
            "start": derive_seed(ensemble_seed, k, START_VECTOR),
            "mg": derive_seed(ensemble_seed, k, MG_SETUP)}


def stream_order(seed: int, size: int) -> list:
    """The order in which a run with `seed` takes the ensemble's members
    (the window cycles through it)."""
    rng = np.random.default_rng(derive_seed(seed, 0, ORDER))
    return [int(k) for k in rng.permutation(size)]


def su3_project(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] complex -> SU(3): Q of QR (columns Gram-Schmidt), then
    Q times conj(det Q)^(1/3)."""
    c0, c1, c2 = m[..., 0], m[..., 1], m[..., 2]

    def unit(v):
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    def dot(a, b):
        return (a.conj() * b).sum(-1, keepdim=True)

    q0 = unit(c0)
    q1 = unit(c1 - dot(q0, c1) * q0)
    q2 = unit(c2 - dot(q0, c2) * q0 - dot(q1, c2) * q1)
    q = torch.stack([q0, q1, q2], -1)
    det = torch.linalg.det(q)
    # principal cube root of conj(det), |det| = 1
    return q * torch.exp(-1j * torch.angle(det) / 3)[..., None, None]


def hot_gauge(dims, seed: int, device) -> torch.Tensor:
    """U [4, T, Z, Y, X, 3, 3] complex128 on `device`, drawn from `seed`
    with a generator on that device."""
    X, Y, Z, T = dims
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (4, T, Z, Y, X, 3, 3)
    re = torch.randn(shape, generator=gen, dtype=torch.float64, device=device)
    im = torch.randn(shape, generator=gen, dtype=torch.float64, device=device)
    return su3_project(torch.complex(re, im))
