"""Wilson hopping term on complex full-site fields (port of
mugiq_tpu.ops.dslash, the JAX package's XLA stencil).

    D psi(x) = sum_mu [ (1 - g_mu) U_mu(x)       psi(x + mu)
                      + (1 + g_mu) U_mu^dag(x-mu) psi(x - mu) ]

in QUDA's kappa normalisation (M = 1 - kappa D).  Each directed term
projects to a half spinor (Q [2, 4]), applies the link and reconstructs
(R [4, 2]), R Q = 1 -/+ g_mu (gamma.projector_decomp).  Plain PyTorch:
no TPU kernel reaches this path.  Fields may carry leading batch axes.

dslash_hop runs the eight directions together in a few large
operations rather than as per-site 2x4 / 3x3 / 4x2 matrix products
(which PyTorch would launch as batched GEMMs of one site each): the
spin axis leads, the sixteen half-spinor projections of the unshifted
field are one GEMM of depth 4 (a projection commutes with a shift),
one gather fetches each direction's neighbours, the links are three
elementwise column-times-entry products, and the reconstruction and
the sum over directions one GEMM of depth 16.
"""

from functools import lru_cache

import numpy as np
import torch

from ..fields import shift
from ..gamma import projector_decomp

_G5 = (1.0, 1.0, -1.0, -1.0)


def _projectors(mu: int, forward: bool, like: torch.Tensor):
    q, r = projector_decomp()[(mu, "fwd" if forward else "bwd")]
    return (torch.as_tensor(q, dtype=like.dtype, device=like.device),
            torch.as_tensor(r, dtype=like.dtype, device=like.device))


@lru_cache(maxsize=None)
def _projectors8_np():
    """Q [16, 4] and R [4, 16] of the eight directed hops, row / column
    h * 8 + d for half-spinor component h of direction d = 2 mu
    (forward) or 2 mu + 1 (backward)."""
    d = projector_decomp()
    qs, rs = [], []
    for mu in range(4):
        for tag in ("fwd", "bwd"):
            q, r = d[(mu, tag)]
            qs.append(q)
            rs.append(r)
    q8, r8 = np.stack(qs), np.stack(rs, axis=0)    # [8, 2, 4], [8, 4, 2]
    return (q8.transpose(1, 0, 2).reshape(16, 4),
            r8.transpose(1, 2, 0).reshape(4, 16))


@lru_cache(maxsize=None)
def _hop_consts(dims, dtype, device):
    """Q, R (_projectors8_np) as tensors, and the gather index [8 * S]:
    entry d * S + s is d * S + (the site psi(x +/- mu) sits at)."""
    q, r = _projectors8_np()
    idx = np.arange(int(np.prod(dims))).reshape(dims)
    nbr = [np.roll(idx, -sign, axis=ax) for ax in (3, 2, 1, 0)
           for sign in (+1, -1)]
    flat = (np.stack(nbr).reshape(8, -1)
            + idx.size * np.arange(8)[:, None]).reshape(-1)
    return (torch.as_tensor(q, dtype=dtype, device=device),
            torch.as_tensor(r, dtype=dtype, device=device),
            torch.as_tensor(flat, device=device))


def hop_links(U: torch.Tensor) -> torch.Tensor:
    """The eight directed links L [8, T, Z, Y, X, 3, 3] that multiply the
    projected neighbour: U_mu(x) forward, U_mu(x - mu)^dag backward."""
    out = []
    for mu in range(4):
        out.append(U[mu])
        out.append(shift(U[mu], mu, -1).transpose(-1, -2).conj())
    return torch.stack(out)


def _hop_term(U_mu: torch.Tensor, psi: torch.Tensor, mu: int,
              forward: bool) -> torch.Tensor:
    """One directed hop: (1 - g_mu) U_mu(x) psi(x+mu) (forward) or
    (1 + g_mu) U_mu^dag(x-mu) psi(x-mu) (backward)."""
    q, r = _projectors(mu, forward, psi)
    if forward:
        link, nbr = U_mu, shift(psi, mu, +1)
    else:
        link = shift(U_mu, mu, -1).transpose(-1, -2).conj()
        nbr = shift(psi, mu, -1)
    half = torch.einsum("hs,...sc->...hc", q, nbr)
    # link[a, b] half[h, b], summed over b, per site
    half = (link.unsqueeze(-3) * half.unsqueeze(-2)).sum(-1)
    return torch.einsum("sh,...hc->...sc", r, half)


def dslash_hop(U: torch.Tensor, psi: torch.Tensor,
               links: torch.Tensor = None) -> torch.Tensor:
    """D psi, the eight directed hops; U [4, T, Z, Y, X, 3, 3] (boundary
    phases folded in), psi [..., T, Z, Y, X, 4, 3]; links: hop_links(U),
    when the caller keeps them."""
    if links is None:
        links = hop_links(U)
    dims = tuple(psi.shape[-6:-2])
    Q, R, gather = _hop_consts(dims, psi.dtype, psi.device)
    lead = psi.shape[:-6]
    S = int(np.prod(dims))
    B = int(np.prod(lead)) if lead else 1
    # spin first, batch inside the site: [4, S * B * 3]
    ps = psi.reshape(B, S, 4, 3).permute(2, 1, 0, 3).reshape(4, -1)
    proj = (Q @ ps).reshape(2, 8 * S, B * 3)       # rows (h, d), sites
    half = proj.index_select(1, gather).reshape(2, 8, S, B, 3)
    L = links.reshape(1, 8, S, 1, 3, 3)
    # linked[a] = sum_c L[a, c] half[c]: three column-times-entry terms
    linked = L[..., 0] * half[..., 0:1]            # [2, 8, S, B, 3]
    for c in (1, 2):
        linked.addcmul_(L[..., c], half[..., c:c + 1])
    out = R @ linked.reshape(16, -1)               # [4, S * B * 3]
    out = out.reshape(4, S, B, 3).permute(2, 1, 0, 3)
    return out.reshape(psi.shape)


def g5(psi: torch.Tensor) -> torch.Tensor:
    """g5 psi, g5 = diag(1, 1, -1, -1) in the DeGrand-Rossi basis."""
    s = torch.tensor(_G5, dtype=psi.real.dtype, device=psi.device)
    return psi * s.reshape(4, 1)


def dslash_hop_dagger(U: torch.Tensor, psi: torch.Tensor,
                      links: torch.Tensor = None) -> torch.Tensor:
    """D^dag psi = g5 D g5 psi."""
    return g5(dslash_hop(U, g5(psi), links))
