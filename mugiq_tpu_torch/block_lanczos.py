"""Thick-restart block Lanczos on real-pair fields (port of
mugiq_tpu.planar.block_lanczos.block_lanczos_hermitian_realpair).

Each Krylov step applies the operator to a block of b vectors (one
batched kernel launch when matvec_batch is the operator itself: K1 and
K6 take a leading batch axis), reorthogonalises the block fully (CGS2
against the basis prefix, then an in-block complex MGS QR) and records a
block-tridiagonal projected matrix, eigh'd on the host.  Degenerate or
clustered eigenvalues are resolved within one cycle.  The algebra is
lanczos.py's (the same _mm products, so a bf16 basis is read natively on
CUDA), batched over the block; `reduce` sums the inner products of a
sharded field over the ranks.
"""

from typing import Callable, Optional

import numpy as np
import torch

from .lanczos import (LanczosResult, _jrot, _mm, _rotate, _unitize, norm,
                      normalize_which)


def _dots_block(V, W, ax):
    """d[i, c, w]: c = 0 Re<V_i, W_w>, c = 1 Im<V_i, W_w>; one V pass."""
    b = W.shape[0]
    Wb = torch.stack([W, _jrot(W, ax + 1)]).reshape(2 * b, -1)
    return _mm(V.reshape(V.shape[0], -1), Wb.T).reshape(-1, 2, b)


def _axpy_sub_block(W, d, V, ax):
    """W_w - sum_i (d[i, 0, w] + i d[i, 1, w]) V_i; one V pass."""
    b = W.shape[0]
    C = _mm(d.reshape(d.shape[0], 2 * b).T, V.reshape(V.shape[0], -1))
    C = C.reshape((2,) + tuple(W.shape))
    return W - C[0] + _jrot(C[1], ax + 1)


def _qr_block(W, ax, reduce=None):
    """Complex MGS QR of the b vectors of a block, twice per column for
    f32 orthogonality: W = Q R with Q [b, *field] orthonormal and R
    [b, b, 2] upper triangular with a real non-negative diagonal."""
    red = reduce or (lambda x: x)
    b = W.shape[0]
    tiny = torch.finfo(W.dtype).tiny
    q = [W[j] for j in range(b)]
    R = torch.zeros((b, b, 2), dtype=W.dtype, device=W.device)
    for j in range(b):
        w = q[j]
        for _ in range(2):
            for i in range(j):
                rr, ri = red(torch.stack([torch.sum(q[i] * w),
                                          torch.sum(q[i] * _jrot(w, ax))]))
                w = w - rr * q[i] + ri * _jrot(q[i], ax)
                R[i, j, 0] += rr
                R[i, j, 1] += ri
        nrm = norm(w, reduce)
        R[j, j, 0] = nrm
        q[j] = w / torch.clamp(nrm, min=tiny)
    return torch.stack(q), R


def _conj_t(B):
    """The conjugate transpose of a [r, c, 2] re/im block -> [c, r, 2]."""
    sign = torch.tensor([1.0, -1.0], dtype=B.dtype, device=B.device)
    return B.transpose(0, 1) * sign


def block_cycle(matvec_batch: Callable, V: torch.Tensor, Tmat: torch.Tensor,
                j0b: int, b: int, ax: int, reduce: Optional[Callable] = None):
    """Block steps j0b..m/b-1 (port of planar/block_lanczos.py
    _make_block_cycle): V [m+b, *field], Tmat [m, m, 2] updated in place
    (column block, conjugate row block, R and R^dag off the diagonal);
    returns the last step's R [b, b, 2], the residual block's coupling."""
    m = Tmat.shape[0]
    rdtype = Tmat.dtype
    red = reduce or (lambda x: x)
    R = torch.zeros((b, b, 2), dtype=rdtype, device=Tmat.device)
    for j in range(j0b, m // b):
        jb = j * b
        # the stored block feeds the operator as it is (bf16 basis)
        W = matvec_batch(V[jb:jb + b]).to(rdtype)
        Vp = V[:jb + b]
        d = red(_dots_block(Vp, W, ax))
        W = _axpy_sub_block(W, d, Vp, ax)
        d2 = red(_dots_block(Vp, W, ax))
        W = _axpy_sub_block(W, d2, Vp, ax)
        Q, R = _qr_block(W, ax, reduce)
        V[jb + b:jb + 2 * b] = Q
        col = (d + d2).transpose(1, 2)                 # [jb+b, b, 2]
        Tmat[:jb + b, jb:jb + b] = col
        Tmat[jb:jb + b, :jb + b] = _conj_t(col)
        if jb + b < m:
            Tmat[jb + b:jb + 2 * b, jb:jb + b] = R
            Tmat[jb:jb + b, jb + b:jb + 2 * b] = _conj_t(R)
    return R


def block_lanczos_hermitian_realpair(
    matvec: Callable,
    v0: torch.Tensor,
    n_ev: int,
    n_kr: int,
    block_size: int = 4,
    re_im_axis: int = 0,
    tol: float = 1e-6,
    max_restarts: int = 100,
    which: str = "SR",
    check_interval: int = 1,
    matvec_batch: Optional[Callable] = None,
    v0_is_block: bool = False,
    seed: int = 7,
    reduce: Optional[Callable] = None,
    basis_dtype: Optional[torch.dtype] = None,
) -> LanczosResult:
    """n_ev extremal eigenpairs of a Hermitian operator on real-pair fields
    by block thick-restart Lanczos with block size b = block_size.

    v0: one start vector, the rest of the first block filled with
    Gaussian noise from numpy's default_rng(seed), as the JAX function
    draws it; or, with v0_is_block=True, the whole start block
    [b, *field].  n_kr is rounded down to a multiple of b.
    matvec_batch: the operator on a block [b, *field] -> [b, *field];
    default: matvec on each vector in turn.  Pass an operator that takes
    a leading batch axis (WilsonDiracKernel, SchurDiracKernelPacked) for
    one launch per block.  reduce and basis_dtype as in
    lanczos_hermitian_realpair; the evecs come back in v0's dtype."""
    which = normalize_which(which)
    b = block_size
    ax = re_im_axis
    m = (n_kr // b) * b
    if m < 2 * b:
        raise ValueError(f"n_kr={n_kr} too small for block_size={b}")
    if matvec_batch is None:
        def matvec_batch(W):
            return torch.stack([matvec(w) for w in W])

    if v0_is_block:
        if v0.shape[0] != b:
            raise ValueError(f"v0 block has {v0.shape[0]} != {b} vectors")
        W0 = v0
    else:
        noise = np.random.default_rng(seed).standard_normal(
            (b - 1,) + tuple(v0.shape))
        W0 = torch.cat([v0[None], torch.as_tensor(noise, dtype=v0.dtype,
                                                  device=v0.device)])
    shape = tuple(W0.shape[1:])
    if shape[ax] % 2:
        raise ValueError(f"re_im_axis {ax} has odd extent {shape[ax]}")
    dev, rdtype = W0.device, W0.dtype

    # keep-count k: a multiple of b (block steps restart at offset k)
    k = n_ev + max(1, (m - n_ev) // 2)
    k = min(((k + b - 1) // b) * b, m - b)
    k = max(k, ((n_ev + b - 1) // b) * b)
    if k > m - b:
        raise ValueError(f"n_kr={n_kr} too small: keep={k} + block={b} > "
                         f"m={m}; raise n_kr")

    V = torch.zeros((m + b,) + shape, dtype=basis_dtype or rdtype,
                    device=dev)
    V[:b] = _qr_block(W0, ax, reduce)[0]
    Tmat = torch.zeros((m, m, 2), dtype=rdtype, device=dev)

    j0b = 0
    converged = False
    theta = q = sel = None
    S_host = np.zeros((b, n_ev))
    for restart in range(max_restarts):
        B = block_cycle(matvec_batch, V, Tmat, j0b, b, ax, reduce)
        T2 = Tmat.double().cpu().numpy()
        B2 = B.double().cpu().numpy()
        T_host = T2[..., 0] + 1j * T2[..., 1]
        B_host = B2[..., 0] + 1j * B2[..., 1]
        theta, q = np.linalg.eigh((T_host + T_host.conj().T) / 2)
        sel = (np.arange(k) if which == "SR"
               else np.arange(m - 1, m - 1 - k, -1))
        S_host = B_host @ q[m - b:, sel]           # [b, k] coupling
        resid = np.linalg.norm(S_host, axis=0)
        if (restart + 1) % check_interval == 0 or restart == max_restarts - 1:
            t_np = theta[sel][:n_ev]
            if np.all(resid[:n_ev] < tol * np.maximum(1.0, np.abs(t_np))):
                converged = True
                break
        if restart == max_restarts - 1:
            break
        # V[:k] = Ritz vectors, V[k:k+b] = the residual block (old
        # V[m:m+b]); T = diag(theta_sel) with the coupling S off it
        Qs = q[:, sel]
        Vk = _rotate(V[:m], torch.as_tensor(Qs.real, dtype=rdtype, device=dev),
                     torch.as_tensor(Qs.imag, dtype=rdtype, device=dev), ax)
        V[:k] = Vk
        del Vk
        V[k:k + b] = V[m:m + b]
        Tmat.zero_()
        idx = torch.arange(k, device=dev)
        Tmat[idx, idx, 0] = torch.as_tensor(theta[sel], dtype=rdtype,
                                            device=dev)
        S = torch.as_tensor(np.stack([S_host.real, S_host.imag], -1),
                            dtype=rdtype, device=dev)
        Tmat[k:k + b, :k] = S
        Tmat[:k, k:k + b] = _conj_t(S)
        j0b = k // b

    sel_np = np.asarray(sel)[:n_ev]
    Qs = q[:, sel_np]
    evecs = _unitize(_rotate(
        V[:m], torch.as_tensor(Qs.real, dtype=rdtype, device=dev),
        torch.as_tensor(Qs.imag, dtype=rdtype, device=dev), ax), reduce)
    del V, Tmat
    return LanczosResult(
        evals=theta[sel_np],
        evecs=evecs,
        resids=np.linalg.norm(S_host[:, :n_ev], axis=0),
        n_restarts=restart + 1,
        converged=converged,
    )
