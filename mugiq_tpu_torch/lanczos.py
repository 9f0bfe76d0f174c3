"""Thick-restart Lanczos on real-pair fields (port of
mugiq_tpu.planar.lanczos.lanczos_hermitian_realpair and
rayleigh_ritz_refine).

Fields are real arrays whose `re_im_axis` holds the real parts in its
first half and the imaginary parts in its second (the kernel layout
[T, 24, Z, Y*X] with re_im_axis=1).  Complex algebra becomes full-array
real GEMMs on flat [m+1, N] views of the basis plus the J rotation
(xr, xi) -> (xi, -xr): for re/im-paired arrays Re<a,b> = sum a*b and
Im<a,b> = sum a*(J b).  The projected matrix is eigh'd on the host.
Kept from JAX: CGS2 full reorthogonalisation, thick restart with
k = min(n_ev + max(1, (m - n_ev)//2), m - 2), the convergence test.
The XLA machinery (donation, prefix blocking, caches) has no counterpart;
the reorthogonalisation reads the live prefix V[:j+1] directly.

basis_dtype=torch.bfloat16 stores V in bf16 (the planar/lanczos.py
basis_dtype path): only stores round; the stored vector feeds the
operator as it is and the operator's result is upcast; all algebra is
f32.  The products with V (_mm) read the bf16 basis natively on CUDA,
never an f32 copy of it.  The cycle (krylov_cycle) also records the
Hessenberg matrix of a non-normal operator (hermitian=False), for the
Krylov-Schur Arnoldi of eig/arnoldi_realpair.py.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


def normalize_which(which: str) -> str:
    """SR/SM -> 'SR', LR/LM -> 'LR' for a Hermitian PSD operator; SI/LI
    (and typos) raise."""
    w = which.upper()
    if w in ("SR", "SM"):
        return "SR"
    if w in ("LR", "LM"):
        return "LR"
    raise ValueError(
        f"spectrum '{which}' unsupported by the Hermitian production "
        f"eigensolver (PSD operator: use SR/SM or LR/LM)")


@dataclass
class LanczosResult:
    evals: np.ndarray
    evecs: torch.Tensor      # [n_ev, *field]
    resids: np.ndarray
    n_restarts: int
    converged: bool


def _jrot(x: torch.Tensor, ax: int) -> torch.Tensor:
    """J x: (xr, xi) -> (xi, -xr) on the re/im split axis."""
    xr, xi = torch.chunk(x, 2, dim=ax)
    return torch.cat([xi, -xr], dim=ax)


def _mm(a, b):
    """a @ b of 2-D operands, one of them possibly the bf16 basis (the
    port of planar/lanczos.py _make_ops.match): the result is in the
    other operand's (the algebra's) dtype.  On CUDA the small operand is
    cast to bf16 and torch.mm reads the basis natively, accumulating and
    returning f32 (the aten::mm.dtype overload; XLA's
    preferred_element_type=f32); an f32 copy of the basis would cost a
    full pass per product.  On the CPU the bf16 operand is promoted, as
    the JAX CPU backend does, which is exact."""
    if a.dtype == b.dtype:
        return a @ b
    lo = torch.bfloat16
    if a.device.type == "cuda":
        return torch.mm(a.to(lo), b.to(lo), out_dtype=torch.float32)
    dt = b.dtype if a.dtype == lo else a.dtype
    return a.to(dt) @ b.to(dt)


def _dots(V, w, ax):
    """d_i = <V_i, w> as [len(V), 2] (re, im); one pass over V."""
    W = torch.stack([w, _jrot(w, ax)]).reshape(2, -1)
    return _mm(V.reshape(V.shape[0], -1), W.T)


def _axpy_sub(w, d, V, ax):
    """w - sum_i d_i V_i (complex d in parts)."""
    C = _mm(d.T, V.reshape(V.shape[0], -1)).reshape((2,) + w.shape)
    return w - C[0] + _jrot(C[1], ax)


def _rotate(V, Qr, Qi, ax):
    """V'_k = sum_i Q[i, k] V_i for complex Q = Qr + i Qi -> [k, *field]
    in Q's dtype (f32 from a bf16 basis)."""
    Vf = V.reshape(V.shape[0], -1)
    shape = (Qr.shape[1],) + V.shape[1:]
    Cr = _mm(Qr.T, Vf).reshape(shape)
    Ci = _mm(Qi.T, Vf).reshape(shape)
    return Cr - _jrot(Ci, ax + 1)


def krylov_cycle(matvec: Callable, V: torch.Tensor, Tmat: torch.Tensor,
                 j0: int, ax: int, reduce: Optional[Callable] = None,
                 hermitian: bool = True):
    """Krylov steps j0..m-1 with CGS2 full reorthogonalisation (port of
    planar/lanczos.py _make_cycle): V [m+1, *field] (f32, or bf16 with
    f32 algebra), Tmat [m, m, 2] the projected matrix, both updated in
    place.  hermitian=True records the Lanczos T (column, conjugate row,
    real beta sub- and super-diagonal); False the Arnoldi/Krylov-Schur
    Hessenberg column and beta sub-diagonal.  Returns the last beta."""
    m = Tmat.shape[0]
    rdtype = Tmat.dtype
    tiny = torch.finfo(rdtype).tiny
    sign = torch.tensor([1.0, -1.0], dtype=rdtype, device=Tmat.device)
    red = reduce or (lambda x: x)
    beta = torch.zeros((), dtype=rdtype, device=Tmat.device)
    for j in range(j0, m):
        # the stored vector feeds the operator as it is; its result is
        # upcast and the algebra stays f32
        w = matvec(V[j]).to(rdtype)
        Vp = V[:j + 1]
        d = red(_dots(Vp, w, ax))
        w = _axpy_sub(w, d, Vp, ax)
        d2 = red(_dots(Vp, w, ax))
        w = _axpy_sub(w, d2, Vp, ax)
        col = d + d2                                      # [j+1, 2]
        Tmat[:j + 1, j] = col
        beta = norm(w, reduce)
        V[j + 1] = w / torch.clamp(beta, min=tiny)
        if hermitian:
            Tmat[j, :j + 1] = col * sign                  # conjugate row
        if j + 1 < m:
            Tmat[j + 1, j, 0] = beta
            Tmat[j + 1, j, 1] = 0.0
            if hermitian:
                Tmat[j, j + 1, 0] = beta
                Tmat[j, j + 1, 1] = 0.0
    return beta


def norm(x: torch.Tensor, reduce: Optional[Callable] = None):
    """The 2-norm of x; with `reduce` (the sum over ranks of a sharded
    field's local parts) the global norm of the field whose local part x
    is."""
    n = torch.linalg.vector_norm(x)
    return n if reduce is None else torch.sqrt(reduce(n * n))


def _unitize(E, reduce=None):
    nrm = torch.linalg.vector_norm(E.reshape(E.shape[0], -1), dim=1)
    if reduce is not None:
        nrm = torch.sqrt(reduce(nrm * nrm))
    return E / nrm.reshape((-1,) + (1,) * (E.ndim - 1))


def lanczos_hermitian_realpair(
    matvec: Callable,
    v0: torch.Tensor,
    n_ev: int,
    n_kr: int,
    re_im_axis: int = 0,
    tol: float = 1e-6,
    max_restarts: int = 100,
    which: str = "SR",
    check_interval: int = 1,
    reduce: Optional[Callable] = None,
    basis_dtype: Optional[torch.dtype] = None,
) -> LanczosResult:
    """n_ev extremal eigenpairs of a Hermitian operator on real-pair fields.

    The Krylov basis V [n_kr+1, *field] lives on v0's device in
    basis_dtype (default v0's dtype); all GEMMs run in full f32 (the
    package pins TF32 off).  A bf16 basis halves the cycle algebra's
    traffic; its residuals floor near bf16 storage eps (deflation-grade).
    The evecs come back in v0's dtype.

    reduce: for a field sharded over ranks (v0 and matvec's fields are the
    local blocks), the sum over ranks of a tensor of local partial sums;
    every inner product and norm goes through it, so the projected matrix
    and every convergence decision are the same on every rank.  None on
    one device."""
    which = normalize_which(which)
    shape = v0.shape
    ax = re_im_axis
    if shape[ax] % 2:
        raise ValueError(f"re_im_axis {ax} has odd extent {shape[ax]}")
    dev, rdtype = v0.device, v0.dtype
    m = n_kr
    k = max(min(n_ev + max(1, (m - n_ev) // 2), m - 2), n_ev)

    V = torch.zeros((m + 1,) + tuple(shape), dtype=basis_dtype or rdtype,
                    device=dev)
    V[0] = v0 / norm(v0, reduce)
    Tmat = torch.zeros((m, m, 2), dtype=rdtype, device=dev)

    j0 = 0
    converged = False
    theta = q = sel = None
    beta_h = 0.0
    for restart in range(max_restarts):
        beta_h = float(krylov_cycle(matvec, V, Tmat, j0, ax, reduce))
        T2 = Tmat.double().cpu().numpy()
        T_host = T2[..., 0] + 1j * T2[..., 1]
        theta, q = np.linalg.eigh((T_host + T_host.conj().T) / 2)
        sel = (np.arange(k) if which == "SR"
               else np.arange(m - 1, m - 1 - k, -1))
        resid = np.abs(beta_h * q[m - 1, sel])
        if (restart + 1) % check_interval == 0 or restart == max_restarts - 1:
            t_np = theta[sel][:n_ev]
            if np.all(resid[:n_ev] < tol * np.maximum(1.0, np.abs(t_np))):
                converged = True
                break
        if restart == max_restarts - 1:
            break
        # thick restart: V[:k] = Ritz vectors, V[k] = residual vector V[m],
        # T = diag(theta_sel); the next cycle's CGS2 rebuilds the arrow
        Qs = q[:, sel]
        Vk = _rotate(V[:m], torch.as_tensor(Qs.real, dtype=rdtype, device=dev),
                     torch.as_tensor(Qs.imag, dtype=rdtype, device=dev), ax)
        V[:k] = Vk
        del Vk
        V[k] = V[m]
        Tmat.zero_()
        idx = torch.arange(k, device=dev)
        Tmat[idx, idx, 0] = torch.as_tensor(theta[sel], dtype=rdtype,
                                            device=dev)
        j0 = k

    sel_np = np.asarray(sel)[:n_ev]
    Qs = q[:, sel_np]
    evecs = _unitize(_rotate(
        V[:m], torch.as_tensor(Qs.real, dtype=rdtype, device=dev),
        torch.as_tensor(Qs.imag, dtype=rdtype, device=dev), ax), reduce)
    del V, Tmat
    return LanczosResult(
        evals=theta[sel_np],
        evecs=evecs,
        resids=np.abs(beta_h * q[m - 1, sel_np]),
        n_restarts=restart + 1,
        converged=converged,
    )


def rayleigh_ritz_refine(matvec: Callable, evecs: torch.Tensor,
                         re_im_axis: int = 0,
                         reduce: Optional[Callable] = None):
    """Second Rayleigh-Ritz pass on the ORIGINAL operator.

    Ritz vectors of a Chebyshev-filtered solve bottom out at the cluster
    width of the spectrum; projecting A itself on their span (a small
    generalized eigenproblem on the host) resolves the clusters.  The
    projections H = V^dag A V and G = V^dag V accumulate in float64 on the
    device (native on the H100); on a sharded field `reduce` sums their
    local parts over the ranks in float64.
    Returns (evecs', evals', resids'), evecs' unit-norm, ascending evals.
    """
    import scipy.linalg

    ax = re_im_axis
    red = reduce or (lambda x: x)
    n = evecs.shape[0]
    Vd = evecs.reshape(n, -1).double()
    H = torch.empty((n, n), dtype=torch.complex128)
    G = torch.empty((n, n), dtype=torch.complex128)
    for j in range(n):
        v = evecs[j]
        w = matvec(v)
        hw = torch.stack([w, _jrot(w, ax)]).reshape(2, -1).double()
        gv = torch.stack([v, _jrot(v, ax)]).reshape(2, -1).double()
        h = red(Vd @ hw.T).cpu()
        g = red(Vd @ gv.T).cpu()
        H[:, j] = torch.complex(h[:, 0], h[:, 1])
        G[:, j] = torch.complex(g[:, 0], g[:, 1])
    del Vd
    Hn = H.numpy()
    Gn = G.numpy()
    Hn = (Hn + Hn.conj().T) / 2
    Gn = (Gn + Gn.conj().T) / 2
    theta, q = scipy.linalg.eigh(Hn, Gn)
    dev, dt = evecs.device, evecs.dtype
    refined = _unitize(_rotate(evecs,
                               torch.as_tensor(q.real, dtype=dt, device=dev),
                               torch.as_tensor(q.imag, dtype=dt, device=dev),
                               ax), reduce)
    rs = []
    for j in range(n):
        v = refined[j]
        d = float(theta[j]) * v - matvec(v)
        rs.append(float(norm(d.double(), reduce)))
    return refined, theta, np.asarray(rs)
