"""Plain two-level MG coarse space of a Wilson operator, written for the
benchmark's correctness check; it imports nothing of the program.

The hierarchy is MuGiq's recipe, worked out again from the gauge and the
set-up seed: n_vec null vectors, each a host draw of normals
(numpy default_rng(setup_seed), one [T, 24, Z, Y*X] draw a vector, the
kernel layout's component order), smoothed by setup_iters iterations of CG
on M^dag M from zero and normalised; blocks of b_x b_y b_z b_t sites,
split by chirality (spins {0, 1} and {2, 3}); each block's vectors
orthonormalised; the coarse operator the Galerkin product P^dag M P.  Only
the span of each block's vectors enters the check, so the orthonormal basis
may differ from the program's by a unitary rotation a block.

Coarse fields are [Tc, Zc, Yc, Xc, 2 * n_vec]; the stencil
M_c u(x) = D(x) u(x) + sum_mu Yp_mu(x) u(x + mu) + Ym_mu(x) u(x - mu).
"""

import queue
import threading

import numpy as np
import torch

from .wilson import MU_AXIS, kernel_layout_to_full, vdot


def draw_null_sources(setup_seed: int, n_vec: int, dims, out: queue.Queue):
    """The host draws, in order, as full-site complex128 fields (run in a
    thread: numpy fills the array without the interpreter lock)."""
    X, Y, Z, T = dims
    rng = np.random.default_rng(setup_seed)
    for _ in range(n_vec):
        b = rng.standard_normal((T, 24, Z, Y * X)).astype(np.float32)
        out.put(kernel_layout_to_full(b, Y))


def cg_smooth(op, b: torch.Tensor, iters: int) -> torch.Tensor:
    """iters iterations of CG on op (Hermitian positive) from x = 0."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    rs = vdot(r, r).real
    for _ in range(iters):
        ap = op(p)
        alpha = rs / vdot(p, ap).real
        x += alpha * p
        r -= alpha * ap
        rs_new = vdot(r, r).real
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x


def null_vectors(wilson, setup_seed: int, n_vec: int, iters: int, dims,
                 dtype=torch.complex64) -> torch.Tensor:
    """[n_vec, T, Z, Y, X, 4, 3] on the operator's device, in `dtype`; the
    next draw runs on the host while the device smooths the last one."""
    q = queue.Queue(maxsize=2)
    th = threading.Thread(target=draw_null_sources,
                          args=(setup_seed, n_vec, dims, q), daemon=True)
    th.start()
    out = []
    for _ in range(n_vec):
        b = torch.from_numpy(q.get()).to(wilson.U.device, dtype)
        x = cg_smooth(wilson.MdagM, b, iters)
        out.append(x / torch.sqrt(vdot(x, x).real))
    th.join()
    return torch.stack(out)


class Blocking:
    """Fine field [..., T, Z, Y, X, 4, 3] <-> per-aggregate vectors
    [..., Tc, Zc, Yc, Xc, 2, agg]: the block's sites, the chirality's two
    spins and three colours."""

    def __init__(self, dims, block):
        X, Y, Z, T = dims
        bx, by, bz, bt = block
        self.fine = (T, Z, Y, X)
        self.b = (bt, bz, by, bx)
        self.coarse = (T // bt, Z // bz, Y // by, X // bx)

    def agg(self, f: torch.Tensor) -> torch.Tensor:
        lead = f.shape[:-6]
        (Tc, Zc, Yc, Xc), (bt, bz, by, bx) = self.coarse, self.b
        r = f.reshape(lead + (Tc, bt, Zc, bz, Yc, by, Xc, bx, 2, 2, 3))
        n = len(lead)
        perm = tuple(range(n)) + tuple(n + a for a in
                                       (0, 2, 4, 6, 8, 1, 3, 5, 7, 9, 10))
        return r.permute(perm).reshape(lead + self.coarse + (2, -1))

    def unagg(self, a: torch.Tensor) -> torch.Tensor:
        lead = a.shape[:-6]
        (Tc, Zc, Yc, Xc), (bt, bz, by, bx) = self.coarse, self.b
        r = a.reshape(lead + (Tc, Zc, Yc, Xc, 2, bt, bz, by, bx, 2, 3))
        n = len(lead)
        perm = tuple(range(n)) + tuple(n + a for a in
                                       (0, 5, 1, 6, 2, 7, 3, 8, 4, 9, 10))
        return r.permute(perm).reshape(lead + self.fine + (4, 3))

    def edge(self, mu: int, sign: int, device) -> torch.Tensor:
        """1 at fine sites whose neighbour x + sign mu lies in another
        block, [T, Z, Y, X, 1, 1]."""
        ax = 3 - mu                                 # (T, Z, Y, X) axis
        n, b = self.fine[ax], self.b[ax]
        pos = torch.arange(n, device=device) % b
        m = (pos == (b - 1 if sign > 0 else 0)).to(torch.float64)
        shape = [1, 1, 1, 1]
        shape[ax] = n
        return m.reshape(shape + [1, 1])


class Transfer:
    """Block-orthonormal basis V [Tc, Zc, Yc, Xc, 2, agg, n_vec] of the null
    vectors' span in each aggregate (Cholesky QR in float64)."""

    def __init__(self, nulls: torch.Tensor, blocking: Blocking):
        self.blk = blocking
        A = torch.movedim(blocking.agg(nulls), 0, -1).to(torch.complex128)
        L = torch.linalg.cholesky(A.transpose(-1, -2).conj() @ A)
        # V = A L^-dag: V^dag V = 1, the same span as A
        Vt = torch.linalg.solve_triangular(L, A.transpose(-1, -2).conj(),
                                           upper=False)
        self.V = Vt.transpose(-1, -2).conj().to(nulls.dtype)
        self.n_vec = nulls.shape[0]

    def restrict(self, f: torch.Tensor) -> torch.Tensor:
        """[..., T, Z, Y, X, 4, 3] -> [..., Tc, Zc, Yc, Xc, 2 * n_vec]."""
        a = self.blk.agg(f).unsqueeze(-2)          # [..., 2, 1, agg]
        r = (a @ self.V.conj()).squeeze(-2)        # [..., 2, n_vec]
        return r.reshape(r.shape[:-2] + (-1,))

    def prolong(self, u: torch.Tensor) -> torch.Tensor:
        c = u.reshape(u.shape[:-1] + (2, self.n_vec, 1))
        return self.blk.unagg((self.V @ c).squeeze(-1))

    def probes(self, s: int, v: int) -> torch.Tensor:
        """P e_(s, v), the unit coarse vector at every coarse site."""
        return self.blk.unagg(
            torch.nn.functional.pad(self.V[..., s:s + 1, :, v],
                                    (0, 0, s, 1 - s)))


class Coarse:
    """The Galerkin coarse operator P^dag M P of a Wilson operator and a
    Transfer, built by probing: each directed hop of each probe split by the
    block-edge mask into the coarse hop and the diagonal."""

    def __init__(self, wilson, tr: Transfer):
        blk = tr.blk
        dev = tr.V.device
        n = 2 * tr.n_vec
        cols_d, cols_p, cols_m = [], [[] for _ in range(4)], \
            [[] for _ in range(4)]
        edges = {(mu, s): blk.edge(mu, s, dev) for mu in range(4)
                 for s in (1, -1)}
        for s in range(2):
            for v in range(tr.n_vec):
                p = tr.probes(s, v)
                d = tr.restrict(p)
                for mu in range(4):
                    for sign, cols in ((1, cols_p), (-1, cols_m)):
                        h = -wilson.kappa * wilson.hop(p, mu, sign)
                        m = edges[(mu, sign)].to(h.real.dtype)
                        cols[mu].append(tr.restrict(h * m))
                        d = d + tr.restrict(h * (1 - m))
                        del h
                cols_d.append(d)
        # column j of each stencil [Tc, Zc, Yc, Xc, n, n]
        self.D = torch.stack(cols_d, -1)
        self.Yp = [torch.stack(c, -1) for c in cols_p]
        self.Ym = [torch.stack(c, -1) for c in cols_m]
        self.n = n

    def to(self, dtype) -> "Coarse":
        self.D = self.D.to(dtype)
        self.Yp = [y.to(dtype) for y in self.Yp]
        self.Ym = [y.to(dtype) for y in self.Ym]
        return self

    @staticmethod
    def _shift(u, mu, sign):
        return torch.roll(u, -sign, dims=MU_AXIS[mu] + 1)

    def M(self, u: torch.Tensor) -> torch.Tensor:
        out = (self.D @ u.unsqueeze(-1))[..., 0]
        for mu in range(4):
            out += (self.Yp[mu] @ self._shift(u, mu, 1).unsqueeze(-1))[..., 0]
            out += (self.Ym[mu] @ self._shift(u, mu, -1).unsqueeze(-1))[..., 0]
        return out

    def Mdag(self, u: torch.Tensor) -> torch.Tensor:
        def h(a):
            return a.transpose(-1, -2).conj()
        out = (h(self.D) @ u.unsqueeze(-1))[..., 0]
        for mu in range(4):
            # (Yp_mu(x - mu))^dag u(x - mu) + (Ym_mu(x + mu))^dag u(x + mu)
            out += self._shift(
                (h(self.Yp[mu]) @ u.unsqueeze(-1))[..., 0], mu, -1)
            out += self._shift(
                (h(self.Ym[mu]) @ u.unsqueeze(-1))[..., 0], mu, 1)
        return out

    def MdagM(self, u: torch.Tensor) -> torch.Tensor:
        return self.Mdag(self.M(u))
