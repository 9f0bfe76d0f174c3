"""Plain Wilson operator on complex full-site fields, written for the
benchmark's correctness check; it imports nothing of the program.

    M psi(x) = psi(x) - kappa sum_mu [ (1 - g_mu) U_mu(x) psi(x + mu)
                     + (1 + g_mu) U_mu(x - mu)^dag psi(x - mu) ]

in the DeGrand-Rossi basis, with the antiperiodic time boundary folded into
the t-links of the last time slice.  Fields: spinors [..., T, Z, Y, X, 4, 3],
links [4, T, Z, Y, X, 3, 3] (mu = x, y, z, t), complex64 or complex128.

The program hands its vectors over in its kernel layout [T, 24, Z, Y*X]
(component r*12 + s*3 + c, r the real / imaginary plane);
``from_kernel_layout`` reads them into full-site fields.
"""

import numpy as np
import torch

#: lattice direction mu (x, y, z, t) -> axis of a [..., T, Z, Y, X, a, b]
#: field, counted from the end
MU_AXIS = (-3, -4, -5, -6)


def base_gammas() -> np.ndarray:
    """g_x, g_y, g_z, g_t in the DeGrand-Rossi basis, [4, 4, 4]."""
    i = 1j
    gx = [[0, 0, 0, i], [0, 0, i, 0], [0, -i, 0, 0], [-i, 0, 0, 0]]
    gy = [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]]
    gz = [[0, 0, i, 0], [0, 0, 0, -i], [-i, 0, 0, 0], [0, i, 0, 0]]
    gt = [[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]]
    return np.array([gx, gy, gz, gt], dtype=np.complex128)


def gamma16() -> np.ndarray:
    """The 16 products G(n) = g_x^n0 g_y^n1 g_z^n2 g_t^n3, n = n0 + 2 n1 +
    4 n2 + 8 n3, [16, 4, 4] (MuGiq's gamma order)."""
    g = base_gammas()
    out = np.zeros((16, 4, 4), dtype=np.complex128)
    for n in range(16):
        m = np.eye(4, dtype=np.complex128)
        for mu in range(4):
            if (n >> mu) & 1:
                m = m @ g[mu]
        out[n] = m
    return out


def from_kernel_layout(k: torch.Tensor, Y: int) -> torch.Tensor:
    """[..., T, 24, Z, Y*X] real -> complex [..., T, Z, Y, X, 4, 3] of the
    same precision (complex64 from float32)."""
    lead = k.shape[:-4]
    T, _, Z, YX = k.shape[-4:]
    f = k.reshape(lead + (T, 2, 4, 3, Z, Y, YX // Y)).float()
    n = len(lead)
    perm = tuple(range(n)) + tuple(n + a for a in (0, 4, 5, 6, 2, 3, 1))
    f = f.permute(perm)                        # [..., T, Z, Y, X, 4, 3, 2]
    return torch.complex(f[..., 0], f[..., 1])


def kernel_layout_to_full(k: np.ndarray, Y: int) -> np.ndarray:
    """numpy form of from_kernel_layout (a host draw in the kernel layout)."""
    T, _, Z, YX = k.shape
    f = k.reshape(T, 2, 4, 3, Z, Y, YX // Y)
    f = np.transpose(f, (0, 4, 5, 6, 2, 3, 1))
    return f[..., 0] + 1j * f[..., 1]


def phased_links(U: torch.Tensor, antiperiodic_t: bool = True) -> torch.Tensor:
    """The operator's links: t-links of the last time slice times -1."""
    U = U.clone()
    if antiperiodic_t:
        U[3, -1] *= -1
    return U


def shift(f: torch.Tensor, mu: int, sign: int) -> torch.Tensor:
    """f(x + sign mu), periodic."""
    return torch.roll(f, -sign, dims=MU_AXIS[mu])


class Wilson:
    """M, M^dag and M^dag M of plain Wilson fermions on links U (phased),
    in U's complex dtype."""

    def __init__(self, U: torch.Tensor, kappa: float):
        self.U = U
        self.kappa = kappa
        g = torch.as_tensor(base_gammas(), dtype=U.dtype, device=U.device)
        eye = torch.eye(4, dtype=U.dtype, device=U.device)
        # spin matrices of the forward (1 - g) and backward (1 + g) hops
        self.proj = {(mu, s): eye - s * g[mu] for mu in range(4)
                     for s in (1, -1)}
        self.g5 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=U.real.dtype,
                               device=U.device).reshape(4, 1)
        # U_mu(x - mu)^dag, the backward hop's links
        self.Ub = [shift(U[mu], mu, -1).transpose(-1, -2).conj()
                   for mu in range(4)]

    def hop(self, psi: torch.Tensor, mu: int, sign: int) -> torch.Tensor:
        """One directed hop without -kappa: (1 - g_mu) U_mu(x) psi(x+mu)
        (sign +1) or (1 + g_mu) U_mu(x-mu)^dag psi(x-mu) (sign -1)."""
        link = self.U[mu] if sign > 0 else self.Ub[mu]
        nbr = shift(psi, mu, sign)
        # colour: out[s, a] = sum_b link[a, b] nbr[s, b]
        c = (link.unsqueeze(-3) * nbr.unsqueeze(-2)).sum(-1)
        return torch.einsum("rs,...sa->...ra", self.proj[(mu, sign)], c)

    def M(self, psi: torch.Tensor) -> torch.Tensor:
        out = psi.clone()
        for mu in range(4):
            for sign in (1, -1):
                out -= self.kappa * self.hop(psi, mu, sign)
        return out

    def Mdag(self, psi: torch.Tensor) -> torch.Tensor:
        """g5 M g5 (g5-hermiticity)."""
        return self.g5 * self.M(self.g5 * psi)

    def MdagM(self, psi: torch.Tensor) -> torch.Tensor:
        return self.Mdag(self.M(psi))


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum conj(a) b."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def gram_defect(vecs: torch.Tensor) -> float:
    """max |V^dag V - I| over the Gram matrix of the vectors (rows of V),
    in complex128."""
    V = vecs.reshape(vecs.shape[0], -1).to(torch.complex128)
    G = V.conj() @ V.T
    return float(torch.max(torch.abs(
        G - torch.eye(len(G), dtype=G.dtype, device=G.device))))


def eigen_residuals(op, vecs, evals) -> tuple:
    """For each vector v_i and eigenvalue lambda_i (the program's):
    ||A v - lambda v|| / (lambda ||v||) and the Rayleigh quotient
    <v, A v> / <v, v>, with A = op (a callable), one vector at a time."""
    res, rq = [], []
    for v, lam in zip(vecs, evals):
        w = op(v)
        vv = vdot(v, v).real
        rq.append(float(vdot(v, w).real / vv))
        res.append(float(torch.linalg.vector_norm(w - lam * v)
                         / (abs(lam) * torch.sqrt(vv))))
        del w
    return res, rq
