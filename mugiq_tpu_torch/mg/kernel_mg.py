"""The fine-level MG transfer and Galerkin build on the kernel layout (port
of mugiq_tpu.mg.kernel_mg).

The null vectors, the block-orthonormal basis V and every fine-volume
field stay in the kernel layout [T, 24, Z, Y*X] (comp = r*12 + s*3 + c,
fine spin s = 2*sc + sb for the chiral aggregation).  Coarse fields use the
TransferRC layout [Tc, Zc, Yc, Xc, sc, n_vec, 2], and the stencils the flat
coarse index i = sc*n_vec + w, so the coarse operator and its eigensolve
are those of rc_mg.  A block sum is an in-order reshape of a fine field
into block axes plus a sum over them; a per-block coefficient multiplies
by broadcasting over the same view.  The JAX module's lane-sum matrix,
staged reductions and fine-grained jits are TPU workarounds with no
counterpart here.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.hop_dir import dslash_hop_dir
from ..kernels.wilson import clover_apply_plain
from .rc_mg import StencilOperatorRC
from .transfer import BlockGeometry

# the axes of a _kview summed by a block reduction: bt, r, (sb, c), bz,
# by, bx
_BLOCK_AXES = (-10, -9, -7, -5, -3, -1)


def _kview(f, g: BlockGeometry, Y: int):
    """[..., T, 24, Z, Y*X] -> [..., Tc, bt, r, sc, (sb, c), Zc, bz, Yc, by,
    Xc, bx], a view (every split is in order)."""
    T, _, Z, YX = f.shape[-4:]
    X = YX // Y
    bx, by, bz, bt = g.block
    return f.reshape(f.shape[:-4] + (T // bt, bt, 2, 2, 6, Z // bz, bz,
                                     Y // by, by, X // bx, bx))


def _coef(d):
    """[..., Tc, sc, Zc, Yc, Xc] per-block coefficients -> broadcastable
    against a _kview."""
    Tc, sc, Zc, Yc, Xc = d.shape[-5:]
    return d.reshape(d.shape[:-5] + (Tc, 1, 1, sc, 1, Zc, 1, Yc, 1, Xc, 1))


def _jrot(c):
    """J c = (c_im, -c_re) on the component axis of [..., T, 24, Z, Y*X]."""
    return torch.cat([c[..., 12:, :, :], -c[..., :12, :, :]], dim=-3)


def _block_dot(q, c, g: BlockGeometry, Y: int):
    """Per-block complex <q, c> = sum conj(q) c over each (block, coarse
    spin) aggregate.  q [..., T, 24, Z, Y*X], c [T, 24, Z, Y*X] -> (re, im),
    each [..., Tc, sc, Zc, Yc, Xc].  Re sums q*c over (re, im) parts,
    Im sums q*(J c)."""
    re = _kview(q * c, g, Y).sum(_BLOCK_AXES)
    im = _kview(q * _jrot(c), g, Y).sum(_BLOCK_AXES)
    return re, im


def _caxpy(c, q, dr, di, g: BlockGeometry, Y: int):
    """c - d q with per-block complex coefficients d = dr + i di
    (i q = -J q)."""
    out = (_kview(c, g, Y) - _coef(dr) * _kview(q, g, Y)
           + _coef(di) * _kview(_jrot(q), g, Y))
    return out.reshape(c.shape)


def _mgs_kernel(V, g: BlockGeometry, Y: int):
    """Block-wise complex modified Gram-Schmidt over the leading n_vec
    axis, in the order of rc_mg._mgs_orthonormalize_rc (the same basis)."""
    Q = torch.empty_like(V)
    tiny = torch.finfo(V.dtype).tiny
    for j in range(V.shape[0]):
        c = V[j]
        for i in range(j):
            dr, di = _block_dot(Q[i], c, g, Y)
            c = _caxpy(c, Q[i], dr, di, g, Y)
        nr, _ = _block_dot(c, c, g, Y)
        inv = 1.0 / torch.sqrt(torch.clamp(nr, min=tiny))
        Q[j] = (_kview(c, g, Y) * _coef(inv)).reshape(c.shape)
    return Q


def _edge_mask(g: BlockGeometry, Y: int, mu: int, sign: int, device):
    """Fine-site mask [T, 1, Z, Y*X]: 1 where the sign*mu neighbour lies in
    the adjacent block (coord % b == b-1 forward, == 0 backward)."""
    X, _, Z, T = g.fine_dims
    t, z, y, x = np.meshgrid(np.arange(T), np.arange(Z), np.arange(Y),
                             np.arange(X), indexing="ij")
    coord = (x, y, z, t)[mu]
    b = g.block[mu]
    edge = coord % b == (b - 1 if sign > 0 else 0)
    return torch.from_numpy(edge.reshape(T, 1, Z, Y * X).astype(
        np.float32)).to(device)


def _sc_mask(s: int, device):
    """Comp-axis mask [1, 24, 1, 1] selecting coarse spin s (fine spins
    2s, 2s+1), both re and im halves."""
    m = np.zeros((2, 4, 3), np.float32)
    m[:, 2 * s:2 * s + 2, :] = 1.0
    return torch.from_numpy(m.reshape(1, 24, 1, 1)).to(device)


@dataclass
class TransferKernelMG:
    """Fine-level MG transfer on kernel-layout fields.

    V: [n_vec, T, 24, Z, Y*X] block-orthonormal basis.  Coarse fields use
    the TransferRC layout [Tc, Zc, Yc, Xc, sc, n_vec, 2]."""
    geom: BlockGeometry
    Y: int
    V: torch.Tensor

    @classmethod
    def build(cls, nulls_k, block, Y: int) -> "TransferKernelMG":
        """nulls_k: [n_vec, T, 24, Z, Y*X] kernel-layout null vectors."""
        T, _, Z, YX = nulls_k.shape[1:]
        g = BlockGeometry(fine_dims=(YX // Y, Y, Z, T), block=tuple(block),
                          ns_fine=4, nc_fine=3, spin_block=2)
        return cls(geom=g, Y=Y, V=_mgs_kernel(nulls_k, g, Y))

    @property
    def n_vec(self):
        return self.V.shape[0]

    @property
    def coarse_field_shape(self):
        Xc, Yc, Zc, Tc = self.geom.coarse_dims
        return (Tc, Zc, Yc, Xc, 2, self.n_vec, 2)

    def restrict(self, psi):
        """[T, 24, Z, Y*X] -> [Tc, Zc, Yc, Xc, sc, n_vec, 2]."""
        re, im = _block_dot(self.V, psi, self.geom, self.Y)
        # [w, Tc, sc, Zc, Yc, Xc, 2] -> [Tc, Zc, Yc, Xc, sc, w, 2]
        return torch.stack([re, im], -1).permute(1, 3, 4, 5, 2, 0,
                                                 6).contiguous()

    def prolong(self, phi):
        """[Tc, Zc, Yc, Xc, sc, n_vec, 2] -> [T, 24, Z, Y*X]:
        sum_w V_w d_w = V_w d_re - (J V_w) d_im, accumulated per w."""
        g, Y = self.geom, self.Y
        d = phi.permute(5, 6, 0, 4, 1, 2, 3)      # [w, 2, Tc, sc, Zc, Yc, Xc]
        out = torch.zeros(self.V.shape[1:], dtype=self.V.dtype,
                          device=self.V.device)
        ov = _kview(out, g, Y)
        for w in range(self.n_vec):
            ov += _coef(d[w, 0]) * _kview(self.V[w], g, Y)
            ov -= _coef(d[w, 1]) * _kview(_jrot(self.V[w]), g, Y)
        return out

    def to_agg_V(self) -> torch.Tensor:
        """V in the TransferRC storage [Tc, Zc, Yc, Xc, sc, agg, n_vec, 2],
        agg = (bt, bz, by, bx, sb, c): the checkpoint format."""
        g, n = self.geom, self.n_vec
        bx, by, bz, bt = g.block
        Xc, Yc, Zc, Tc = g.coarse_dims
        v = self.V.reshape(n, Tc, bt, 2, 2, 2, 3, Zc, bz, Yc, by, Xc, bx)
        # [w, Tc,bt, r, sc,sb,c, Zc,bz, Yc,by, Xc,bx]
        #   -> [Tc,Zc,Yc,Xc, sc, bt,bz,by,bx, sb,c, w, r]
        v = v.permute(1, 7, 9, 11, 4, 2, 8, 10, 12, 5, 6, 0, 3)
        return v.reshape(Tc, Zc, Yc, Xc, 2, g.agg, n, 2).contiguous()

    @classmethod
    def from_agg_V(cls, Vagg, geom: BlockGeometry, Y: int):
        """Inverse of to_agg_V."""
        v = torch.as_tensor(Vagg)
        Tc, Zc, Yc, Xc = v.shape[:4]
        n = v.shape[-2]
        bx, by, bz, bt = geom.block
        v = v.reshape(Tc, Zc, Yc, Xc, 2, bt, bz, by, bx, 2, 3, n, 2)
        # [Tc,Zc,Yc,Xc, sc, bt,bz,by,bx, sb,c, w, r]
        #   -> [w, Tc,bt, r, sc,sb,c, Zc,bz, Yc,by, Xc,bx]
        v = v.permute(11, 0, 5, 12, 4, 9, 10, 1, 6, 2, 7, 3, 8)
        V = v.reshape(n, Tc * bt, 24, Zc * bz, Yc * by * Xc * bx)
        return cls(geom=geom, Y=Y, V=V.contiguous())


def galerkin_kernel(U_k, kappa: float, transfer: TransferKernelMG,
                    A144=None, hops=None) -> StencilOperatorRC:
    """Exact R A P of the fine Wilson(-clover) operator A - kappa D on the
    kernel layout: probes are the basis columns masked to one coarse spin,
    each hop term one K5 launch per (probe, mu, sign) scaled by -kappa and
    split by the block-edge mask into the coarse hop (Yp/Ym) and the
    diagonal; the diagonal also restricts A probe (the probe itself for
    Wilson), as the agg formulation does.

    U_k [T, 4, 18, Z, Y*X] phased links (f32: upcast bf16 links first);
    A144 [T, 144, Z, Y*X] clover chiral blocks or None.  hops(p, mu) ->
    (forward, backward) hop of the probe p along mu, unscaled: by default
    K5 on the field as it stands (periodic), block_hops on a rank's block.
    The output layout is galerkin_coarse_operator_rc's (flat coarse index
    i = sc*n_vec + w, columns the probes (s, u))."""
    g, Y, V = transfer.geom, transfer.Y, transfer.V
    n_vec = transfer.n_vec
    dev = V.device
    mk = -float(kappa)
    if hops is None:
        def hops(p, mu):
            return [dslash_hop_dir(p, U_k, mu, sign, False, Y)
                    for sign in (1, -1)]

    def cols(cs):
        """u list of [Tc,Zc,Yc,Xc,sc,w,2] -> [Tc,Zc,Yc,Xc, n(rows), u, 2]."""
        a = torch.stack(cs, -2)                 # [Tc,Zc,Yc,Xc,sc,w,u,2]
        return a.reshape(a.shape[:4] + (2 * n_vec, len(cs), 2))

    D_b, Yp_b, Ym_b = [], [[] for _ in range(4)], [[] for _ in range(4)]
    for s in range(2):
        scm = _sc_mask(s, dev)
        dcol = [transfer.restrict(V[u] * scm if A144 is None else
                                  clover_apply_plain(A144, V[u] * scm))
                for u in range(n_vec)]
        for mu in range(4):
            ems = [_edge_mask(g, Y, mu, sign, dev) for sign in (1, -1)]
            ycols = ([], [])
            for u in range(n_vec):
                for h, em, ycol in zip(hops(V[u] * scm, mu), ems, ycols):
                    h *= mk
                    ycol.append(transfer.restrict(h * em))
                    dcol[u] = dcol[u] + transfer.restrict(h * (1.0 - em))
            Yp_b[mu].append(cols(ycols[0]))
            Ym_b[mu].append(cols(ycols[1]))
        D_b.append(cols(dcol))
    return StencilOperatorRC(
        D=torch.cat(D_b, -2),
        Yp=[torch.cat(Yp_b[mu], -2) for mu in range(4)],
        Ym=[torch.cat(Ym_b[mu], -2) for mu in range(4)],
        ns=2, nc=n_vec)


def block_hops(mesh, halo, U_loc):
    """galerkin_kernel's hops on one rank's block (links U_loc [Tl, 4, 18,
    Zl, Yl*X], f32): K5 on the block along a direction the mesh does not
    partition; along one it does, K5 on the probe extended by one slice a
    side (shard_dslash.extend_along, one exchange a probe and axis) with
    the links extended alike (once, here), and the interior kept: K5's
    periodic wrap then touches halo rows only."""
    from ..parallel.shard_dslash import extend_along, partitioned_dirs

    Yl = mesh.local["y"]
    split = partitioned_dirs(mesh)
    U_ext = {mu: extend_along(halo, U_loc, a, du, w)
             for mu, (a, du, _, w) in split.items()}

    def hops(p, mu):
        if mu not in split:
            return [dslash_hop_dir(p, U_loc, mu, sign, False, Yl)
                    for sign in (1, -1)]
        a, _, d, w = split[mu]
        ext = extend_along(halo, p, a, d, w)
        Ye = Yl + 2 if a == "y" else Yl
        return [dslash_hop_dir(ext, U_ext[mu], mu, sign, False, Ye)
                .narrow(d, w, p.shape[d]).contiguous() for sign in (1, -1)]

    return hops


def check_blocks_divide(mesh, block) -> None:
    """Under a mesh every fine MG block must lie inside one rank's block
    (the block Gram-Schmidt and the restriction are then rank-local): each
    extent of `block` (bx, by, bz, bt) must divide the local extent along
    a partitioned axis."""
    X, Yl, Zl, Tl = mesh.local_dims
    for axis, n, b in (("y", Yl, block[1]), ("z", Zl, block[2]),
                       ("t", Tl, block[3])):
        if mesh.shape[axis] > 1 and n % b:
            raise ValueError(
                f"the MG block {tuple(block)} straddles the ranks: along "
                f"the mesh axis {axis} the local extent {n} is not a "
                f"multiple of the block's {b}")
