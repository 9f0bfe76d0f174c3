"""The coarse stencil operator, the coarser-level transfers and the MG
hierarchy (port of mugiq_tpu.mg.rc_mg).

Coarse fields and stencils keep the JAX package's real-pair layouts (a
trailing (re, im) axis: fields [T, Z, Y, X, ns, nc, 2], stencils
[T, Z, Y, X, n, n, 2]), so a hierarchy saved by either package loads in
the other.  That trailing axis is exactly torch.view_as_complex's, so
every term is a complex per-site [n, n] matvec plus torch.roll.  These are
plain torch ops: the JAX package computes them outside any Pallas kernel.
The fine level of the hierarchy is the kernel-layout formulation of
kernel_mg at every volume (the JAX package's host/split/agg fine-level
setups are TPU workarounds).
"""

from dataclasses import dataclass, field, replace
from typing import List

import numpy as np
import torch

from ..params import EigOperator, MGParam
from ..utils import log, phase_timer
from .transfer import BlockGeometry, block_edge_mask

# lattice direction -> axis of a [T, Z, Y, X, ...] coarse field
_MU_AXIS = (3, 2, 1, 0)


def _cplx(x):
    """Real-pair [..., 2] -> complex view [...]."""
    return torch.view_as_complex(x.contiguous())


def _rpair(z):
    return torch.view_as_real(z)


# ---------------------------------------------------------------------------
# real-pair block aggregation
# ---------------------------------------------------------------------------

def _block_agg_rc(psi, g: BlockGeometry):
    """[T,Z,Y,X,ns,nc,2] -> [Tc,Zc,Yc,Xc,ns_c,agg,2]."""
    T, Z, Y, X = psi.shape[:4]
    bx, by, bz, bt = g.block
    r = psi.reshape(T // bt, bt, Z // bz, bz, Y // by, by, X // bx, bx,
                    g.ns_coarse, g.spin_block, g.nc_fine, 2)
    r = r.permute(0, 2, 4, 6, 8, 1, 3, 5, 7, 9, 10, 11)
    return r.reshape(r.shape[:5] + (g.agg, 2))


def _unblock_agg_rc(phi, g: BlockGeometry):
    """Inverse of _block_agg_rc."""
    Tc, Zc, Yc, Xc = phi.shape[:4]
    bx, by, bz, bt = g.block
    r = phi.reshape(Tc, Zc, Yc, Xc, g.ns_coarse, bt, bz, by, bx,
                    g.spin_block, g.nc_fine, 2)
    r = r.permute(0, 5, 1, 6, 2, 7, 3, 8, 4, 9, 10, 11)
    return r.reshape(Tc * bt, Zc * bz, Yc * by, Xc * bx,
                     g.ns_coarse * g.spin_block, g.nc_fine, 2)


def _mgs_orthonormalize_rc(V):
    """Batched complex modified Gram-Schmidt on real-pair columns:
    V [..., agg, nvec, 2] -> a column-orthonormal basis per batch entry."""
    Vc = _cplx(V)
    tiny = torch.finfo(V.dtype).tiny
    cols = [Vc[..., j] for j in range(Vc.shape[-1])]    # each [..., agg]
    for j in range(len(cols)):
        for i in range(j):
            d = torch.sum(cols[i].conj() * cols[j], -1, keepdim=True)
            cols[j] = cols[j] - d * cols[i]
        nrm = torch.linalg.vector_norm(cols[j], dim=-1, keepdim=True)
        cols[j] = cols[j] / torch.clamp(nrm, min=tiny)
    return _rpair(torch.stack(cols, -1)).contiguous()


@dataclass
class TransferRC:
    """Orthonormal block transfer between two coarse levels.

    V [Tc, Zc, Yc, Xc, ns_c, agg, n_vec, 2]."""
    geom: BlockGeometry
    V: torch.Tensor

    @classmethod
    def build(cls, null_vecs_rc, block, spin_block: int) -> "TransferRC":
        """null_vecs_rc: [n_vec, T, Z, Y, X, ns, nc, 2]."""
        T, Z, Y, X, ns, nc = null_vecs_rc.shape[1:7]
        g = BlockGeometry(fine_dims=(X, Y, Z, T), block=tuple(block),
                          ns_fine=ns, nc_fine=nc, spin_block=spin_block)
        blocked = torch.stack([_block_agg_rc(v, g) for v in null_vecs_rc])
        Vraw = torch.movedim(blocked, 0, -2)        # [..., ns_c, agg, nvec, 2]
        return cls(geom=g, V=_mgs_orthonormalize_rc(Vraw))

    @property
    def coarse_field_shape(self):
        Xc, Yc, Zc, Tc = self.geom.coarse_dims
        return (Tc, Zc, Yc, Xc, self.geom.ns_coarse, self.V.shape[-2], 2)

    def restrict(self, psi, mask_agg=None):
        h = _block_agg_rc(psi, self.geom)
        if mask_agg is not None:
            h = h * mask_agg[:, None]
        out = torch.einsum("...av,...a->...v", _cplx(self.V).conj(), _cplx(h))
        return _rpair(out)

    def prolong(self, phi):
        h = torch.einsum("...av,...v->...a", _cplx(self.V), _cplx(phi))
        return _unblock_agg_rc(_rpair(h), self.geom)

    def probe_fine_vectors(self):
        """P applied to each coarse unit vector e_{s, v} (1 at every coarse
        site): [ns_c * n_vec, *fine field]."""
        probes = []
        for s in range(self.geom.ns_coarse):
            for v in range(self.V.shape[-2]):
                e = torch.zeros(self.coarse_field_shape, dtype=self.V.dtype,
                                device=self.V.device)
                e[..., s, v, 0] = 1.0
                probes.append(self.prolong(e))
        return torch.stack(probes)


# ---------------------------------------------------------------------------
# coarse stencil operator
# ---------------------------------------------------------------------------

@dataclass
class StencilOperatorRC:
    """Coarse operator M phi(x) = D(x) phi(x) + sum_mu Yp_mu(x) phi(x+mu)
    + Ym_mu(x) phi(x-mu) on real-pair fields [T, Z, Y, X, ns, nc, 2];
    D, Yp[mu], Ym[mu]: [T, Z, Y, X, n, n, 2] with n = ns * nc.

    M and M^dag each stack their nine complex link tensors once, at first
    use (M^dag's are the conjugate transposes of D, Ym(x+mu), Yp(x-mu));
    the stencils must not change after that."""
    D: torch.Tensor
    Yp: List[torch.Tensor]
    Ym: List[torch.Tensor]
    ns: int
    nc: int
    _links: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    @property
    def field_shape(self):
        return tuple(self.D.shape[:4]) + (self.ns, self.nc, 2)

    @property
    def dtype(self):
        return self.D.dtype

    def _stack(self, adjoint: bool):
        if adjoint not in self._links:
            if adjoint:
                ls = [self.D]
                for mu in range(4):
                    ax = _MU_AXIS[mu]
                    ls += [torch.roll(self.Ym[mu], -1, ax),
                           torch.roll(self.Yp[mu], +1, ax)]
                st = torch.stack([_cplx(x) for x in ls]).transpose(-1, -2)
                self._links[True] = torch.conj_physical(st).contiguous()
            else:
                ls = [self.D]
                for mu in range(4):
                    ls += [self.Yp[mu], self.Ym[mu]]
                self._links[False] = torch.stack([_cplx(x) for x in ls])
        return self._links[adjoint]

    def _apply(self, links, phi):
        """sum over the 9 terms of links[k] times phi shifted: phi(x), then
        phi(x+mu), phi(x-mu) for each mu."""
        f = _cplx(phi).reshape(phi.shape[:4] + (self.ns * self.nc,))
        fs = [f]
        for mu in range(4):
            fs += [torch.roll(f, -1, _MU_AXIS[mu]),
                   torch.roll(f, +1, _MU_AXIS[mu])]
        out = torch.matmul(links, torch.stack(fs)[..., None])[..., 0].sum(0)
        return _rpair(out).reshape(phi.shape)

    def M(self, phi):
        return self._apply(self._stack(False), phi)

    def Mdag(self, phi):
        return self._apply(self._stack(True), phi)

    def MdagM(self, phi):
        return self.Mdag(self.M(phi))

    def MMdag(self, phi):
        return self.M(self.Mdag(phi))

    def operator(self, which: EigOperator):
        return {EigOperator.M: self.M, EigOperator.Mdag: self.Mdag,
                EigOperator.MdagM: self.MdagM,
                EigOperator.MMdag: self.MMdag}[which]

    def _term(self, link, f):
        n = self.ns * self.nc
        out = torch.matmul(_cplx(link), f.reshape(f.shape[:4] + (n, 1)))
        return _rpair(out[..., 0]).reshape(f.shape[:4] + (self.ns, self.nc,
                                                          2))

    def diag_term(self, phi):
        return self._term(self.D, _cplx(phi))

    def hop_term(self, mu: int, sign: int, phi):
        link = self.Yp[mu] if sign > 0 else self.Ym[mu]
        return self._term(link, torch.roll(_cplx(phi), -sign, _MU_AXIS[mu]))


def galerkin_coarse_operator_rc(fine_op: StencilOperatorRC,
                                transfer: TransferRC) -> StencilOperatorRC:
    """Exact R A P by probing: A applied term by term to the prolonged
    coarse unit vectors, each hop split by the block-edge mask into the
    coarse hop and the diagonal."""
    g = transfer.geom
    n = g.ns_coarse * transfer.V.shape[-2]
    dev = transfer.V.device
    probes = transfer.probe_fine_vectors()

    def restrict_cols(fields, mask=None):
        r = torch.stack([transfer.restrict(h, mask) for h in fields])
        r = torch.movedim(r, 0, -2)                 # [..., ns_c, n_vec, n, 2]
        return r.reshape(r.shape[:4] + (n, n, 2))

    dia = restrict_cols([fine_op.diag_term(p) for p in probes])
    Yp, Ym = [], []
    for mu in range(4):
        h_fwd = [fine_op.hop_term(mu, +1, p) for p in probes]
        h_bwd = [fine_op.hop_term(mu, -1, p) for p in probes]
        m_fwd = block_edge_mask(g, mu, +1, dev)
        m_bwd = block_edge_mask(g, mu, -1, dev)
        Yp.append(restrict_cols(h_fwd, m_fwd))
        Ym.append(restrict_cols(h_bwd, m_bwd))
        dia = (dia + restrict_cols(h_fwd, 1.0 - m_fwd)
               + restrict_cols(h_bwd, 1.0 - m_bwd))
    return StencilOperatorRC(D=dia, Yp=Yp, Ym=Ym, ns=g.ns_coarse,
                             nc=transfer.V.shape[-2])


# ---------------------------------------------------------------------------
# the hierarchy
# ---------------------------------------------------------------------------

def _cg_realpair(matvec, b, iters: int, reduce=None):
    """Fixed-iteration CG for a Hermitian positive operator on real-pair
    fields (all CG scalars are real, so plain real dots suffice).
    reduce: the sum over ranks of a dot's local parts (sharded fields)."""
    red = reduce or (lambda v: v)

    def dot(a, c):
        return red(torch.sum(a * c))

    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    rs = dot(r, r)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rs / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x


def _null_vectors_fine(fine_op, params: MGParam, mesh=None):
    """Level-0 null vectors on the kernel layout [n_vec, T, 24, Z, Y*X]:
    numpy normals drawn on the host as the JAX package draws them
    (default_rng(setup_seed).standard_normal((n_vec, T, 24, Z, Y*X)), one
    vector at a time: the same stream), each smoothed by setup_iters CG
    iterations of MdagM and normalised.  mesh: fine_op is the rank's
    sharded operator; each vector is drawn whole, as on one device, and
    the rank keeps its block; the CG dots and the norm sum over the
    ranks.  Returns the rank's blocks."""
    n = params.n_vec[0]
    if mesh is None:
        T, _, Z, YX = fine_op.field_shape
        dev, reduce = fine_op.U_k.device, None
    else:
        T, Z, YX = (mesh.global_ext["t"], mesh.global_ext["z"],
                    mesh.global_ext["y"] * mesh.X)
        dev, reduce = mesh.device, mesh.all_reduce
    red = reduce or (lambda v: v)
    rng = np.random.default_rng(params.setup_seed)
    B = torch.empty((n,) + tuple(fine_op.field_shape), dtype=torch.float32,
                    device=dev)
    for i in range(n):
        with phase_timer("mg-null-vector-draw-l0"):
            b = rng.standard_normal((T, 24, Z, YX)).astype(np.float32)
            if mesh is not None:
                b = np.ascontiguousarray(mesh.local_block(b))
            b = torch.from_numpy(b).to(dev)
        x = _cg_realpair(fine_op.MdagM, b, params.setup_iters, reduce)
        B[i] = x / torch.sqrt(red(torch.sum(x * x)))
    return B


@dataclass
class MGEnvRC:
    """level_ops[0] is the fine kernel-layout operator (WilsonDiracKernel,
    or under a mesh the rank's ShardedWilsonKernel), the rest
    StencilOperatorRC; transfers[0] is a TransferKernelMG, the rest
    TransferRC.

    mesh (a parallel.mesh.LatticeMesh): transfers[0] holds the rank's
    block of the basis (its fine blocks: each lies inside the rank's
    block) and every coarse level is global, the same on every rank (the
    level-1 stencils gathered, the levels under them built replicated, as
    the JAX package keeps them: coarse volumes are small)."""
    level_ops: List[object]
    transfers: List[object]
    params: MGParam
    mesh: object = None

    @classmethod
    def build(cls, fine_op, params: MGParam, mesh=None) -> "MGEnvRC":
        """Null-vector smoothing (K1 at the fine level; K7a under a mesh),
        transfer and Galerkin coarse operator (K5), level by level
        (MGEnvRC.build with kernel_impl=True in the JAX package; its mesh
        form shards the fine level alike).  mesh: the fine blocks must lie
        inside the rank's block (kernel_mg.check_blocks_divide, which the
        caller runs before it builds the sharded operator)."""
        from .kernel_mg import TransferKernelMG, block_hops, galerkin_kernel

        if len(params.geo_block_size) < params.n_level - 1 or \
                len(params.n_vec) < params.n_level - 1:
            raise ValueError(f"MGParam: {params.n_level} levels need "
                             f"{params.n_level - 1} block sizes and n_vec")
        level_ops, transfers = [fine_op], []
        for lev in range(params.n_level - 1):
            block = params.geo_block_size[lev]
            if lev == 0:
                with phase_timer("mg-rc-null-vectors-l0"):
                    B = _null_vectors_fine(fine_op, params, mesh)
                with phase_timer("mg-kernel-transfer-l0"):
                    tr = TransferKernelMG.build(
                        B, block,
                        fine_op.Y if mesh is None else mesh.local["y"])
                del B
                with phase_timer("mg-kernel-galerkin-l0"):
                    # the Galerkin runs on the f32 upcast of the stored
                    # links and clover blocks
                    A = None if fine_op.A144 is None else fine_op.A144.float()
                    U = (fine_op.U_k if mesh is None
                         else fine_op.block_links()).float()
                    hops = (None if mesh is None
                            else block_hops(mesh, fine_op.halo, U))
                    coarse = galerkin_kernel(U, fine_op.kappa, tr, A, hops)
                    del U, hops
                if mesh is not None:
                    with phase_timer("mg-gather-l0"):
                        coarse = _gather_stencils(coarse, mesh)
            else:
                op = level_ops[-1]
                rng = np.random.default_rng(params.setup_seed + lev)
                with phase_timer(f"mg-rc-null-vectors-l{lev}"):
                    b = torch.from_numpy(rng.standard_normal(
                        (params.n_vec[lev],) + op.field_shape).astype(
                        np.float32)).to(op.D.device)
                    B = torch.stack([_cg_realpair(op.MdagM, v,
                                                  params.setup_iters)
                                     for v in b])
                    nrm = torch.linalg.vector_norm(
                        B.reshape(B.shape[0], -1), dim=1)
                    B = B / nrm.reshape((-1,) + (1,) * (B.ndim - 1))
                with phase_timer(f"mg-rc-transfer-l{lev}"):
                    tr = TransferRC.build(B, block, spin_block=1)
                with phase_timer(f"mg-rc-galerkin-l{lev}"):
                    coarse = galerkin_coarse_operator_rc(op, tr)
            log(f"MGEnvRC: level {lev + 1} built — coarse dims "
                f"{tr.geom.coarse_dims}, n={coarse.ns * coarse.nc}")
            transfers.append(tr)
            level_ops.append(coarse)
        return cls(level_ops=level_ops, transfers=transfers, params=params,
                   mesh=mesh)

    @property
    def coarsest_op(self):
        return self.level_ops[-1]

    def prolongate(self, phi):
        """A coarsest-level field to the fine level (under a mesh, the
        rank's block of it)."""
        for i in reversed(range(len(self.transfers))):
            if i == 0 and self.mesh is not None:
                phi = self.mesh.local_coarse_block(phi)
            phi = self.transfers[i].prolong(phi)
        return phi

    def prolongate_batch(self, phis):
        """Recursive prolongation of an evec batch, one vector at a time."""
        return torch.stack([self.prolongate(phi) for phi in phis])

    def save(self, path: str) -> None:
        """Transfer bases and Galerkin stencils in the JAX package's npz
        format (the kernel-layout basis in the agg layout): a load skips
        the setup CG and the probing.  Under a mesh every rank gathers the
        fine-level basis and the primary writes the global file one device
        would write."""
        mesh = self.mesh
        data = {"n_level": np.asarray(self.params.n_level)}
        for i, tr in enumerate(self.transfers):
            g = tr.geom
            if i == 0:
                V = tr.to_agg_V()
                if mesh is not None:
                    V = mesh.gather_coarse(V)
                    g = replace(g, fine_dims=mesh.dims)
            else:
                V = tr.V
            data[f"V{i}"] = V.cpu().numpy()
            data[f"geom{i}"] = np.asarray(
                list(g.fine_dims) + list(g.block)
                + [g.ns_fine, g.nc_fine, g.spin_block], dtype=np.int64)
        if mesh is not None and not mesh.is_primary:
            return
        for i, op in enumerate(self.level_ops[1:]):
            data[f"D{i}"] = op.D.cpu().numpy()
            for mu in range(4):
                data[f"Yp{i}_{mu}"] = op.Yp[mu].cpu().numpy()
                data[f"Ym{i}_{mu}"] = op.Ym[mu].cpu().numpy()
            data[f"nsnc{i}"] = np.asarray([op.ns, op.nc], dtype=np.int64)
        np.savez(path, **data)
        log(f"MGEnvRC: hierarchy saved to {path} "
            f"({len(self.transfers)} transfer level(s))")

    @classmethod
    def load(cls, path: str, fine_op, params: MGParam, device="cuda",
             mesh=None) -> "MGEnvRC":
        """Rebuild the hierarchy from a save() checkpoint of either package
        (no setup CG, no probing).  fine_op must be the operator the
        hierarchy was built for.  mesh: the global file of any mesh (or of
        one device); the rank keeps its block of the fine-level basis."""
        from .kernel_mg import TransferKernelMG, check_blocks_divide

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(device)

        with np.load(path) as z:
            n_coarse = int(z["n_level"]) - 1
            transfers, level_ops = [], [fine_op]
            for i in range(n_coarse):
                gi = z[f"geom{i}"]
                g = BlockGeometry(fine_dims=tuple(int(d) for d in gi[:4]),
                                  block=tuple(int(b) for b in gi[4:8]),
                                  ns_fine=int(gi[8]), nc_fine=int(gi[9]),
                                  spin_block=int(gi[10]))
                if i == 0:
                    V0 = z["V0"]
                    if mesh is not None:
                        if g.fine_dims != mesh.dims:
                            raise ValueError(
                                f"{path}: a hierarchy of the lattice "
                                f"{g.fine_dims}, not {mesh.dims}")
                        check_blocks_divide(mesh, g.block)
                        V0 = mesh.local_coarse_block(V0)
                        g = replace(g, fine_dims=mesh.local_dims)
                    transfers.append(TransferKernelMG.from_agg_V(
                        t(V0), g, g.fine_dims[1]))
                else:
                    transfers.append(TransferRC(geom=g, V=t(z[f"V{i}"])))
                ns, nc = (int(v) for v in z[f"nsnc{i}"])
                level_ops.append(StencilOperatorRC(
                    D=t(z[f"D{i}"]),
                    Yp=[t(z[f"Yp{i}_{mu}"]) for mu in range(4)],
                    Ym=[t(z[f"Ym{i}_{mu}"]) for mu in range(4)],
                    ns=ns, nc=nc))
        log(f"MGEnvRC: hierarchy loaded from {path} "
            f"({n_coarse} coarse level(s))")
        return cls(level_ops=level_ops, transfers=transfers, params=params,
                   mesh=mesh)


def _gather_stencils(op: StencilOperatorRC, mesh) -> StencilOperatorRC:
    """The global coarse operator on every rank from each rank's block of
    its stencils (one all-gather a tensor)."""
    return StencilOperatorRC(D=mesh.gather_coarse(op.D),
                             Yp=[mesh.gather_coarse(y) for y in op.Yp],
                             Ym=[mesh.gather_coarse(y) for y in op.Ym],
                             ns=op.ns, nc=op.nc)
