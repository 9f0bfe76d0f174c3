"""The sharded Wilson(-clover) operators of one rank (port of
mugiq_tpu.parallel.shard_op: ShardedWilsonKernel, ShardedSchurKernelPacked).

Each rank holds its block of the kernel-layout fields; M and M^dag are one
halo exchange and one K7 stencil pass (hop, clover diagonal and kappa
combine in the kernel, as K1); the bare hop _hop / _hop_dag one exchange
and one K4-halo pass; the packed Schur operator is two, as K6's.  Every
application takes f32 or bf16 spinors and returns the input's dtype (the
stored vectors of a bf16 Krylov basis run bf16 through the exchange and
the kernels, as on one device and in the JAX package).
The Krylov algebra runs on the local blocks and reduces its inner
products over the ranks (lanczos.py's ``reduce``), so nothing else of the
eigensolver changes.  Reference counterpart: QUDA's multi-GPU Dirac
operator consumed at lib/eigsolve_mugiq.cpp:169-207, with the domain
decomposition restricted to (t, z[, y]) as in the JAX package.
"""

from typing import Callable, Optional

import torch

from ..kernels.parity import parity_hop_halo
from ..kernels.wilson import wilson_m_halo
from ..params import EigOperator
from .halo import HaloExchange
from .shard_dslash import (ExtBuffers, apply_halo, extend_links,
                           make_sharded_dslash)


class _Sharded:
    """What both operators share: the mesh, its halo exchange, the M/M^dag
    compositions.  A batch [b, *field] (block Lanczos) is applied one
    vector at a time, one exchange each."""

    def _batched(self, psi, dagger: bool):
        if psi.ndim == len(self._field_shape) + 1:
            return torch.stack([self._apply(p, dagger) for p in psi])
        return self._apply(psi, dagger)

    def M(self, psi):
        return self._batched(psi, False)

    def Mdag(self, psi):
        return self._batched(psi, True)

    def MdagM(self, psi):
        return self.Mdag(self.M(psi))

    def MMdag(self, psi):
        return self.M(self.Mdag(psi))

    def operator(self, which: EigOperator) -> Callable:
        return {EigOperator.M: self.M, EigOperator.Mdag: self.Mdag,
                EigOperator.MdagM: self.MdagM,
                EigOperator.MMdag: self.MMdag}[which]

    @property
    def field_shape(self):
        """The local block's field shape."""
        return self._field_shape

    def place(self, field):
        """This rank's block of a global field, on the rank's device."""
        return self.mesh.local_block(field).to(self.mesh.device).contiguous()


class ShardedWilsonKernel(_Sharded):
    """M = A - kappa D of one rank's block on a (t, z[, y]) mesh.

    U_loc [Tl, 4, 18, Zl, Yl*X] the block's phased links (f32 or bf16),
    A144_loc [Tl, 144, Zl, Yl*X] its clover blocks or None.  The links'
    z/y halos and the shifted t-links are exchanged here, once.
    overlap: the interior/boundary split of shard_dslash.apply_halo.
    _hop / _hop_dag: the bare hop D / D^dag of the block on the same links,
    exchange and extended buffer (shard_dslash.make_sharded_dslash), as
    the JAX class builds them."""

    def __init__(self, mesh, U_loc: torch.Tensor, kappa: float,
                 A144_loc: Optional[torch.Tensor] = None,
                 overlap: bool = True):
        self.mesh = mesh
        self.halo = HaloExchange(mesh)
        self.kappa = float(kappa)
        self.overlap = overlap
        dev = mesh.device
        U_loc = U_loc.to(dev)
        Tl, _, _, Zl, YXl = U_loc.shape
        self.Yl = mesh.local["y"]
        self.X = YXl // self.Yl
        self.U_ext, self.Ut_shift = extend_links(self.halo, U_loc, mesh,
                                                 self.X)
        self.A144 = (None if A144_loc is None
                     else A144_loc.to(dev, U_loc.dtype).contiguous())
        self._ext = ExtBuffers(mesh, self.X, dev)
        self._field_shape = (Tl, 24, Zl, YXl)
        hops = [make_sharded_dslash(mesh, self.halo, self._ext, dagger=d,
                                    overlap=overlap)
                for d in (False, True)]
        self._hop = lambda psi: hops[0](psi, self.U_ext, self.Ut_shift)
        self._hop_dag = lambda psi: hops[1](psi, self.U_ext, self.Ut_shift)

    def _apply(self, psi, dagger: bool):
        out = torch.empty(self._field_shape, dtype=psi.dtype,
                          device=psi.device)
        m = self.mesh
        ext = self._ext(psi.dtype)

        def launch(rows):
            wilson_m_halo(ext, self.U_ext, self.Ut_shift, self.A144,
                          self.kappa, dagger, self.Yl, m.z_ext, m.y_ext,
                          rows=rows, out=out)

        apply_halo(self.halo, ext, psi, launch, m, self.X, self.overlap)
        return out

    def block_links(self) -> torch.Tensor:
        """The block's links [Tl, 4, 18, Zl, Yl*X] in their stored dtype:
        the interior of U_ext (a copy where z or y is extended)."""
        m = self.mesh
        Tl, _, _, Zp, YXp = self.U_ext.shape
        Zl = m.local["z"]
        v = self.U_ext.view(Tl, 4, 18, Zp, YXp // self.X, self.X)
        if m.z_ext:
            v = v[:, :, :, 1:Zl + 1]
        if m.y_ext:
            v = v[:, :, :, :, 1:self.Yl + 1]
        return v.reshape(Tl, 4, 18, Zl, self.Yl * self.X)

    @classmethod
    def from_kernel_op(cls, mesh, op, overlap: bool = True):
        """The rank's block of a single-device WilsonDiracKernel (its links
        and clover on any device, the host included)."""
        A = None if op.A144 is None else mesh.local_block(op.A144)
        return cls(mesh, mesh.local_block(op.U_k), op.kappa, A144_loc=A,
                   overlap=overlap)


def check_even_block(mesh) -> None:
    """The packed layout on a block needs even local extents: then every
    block starts at an even site and local parity is global parity."""
    X, Yl, Zl, Tl = mesh.local_dims
    if Tl % 2 or Zl % 2 or Yl % 2 or X % 2:
        raise ValueError(f"the even-odd preconditioned operator needs even "
                         f"local extents on every rank: the mesh "
                         f"{mesh.mesh_shape} gives blocks X={X} Y={Yl} "
                         f"Z={Zl} T={Tl}")


class ShardedSchurKernelPacked(_Sharded):
    """The packed even-even Schur operator of one rank's block (Wilson:
    1 - kappa^2 D_eo D_oe; clover: A_ee - kappa^2 D_eo A_oo^-1 D_oe), two
    K7b passes per application.  U_e, U_o [Tl, 4, 18, Zl, Yl*X/2] the
    block's packed links based at even / odd sites; A_e, Ainv_o
    [Tl, 144, Zl, Yl*X/2] its packed clover blocks or None.  The JAX
    dispatch (shard_op.py:337-371) maps to the halo form: t only on a t
    mesh, (t, z[, y]) on 2D and 3D meshes."""

    def __init__(self, mesh, U_e: torch.Tensor, U_o: torch.Tensor,
                 kappa: float, A_e: Optional[torch.Tensor] = None,
                 Ainv_o: Optional[torch.Tensor] = None,
                 overlap: bool = True):
        check_even_block(mesh)
        self.mesh = mesh
        self.halo = HaloExchange(mesh)
        self.kappa = float(kappa)
        self.overlap = overlap
        dev = mesh.device
        Tl, _, _, Zl, YXh = U_e.shape
        self.Yl = mesh.local["y"]
        self.Xh = YXh // self.Yl
        self.U_e, self.Ut_e = extend_links(self.halo, U_e.to(dev), mesh,
                                           self.Xh)
        self.U_o, self.Ut_o = extend_links(self.halo, U_o.to(dev), mesh,
                                           self.Xh)
        store = self.U_e.dtype
        self.A_e = None if A_e is None else A_e.to(dev, store).contiguous()
        self.Ainv_o = (None if Ainv_o is None
                       else Ainv_o.to(dev, store).contiguous())
        self._ext = ExtBuffers(mesh, self.Xh, dev)
        self._field_shape = (Tl, 24, Zl, YXh)

    def _apply(self, pe, dagger: bool):
        # clover: M = A_ee pe - k^2 D_eo A_oo^-1 D_oe pe; M^dag has the same
        # two passes with the dagger hop (the chiral blocks are Hermitian);
        # d_o and the output in pe's dtype, as K6 and the JAX out_shape
        m = self.mesh
        d_o = torch.empty(self._field_shape, dtype=pe.dtype,
                          device=pe.device)
        out = torch.empty_like(d_o)
        ext = self._ext(pe.dtype)

        def pass1(rows):
            parity_hop_halo(ext, self.U_o, self.U_e, self.Ut_e, self.Yl, 1,
                            dagger, m.z_ext, m.y_ext, A_post=self.Ainv_o,
                            rows=rows, out=d_o)

        def pass2(rows):
            parity_hop_halo(ext, self.U_e, self.U_o, self.Ut_o, self.Yl, 0,
                            dagger, m.z_ext, m.y_ext, kappa2=self.kappa ** 2,
                            psi_out=pe, A_comb=self.A_e, rows=rows, out=out)

        apply_halo(self.halo, ext, pe, pass1, m, self.Xh, self.overlap)
        apply_halo(self.halo, ext, d_o, pass2, m, self.Xh, self.overlap)
        return out

    @classmethod
    def from_packed_op(cls, mesh, op, overlap: bool = True):
        """The rank's block of a single-device SchurDiracKernelPacked (its
        packed fields on any device): the global packing's offsets hold on
        every block, whose origin is even."""
        def blk(a):
            return None if a is None else mesh.local_block(a)

        return cls(mesh, blk(op.U_e), blk(op.U_o), op.kappa, A_e=blk(op.A_e),
                   Ainv_o=blk(op.Ainv_o), overlap=overlap)
