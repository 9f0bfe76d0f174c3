"""Packed even-odd (half-volume) fields and the preconditioned operator
(port of mugiq_tpu.pallas.schur_kernel: pack_parity, unpack_parities,
pack_parity_gauge, SchurDiracKernelPacked).

Packed layout (x packed 2:1):
    psi_p  [T, 24, Z, Y*Xh]      Xh = X/2; site (t, z, y, xh) of parity p
                                 is x = 2*xh + (t+z+y+p) % 2 (x fastest)
    U_p    [T, 4, 18, Z, Y*Xh]   links based at parity-p sites

A periodic hop keeps the parity alternating only when every extent is
even, so the operator requires even T, Z, Y and X.

The TPU pipeline inputs of the JAX operator (the row-offset masks, the
t-1 link views), its grouped-lane tiling and its project-then-shift body
have no counterpart: K6 computes offsets and neighbours from its indices.
"""

from typing import Callable, Optional

import torch

from .kernels.parity import parity_hop
from .params import EigOperator


def _offsets(T: int, Z: int, Y: int, parity: int, device) -> torch.Tensor:
    """Row x-offset (t+z+y+parity) % 2 as a [T, 1, Z, Y, 1] tensor."""
    t = torch.arange(T, device=device).reshape(T, 1, 1)
    z = torch.arange(Z, device=device).reshape(1, Z, 1)
    y = torch.arange(Y, device=device).reshape(1, 1, Y)
    return ((t + z + y + parity) % 2).reshape(T, 1, Z, Y, 1)


def pack_parity(field: torch.Tensor, Y: int, parity: int) -> torch.Tensor:
    """Full kernel-layout field [T, C, Z, Y*X] -> packed [T, C, Z, Y*Xh]
    holding the parity-`parity` sites (x = 2*xh + (t+z+y+parity) % 2)."""
    T, C, Z, YX = field.shape
    X = YX // Y
    if X % 2:
        raise ValueError(f"x extent must be even to pack parities: {X}")
    f = field.reshape(T, C, Z, Y, X // 2, 2)
    sel = _offsets(T, Z, Y, parity, field.device) == 0
    return torch.where(sel, f[..., 0], f[..., 1]).reshape(T, C, Z, YX // 2)


def unpack_parities(even: torch.Tensor, odd: torch.Tensor,
                    Y: int) -> torch.Tensor:
    """Packed (even, odd) [T, C, Z, Y*Xh] -> full [T, C, Z, Y*X]."""
    T, C, Z, YXh = even.shape
    e = even.reshape(T, C, Z, Y, YXh // Y)
    o = odd.reshape(T, C, Z, Y, YXh // Y)
    sel = _offsets(T, Z, Y, 0, even.device) == 0
    # even sites sit in slot off, odd ones in slot 1 - off
    full = torch.stack([torch.where(sel, e, o), torch.where(sel, o, e)], -1)
    return full.reshape(T, C, Z, 2 * YXh)


def pack_parity_gauge(U_k: torch.Tensor, Y: int, parity: int) -> torch.Tensor:
    """[T, 4, 18, Z, Y*X] -> [T, 4, 18, Z, Y*Xh] links based at parity-p
    sites (the spinor packing rule, per direction)."""
    T, MU, C, Z, YX = U_k.shape
    return pack_parity(U_k.reshape(T, MU * C, Z, YX), Y, parity).reshape(
        T, MU, C, Z, YX // 2)


class SchurDiracKernelPacked:
    """Even-even preconditioned Wilson(-clover) on packed even-parity
    fields [T, 24, Z, Y*Xh]:

        Wilson:  M_pc = 1 - kappa^2 D_eo D_oe
        clover:  M_pc = A_ee - kappa^2 D_eo A_oo^-1 D_oe   (asymmetric)

    Each application is two K6 passes: pass 1 hops even -> odd and fuses
    A_oo^-1, pass 2 hops odd -> even and fuses the combine.  M^dag runs the
    same passes with the dagger hop (g5-hermitian; the chiral blocks are
    Hermitian).  Reference semantics: QUDA_MATPC_EVEN_EVEN pc_solve
    (eigsolve_mugiq.cpp:169-181).

    U_k [T, 4, 18, Z, Y*X]: full phased links; A_blocks [T, 2, 6, 6, 2, Z,
    Y*X] (clover_np.clover_chiral_blocks_np) or None; Ainv_blocks its
    site-wise inverse, computed on the host when not given.
    precision="bf16" stores links and clover blocks in bfloat16 (cast after
    the inverse); arithmetic stays f32.  Only the packed links and blocks
    are kept.  M, M^dag and their products take a packed field or a batch
    [b, T, 24, Z, Y*Xh] (one launch per pass), f32 or bf16: with bf16
    pass 1 rounds d_oe to bf16 and the result is bf16, as the JAX
    operator's (its pass 1 writes psi_in's dtype).
    """

    def __init__(self, U_k: torch.Tensor, kappa: float, Y: int,
                 A_blocks: Optional[torch.Tensor] = None,
                 Ainv_blocks: Optional[torch.Tensor] = None,
                 precision: str = "f32"):
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision must be f32|bf16: {precision}")
        store = torch.bfloat16 if precision == "bf16" else torch.float32
        T, _, _, Z, YX = U_k.shape
        Y = int(Y)
        X = YX // Y
        if T % 2 or Z % 2 or Y % 2 or X % 2 or X * Y != YX:
            raise ValueError(f"the even-odd checkerboard needs even extents:"
                             f" T={T} Z={Z} Y={Y} X={X}")
        self.kappa = float(kappa)
        self.Y = Y
        self.precision = precision
        self._field_shape = (T, 24, Z, YX // 2)
        U = U_k.to(store)
        self.U_e = pack_parity_gauge(U, Y, 0).contiguous()
        self.U_o = pack_parity_gauge(U, Y, 1).contiguous()
        del U
        self.A_e = self.Ainv_o = None
        if A_blocks is not None:
            if Ainv_blocks is None:
                from .clover_np import invert_chiral_blocks_np
                Ainv_blocks = torch.from_numpy(invert_chiral_blocks_np(
                    A_blocks.cpu().numpy())).to(A_blocks.device)
            A144 = A_blocks.reshape(T, 144, Z, YX).to(store)
            Ainv144 = Ainv_blocks.reshape(T, 144, Z, YX).to(store)
            self.A_e = pack_parity(A144, Y, 0).contiguous()
            self.Ainv_o = pack_parity(Ainv144, Y, 1).contiguous()

    def pack_even(self, psi_k):
        return pack_parity(psi_k, self.Y, 0)

    def unpack_even(self, pe):
        return unpack_parities(pe, torch.zeros_like(pe), self.Y)

    def _apply(self, pe, dagger: bool):
        d_oe = parity_hop(pe, self.U_o, self.U_e, self.Y, 1, dagger,
                          A_post=self.Ainv_o)
        return parity_hop(d_oe, self.U_e, self.U_o, self.Y, 0, dagger,
                          kappa2=self.kappa ** 2, psi_out=pe,
                          A_comb=self.A_e)

    def M(self, pe):
        return self._apply(pe, False)

    def Mdag(self, pe):
        return self._apply(pe, True)

    def MdagM(self, pe):
        return self.Mdag(self.M(pe))

    def MMdag(self, pe):
        return self.M(self.Mdag(pe))

    def operator(self, which: EigOperator) -> Callable:
        return {EigOperator.M: self.M, EigOperator.Mdag: self.Mdag,
                EigOperator.MdagM: self.MdagM,
                EigOperator.MMdag: self.MMdag}[which]

    @property
    def field_shape(self):
        return self._field_shape
