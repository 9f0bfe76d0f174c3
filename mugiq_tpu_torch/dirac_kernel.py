"""Wilson(-clover) operators on the kernel layout (port of
mugiq_tpu.pallas.dirac_kernel: WilsonDiracKernel, the masked even-even
preconditioned SchurDiracKernel and its parity_masks_kernel).

Fields live in the [T, 24, Z, Y*X] kernel layout, so the eigensolver's
Krylov algebra and the K1 / K4 kernels share one layout.  The TPU variant
selection, autotuning and operator_with_args have no counterpart: there is
one Hopper kernel per function and PyTorch runs eagerly.
"""

from typing import Callable, Optional

import torch

from .kernels.wilson import dslash_hop, wilson_m
from .params import EigOperator


class WilsonDiracKernel:
    """M = A - kappa D on the kernel layout.

    U_k [T, 4, 18, Z, Y*X]: phased links; A_blocks [T, 2, 6, 6, 2, Z, Y*X]
    (clover_np.clover_chiral_blocks_np) or None.  precision="bf16" stores
    links and clover in bfloat16; all arithmetic stays f32.  M, M^dag and
    their products take a field [T, 24, Z, Y*X] or a batch [b, T, 24, Z,
    Y*X] (one K1 launch per application), f32 or bf16 (the stored
    vectors of a bf16 Krylov basis), and return psi's dtype.
    """

    def __init__(self, U_k: torch.Tensor, kappa: float, Y: int,
                 A_blocks: Optional[torch.Tensor] = None,
                 precision: str = "f32"):
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision must be f32|bf16: {precision}")
        store = torch.bfloat16 if precision == "bf16" else torch.float32
        self.U_k = U_k.to(store).contiguous()
        self.kappa = float(kappa)
        self.Y = int(Y)
        self.precision = precision
        T, _, _, Z, YX = self.U_k.shape
        self.A144 = (None if A_blocks is None
                     else A_blocks.to(store).reshape(T, 144, Z, YX)
                     .contiguous())

    def M(self, psi):
        return wilson_m(psi, self.U_k, self.A144, self.kappa, False, self.Y)

    def Mdag(self, psi):
        """M^dag through the kernel's swapped projectors (g5 folded in; the
        clover diagonal is Hermitian)."""
        return wilson_m(psi, self.U_k, self.A144, self.kappa, True, self.Y)

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
        T, _, _, Z, YX = self.U_k.shape
        return (T, 24, Z, YX)


def parity_masks_kernel(T: int, Z: int, Y: int, X: int,
                        dtype=torch.float32, device="cuda"):
    """(even, odd) 0/1 masks [T, 1, Z, Y*X] of kernel-layout fields: the
    parity of t + z + y + x."""
    t, z, y, x = torch.meshgrid(*(torch.arange(n, device=device)
                                  for n in (T, Z, Y, X)), indexing="ij")
    par = ((t + z + y + x) % 2).reshape(T, 1, Z, Y * X).to(dtype)
    return 1.0 - par, par


class SchurDiracKernel:
    """The masked even-even preconditioned Wilson operator on full-volume
    kernel-layout fields, M_pc = 1 - kappa^2 P_e D P_o D (the JAX
    package's SchurDiracKernel): each application is two K4 hops and two
    mask multiplies, at any extents (the packed
    schur_kernel.SchurDiracKernelPacked, two K6 passes on half-volume
    fields, needs even ones).

    U_k [T, 4, 18, Z, Y*X] phased links (f32 or bf16); the masks live on
    U_k's device."""

    def __init__(self, U_k: torch.Tensor, kappa: float, Y: int):
        self.U_k = U_k.contiguous()
        self.kappa = float(kappa)
        self.Y = int(Y)
        T, _, _, Z, YX = self.U_k.shape
        self.even, self.odd = parity_masks_kernel(T, Z, self.Y, YX // self.Y,
                                                  device=self.U_k.device)

    def project_even(self, psi):
        return self.even * psi

    def _apply(self, psi, dagger: bool):
        pe = self.even * psi
        d_oe = self.odd * dslash_hop(pe, self.U_k, dagger, self.Y)
        hop_back = self.even * dslash_hop(d_oe, self.U_k, dagger, self.Y)
        return pe - self.kappa ** 2 * hop_back

    def M(self, psi):
        return self._apply(psi, False)

    def Mdag(self, psi):
        return self._apply(psi, True)

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
        T, _, _, Z, YX = self.U_k.shape
        return (T, 24, Z, YX)

    @property
    def dtype(self):
        """The links' dtype, as the JAX class reports it."""
        return self.U_k.dtype
