"""Multigrid for the MG-deflated loop (port of mugiq_tpu.mg's production
pieces): the fine-level transfer and Galerkin build on the kernel layout
(kernel_mg), the coarse stencil operator, the coarser-level transfers and
the hierarchy (rc_mg)."""

from .transfer import BlockGeometry
from .kernel_mg import TransferKernelMG, galerkin_kernel
from .rc_mg import MGEnvRC, StencilOperatorRC, TransferRC
