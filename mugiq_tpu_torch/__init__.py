"""mugiq_tpu_torch — the PyTorch/CUDA port of mugiq_tpu for NVIDIA Hopper.

The single-device production loop (eigensolve -> loop contraction ->
momentum projection), its MG-deflated form (the Galerkin coarse operator
of a multigrid hierarchy eigensolved and its eigenvectors prolongated,
``mg/``) and the eigensolve entry point, with the full or the packed
even-odd preconditioned operator, thick-restart or block Lanczos with an
f32 or bf16 Krylov basis, or the Krylov-Schur Arnoldi of M / M^dag, on a
CUDA device, and the loop and
eigensolve sharded over a (t, z[, y]) grid of ranks, one
torch.distributed process each (``parallel/``); the stencil kernels
are written by hand in CUDA C++ (``kernels/csrc``) and built with
``nvcc`` at first use.  Every kernel wrapper has a plain PyTorch twin that
runs for CPU tensors, so the whole slice also runs (slowly) on the CPU.

The JAX package ``mugiq_tpu`` is the reference; this package never imports
JAX.  Importing it builds nothing and touches no device.

Importing the package pins float32 matrix products to full precision
(TF32 off): the Krylov algebra of the eigensolver floors at ~3e-3
residuals with TF32, as the JAX eigensolve did with bf16 MXU passes.
"""

from .utils import pin_full_f32

pin_full_f32()

__version__ = "0.1.0"
