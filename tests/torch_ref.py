"""Shared inputs for the mugiq_tpu_torch tests: numpy-seeded fields that
both packages receive, and the JAX package's operator state as numpy."""

import numpy as np
import pytest
import torch


def cuda_device():
    """The CUDA device, or skip: kernel tests run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode); "
                    "run on the GPU machine")
    return torch.device("cuda")


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def jax_operator(U, dims, kappa, clover, csw=1.1, precision="f32"):
    """The JAX package's production operator for complex gauge U."""
    from mugiq_tpu.params import DslashType, GaugeParam, InvertParam
    from mugiq_tpu.production import build_kernel_dirac

    gp = GaugeParam(dims=dims)
    ip = InvertParam(kappa=kappa, csw=csw if clover else 0.0,
                     dslash_type=(DslashType.CLOVER_WILSON if clover
                                  else DslashType.WILSON))
    return build_kernel_dirac(U, gp, ip, precision=precision), gp, ip


def port_operator(jop, precision="f32"):
    """The port's operator carried over from the JAX operator's state."""
    from mugiq_tpu_torch.layout import from_jax_numpy

    A = None if jop.A_blocks is None else np.asarray(jop.A_blocks, np.float32)
    return from_jax_numpy(np.asarray(jop.U_k, np.float32), A, jop.kappa,
                          jop.Y, precision=precision, device="cpu")


def port_packed_operator(jop):
    """The port's packed even-odd operator carried over from the state of a
    JAX SchurDiracKernelPacked (its links and blocks, f32 or bf16)."""
    from mugiq_tpu_torch.layout import from_jax_packed_numpy

    def f32(a):
        return None if a is None else np.asarray(a, np.float32)

    return from_jax_packed_numpy(f32(jop.U_k), f32(jop.A_blocks),
                                 f32(jop.Ainv_blocks), jop.kappa, jop.Y,
                                 precision=jop.precision, device="cpu")
