"""Null-vector (near-kernel) setup of the multigrid hierarchy on complex
fields (port of mugiq_tpu.mg.setup): inverse iteration, a fixed number of
CG steps on the normal equations from random starts, all n_vec vectors
in one batched CG (jax.vmap in the JAX function).

The starts are drawn from numpy's default_rng(seed) (real parts, then
imaginary parts), as the port's production setup draws its own; the JAX
package draws them from jax.random (ROADMAP, deliberate deviations).
"""

import torch

from ..eig.eigsolve import random_field
from ..eig.lanczos import vnorm
from ..solvers import cg


def setup_null_vectors(op_mdagm, field_shape, dtype, n_vec: int,
                       iters: int = 50, seed: int = 7,
                       device="cuda") -> torch.Tensor:
    """[n_vec, *field_shape] approximate near-kernel vectors of M, each
    x ~ (M^dag M)^-1 r after `iters` CG steps, normalised."""
    b = random_field((n_vec,) + tuple(field_shape), seed, dtype, device)
    x = cg(op_mdagm, b, tol=0.0, maxiter=iters, batched=True).x
    nrm = vnorm(x.reshape(n_vec, -1), dim=1)
    return x / nrm.reshape((n_vec,) + (1,) * len(field_shape))
