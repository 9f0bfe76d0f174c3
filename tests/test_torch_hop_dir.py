"""K5 (one directed hop): the port's plain twin against the JAX package's
TPU kernel dslash_hop_pallas_gl_dir in interpret mode, for all 8 (mu,
sign) and both daggers, at distinct even extents (X, Y, Z, T) = (4, 8, 4,
6) so that no two axes can be confused.  Both run f32 arithmetic on the
same links and differ by summation order only: 1e-6 of max |out|.  Each
case compiles the JAX kernel anew (~2 s of CPU).

Also on the CPU: the eight directed hops sum to the Wilson hop of K1's
twin, and the wrapper rejects what the kernel does not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu_torch.kernels.hop_dir import (dslash_hop_dir,
                                             dslash_hop_dir_plain)
from mugiq_tpu_torch.kernels.wilson import wilson_m_plain

from torch_ref import rand

torch.set_num_threads(2)

T, Z, Y, X = 6, 4, 8, 4
BY = 4          # the grouped-lane tiling galerkin_wilson_kernel picks here


@pytest.mark.parametrize("dagger", [False, True])
@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("mu", [0, 1, 2, 3])
def test_twin_matches_pallas_gl_dir(mu, sign, dagger):
    import mugiq_tpu.pallas.dslash_kernel as dk

    psi = rand((T, 24, Z, Y * X), seed=1)
    U = rand((T, 4, 18, Z, Y * X), seed=2, scale=0.5)
    ref = np.asarray(dk.dslash_hop_pallas_gl_dir(
        jnp.asarray(psi), jnp.asarray(U), jnp.asarray(U[:, 3]), Y=Y, mu=mu,
        sign=sign, by=BY, dagger=dagger))
    got = dslash_hop_dir(torch.from_numpy(psi), torch.from_numpy(U), mu,
                         sign, dagger, Y).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("dagger", [False, True])
def test_directed_hops_sum_to_wilson_operator(dagger):
    """psi - kappa sum_{mu, sign} K5(psi) = M psi (K1's twin, Wilson)."""
    psi = torch.from_numpy(rand((T, 24, Z, Y * X), seed=3))
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), seed=4, scale=0.5))
    kappa = 0.13
    hop = sum(dslash_hop_dir_plain(psi, U, mu, sg, dagger, Y)
              for mu in range(4) for sg in (1, -1))
    ref = wilson_m_plain(psi, U, None, kappa, dagger, Y)
    got = psi - kappa * hop
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_wrapper_rejects_bad_input():
    psi = torch.zeros((2, 24, 2, 4))
    U = torch.zeros((2, 4, 18, 2, 4))
    for mu, sign in ((4, 1), (0, 0), (-1, -1)):
        with pytest.raises(ValueError, match="direction"):
            dslash_hop_dir(psi, U, mu, sign, False, 2)
    m = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        dslash_hop_dir(psi.to(m), U.to(m), 0, 1, False, 2)
