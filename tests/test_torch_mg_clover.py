"""The port's Galerkin coarse operator of the clover operator against the
JAX package's agg formulation (MGEnvRC.build on build_rc_dirac: R A P with
A = the clover term, probed term by term).

The JAX kernel formulation (galerkin_wilson_kernel) is Wilson-only: its
diagonal restricts the bare probe.  The port's kernel formulation restricts
A probe, so at every volume it equals the agg formulation, which the JAX
package uses at small volumes.  4^3x8, csw 1, kappa 0.12, block 2^4, n_vec
4, 6 setup iterations; the same numpy draws in both packages.  The JAX
build runs its null-vector smoothing through the interpret-mode Pallas K1
(~35 s of CPU).  Tolerances as in test_torch_mg.py: basis 2e-6, stencils
2e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import torch

from mugiq_tpu import fields
from mugiq_tpu.lattice import LatticeGeometry

from mugiq_tpu_torch.mg.kernel_mg import galerkin_kernel
from mugiq_tpu_torch.mg.rc_mg import MGEnvRC
from mugiq_tpu_torch.params import (DslashType, GaugeParam, InvertParam,
                                    MGParam)
from mugiq_tpu_torch.production import build_kernel_dirac

torch.set_num_threads(2)

DIMS = (4, 4, 4, 8)
MG = dict(n_level=2, geo_block_size=[(2, 2, 2, 2)], n_vec=[4],
          setup_iters=6)


def test_clover_galerkin_matches_jax_agg():
    from mugiq_tpu import params as jp
    from mugiq_tpu.mg.rc_mg import MGEnvRC as JaxEnv
    from mugiq_tpu.production import build_rc_dirac
    from mugiq_tpu.production import build_kernel_dirac as jax_kernel_dirac

    U = np.asarray(fields.weak_gauge(LatticeGeometry(DIMS), eps=0.3, seed=4,
                                     dtype=jnp.complex64))
    jgp = jp.GaugeParam(dims=DIMS)
    jip = jp.InvertParam(kappa=0.12, csw=1.0,
                         dslash_type=jp.DslashType.CLOVER_WILSON)
    ref = JaxEnv.build(build_rc_dirac(U, jgp, jip), jp.MGParam(**MG),
                       fast_fine_op=jax_kernel_dirac(U, jgp, jip))

    ip = InvertParam(kappa=0.12, csw=1.0,
                     dslash_type=DslashType.CLOVER_WILSON)
    op = build_kernel_dirac(U, GaugeParam(dims=DIMS), ip, device="cpu")
    env = MGEnvRC.build(op, MGParam(**MG))

    np.testing.assert_allclose(env.transfers[0].to_agg_V().numpy(),
                               np.asarray(ref.transfers[0].V), atol=2e-6)
    got, want = env.coarsest_op, ref.coarsest_op
    np.testing.assert_allclose(got.D.numpy(), np.asarray(want.D), atol=2e-5)
    for mu in range(4):
        np.testing.assert_allclose(got.Yp[mu].numpy(),
                                   np.asarray(want.Yp[mu]), atol=2e-5,
                                   err_msg=f"Yp{mu}")
        np.testing.assert_allclose(got.Ym[mu].numpy(),
                                   np.asarray(want.Ym[mu]), atol=2e-5,
                                   err_msg=f"Ym{mu}")
    # restricting the bare probe (the JAX kernel formulation's diagonal)
    # on the same basis misses the clover term
    bare = galerkin_kernel(op.U_k, op.kappa, env.transfers[0], None)
    np.testing.assert_array_equal(bare.Yp[0].numpy(), got.Yp[0].numpy())
    assert np.abs(bare.D.numpy() - np.asarray(want.D)).max() > 1e-2
