"""The MG-deflated loop of the port against the JAX package, on the CPU
(the kernels' twins).

One JAX run, shared by the module: the JAX MG production loop
(_compute_loop_production_mg, mg_setup="kernel") at 4^3x8, Wilson kappa
0.12, three levels (block 2^4, then (1,1,1,2); n_vec 4 on both; 6 setup
iterations).  It builds level 0 with the kernel formulation (interpret-mode
Pallas K1 and K5) and level 1 with the agg one, saves the hierarchy
(MGEnvRC.save), eigensolves the coarsest MdagM and measures the loop: ~50 s
of CPU.  The port builds the same hierarchy from the same numpy draws.

Tolerances: the transfer basis 2e-6 (f32 Gram-Schmidt in another summation
order); stencils 2e-5 absolute (max |stencil| ~0.85, f32 sums of ~10^3
terms); the loop's eigenvalues 1e-5 relative (both f32 coarse eigensolves
converged to 1e-6) and data_mom 1e-4 of its max (subspace error ~ residual
/ gap, plus f32 sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu import fields
from mugiq_tpu.lattice import LatticeGeometry

from mugiq_tpu_torch.cli import loop as cli_loop
from mugiq_tpu_torch.mg.kernel_mg import TransferKernelMG
from mugiq_tpu_torch.mg.rc_mg import MGEnvRC
from mugiq_tpu_torch.params import (EigParam, GaugeParam, InvertParam,
                                    LoopParam, MGParam)
from mugiq_tpu_torch.production import (build_kernel_dirac,
                                        compute_loop_production)

torch.set_num_threads(2)

DIMS = (4, 4, 4, 8)
KAPPA = 0.12
MG = dict(n_level=3, geo_block_size=[(2, 2, 2, 2), (1, 1, 1, 2)],
          n_vec=[4, 4], setup_iters=6)
EIG = dict(n_ev=4, n_kr=16, tol=1e-6, max_restarts=200)
MOMENTA = [(0, 0, 0), (1, 0, 0)]
STENCIL_ATOL = 2e-5


@pytest.fixture(scope="module")
def gauge():
    return np.asarray(fields.weak_gauge(LatticeGeometry(DIMS), eps=0.3,
                                        seed=1, dtype=jnp.complex64))


@pytest.fixture(scope="module")
def jax_run(gauge, tmp_path_factory):
    from mugiq_tpu import params as jp
    from mugiq_tpu.production import _compute_loop_production_mg

    npz = str(tmp_path_factory.mktemp("jax_mg") / "hierarchy.npz")
    res = _compute_loop_production_mg(
        gauge, jp.GaugeParam(dims=DIMS), jp.InvertParam(kappa=KAPPA),
        jp.EigParam(**EIG), jp.LoopParam(momenta=MOMENTA),
        jp.MGParam(**MG, vec_outfile=npz), None, False, 1234,
        mg_setup="kernel")
    with np.load(npz) as z:
        saved = dict(z)
    return res, npz, saved


@pytest.fixture(scope="module")
def port_env(gauge):
    op = build_kernel_dirac(gauge, GaugeParam(dims=DIMS),
                            InvertParam(kappa=KAPPA), device="cpu")
    return MGEnvRC.build(op, MGParam(**MG))


def _assert_stencils(op, saved, level, atol):
    np.testing.assert_allclose(op.D.numpy(), saved[f"D{level}"], atol=atol)
    for mu in range(4):
        np.testing.assert_allclose(op.Yp[mu].numpy(), saved[f"Yp{level}_{mu}"],
                                   atol=atol, err_msg=f"Yp{mu}")
        np.testing.assert_allclose(op.Ym[mu].numpy(), saved[f"Ym{level}_{mu}"],
                                   atol=atol, err_msg=f"Ym{mu}")


def test_null_vectors_drawn_per_vector_are_the_same_stream():
    """The port draws the fine null vectors one at a time; numpy's
    Generator gives the stream of the JAX package's single draw."""
    shape = (3, 2, 24, 2, 4)
    whole = np.random.default_rng(7).standard_normal(shape)
    rng = np.random.default_rng(7)
    parts = np.stack([rng.standard_normal(shape[1:]) for _ in range(3)])
    np.testing.assert_array_equal(parts, whole)


def test_transfer_basis_matches_jax(jax_run, port_env):
    _, _, saved = jax_run
    np.testing.assert_allclose(port_env.transfers[0].to_agg_V().numpy(),
                               saved["V0"], atol=2e-6)


def test_transfer_restrict_prolong_match_jax(jax_run):
    """The JAX basis in both packages: restrict, prolong, and the
    checkpoint layout round trip (exact)."""
    from mugiq_tpu.mg.kernel_mg import TransferKernelMG as JT
    from mugiq_tpu.mg.transfer import BlockGeometry as JG
    from mugiq_tpu_torch.mg.transfer import BlockGeometry

    _, _, saved = jax_run
    gi = [int(v) for v in saved["geom0"]]
    kw = dict(fine_dims=tuple(gi[:4]), block=tuple(gi[4:8]), ns_fine=gi[8],
              nc_fine=gi[9], spin_block=gi[10])
    jt = JT.from_agg_V(saved["V0"], JG(**kw), DIMS[1])
    pt = TransferKernelMG.from_agg_V(torch.from_numpy(saved["V0"]),
                                     BlockGeometry(**kw), DIMS[1])
    np.testing.assert_array_equal(pt.V.numpy(), np.asarray(jt.V))
    np.testing.assert_array_equal(pt.to_agg_V().numpy(), saved["V0"])

    rng = np.random.default_rng(0)
    psi = rng.standard_normal(pt.V.shape[1:]).astype(np.float32)
    np.testing.assert_allclose(pt.restrict(torch.from_numpy(psi)).numpy(),
                               np.asarray(jt.restrict(jnp.asarray(psi))),
                               atol=2e-5)
    phi = rng.standard_normal(pt.coarse_field_shape).astype(np.float32)
    got = pt.prolong(torch.from_numpy(phi))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jt.prolong(jnp.asarray(phi))),
                               atol=2e-6)
    # V is block-orthonormal: R P = 1
    np.testing.assert_allclose(pt.restrict(got).numpy(), phi, atol=2e-5)


def test_galerkin_matches_jax_kernel_formulation(jax_run, port_env):
    _, _, saved = jax_run
    _assert_stencils(port_env.level_ops[1], saved, 0, STENCIL_ATOL)


def test_three_level_hierarchy_matches_jax(jax_run, port_env):
    _, _, saved = jax_run
    np.testing.assert_allclose(port_env.transfers[1].V.numpy(), saved["V1"],
                               atol=2e-5)
    _assert_stencils(port_env.level_ops[2], saved, 1, STENCIL_ATOL)


def test_jax_checkpoint_loads_in_port(jax_run, port_env, tmp_path):
    """A hierarchy saved by JAX MGEnvRC.save loads as the same coarse
    operator, and the port's save writes the same arrays back."""
    _, npz, saved = jax_run
    env = MGEnvRC.load(npz, None, MGParam(**MG), device="cpu")
    _assert_stencils(env.level_ops[2], saved, 1, 0.0)
    phi = torch.from_numpy(np.random.default_rng(1).standard_normal(
        env.coarsest_op.field_shape).astype(np.float32))
    np.testing.assert_allclose(env.coarsest_op.MdagM(phi).numpy(),
                               port_env.coarsest_op.MdagM(phi).numpy(),
                               atol=1e-4)
    out = str(tmp_path / "again.npz")
    env.save(out)
    with np.load(out) as z:
        assert sorted(z.files) == sorted(saved)
        for k in saved:
            np.testing.assert_array_equal(z[k], saved[k], err_msg=k)


def test_mg_loop_matches_jax(jax_run, gauge):
    ref, _, _ = jax_run
    res = compute_loop_production(
        gauge, GaugeParam(dims=DIMS), InvertParam(kappa=KAPPA),
        EigParam(**EIG), LoopParam(momenta=MOMENTA), use_mg=True,
        mg=MGParam(**MG), device="cpu")
    assert res.converged and ref.converged
    np.testing.assert_allclose(res.evals, ref.evals, rtol=1e-5)
    assert res.data_mom.shape == ref.data_mom.shape == (2, 1, 16, 8)
    np.testing.assert_allclose(res.data_mom, ref.data_mom,
                               atol=1e-4 * np.abs(ref.data_mom).max())


def test_mg_cli_on_cpu_with_checkpoint(tmp_path):
    """The MG flags of the JAX CLI through the port's CLI on the CPU, a
    displacement on the MG evecs, and a hierarchy saved by one run and
    loaded by the next (the same eigenpairs and loops)."""
    npz = str(tmp_path / "h.npz")
    argv = ["--dims", "4", "4", "4", "4", "--gauge", "weak:0.4",
            "--gauge-seed", "2", "--kappa", "0.12", "--eig-nev", "4",
            "--eig-nkr", "16", "--eig-tol", "1e-6", "--mugiq-use-mg", "yes",
            "--mg-levels", "2", "--mg-block-size", "2", "2", "2", "2",
            "--mg-nvec", "4", "--mg-setup-iters", "4",
            "--loop-do-nonlocal", "yes", "--displace-entry-string", "+z:1",
            "--production", "--device", "cpu"]
    built = cli_loop.run(argv + ["--mg-vec-outfile", npz])
    loaded = cli_loop.run(argv + ["--mg-vec-infile", npz])
    assert built.converged and max(built.resids) < 1e-5
    assert built.data_mom.shape == (1, 2, 16, 4)
    assert np.isfinite(built.data_mom).all()
    np.testing.assert_array_equal(loaded.evals, built.evals)
    np.testing.assert_array_equal(loaded.data_mom, built.data_mom)


# the MG loop under --mesh (with --loop-coarse-ulocal yes, a logged no-op
# with --production): tests/test_torch_mesh.py
@pytest.mark.parametrize("flags", [["--mg-block-size", "2", "2", "2"]])
def test_mg_cli_rejects(flags):
    argv = ["--dims", "4", "4", "4", "4", "--mugiq-use-mg", "yes",
            "--production", "--device", "cpu"] + flags
    with pytest.raises(ValueError, match="4 ints per level"):
        cli_loop.run(argv)
