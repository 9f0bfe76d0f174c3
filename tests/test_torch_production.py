"""The slice as a whole: the port's production loop, driven through its
CLI on the CPU (the kernels' twins), against the JAX package.

Reference: mugiq_tpu.compute_loop, the fp64 validation path, converged to
1e-9 on the same 4^4 gauge (numpy weak:0.5, seed 1; kappa 0.13).  The
port runs the flagship recipe in f32 (Chebyshev filter, Rayleigh-Ritz
refine).  n_ev = 4 ends at a clear gap of the MdagM spectrum (0.07041 |
0.07375, 4.5%), so the deflation subspace and the loops are well defined.
Tolerances: eigenvalues 1e-5 relative (f32 operator rounding, residuals
~1e-6); data_mom 1e-4 of max |data_mom| (subspace error ~ residual /
gap plus f32 sums).

One slow test holds the port against JAX compute_loop_production itself
(interpret-mode Pallas in every matvec; minutes).
"""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu_torch.cli import loop as cli_loop
from mugiq_tpu_torch.params import (EigOperator, EigParam, GaugeParam,
                                    InvertParam, LoopParam)
from mugiq_tpu_torch.production import (compute_evecs_production,
                                        compute_loop_production)

torch.set_num_threads(2)

DIMS = (4, 4, 4, 4)
MOMENTA = [(0, 0, 0), (1, 0, 0), (0, 1, 1)]
DISP = ["+z:1,2", "-t:1"]


def _gauge():
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    return load_gauge_np("weak:0.5", LatticeGeometry(DIMS), seed=1)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    from mugiq_tpu.api import compute_loop
    from mugiq_tpu import params as jp

    h5 = str(tmp_path_factory.mktemp("jax") / "loops.h5")
    ep = jp.EigParam(n_ev=4, n_kr=16, tol=1e-9, max_restarts=500)
    lp = jp.LoopParam(momenta=MOMENTA, do_nonlocal=True, disp_entries=DISP,
                      write_mom_space_hdf5=True, fname_mom_h5=h5)
    res, eig = compute_loop(jnp.asarray(_gauge()), jp.GaugeParam(dims=DIMS),
                            jp.InvertParam(kappa=0.13), ep, lp)
    return res, eig, h5


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("port")
    mom = d / "moms.txt"
    mom.write_text("".join(f"{p[0]} {p[1]} {p[2]}\n" for p in MOMENTA))
    h5 = str(d / "loops.h5")
    res = cli_loop.run([
        "--dims", *map(str, DIMS), "--gauge", "weak:0.5", "--gauge-seed", "1",
        "--kappa", "0.13", "--eig-nev", "4", "--eig-nkr", "16",
        "--eig-tol", "1e-6", "--eig-max-restarts", "100",
        "--eig-use-poly-acc", "--eig-poly-deg", "8", "--eig-amin", "0.09",
        "--momenta-filename", str(mom), "--loop-do-nonlocal", "yes",
        "--displace-entry-string", ";".join(DISP),
        "--loop-write-mom-space", "yes", "--loop-mom-space-filename", h5,
        "--production", "--device", "cpu"])
    return res, h5


def test_slice_converges(port_run):
    res, _ = port_run
    assert res.converged
    assert np.max(res.resids) < 1e-5


def test_slice_evals_match_validation(jax_ref, port_run):
    _, eig, _ = jax_ref
    res, _ = port_run
    np.testing.assert_allclose(res.evals, np.sort(eig.evals.real), rtol=1e-5)
    np.testing.assert_allclose(res.sigma, np.sort(eig.sigma), rtol=1e-5)


def test_slice_data_mom_matches_validation(jax_ref, port_run):
    ref, _, _ = jax_ref
    res, _ = port_run
    assert res.data_mom.shape == ref.data_mom.shape == (3, 4, 16, 4)
    np.testing.assert_allclose(res.data_mom, ref.data_mom,
                               atol=1e-4 * np.abs(ref.data_mom).max())


def test_slice_data_pos_matches_validation(jax_ref):
    """Position-space loops (raw traces, before the g5 map) through the
    library call with keep_pos: 1e-4 of max |data_pos|."""
    ref, _, _ = jax_ref
    ep = EigParam(n_ev=4, n_kr=16, tol=1e-6, max_restarts=100,
                  use_poly_acc=True, poly_deg=8, a_min=0.09)
    lp = LoopParam(momenta=MOMENTA, do_nonlocal=True, disp_entries=DISP)
    res = compute_loop_production(_gauge(), GaugeParam(dims=DIMS),
                                  InvertParam(kappa=0.13), ep, lp,
                                  keep_pos=True, device="cpu")
    want = np.asarray(ref.data_pos)
    assert res.data_pos.shape == want.shape == (4, 16, 4, 4, 4, 4)
    np.testing.assert_allclose(res.data_pos, want,
                               atol=1e-4 * np.abs(want).max())


def test_slice_hdf5_matches_jax_writer(jax_ref, port_run):
    """Same group tree (mom / disp / gamma / loop) and the same data."""
    _, _, h5_ref = jax_ref
    _, h5 = port_run

    def tree(path):
        out = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda name, obj: out.__setitem__(
                name, obj[()] if isinstance(obj, h5py.Dataset) else None))
        return out

    got, ref = tree(h5), tree(h5_ref)
    assert sorted(got) == sorted(ref)
    scale = max(np.abs(v).max() for v in ref.values() if v is not None)
    for name, v in ref.items():
        if v is not None:
            assert got[name].dtype == np.float32 and got[name].shape == v.shape
            np.testing.assert_allclose(got[name], v, atol=1e-4 * scale,
                                       err_msg=name)


@pytest.mark.parametrize("even_odd", [False, True], ids=["full", "pc"])
def test_bf16_basis_under_one_rank_mesh(even_odd):
    """compute_evecs_production with a bf16 Krylov basis over a one-rank
    (1, 1) mesh (every sharded code path but the transfer: the halo
    kernels' twins on the stored bf16 vectors) against the same solve on
    one device: eigenvalues 1e-3 relative (the basis rounds after sums in
    another order, so the runs agree in eigenvalues, not bit for bit),
    residuals under 0.1 (the JAX bound for a bf16 basis), f32 evecs of
    the rank's block.  The bf16 basis on one device is held to the JAX
    package in test_torch_bf16_basis.py."""
    from mugiq_tpu_torch.parallel.mesh import LatticeMesh

    ep = EigParam(n_ev=4, n_kr=16, tol=1e-3, max_restarts=30,
                  use_poly_acc=True, poly_deg=8,
                  a_min=0.3 if even_odd else 0.09)
    got = [compute_evecs_production(
        _gauge(), GaugeParam(dims=DIMS), InvertParam(kappa=0.13), ep,
        even_odd=even_odd, basis_precision="bf16", device="cpu",
        mesh=mesh) for mesh in (None, LatticeMesh((1, 1), DIMS,
                                                  device="cpu"))]
    (one, ev1, _, _), (res, evals, _, resids) = got
    assert one.converged and res.converged
    np.testing.assert_allclose(evals, ev1, rtol=1e-3)
    assert max(resids) < 0.1
    assert res.evecs.dtype == torch.float32
    assert res.evecs.shape == one.evecs.shape == (
        4, 4, 24, 4, 16 // (2 if even_odd else 1))


@pytest.mark.parametrize("kw, match", [
    (dict(operator=EigOperator.M, use_poly_acc=True), "normal operator"),
    (dict(operator=EigOperator.Mdag), "Hermitian Lanczos only")])
def test_nonnormal_operator_errors_match_jax(kw, match):
    """The JAX function's errors: the Chebyshev filter and the bf16 basis
    need a normal operator (production.py:293-306)."""
    bp = "f32" if kw.get("use_poly_acc") else "bf16"
    with pytest.raises(ValueError, match=match):
        compute_evecs_production(_gauge(), GaugeParam(dims=DIMS),
                                 InvertParam(kappa=0.13),
                                 EigParam(n_ev=2, n_kr=8, **kw),
                                 basis_precision=bp, device="cpu")


@pytest.mark.parametrize("kw", [dict(use_mg=True, mg_setup="host")])
def test_loop_options_outside_slice_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compute_loop_production(_gauge(), GaugeParam(dims=DIMS),
                                InvertParam(kappa=0.13),
                                EigParam(n_ev=2, n_kr=8), LoopParam(),
                                device="cpu", **kw)


@pytest.mark.slow
def test_slice_matches_jax_production(port_run):
    """JAX compute_loop_production (f32, interpret-mode Pallas kernels) on
    the same gauge and recipe: evals 1e-5, data_mom 1e-4 of max."""
    from mugiq_tpu import params as jp
    from mugiq_tpu.production import compute_loop_production as jax_prod

    ep = jp.EigParam(n_ev=4, n_kr=16, tol=1e-6, max_restarts=100,
                     use_poly_acc=True, poly_deg=8, a_min=0.09)
    lp = jp.LoopParam(momenta=MOMENTA, do_nonlocal=True, disp_entries=DISP)
    ref = jax_prod(_gauge(), jp.GaugeParam(dims=DIMS),
                   jp.InvertParam(kappa=0.13), ep, lp)
    res, _ = port_run
    np.testing.assert_allclose(res.evals, ref.evals, rtol=1e-5)
    np.testing.assert_allclose(res.data_mom, ref.data_mom,
                               atol=1e-4 * np.abs(ref.data_mom).max())
