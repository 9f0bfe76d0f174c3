"""The eigensolve entry point of the port (mugiq_tpu_torch.cli.eigensolve),
driven on the CPU (the kernels' twins), against the JAX package.

Reference: mugiq_tpu.api.compute_evecs_mugiq, the fp64 validation path
converged to 1e-9 on the same 4^4 gauge (numpy weak:0.5, seed 1; kappa
0.13): even_odd=True for --solve-type direct-pc (the even-even Schur
complement, asymmetric for clover csw 1.1), False for direct.  The port
runs the production recipe in f32 (Chebyshev deg 8, Rayleigh-Ritz
refine).  n_ev = 4 ends at a gap of each spectrum (pc Wilson 0.22192 |
0.23215, pc clover 0.22413 | 0.23251, full Wilson 0.07041 | 0.07375), so
the four eigenvalues are well defined.  Tolerances: eigenvalues 1e-5
relative (f32 operator rounding; residuals ~1e-6), residuals < 1e-5.
"""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu_torch.cli import eigensolve as cli

torch.set_num_threads(2)

DIMS = (4, 4, 4, 4)
ARGS = ["--dims", *map(str, DIMS), "--gauge", "weak:0.5", "--gauge-seed",
        "1", "--kappa", "0.13", "--eig-nev", "4", "--eig-nkr", "16",
        "--eig-tol", "1e-6", "--eig-max-restarts", "100",
        "--eig-use-poly-acc", "--eig-poly-deg", "8", "--production",
        "--device", "cpu"]
# Chebyshev windows above each spectrum's wanted part (see the docstring)
PC = ["--solve-type", "direct-pc", "--eig-amin", "0.3"]
CLOVER = ["--dslash-type", "clover", "--csw", "1.1"]


def _jax_evals(clover: bool, even_odd: bool):
    from mugiq_tpu import params as jp
    from mugiq_tpu.api import compute_evecs_mugiq
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry

    U = load_gauge_np("weak:0.5", LatticeGeometry(DIMS), seed=1)
    ip = jp.InvertParam(kappa=0.13, csw=1.1 if clover else 0.0,
                        dslash_type=(jp.DslashType.CLOVER_WILSON if clover
                                     else jp.DslashType.WILSON))
    ep = jp.EigParam(n_ev=4, n_kr=24, tol=1e-9, max_restarts=500)
    res = compute_evecs_mugiq(jnp.asarray(U), jp.GaugeParam(dims=DIMS), ip,
                              ep, even_odd=even_odd)
    return np.sort(res.evals.real), np.sort(res.sigma)


@pytest.fixture(scope="module")
def pc_run(tmp_path_factory):
    """The Wilson direct-pc run, with its evec checkpoint written."""
    h5 = str(tmp_path_factory.mktemp("evecs") / "evecs.h5")
    return cli.run(ARGS + PC + ["--eig-vec-outfile", h5]), h5


@pytest.mark.parametrize("clover", [False, True])
def test_direct_pc_matches_validation(clover, pc_run):
    res, evals, sigma, resids = (
        cli.run(ARGS + PC + CLOVER) if clover else pc_run[0])
    assert res.converged
    assert res.evecs.shape == (4, 4, 24, 4, 8)     # packed half volume
    assert max(resids) < 1e-5
    ref_evals, ref_sigma = _jax_evals(clover, True)
    np.testing.assert_allclose(evals, ref_evals, rtol=1e-5)
    np.testing.assert_allclose(sigma, ref_sigma, rtol=1e-5)


def test_direct_matches_validation():
    res, evals, sigma, resids = cli.run(ARGS + ["--eig-amin", "0.09"])
    assert res.converged
    assert res.evecs.shape == (4, 4, 24, 4, 16)
    assert max(resids) < 1e-5
    np.testing.assert_allclose(evals, _jax_evals(False, False)[0], rtol=1e-5)


def test_evec_checkpoint_round_trip(pc_run, tmp_path):
    """--eig-vec-outfile writes the JAX save_evecs layout; --eig-vec-infile
    reads it back instead of solving."""
    from mugiq_tpu.io.gauge_io import load_evecs, save_evecs

    (res, evals, sigma, resids), h5 = pc_run
    evecs = res.evecs.numpy()
    ref = str(tmp_path / "jax.h5")
    save_evecs(ref, evecs, evals, sigma=sigma, resids=np.asarray(resids),
               attrs={"dims": str(DIMS), "kappa": str(0.13),
                      "layout": "kernel-realpair"})

    def layout(path):
        with h5py.File(path, "r") as f:
            return ({k: (f[k].shape, f[k].dtype) for k in f},
                    dict(f.attrs))

    assert layout(h5) == layout(ref)
    got = load_evecs(h5)
    np.testing.assert_array_equal(got[0], evecs)
    for a, b in zip(got[1:4], (evals, sigma, resids)):
        np.testing.assert_array_equal(a, np.asarray(b))

    none, ev2, sg2, rs2 = cli.run(ARGS + PC + ["--eig-vec-infile", h5])
    assert none is None
    np.testing.assert_array_equal(ev2, evals)
    np.testing.assert_array_equal(sg2, sigma)
    np.testing.assert_array_equal(rs2, np.asarray(resids))


# the API path (no --production): complex fields, one device
API_ARGS = [a for a in ARGS if a != "--production"]


@pytest.mark.parametrize("flags, rtol", [
    (["--eig-amin", "0.09"], 1e-5),
    (["--eig-amin", "0.09", "--prec", "double", "--eig-tol", "1e-10"],
     1e-9),
    (["--mugiq-use-mg", "yes", "--mg-block-size", "2", "2", "2", "2",
      "--mg-nvec", "4", "--mg-setup-iters", "6", "--prec", "double",
      "--eig-tol", "1e-10", "--eig-amin", "0.7"], None)],
    ids=["fine", "fp64", "mg"])
def test_api_path_runs(flags, rtol, tmp_path):
    """Without --production the CLI runs the API path, as the JAX CLI
    does: complex64 or (--prec double) complex128 against the JAX fp64
    validation run, and the MG-coarse eigensolve; the evec file has the
    JAX API path's attributes (no layout)."""
    h5 = str(tmp_path / "evecs.h5")
    res, evals, sigma, resids = cli.run(API_ARGS + flags
                                        + ["--eig-vec-outfile", h5])
    double = "double" in flags
    assert res.evecs.dtype == (torch.complex128 if double
                               else torch.complex64)
    assert res.output.converged
    assert max(resids) < (1e-8 if double else 1e-5)
    if rtol is None:
        assert res.mg_env is not None
        assert res.evecs.shape == (4, 2, 2, 2, 2, 2, 4)
    else:
        np.testing.assert_allclose(np.sort(evals.real),
                                   _jax_evals(False, False)[0], rtol=rtol)
    with h5py.File(h5, "r") as f:
        assert dict(f.attrs) == {"dims": str(DIMS), "kappa": str(0.13)}
        np.testing.assert_array_equal(f["evecs"][:], res.evecs.numpy())


def test_mesh_without_production_raises():
    """The API path runs on one device; the JAX API branch would ignore
    --mesh."""
    with pytest.raises(SystemExit):
        cli.run(API_ARGS + PC + ["--mesh", "1", "1"])
