"""The port's API path (mugiq_tpu_torch.api and the complex full-site
modules under it) against the JAX package's, on the CPU.

Inputs come from numpy seeds (the gauge from io.gauge_io.load_gauge_np,
spinors from default_rng) and the JAX run's random state is carried
across: its Lanczos / Arnoldi start vector goes to the port's solver.
Both sides run complex128 at 4^4 (the JAX package with x64, as
tests/conftest.py sets it) unless a case says otherwise.

Tolerances (max |port - jax| / max |jax|): operators 1e-12 (fp64 sums in
another order); Ritz values from the same v0 at the same restart count
1e-9; compute_loop's data_mom 1e-8 normwise (each side converged to
residual 1e-10 from its own start vector; data_mom does not depend on
eigenvector phases); a complex64 API eigensolve 1e-5 against the JAX
fp64 one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu_torch import api, fields
from mugiq_tpu_torch.io.gauge_io import load_gauge_np
from mugiq_tpu_torch.lattice import LatticeGeometry
from mugiq_tpu_torch.params import (DslashType, EigOperator, EigParam,
                                    GaugeParam, InvertParam, LoopParam,
                                    MassNormalization)

torch.set_num_threads(2)

DIMS = (4, 4, 4, 4)
KAPPA = 0.13
OP_RTOL = 1e-12
MOMENTA = [(0, 0, 0), (1, 0, 0), (0, 1, 1)]
DISP = ["+z:1,2", "-t:1", "+x:1"]
C128 = torch.complex128


def rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


def t(a):
    return torch.from_numpy(np.asarray(a))


def spinor(seed, lead=()):
    rng = np.random.default_rng(seed)
    shape = lead + (DIMS[3], DIMS[2], DIMS[1], DIMS[0], 4, 3)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def gauge():
    return load_gauge_np("weak:0.5", LatticeGeometry(DIMS), seed=1)


def jax_params(clover=False, anisotropy=1.0, mass_norm=False):
    from mugiq_tpu import params as jp
    ip = jp.InvertParam(
        kappa=KAPPA, csw=1.1 if clover else 0.0, anisotropy=anisotropy,
        dslash_type=(jp.DslashType.CLOVER_WILSON if clover
                     else jp.DslashType.WILSON),
        mass_normalization=(jp.MassNormalization.MASS if mass_norm
                            else jp.MassNormalization.KAPPA))
    return jp.GaugeParam(dims=DIMS, anisotropy=anisotropy), ip


def port_params(clover=False, anisotropy=1.0, mass_norm=False):
    ip = InvertParam(
        kappa=KAPPA, csw=1.1 if clover else 0.0, anisotropy=anisotropy,
        dslash_type=(DslashType.CLOVER_WILSON if clover
                     else DslashType.WILSON),
        mass_normalization=(MassNormalization.MASS if mass_norm
                            else MassNormalization.KAPPA))
    return GaugeParam(dims=DIMS, anisotropy=anisotropy), ip


def both_diracs(U, **kw):
    from mugiq_tpu.dirac import make_dirac as jax_make
    from mugiq_tpu_torch.dirac import make_dirac
    return (jax_make(jnp.asarray(U), *jax_params(**kw)),
            make_dirac(t(U), *port_params(**kw)))


def test_fields_match_jax(gauge):
    from mugiq_tpu import fields as jf

    psi = spinor(2)
    for mu in range(4):
        for sign in (+1, -1):
            assert rel(fields.shift(t(psi), mu, sign),
                       jf.shift(jnp.asarray(psi), mu, sign)) == 0.0
            # a leading batch axis and the link layout shift alike
            assert rel(fields.shift(t(psi[None]), mu, sign),
                       jf.shift(jnp.asarray(psi[None]), mu, sign,
                                rank_offset=1)) == 0.0
    for ap in (True, False):
        assert rel(fields.apply_boundary_phase(t(gauge), ap),
                   jf.apply_boundary_phase(jnp.asarray(gauge), ap)) == 0.0
    phi = spinor(3)
    assert abs(complex(fields.inner(t(psi), t(phi)))
               - complex(jf.inner(jnp.asarray(psi), jnp.asarray(phi)))) \
        <= OP_RTOL * abs(complex(jf.inner(jnp.asarray(psi),
                                          jnp.asarray(phi))))
    assert float(fields.norm2(t(psi))) == pytest.approx(
        float(jf.norm2(jnp.asarray(psi))), rel=OP_RTOL)


def test_dslash_matches_jax(gauge):
    from mugiq_tpu.ops import dslash as jd
    from mugiq_tpu_torch.ops import dslash

    U, psi = gauge, spinor(4)
    assert rel(dslash.dslash_hop(t(U), t(psi)),
               jd.dslash_hop(jnp.asarray(U), jnp.asarray(psi))) < OP_RTOL
    assert rel(dslash.dslash_hop_dagger(t(U), t(psi)),
               jd.dslash_hop_dagger(jnp.asarray(U), jnp.asarray(psi))) \
        < OP_RTOL
    for mu in range(4):
        for fwd in (True, False):
            assert rel(dslash._hop_term(t(U[mu]), t(psi), mu, fwd),
                       jd._hop_term(jnp.asarray(U[mu]), jnp.asarray(psi),
                                    mu, fwd)) < OP_RTOL


def test_clover_matches_jax(gauge):
    from mugiq_tpu import clover as jc
    from mugiq_tpu_torch import clover

    U, psi = gauge, spinor(5)
    assert rel(clover.field_strength(t(U)),
               jc.field_strength(jnp.asarray(U))) < OP_RTOL
    A = clover.clover_field(t(U), KAPPA, 1.1)
    jA = jc.clover_field(jnp.asarray(U), KAPPA, 1.1)
    assert rel(A, jA) < OP_RTOL
    assert rel(clover.apply_clover(A, t(psi)),
               jc.apply_clover(jA, jnp.asarray(psi))) < OP_RTOL
    assert rel(clover.clover_inverse(A), jc.clover_inverse(jA)) < OP_RTOL


@pytest.mark.parametrize("kw", [dict(clover=True), dict(anisotropy=1.3)],
                         ids=["clover", "anisotropic"])
def test_dirac_matches_jax(gauge, kw):
    jd, d = both_diracs(gauge, **kw)
    psi = spinor(6)
    jpsi = jnp.asarray(psi)
    assert rel(d.U, jd.U) < OP_RTOL
    for which in EigOperator:
        from mugiq_tpu.params import EigOperator as JOp
        assert rel(d.operator(which)(t(psi)),
                   jd.operator(JOp[which.name])(jpsi)) < OP_RTOL, which
    assert rel(d.diag_term(t(psi)), jd.diag_term(jpsi)) < OP_RTOL
    for mu in range(4):
        for sign in (+1, -1):
            assert rel(d.hop_term(mu, sign, t(psi)),
                       jd.hop_term(mu, sign, jpsi)) < OP_RTOL
    assert d.field_shape == tuple(jd.field_shape)


def test_dense_matrix_matches_jax():
    from mugiq_tpu.dirac import dense_matrix as jax_dense
    from mugiq_tpu.dirac import make_dirac as jax_make
    from mugiq_tpu import params as jp
    from mugiq_tpu_torch.dirac import dense_matrix, make_dirac

    dims = (2, 2, 2, 2)
    U = load_gauge_np("weak:0.5", LatticeGeometry(dims), seed=3)
    jd = jax_make(jnp.asarray(U), jp.GaugeParam(dims=dims),
                  jp.InvertParam(kappa=KAPPA))
    d = make_dirac(t(U), GaugeParam(dims=dims), InvertParam(kappa=KAPPA))
    assert rel(dense_matrix(d.M, d.field_shape, C128, device="cpu"),
               jax_dense(jd.M, jd.field_shape, jnp.complex128)) < OP_RTOL


@pytest.mark.parametrize("clover, symmetric", [(False, False), (True, True)],
                         ids=["wilson-asym", "clover-sym"])
def test_schur_matches_jax(gauge, clover, symmetric):
    from mugiq_tpu.schur import SchurDirac as JS
    from mugiq_tpu_torch.schur import SchurDirac

    jd, d = both_diracs(gauge, clover=clover)
    js = JS.from_dirac(jd, symmetric=symmetric)
    s = SchurDirac.from_dirac(d, symmetric=symmetric)
    psi = spinor(7)
    jpsi = jnp.asarray(psi)
    assert rel(s.project_even(t(psi)), js.project_even(jpsi)) == 0.0
    for name in ("M", "Mdag", "MdagM", "MMdag"):
        assert rel(getattr(s, name)(t(psi)), getattr(js, name)(jpsi)) \
            < OP_RTOL, name
    x = s.solve_full(d, t(psi), tol=1e-12, maxiter=500)
    assert rel(x, js.solve_full(jd, jpsi, tol=1e-12, maxiter=500)) < 1e-10
    assert rel(d.M(x), psi) < 1e-10


def test_solvers_match_jax(gauge):
    from mugiq_tpu import solvers as js
    from mugiq_tpu_torch import solvers

    jd, d = both_diracs(gauge)
    b = spinor(8)
    got = solvers.cg(d.MdagM, t(b), tol=1e-11, maxiter=400)
    ref = js.cg(jd.MdagM, jnp.asarray(b), tol=1e-11, maxiter=400)
    assert got.iters == int(ref.iters)
    assert rel(got.x, ref.x) < 1e-10
    got = solvers.cgne(d.M, d.Mdag, t(b), tol=0.0, maxiter=7)
    ref = js.cgne(jd.M, jd.Mdag, jnp.asarray(b), tol=0.0, maxiter=7)
    assert got.iters == 7 and rel(got.x, ref.x) < OP_RTOL
    # a batch runs one CG per vector, as jax.vmap of the JAX solve
    B = spinor(9, lead=(3,))
    got = solvers.cg(d.MdagM, t(B), tol=0.0, maxiter=5, batched=True)
    import jax
    ref = jax.vmap(lambda r: js.cg(jd.MdagM, r, tol=0.0, maxiter=5).x)(
        jnp.asarray(B))
    assert rel(got.x, ref) < OP_RTOL


def test_lanczos_matches_jax(gauge):
    """The same v0 (the JAX one) and restart count: the same Ritz values,
    Chebyshev-filtered as the eigensolver runs them."""
    from mugiq_tpu.eig import lanczos as jl
    from mugiq_tpu_torch.eig import lanczos

    jd, d = both_diracs(gauge)
    v0 = spinor(10)
    a_max = jl.estimate_spectral_edge(jd.MdagM, jnp.asarray(v0))
    assert lanczos.estimate_spectral_edge(d.MdagM, t(v0)) == pytest.approx(
        a_max, rel=1e-12)
    kw = dict(n_ev=4, n_kr=16, tol=1e-10, max_restarts=60, which="LR",
              check_interval=2)
    ref = jl.lanczos_hermitian(jl.chebyshev_op(jd.MdagM, 8, 0.09, a_max),
                               jnp.asarray(v0), **kw)
    got = lanczos.lanczos_hermitian(
        lanczos.chebyshev_op(d.MdagM, 8, 0.09, a_max), t(v0), **kw)
    assert (got.n_restarts, got.converged) == (ref.n_restarts, ref.converged)
    np.testing.assert_allclose(got.evals, ref.evals, rtol=1e-9)
    np.testing.assert_allclose(got.resids, ref.resids, atol=1e-9 * np.abs(
        ref.evals).max())
    # Ritz vectors agree up to a phase each
    ov = np.abs(np.sum(np.conj(np.asarray(ref.evecs)).reshape(4, -1)
                       * got.evecs.numpy().reshape(4, -1), axis=1))
    np.testing.assert_allclose(ov, 1.0, atol=1e-8)


def test_arnoldi_matches_jax(gauge):
    from mugiq_tpu.eig.arnoldi import arnoldi_krylov_schur as jax_arnoldi
    from mugiq_tpu_torch.eig.arnoldi import arnoldi_krylov_schur

    jd, d = both_diracs(gauge)
    v0 = spinor(11)
    kw = dict(n_ev=3, n_kr=20, tol=1e-9, max_restarts=40, which="SM")
    ref = jax_arnoldi(jd.M, jnp.asarray(v0), **kw)
    got = arnoldi_krylov_schur(d.M, t(v0), **kw)
    assert got.n_restarts == ref.n_restarts
    np.testing.assert_allclose(got.evals, ref.evals, rtol=1e-9)


@pytest.mark.parametrize("which, even_odd", [
    (EigOperator.MdagM, False), (EigOperator.MMdag, True),
    (EigOperator.M, False)], ids=["MdagM", "MMdag-pc", "M"])
def test_eigensolver_matches_jax(gauge, which, even_odd):
    """Eigensolver (Lanczos + Chebyshev, or Arnoldi for M; computeEvals
    with the MASS rescale; sort; sigma; project) from the JAX start
    vector."""
    from mugiq_tpu import params as jp
    from mugiq_tpu.eig.eigsolve import Eigensolver as JE
    from mugiq_tpu.schur import SchurDirac as JS
    from mugiq_tpu_torch.eig.eigsolve import Eigensolver
    from mugiq_tpu_torch.schur import SchurDirac

    jd, d = both_diracs(gauge, mass_norm=True)
    jop, op = (JS.from_dirac(jd), SchurDirac.from_dirac(d)) if even_odd \
        else (jd, d)
    poly = which != EigOperator.M
    common = dict(n_ev=4, n_kr=16, tol=1e-10, max_restarts=80,
                  use_poly_acc=poly, poly_deg=8 if poly else 0,
                  a_min=0.3 if even_odd else 0.09,
                  spectrum=("SM" if not poly else "SR"), check_interval=2)
    jep = jp.EigParam(operator=jp.EigOperator[which.name],
                      **{**common, "spectrum": jp.Spectrum[common["spectrum"]]})
    from mugiq_tpu_torch.params import Spectrum
    ep = EigParam(operator=which,
                  **{**common, "spectrum": Spectrum[common["spectrum"]]})
    je = JE(jop.operator(jep.operator), jop.field_shape, jop.dtype, jep,
            jax_params(mass_norm=True)[1],
            v0_transform=jop.project_even if even_odd else None)
    v0 = je._start_vector()
    ref = je.solve()
    e = Eigensolver(op.operator(which), op.field_shape, C128, ep,
                    port_params(mass_norm=True)[1], device="cpu",
                    v0_transform=op.project_even if even_odd else None)
    e.start_vector = lambda: t(np.asarray(v0))
    got = e.solve()
    assert got.n_restarts == ref.n_restarts
    np.testing.assert_allclose(got.evals, ref.evals, rtol=1e-9)
    np.testing.assert_allclose(got.evals_lanczos, ref.evals_lanczos,
                               rtol=1e-9)
    np.testing.assert_allclose(got.resids, ref.resids, rtol=1e-6,
                               atol=1e-9 * np.abs(ref.evals).max())
    if poly:
        np.testing.assert_allclose(got.sigma, ref.sigma, rtol=1e-9)
    else:
        assert got.sigma is None and ref.sigma is None
    vec = spinor(12)
    assert rel(e.project(got.evecs, t(vec)),
               je.project(ref.evecs, jnp.asarray(vec))) < 1e-8
    if which == EigOperator.M:
        with pytest.raises(ValueError, match="non-symmetric"):
            Eigensolver(op.M, op.field_shape, C128,
                        EigParam(operator=which, use_poly_acc=True),
                        device="cpu")


def test_displace_matches_jax(gauge):
    from mugiq_tpu.displace import covariant_displace as jax_disp
    from mugiq_tpu_torch.displace import covariant_displace

    V = spinor(13, lead=(2,))
    for d in ("+x", "-y", "+z", "-t"):
        assert rel(covariant_displace(t(gauge), t(V), d),
                   jax_disp(jnp.asarray(gauge), jnp.asarray(V), d)) < OP_RTOL


def test_contract_and_phase_match_jax():
    from mugiq_tpu.ops import contract as jc
    from mugiq_tpu.ops import phase as jph
    from mugiq_tpu.lattice import LatticeGeometry as JG
    from mugiq_tpu_torch import phase
    from mugiq_tpu_torch.ops import contract

    vL, vR = spinor(14, lead=(3,)), spinor(15, lead=(3,))
    w = np.array([0.7, 1.3, 2.1])
    dp = contract.loop_contract(t(vL), t(vR), t(w))
    jdp = jc.loop_contract(jnp.asarray(vL), jnp.asarray(vR), jnp.asarray(w))
    assert rel(dp, jdp) < OP_RTOL
    assert rel(contract.loop_contract_single(t(vL[0]), t(vR[0]), 0.7),
               jc.loop_contract_single(jnp.asarray(vL[0]),
                                       jnp.asarray(vR[0]), 0.7)) < OP_RTOL
    geom = LatticeGeometry(DIMS)
    ph = phase.phase_matrix(geom, MOMENTA, -1, C128, device="cpu")
    jph_ = jph.phase_matrix(JG(DIMS), MOMENTA, -1, jnp.complex128)
    assert rel(ph, jph_) < OP_RTOL
    data = torch.stack([dp, 2 * dp])
    jdata = jnp.stack([jdp, 2 * jdp])
    mapped = phase.map_gamma_g5(data)
    assert rel(mapped, jph.map_gamma_g5(jdata)) < OP_RTOL
    assert rel(phase.momentum_project(mapped, ph),
               jph.momentum_project(jph.map_gamma_g5(jdata), jph_)) \
        < OP_RTOL


def test_loop_computer_matches_jax(gauge):
    """LoopComputer on the same eigenvectors and sigma: data_pos and
    data_mom."""
    from mugiq_tpu.lattice import LatticeGeometry as JG
    from mugiq_tpu.loop import LoopComputer as JLC
    from mugiq_tpu.params import LoopParam as JLP
    from mugiq_tpu_torch.loop import LoopComputer

    ev = spinor(16, lead=(3,))
    sigma = np.array([0.3, 0.4, 0.5])
    kw = dict(momenta=MOMENTA, do_nonlocal=True, disp_entries=DISP)
    got = LoopComputer(LatticeGeometry(DIMS), LoopParam(**kw),
                       U_disp=t(gauge)).compute(t(ev), sigma)
    ref = JLC(JG(DIMS), JLP(**kw), U_disp=jnp.asarray(gauge)).compute(
        jnp.asarray(ev), sigma)
    assert rel(got.data_pos, ref.data_pos) < OP_RTOL
    assert rel(got.data_mom, ref.data_mom) < OP_RTOL
    assert got.momenta == ref.momenta
    assert got.cparam.slot_labels() == ref.cparam.slot_labels()


API_EIG = dict(n_ev=4, n_kr=16, tol=1e-10, max_restarts=200,
               use_poly_acc=True, poly_deg=8, a_min=0.09, check_interval=2)


@pytest.fixture(scope="module")
def jax_loop(gauge, tmp_path_factory):
    """The JAX API compute_loop (fp64, converged to 1e-10), its HDF5."""
    from mugiq_tpu import api as japi
    from mugiq_tpu import params as jp

    h5 = str(tmp_path_factory.mktemp("jax_loop") / "loops.h5")
    gp, ip = jax_params()
    return japi.compute_loop(
        jnp.asarray(gauge), gp, ip, jp.EigParam(**API_EIG),
        jp.LoopParam(momenta=MOMENTA, do_nonlocal=True, disp_entries=DISP,
                     write_mom_space_hdf5=True, fname_mom_h5=h5)), h5


def test_compute_loop_matches_jax(gauge, jax_loop, tmp_path):
    """api.compute_loop from its own start vector: the converged data_mom
    and eigenvalues, and the same HDF5 layout."""
    import h5py

    (ref, jres), jh5 = jax_loop
    h5 = str(tmp_path / "loops.h5")
    got, res = api.compute_loop(
        gauge, *port_params(), EigParam(**API_EIG),
        LoopParam(momenta=MOMENTA, do_nonlocal=True, disp_entries=DISP,
                  write_mom_space_hdf5=True, fname_mom_h5=h5),
        dtype=C128, device="cpu")
    assert res.output.converged and jres.output.converged
    np.testing.assert_allclose(res.evals, jres.evals, rtol=1e-10)
    assert np.linalg.norm(got.data_mom - ref.data_mom) \
        <= 1e-8 * np.linalg.norm(ref.data_mom)
    with h5py.File(h5) as a, h5py.File(jh5) as b:
        names = []
        a.visit(names.append)
        jnames = []
        b.visit(jnames.append)
        assert names == jnames
        for n in names:
            if isinstance(a[n], h5py.Dataset):
                assert a[n].dtype == b[n].dtype
                np.testing.assert_allclose(
                    a[n][:], b[n][:], atol=1e-8 * np.abs(ref.data_mom).max())


def test_complex64_eigensolve_matches_jax_fp64(gauge, jax_loop):
    """complex64 (the CLIs' --prec single): eigenvalues within 1e-5 of the
    JAX fp64 eigensolve."""
    (_, jres), _ = jax_loop
    res = api.compute_evecs_mugiq(
        gauge, *port_params(), EigParam(**{**API_EIG, "tol": 1e-6}),
        dtype=torch.complex64, device="cpu")
    assert res.evecs.dtype == torch.complex64
    np.testing.assert_allclose(res.evals.real, jres.evals.real, rtol=1e-5)
    assert res.output.resids.max() < 1e-5


@pytest.mark.slow
def test_compute_evecs_even_odd_matches_jax(gauge):
    """The even-odd entry point, clover: evals, and evecs on even sites."""
    from mugiq_tpu import api as japi
    from mugiq_tpu import params as jp

    eig = {**API_EIG, "a_min": 0.3}
    ref = japi.compute_evecs_mugiq(jnp.asarray(gauge),
                                   *jax_params(clover=True),
                                   jp.EigParam(**eig), even_odd=True)
    got = api.compute_evecs_mugiq(gauge, *port_params(clover=True),
                                  EigParam(**eig), even_odd=True,
                                  dtype=C128, device="cpu")
    np.testing.assert_allclose(got.evals, ref.evals, rtol=1e-10)
    odd = (np.indices(DIMS[::-1]).sum(axis=0) % 2).astype(bool)
    assert np.abs(got.evecs.numpy()[:, odd]).max() == 0.0


def test_api_device_and_dtype_checks(gauge, monkeypatch):
    """The card unless the caller asks for the CPU; complex dtypes only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.compute_evecs_mugiq(gauge, *port_params(), EigParam(n_ev=2,
                                                                n_kr=8))
    with pytest.raises(ValueError, match="complex64 or"):
        api.compute_evecs_mugiq(gauge, *port_params(), EigParam(),
                                dtype=torch.float32, device="cpu")
