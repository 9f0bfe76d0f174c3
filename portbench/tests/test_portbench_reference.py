"""The plain reference agrees with the port's plain twins at a tiny
lattice (the tests may import the port; the reference may not), and the
whole check passes on the port's own run of each cell at a tiny size."""

import numpy as np
import pytest
import torch
from conftest import tiny_cell

from portbench import check, gauge, session
from portbench.reference import loop as rloop
from portbench.reference import mg as rmg
from portbench.reference import wilson as rw

DIMS = (4, 4, 4, 8)
Y = DIMS[1]


def _gauge(seed=11):
    return gauge.hot_gauge(DIMS, seed, "cpu")


def _kernel_spinors(n, seed=3):
    X, Y_, Z, T = DIMS
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, T, 24, Z, Y_ * X), generator=g)


def test_wilson_matches_the_port_twin():
    from mugiq_tpu_torch.kernels.wilson import wilson_m_plain
    from mugiq_tpu_torch.layout import kernel_gauge_np
    U = _gauge()
    Uk = torch.from_numpy(kernel_gauge_np(U.numpy(), True))
    psi = _kernel_spinors(1)[0]
    ref = rw.Wilson(rw.phased_links(U).to(torch.complex64), 0.12)
    for dagger, op in ((False, ref.M), (True, ref.Mdag)):
        got = rw.from_kernel_layout(
            wilson_m_plain(psi, Uk, None, 0.12, dagger, Y), Y)
        want = op(rw.from_kernel_layout(psi, Y))
        assert torch.max(torch.abs(got - want)) < 1e-5 * torch.max(
            torch.abs(want))


@pytest.mark.parametrize("mu", range(4))
def test_directed_hops_match_the_port_twin(mu):
    from mugiq_tpu_torch.kernels.hop_dir import dslash_hop_dir_plain
    from mugiq_tpu_torch.layout import kernel_gauge_np
    U = _gauge()
    Uk = torch.from_numpy(kernel_gauge_np(U.numpy(), True))
    psi = _kernel_spinors(1)[0]
    ref = rw.Wilson(rw.phased_links(U).to(torch.complex64), 0.12)
    for sign in (1, -1):
        got = rw.from_kernel_layout(
            dslash_hop_dir_plain(psi, Uk, mu, sign, False, Y), Y)
        want = ref.hop(rw.from_kernel_layout(psi, Y), mu, sign)
        assert torch.max(torch.abs(got - want)) < 1e-5


def test_loops_match_the_port_measurement():
    from mugiq_tpu_torch import production
    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.loop import LoopComputeParam
    from mugiq_tpu_torch.params import LoopParam
    U = _gauge()
    ev = _kernel_spinors(3)
    sigma = np.array([0.4, 0.5, 0.7])
    moms = [(0, 0, 0), (1, 0, 0), (0, 1, 1)]
    lp = LoopParam(momenta=moms, do_nonlocal=True,
                   disp_entries=["+z:1,2", "-t:1"])
    geom = LatticeGeometry(DIMS)
    got, _ = production._measure_production_kernel(
        geom, lp, LoopComputeParam.build(geom, lp), ev, sigma, U.numpy(),
        False)
    want = rloop.loop_data_mom(
        rw.from_kernel_layout(ev, Y).to(torch.complex128), sigma, U,
        ["+z:1,2", "-t:1"], moms, -1).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(want))


def test_coarse_operator_has_the_ports_spectrum():
    """The reference's Galerkin operator, rebuilt from the gauge and the
    set-up seed, has the spectrum of the port's (the bases differ by a
    unitary rotation a block)."""
    from mugiq_tpu_torch.dirac_kernel import WilsonDiracKernel
    from mugiq_tpu_torch.layout import kernel_gauge_np
    from mugiq_tpu_torch.mg.rc_mg import MGEnvRC
    from mugiq_tpu_torch.params import MGParam
    U = _gauge()
    mgp = MGParam(n_level=2, geo_block_size=[(2, 2, 2, 2)], n_vec=[4],
                  setup_iters=5, setup_seed=2 ** 40 + 9)
    Uk = torch.from_numpy(kernel_gauge_np(U.numpy(), True))
    op = WilsonDiracKernel(U_k=Uk, kappa=0.12, Y=Y)
    env = MGEnvRC.build(op, mgp)
    c = env.coarsest_op
    n = int(np.prod(c.field_shape[:-1]))

    def dense(apply, shape, dtype):
        eye = torch.eye(n, dtype=dtype)
        return torch.stack([apply(e.reshape(shape)).reshape(-1)
                            for e in eye], -1)

    shape = c.field_shape
    port = dense(lambda e: torch.view_as_complex(
        c.MdagM(torch.view_as_real(e.reshape(shape[:-1])).contiguous())
        .contiguous()), shape[:-1], torch.complex64)
    wil = rw.Wilson(rw.phased_links(U).to(torch.complex64), 0.12)
    nulls = rmg.null_vectors(wil, mgp.setup_seed, 4, 5, DIMS)
    tr = rmg.Transfer(nulls, rmg.Blocking(DIMS, (2, 2, 2, 2)))
    co = rmg.Coarse(wil, tr).to(torch.complex128)
    cshape = tuple(co.D.shape[:4]) + (co.n,)
    ref = dense(co.MdagM, cshape, torch.complex128)
    ep = np.linalg.eigvalsh(port.to(torch.complex128).numpy())
    er = np.linalg.eigvalsh(ref.numpy())
    assert np.max(np.abs(ep - er)) < 1e-5 * np.max(er)


def test_prolong_restrict_round_trip():
    U = _gauge()
    wil = rw.Wilson(rw.phased_links(U).to(torch.complex64), 0.12)
    nulls = rmg.null_vectors(wil, 5, 4, 2, DIMS)
    tr = rmg.Transfer(nulls, rmg.Blocking(DIMS, (2, 2, 2, 2)))
    u = torch.randn(tr.restrict(nulls[0]).shape, dtype=torch.complex64)
    assert torch.allclose(tr.restrict(tr.prolong(u)), u, atol=1e-5)
    # a null vector lies in the coarse space
    assert torch.allclose(tr.prolong(tr.restrict(nulls[1])), nulls[1],
                          atol=1e-5)


@pytest.mark.parametrize("cell", ["wilson32-defl.flagship",
                                  "wilson32-mg.flagship"])
def test_check_passes_on_the_ports_run(cell, cpu_only):
    c = tiny_cell(cell)
    result, lines = session.execute(c, 2 ** 31 + 101, 0.1, False, "cpu", 0.0)
    assert result["correct"], result["check"]
    # one whole pass through the members, however short the window
    assert result["attempted"] == len(c.traffic["ensemble"]["members"])
    assert list(result["metrics"]) == ["cfg_s", "setup_s"]
    assert list(result)[-1] == "check"
    n = len(check.NAMES)
    assert [ln.split()[1] for ln in lines[-n:]] == list(check.NAMES)
