"""The stream's gauge generator: SU(3) links, reproducible from (seed,
index), distinct between configurations."""

import numpy as np
import pytest
import torch

from portbench import gauge


def test_links_are_su3():
    U = gauge.hot_gauge((4, 4, 2, 4), seed=7, device="cpu")
    assert U.shape == (4, 4, 2, 4, 4, 3, 3) and U.dtype == torch.complex128
    eye = torch.eye(3, dtype=U.dtype)
    uu = U @ U.transpose(-1, -2).conj()
    assert torch.max(torch.abs(uu - eye)) < 1e-12
    det = torch.linalg.det(U)
    assert torch.max(torch.abs(det - 1)) < 1e-12


def test_same_seed_same_gauge_other_index_other_gauge():
    s0 = gauge.derive_seed(2 ** 31 + 5, 0, gauge.GAUGE)
    s1 = gauge.derive_seed(2 ** 31 + 5, 1, gauge.GAUGE)
    a = gauge.hot_gauge((2, 2, 2, 2), s0, "cpu")
    b = gauge.hot_gauge((2, 2, 2, 2), s0, "cpu")
    c = gauge.hot_gauge((2, 2, 2, 2), s1, "cpu")
    assert torch.equal(a, b) and not torch.allclose(a, c)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 17, 2 ** 64 + 3, -5])
def test_derive_seed_takes_any_whole_number(seed):
    seeds = {gauge.derive_seed(seed, i, p) for i in (0, 1, -1)
             for p in (gauge.GAUGE, gauge.START_VECTOR, gauge.MG_SETUP)}
    assert len(seeds) == 9
    assert all(0 <= s < 2 ** 63 for s in seeds)
    np.random.default_rng(max(seeds))


def test_projection_matches_the_programs_host_factory():
    """su3_project is the arithmetic of io/gauge_io._project_su3."""
    from mugiq_tpu_torch.io.gauge_io import _project_su3
    rng = np.random.default_rng(3)
    m = rng.standard_normal((50, 3, 3)) + 1j * rng.standard_normal((50, 3, 3))
    got = gauge.su3_project(torch.from_numpy(m)).numpy()
    assert np.max(np.abs(got - _project_su3(m))) < 1e-12
