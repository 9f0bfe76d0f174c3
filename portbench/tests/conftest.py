"""CPU tests of the benchmark (``python -m pytest portbench/tests -q``); the
card's tests are marked gpu and skip without a CUDA device."""

import copy
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device; skips without one")


def tiny_cell(name: str, **config_changes):
    """A cell of BENCHMARK.json cut to a CPU-sized lattice (its limits as
    they stand)."""
    from portbench.manifest import load_cell
    cell = load_cell(name, ROOT)
    cell = copy.deepcopy(cell)
    cfg = cell.config
    cfg["dims"] = [4, 4, 4, 8]
    cfg["eig"].update(n_ev=4, n_kr=12)
    if cfg.get("mg"):
        cfg["mg"].update(geo_block_size=[[2, 2, 2, 2]], n_vec=[4])
    cfg.update(config_changes)
    return cell


@pytest.fixture
def cpu_only():
    import torch
    torch.set_num_threads(4)
