"""The launch choice of K1 and K6 (kernels/wilson.py launch_plan) and
their C entry points, on the CPU: pairs appear only where they are
legal, block tiles only for a batch, each plan names a kernel source
that exists, and every source's C entry point takes the arguments its
wrapper passes; likewise the sources of the halo kernels K7a, K4-halo
and K7b, one per spinor type (and K7b's per link type)."""

import ctypes
import os
import re

import pytest

from mugiq_tpu_torch.kernels import build, parity, wilson
from mugiq_tpu_torch.kernels.wilson import launch_plan

KERNELS = {"wilson_m": wilson, "parity_hop": parity}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("spinor_bf16", [False, True])
@pytest.mark.parametrize("aligned", [False, True])
def test_launch_plan(kernel, spinor_bf16, aligned):
    sources = set(build.sources())
    for b in range(1, 18):
        for x in (1, 2, 3, 4, 5, 6, 16, 32):
            p = launch_plan(b, x, spinor_bf16, aligned)
            assert p.spinor_bf16 == spinor_bf16
            assert p.pair == (spinor_bf16 and aligned and x % 2 == 0)
            assert p.tiled == (b > 1 and (p.pair or not spinor_bf16))
            src = p.source(kernel)
            assert src in sources
            # the f32 sources hold f32 spinors only, the rest bf16
            assert spinor_bf16 == (src not in (kernel, f"{kernel}_staged"))


def test_launch_plan_rejects_empty_batch():
    with pytest.raises(ValueError):
        launch_plan(0, 4, False, True)


def _c_params(name):
    """The C parameter kinds of csrc/<name>.cu's entry point mugiq_<name>."""
    text = (build.CSRC / f"{name}.cu").read_text()
    m = re.search(rf'extern "C" int mugiq_{name}\((.*?)\)\s*{{', text, re.S)
    assert m, f"no entry point mugiq_{name} in {name}.cu"
    kinds = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        kinds.append(ctypes.c_void_p if "*" in param else
                     ctypes.c_float if param.startswith("float ") else
                     ctypes.c_int if param.startswith("int ") else param)
    return kinds


@pytest.mark.parametrize("name", [
    f"{k}{s}" for k in sorted(KERNELS)
    for s in ("", "_bf16", "_pair", "_staged", "_staged_pair")])
def test_entry_point_matches_wrapper(name):
    kernel = "wilson_m" if name.startswith("wilson_m") else "parity_hop"
    assert _c_params(name) == KERNELS[kernel].ENTRY_ARGTYPES


HALO_SOURCES = {
    **{wilson.halo_source(k, dt): argtypes
       for k, argtypes in (("wilson_m_halo", wilson.HALO_ARGTYPES),
                           ("dslash_hop_halo", wilson.HOP_HALO_ARGTYPES))
       for dt in wilson.SPINOR_DTYPES},
    **{name: parity.HALO_ARGTYPES for name in parity.HALO_SOURCES.values()}}


@pytest.mark.parametrize("name", sorted(HALO_SOURCES))
def test_halo_entry_point_matches_wrapper(name):
    assert _c_params(name) == HALO_SOURCES[name]


def test_every_source_is_a_wrapper_source():
    """Every csrc/*.cu is reached by a wrapper: the launch plans' K1 / K6
    sources, the halo sources and the single-source kernels."""
    plans = {f"{k}{s}" for k in KERNELS
             for s in ("", "_bf16", "_pair", "_staged", "_staged_pair")}
    single = {"contract", "dslash_hop", "hop_dir"}
    assert set(build.sources()) == plans | set(HALO_SOURCES) | single


def test_build_order_longest_first():
    """The build starts the sources longest first, a source not timed yet
    before all, at most one nvcc per core."""
    order = build.build_order(build.sources() + ["new_kernel"])
    assert order[0] == "new_kernel"
    secs = [build.NVCC_SECONDS[n] for n in order[1:]]
    assert secs == sorted(secs, reverse=True)
    assert set(order[1:7]) == {n for n in build.sources() if "halo" in n
                               and not n.startswith("dslash")}
    assert 1 <= build.build_jobs() <= (os.cpu_count() or 1)
