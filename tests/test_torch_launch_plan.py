"""The launch choice of the stencils (kernels/wilson.py launch_plan: K1,
K6, K4, K7a and K4-halo) and their C entry points, on the CPU: pairs
appear only where they are legal, block tiles only for a batch of K1 or
K6, each plan names a kernel source that exists, and every source's C
entry point takes the arguments its wrapper passes; likewise K7b's
sources, one per spinor and link type."""

import ctypes
import os
import re

import pytest

from mugiq_tpu_torch.kernels import build, parity, wilson
from mugiq_tpu_torch.kernels.wilson import launch_plan

#: each stencil's module and C argument types
KERNELS = {"wilson_m": wilson.ENTRY_ARGTYPES,
           "parity_hop": parity.ENTRY_ARGTYPES,
           "dslash_hop": wilson.HOP_ARGTYPES,
           "wilson_m_halo": wilson.HALO_ARGTYPES,
           "dslash_hop_halo": wilson.HOP_HALO_ARGTYPES}
#: the sources whose instances hold f32 spinors (K4's one-site source
#: holds every type)
F32_SOURCES = {"wilson_m", "wilson_m_staged", "parity_hop",
               "parity_hop_staged", "dslash_hop", "wilson_m_halo",
               "dslash_hop_halo"}


def plan_sources():
    """{source: kernel} of every launch plan of every stencil."""
    out = {}
    for kernel in KERNELS:
        for b in ((1, 2) if kernel in wilson.BATCHED else (1,)):
            for x in (1, 2):
                for bf in (False, True):
                    for aligned in (False, True):
                        out[launch_plan(kernel, b, x, bf, aligned).source] = \
                            kernel
    return out


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("spinor_bf16", [False, True])
@pytest.mark.parametrize("aligned", [False, True])
def test_launch_plan(kernel, spinor_bf16, aligned):
    sources = set(build.sources())
    batches = range(1, 18) if kernel in wilson.BATCHED else (1,)
    for b in batches:
        for x in (1, 2, 3, 4, 5, 6, 16, 32):
            p = launch_plan(kernel, b, x, spinor_bf16, aligned)
            assert p.kernel == kernel
            assert p.spinor_bf16 == spinor_bf16
            assert p.pair == (spinor_bf16 and aligned and x % 2 == 0)
            assert p.tiled == (b > 1 and (p.pair or not spinor_bf16))
            src = p.source
            assert src in sources
            assert src.startswith(kernel)
            # the f32 sources hold f32 spinors; the rest bf16 (K4's
            # one-site source both)
            if src != "dslash_hop":
                assert spinor_bf16 == (src not in F32_SOURCES)
            assert p.pair == src.endswith("_pair")


def test_launch_plan_rejects_empty_batch():
    for kernel in KERNELS:
        with pytest.raises(ValueError):
            launch_plan(kernel, 0, 4, False, True)


@pytest.mark.parametrize("kernel", ["dslash_hop", "wilson_m_halo",
                                    "dslash_hop_halo", "parity_hop_halo"])
def test_launch_plan_rejects_batch_or_unplanned_kernel(kernel):
    """K4 and the halo kernels take one field; K7b picks its source by
    type (parity.HALO_SOURCES), not by a launch plan."""
    with pytest.raises(ValueError):
        launch_plan(kernel, 2, 4, True, True)


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


HALO_KERNELS = ("wilson_m_halo", "dslash_hop_halo")


@pytest.mark.parametrize("name", sorted(
    s for s, k in plan_sources().items() if k not in HALO_KERNELS))
def test_entry_point_matches_wrapper(name):
    assert _c_params(name) == KERNELS[plan_sources()[name]]


#: the halo kernels' sources: K7a's and K4-halo's by launch plan, K7b's
#: by spinor and link type
HALO_SOURCES = {
    **{s: KERNELS[k] for s, k in plan_sources().items() if k in HALO_KERNELS},
    **{name: parity.HALO_ARGTYPES for name in parity.HALO_SOURCES.values()}}


@pytest.mark.parametrize("name", sorted(HALO_SOURCES))
def test_halo_entry_point_matches_wrapper(name):
    assert _c_params(name) == HALO_SOURCES[name]


def test_every_source_is_a_wrapper_source():
    """Every csrc/*.cu is reached by a wrapper: the launch plans' sources,
    K7b's sources and the single-source kernels."""
    single = {"contract", "hop_dir"}
    assert set(build.sources()) == (set(plan_sources())
                                    | set(parity.HALO_SOURCES.values())
                                    | single)


def test_build_order_longest_first():
    """The build starts the sources longest first, a source not timed yet
    before all, at most one nvcc per core; every source is timed."""
    order = build.build_order(build.sources() + ["new_kernel"])
    assert order[0] == "new_kernel"
    assert set(order[1:]) == set(build.NVCC_SECONDS)
    secs = [build.NVCC_SECONDS[n] for n in order[1:]]
    assert secs == sorted(secs, reverse=True)
    assert 1 <= build.build_jobs() <= (os.cpu_count() or 1)
