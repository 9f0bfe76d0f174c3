"""The stencil_roofline reader's bytes arithmetic: PERF.md's kernel bounds
at 32^3x64 (each input read once, each output written once, 3.35 TB/s),
and the reader on a trace of known times."""

import math
from types import SimpleNamespace

import pytest
from conftest import ROOT

from portbench import manifest

SITES = 32 * 32 * 32 * 64
K1 = ("void (anonymous namespace)::wilson_m_direct_kernel<false, false, 1, "
      "float, float>(float const*, float const*, float const*, float*, int, "
      "int, int, int, float)")
K1_BF16_PSI = K1.replace("1, float, float>", "2, float, __nv_bfloat16>")
K5 = ("void (anonymous namespace)::hop_dir_kernel<false, __nv_bfloat16>("
      "float const*, __nv_bfloat16 const*, float*, int, int, int, int, "
      "unsigned int)")


def _reader():
    cell = manifest.load_cell("wilson32-defl.flagship", ROOT)
    return manifest.metric_reader(cell, "stencil_roofline"), cell


def _mod():
    read, _ = _reader()
    return read.__globals__


@pytest.mark.parametrize("kernel,name,args,ms", [
    ("K1", K1, None, 0.300),
    ("K1", K1_BF16_PSI, None, 0.240),
    ("K5", K5.replace("__nv_bfloat16>", "float>"), None, 0.165),
    ("K2", None, 8, 1.042),
    ("K3", None, 8, 1.007),
])
def test_bounds_reproduce_perf_md(kernel, name, args, ms):
    g = _mod()
    if name is not None:
        pat = {"K1": "wilson_m_direct_kernel<",
               "K5": "hop_dir_kernel<"}[kernel]
        b = g["bound_seconds"](kernel, SITES, g["template_args"](name, pat))
    else:
        b = g["bound_seconds"](kernel, SITES, n_vec=args)
    assert round(b * 1e3, 3) == ms


def test_template_args():
    g = _mod()
    assert g["template_args"](K1, "wilson_m_direct_kernel<") == [
        "false", "false", "1", "float", "float"]
    assert g["template_args"](K5, "hop_dir_kernel<") == ["false",
                                                         "__nv_bfloat16"]


def test_reader_on_a_known_trace():
    read, cell = _reader()
    g = _mod()
    b1 = g["bound_seconds"]("K1", SITES, g["template_args"](
        K1, "wilson_m_direct_kernel<"))
    b5 = g["bound_seconds"]("K5", SITES, g["template_args"](
        K5, "hop_dir_kernel<"))
    traced = SimpleNamespace(by_kernel={
        K1: [100 * b1 / 0.5, 100],       # at half its bound
        K5: [10 * b5 / 0.8, 10],
        "some_other_kernel": [5.0, 3]})
    run = SimpleNamespace(cell=cell, traced=traced)
    want = 100 * (100 * b1 + 10 * b5) / (100 * b1 / 0.5 + 10 * b5 / 0.8)
    assert math.isclose(read(run), want)
    run.traced = None
    assert read(run) is None
