"""Host-side pieces of mugiq_tpu_torch against the JAX package: layouts,
gauge factory, NERSC and ILDG readers, plaquette, clover blocks, gamma
tables, parameter parsing.  All exact (the same numpy code on the same inputs)
unless a tolerance is stated.  Also: the package imports no JAX and pins
full-f32 GEMMs."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu_torch import clover_np, gamma, layout, params
from mugiq_tpu_torch.io import gauge_io
from mugiq_tpu_torch.lattice import LatticeGeometry

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
GEOM = LatticeGeometry((4, 6, 2, 4))       # X, Y, Z, T all distinct-ish


def _run_fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


_IMPORT_ALL = (
    "import sys, torch\n"
    "import mugiq_tpu_torch, mugiq_tpu_torch.production, "
    "mugiq_tpu_torch.cli.loop, mugiq_tpu_torch.cli.eigensolve, "
    "mugiq_tpu_torch.layout, mugiq_tpu_torch.schur_kernel, "
    "mugiq_tpu_torch.kernels.parity, mugiq_tpu_torch.kernels.hop_dir, "
    "mugiq_tpu_torch.mg, mugiq_tpu_torch.io.gauge_io, "
    "mugiq_tpu_torch.io.lime_io, mugiq_tpu_torch.io.hdf5io, "
    "mugiq_tpu_torch.parallel.mesh, mugiq_tpu_torch.parallel.distributed, "
    "mugiq_tpu_torch.parallel.halo, mugiq_tpu_torch.parallel.shard_dslash, "
    "mugiq_tpu_torch.parallel.shard_op, mugiq_tpu_torch.api, "
    "mugiq_tpu_torch.fields, mugiq_tpu_torch.ops.dslash, "
    "mugiq_tpu_torch.ops.contract, mugiq_tpu_torch.clover, "
    "mugiq_tpu_torch.dirac, mugiq_tpu_torch.schur, "
    "mugiq_tpu_torch.solvers, mugiq_tpu_torch.displace, "
    "mugiq_tpu_torch.eig.lanczos, mugiq_tpu_torch.eig.arnoldi, "
    "mugiq_tpu_torch.eig.eigsolve, mugiq_tpu_torch.mg.setup, "
    "mugiq_tpu_torch.mg.coarse, mugiq_tpu_torch.mg.mg, "
    "mugiq_tpu_torch.mg.coarse_loop, mugiq_tpu_torch.stochastic, "
    "mugiq_tpu_torch.stochastic_production, chip_smoke\n")


def test_import_leaves_jax_out():
    out = _run_fresh(_IMPORT_ALL + "print('jax' in sys.modules, "
                     "'mugiq_tpu' in sys.modules, 'h5py' in sys.modules)")
    assert out.split() == ["False", "False", "False"]


def test_sources_import_no_jax():
    """No import statement of the port or of chip_smoke.py, at any level,
    names jax or the JAX package."""
    files = sorted((REPO / "mugiq_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "mugiq_tpu"), \
                    f"{path.relative_to(REPO)} imports {name}"


def test_import_pins_full_f32():
    """TF32 keeps ~3 digits: the Krylov GEMMs must run in full f32."""
    out = _run_fresh(_IMPORT_ALL + "print(torch.backends.cuda.matmul."
                     "allow_tf32, torch.backends.cudnn.allow_tf32, "
                     "torch.get_float32_matmul_precision())")
    assert out.split() == ["False", "False", "highest"]


def test_gamma_tables_match_jax():
    from mugiq_tpu import gamma as jg
    from mugiq_tpu.ops.contract import _gamma_flat_np
    from mugiq_tpu.ops.dslash import _projector_decomp

    assert gamma.GAMMA_NAMES == jg.GAMMA_NAMES
    np.testing.assert_array_equal(gamma.gamma_basis(), jg.gamma_basis())
    np.testing.assert_array_equal(gamma.sigma_munu(), jg.sigma_munu())
    np.testing.assert_array_equal(gamma.gamma_map_sign(), jg.gamma_map_sign())
    np.testing.assert_array_equal(gamma.gamma_map_index(),
                                  jg.gamma_map_index())
    np.testing.assert_array_equal(gamma.gamma_flat(), _gamma_flat_np())
    ref = _projector_decomp()
    for key, (q, r) in gamma.projector_decomp().items():
        np.testing.assert_array_equal(q, ref[key][0])
        np.testing.assert_array_equal(r, ref[key][1])


def test_cuda_projector_tables_are_wilson_projectors():
    """The unit-phase tables baked into hop_common.cuh, which K1 and K6
    include, rebuild 1 -/+ g_mu exactly, and are _projector_decomp's rows
    scaled by sqrt(2)."""
    csrc = REPO / "mugiq_tpu_torch/kernels/csrc"
    for kernel in ("wilson_m.cu", "parity_hop.cu"):
        assert '#include "hop_common.cuh"' in (csrc / kernel).read_text()
    src = (csrc / "hop_common.cuh").read_text()
    rows = re.findall(r"ProjTab\{\{\{(\d), (\d)\}, \{(\d), (\d)\}\}, "
                      r"\{\{(\d), (\d)\}, \{(\d), (\d)\}\}, "
                      r"\{(\d), (\d), (\d), (\d)\}, "
                      r"\{(\d), (\d), (\d), (\d)\}\}", src)
    assert len(rows) == 8
    ph = np.array([1, 1j, -1, -1j])
    g = gamma.gamma_matrices()
    dec = gamma.projector_decomp()
    for n, row in enumerate(rows):
        mu, f = n // 2, n % 2
        v = [int(x) for x in row]
        Q = np.zeros((2, 4), complex)
        R = np.zeros((4, 2), complex)
        for h in range(2):
            for k in range(2):
                Q[h, v[2 * h + k]] = ph[v[4 + 2 * h + k]]
        for s in range(4):
            R[s, v[8 + s]] = ph[v[12 + s]]
        P = np.eye(4) + (-1.0 if f == 0 else 1.0) * g[mu]
        np.testing.assert_array_equal(R @ Q, P)
        q, r = dec[(mu, "fwd" if f == 0 else "bwd")]
        np.testing.assert_allclose(Q, np.sqrt(2) * q, atol=1e-15)
        np.testing.assert_allclose(R, r / np.sqrt(2), atol=1e-15)


def test_layouts_match_jax():
    import mugiq_tpu.pallas.dslash_kernel as dk
    from mugiq_tpu.production import _planar_gauge_np

    X, Y, Z, T = GEOM.dims
    p = np.random.default_rng(0).standard_normal((2, 4, 3, T, Z, Y, X))
    k_ref = np.asarray(dk.to_kernel_spinor(jnp.asarray(p)))
    k = layout.to_kernel_spinor(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(k, k_ref)
    np.testing.assert_array_equal(
        layout.from_kernel_spinor(torch.from_numpy(k), Y).numpy(), p)

    U = gauge_io.load_gauge_np("random", GEOM, seed=3)
    for ap, aniso in ((True, 1.0), (False, 1.0), (True, 2.5)):
        pl_ref = _planar_gauge_np(U, ap, aniso)
        np.testing.assert_array_equal(layout.planar_gauge_np(U, ap, aniso),
                                      pl_ref)
        uk_ref = np.asarray(dk.to_kernel_gauge(jnp.asarray(pl_ref)))
        np.testing.assert_array_equal(layout.kernel_gauge_np(U, ap, aniso),
                                      uk_ref)
        np.testing.assert_array_equal(
            layout.to_kernel_gauge(torch.from_numpy(pl_ref)).numpy(), uk_ref)


@pytest.mark.parametrize("spec", ["unit", "random", "weak:0.3"])
def test_gauge_factory_matches_jax(spec):
    from mugiq_tpu.io.gauge_io import load_gauge_np

    np.testing.assert_array_equal(
        gauge_io.load_gauge_np(spec, GEOM, seed=5),
        load_gauge_np(spec, GEOM, seed=5))


@pytest.mark.parametrize("three_row", [True, False])
def test_nersc_reader_matches_jax(tmp_path, three_row):
    from mugiq_tpu.io.gauge_io import read_nersc_gauge, write_nersc_gauge

    U = gauge_io.load_gauge_np("random", GEOM, seed=7)
    path = tmp_path / "cfg.nersc"
    write_nersc_gauge(str(path), U, three_row=three_row)
    got, hdr = gauge_io.read_nersc_gauge(str(path))
    ref, hdr_ref = read_nersc_gauge(str(path))
    np.testing.assert_array_equal(got, ref)
    assert hdr == hdr_ref
    np.testing.assert_array_equal(
        gauge_io.load_gauge_np(str(path), GEOM), ref)
    with pytest.raises(ValueError, match="dims"):
        gauge_io.load_gauge_np(str(path), LatticeGeometry((4, 4, 4, 4)))


@pytest.mark.parametrize("double", [True, False])
def test_ildg_reader_matches_jax(tmp_path, double):
    """An ILDG file written by the JAX package reads the same through both
    load_gauge_np (the LIME magic selects the reader); the port's writer
    gives the same bytes."""
    from mugiq_tpu.io.gauge_io import load_gauge_np
    from mugiq_tpu.io.lime_io import write_ildg_gauge
    from mugiq_tpu_torch.io import lime_io

    U = gauge_io.load_gauge_np("random", GEOM, seed=8)
    path = tmp_path / "cfg.lime"
    write_ildg_gauge(str(path), U, double=double)
    got = gauge_io.load_gauge_np(str(path), GEOM)
    np.testing.assert_array_equal(got, load_gauge_np(str(path), GEOM))
    if double:
        np.testing.assert_array_equal(got, U)
    mine = tmp_path / "mine.lime"
    lime_io.write_ildg_gauge(str(mine), U, double=double)
    assert mine.read_bytes() == path.read_bytes()
    with pytest.raises(ValueError, match="dims"):
        gauge_io.load_gauge_np(str(path), LatticeGeometry((4, 4, 4, 4)))


def test_plaquette_matches_jax():
    """complex128 sums in another order: 1e-12."""
    from mugiq_tpu.fields import plaquette_np

    U = gauge_io.load_gauge_np("weak:0.4", GEOM, seed=2)
    np.testing.assert_allclose(gauge_io.plaquette(U, device="cpu"),
                               plaquette_np(U), rtol=1e-12)
    unit = gauge_io.load_gauge_np("unit", GEOM)
    np.testing.assert_allclose(gauge_io.plaquette(unit, device="cpu"),
                               (1.0, 1.0, 1.0), rtol=1e-14)


def test_clover_blocks_match_jax():
    from mugiq_tpu import clover_np as jc

    U = gauge_io.load_gauge_np("weak:0.4", GEOM, seed=4)
    A = clover_np.clover_field_np(U, 0.12, 1.3)
    np.testing.assert_array_equal(A, jc.clover_field_np(U, 0.12, 1.3))
    np.testing.assert_array_equal(clover_np.clover_chiral_blocks_np(A),
                                  jc.clover_chiral_blocks_np(A))


@pytest.mark.parametrize("entry", ["+z:1,8", "-x:3", "+t:4,2", "-y:1"])
def test_disp_entry_parse_matches_jax(entry):
    from mugiq_tpu.displace import parse_disp_str
    from mugiq_tpu.params import parse_disp_entry

    assert params.parse_disp_entry(entry) == parse_disp_entry(entry)
    d = entry.split(":")[0]
    assert params.parse_disp_str(d) == parse_disp_str(d)


@pytest.mark.parametrize("bad", ["+q:1", "z:1", "+z:", "+z:1,2,3", "+z"])
def test_disp_entry_parse_rejects(bad):
    with pytest.raises(ValueError):
        params.parse_disp_entry(bad)


def test_loop_slots_match_jax():
    from mugiq_tpu.loop import LoopComputeParam as JL
    from mugiq_tpu.params import LoopParam as JLP
    from mugiq_tpu_torch.loop import LoopComputeParam

    kw = dict(momenta=[(0, 0, 0), (1, 0, 0)], do_nonlocal=True,
              disp_entries=["+z:1,3", "-t:2"])
    got = LoopComputeParam.build(GEOM, params.LoopParam(**kw))
    from mugiq_tpu.lattice import LatticeGeometry as JG
    ref = JL.build(JG(GEOM.dims), JLP(**kw))
    assert got.slot_labels() == ref.slot_labels()
    assert (got.n_loop, got.n_loop_offset, got.n_loop_per_entry) == \
        (ref.n_loop, ref.n_loop_offset, ref.n_loop_per_entry)


def test_cuda_request_without_cuda_raises(monkeypatch):
    from mugiq_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_reject_other_devices():
    from mugiq_tpu_torch.kernels.contract import (covariant_displace,
                                                  loop_contract)
    from mugiq_tpu_torch.kernels.wilson import wilson_m

    m = torch.device("meta")
    psi = torch.empty((2, 24, 2, 4), device=m)
    with pytest.raises(ValueError, match="no kernel"):
        wilson_m(psi, torch.empty((2, 4, 18, 2, 4), device=m), None, 0.1,
                 False, 2)
    b = torch.empty((1, 2, 24, 2, 4), device=m)
    with pytest.raises(ValueError, match="no kernel"):
        loop_contract(b, b, torch.empty((1,), device=m))
    with pytest.raises(ValueError, match="no kernel"):
        covariant_displace(b, torch.empty((2, 4, 18, 2, 4), device=m), 0, 1,
                           2)
    from mugiq_tpu_torch.kernels.parity import parity_hop_halo
    from mugiq_tpu_torch.kernels.wilson import wilson_m_halo
    pe = torch.empty((4, 24, 2, 4), device=m)
    u = torch.empty((2, 4, 18, 2, 4), device=m)
    ut = torch.empty((2, 18, 2, 4), device=m)
    with pytest.raises(ValueError, match="no kernel"):
        wilson_m_halo(pe, u, ut, None, 0.1, False, 2, False, False)
    with pytest.raises(ValueError, match="no kernel"):
        parity_hop_halo(pe, u, u, ut, 2, 0, False, False, False)


def test_init_distributed_device_choice(monkeypatch):
    """A rank's device: cuda -> cuda:{LOCAL_RANK % cards}; explicit index
    and cpu stay; no launcher environment -> no group, the device as
    given."""
    from mugiq_tpu_torch.parallel import distributed as dd

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dd.rank_device("cuda", 3) == torch.device("cuda", 1)
    assert dd.rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert dd.rank_device("cpu", 3) == torch.device("cpu")
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert dd.init_distributed(device="cpu") == torch.device("cpu")
    assert dd.default_backend("cpu") == "gloo"
    assert dd.default_backend("cuda") == "nccl"


def test_device_parameters_default_to_cuda():
    """Every public function and method of the port that takes a `device`
    with a default defaults to the card: nothing runs on the CPU unless
    the caller asks for it."""
    import importlib
    import inspect
    import pkgutil

    import mugiq_tpu_torch

    def public(mod):
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) \
                    != mod.__name__:
                continue
            if inspect.isfunction(obj):
                yield f"{mod.__name__}.{name}", obj
            elif inspect.isclass(obj):
                for mname, m in vars(obj).items():
                    m = getattr(m, "__func__", m)
                    if not mname.startswith("_") and inspect.isfunction(m):
                        yield f"{mod.__name__}.{name}.{mname}", m

    defaults = {}
    for info in pkgutil.walk_packages(mugiq_tpu_torch.__path__,
                                      "mugiq_tpu_torch."):
        mod = importlib.import_module(info.name)
        for qual, fn in public(mod):
            p = inspect.signature(fn).parameters.get("device")
            if p is not None and p.default is not inspect.Parameter.empty:
                defaults[qual] = p.default
    assert {"mugiq_tpu_torch.io.gauge_io.plaquette",
            "mugiq_tpu_torch.phase.phase_matrix_planar",
            "mugiq_tpu_torch.mg.rc_mg.MGEnvRC.load",
            "mugiq_tpu_torch.parallel.distributed.init_distributed",
            "mugiq_tpu_torch.parallel.mesh.make_lattice_mesh",
            "mugiq_tpu_torch.production.compute_evecs_production"} \
        <= set(defaults)
    assert {k: v for k, v in defaults.items() if v != "cuda"} == {}
