"""Position-space loop output of the port (io.hdf5io write_loops_hdf5_pos,
write_loops_hdf5_pos_sharded, assemble_loops_hdf5_pos; the API and
production paths' writers) against the JAX package's, on the CPU.

Files are compared as trees: the same group and dataset names in the same
order, equal dtypes, and the data bit for bit where both sides write the
same numbers.  The per-rank files of a mesh are written in one process,
rank by rank, with a LatticeMesh of that rank (no process group; the
gloo launch of tests/test_torch_mesh.py writes them from real ranks).
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mugiq_tpu.io import hdf5io as jio

from mugiq_tpu_torch import api
from mugiq_tpu_torch.io import hdf5io as io
from mugiq_tpu_torch.io.gauge_io import load_gauge_np
from mugiq_tpu_torch.lattice import LatticeGeometry
from mugiq_tpu_torch.parallel.mesh import LatticeMesh
from mugiq_tpu_torch.params import (EigParam, GaugeParam, InvertParam,
                                    LoopParam)
from mugiq_tpu_torch.production import compute_loop_production

torch.set_num_threads(2)

LABELS = ["disp_0", "disp_+z_1", "disp_+z_2"]
# (X, Y, Z, T): every extent distinct, so no axis can stand in for another
DIMS = (2, 4, 6, 8)


def planar(seed, dims=DIMS, dtype=np.float32):
    X, Y, Z, T = dims
    rng = np.random.default_rng(seed)
    return rng.standard_normal((len(LABELS), 2, 16, T, Z, Y, X)).astype(
        dtype)


def assert_same_tree(a_path, b_path):
    """The same names in the same order, equal dtypes and shapes, the data
    bit for bit."""
    with h5py.File(a_path) as a, h5py.File(b_path) as b:
        na, nb = [], []
        a.visit(na.append)
        b.visit(nb.append)
        assert na == nb and na
        for n in na:
            if isinstance(a[n], h5py.Dataset):
                assert a[n].dtype == b[n].dtype, n
                assert a[n][()].tobytes() == b[n][()].tobytes(), n
            assert sorted(a[n].attrs) == sorted(b[n].attrs), n
            for k in a[n].attrs:
                assert np.array_equal(a[n].attrs[k], b[n].attrs[k]), (n, k)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_serial_writer_matches_jax(tmp_path, dtype):
    d = planar(1, dtype=np.float64)
    data = (d[:, 0] + 1j * d[:, 1]).astype(dtype)
    io.write_loops_hdf5_pos(str(tmp_path / "port.h5"), data, LABELS)
    jio.write_loops_hdf5_pos(str(tmp_path / "jax.h5"), data, LABELS)
    assert_same_tree(tmp_path / "port.h5", tmp_path / "jax.h5")
    with h5py.File(tmp_path / "port.h5") as f:
        loop = f["disp_+z_1/g5/loop"]
        assert loop.shape == (8, 6, 4, 2, 2)
        assert loop.dtype == (np.float32 if dtype == np.complex64
                              else np.float64)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 3), (2, 3, 2)],
                         ids=["t", "tz", "tzy"])
def test_rank_files_assemble_in_jax(tmp_path, mesh_shape):
    """The port's per-rank files, assembled by the JAX assembler, give the
    JAX serial file of the same data; the port's assembler gives it too."""
    d = planar(2)
    full = d[:, 0] + 1j * d[:, 1]
    prefix = str(tmp_path / "pos")
    mesh = LatticeMesh(mesh_shape, DIMS, device="cpu")
    paths = []
    for r in range(mesh.world):
        m = LatticeMesh(mesh_shape, DIMS, rank=r, device="cpu")
        o, lo = m.origin, m.local
        blk = d[:, :, :, o["t"]:o["t"] + lo["t"], o["z"]:o["z"] + lo["z"],
                o["y"]:o["y"] + lo["y"]]
        paths.append(io.write_loops_hdf5_pos_sharded(prefix, blk, LABELS, m))
    assert paths == [f"{prefix}.proc{r}.h5" for r in range(mesh.world)]
    with h5py.File(paths[-1]) as f:
        assert int(f.attrs["process_count"]) == mesh.world
        assert list(f.attrs["global_dims"]) == [8, 6, 4, 2]
    jio.write_loops_hdf5_pos(str(tmp_path / "serial.h5"), full, LABELS)
    got = jio.assemble_loops_hdf5_pos(prefix, str(tmp_path / "jax_asm.h5"),
                                      LABELS)
    assert got.tobytes() == full.astype(np.complex64).tobytes()
    assert_same_tree(tmp_path / "jax_asm.h5", tmp_path / "serial.h5")
    mine = io.assemble_loops_hdf5_pos(prefix, str(tmp_path / "asm.h5"),
                                      LABELS)
    assert mine.dtype == np.complex64 and np.array_equal(mine, full)
    assert_same_tree(tmp_path / "asm.h5", tmp_path / "serial.h5")
    with pytest.raises(ValueError, match="not rank 1's block"):
        io.write_loops_hdf5_pos_sharded(prefix, d, LABELS,
                                        LatticeMesh(mesh_shape, DIMS, rank=1,
                                                    device="cpu"))


def test_assembler_reads_jax_mesh_file(tmp_path):
    """A file of the JAX writer on its 8-virtual-device (t, z, y) mesh (one
    process, eight shard groups): the port's assembler returns the JAX
    assembler's array."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    d = planar(3)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                ("t", "z", "y"))
    arr = jax.device_put(jnp.asarray(d), NamedSharding(
        mesh, P(None, None, None, "t", "z", "y")))
    prefix = str(tmp_path / "jpos")
    jio.write_loops_hdf5_pos_sharded(prefix, arr, LABELS)
    with h5py.File(f"{prefix}.proc0.h5") as f:
        assert sorted(k for k in f if k.startswith("shard")) == [
            f"shard{k}" for k in range(8)]
    ref = jio.assemble_loops_hdf5_pos(prefix, "", LABELS)
    got = io.assemble_loops_hdf5_pos(prefix, "", LABELS)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    assert np.array_equal(got, d[:, 0] + 1j * d[:, 1])


API_DIMS = (4, 4, 4, 4)
API_EIG = dict(n_ev=4, n_kr=16, tol=1e-10, max_restarts=200,
               use_poly_acc=True, poly_deg=8, a_min=0.09, check_interval=2)
DISP = ["+z:1,2"]


def test_api_pos_file_matches_jax(tmp_path):
    """api.compute_loop with write_pos_space_hdf5 at 4^4 (complex128) writes
    the JAX api.compute_loop's file: the same tree and dtypes, the data
    within 1e-8 of its max (each side converged from its own start
    vector); the data is the g5-mapped data_pos."""
    from mugiq_tpu import api as japi
    from mugiq_tpu import params as jp
    from mugiq_tpu_torch.phase import map_gamma_g5

    U = load_gauge_np("weak:0.5", LatticeGeometry(API_DIMS), seed=1)
    jh5, h5 = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    japi.compute_loop(jnp.asarray(U), jp.GaugeParam(dims=API_DIMS),
                      jp.InvertParam(kappa=0.13), jp.EigParam(**API_EIG),
                      jp.LoopParam(do_nonlocal=True, disp_entries=DISP,
                                   write_pos_space_hdf5=True,
                                   fname_pos_h5=jh5))
    got, _ = api.compute_loop(
        U, GaugeParam(dims=API_DIMS), InvertParam(kappa=0.13),
        EigParam(**API_EIG), LoopParam(do_nonlocal=True, disp_entries=DISP,
                                       write_pos_space_hdf5=True,
                                       fname_pos_h5=h5),
        dtype=torch.complex128, device="cpu")
    mapped = map_gamma_g5(got.data_pos).numpy()
    with h5py.File(h5) as a, h5py.File(jh5) as b:
        na, nb = [], []
        a.visit(na.append)
        b.visit(nb.append)
        assert na == nb
        scale = max(np.abs(b[f"{label}/{g}/loop"][()]).max()
                    for label in b for g in b[label])
        for il, label in enumerate(["disp_0", "disp_+z_1", "disp_+z_2"]):
            for ig, g in enumerate(io.GAMMA_NAMES):
                x, y = a[f"{label}/{g}/loop"][()], b[f"{label}/{g}/loop"][()]
                assert x.dtype == y.dtype == np.float64
                assert np.abs(x - y).max() <= 1e-8 * scale
                v = mapped[il, ig]
                assert np.array_equal(x, np.stack([v.real, v.imag], -1))
    with pytest.raises(ValueError, match="fname_pos_h5 empty"):
        api.compute_loop(U, GaugeParam(dims=API_DIMS),
                         InvertParam(kappa=0.13), EigParam(n_ev=2, n_kr=8),
                         LoopParam(write_pos_space_hdf5=True), device="cpu")


def test_production_keep_pos_is_the_written_file(tmp_path):
    """compute_loop_production with keep_pos and write_pos_space_hdf5: the
    g5-mapped data_pos it returns is the file's data, bit for bit."""
    from mugiq_tpu_torch.phase import map_gamma_g5

    dims = (4, 4, 4, 8)
    h5 = str(tmp_path / "pos.h5")
    res = compute_loop_production(
        load_gauge_np("weak:0.5", LatticeGeometry(dims), seed=1),
        GaugeParam(dims=dims), InvertParam(kappa=0.13),
        EigParam(n_ev=2, n_kr=12, tol=1e-5, max_restarts=10),
        LoopParam(momenta=[(0, 0, 0), (1, 0, 0)], do_nonlocal=True,
                  disp_entries=["-t:1"], write_pos_space_hdf5=True,
                  fname_pos_h5=h5),
        keep_pos=True, device="cpu")
    assert res.data_pos.shape == (2, 16, 8, 4, 4, 4)
    assert res.data_pos.dtype == np.complex64
    mapped = map_gamma_g5(torch.from_numpy(res.data_pos)).numpy()
    with h5py.File(h5) as f:
        for il, label in enumerate(["disp_0", "disp_-t_1"]):
            for ig, g in enumerate(io.GAMMA_NAMES):
                v = mapped[il, ig]
                want = np.stack([v.real, v.imag], -1)
                got = f[f"{label}/{g}/loop"][()]
                assert got.dtype == np.float32
                assert got.tobytes() == want.tobytes()
