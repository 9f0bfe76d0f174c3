"""HDF5 output of loop data (port of mugiq_tpu.io.hdf5io:
write_loops_hdf5_mom, write_loops_hdf5_pos, write_loops_hdf5_pos_sharded,
assemble_loops_hdf5_pos).

Group schema of writeLoopsHDF5_Mom (loop_mugiq.cpp:529-656):

    /mom_{px:+d}_{py:+d}_{pz:+d}/<disp>/<gamma-name>/loop   float[totT, 2]

Position space (writeLoopsHDF5_Pos is unimplemented in the reference,
loop_mugiq.cpp:660-663; the JAX package's layout):

    /<disp>/<gamma-name>/loop   float[T, Z, Y, X, 2]

and, per rank of a mesh, ``<prefix>.proc<rank>.h5`` with its block of the
planar [l, 2, 16, T, Z, Y, X] array and the block's offset, which
assemble_loops_hdf5_pos puts back together.  The last axis is (real,
imag), float32 for complex64 data and float64 for complex128.

h5py is imported inside each function: a machine without it runs
everything but the file I/O.
"""

from typing import List, Sequence, Tuple

import numpy as np

from ..gamma import GAMMA_NAMES


def write_loops_hdf5_mom(filename: str,
                         data_mom: np.ndarray,
                         momenta: Sequence[Tuple[int, int, int]],
                         slot_labels: List[str]) -> None:
    """data_mom: [Nmom, nLoop, 16, totT] complex."""
    import h5py

    n_mom, n_loop, n_g, _ = data_mom.shape
    if (n_g, n_mom, n_loop) != (len(GAMMA_NAMES), len(list(momenta)),
                                len(slot_labels)):
        raise ValueError(f"data_mom shape {data_mom.shape} does not match "
                         f"{len(list(momenta))} momenta x "
                         f"{len(slot_labels)} loops x 16 gammas")
    real_dtype = np.float32 if data_mom.dtype == np.complex64 else np.float64

    with h5py.File(filename, "w") as f:
        for im, (px, py, pz) in enumerate(momenta):
            g1 = f.create_group(f"mom_{px:+d}_{py:+d}_{pz:+d}")
            for il, label in enumerate(slot_labels):
                g2 = g1.create_group(label)
                for ig, gname in enumerate(GAMMA_NAMES):
                    g3 = g2.create_group(gname)
                    series = data_mom[im, il, ig]
                    arr = np.stack([series.real, series.imag], axis=-1)
                    g3.create_dataset("loop", data=arr.astype(real_dtype))


def _check_loops(n_loop: int, n_g: int, slot_labels: List[str]) -> None:
    if (n_g, n_loop) != (len(GAMMA_NAMES), len(slot_labels)):
        raise ValueError(f"{n_loop} loops x {n_g} gammas do not match "
                         f"{len(slot_labels)} slot labels x 16 gammas")


def write_loops_hdf5_pos(filename: str, data_pos: np.ndarray,
                         slot_labels: List[str]) -> None:
    """data_pos: [nLoop, 16, T, Z, Y, X] complex (the callers write the
    g5-mapped data, as the momentum-space output)."""
    import h5py

    _check_loops(data_pos.shape[0], data_pos.shape[1], slot_labels)
    real_dtype = np.float32 if data_pos.dtype == np.complex64 else np.float64

    with h5py.File(filename, "w") as f:
        for il, label in enumerate(slot_labels):
            g2 = f.create_group(label)
            for ig, gname in enumerate(GAMMA_NAMES):
                vol = data_pos[il, ig]
                arr = np.stack([vol.real, vol.imag], axis=-1)
                g2.create_group(gname).create_dataset(
                    "loop", data=arr.astype(real_dtype))


def write_loops_hdf5_pos_sharded(path_prefix: str, block: np.ndarray,
                                 slot_labels: List[str], mesh) -> str:
    """One rank's file of a sharded position-space write (the reference's
    parallel-HDF5 hyperslabs; h5py here has no MPI-IO, so each rank writes
    its own file and assemble_loops_hdf5_pos rebuilds the serial one).

    block: the rank's [nLoop, 2, 16, Tl, Zl, Yl, X] planar block (real,
    numpy) of the global [nLoop, 2, 16, T, Z, Y, X] array; mesh: a
    parallel.mesh.LatticeMesh whose rank and origin place it (a mesh
    without a process group serves, so one process can write every
    rank's file).  Writes ``<prefix>.proc<rank>.h5`` in the JAX layout:

        /                 attrs: global_dims [T,Z,Y,X], n_loop,
                                 process_count (the mesh's ranks)
        /shard0           attrs: offset [7], shape [7] (global hyperslab)
        /shard0/<disp>/<gamma-name>/loop   float[Tl, Zl, Yl, X, 2]

    Returns the path written."""
    import h5py

    n_loop, two, n_g = block.shape[:3]
    if two != 2:
        raise ValueError(f"block shape {block.shape}: axis 1 must be re/im")
    _check_loops(n_loop, n_g, slot_labels)
    X, Y, Z, T = mesh.dims
    want = (mesh.local["t"], mesh.local["z"], mesh.local["y"], X)
    if tuple(block.shape[3:]) != want:
        raise ValueError(f"block shape {block.shape} is not rank "
                         f"{mesh.rank}'s block {want} of the mesh "
                         f"{mesh.mesh_shape}")
    path = f"{path_prefix}.proc{mesh.rank}.h5"
    off = [0, 0, 0, mesh.origin["t"], mesh.origin["z"], mesh.origin["y"], 0]
    with h5py.File(path, "w") as f:
        f.attrs["global_dims"] = np.asarray((T, Z, Y, X), dtype=np.int64)
        f.attrs["n_loop"] = n_loop
        f.attrs["process_count"] = mesh.world
        grp = f.create_group("shard0")
        grp.attrs["offset"] = np.asarray(off, dtype=np.int64)
        grp.attrs["shape"] = np.asarray(block.shape, dtype=np.int64)
        for il, label in enumerate(slot_labels):
            g2 = grp.create_group(label)
            for ig, gname in enumerate(GAMMA_NAMES):
                g2.create_group(gname).create_dataset(
                    "loop", data=np.ascontiguousarray(
                        np.moveaxis(block[il, :, ig], 0, -1)))
    return path


def assemble_loops_hdf5_pos(path_prefix: str, out_filename: str,
                            slot_labels: List[str]) -> np.ndarray:
    """The serial position-space array [nLoop, 16, T, Z, Y, X] (complex64,
    as the sharded writers' production data) from every
    ``<prefix>.proc*.h5`` file, each holding one or more ``shard*`` groups
    (one per rank here; one per device of its mesh from the JAX package's
    single-process writer), and, with out_filename, its serial file
    (write_loops_hdf5_pos)."""
    import glob

    import h5py

    files = sorted(glob.glob(f"{path_prefix}.proc*.h5"))
    if not files:
        raise FileNotFoundError(f"no shard files at {path_prefix}.proc*.h5")
    with h5py.File(files[0], "r") as f:
        T, Z, Y, X = (int(v) for v in f.attrs["global_dims"])
        n_loop = int(f.attrs["n_loop"])
        n_proc = int(f.attrs["process_count"])
    if len(files) != n_proc:
        raise ValueError(f"{len(files)} shard files at {path_prefix} but "
                         f"the writers had {n_proc} processes")
    _check_loops(n_loop, len(GAMMA_NAMES), slot_labels)

    full = np.zeros((n_loop, len(GAMMA_NAMES), T, Z, Y, X),
                    dtype=np.complex64)
    for path in files:
        with h5py.File(path, "r") as f:
            for key in f.keys():
                if not key.startswith("shard"):
                    continue
                grp = f[key]
                # the offset covers the whole planar [l, 2, 16, T, Z, Y, X]
                # array: every lattice axis, so (t, z, y) meshes assemble
                off = [int(v) for v in grp.attrs["offset"]]
                t0, z0, y0, x0 = (off + [0] * 7)[3:7]
                for il, label in enumerate(slot_labels):
                    for ig, gname in enumerate(GAMMA_NAMES):
                        blk = np.asarray(grp[label][gname]["loop"])
                        lt, lz, ly, lx = blk.shape[:4]
                        full[il, ig, t0:t0 + lt, z0:z0 + lz, y0:y0 + ly,
                             x0:x0 + lx] = blk[..., 0] + 1j * blk[..., 1]
    if out_filename:
        write_loops_hdf5_pos(out_filename, full, slot_labels)
    return full
