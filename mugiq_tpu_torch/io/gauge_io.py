"""Gauge configurations and eigenvector checkpoints: NERSC reader, host
gauge factory (NERSC or ILDG files), plaquette, evec save/load (port of
mugiq_tpu.io.gauge_io load_gauge_np / read_nersc_gauge / save_evecs /
load_evecs and of fields._project_su3 / plaquette_np).

Gauge fields are complex numpy arrays U[4, T, Z, Y, X, 3, 3]; the
production path converts them to the kernel layout itself.
"""

from typing import Dict, Tuple

import numpy as np
import torch

from ..lattice import LatticeGeometry
from .lime_io import LIME_MAGIC, read_ildg_gauge

_HDR_BEGIN = b"BEGIN_HEADER"
_HDR_END = b"END_HEADER"


def _project_su3(m: np.ndarray) -> np.ndarray:
    """Project a batch of complex 3x3 matrices onto SU(3) via QR + phase fix."""
    q, r = np.linalg.qr(m)
    # real-positive diagonal of R makes Q Haar-distributed in U(3)
    d = np.einsum("...ii->...i", r)
    ph = d / np.abs(d)
    q = q * ph[..., None, :].conj()
    # remove the overall det phase -> SU(3)
    det = np.linalg.det(q)
    q = q * (det.conj() ** (1.0 / 3.0)
             / np.abs(det) ** (1.0 / 3.0))[..., None, None]
    return q


def _third_row(u2: np.ndarray) -> np.ndarray:
    """Reconstruct row 3 of SU(3) from rows 1,2: r3 = (r1 x r2)^*."""
    r1, r2 = u2[..., 0, :], u2[..., 1, :]
    r3 = np.cross(r1, r2).conj()
    return np.concatenate([u2, r3[..., None, :]], axis=-2)


def read_nersc_gauge(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """Read a NERSC archive config -> (U[4, T, Z, Y, X, 3, 3], header)."""
    with open(path, "rb") as f:
        line = f.readline()
        if line.strip() != _HDR_BEGIN:
            raise ValueError(
                f"{path}: not a NERSC archive (missing BEGIN_HEADER)")
        header: Dict[str, str] = {}
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated header")
            if line.strip() == _HDR_END:
                break
            if b"=" in line:
                k, v = line.decode("ascii", "replace").split("=", 1)
                header[k.strip()] = v.strip()
        data = f.read()

    Lx, Ly, Lz, Lt = (int(header[f"DIMENSION_{i}"]) for i in (1, 2, 3, 4))
    datatype = header.get("DATATYPE", "4D_SU3_GAUGE")
    fp = header.get("FLOATING_POINT", "IEEE32BIG")
    dts = {"IEEE32": ">f4", "IEEE32BIG": ">f4", "IEEE32LITTLE": "<f4",
           "IEEE64": ">f8", "IEEE64BIG": ">f8", "IEEE64LITTLE": "<f8"}
    if fp not in dts:
        raise ValueError(f"{path}: unsupported FLOATING_POINT {fp}")
    dt = np.dtype(dts[fp])
    rows = {"4D_SU3_GAUGE": 2, "4D_SU3_GAUGE_3x3": 3}.get(datatype)
    if rows is None:
        raise ValueError(f"{path}: unsupported DATATYPE {datatype}")

    vol = Lx * Ly * Lz * Lt
    n_real = vol * 4 * rows * 3 * 2
    raw = np.frombuffer(data, dtype=dt, count=n_real).astype(np.float64)
    cplx = raw[0::2] + 1j * raw[1::2]
    # file order: site (x fastest) -> mu -> row -> col
    u = cplx.reshape(Lt, Lz, Ly, Lx, 4, rows, 3)
    if rows == 2:
        u = _third_row(u)
    U = np.moveaxis(u, 4, 0)    # [4, T, Z, Y, X, 3, 3]

    # NERSC checksum: uint32 sum of all data words
    if "CHECKSUM" in header:
        words = np.frombuffer(data[:raw.size * dt.itemsize], dtype=dt)
        u32 = words.astype(dt.newbyteorder("=")).view(
            np.uint32 if dt.itemsize == 4 else np.uint64)
        if dt.itemsize == 8:
            u32 = u32.view(np.uint32)
        chk = np.uint32(np.sum(u32, dtype=np.uint64) & 0xFFFFFFFF)
        want = int(header["CHECKSUM"], 16)
        if int(chk) != want:
            raise ValueError(
                f"{path}: checksum mismatch {int(chk):08x} != {want:08x}")
    return U, header


def load_gauge_np(spec: str, geom: LatticeGeometry,
                  seed: int = 0) -> np.ndarray:
    """Host gauge factory: 'unit' | 'random' | 'weak[:eps]' | a path to a
    NERSC or an ILDG (LIME) file, told apart by the LIME magic.

    'random' and 'weak' draw from numpy's default_rng(seed) exactly as the
    JAX package does, so both packages build the same field."""
    shape = (4, *geom.shape_tzyx, 3, 3)
    if spec == "unit":
        return np.broadcast_to(np.eye(3, dtype=np.complex128), shape).copy()
    if spec == "random":
        rng = np.random.default_rng(seed)
        m = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return _project_su3(m)
    if spec.startswith("weak"):
        eps = float(spec.split(":")[1]) if ":" in spec else 0.1
        rng = np.random.default_rng(seed)
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        h = 0.5 * (a + np.conj(np.swapaxes(a, -1, -2)))
        tr = np.einsum("...ii->...", h) / 3.0
        h = h - tr[..., None, None] * np.eye(3)
        w, v = np.linalg.eigh(h)
        return np.einsum("...ab,...b,...cb->...ac", v, np.exp(1j * eps * w),
                         np.conj(v))
    with open(spec, "rb") as f:
        magic = f.read(4)
    if int.from_bytes(magic, "big") == LIME_MAGIC:
        U, _ = read_ildg_gauge(spec)
    else:
        U, _ = read_nersc_gauge(spec)
    dims = (U.shape[4], U.shape[3], U.shape[2], U.shape[1])
    if dims != geom.dims:
        raise ValueError(f"gauge file dims {dims} != requested {geom.dims}")
    return U


def plaquette(U_np: np.ndarray, device="cuda") -> tuple:
    """Average plaquette (total, spatial, temporal), 1 at U = 1 (plaqQuda,
    tests/loop.cpp:895-898), computed in complex128 on `device`."""
    u = torch.from_numpy(np.ascontiguousarray(U_np, np.complex128)).to(device)

    def roll(a, mu):
        return torch.roll(a, -1, dims={0: 3, 1: 2, 2: 1, 3: 0}[mu])

    spatial, temporal = [], []
    for mu in range(4):
        for nu in range(mu + 1, 4):
            # Tr[U_mu(x) U_nu(x+mu) U_mu(x+nu)^dag U_nu(x)^dag]
            left = u[mu] @ roll(u[nu], mu)
            right = u[nu] @ roll(u[mu], nu)
            tr = torch.einsum("...ab,...ab->...", left, right.conj())
            p = float(tr.real.mean()) / 3.0
            (temporal if nu == 3 else spatial).append(p)
    sp = sum(spatial) / len(spatial)
    tm = sum(temporal) / len(temporal)
    return (sp + tm) / 2.0, sp, tm


def save_evecs(path: str, evecs, evals, sigma=None, resids=None,
               attrs: Dict[str, str] = None) -> None:
    """Eigenvector checkpoint (vec_outfile analog): HDF5 datasets evecs,
    evals and, where given, sigma and resids; `attrs` as file attributes.
    The same layout as the JAX package writes."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("evecs", data=np.asarray(evecs))
        f.create_dataset("evals", data=np.asarray(evals))
        if sigma is not None:
            f.create_dataset("sigma", data=np.asarray(sigma))
        if resids is not None:
            f.create_dataset("resids", data=np.asarray(resids))
        for k, v in (attrs or {}).items():
            f.attrs[k] = v


def load_evecs(path: str):
    """-> (evecs, evals, sigma or None, resids or None, attrs)."""
    import h5py

    with h5py.File(path, "r") as f:
        evecs = f["evecs"][:]
        evals = f["evals"][:]
        sigma = f["sigma"][:] if "sigma" in f else None
        resids = f["resids"][:] if "resids" in f else None
        attrs = dict(f.attrs)
    return evecs, evals, sigma, resids, attrs
