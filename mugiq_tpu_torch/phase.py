"""g5 output map and momentum projection: the planar real-pair forms of
the production path (port of mugiq_tpu.planar.phase.map_gamma_g5_planar /
phase_matrix_planar and production.momentum_project_production) and the
complex full-layout forms of the API path (port of mugiq_tpu.ops.phase).

    phase(x, p) = exp(i ft_sign 2 pi sum_d p_d x_d / L_d)
    dataMom[l, g, t, p] = sum_{z,y,x} dataPos[l, g, t, z, y, x] phase(x, p)
"""

import numpy as np
import torch

from .gamma import gamma_map_index, gamma_map_sign


def map_gamma_g5_planar(data: torch.Tensor) -> torch.Tensor:
    """data [l, 2, 16, T, Z, Y, X]: the G -> g5 G remap and sign on the
    gamma axis."""
    inv = np.argsort(gamma_map_index())
    s = torch.as_tensor(gamma_map_sign()[inv], dtype=data.dtype,
                        device=data.device)
    idx = torch.as_tensor(inv, device=data.device)
    return data[:, :, idx] * s.reshape(1, 1, 16, 1, 1, 1, 1)


def _phases_np(geom, momenta, ft_sign) -> np.ndarray:
    """exp(i ft_sign 2 pi p.x / L) as complex128 [Z, Y, X, P]."""
    mom = np.asarray(list(momenta), dtype=np.int64).reshape(-1, 3)
    Lx, Ly, Lz, _ = geom.dims
    z, y, x = np.meshgrid(np.arange(Lz), np.arange(Ly), np.arange(Lx),
                          indexing="ij")
    phi = (mom[:, 0][:, None, None, None] * x[None] / Lx
           + mom[:, 1][:, None, None, None] * y[None] / Ly
           + mom[:, 2][:, None, None, None] * z[None] / Lz)
    return np.moveaxis(np.exp(1j * int(ft_sign) * 2.0 * np.pi * phi), 0, -1)


def phase_matrix_planar(geom, momenta, ft_sign, device="cuda",
                        dtype=torch.float32) -> torch.Tensor:
    """Host-built phases exp(i ft_sign 2 pi p.x / L) as [2, Z, Y, X, P]."""
    ph = _phases_np(geom, momenta, ft_sign)
    return torch.as_tensor(np.stack([ph.real, ph.imag]), dtype=dtype,
                           device=device)


def phase_matrix(geom, momenta, ft_sign, dtype=torch.complex64,
                 device="cuda") -> torch.Tensor:
    """Complex phases [Z, Y, X, P] (momenta: (px, py, pz) triples, the
    reference's momMatrix rows; ft_sign -1 or +1)."""
    return torch.as_tensor(_phases_np(geom, momenta, ft_sign), dtype=dtype,
                           device=device)


def map_gamma_g5(data_pos: torch.Tensor) -> torch.Tensor:
    """The G -> g5 G remap and sign on the gamma axis (axis 1) of
    dataPos [l, 16, T, Z, Y, X] (convertIdxOrder_mapGamma_kernel,
    lib/mugiq_util_kernels.cu:88-97)."""
    inv = np.argsort(gamma_map_index())
    s = torch.as_tensor(gamma_map_sign()[inv], dtype=data_pos.real.dtype,
                        device=data_pos.device)
    idx = torch.as_tensor(inv, device=data_pos.device)
    return data_pos[:, idx] * s.reshape(1, 16, 1, 1, 1, 1)


def momentum_project(data_pos_mapped: torch.Tensor,
                     phases: torch.Tensor) -> torch.Tensor:
    """dataMom[l, g, t, p] from dataPos [l, g, t, z, y, x] and phases
    [Z, Y, X, P]: one complex GEMM over the spatial volume."""
    l, g, T = data_pos_mapped.shape[:3]
    P = phases.shape[-1]
    return (data_pos_mapped.reshape(l * g * T, -1)
            @ phases.reshape(-1, P)).reshape(l, g, T, P)


def momentum_project_production(data: torch.Tensor,
                                ph: torch.Tensor) -> torch.Tensor:
    """data [l, 2, 16, T, Z, Y, X], ph [2, Z, Y, X, P] -> [l, 2, 16, T, P]:
    one real [l*16*T, V3] x [V3, P] GEMM pair (the reference's cuBLAS GEMM,
    loop_mugiq.cpp:363-378), in full f32."""
    l, _, g, T, Z, Y, X = data.shape
    P = ph.shape[-1]
    dr = data[:, 0].reshape(l * g * T, Z * Y * X)
    di = data[:, 1].reshape(l * g * T, Z * Y * X)
    phr = ph[0].reshape(Z * Y * X, P)
    phi_ = ph[1].reshape(Z * Y * X, P)
    outr = dr @ phr - di @ phi_
    outi = dr @ phi_ + di @ phr
    return torch.stack([outr, outi]).reshape(2, l, g, T, P).transpose(0, 1)
