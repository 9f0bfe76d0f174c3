"""g5 output map and momentum projection (port of
mugiq_tpu.planar.phase.map_gamma_g5_planar / phase_matrix_planar and
production.momentum_project_production)."""

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


def phase_matrix_planar(geom, momenta, ft_sign, device="cuda",
                        dtype=torch.float32) -> torch.Tensor:
    """Host-built phases exp(i ft_sign 2 pi p.x / L) as [2, Z, Y, X, P]."""
    mom = np.asarray(list(momenta), dtype=np.int64).reshape(-1, 3)
    Lx, Ly, Lz, _ = geom.dims
    z, y, x = np.meshgrid(np.arange(Lz), np.arange(Ly), np.arange(Lx),
                          indexing="ij")
    phi = (mom[:, 0][:, None, None, None] * x[None] / Lx
           + mom[:, 1][:, None, None, None] * y[None] / Ly
           + mom[:, 2][:, None, None, None] * z[None] / Lz)
    ph = np.moveaxis(np.exp(1j * int(ft_sign) * 2.0 * np.pi * phi), 0, -1)
    return torch.as_tensor(np.stack([ph.real, ph.imag]), dtype=dtype,
                           device=device)


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
