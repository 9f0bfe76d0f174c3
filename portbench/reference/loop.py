"""Plain disconnected-loop measurement on complex full-site eigenvectors,
written for the benchmark's correctness check; it imports nothing of the
program.

    T_g(x)  = sum_n (1/sigma_n) v_n(x)^dag G(g) vR_n(x)     (colour traced)
    vR      = v, or v covariantly displaced: U_d(x) v(x + d) for '+d',
              U_d(x - d)^dag v(x - d) for '-d' (unphased loop links)
    L_k     = s_k T_{15-k}      (MuGiq's G -> g5 G output map, g5_map_signs)
    data_mom[p, l, k, t] = sum_{z,y,x} L_k(l; t, z, y, x)
        exp(i ft_sign 2 pi (p_x x/L_x + p_y y/L_y + p_z z/L_z))
"""

import numpy as np
import torch

from .wilson import gamma16, shift

_DIRS = {"x": 0, "y": 1, "z": 2, "t": 3}


def g5_map_signs() -> np.ndarray:
    """s_k of L_k = s_k T_{15-k}: g5 G(k), with MuGiq's extra -1 on the
    outputs named -g5g3 and -g5g1 (G(11), G(14)), equals s_k G(15-k)."""
    G = gamma16()
    signs = np.zeros(16)
    for k in range(16):
        named = -G[k] if k in (11, 14) else G[k]
        prod = G[15] @ named
        nz = np.nonzero(G[15 - k])
        ratio = prod[nz] / G[15 - k][nz]
        if not np.allclose(ratio, ratio[0].real):
            raise AssertionError(f"g5 G({k}) is not +-G({15 - k})")
        signs[k] = ratio[0].real
    return signs


def parse_disp_entry(entry: str):
    """'+z:1,2' -> (mu, sign, start, stop); '+z:1' -> stop = start."""
    head, lims = entry.split(":")
    if len(head) != 2 or head[0] not in "+-" or head[1] not in _DIRS:
        raise ValueError(f"displacement entry {entry!r}")
    n = [int(s) for s in lims.split(",")]
    start, stop = min(n), max(n)
    return _DIRS[head[1]], (1 if head[0] == "+" else -1), start, stop


def displace(U: torch.Tensor, v: torch.Tensor, mu: int, sign: int):
    if sign > 0:
        link, nbr = U[mu], shift(v, mu, 1)
    else:
        link = shift(U[mu], mu, -1).transpose(-1, -2).conj()
        nbr = shift(v, mu, -1)
    return (link.unsqueeze(-3) * nbr.unsqueeze(-2)).sum(-1)


def contract(vL, vR, inv_sigma, G):
    """[16, T, Z, Y, X]: sum_n w_n vL_n^dag G(g) vR_n, one vector at a time."""
    acc = None
    for n in range(vL.shape[0]):
        # s[b, a] = sum_c conj(vL_b^c) vR_a^c
        s = torch.einsum("...bc,...ac->...ba", vL[n].conj(), vR[n])
        s = s * inv_sigma[n]
        acc = s if acc is None else acc + s
    return torch.einsum("gba,...ba->g...", G, acc)


def loop_data_mom(evecs, sigma, U_loop, disp_entries, momenta, ft_sign=-1):
    """data_mom [P, nLoop, 16, T] (complex, evecs' precision) from evecs
    [n, T, Z, Y, X, 4, 3], sigma [n], the unphased loop links U_loop
    [4, T, Z, Y, X, 3, 3] of the same dtype; slot 0 ultra-local, then one
    slot per displacement length of each entry."""
    dev, dt = evecs.device, evecs.dtype
    G = torch.as_tensor(gamma16(), dtype=dt, device=dev)
    inv_sigma = [float(1.0 / s) for s in np.asarray(sigma)]
    slots = [contract(evecs, evecs, inv_sigma, G)]
    for entry in disp_entries:
        mu, sign, start, stop = parse_disp_entry(entry)
        vR = evecs
        for i in range(1, stop + 1):
            vR = torch.stack([displace(U_loop, v, mu, sign) for v in vR])
            if i >= start:
                slots.append(contract(evecs, vR, inv_sigma, G))
        del vR
    pos = torch.stack(slots)                   # [l, 16, T, Z, Y, X]
    signs = torch.as_tensor(g5_map_signs(), dtype=pos.real.dtype, device=dev)
    mapped = pos.flip(1) * signs.reshape(1, 16, 1, 1, 1, 1)
    T, Z, Y, X = evecs.shape[1:5]
    z, y, x = torch.meshgrid(*(torch.arange(n, dtype=torch.float64)
                               for n in (Z, Y, X)), indexing="ij")
    mom = torch.as_tensor(np.asarray(momenta, dtype=np.float64).reshape(-1, 3))
    phase = (mom[:, 0, None, None, None] * x / X
             + mom[:, 1, None, None, None] * y / Y
             + mom[:, 2, None, None, None] * z / Z)
    ph = torch.exp(1j * ft_sign * 2 * np.pi * phase).to(dt).to(dev)
    l = mapped.shape[0]
    out = mapped.reshape(l, 16, T, Z * Y * X) @ ph.reshape(len(mom), -1).T
    return out.permute(3, 0, 1, 2)             # [P, l, 16, T]
