"""Loop trace contraction on complex full-site eigenvectors, all 16 gamma
insertions, batched over the eigenvectors (port of
mugiq_tpu.ops.contract):

    loopData(x, G) = sum_n (1/sigma_n) Tr[ vL_n(x)^dag Gamma(G) vR_n(x) ]
"""

import torch

from ..gamma import gamma_flat


def loop_contract(vL: torch.Tensor, vR: torch.Tensor,
                  inv_sigma: torch.Tensor) -> torch.Tensor:
    """vL, vR [n, T, Z, Y, X, 4, 3], inv_sigma [n] real -> [16, T, Z, Y, X]
    complex."""
    w = torch.as_tensor(inv_sigma, device=vL.device).to(vL.real.dtype)
    wL = vL * w.reshape(-1, 1, 1, 1, 1, 1, 1)
    # resG[x, b, a] = sum_n sum_c conj(wL)_b^c vR_a^c
    resG = torch.einsum("ntzyxbc,ntzyxac->tzyxba", wL.conj(), vR)
    G = torch.as_tensor(gamma_flat(), dtype=vL.dtype, device=vL.device)
    return torch.einsum("gp,tzyxp->gtzyx", G,
                        resG.reshape(resG.shape[:4] + (16,)))


def loop_contract_single(vL: torch.Tensor, vR: torch.Tensor,
                         inv_sigma: float) -> torch.Tensor:
    """One eigenvector pair (incremental accumulation)."""
    return loop_contract(vL[None], vR[None],
                         torch.tensor([inv_sigma], dtype=torch.float64))
