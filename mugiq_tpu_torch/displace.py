"""Covariant displacement of complex full-site spinors (port of
mugiq_tpu.displace):

    psi'(x) = U_d(x) psi(x + d)          for a '+' displacement
    psi'(x) = U_d^dag(x - d) psi(x - d)  for a '-' displacement

with the unphased (smeared) loop gauge (tests/loop.cpp:901-918).
"""

import torch

from .fields import shift
from .params import parse_disp_str


def covariant_displace(U: torch.Tensor, psi: torch.Tensor,
                       disp_str: str) -> torch.Tensor:
    """One displacement step of psi [..., T, Z, Y, X, 4, 3] (leading batch
    axes allowed) along disp_str ('+z', '-t', ...); U [4, T, Z, Y, X, 3,
    3]."""
    d, sign = parse_disp_str(disp_str)
    if sign > 0:
        link, nbr = U[d], shift(psi, d, +1)
    else:
        link, nbr = shift(U[d], d, -1).transpose(-1, -2).conj(), \
            shift(psi, d, -1)
    # out[s, a] = sum_b link[a, b] nbr[s, b], as an elementwise product
    # and sum (not one 4x3 by 3x3 GEMM per site)
    return (link.unsqueeze(-3) * nbr.unsqueeze(-2)).sum(-1)
