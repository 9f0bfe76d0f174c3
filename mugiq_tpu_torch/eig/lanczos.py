"""Chebyshev acceleration and spectral-edge estimate (port of
mugiq_tpu.eig.lanczos.chebyshev_op / estimate_spectral_edge)."""

from typing import Callable, Optional

import torch

from ..lanczos import norm


def estimate_spectral_edge(matvec: Callable, v0: torch.Tensor,
                           iters: int = 25,
                           reduce: Optional[Callable] = None) -> float:
    """Upper spectral edge of a Hermitian PSD operator by power iteration,
    padded by 10% (auto a_max for Chebyshev acceleration).  reduce: the
    sum over ranks for a sharded field (lanczos_hermitian_realpair)."""
    v = v0 / norm(v0, reduce)
    for _ in range(iters):
        w = matvec(v)
        v = w / norm(w, reduce)
    dot = torch.sum(v * matvec(v))
    return float(dot if reduce is None else reduce(dot)) * 1.10


def chebyshev_op(matvec: Callable, poly_deg: int, a_min: float,
                 a_max: float) -> Callable:
    """p(A): the degree-poly_deg Chebyshev polynomial of A mapped so that
    [a_min, a_max] -> [-1, 1]; eigenvalues below a_min grow exponentially
    in poly_deg and become the largest of p(A) (QUDA's poly_deg / a_min /
    a_max, include/eigsolve_mugiq.h:27-30).  The chain keeps the input's
    dtype: its Python-float scalars keep a bf16 field (a vector of a bf16
    Krylov basis) bf16, as JAX's weak-typed scalars do, and it takes a
    leading batch axis when the operator does."""
    d = 0.5 * (a_max - a_min)
    c = 0.5 * (a_max + a_min)

    def scaled(v):
        return (matvec(v) - c * v) / d

    def apply(v):
        if poly_deg == 0:
            return matvec(v)
        tkm1, tk = v, scaled(v)
        for _ in range(1, poly_deg):
            tkm1, tk = tk, 2.0 * scaled(tk) - tkm1
        return tk

    return apply
