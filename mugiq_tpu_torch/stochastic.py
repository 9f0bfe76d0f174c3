"""Stochastic (Hutchinson) probing of disconnected loops on complex
fields (port of mugiq_tpu.stochastic): the API form, plain PyTorch.

The reference computes the low-mode part of the loop from eigenvectors
only (computeCoarseLoop); the stochastic remainder completes it:

    Tr[Gamma M^-1](x) = Tr[Gamma Mdefl^-1](x)
                        + E_eta[ eta(x)^dag Gamma ((M^-1 - Mdefl^-1) eta)(x) ]

with Mdefl^-1 = sum_n v_n lambda_n^-1 (M v_n)^dag the exact inverse on the
span of M^dag M eigenvectors v_n and eta Z4 noise.  The result has the
[16, T, Z, Y, X] layout of one loop slot, so the g5 map, momentum
projection and HDF5 writers apply unchanged.

The noise of probe i comes from numpy's default_rng(seed + i); the JAX
function draws it from jax.random (threefry), which the port cannot
reproduce (ROADMAP, deliberate deviations).  The production form on the
kernel layout, with K1 and K2, is stochastic_production.py.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .ops.contract import loop_contract
from .solvers import cg
from .utils import log, phase_timer


def z4_noise(seed: int, shape, dtype, device="cuda") -> torch.Tensor:
    """Z4 noise: entries in {1, i, -1, -i}, uniform, from
    numpy.random.default_rng(seed)."""
    k = np.random.default_rng(seed).integers(0, 4, size=tuple(shape))
    table = np.asarray([1.0 + 0j, 1j, -1.0 + 0j, -1j])
    return torch.as_tensor(table[k], dtype=dtype, device=device)


@dataclass
class DeflationSpace:
    """The exact inverse on the span of M^dag M eigenvectors."""
    evecs: torch.Tensor       # [n, *field]
    evals: torch.Tensor       # [n] real eigenvalues of M^dag M
    M_evecs: torch.Tensor     # [n, *field] = M v_n

    @classmethod
    def build(cls, dirac_M: Callable, evecs, evals):
        evecs = torch.as_tensor(evecs)
        lam = torch.as_tensor(np.asarray(evals).real, device=evecs.device)
        return cls(evecs=evecs, evals=lam, M_evecs=dirac_M(evecs))

    def apply_inv(self, rhs):
        """Mdefl^-1 rhs = sum_n v_n lambda_n^-1 <M v_n, rhs>: two GEMMs."""
        n = self.evecs.shape[0]
        dots = self.M_evecs.reshape(n, -1).conj() @ rhs.reshape(-1)
        c = dots / self.evals.to(dots.dtype)
        return (c @ self.evecs.reshape(n, -1)).reshape(rhs.shape)

    def trace_contribution(self):
        """Per-site all-gamma trace of Gamma Mdefl^-1:
        sum_n lambda_n^-1 (M v_n)(x)^dag Gamma v_n(x)."""
        return loop_contract(self.M_evecs, self.evecs, 1.0 / self.evals)


def stochastic_loop_trace(dirac, n_noise: int,
                          deflation: Optional[DeflationSpace] = None,
                          solver_tol: float = 1e-8,
                          solver_maxiter: int = 2000,
                          seed: int = 99) -> torch.Tensor:
    """Estimate dataPos [16, T, Z, Y, X] = per-site Tr[Gamma M^-1].

    dirac: a full-site operator with M / Mdag (dirac.WilsonDirac).  Each
    noise is solved through the normal equations with CG, after the
    deflated part when a DeflationSpace is given; only the remainder is
    estimated and the deflated trace is added at the end."""
    shape, dtype = dirac.field_shape, dirac.dtype
    dev = dirac.U.device

    def solve(rhs):
        if deflation is not None:
            s0 = deflation.apply_inv(rhs)
            r = rhs - dirac.M(s0)
            res = cg(dirac.MdagM, dirac.Mdag(r), tol=solver_tol,
                     maxiter=solver_maxiter)
            return s0 + res.x, res
        res = cg(dirac.MdagM, dirac.Mdag(rhs), tol=solver_tol,
                 maxiter=solver_maxiter)
        return res.x, res

    ones = torch.ones(1, dtype=torch.float64, device=dev)
    acc = None
    for i in range(n_noise):
        eta = z4_noise(seed + i, shape, dtype, dev)
        with phase_timer("stochastic-solve"):
            s, res = solve(eta)
        log(f"stochastic_loop_trace: noise {i}: CG iters={int(res.iters)} "
            f"resid={float(res.resid):.2e}")
        if deflation is not None:
            # estimate only the remainder: subtract the deflated part of s
            s = s - deflation.apply_inv(eta)
        contrib = loop_contract(eta[None], s[None], ones)
        acc = contrib if acc is None else acc + contrib
    data = acc / n_noise
    if deflation is not None:
        data = data + deflation.trace_contribution()
    return data
