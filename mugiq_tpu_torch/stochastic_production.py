"""Stochastic (Hutchinson) loop traces on the kernel layout (port of
mugiq_tpu.stochastic_production): Z4 noise built on the host in numpy,
deflated normal-equation solves with cg_realpair on K1 (M, then M^dag),
contractions with K2.

    Tr[Gamma M^-1](x) = Tr[Gamma Mdefl^-1](x)
                        + E_eta[eta^dag Gamma (M^-1 - Mdefl^-1) eta](x)

Fields are [T, 24, Z, Y*X] f32, real parts in rows 0-11 and imaginary
parts in rows 12-23.  The operator is the single-device
dirac_kernel.WilsonDiracKernel or one rank's
parallel.shard_op.ShardedWilsonKernel: then every noise is the rank's
block of the global noise, every dot is summed over the ranks, K2 runs
on the rank's block and the result is the rank's block.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .kernels.contract import gamma_project, loop_contract
from .solvers import cg_realpair
from .utils import log, phase_timer


def z4_noise_kernel_np(shape_tzyx, seed: int) -> np.ndarray:
    """Z4 spinor noise in kernel layout [T, 24, Z, Y*X] (numpy f32) for
    lattice dims (X, Y, Z, T), from numpy.random.default_rng(seed)."""
    T, Z, Y, X = shape_tzyx[3], shape_tzyx[2], shape_tzyx[1], shape_tzyx[0]
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 4, size=(T, 12, Z, Y * X))
    table_r = np.asarray([1.0, 0.0, -1.0, 0.0], np.float32)
    table_i = np.asarray([0.0, 1.0, 0.0, -1.0], np.float32)
    return np.concatenate([table_r[k], table_i[k]], axis=1)


def _swap(x: torch.Tensor) -> torch.Tensor:
    """J x = (x_im, -x_re) over the re/im rows of [.., T, 24, Z, YX]:
    Im<a, b> = sum a * J b, and i b = -J b."""
    return torch.cat([x[..., 12:, :, :], -x[..., :12, :, :]], dim=-3)


@dataclass
class DeflationSpaceKernel:
    """The exact inverse on the span of M^dag M eigenvectors (kernel
    layout).  reduce: the sum over ranks when the basis is a rank's
    block."""
    evecs: torch.Tensor      # [n, T, 24, Z, YX]
    evals: torch.Tensor      # [n] real (M^dag M eigenvalues), f32
    M_evecs: torch.Tensor    # [n, T, 24, Z, YX] = M v_n
    reduce: Optional[object] = None

    @classmethod
    def build(cls, op, evecs, evals):
        """M v_n through the operator (K1 on one device, K7a on a rank's
        block), one vector at a time as the JAX function."""
        Mv = torch.stack([op.M(v) for v in evecs])
        mesh = getattr(op, "mesh", None)
        return cls(evecs=evecs, evals=torch.as_tensor(
            np.asarray(evals).real, dtype=torch.float32,
            device=evecs.device), M_evecs=Mv,
            reduce=None if mesh is None else mesh.all_reduce)

    def apply_inv(self, rhs):
        """Mdefl^-1 rhs = sum_n v_n lambda_n^-1 <M v_n, rhs>: one GEMM for
        the complex dots (rhs and J rhs as two columns), one for the sum
        (the coefficients' real and imaginary parts as two rows)."""
        n = self.evecs.shape[0]
        cols = torch.stack([rhs, _swap(rhs)]).reshape(2, -1)
        d = self.M_evecs.reshape(n, -1) @ cols.T          # [n, 2]: re, im
        if self.reduce is not None:
            d = self.reduce(d)
        c = d / self.evals[:, None]
        ab = (c.T @ self.evecs.reshape(n, -1)).reshape((2,) + rhs.shape)
        # sum_n (cr + i ci) v_n = V^T cr - J (V^T ci)
        return ab[0] - _swap(ab[1])

    def trace_contribution_planar(self, Y):
        """[2, 16, T, Z, Y, X]: sum_n lambda_n^-1 (M v_n)^dag Gamma v_n,
        through K2 (Y: the block's Y extent)."""
        return gamma_project(loop_contract(self.M_evecs, self.evecs,
                                           1.0 / self.evals), Y)


def stochastic_loop_trace_production(
        op, geom, n_noise: int,
        deflation: Optional[DeflationSpaceKernel] = None,
        solver_tol: float = 1e-6, solver_maxiter: int = 2000,
        seed: int = 99, solves: Optional[list] = None) -> torch.Tensor:
    """[2, 16, T, Z, Y, X] estimate of the per-site Tr[Gamma M^-1].

    op: WilsonDiracKernel, or ShardedWilsonKernel (the rank's block of
    [2, 16, T, Z, Y, X] is returned).  Noise i is z4_noise_kernel_np(
    geom.dims, seed + i); after the deflated part (when a deflation space
    is given) the remainder is solved by CG on M^dag M with tol
    solver_tol, contracted with its noise through K2 (weight 1), and the
    deflated trace is added at the end.  solves: when a list, each
    noise's (CG iterations, final relative residual) is appended."""
    mesh = getattr(op, "mesh", None)
    if mesh is None:
        Y, dev, reduce = geom.dims[1], op.U_k.device, None
    else:
        Y, dev, reduce = mesh.local["y"], mesh.device, mesh.all_reduce
    ones = torch.ones(1, dtype=torch.float32, device=dev)

    acc = None
    for i in range(n_noise):
        eta = torch.from_numpy(z4_noise_kernel_np(geom.dims, seed + i))
        eta = op.place(eta) if mesh is not None else eta.to(dev)
        rhs = eta
        if deflation is not None:
            rhs = eta - op.M(deflation.apply_inv(eta))
        with phase_timer("stochastic-solve"):
            res = cg_realpair(op.MdagM, op.Mdag(rhs), tol=solver_tol,
                              maxiter=solver_maxiter, reduce=reduce)
        resid = float(res.resid)
        log(f"stochastic production: noise {i}: iters={res.iters} "
            f"resid={resid:.2e}")
        if solves is not None:
            solves.append((res.iters, resid))
        # the remainder solve only: (M^-1 - Mdefl^-1) eta
        contrib = gamma_project(loop_contract(eta[None], res.x[None], ones),
                                Y)
        acc = contrib if acc is None else acc + contrib
        del eta, rhs, res
    data = acc / n_noise
    if deflation is not None:
        data = data + deflation.trace_contribution_planar(Y)
    return data
