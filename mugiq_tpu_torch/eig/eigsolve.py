"""Eigensolve orchestration on complex fields — the Eigsolve_Mugiq analog
(port of mugiq_tpu.eig.eigsolve).

The Hermitian MdagM / MMdag run thick-restart Lanczos (optionally on a
Chebyshev polynomial of the operator), the non-normal M / Mdag the
Krylov-Schur Arnoldi; then computeEvals (lib/eigsolve_mugiq.cpp:289-315):
Rayleigh quotients and residuals of the operator, rescaled by 0.25/kappa^2
under MASS normalisation, and sigma = sqrt(lambda) for the normal
operators (the loop's 1/sigma weights).

The start vector is drawn from numpy's default_rng(seed) (real parts,
then imaginary parts, float64, cast to the field dtype), as the port's
production path draws its own; the JAX package draws it from jax.random,
which the port cannot reproduce (ROADMAP, deliberate deviations).
"""

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..params import (EigOperator, EigParam, InvertParam,
                      MassNormalization, Spectrum)
from .lanczos import (chebyshev_op, estimate_spectral_edge,
                      lanczos_hermitian, vnorm)


@dataclass
class EigsolveOutput:
    evecs: torch.Tensor            # [n_ev, *field shape]
    evals: np.ndarray              # Rayleigh-quotient eigenvalues (complex)
    evals_lanczos: np.ndarray      # Ritz values of the iterated operator
    resids: np.ndarray             # ||lambda v - Op v|| (after mass norm.)
    sigma: Optional[np.ndarray]    # sqrt(lambda) for MdagM / MMdag
    n_restarts: int
    converged: bool


def random_field(shape, seed: int, dtype, device="cuda") -> torch.Tensor:
    """Complex Gaussian field from numpy's default_rng(seed): the real
    parts of every entry, then the imaginary parts."""
    rng = np.random.default_rng(seed)
    re = rng.standard_normal(tuple(shape))
    im = rng.standard_normal(tuple(shape))
    return torch.as_tensor(re + 1j * im, dtype=dtype, device=device)


class Eigensolver:
    """Eigenpairs of a Dirac matrix (operator_apply: M, Mdag, MdagM or
    MMdag, already selected).  Polynomial acceleration needs a normal
    operator (lib/eigsolve_mugiq.cpp:217-220).  v0_transform maps the
    start vector into an invariant subspace (the even sites of the
    Schur-preconditioned operator, whose complement is its null space)."""

    def __init__(self, operator_apply: Callable, field_shape, dtype,
                 eig_param: EigParam,
                 inv_param: Optional[InvertParam] = None,
                 v0_transform: Optional[Callable] = None, device="cuda"):
        self.op = operator_apply
        self.field_shape = tuple(field_shape)
        self.dtype = dtype
        self.device = torch.device(device)
        self.p = eig_param
        self.inv = inv_param
        self.v0_transform = v0_transform
        self.hermitian = eig_param.operator in (EigOperator.MdagM,
                                                EigOperator.MMdag)
        if not self.hermitian and eig_param.use_poly_acc:
            raise ValueError(
                "Polynomial acceleration with non-symmetric matrices not "
                "supported (matches lib/eigsolve_mugiq.cpp:217-220)")

    def start_vector(self) -> torch.Tensor:
        v0 = random_field(self.field_shape, self.p.seed, self.dtype,
                          self.device)
        return v0 if self.v0_transform is None else self.v0_transform(v0)

    def solve(self) -> EigsolveOutput:
        p = self.p
        v0 = self.start_vector()
        if not self.hermitian:
            return self._solve_arnoldi(v0)

        it_op = self.op
        it_which = {Spectrum.SR: "SR", Spectrum.LR: "LR"}.get(p.spectrum)
        if it_which is None:
            raise ValueError(
                f"spectrum {p.spectrum} unsupported by Lanczos (SR/LR only), "
                "matching the reference check (tests/eigensolve.cpp:253)")
        if p.use_poly_acc:
            if p.spectrum != Spectrum.SR:
                raise ValueError("Chebyshev acceleration targets the SR end")
            a_max = (p.a_max if p.a_max > 0
                     else estimate_spectral_edge(self.op, v0))
            it_op = chebyshev_op(self.op, p.poly_deg, p.a_min, a_max)
            it_which = "LR"   # smallest of A -> largest of p(A)

        res = lanczos_hermitian(
            it_op, v0, n_ev=p.n_ev, n_kr=p.n_kr, tol=p.tol,
            max_restarts=p.max_restarts, which=it_which,
            check_interval=p.check_interval)

        evals, resids = self._compute_evals(res.evecs)
        order = np.argsort(evals.real)
        if p.spectrum == Spectrum.LR:
            order = order[::-1]
        order = np.ascontiguousarray(order)
        evecs = res.evecs[torch.as_tensor(order, device=res.evecs.device)]
        evals, resids = evals[order], resids[order]
        sigma = np.sqrt(np.maximum(evals.real, 0.0))
        return EigsolveOutput(
            evecs=evecs, evals=evals, evals_lanczos=res.evals,
            resids=resids, sigma=sigma,
            n_restarts=res.n_restarts, converged=res.converged)

    def _solve_arnoldi(self, v0) -> EigsolveOutput:
        """The non-Hermitian M / Mdag by Krylov-Schur Arnoldi."""
        from .arnoldi import arnoldi_krylov_schur

        p = self.p
        res = arnoldi_krylov_schur(
            self.op, v0, n_ev=p.n_ev, n_kr=p.n_kr, tol=p.tol,
            max_restarts=p.max_restarts, which=p.spectrum.value,
            check_interval=p.check_interval)
        evals, resids = self._compute_evals(res.evecs)
        return EigsolveOutput(
            evecs=res.evecs, evals=evals, evals_lanczos=res.evals,
            resids=resids, sigma=None,
            n_restarts=res.n_restarts, converged=res.converged)

    def _compute_evals(self, evecs):
        """Rayleigh quotients and residuals of the operator, w = Op v
        rescaled by 0.25/kappa^2 under MASS normalisation before both
        (computeEvals); their sums run in complex128 whatever the field
        dtype."""
        scale = 1.0
        if (self.inv is not None
                and self.inv.mass_normalization == MassNormalization.MASS):
            scale = 0.25 / self.inv.kappa ** 2
        lams, rs = [], []
        for v in evecs:
            w = self.op(v) * scale
            vd = v.reshape(-1).to(torch.complex128)
            lam = torch.vdot(vd, w.reshape(-1).to(torch.complex128)) \
                / vnorm(vd)
            lams.append(complex(lam))
            rs.append(float(vnorm(lam * v - w)))
        return np.asarray(lams), np.asarray(rs)

    def project(self, evecs: torch.Tensor, vec: torch.Tensor):
        """sum_i v_i <v_i, vec>, the deflation projector (projectVector,
        lib/eigsolve_mugiq.cpp:340-348)."""
        E = evecs.reshape(evecs.shape[0], -1)
        return (E.T @ (E.conj() @ vec.reshape(-1))).reshape(vec.shape)
