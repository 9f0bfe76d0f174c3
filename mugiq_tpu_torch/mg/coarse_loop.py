"""Coarse-space ultra-local loop: no prolongation of eigenvectors (port of
mugiq_tpu.mg.coarse_loop).

The reference's legacy tree records the dual of the live pipeline's
fine-space contraction (lib/LEGACY/loop_coarse.cu.LEGACY:334-340,
loop_coarse_ulocal.cu.LEGACY:406-452): restrict the 12 spin-colour unit
generators (unphased once, phased and time-diluted per (momentum, t))
through Transfer::R to the coarsest level and assemble the ultra-local
loop there:

    L_n(p,t) = sum_m w_m  <u_m, r_i>  gcoeff(n)_{ij}  <v_j, u_m>

with u_m the coarse eigenvectors, r_i = R(unit_i), v_j = R(phase delta_t
unit_j) and gcoeff(n)_{ij} = (gamma_n)_{s_i s_j} delta_{c_i c_j}.
Because R = P^dag it equals the fine contraction of the prolongated
eigenvectors up to rounding.

The JAX function reads every dot product back to the host and restricts
the generators one at a time at full volume.  Here the 12 generators go
through R in one batched call, and a time-diluted generator of slice t
only through the transfers' rows of the coarsest time row that holds t
(R is block-local, so the other rows of its restriction vanish); A
[n_ev, 12] and each B [12, n_ev] are one GEMM each, and the result moves
to the host once.
"""

from functools import lru_cache

import numpy as np
import torch

from ..gamma import gamma_basis
from ..lattice import LatticeGeometry
from .transfer import _block_agg, apply_R

N_GAMMA = 16


@lru_cache(maxsize=None)
def _gcoeff_np():
    """[16, 12, 12] dense gamma coefficients in spin tensor colour:
    gcoeff(n)[s*3+c, s'*3+c'] = (gamma_n)_{s s'} delta_{c c'}."""
    g = gamma_basis()                         # [16, 4, 4]
    eye3 = np.eye(3)
    return np.einsum("nab,cd->nacbd", g, eye3).reshape(N_GAMMA, 12, 12)


def _unit_generators_np(dims):
    """[12, T, Z, Y, X, 4, 3] unit spin-colour generators: u_{s*3+c} is 1
    in component (s, c) at every site (createUnphasedGammaUnitVectors,
    lib/LEGACY/utility_kernels.cu.LEGACY:8-40)."""
    X, Y, Z, T = dims
    u = np.zeros((12, T, Z, Y, X, 4, 3), dtype=np.complex128)
    for s in range(4):
        for c in range(3):
            u[s * 3 + c, ..., s, c] = 1.0
    return u


def _phase_np(geom: LatticeGeometry, mom, ft_sign: int):
    """[T, Z, Y, X] plane-wave phase exp(i*sign*2pi p.x/L) (spatial)."""
    X, Y, Z, T = geom.dims
    x = np.arange(X)[None, None, None, :]
    y = np.arange(Y)[None, None, :, None]
    z = np.arange(Z)[None, :, None, None]
    ph = 2 * np.pi * (mom[0] * x / X + mom[1] * y / Y + mom[2] * z / Z)
    return np.broadcast_to(np.exp(1j * ft_sign * ph), (T, Z, Y, X))


def time_rows(env) -> int:
    """Fine time slices under one time row of the coarsest level."""
    rows = 1
    for tr in env.transfers:
        rows *= tr.geom.block[3]
    return rows


def restrict_rows(env, psi: torch.Tensor, t0: int) -> torch.Tensor:
    """R of a fine field that vanishes outside the time slices [t0, t0 +
    rows) of one coarsest time row (rows = time_rows(env), t0 a multiple
    of it): psi [..., rows, Z, Y, X, ns, nc] holds those slices; returns
    that coarsest row [..., 1, Zc, Yc, Xc, ns_c, n_vec], which equals the
    row t0 // rows of env.restrict of the full field (every other row of
    it is zero)."""
    for tr in env.transfers:
        bt = tr.geom.block[3]
        h = _block_agg(psi, tr.geom)          # [..., k, Zc, Yc, Xc, ns, agg]
        t0 //= bt
        psi = apply_R(h, tr.V[t0:t0 + h.shape[-6]])
    return psi


def coarse_loop_ulocal(env, evecs_coarse, weights, geom: LatticeGeometry,
                       momenta, ft_sign: int = -1) -> np.ndarray:
    """Assemble the ultra-local loop in coarse space.

    env: MGEnv of the API path; evecs_coarse [nEv, *coarse field] on the
    env's device; weights [nEv] real (1/lambda for the legacy
    normalisation, 1/sigma for the live pipeline's).  Returns complex128
    numpy [P, 16, T], gamma inside time inside momentum as the legacy host
    buffer (loop_coarse.cu.LEGACY:150-160).  The generators take the
    eigenvectors' dtype; the small products run in complex128."""
    X, Y, Z, T = geom.dims
    dev, dtype = evecs_coarse.device, evecs_coarse.dtype
    n_ev = evecs_coarse.shape[0]
    rows = time_rows(env)
    if T % rows:
        raise ValueError(f"the coarsest time row ({rows} slices) does not "
                         f"divide T={T}")
    c128 = torch.complex128
    U = evecs_coarse.reshape(n_ev, evecs_coarse.shape[1], -1)  # [m, Tc, .]
    eye = torch.eye(12, dtype=dtype, device=dev)

    # A[m, i] = <u_m, R(unit_i)>: the 12 unit generators in one batch
    units = eye.reshape(12, 1, 1, 1, 1, 4, 3).expand(12, T, Z, Y, X, 4, 3)
    r_units = env.restrict(units).reshape(12, -1)
    A = (U.reshape(n_ev, -1).conj() @ r_units.T).to(c128)
    del units, r_units

    gco = torch.as_tensor(_gcoeff_np(), dtype=c128, device=dev)
    w = torch.as_tensor(np.asarray(weights, dtype=np.float64), dtype=c128,
                        device=dev)
    # G[n, j, m] = sum_i gco[n, i, j] A[m, i] w_m
    G = torch.einsum("nij,mi,m->njm", gco, A, w)
    out = torch.empty((len(momenta), N_GAMMA, T), dtype=c128, device=dev)
    gen = torch.zeros((12, rows, Z, Y, X, 12), dtype=dtype, device=dev)
    for ip, mom in enumerate(momenta):
        ph = torch.as_tensor(np.array(_phase_np(geom, mom, ft_sign)[0]),
                             dtype=dtype, device=dev)
        # the 12 time-diluted phased generators of one slice: component j
        # of generator j carries the phase on that slice: [12, Z, Y, X, 12]
        slab = ph[..., None] * eye[:, None, None, None, :]
        for t in range(T):
            t0 = t - t % rows
            gen.zero_()
            gen[:, t - t0] = slab
            v = restrict_rows(env, gen.reshape(12, rows, Z, Y, X, 4, 3), t0)
            # B[j, m] = <R(gen_j), u_m> on the coarsest row t0 // rows
            B = (v.reshape(12, -1).conj() @ U[:, t0 // rows].T).to(c128)
            out[ip, :, t] = torch.einsum("njm,jm->n", G, B)
    return out.cpu().numpy()
