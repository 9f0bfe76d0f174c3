"""Whether what the window produced is correct: the numbers compared with
the plain reference (portbench/reference/), each against its limit in the
configuration file ("limits").

For each checked configuration the reference makes the configuration's gauge
again from its seed, builds its own operator and reads the program's
outputs only to judge them:

* ``unconverged``: the window's calls whose eigensolve stopped at the
  configuration's restart cap short of its tolerance (the entry's
  ``converged``), every call; limit 0, since a configuration's time
  counts only as a time to a solution at the stated tolerance.
* ``eig_resid``: max over the eigenpairs of
  ||A v - lambda v|| / (lambda ||v||), lambda the program's eigenvalue, v
  the eigenvector the program measured on, A the reference's M^dag M; in
  an MG configuration A is the reference's own Galerkin coarse M^dag M (its
  hierarchy rebuilt from the gauge and the set-up seed) and v the program's
  prolongated vector restricted to it.
* ``orth``: max |V^dag V - I| over the program's measured eigenvectors, so
  that copies of one pair, or pairs no longer orthogonal, do not pass on
  their residuals.
* ``loop_rel``: max |data_mom - data_mom_ref| / max |data_mom_ref|, the
  reference's loops (slot 0, each displacement, g5 map, momentum
  projection) on the same vectors with sigma from its own Rayleigh
  quotients.

``lowp`` computes the loops as the control does: the reference in the
program's place in bfloat16 (vectors and loop links rounded to bfloat16,
complex64 arithmetic).
"""

import numpy as np
import torch

from . import gauge as gauges
from .reference import loop as rloop
from .reference import mg as rmg
from .reference import wilson as rw

NAMES = ("unconverged", "eig_resid", "orth", "loop_rel")
#: the numbers of one configuration (check.numbers)
PER_CONFIGURATION = ("eig_resid", "orth", "loop_rel")


def pin_precision():
    """No TF32 in the reference's products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_bf16(U: torch.Tensor) -> torch.Tensor:
    """Links with real and imaginary parts rounded f64 -> f32 -> bf16, as the
    program stores bf16 links."""
    r = torch.view_as_real(U).float().to(torch.bfloat16).double()
    return torch.view_as_complex(r.contiguous())


def _lowp(z: torch.Tensor) -> torch.Tensor:
    return _round_bf16(z).to(torch.complex64)


def numbers(cell, seeds: dict, evecs_k, evals, data_mom, device,
            lowp: bool = False) -> dict:
    """{name: value} for one configuration, made from `seeds`
    (gauge.member_seeds); evecs_k the measured vectors in
    the program's layout [n, T, 24, Z, Y*X] (host or device); data_mom the
    program's (ignored with lowp: the bf16 reference is judged instead)."""
    cfg, tr = cell.config, cell.traffic
    dims = tuple(cfg["dims"])
    X, Y, Z, T = dims
    U = gauges.hot_gauge(dims, seeds["gauge"], device)
    Uop = rw.phased_links(U, cfg["antiperiodic_t"])
    if cfg["link_precision"] == "bf16":
        Uop = _round_bf16(Uop)
    w = rw.from_kernel_layout(evecs_k.to(device), Y)
    orth = rw.gram_defect(w)
    evals = [float(x) for x in evals]
    if cfg.get("mg"):
        mg = cfg["mg"]
        wil = rw.Wilson(Uop.to(torch.complex64), cfg["kappa"])
        nulls = rmg.null_vectors(wil, seeds["mg"], mg["n_vec"][0],
                                 mg["setup_iters"], dims)
        trans = rmg.Transfer(nulls,
                             rmg.Blocking(dims, mg["geo_block_size"][0]))
        del nulls
        coarse = rmg.Coarse(wil, trans).to(torch.complex128)
        del wil
        u = trans.restrict(w).to(torch.complex128)
        res, rq = rw.eigen_residuals(coarse.MdagM, u, evals)
        del coarse
        vecs = trans.prolong(u.to(torch.complex64)).to(torch.complex128)
        del trans, u
    else:
        wil = rw.Wilson(Uop.to(torch.complex128), cfg["kappa"])
        vecs = w.to(torch.complex128)
        res, rq = rw.eigen_residuals(wil.MdagM, vecs, evals)
        del wil
    del Uop, w
    sigma = np.sqrt(np.maximum(rq, 0.0))
    args = (tr["displacements"], tr["momenta"], tr["ft_sign"])
    ref = rloop.loop_data_mom(vecs, sigma, U, *args).cpu().numpy()
    if lowp:
        got = rloop.loop_data_mom(_lowp(vecs), sigma, _lowp(U),
                                  *args).cpu().numpy()
    else:
        got = np.asarray(data_mom)
    loop_rel = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    return {"eig_resid": max(res), "orth": orth, "loop_rel": loop_rel}


def judge(cell, seed: int, calls, device) -> dict:
    """{name: {"value": worst over the checked calls, "limit": limit}} and
    the calls checked: every call, or the configuration's "checked_per_run"
    drawn from the seed; ``unconverged`` counts every call."""
    pin_precision()
    k = cell.config["checked_per_run"]
    chosen = list(calls)
    if k and len(chosen) > k:
        rng = np.random.default_rng(
            gauges.derive_seed(seed, 0, gauges.SAMPLE))
        chosen = [chosen[i] for i in
                  sorted(rng.choice(len(chosen), size=k, replace=False))]
    ens_seed = int(cell.traffic["ensemble"]["seed"])
    worst = {n: 0.0 for n in PER_CONFIGURATION}
    worst["unconverged"] = sum(not c.converged for c in calls)
    for c in chosen:
        got = numbers(cell, gauges.member_seeds(ens_seed, c.member), c.evecs,
                      c.evals, c.data_mom, device)
        for n in PER_CONFIGURATION:
            v = got[n] if got[n] == got[n] else float("inf")   # NaN fails
            worst[n] = max(worst[n], v)
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
    limits = cell.config["limits"]
    out = {n: {"value": worst[n], "limit": limits[n]} for n in NAMES}
    out["checked"] = [c.member for c in chosen]
    return out


def passed(check: dict) -> bool:
    return all(check[n]["value"] <= check[n]["limit"] for n in NAMES)
