"""A run with the timed path broken underneath comes out not correct:
the harness driven as on the card (less its look for one), at a tiny size
on the CPU, once for each fault a cell of one chip can have.  (Neither cell
exchanges anything between chips.)"""

import numpy as np
import pytest
from conftest import tiny_cell

from portbench import session

CELLS = ["wilson32-defl.flagship", "wilson32-mg.flagship"]


def _displace_unchanged(production, monkeypatch):
    """A step that returns its state unchanged: K3 hands back its input."""
    def displace(vR, U, mu, sgn, Y, out=None):
        return vR.clone() if out is None else out.copy_(vR)
    monkeypatch.setattr(production, "covariant_displace", displace)


def _half_the_vectors(production, monkeypatch):
    """Half of the batch left out, the mean taken over the rest: the loops
    of the first half of the eigenvectors, doubled."""
    inner = production._measure_production_kernel

    def measure(geom, lp, cp, evecs, sigma, *args):
        h = evecs.shape[0] // 2
        return inner(geom, lp, cp, evecs[:h].contiguous(),
                     [s / 2 for s in sigma[:h]], *args)
    monkeypatch.setattr(production, "_measure_production_kernel", measure)


def _contraction_altered(production, monkeypatch):
    """An answer altered where it is produced: K2's sums off by 1e-3."""
    inner = production.loop_contract

    def contract(L, R, w, acc=None):
        return inner(L, R, w, acc) * (1 + 1e-3)
    monkeypatch.setattr(production, "loop_contract", contract)


def _eigensolve_stopped(production, monkeypatch):
    """An answer altered where it is produced: the eigensolver stopped after
    one restart, its vectors returned as converged."""
    inner = production.lanczos_hermitian_realpair

    def lanczos(*args, **kw):
        return inner(*args, **{**kw, "max_restarts": 1})
    monkeypatch.setattr(production, "lanczos_hermitian_realpair", lanczos)


def _pairs_copied(production, monkeypatch):
    """An answer altered where it is produced: the eigensolver hands back
    the first half of its pairs twice (eigenvalues and vectors), each copy
    an eigenpair on its own.  The Rayleigh-Ritz refine of a filtered solve
    is part of the eigensolver: it refines the first half, then copies."""
    import dataclasses

    import torch
    inner, inner_refine = (production.lanczos_hermitian_realpair,
                           production.rayleigh_ritz_refine)

    def twice(x):
        h = len(x) // 2
        return (torch.cat([x[:h]] * 2) if torch.is_tensor(x)
                else np.concatenate([np.asarray(x)[:h]] * 2))

    def lanczos(*args, **kw):
        res = inner(*args, **kw)
        return dataclasses.replace(res, evals=twice(res.evals),
                                   evecs=twice(res.evecs),
                                   resids=twice(res.resids))

    def refine(matvec, evecs, **kw):
        h = len(evecs) // 2
        out = inner_refine(matvec, evecs[:h], **kw)
        return tuple(torch.cat([x] * 2) if torch.is_tensor(x)
                     else np.concatenate([np.asarray(x)] * 2) for x in out)
    monkeypatch.setattr(production, "lanczos_hermitian_realpair", lanczos)
    monkeypatch.setattr(production, "rayleigh_ritz_refine", refine)


FAULTS = [_displace_unchanged, _half_the_vectors, _contraction_altered,
          _eigensolve_stopped, _pairs_copied]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_is_not_correct(name, fault, monkeypatch, cpu_only):
    from mugiq_tpu_torch import production
    fault(production, monkeypatch)
    result, lines = session.execute(tiny_cell(name), 2 ** 32 + 77, 0.1,
                                    False, "cpu", 0.0)
    assert result["correct"] is False, result["check"]
    assert 1 <= result["failed"] <= result["attempted"]
    if fault is _pairs_copied:
        # copies of eigenpairs pass on their residuals; orth sees them
        assert result["check"]["orth"]["value"] > 0.5, result["check"]
