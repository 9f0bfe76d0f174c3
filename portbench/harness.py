"""One run of a cell: set-up (the cell's kernels, one cheap call of the
entry), the window over a stream of gauge configurations, then the check
of what the window produced against the plain reference.

The window drives the port's entry ``production.compute_loop_production``
once per configuration, as an ensemble is processed.  The traffic names the
ensemble (its seed and the members it takes); every run takes the same
members, in an order drawn from its --seed, so that each seed gets the same
work.  Each member's hot gauge is made on the device from the ensemble's
seed between calls, with the clock stopped; the clock runs from a call to
its return (its results on the host).  Configurations start while the timed
seconds are fewer than the run's ``--seconds``, and then until the pass
through the members is whole, so that every window holds whole passes.

The entry returns the eigenvalues and the loops but not the eigenvectors
they were measured on, so the run wraps the entry's measurement
(``production._measure_production_kernel``) to keep a reference to its
eigenvectors; they are copied to the host for the check once the call's
clock and its trace marker have closed.
"""

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import gauge as gauges


@dataclass
class Call:
    """One configuration of the window."""
    member: int             # member of the ensemble
    seconds: float
    phases: dict            # PROFILE seconds of this call, by phase
    n_restarts: int
    converged: bool
    evals: np.ndarray
    data_mom: np.ndarray
    evecs: torch.Tensor     # the measured eigenvectors, on the host
    peak_bytes: int


@dataclass
class Run:
    cell: object
    seed: int
    trace: bool
    device: str
    setup_s: float = 0.0
    calls: list = field(default_factory=list)
    traced: Optional[object] = None     # tracing.Traced of a --trace 1 run
    check: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return sum(c.seconds for c in self.calls)

    @property
    def peak_bytes(self) -> int:
        return max((c.peak_bytes for c in self.calls), default=0)

    def phase_mean(self, *names):
        """The PROFILE seconds of `names` summed, per configuration; None
        where no call ran any of them."""
        if not any(n in c.phases for c in self.calls for n in names):
            return None
        return sum(c.phases.get(n, 0.0) for c in self.calls
                   for n in names) / len(self.calls)


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


class Program:
    """The port's entry with a cell's configuration and traffic."""

    def __init__(self, config: dict, traffic: dict, device: str):
        from mugiq_tpu_torch import production
        from mugiq_tpu_torch.params import (DslashType, EigOperator,
                                            EigParam, FTSign, GaugeParam,
                                            InvertParam, LoopParam, MGParam,
                                            Spectrum)
        self.production = production
        self.config, self.device = config, device
        if (traffic["gauge"], traffic["arrivals"]) != ("hot", "back_to_back"):
            raise ValueError("the generator makes hot gauges back to back: "
                             f"{traffic['gauge']!r}, {traffic['arrivals']!r}")
        self.dims = tuple(config["dims"])
        self.gauge = GaugeParam(dims=self.dims,
                                antiperiodic_t=config["antiperiodic_t"])
        self.inv = InvertParam(dslash_type=DslashType(config["dslash"]),
                               kappa=config["kappa"], csw=config["csw"])
        self._EigParam, self._MGParam = EigParam, MGParam
        eig = dict(config["eig"])
        eig["operator"] = EigOperator(eig["operator"])
        eig["spectrum"] = Spectrum(eig["spectrum"])
        self.eig = eig
        self.loop = LoopParam(
            momenta=[tuple(m) for m in traffic["momenta"]],
            ft_sign=FTSign(traffic["ft_sign"]),
            do_nonlocal=bool(traffic["displacements"]),
            disp_entries=list(traffic["displacements"]))

    def call(self, U_np: np.ndarray, seeds: dict,
             override: Optional[dict] = None):
        """compute_loop_production on one configuration, its start vector
        and null vectors drawn from `seeds` (gauge.member_seeds); `override`
        replaces entries of the configuration's "eig" and "mg" groups (the
        warm-up's) and its "basis_precision" (the control's)."""
        override = override or {}
        cfg = self.config
        eig = self._EigParam(**{**self.eig, **override.get("eig", {})})
        mg = None
        if cfg.get("mg"):
            m = {**cfg["mg"], **override.get("mg", {})}
            mg = self._MGParam(
                n_level=m["n_level"],
                geo_block_size=[tuple(b) for b in m["geo_block_size"]],
                n_vec=list(m["n_vec"]), setup_iters=m["setup_iters"],
                setup_seed=seeds["mg"])
        return self.production.compute_loop_production(
            U_np, self.gauge, self.inv, eig, self.loop, use_mg=mg is not None,
            mg=mg, precision=cfg["link_precision"],
            basis_precision=override.get("basis_precision",
                                         cfg["basis_precision"]),
            seed=seeds["start"],
            device=self.device)


class Capture:
    """Wraps the entry's measurement to keep the eigenvectors it measured
    on; `host()` copies the last call's to the host and lets them go."""

    def __init__(self, production):
        self.production = production
        self.inner = production._measure_production_kernel
        self.taken = None

    def __call__(self, geom, loop_param, cp, evecs_k, sigma, *args):
        self.taken = evecs_k
        return self.inner(geom, loop_param, cp, evecs_k, sigma, *args)

    def host(self) -> torch.Tensor:
        evecs, self.taken = self.taken.to("cpu"), None
        return evecs

    def __enter__(self):
        self.production._measure_production_kernel = self
        return self

    def __exit__(self, *exc):
        self.production._measure_production_kernel = self.inner


def make_gauge(dims, gauge_seed: int, device: str) -> np.ndarray:
    """A hot gauge as the entry takes it: numpy complex128
    [4, T, Z, Y, X, 3, 3]."""
    return gauges.hot_gauge(dims, gauge_seed, device).cpu().numpy()


def _sync(device: str):
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _reset_peak(device: str):
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()


def _peak(device: str) -> int:
    if device.startswith("cuda"):
        return int(torch.cuda.max_memory_allocated())
    return 0


def setup(cell, seed: int, device: str) -> Program:
    """The cell's kernels built (first run) or loaded, and one warm-up call
    of the entry with the configuration's "warmup" overrides.  The
    program's `setup_parts` holds the seconds of each step."""
    from mugiq_tpu_torch.kernels import build

    t0 = time.perf_counter()
    if device.startswith("cuda"):
        build.build_all(cell.config["kernels"])
    t1 = time.perf_counter()
    program = Program(cell.config, cell.traffic, device)
    warm = gauges.member_seeds(gauges.derive_seed(seed, 0, gauges.WARMUP),
                               0)
    U = make_gauge(program.dims, warm["gauge"], device)
    t2 = time.perf_counter()
    program.call(U, warm, cell.config["warmup"])
    _sync(device)
    program.setup_parts = {"kernels": t1 - t0, "gauge": t2 - t1,
                           "warm-up call": time.perf_counter() - t2}
    return program


def ensemble_order(traffic: dict, seed: int) -> list:
    """The traffic's ensemble members in the order a run with `seed` takes
    them, one pass."""
    members = [int(k) for k in traffic["ensemble"]["members"]]
    return [members[i] for i in gauges.stream_order(seed, len(members))]


def run_window(run: Run, program: Program, seconds: float,
               t_start: float) -> None:
    """The timed stream of configurations (run.calls): whole passes through
    the ensemble's members, until the timed calls reach `seconds`."""
    from mugiq_tpu_torch.utils import PHASE_TIMES

    dev = run.device
    marker = nullcontext
    if run.trace:
        from torch.profiler import record_function

        def marker():
            return record_function("portbench.configuration")
    ens_seed = int(run.cell.traffic["ensemble"]["seed"])
    order = ensemble_order(run.cell.traffic, run.seed)
    with Capture(program.production) as cap:
        while run.window_s < seconds or len(run.calls) % len(order):
            member = order[len(run.calls) % len(order)]
            seeds = gauges.member_seeds(ens_seed, member)
            U = make_gauge(program.dims, seeds["gauge"], dev)
            phases0 = dict(PHASE_TIMES)
            _sync(dev)
            _reset_peak(dev)
            if not run.calls:
                run.setup_s = time.perf_counter() - t_start
            with marker():
                t0 = time.perf_counter()
                res = program.call(U, seeds)
                _sync(dev)
                dt = time.perf_counter() - t0
            run.calls.append(Call(
                member=member, seconds=dt,
                phases=_delta(dict(PHASE_TIMES), phases0),
                n_restarts=int(res.n_restarts),
                converged=bool(res.converged),
                evals=np.asarray(res.evals), data_mom=res.data_mom,
                evecs=cap.host(), peak_bytes=_peak(dev)))
            del U, res
