"""The readings that the limits of a cell's check are set from, on the card
at the cell's own size (set-up paid once, then one configuration a member:
members of an ensemble, as the traffic names them):

    python3 -m portbench.readings --workload <cell> --ensemble 20261018 \
        --members 0 1 2 ...
    python3 -m portbench.readings --workload <cell> --ensemble 7 \
        --members 0 1 2 --control bf16

prints one JSON line a member: the numbers that check.py compares, the
restarts and whether the eigensolve converged.  Without --control they are
the program's (the lower readings); with --control they are a control's
(the upper readings):

* ``bf16``: the program's own bfloat16 Krylov basis
  (``basis_precision="bf16"``; in an MG configuration, whose entry keeps
  its coarse basis in f32, the coarse Lanczos's ``basis_dtype`` set to
  bfloat16 around the call), and the loops of the reference put in the
  program's place in bfloat16 (check.numbers with lowp);
* ``tf32``: the program with TF32 allowed in its float32 GEMMs (the
  program pins them to full f32 on import), its own loops.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def bf16_coarse_basis(production):
    """The MG entry's coarse Lanczos with its basis stored in bfloat16 (the
    coarse operator, plain torch on complex views, takes them in f32)."""
    inner = production.lanczos_hermitian_realpair

    def lanczos(matvec, v0, **kw):
        return inner(lambda v: matvec(v.float()), v0,
                     basis_dtype=torch.bfloat16, **kw)

    production.lanczos_hermitian_realpair = lanczos
    try:
        yield
    finally:
        production.lanczos_hermitian_realpair = inner


def readings(cell, ensemble: int, members, control=None, device="cuda"):
    """[{member, numbers...}] for the `members` of ensemble `ensemble`."""
    from . import check, gauge as gauges, harness

    check.pin_precision()
    program = harness.setup(cell, ensemble, device)
    print(json.dumps({"setup": program.setup_parts}), file=sys.stderr,
          flush=True)
    override = {"basis_precision": "bf16"} if control == "bf16" else {}
    out = []
    for k in members:
        seeds = gauges.member_seeds(ensemble, k)
        U = harness.make_gauge(program.dims, seeds["gauge"], device)
        mg_ctl = (bf16_coarse_basis(program.production)
                  if control == "bf16" and cell.config.get("mg")
                  else contextlib.nullcontext())
        torch.backends.cuda.matmul.allow_tf32 = control == "tf32"
        with harness.Capture(program.production) as cap, mg_ctl:
            t0 = time.perf_counter()
            res = program.call(U, seeds, override)
            harness._sync(device)
            dt = time.perf_counter() - t0
        check.pin_precision()
        del U
        evecs = cap.host()
        got = check.numbers(cell, seeds, evecs, res.evals, res.data_mom,
                            device, lowp=control == "bf16")
        out.append({"ensemble": ensemble, "member": k, "control": control,
                    **got, "restarts": int(res.n_restarts),
                    "converged": bool(res.converged), "seconds": dt})
        print(json.dumps(out[-1]), flush=True)
        del res, evecs
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--ensemble", type=int, required=True)
    p.add_argument("--members", type=int, nargs="+", required=True)
    p.add_argument("--control", choices=("bf16", "tf32"))
    args = p.parse_args(argv)
    from .manifest import load_cell
    cell = load_cell(args.workload, Path.cwd())
    if not torch.cuda.is_available():
        print("portbench.readings needs a CUDA device", file=sys.stderr)
        return 2
    readings(cell, args.ensemble, args.members, args.control, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
