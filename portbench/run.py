"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

prints the run's result as the last line of standard output (one JSON
object: correct, attempted, failed, metrics, device[, breakdown], check)
and the numbers compared, each beside its limit, as the last lines of
standard error.  --trace 0 reports the cell's end-to-end metrics, --trace 1
its per-layer metrics from a run under torch.profiler.  Exits 2 without a
result where CUDA or the cell's cards are missing, where the program cannot
be imported, or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
#: top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "mugiq_tpu")


def _environment():
    """Caches inside the checkout, at fixed paths; the program's log quiet;
    libraries kept from loading JAX."""
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["MUGIQ_LOG_LEVEL"] = "WARNING"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    _environment()
    from .manifest import load_cell
    cell = load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    try:
        import mugiq_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not importable here: {e}",
              file=sys.stderr)
        return 2
    from .session import execute
    result, lines = execute(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that no run may load: {bad}",
              file=sys.stderr)
        return 2
    sys.stdout.flush()
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
