"""Device time by kernel for one CLI run, from torch.profiler.

    python -m mugiq_tpu_torch.trace eigensolve --dims 32 32 32 64 \
        --gauge random --gauge-seed 1 --kappa 0.12 ... --solve-type direct-pc
    python -m mugiq_tpu_torch.trace loop --dims ...

Builds the kernels first, outside the window, then runs the CLI's
``run(argv)`` once under torch.profiler (CPU and CUDA activities) and
prints the device time of each kernel name, largest first, the total
device time and the window's wall time (host set-up included).  Needs a
CUDA device.
"""

import sys
import time
from collections import defaultdict


def device_time_by_kernel(events):
    """{kernel name: [device us, launches]} over the CUDA events."""
    from torch.autograd import DeviceType

    per = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type == DeviceType.CUDA:
            per[e.name][0] += e.time_range.elapsed_us()
            per[e.name][1] += 1
    return per


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("loop", "eigensolve"):
        raise SystemExit("usage: python -m mugiq_tpu_torch.trace "
                         "{loop,eigensolve} <CLI arguments>")
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("mugiq_tpu_torch.trace needs a CUDA device")
    from .cli import eigensolve, loop
    from .kernels import build

    build.build_all()
    run = {"loop": loop.run, "eigensolve": eigensolve.run}[argv[0]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(argv[1:])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per = device_time_by_kernel(prof.events())
    total = sum(us for us, _ in per.values())
    print(f"trace: window {wall:.3f} s, device {total / 1e6:.3f} s "
          f"({total / 1e6 / wall:.3f} of the window)")
    for name, (us, n) in sorted(per.items(), key=lambda kv: -kv[1][0]):
        print(f"trace: {us / 1e6:9.4f} s {100 * us / total:5.1f}% "
              f"{n:7d} x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
