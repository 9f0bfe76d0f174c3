"""One run of a cell, from set-up to the result line: harness (set-up and
window), tracing (--trace 1), check (the reference, after the window has
closed and the peak memory has been read) and the metrics' readers."""

import gc
import time

import torch

from . import check, harness, manifest


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float):
    """(result dict, the lines that print the numbers compared)."""
    run = harness.Run(cell=cell, seed=seed, trace=trace, device=device)
    program = harness.setup(cell, seed, device)
    if trace:
        with _profiler() as prof:
            harness.run_window(run, program, seconds, t_start)
        from . import tracing
        run.traced = tracing.reduce(prof)
        del prof
    else:
        harness.run_window(run, program, seconds, t_start)
    program_parts = program.setup_parts
    del program
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    run.check = check.judge(cell, seed, run.calls, device)
    t_check = time.perf_counter() - t_check
    correct = check.passed(run.check)

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = manifest.metric_reader(cell, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name() if device.startswith("cuda")
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    failed = max(len(run.check["checked"]),
                 run.check["unconverged"]["value"])
    result = {"correct": correct, "attempted": len(run.calls),
              "failed": 0 if correct else failed,
              "metrics": metrics, "device": dev}
    if run.traced is not None:
        dev["busy_s"] = run.traced.busy_s
        dev["window_s"] = run.traced.window_s
        result["breakdown"] = {"device_ops": run.traced.device_ops,
                               "idle_gaps": run.traced.idle_gaps}
    result["check"] = {n: run.check[n] for n in check.NAMES}
    lines = ["setup " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                  program_parts.items()),
             "calls " + ", ".join(f"member {c.member} {c.seconds:.3f} s "
                                  f"{c.n_restarts} restarts"
                                  f"{'' if c.converged else ' unconverged'}"
                                  for c in run.calls),
             f"check members {run.check['checked']} of the "
             f"{len(run.calls)} calls, {t_check:.1f} s"]
    lines += [f"check {n} {run.check[n]['value']!r} limit "
              f"{run.check[n]['limit']!r}" for n in check.NAMES]
    return result, lines
