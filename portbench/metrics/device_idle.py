"""device_idle: the share of the timed calls in which no operation ran on
the device, 100 (1 - union of device op intervals / the calls' time), from
the torch.profiler trace of a --trace 1 run."""


def read(run):
    t = run.traced
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
