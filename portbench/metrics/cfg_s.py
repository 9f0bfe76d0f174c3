"""cfg_s: seconds per gauge configuration, the summed wall time of every
completed call of the window over the number completed (host clock; each
call ends with its results on the host)."""


def read(run):
    return run.window_s / len(run.calls)
