"""The --trace 1 run's device trace: torch.profiler over the window, reduced
to device time by kernel name, the device's busy seconds inside the timed
calls, and the longest idle gaps by the host op that ran during them.

``device_time_by_kernel`` is a copy of the arithmetic of the program's
``mugiq_tpu_torch/trace.py``; the window here is the timed calls alone
(markers named ``portbench.configuration``), not the process.
"""

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

MARKER = "portbench.configuration"
#: the idle gaps, longest first, that the breakdown labels by host op
N_GAPS = 4000


def device_time_by_kernel(events):
    """{device op name: [device us, launches]} over the CUDA events
    (name, device type, start ns, duration ns, thread)."""
    from torch.autograd import DeviceType

    per = defaultdict(lambda: [0.0, 0])
    for name, dev, _, dur, _ in events:
        if dev == DeviceType.CUDA:
            per[name][0] += dur / 1e3
            per[name][1] += 1
    return per


def _inside(t, windows):
    return any(ws <= t < we for ws, we in windows)


def union(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(intervals, windows):
    """The parts of merged `intervals` inside the merged `windows`."""
    out = []
    for ws, we in windows:
        for s, e in intervals:
            if e > ws and s < we:
                out.append([max(s, ws), min(e, we)])
    return out


@dataclass
class Traced:
    """What the readers take from the trace (times in seconds)."""
    window_s: float = 0.0
    busy_s: float = 0.0
    by_kernel: dict = field(default_factory=dict)   # name -> [s, launches]
    device_ops: list = field(default_factory=list)  # [[name, s]], top 10
    idle_gaps: list = field(default_factory=list)   # [[host op, s]], top 10


def _parents(cpu):
    """parent[i]: the innermost op of `cpu` (sorted by start, nested, one
    thread) that covers op i's start, or -1."""
    parent, stack = [], []
    for i, (s, e, _) in enumerate(cpu):
        while stack and cpu[stack[-1]][1] < s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return parent


def _host_op_at(cpu, starts, parent, t):
    """The innermost op running at time t: from the latest op started by t,
    up its parents (any op covering t covers that one) to one still
    running."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and cpu[i][1] < t:
        i = parent[i]
    return cpu[i][2] if i >= 0 else None


def reduce(prof) -> Traced:
    """Traced of a finished torch.profiler.profile, read from its raw
    kineto events (the profiler's own event tree takes minutes to build for
    a window of this size)."""
    return reduce_events(
        [(e.name(), e.device_type(), e.start_ns(), e.duration_ns(),
          e.start_thread_id())
         for e in prof.profiler.kineto_results.events()])


def reduce_events(events) -> Traced:
    """Traced of the events (name, device type, start ns, duration ns,
    thread); the windows are the host spans named MARKER."""
    from torch.autograd import DeviceType

    mark = [e for e in events if e[0] == MARKER and e[1] != DeviceType.CUDA]
    windows = union([[s, s + d] for _, _, s, d, _ in mark])
    main = mark[0][4]
    dev_events, cpu = [], []
    for e in events:
        name, dev, s, d, thread = e
        if dev == DeviceType.CUDA:
            # the marker's own span on the device timeline is no op
            if name != MARKER and _inside(s, windows):
                dev_events.append(e)
        elif thread == main and name != MARKER and d > 0:
            cpu.append((s, s + d, name))
    busy = clip(union([[s, s + d] for _, _, s, d, _ in dev_events]), windows)
    t = Traced()
    t.window_s = sum(e - s for s, e in windows) / 1e9
    t.busy_s = sum(e - s for s, e in busy) / 1e9
    # device ops of the timed calls, not of the gauges made between them
    per = device_time_by_kernel(dev_events)
    t.by_kernel = {k: [us / 1e6, n] for k, (us, n) in per.items()}
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:10]
    t.device_ops = [[k[:120], us / 1e6] for k, (us, _) in top]
    # idle gaps inside the windows, longest first, by the host op running
    gaps = []
    for ws, we in windows:
        prev = ws
        for s, e in busy:
            if e <= ws or s >= we:
                continue
            if s > prev:
                gaps.append((s - prev, prev, s))
            prev = max(prev, e)
        if we > prev:
            gaps.append((we - prev, prev, we))
    gaps.sort(reverse=True)
    cpu.sort()
    starts = [c[0] for c in cpu]
    parent = _parents(cpu)
    by_op = defaultdict(float)
    for length, s, e in gaps[:N_GAPS]:
        op = _host_op_at(cpu, starts, parent, (s + e) / 2)
        by_op[(op or "host, no torch op")[:120]] += length / 1e9
    t.idle_gaps = [[k, v] for k, v in
                   sorted(by_op.items(), key=lambda kv: -kv[1])[:10]]
    return t
