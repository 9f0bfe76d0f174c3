"""The trace reducer's arithmetic on a few synthetic events: the windows are
the marker's host spans, the marker's own device span is no op, device ops
outside the windows are left out and those across an edge clipped, and the
idle gaps are labelled by the innermost host op of the main thread."""

import math

from torch.autograd import DeviceType

from portbench import tracing

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
M = tracing.MARKER


def _events():
    # (name, device type, start ns, duration ns, thread)
    return [
        (M, CPU, 1000, 4000, 1),           # window 1: [1000, 5000]
        (M, CPU, 10000, 4000, 1),          # window 2: [10000, 14000]
        (M, CUDA, 1000, 4000, 0),          # the marker on the device
        ("k1", CUDA, 1500, 1000, 0),
        ("k2", CUDA, 2000, 1000, 0),       # overlaps k1: busy [1500, 3000]
        ("k1", CUDA, 4500, 1500, 0),       # across the edge: [4500, 5000]
        ("gauge", CUDA, 7000, 1000, 0),    # between the windows
        ("k1", CUDA, 10000, 1000, 0),
        ("aten::mm", CPU, 2800, 1800, 1),  # covers the gap [3000, 4500]
        ("outer", CPU, 11000, 3000, 1),
        ("inner", CPU, 11500, 1500, 1),    # innermost at 12500
        ("other thread", CPU, 1000, 500, 2),
    ]


def test_reduce_events():
    t = tracing.reduce_events(_events())
    assert math.isclose(t.window_s, 8000e-9)
    assert math.isclose(t.busy_s, (1500 + 500 + 1000) * 1e-9)
    assert set(t.by_kernel) == {"k1", "k2"}
    assert math.isclose(t.by_kernel["k1"][0], 3500e-9)
    assert t.by_kernel["k1"][1] == 3
    assert t.by_kernel["k2"][1] == 1
    assert [k for k, _ in t.device_ops] == ["k1", "k2"]
    got = {k: v for k, v in t.idle_gaps}
    assert list(got) == ["inner", "aten::mm", "host, no torch op"]
    assert math.isclose(got["inner"], 3000e-9)
    assert math.isclose(got["aten::mm"], 1500e-9)
    assert math.isclose(got["host, no torch op"], 500e-9)


def test_union_and_clip():
    u = tracing.union([[5, 7], [1, 3], [2, 4], [7, 8]])
    assert u == [[1, 4], [5, 8]]
    assert tracing.clip(u, [[0, 2], [6, 10]]) == [[1, 2], [6, 8]]
