"""The device trace of a traced run: torch.profiler over part of the
window, reduced to the device's busy time (the union of its kernels'
intervals), the kernels by time, the idle gaps by the benchmark span the
host was in, and the device time of the kernels inside a span.
"""

import collections

import torch
from torch.profiler import ProfilerActivity, profile

PREFIX = "speedbench."
WINDOW = PREFIX + "trace_window"


class DeviceTrace:
    """The profiler starts (which takes seconds) with the object, before
    the window; mark() opens the traced window, stop() closes it and the
    profiler; then reduce()."""

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW)
        self.open = False

    def mark(self):
        self._range.__enter__()
        self.open = True

    def stop(self):
        if self.open:
            torch.cuda.synchronize()
            self._range.__exit__(None, None, None)
            self.open = False
        self.prof.__exit__(None, None, None)

    def reduce(self, top=10):
        return reduce_events(self.prof.events(), top)


def _is_annotation(e):
    return (getattr(e, "is_user_annotation", False)
            or e.name.startswith(PREFIX))


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def _overlap(intervals, ranges):
    """The length of the union of `intervals` inside the union of
    `ranges` (both lists of (start, end))."""
    total = 0.0
    ranges = _union(ranges)
    for a, b in _union(intervals):
        for lo, hi in ranges:
            total += max(0.0, min(b, hi) - max(a, lo))
    return total


def reduce_events(events, top=10):
    """{window_s, busy_s, device_ops, idle_gaps, span_device_s} from the
    profiler's events (times in microseconds). span_device_s[name] is the
    device time of the kernels inside the device-side ranges of the
    benchmark span `name`, where the trace has such ranges."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, gpu_ranges, cpu_ranges = [], collections.defaultdict(list), []
    window = None
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if _is_annotation(e):
                if e.name.startswith(PREFIX):
                    gpu_ranges[e.name[len(PREFIX):]].append((start, end))
            else:
                kernels.append((start, end, e.name))
        elif e.name == WINDOW:
            window = (start, end)
        elif e.name.startswith(PREFIX):
            cpu_ranges.append((start, end, e.name[len(PREFIX):]))
    if window is None:
        raise RuntimeError("the trace has no window range")
    lo, hi = window
    intervals = _clip([(a, b) for a, b, _ in kernels], lo, hi)
    busy = _union(intervals)
    by_name = collections.Counter()
    for a, b, name in kernels:
        by_name[name[:120]] += (min(b, hi) - max(a, lo)) if b > lo and a < hi \
            else 0.0
    gaps = collections.Counter()
    edge = lo
    for a, b in busy + [[hi, hi]]:
        if a > edge:
            gaps[_host_span(cpu_ranges, edge)] += a - edge
        edge = max(edge, b)
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "n_kernels": len(intervals),
        "device_ops": [[n, s / 1e6] for n, s in by_name.most_common(top)],
        "idle_gaps": [[n, s / 1e6] for n, s in gaps.most_common(top)],
        "span_device_s": {name: _overlap(intervals, r) / 1e6
                          for name, r in gpu_ranges.items()},
    }


def _host_span(cpu_ranges, t):
    """The innermost benchmark span that the host was in at time t."""
    best = None
    for a, b, name in cpu_ranges:
        if a <= t < b and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else "between_spans"
