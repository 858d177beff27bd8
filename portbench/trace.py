"""Reading torch.profiler's trace of a window: the card's busy time (the
union of every device operation's interval), kernel time by name, the
host's launch calls, and the idle gaps labelled by what the host was doing.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
_MIN_GAP_US = 5.0


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int
    kernels: list  # (name, start_us, end_us) of every device operation
    device_ops: list  # [name, seconds], the 10 that took most time
    idle_gaps: list  # [host activity, seconds], the 10 that idled most

    def kernel_time(self, match) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name matches."""
        hits = [(s, e) for n, s, e in self.kernels if match(n)]
        return sum(e - s for s, e in hits) / 1e6, len(hits)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label_gaps(gaps, host):
    """Labels each gap by the innermost host operation (the latest to
    start, on any thread) running at its middle. The profiler sees the CUDA
    calls of every thread but the operator spans only of threads it was
    started on, so a gap in the client threads' Python reads as outside
    any CUDA call."""
    import bisect

    host.sort()
    starts = [h[0] for h in host]
    out = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "host outside any CUDA call"
        for j in range(i, max(-1, i - 5000), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        out[label] += (e - s) / 1e6
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])[:10]


def summarise(events, window_us: float) -> Trace:
    """A Trace from (name, on_device, start_us, end_us) of every event, on
    the profiler's clock, clipped to [0, window_us]."""
    kernels, host, launches = [], [], 0
    totals = defaultdict(float)
    for name, on_device, s, e in events:
        if on_device:
            s, e = max(s, 0.0), min(e, window_us)
            if e > s:
                kernels.append((name, s, e))
                totals[name] += (e - s) / 1e6
        else:
            launches += name in LAUNCH_CALLS
            host.append((s, e, name))
    busy = _merge([(s, e) for _n, s, e in kernels])
    edges = [0.0] + [x for iv in busy for x in iv] + [window_us]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] - edges[i] >= _MIN_GAP_US]
    device_ops = sorted(([k, v] for k, v in totals.items()),
                        key=lambda kv: -kv[1])[:10]
    return Trace(
        window_s=window_us / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        launches=launches, kernels=kernels, device_ops=device_ops,
        idle_gaps=_label_gaps(gaps, host),
    )


def raw_events(prof):
    """(name, on_device, start_us, end_us) of the profiler's raw events,
    relative to the trace's start: read without building the profiler's
    own event tree, which takes minutes over a seal's million launches."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    for evt in res.events():
        yield (evt.name(), "CUDA" in str(evt.device_type()),
               (evt.start_ns() - t0) / 1e3, (evt.end_ns() - t0) / 1e3)


class Profiled:
    """``with Profiled(cpu=True) as p: ...`` then ``p.trace``: the window is
    the time between entering and leaving, ended by a device sync;
    ``p.t0``, ``p.t1`` are its ends on the host's clock, and ``p.state`` what
    ``at_stop()`` returned there, before the profiler stops (stopping and
    reading the trace take seconds that belong to no window)."""

    def __init__(self, cpu: bool = True, at_stop=None):
        self.cpu, self.at_stop = cpu, at_stop
        self.trace: Trace | None = None
        self.state = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.cpu else [])
        torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self.at_stop is not None:
            self.state = self.at_stop()
        window_us = (self.t1 - self.t0) * 1e6
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = summarise(raw_events(self._prof), window_us)
        return False
