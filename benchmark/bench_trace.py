"""The traced stretch: ``torch.profiler`` over a short part of a run, and
what the per-layer metrics read from it.

From the profiler's events the tracer keeps, per device operation name,
its summed device seconds, and the union of the device operations'
intervals on the timeline (the busy seconds: time in which at least one
operation ran, so overlapping kernels count once).  The traced window is
the host clock from the start to the stop of the profiler, each after a
synchronize.  The idle gaps are the longest stretches between busy
intervals, each named after the innermost host operation that covers
its middle.  No trace file is written.
"""

import time

import torch

__all__ = ["Tracer", "union_seconds", "gaps"]


def union_seconds(intervals):
    """Total length of the union of ``(start, end)`` intervals, and the
    merged intervals in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def gaps(merged, host, top=10):
    """The ``top`` longest gaps between merged busy intervals as
    ``[name, seconds]``, named after the shortest host interval
    ``(start, end, name)`` that covers the gap's middle."""
    found = [(merged[i + 1][0] - merged[i][1], merged[i][1],
              merged[i + 1][0]) for i in range(len(merged) - 1)]
    found.sort(reverse=True)
    out = []
    for length, s, e in found[:top]:
        mid = 0.5 * (s + e)
        best = None
        for hs, he, name in host:
            if hs <= mid <= he and (best is None or he - hs < best[0]):
                best = (he - hs, name)
        out.append([best[1] if best else "host", length])
    return out


class Tracer:
    """Start and stop the profiler once; ``result()`` then holds
    ``busy_s``, ``window_s``, ``per_kernel`` (device seconds by name),
    ``device_ops`` and ``idle_gaps`` (the ten largest of each)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.t0 = self.window_s = None
        self.done = False

    def start(self):
        if self.prof is not None or self.done:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        if self.prof is None or self.done:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.done = True

    def result(self):
        if self.prof is None:
            return None
        dev_type = torch.autograd.DeviceType.CUDA
        intervals, host, per_kernel = [], [], {}
        for ev in self.prof.events():
            tr = ev.time_range
            s, e = tr.start * 1e-6, tr.end * 1e-6
            if ev.device_type == dev_type:
                intervals.append((s, e))
                per_kernel[ev.name] = per_kernel.get(ev.name, 0.0) + (e - s)
            else:
                host.append((s, e, ev.name))
        busy, merged = union_seconds(intervals)
        ops = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
        return dict(busy_s=busy, window_s=self.window_s,
                    per_kernel=per_kernel,
                    device_ops=[[k, v] for k, v in ops],
                    idle_gaps=gaps(merged, host))
