"""Reduce a torch.profiler trace of the window to what the per-layer
metrics and the result's `breakdown` read.

  kernels   {device op name: [seconds, launches]} summed over the window;
  busy_s    the seconds in which some operation (kernel, copy or fill) ran
            on the device: the union of their intervals;
  device_ops  the 10 device ops that took most time, [name, seconds];
  idle_gaps   the idle time between device ops, summed by what the host
            was doing meanwhile (the innermost host op under the gap's
            midpoint, or "host code" where none was traced), the 10
            largest, [name, seconds].
"""

from __future__ import annotations

import bisect

NAME_CHARS = 120


def _is_device(ev) -> bool:
    from torch.autograd import DeviceType

    return ev.device_type == DeviceType.CUDA


def reduce(events) -> dict:
    """The reduction of a profiler's events() (FunctionEvents)."""
    kernels, dev, host = {}, [], []
    for ev in events:
        start, end = ev.time_range.start, ev.time_range.end
        if _is_device(ev):
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += (end - start) * 1e-6
            k[1] += 1
            dev.append((start, end))
        elif end > start:
            host.append((start, end, ev.name))
    dev.sort()
    merged = []
    for s, e in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    idle = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid)
        label, width = "host code", None
        for s, e, name in reversed(host[max(0, i - 64):i]):
            if e >= mid and (width is None or e - s < width):
                label, width = name, e - s
        idle[label] = idle.get(label, 0.0) + (s1 - e0) * 1e-6
    top = lambda d: sorted(([k[:NAME_CHARS], v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:10]
    return {"kernels": kernels, "busy_s": busy,
            "device_ops": top({k: v[0] for k, v in kernels.items()}),
            "idle_gaps": top(idle)}


def kernel(ctx: dict, part: str) -> tuple:
    """(seconds, launches) of the device ops whose name holds `part`."""
    secs, n = 0.0, 0
    for name, (s, c) in ctx["kernels"].items():
        if part in name:
            secs, n = secs + s, n + c
    return secs, n
