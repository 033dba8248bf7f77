"""Spans of the program's host work on torch.profiler's timeline.

    with span("sweep.plan", (run_sweep, "loop_ns")):
        ...

While a profiler records (`run --profile`, or a benchmark's traced run),
a span is a plain CPU op named `name` over its block
(torch._C._profiler._RecordFunctionFast): the idle gaps of the device
between kernels can then be put down to the innermost span the host was
in. It is not a user annotation (`record_function`), which the profiler
also copies onto the device's timeline over the kernels launched inside
it. With no profiler recording, a span costs one flag check.

A span given `into`, an (object, attribute) pair, also adds its block's
`time.perf_counter_ns` duration to that int attribute, recording or not:
the counters of `kernels.counted` under dotted names.
"""

from __future__ import annotations

import time

import torch

_recording = torch._C._autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


class span:
    """Context manager: mark the block `name` on the profiler's timeline
    while one records; with `into`, add its nanoseconds to that counter."""

    __slots__ = ("name", "into", "_op", "_t0")

    def __init__(self, name: str, into: tuple | None = None):
        self.name, self.into, self._op = name, into, None

    def __enter__(self):
        if _recording():
            self._op = _RecordFunctionFast(self.name)
            self._op.__enter__()
        if self.into is not None:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.into is not None:
            owner, attr = self.into
            setattr(owner, attr, getattr(owner, attr) + time.perf_counter_ns() - self._t0)
        if self._op is not None:
            op, self._op = self._op, None
            op.__exit__(*exc)
        return False
