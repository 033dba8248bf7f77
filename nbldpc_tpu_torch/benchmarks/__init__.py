"""Microbenchmarks of the port's design questions on one GPU.

  micro_kernels - routing and check-node probes P1-P4 (the counterpart of
                  benchmarks/micro_pallas.py);
  micro_layout  - layout probes P5-P7 (the counterpart of
                  benchmarks/micro_layout.py).

Both run on the card by default (`--device cuda`, which needs one and never
falls back); `--device cpu` runs the plain PyTorch versions on the CPU.
Every printed line names the device, and on a card its power limit.
"""

from __future__ import annotations

import time

import torch


def device_fields(device: torch.device) -> dict:
    """The device's name and, on a card, `name, power.limit` from nvidia-smi."""
    if device.type != "cuda":
        return {"device": "cpu"}
    from nbldpc_tpu_torch.bench import card_info

    return {"device": torch.cuda.get_device_name(device), "card": card_info()}


def time_ms(fn, device: torch.device, calls: int = 1) -> float:
    """Milliseconds of `calls` back-to-back calls of fn: between two CUDA
    events on a card, on the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e3


def first_call_s(fn, device: torch.device) -> float:
    """Seconds of one call of fn to its end (on a first CUDA use it builds
    the kernel library)."""
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0
