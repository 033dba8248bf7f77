"""Benchmarks of the port on one GPU.

Microbenchmarks of its design questions:

  micro_kernels - routing and check-node probes P1-P4 (the counterpart of
                  benchmarks/micro_pallas.py);
  micro_layout  - layout probes P5-P7 (the counterpart of
                  benchmarks/micro_layout.py).

The coding-performance harness, writing into results/ by default:

  fer_curves    - FER/BER waterfalls of the BASELINE configurations and
                  their variants (benchmarks/fer_curves.py), and
                  compare_records, which holds two such records (or two
                  offset sweeps) to each other;
  offset_sweep  - the EMS/T-EMS offset correction swept at one Eb/N0
                  (benchmarks/offset_sweep.py);
  ber_precision - bf16 against f32 message storage in the resident QSPA
                  kernels (benchmarks/ber_precision.py).

The throughput harness, writing into results/ by default:

  run_all       - sim-step throughput of the JAX script's 18
                  configurations at their batches and budgets, device and
                  host clock side by side (benchmarks/run_all.py);
  scaling       - one step's counters across rank layouts on 8 ranks,
                  which must all equal one rank's
                  (benchmarks/scaling_cpu.py).

All run on the card by default (`--device cuda`, which needs one and never
falls back); `--device cpu` runs the plain PyTorch versions on the CPU.
Every printed line and record names the device, and on a card its power
limit.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

RESULTS = Path(__file__).resolve().parent / "results"


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


def merge_records(path: Path, records: list, key: str, order: list) -> None:
    """Write `records` into the JSON list at `path`, replacing the records
    already there that have the same `key` and keeping the rest, in the
    order of the keys in `order`: one failing configuration loses nothing,
    and a rerun of one updates it in place."""
    path.parent.mkdir(parents=True, exist_ok=True)
    merged = {r[key]: r for r in json.loads(path.read_text())} if path.exists() else {}
    merged.update({r[key]: r for r in records})
    path.write_text(json.dumps([merged[k] for k in order if k in merged]
                               + [r for k, r in merged.items() if k not in order],
                               indent=2))
