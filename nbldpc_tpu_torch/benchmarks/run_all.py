"""Throughput of the BASELINE configurations and their variants on one GPU.

The counterpart of benchmarks/run_all.py. Each configuration of CONFIGS
(the JAX script's, row for row: code, decoder, iteration budget, frames a
SNR point, SNR points) is timed over the full sim step
(`sim.make_sim_step`: noise -> llr_init -> decode -> error counters) at
its fixed budget (early_term=False, stats_each_iter=False), all-zero
codeword, sigma 0.7 + 0.05 i at SNR slot i, f32 message storage unless the
row sets mm_precision="bf16", and the kernels `cn_impl="auto"` picks.

    python -m nbldpc_tpu_torch.benchmarks.run_all [--tag h100] [--quick]
        [--only gf16] [--device cuda|cpu] [--out DIR]

Sizes: on the CPU, or with --quick, at most 32 frames a SNR point; 10
timed steps a block on the card, 1 on the CPU. Timing, per configuration:
`first_call_s`, the first step to its end (on the first CUDA use of the
process it includes the kernel build); one warm-up step, its counters
fetched; `ms_per_step`,
the smaller of two blocks of back-to-back steps, each step with its own
generator (`sim.step_generator(0, t)`), between two CUDA events (on the
CPU: the host clock); `wall_ms_per_step`, as many steps on the host clock,
each followed by the fetch of its counters (`sim.step_counters`), as
`sim.run_sweep` runs them. The gap between the two is the host's share at
the configuration's batch. The JAX script times chained steps and takes
the slope, to work around its TPU's remote link; a card needs neither.

Each record keeps the JAX record's keys (config, code, iters, batch,
n_snr, symbols_per_s = frames_per_s * n, frames_per_s, timing:
"cuda_events" or "host_clock"), with the device fields
(`benchmarks.device_fields`) in place of its platform, and adds
first_call_s, ms_per_step, wall_ms_per_step, the steps the configuration
ran and the launches of every kernel wrapper and plain version over them
(`kernels.launch_counts`). The records go to DIR/run_all_<tag>.json
(default DIR: this package's results/), merged by configuration in
CONFIGS order after each configuration: an --only rerun updates its
record in place, and one failing configuration loses nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from nbldpc_tpu_torch.benchmarks import (
    RESULTS, device_fields, first_call_s, merge_records, time_ms,
)
from nbldpc_tpu_torch.cli import code_config, resolve_device

SEED = 0

# name, code, decoder kwargs, iters, batch (frames a SNR point), n_snr:
# benchmarks/run_all.py's CONFIGS, row for row
CONFIGS = [
    ("gf4_qspa_20it", "gf4_n96_k48", dict(kind="qspa"), 20, 4096, 1),
    ("gf16_qspa_50it", "gf16_n204_k102", dict(kind="qspa"), 50, 4096, 1),
    ("gf16_qspa_50it_bf16", "gf16_n204_k102",
     dict(kind="qspa", mm_precision="bf16"), 50, 4096, 1),
    ("gf16_ems_nm16_20it", "gf16_n204_k102", dict(kind="ems", nm=16), 20, 8192, 1),
    ("gf64_tems_20it", "gf64_n576_k480", dict(kind="tems"), 20, 256, 1),
    ("gf256_qspa_10it", "gf256_n255_k175", dict(kind="qspa"), 10, 128, 1),
    ("gf256_ems_nm16_10it", "gf256_n255_k175", dict(kind="ems", nm=16), 10, 128, 1),
    # BASELINE config 5's form: every SNR point in one step
    ("gf256_qspa_10it_4snr", "gf256_n255_k175", dict(kind="qspa"), 10, 128, 4),
    ("gf256_ems_nm16_10it_4snr", "gf256_n255_k175", dict(kind="ems", nm=16), 10, 128, 4),
    # the bubble merge
    ("gf256_ems_bubble_10it", "gf256_n255_k175",
     dict(kind="ems", nm=16, offset=0.0, ems_merge="bubble"), 10, 128, 1),
    # truncated-deviation T-EMS
    ("gf64_tems_nr8_20it", "gf64_n576_k480",
     dict(kind="tems", tems_nr=8), 20, 256, 1),
    ("gf64_tems_nr4_20it", "gf64_n576_k480",
     dict(kind="tems", tems_nr=4), 20, 256, 1),
    # quasi-cyclic codes beside the PEG rows
    ("gf16_qspa_qc_slot_50it", "gf16_n204_k102_qc", dict(kind="qspa"),
     50, 4096, 1),
    ("gf4_qspa_qc_20it", "gf4_n96_k48_qc", dict(kind="qspa"), 20, 4096, 1),
    ("gf16_ems_qc_slot_20it", "gf16_n204_k102_qc", dict(kind="ems", nm=16),
     20, 8192, 1),
    # chunk8 PEG codes: the PEG rows' graphs with grouped weights
    ("gf16_qspa_c8_50it", "gf16_n204_k102_c8", dict(kind="qspa"),
     50, 4096, 1),
    ("gf4_qspa_c8_20it", "gf4_n96_k48_c8", dict(kind="qspa"), 20, 4096, 1),
    ("gf16_ems_c8_20it", "gf16_n204_k102_c8", dict(kind="ems", nm=16),
     20, 8192, 1),
]


def row_step(graph, deckw: dict, iters: int, batch: int, n_snr: int) -> tuple:
    """(step, sigmas) of a configuration on `graph`: the sim step at the
    fixed budget and the JAX script's noise, sigma 0.7 + 0.05 i at slot i."""
    import torch

    from nbldpc_tpu_torch.sim import make_sim_step
    from nbldpc_tpu_torch.utils.config import DecoderConfig

    dec = DecoderConfig(max_iters=iters, early_term=False, stats_each_iter=False, **deckw)
    sigmas = torch.tensor([0.7 + 0.05 * i for i in range(n_snr)], dtype=torch.float32,
                          device=graph.device)
    return make_sim_step(graph, dec, batch, n_snr), sigmas


def measure(name: str, code: str, deckw: dict, iters: int, batch: int, n_snr: int,
            device, reps: int) -> dict:
    """The record of one configuration (see the module docstring)."""
    from nbldpc_tpu_torch.graph import TannerGraph
    from nbldpc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nbldpc_tpu_torch.sim import step_counters, step_generator

    spec = code_config(code).load()
    step, sig = row_step(TannerGraph(spec, device=device), deckw, iters, batch, n_snr)
    reset_launch_counts()
    first_s = first_call_s(lambda: step(step_generator(SEED, 0, device), sig), device)
    step_counters(step, step_generator(SEED, 1, device), sig)
    gens = iter([step_generator(SEED, t, device) for t in range(2, 2 + 2 * reps)])
    ms = min(time_ms(lambda: step(next(gens), sig), device, reps) for _ in range(2)) / reps
    t0 = time.perf_counter()
    for t in range(2 + 2 * reps, 2 + 3 * reps):
        step_counters(step, step_generator(SEED, t, device), sig)
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    launches = launch_counts()
    frames_per_s = batch * n_snr / (ms * 1e-3)
    precision = deckw.get("mm_precision", "f32")
    return {
        "config": name, "code": code, "iters": iters, "batch": batch, "n_snr": n_snr,
        "symbols_per_s": frames_per_s * spec.n, "frames_per_s": frames_per_s,
        "timing": "cuda_events" if device.type == "cuda" else "host_clock",
        "first_call_s": first_s, "ms_per_step": ms, "wall_ms_per_step": wall_ms,
        "mm_precision": precision,
        # the CPU's torch path decodes in f32 whatever the row says
        "mm_precision_applied": precision == "f32" or device.type == "cuda",
        "reps": reps, "steps": 2 + 3 * reps, "launches": launches,
        **device_fields(device),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nbldpc_tpu_torch.benchmarks.run_all")
    ap.add_argument("--tag", default="h100")
    ap.add_argument("--quick", action="store_true", help="small batches")
    ap.add_argument("--only", default=None, help="substring filter")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--out", default=str(RESULTS), help="directory of the records")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        import torch

        torch.cuda.set_device(device)
    on_card = device.type == "cuda"
    reps = 10 if on_card else 1
    out = Path(args.out) / f"run_all_{args.tag}.json"
    for name, code, deckw, iters, batch, n_snr in CONFIGS:
        if args.only and args.only not in name:
            continue
        if not on_card or args.quick:
            batch = min(batch, 32)
        rec = measure(name, code, deckw, iters, batch, n_snr, device, reps)
        print(json.dumps(rec), flush=True)
        merge_records(out, [rec], "config", [c[0] for c in CONFIGS])
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
