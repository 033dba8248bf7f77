"""Throughput benchmark on one GPU: decoded coded symbols/s and frames/s.

The timed unit is the full sim step (noise -> llr_init -> decode -> error
counters) at a fixed iteration budget in throughput mode
(early_term=False, stats_each_iter=False), all-zero codeword, messages in
f32 unless a row's config says mm_precision="bf16". Steps run
back to back after warm-up and are timed with CUDA events. Each row of
ROWS has its own code, batch, budget and noise:
  qspa_gf16_n204_k102_c8, qspa_gf16_n204_k102 - QSPA, B = 8192,
         50 iterations, sigma = 0.63 (about 2 dB at rate 1/2);
  ems_gf16_n204_k102 - EMS under the same conditions (nm = 16, offset 0.3,
         BASELINE config 3's decoder), so its symbols/s compare with QSPA's;
  tems_gf64_n576_k480 - T-EMS at BASELINE config 4's decoder and batch
         (configs/gf64_tems_earlyterm.json: n_r = 8, offset 2.0, B = 1024,
         20 iterations), sigma from 3.5 dB;
  qspa_gf256_n255_k175 - QSPA at BASELINE config 5's decoder and step
         (configs/gf256_sweep_2host.json: 20 iterations, 8 Eb/N0 points x
         512 frames = 4096 frames per step), sigma from 3.0 dB;
  ems_gf256_n255_k175 - config 5's EMS half (nm = 16, offset 0.1) at the
         same step: the classic check-node kernel inside decode_bl, between
         its two routing kernels (kernel path only: the plain path takes
         ~16 s per step there);
  ems_bubble_gf256_n255_k175 - the same step through the bubble merge (nm
         = 16, offset 0.0, the JAX package's gf256_ems_bubble record): the
         bubble check-node kernel inside decode_bl, between its routing
         kernels (kernel path only);
  qspa_gf16_n204_k102_c8_bf16, qspa_gf256_n255_k175_bf16 - the first and
         the fifth row with bf16 message storage (mm_precision="bf16": K0
         and K0-cl's cluster kernel built for bf16 state; the "torch" path
         ignores the mode and decodes in f32).

    python -m nbldpc_tpu_torch bench
    python -m nbldpc_tpu_torch bench --row qspa_gf16_n204_k102_c8_bf16

prints the card's name and power limit, then one JSON line per (row,
implementation), of every row or of the --row ones.
"""

from __future__ import annotations

import json
import subprocess
from typing import NamedTuple

import torch

from nbldpc_tpu_torch.channel import ebn0_to_sigma
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.sim import make_sim_step, step_generator
from nbldpc_tpu_torch.utils.config import CodeConfig, DecoderConfig


class Row(NamedTuple):
    """One benchmark row: the decoder on one code at one step shape."""

    name: str
    code: str
    kind: str                 # decoder kind
    impls: tuple              # cn_impl values, the kernel path first
    batch: int                # frames per step
    iters: int                # fixed iteration budget
    noise: float              # sigma, or Eb/N0 in dB when ebn0 is set
    ebn0: bool = False
    config: tuple = ()        # (DecoderConfig field, value) pairs


ROWS = [
    Row("qspa_gf16_n204_k102_c8", "gf16_n204_k102_c8", "qspa", ("resident", "torch"),
        8192, 50, 0.63),
    Row("qspa_gf16_n204_k102", "gf16_n204_k102", "qspa", ("resident", "torch"),
        8192, 50, 0.63),
    Row("ems_gf16_n204_k102", "gf16_n204_k102", "ems", ("resident", "torch"),
        8192, 50, 0.63, config=(("nm", 16), ("offset", 0.3))),
    Row("tems_gf64_n576_k480", "gf64_n576_k480", "tems", ("kernel", "torch"),
        1024, 20, 3.5, ebn0=True, config=(("tems_nr", 8), ("offset", 2.0))),
    Row("qspa_gf256_n255_k175", "gf256_n255_k175", "qspa",
        ("resident", "kernel", "torch"), 4096, 20, 3.0, ebn0=True),
    Row("ems_gf256_n255_k175", "gf256_n255_k175", "ems", ("kernel",),
        4096, 20, 3.0, ebn0=True, config=(("nm", 16), ("offset", 0.1))),
    Row("ems_bubble_gf256_n255_k175", "gf256_n255_k175", "ems", ("kernel",),
        4096, 20, 3.0, ebn0=True,
        config=(("nm", 16), ("offset", 0.0), ("ems_merge", "bubble"))),
    Row("qspa_gf16_n204_k102_c8_bf16", "gf16_n204_k102_c8", "qspa", ("resident", "torch"),
        8192, 50, 0.63, config=(("mm_precision", "bf16"),)),
    Row("qspa_gf256_n255_k175_bf16", "gf256_n255_k175", "qspa", ("resident",),
        4096, 20, 3.0, ebn0=True, config=(("mm_precision", "bf16"),)),
]
ROWS_BY_NAME = {r.name: r for r in ROWS}


def card_info() -> str:
    """`name, power.limit` of the card(s), as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _step(row: Row, cn_impl: str):
    """(step, sigma tensor, device, spec) of a row's sim step on the current
    CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    spec = CodeConfig(name=row.code).load()
    graph = TannerGraph(spec, device=device)
    sigma = float(ebn0_to_sigma(row.noise, spec.k / spec.n)) if row.ebn0 else row.noise
    config = {"mm_precision": "f32", **dict(row.config)}
    dec = DecoderConfig(kind=row.kind, max_iters=row.iters, early_term=False,
                        stats_each_iter=False, **config)
    step = make_sim_step(graph, dec, row.batch, 1, cn_impl=cn_impl)
    sig = torch.tensor([sigma], dtype=torch.float32, device=device)
    return step, sig, device, spec


def measure(row: Row, cn_impl: str, reps: int = 10) -> dict:
    """Time `reps` sim steps of `row` with `cn_impl` on the current CUDA
    device after two warm-up steps; one result record."""
    step, sig, device, spec = _step(row, cn_impl)
    for t in range(2):
        step(step_generator(0, 1000 + t, device), sig)
    torch.cuda.synchronize(device)
    gens = [step_generator(0, t, device) for t in range(reps)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for g in gens:
        out = step(g, sig)
    end.record()
    torch.cuda.synchronize(device)
    ms = start.elapsed_time(end) / reps
    return {
        "row": row.name,
        "code": row.code,
        "decoder": row.kind,
        "cn_impl": cn_impl,
        "mm_precision": dict(row.config).get("mm_precision", "f32"),
        "batch": row.batch,
        "iters": row.iters,
        "sigma": float(sig[0]),
        "ms_per_step": ms,
        "symbols_per_s": row.batch * spec.n / (ms * 1e-3),
        "frames_per_s": row.batch / (ms * 1e-3),
        "frame_errors_last_step": int(out["frame_errors"][0]),
        "device": torch.cuda.get_device_name(device),
    }


def main(rows: list | None = None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    print(card_info(), flush=True)
    unknown = [r for r in rows or () if r not in ROWS_BY_NAME]
    if unknown:
        raise ValueError(f"unknown bench rows {unknown}; rows: {list(ROWS_BY_NAME)}")
    for row in [ROWS_BY_NAME[r] for r in rows] if rows else ROWS:
        for impl in row.impls:
            print(json.dumps(measure(row, impl)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
