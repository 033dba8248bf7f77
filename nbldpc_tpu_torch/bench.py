"""Throughput benchmark on one GPU: decoded coded symbols/s and frames/s.

The timed unit is the full sim step (noise -> llr_init -> decode -> error
counters) at a fixed iteration budget in throughput mode
(early_term=False, stats_each_iter=False), f32, all-zero codeword. Steps run
back to back after warm-up and are timed with CUDA events. Each decoder
kind has its own batch, budget and noise (DECODERS):
  qspa - CODES, B = 8192, 50 iterations, sigma = 0.63 (about 2 dB at rate 1/2);
  ems  - EMS_CODE under the same conditions (nm = 16, offset 0.3, BASELINE
         config 3's decoder), so its symbols/s compare with QSPA's directly;
  tems - TEMS_CODE at BASELINE config 4's decoder and batch
         (configs/gf64_tems_earlyterm.json: n_r = 8, offset 2.0, B = 1024,
         20 iterations), sigma from 3.5 dB.

    python -m nbldpc_tpu_torch bench

prints the card's name and power limit, then one JSON line per
(code, decoder, implementation) of ROWS.
"""

from __future__ import annotations

import json
import subprocess

import torch

from nbldpc_tpu_torch.channel import ebn0_to_sigma
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.sim import make_sim_step, step_generator
from nbldpc_tpu_torch.utils.config import CodeConfig, DecoderConfig

CODES = ("gf16_n204_k102_c8", "gf16_n204_k102")
EMS_CODE = "gf16_n204_k102"
TEMS_CODE = "gf64_n576_k480"
# per decoder kind: frames per step, iteration budget, noise (sigma, or
# Eb/N0 in dB at the code's rate) and the DecoderConfig fields it sets
DECODERS = {
    "qspa": dict(batch=8192, iters=50, sigma=0.63, config={}),
    "ems": dict(batch=8192, iters=50, sigma=0.63, config=dict(nm=16, offset=0.3)),
    "tems": dict(batch=1024, iters=20, ebn0_db=3.5, config=dict(tems_nr=8, offset=2.0)),
}
# (code, decoder kind, implementations) in the order `bench` runs them
ROWS = ([(c, "qspa", ("resident", "torch")) for c in CODES]
        + [(EMS_CODE, "ems", ("resident", "torch")),
           (TEMS_CODE, "tems", ("kernel", "torch"))])


def card_info() -> str:
    """`name, power.limit` of the card(s), as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def measure(code: str, cn_impl: str, reps: int = 10, kind: str = "qspa") -> dict:
    """Time `reps` sim steps of decoder `kind` (a key of DECODERS) on the
    current CUDA device after two warm-up steps; one result record."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench.measure needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    spec = CodeConfig(name=code).load()
    graph = TannerGraph(spec, device=device)
    s = DECODERS[kind]
    batch, iters = s["batch"], s["iters"]
    sigma = s["sigma"] if "sigma" in s else float(ebn0_to_sigma(s["ebn0_db"], spec.k / spec.n))
    dec = DecoderConfig(kind=kind, max_iters=iters, early_term=False,
                        stats_each_iter=False, mm_precision="f32", **s["config"])
    step = make_sim_step(graph, dec, batch, 1, cn_impl=cn_impl)
    sig = torch.tensor([sigma], dtype=torch.float32, device=device)
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
        "code": code,
        "decoder": kind,
        "cn_impl": cn_impl,
        "batch": batch,
        "iters": iters,
        "sigma": sigma,
        "ms_per_step": ms,
        "symbols_per_s": batch * spec.n / (ms * 1e-3),
        "frames_per_s": batch / (ms * 1e-3),
        "frame_errors_last_step": int(out["frame_errors"][0]),
        "device": torch.cuda.get_device_name(device),
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    print(card_info(), flush=True)
    for code, kind, impls in ROWS:
        for impl in impls:
            print(json.dumps(measure(code, impl, kind=kind)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
