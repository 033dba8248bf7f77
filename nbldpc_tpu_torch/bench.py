"""Throughput benchmark on one GPU: decoded coded symbols/s and frames/s.

The timed unit is the full sim step (noise -> llr_init -> decode -> error
counters) at the fixed 50-iteration budget in throughput mode
(early_term=False, stats_each_iter=False), f32, B = 8192 frames, all-zero
codeword, sigma = 0.63 (about 2 dB at rate 1/2). Steps run back to back
after warm-up and are timed with CUDA events. QSPA runs on CODES, EMS
(nm = 16, offset 0.3, BASELINE config 3's decoder) on EMS_CODE, under the
same conditions, so the two decoders' symbols/s compare directly.

    python -m nbldpc_tpu_torch bench

prints the card's name and power limit, then one JSON line per
(code, implementation).
"""

from __future__ import annotations

import json
import subprocess

import torch

from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.sim import make_sim_step, step_generator
from nbldpc_tpu_torch.utils.config import CodeConfig, DecoderConfig

CODES = ("gf16_n204_k102_c8", "gf16_n204_k102")
EMS_CODE = "gf16_n204_k102"
EMS_NM, EMS_OFFSET = 16, 0.3
BATCH = 8192
ITERS = 50
SIGMA = 0.63


def card_info() -> str:
    """`name, power.limit` of the card(s), as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def measure(code: str, cn_impl: str, reps: int = 10, kind: str = "qspa") -> dict:
    """Time `reps` sim steps of decoder `kind` ("qspa" or "ems") on the
    current CUDA device after two warm-up steps; one result record."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench.measure needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    spec = CodeConfig(name=code).load()
    graph = TannerGraph(spec, device=device)
    dec = DecoderConfig(kind=kind, max_iters=ITERS, early_term=False,
                        stats_each_iter=False, mm_precision="f32",
                        nm=EMS_NM, offset=EMS_OFFSET if kind == "ems" else 0.0)
    step = make_sim_step(graph, dec, BATCH, 1, cn_impl=cn_impl)
    sig = torch.tensor([SIGMA], dtype=torch.float32, device=device)
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
        "batch": BATCH,
        "iters": ITERS,
        "ms_per_step": ms,
        "symbols_per_s": BATCH * spec.n / (ms * 1e-3),
        "frames_per_s": BATCH / (ms * 1e-3),
        "frame_errors_last_step": int(out["frame_errors"][0]),
        "device": torch.cuda.get_device_name(device),
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    print(card_info(), flush=True)
    for code, kind in [(c, "qspa") for c in CODES] + [(EMS_CODE, "ems")]:
        for impl in ("resident", "torch"):
            print(json.dumps(measure(code, impl, kind=kind)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
