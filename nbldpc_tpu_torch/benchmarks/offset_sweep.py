"""Offset-correction sweep for EMS and T-EMS on one GPU.

The counterpart of benchmarks/offset_sweep.py, which chose the offsets
shipped in configs/*.json: truncated min-sum decoders overestimate
extrinsic magnitudes, and the offset correction (DecoderConfig.offset)
compensates. Each configuration of CONFIGS (the JAX script's, row for row)
is swept over the offsets at one mid-waterfall Eb/N0 with a
frame-error-driven stop rule, seed 7; its record holds one row an offset
(frames, frame errors, FER, BER, average iterations, wall seconds), the
best offset (lowest FER, then BER) and the device.

    python -m nbldpc_tpu_torch.benchmarks.offset_sweep [--tag h100] [--only gf16]
        [--max-fe 200] [--max-frames 400000] [--offsets 1.0,1.5,2.0]
        [--device cuda|cpu] [--out DIR]

writes DIR/offset_sweep_<tag>.json (default DIR: this package's results/),
merging by configuration name, so that runs split by --only (each with its
own --offsets grid) land in one file.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from nbldpc_tpu_torch.benchmarks import RESULTS, device_fields, merge_records
from nbldpc_tpu_torch.cli import code_config, resolve_device

SEED = 7

# (name, code, decoder kwargs, mid-waterfall Eb/N0, frames_per_step)
CONFIGS = [
    ("gf16_ems_nm16_20it", "gf16_n204_k102",
     dict(kind="ems", nm=16, max_iters=20), 2.0, 1024),
    ("gf64_tems_20it", "gf64_n576_k480",
     dict(kind="tems", max_iters=20), 3.2, 256),
    ("gf256_ems_nm16_10it", "gf256_n255_k175",
     dict(kind="ems", nm=16, max_iters=10), 2.5, 128),
    # the approximation schemes need their own offsets
    ("gf256_ems_bubble_10it", "gf256_n255_k175",
     dict(kind="ems", nm=16, max_iters=10, ems_merge="bubble"), 2.5, 128),
    ("gf64_tems_nr8_20it", "gf64_n576_k480",
     dict(kind="tems", max_iters=20, tems_nr=8), 3.2, 256),
]

OFFSETS = [0.0, 0.1, 0.2, 0.3, 0.4, 0.6]


def sweep_offsets(name: str, code: str, deckw: dict, snr: float, fps: int, offsets: list,
                  max_fe: int, max_frames: int, device) -> dict:
    """The record of one configuration swept over `offsets`."""
    from nbldpc_tpu_torch.sim import run_sweep
    from nbldpc_tpu_torch.utils.config import (
        ChannelConfig, DecoderConfig, RunConfig, SimConfig,
    )

    rows = []
    for off in offsets:
        cfg = RunConfig(
            code=code_config(code),
            decoder=DecoderConfig(offset=off, **deckw),
            channel=ChannelConfig(ebn0_db=(snr,)),
            sim=SimConfig(frames_per_step=fps, max_frames=max_frames,
                          max_frame_errors=max_fe, seed=SEED),
        )
        res = run_sweep(cfg, device)
        rows.append({
            "offset": off,
            "frames": int(res.counters.frames[0]),
            "frame_errors": int(res.counters.frame_errors[0]),
            "fer": float(res.fer[0]),
            "ber": float(res.ber[0]),
            "avg_iters": float(res.avg_iters[0]),
            "wall_seconds": res.wall_seconds,
        })
        print(json.dumps({"config": name, "snr_db": snr, **rows[-1]}), flush=True)
    best = min(rows, key=lambda r: (r["fer"], r["ber"]))
    return {"config": name, "code": code, "snr_db": snr, "rows": rows,
            "best_offset": best["offset"], "best_fer": best["fer"], **device_fields(device)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nbldpc_tpu_torch.benchmarks.offset_sweep")
    ap.add_argument("--tag", default="h100")
    ap.add_argument("--only", default=None, help="run the configurations whose name contains this")
    ap.add_argument("--max-fe", type=int, default=200)
    ap.add_argument("--max-frames", type=int, default=400_000)
    ap.add_argument("--offsets", default=None, help="comma list overriding the default grid")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--out", default=str(RESULTS), help="directory of the records")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        import torch

        torch.cuda.set_device(device)
    offsets = [float(x) for x in args.offsets.split(",")] if args.offsets else OFFSETS
    out = Path(args.out) / f"offset_sweep_{args.tag}.json"
    for name, code, deckw, snr, fps in CONFIGS:
        if args.only and args.only not in name:
            continue
        rec = sweep_offsets(name, code, deckw, snr, fps, offsets, args.max_fe,
                            args.max_frames, device)
        print(json.dumps({"config": name, "best_offset": rec["best_offset"],
                          "best_fer": rec["best_fer"]}), flush=True)
        merge_records(out, [rec], "config", [c[0] for c in CONFIGS])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
