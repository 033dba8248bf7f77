"""bf16 against f32 message storage in the resident QSPA kernels: BER/FER.

The counterpart of benchmarks/ber_precision.py. The bf16 mode
(mm_precision="bf16") stores the resident decode's state, the prior, the
posterior and the log-domain messages, in bf16 and computes in f32: a
quantized BP. This harness runs the same seeded Monte-Carlo sweep (seed 0,
all-zero codeword, a fixed iteration budget) under both precisions and
writes per-point frames, frame errors, BER, SER, FER and average
iterations of each, with wall seconds and the device.

On a card q <= 32 decodes through K0 (f32, then its bf16 build) and q = 64
to 256 through K0-cl (e.g. --code gf256_n255_k175). On the CPU both
precisions take the same torch path and the comparison is vacuous; it
still runs, for tests.

    python -m nbldpc_tpu_torch.benchmarks.ber_precision [--code gf16_n204_k102]
        [--frames 20000] [--iters 50] [--batch 1024] [--snrs 1.0 1.5 2.0 2.5]
        [--tag h100] [--device cuda|cpu] [--out DIR]

writes DIR/ber_precision_<tag>.json (default DIR: this package's
results/), a list of one record a code, merged by code, and prints the
record and, as its last line, bf16's points held to f32's by
fer_curves.compare_records. That is a sanity check, not a test: both
precisions decode the same noise, so their frame errors are strongly
correlated and the unpaired z is far too loose to catch a small
difference. The bf16 kernels are held, exactly, to their plain version.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from nbldpc_tpu_torch.benchmarks import RESULTS, device_fields, merge_records
from nbldpc_tpu_torch.benchmarks.fer_curves import compare_records
from nbldpc_tpu_torch.cli import code_config, resolve_device

SEED = 0
PRECISIONS = ("f32", "bf16")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nbldpc_tpu_torch.benchmarks.ber_precision")
    ap.add_argument("--code", default="gf16_n204_k102")
    ap.add_argument("--frames", type=int, default=20000)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--snrs", type=float, nargs="+", default=[1.0, 1.5, 2.0, 2.5])
    ap.add_argument("--tag", default="h100")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--out", default=str(RESULTS), help="directory of the records")
    return ap


def as_curve(record: dict, precision: str) -> list:
    """One precision of a record as a fer_curves record list (config: the
    code), for compare_records."""
    return [{"config": record["code"], "ebn0_db": record["snrs_db"],
             **record["modes"][precision]}]


def precision_record(code: str, precision: str, snrs: list, frames: int, iters: int,
                     batch: int, device) -> tuple:
    """({frames, frame_errors, ber, ser, fer, avg_iters, wall_s}, SweepResult)
    of one precision: QSPA at a fixed budget of `iters` iterations, `frames`
    frames a point, `batch` a step."""
    from nbldpc_tpu_torch.sim import run_sweep
    from nbldpc_tpu_torch.utils.config import (
        ChannelConfig, DecoderConfig, RunConfig, SimConfig,
    )

    cfg = RunConfig(
        code=code_config(code),
        decoder=DecoderConfig(kind="qspa", max_iters=iters, early_term=False,
                              mm_precision=precision),
        channel=ChannelConfig(ebn0_db=tuple(snrs)),
        sim=SimConfig(frames_per_step=batch, max_frames=frames,
                      max_frame_errors=10**9, seed=SEED),
    )
    res = run_sweep(cfg, device)
    return {
        "frames": res.counters.frames.tolist(),
        "frame_errors": res.counters.frame_errors.tolist(),
        "ber": [float(x) for x in res.ber],
        "ser": [float(x) for x in res.ser],
        "fer": [float(x) for x in res.fer],
        "avg_iters": [float(x) for x in res.avg_iters],
        "wall_s": res.wall_seconds,
    }, res


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        import torch

        torch.cuda.set_device(device)
    record = {**device_fields(device), "code": args.code, "iters": args.iters,
              "batch": args.batch, "snrs_db": args.snrs, "modes": {}}
    for precision in PRECISIONS:
        record["modes"][precision], res = precision_record(
            args.code, precision, args.snrs, args.frames, args.iters, args.batch, device)
        print(f"== {precision} ==\n{res.table()}", file=sys.stderr, flush=True)
    out = Path(args.out) / f"ber_precision_{args.tag}.json"
    merge_records(out, [record], "code", [])
    print(json.dumps(record), flush=True)
    cmp = compare_records(as_curve(record, "bf16"), as_curve(record, "f32"))
    print(json.dumps({"bf16_vs_f32": {k: cmp[k] for k in ("held", "threshold", "ok")},
                      "z": [p["z"] for p in cmp["points"]]}), flush=True)
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
