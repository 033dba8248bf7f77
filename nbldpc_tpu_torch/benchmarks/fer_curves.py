"""FER/BER waterfall curves of the BASELINE configurations on one GPU.

The counterpart of benchmarks/fer_curves.py: `sim.run_sweep` at >= 3 Eb/N0
points a configuration with a frame-error-driven stop rule, all-zero
codeword, seed 0, early termination, one record a configuration (per point
frames, frame errors, BER, SER, FER, average iterations; wall seconds and
throughput), in the JAX script's format with the device beside. The
configurations (SWEEPS) are the JAX script's, row for row.

    python -m nbldpc_tpu_torch.benchmarks.fer_curves [--tag h100] [--only gf16]
        [--max-frames 200000] [--max-fe 150] [--device cuda|cpu] [--out DIR]
    python -m nbldpc_tpu_torch.benchmarks.fer_curves --compare PORT.json REF.json

writes DIR/fer_curves_<tag>.json (default DIR: this package's results/),
merging by configuration name: one failing configuration loses nothing,
and an --only rerun updates its record in place. `--compare` runs nothing:
it holds two record files (fer_curves or offset_sweep) to each other with
compare_records, prints one JSON line a common point and the verdict, and
exits 1 when a held point breaks the threshold, when no point is held, or
when a point of the reference is missing from the port's file.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from statistics import NormalDist

from nbldpc_tpu_torch.benchmarks import RESULTS, device_fields, merge_records
from nbldpc_tpu_torch.cli import code_config, resolve_device

SEED = 0

# (name, code, decoder kwargs, Eb/N0 grid, frames_per_step): BASELINE
# configs 1-5 and the round-5 variants, as benchmarks/fer_curves.py has them
SWEEPS = [
    ("gf4_qspa_20it", "gf4_n96_k48", dict(kind="qspa", max_iters=20),
     [1.5, 2.0, 2.5, 3.0], 2048),
    ("gf16_qspa_50it", "gf16_n204_k102", dict(kind="qspa", max_iters=50),
     [1.0, 1.5, 2.0, 2.5], 4096),
    # EMS/T-EMS offsets from benchmarks/results/offset_sweep_r4.json
    ("gf16_ems_nm16_20it", "gf16_n204_k102",
     dict(kind="ems", nm=16, max_iters=20, offset=0.3),
     [1.0, 1.5, 2.0, 2.5], 1024),
    ("gf64_tems_20it", "gf64_n576_k480",
     dict(kind="tems", max_iters=20, offset=2.0),
     [2.5, 3.0, 3.5, 4.0], 256),
    ("gf256_qspa_10it", "gf256_n255_k175", dict(kind="qspa", max_iters=10),
     [2.0, 2.5, 3.0], 128),
    ("gf256_ems_nm16_10it", "gf256_n255_k175",
     dict(kind="ems", nm=16, max_iters=10, offset=0.1),
     [2.0, 2.5, 3.0], 128),
    # bubble EMS against classic EMS (same code and points)
    ("gf256_ems_bubble_10it", "gf256_n255_k175",
     dict(kind="ems", nm=16, max_iters=10, offset=0.0, ems_merge="bubble"),
     [2.0, 2.5, 3.0], 128),
    # truncated-deviation T-EMS against the exact scan
    ("gf64_tems_nr8_20it", "gf64_n576_k480",
     dict(kind="tems", max_iters=20, offset=2.0, tems_nr=8),
     [2.5, 3.0, 3.5, 4.0], 256),
    ("gf64_tems_nr6_20it", "gf64_n576_k480",
     dict(kind="tems", max_iters=20, offset=2.0, tems_nr=6),
     [2.5, 3.0, 3.5, 4.0], 256),
    ("gf64_tems_nr4_20it", "gf64_n576_k480",
     dict(kind="tems", max_iters=20, offset=2.0, tems_nr=4),
     [2.5, 3.0, 3.5, 4.0], 256),
    # quasi-cyclic codes against the PEG codes (same shape, decoder, points)
    ("gf16_qspa_qc_slot_50it", "gf16_n204_k102_qc",
     dict(kind="qspa", max_iters=50),
     [1.0, 1.5, 2.0, 2.5], 4096),
    ("gf4_qspa_qc_20it", "gf4_n96_k48_qc",
     dict(kind="qspa", max_iters=20),
     [1.5, 2.0, 2.5, 3.0], 2048),
    # chunk8 PEG codes (same PEG graph, grouped weight tuples) against random
    ("gf16_qspa_c8_50it", "gf16_n204_k102_c8",
     dict(kind="qspa", max_iters=50),
     [1.0, 1.5, 2.0, 2.5], 4096),
    ("gf4_qspa_c8_20it", "gf4_n96_k48_c8",
     dict(kind="qspa", max_iters=20),
     [1.5, 2.0, 2.5, 3.0], 2048),
]

# compare_records: a point is held when both sides have at least
# MIN_ERRORS frame errors and neither has every frame in error; the held
# points together are tested at family-wise FAMILY_ALPHA, two-sided,
# Bonferroni. Fixed: no caller sets either
MIN_ERRORS = 10
FAMILY_ALPHA = 0.001


def sweep_record(name: str, code: str, deckw: dict, snrs: list, batch: int,
                 max_frames: int, max_fe: int, device) -> tuple:
    """(record, SweepResult) of one configuration: the JAX record's keys
    (sweep_report less config_hash, with config and code) and the device."""
    from nbldpc_tpu_torch.sim import run_sweep
    from nbldpc_tpu_torch.utils.config import (
        ChannelConfig, DecoderConfig, RunConfig, SimConfig,
    )
    from nbldpc_tpu_torch.utils.report import sweep_report

    cfg = RunConfig(
        code=code_config(code),
        decoder=DecoderConfig(early_term=True, **deckw),
        channel=ChannelConfig(ebn0_db=tuple(snrs)),
        sim=SimConfig(frames_per_step=batch, max_frames=max_frames,
                      max_frame_errors=max_fe, seed=SEED),
    )
    res = run_sweep(cfg, device)
    rep = {"config": name, "code": code, **sweep_report(res), **device_fields(device)}
    del rep["config_hash"]
    return rep, res


def two_prop_z(k1: int, n1: int, k2: int, n2: int) -> float:
    """Two-proportion z of k1/n1 against k2/n2 (pooled variance)."""
    p = (k1 + k2) / (n1 + n2)
    se = math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    return 0.0 if se == 0 else (k1 / n1 - k2 / n2) / se


def family_threshold(n: int) -> float:
    """|z| bound of each of n points tested together at family-wise
    FAMILY_ALPHA, two-sided, Bonferroni: the normal quantile
    1 - FAMILY_ALPHA / (2 n)."""
    return NormalDist().inv_cdf(1 - FAMILY_ALPHA / (2 * n))


def _points(records: list) -> dict:
    """{(config, x): (frame errors, frames)}: x is a fer_curves record's
    Eb/N0, an offset_sweep record's offset."""
    out = {}
    for r in records:
        if "rows" in r:
            for row in r["rows"]:
                out[(r["config"], row["offset"])] = (row["frame_errors"], row["frames"])
        else:
            for x, k, n in zip(r["ebn0_db"], r["frame_errors"], r["frames"]):
                out[(r["config"], x)] = (k, n)
    return out


def compare_records(port: list, reference: list) -> dict:
    """Hold the port's records to the reference's at every (config, x)
    point the two share (x: the Eb/N0 of fer_curves records, the offset of
    offset_sweep records): the two-proportion z of frame errors over
    frames, port minus reference. A point is held when both sides have at
    least MIN_ERRORS frame errors and not every frame in error (a point
    at FER 1 on both sides says nothing and would only widen the family);
    the n held points pass together when n >= 1 and each |z| <
    family_threshold(n). Points not held are listed with their counts and
    not judged. `missing` lists the reference's (config, x) points the
    port lacks; they do not change `ok` (a run of a few configurations is
    held to a full reference), compare_files fails on them. Returns
    {"points", "held", "threshold", "alpha", "failed", "missing", "ok"}."""
    mine, ref = _points(port), _points(reference)
    points = []
    for key in mine:
        if key not in ref:
            continue
        (k1, n1), (k2, n2) = mine[key], ref[key]
        points.append({"config": key[0], "x": key[1], "port": [k1, n1], "reference": [k2, n2],
                       "z": two_prop_z(k1, n1, k2, n2),
                       "held": (k1 >= MIN_ERRORS and k2 >= MIN_ERRORS
                                and not (k1 == n1 and k2 == n2))})
    held = [p for p in points if p["held"]]
    threshold = family_threshold(len(held)) if held else None
    failed = [p for p in held if not abs(p["z"]) < threshold]
    return {"points": points, "held": len(held), "threshold": threshold,
            "alpha": FAMILY_ALPHA, "failed": failed,
            "missing": [list(key) for key in ref if key not in mine],
            "ok": bool(held) and not failed}


def compare_files(port: str, reference: str) -> int:
    """Print compare_records of two record files, a JSON line a point and
    one for the verdict; 1 when a held point breaks the threshold, when no
    point is held, or when the port's file lacks a point of the
    reference."""
    cmp = compare_records(json.loads(Path(port).read_text()),
                          json.loads(Path(reference).read_text()))
    for p in cmp["points"]:
        print(json.dumps(p))
    print(json.dumps({k: cmp[k] for k in ("held", "threshold", "alpha", "ok")}
                     | {"n_points": len(cmp["points"]), "failed": cmp["failed"],
                        "missing": cmp["missing"]}))
    return 0 if cmp["ok"] and not cmp["missing"] else 1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nbldpc_tpu_torch.benchmarks.fer_curves")
    ap.add_argument("--tag", default="h100")
    ap.add_argument("--only", default=None, help="run the configurations whose name contains this")
    ap.add_argument("--max-frames", type=int, default=200_000)
    ap.add_argument("--max-fe", type=int, default=150)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--out", default=str(RESULTS), help="directory of the records")
    ap.add_argument("--compare", nargs=2, metavar=("PORT", "REFERENCE"),
                    help="hold two record files to each other; runs nothing")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.compare:
        return compare_files(*args.compare)
    device = resolve_device(args.device)
    if device.type == "cuda":
        import torch

        torch.cuda.set_device(device)
    out = Path(args.out) / f"fer_curves_{args.tag}.json"
    for name, code, deckw, snrs, batch in SWEEPS:
        if args.only and args.only not in name:
            continue
        rep, res = sweep_record(name, code, deckw, snrs, batch, args.max_frames,
                                args.max_fe, device)
        print(json.dumps(rep), flush=True)
        print(res.table(), file=sys.stderr, flush=True)
        merge_records(out, [rep], "config", [s[0] for s in SWEEPS])
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
