"""Command-line entry point: `run` (a Monte-Carlo sweep), `gen-codes` and
`bench`.

    python -m nbldpc_tpu_torch run --code gf16_n204_k102_c8 --snr 1.5 2.0 \\
        --iters 50 --set sim.frames_per_step=8192
    python -m nbldpc_tpu_torch run --config configs/gf16_qspa.json --device cpu
    python -m nbldpc_tpu_torch run --code gf4_n96_k48 --random-codewords --device cpu
    python -m nbldpc_tpu_torch gen-codes --out DIR     # default: codes/
    python -m nbldpc_tpu_torch bench        # H100 throughput benchmark
    python -m nbldpc_tpu_torch bench --row qspa_gf16_n204_k102_c8_bf16
    python -m torch.distributed.run --nproc-per-node 2 -m nbldpc_tpu_torch run \
        --config configs/gf256_sweep_2host.json --mesh-snr 2

`--device cuda` (the default) needs a card and never falls back to the CPU.
Under torch.distributed.run (or NBLDPC_COORDINATOR / NBLDPC_NUM_PROCS /
NBLDPC_PROC_ID, parallel/dist.py) `run` joins the process group, and with
more than one rank (and no --no-mesh) splits each step over a
--mesh-snr x --mesh-data layout of the ranks; `--device cuda` is then the
rank's card, cuda:LOCAL_RANK, and `--device cuda:0` puts every rank on card
0 (with --backend gloo: NCCL refuses two ranks on one card). Ranks started
through NBLDPC_NUM_PROCS > 1 need LOCAL_RANK set for `--device cuda`, or
each names its card with `--device cuda:N`.
"""

from __future__ import annotations

import argparse
import dataclasses


def _add_run_parser(sub):
    p = sub.add_parser("run", help="run a BER/FER Monte-Carlo sweep")
    p.add_argument("--config", help="JSON/TOML RunConfig file")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   help="dotted config override, e.g. decoder.max_iters=50")
    p.add_argument("--code", help="standard code name or alist path")
    p.add_argument("--decoder", choices=["qspa", "ems", "tems"])
    p.add_argument("--snr", type=float, nargs="+", help="Eb/N0 points (dB)")
    p.add_argument("--iters", type=int)
    p.add_argument("--frames", type=int, help="max frames per SNR")
    p.add_argument("--report", help="write JSON report to this path")
    p.add_argument("--mesh-snr", type=int, default=1, help="ranks along the SNR axis")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="ranks along the frame axis (0: every rank left)")
    p.add_argument("--no-mesh", action="store_true")
    p.add_argument("--profile", help="torch.profiler trace directory")
    p.add_argument("--random-codewords", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (a rank's: cuda:LOCAL_RANK), cuda:N or cpu")
    p.add_argument("--backend", choices=["nccl", "gloo"],
                   help="process group backend (default: nccl on cuda, gloo on cpu)")


def resolve_device(name: str):
    """A torch.device for `name` ("cuda": the rank's card, cuda:LOCAL_RANK);
    a CUDA device without a card raises, and so does "cuda" for the ranks
    of an NBLDPC_* group of more than one process without LOCAL_RANK,
    which would all take card 0 (NCCL refuses two ranks on one card)."""
    import os

    import torch

    from nbldpc_tpu_torch.parallel.dist import local_rank

    if (name == "cuda" and int(os.environ.get("NBLDPC_NUM_PROCS", "1")) > 1
            and "LOCAL_RANK" not in os.environ):
        raise ValueError(
            "--device cuda under NBLDPC_NUM_PROCS > 1 needs LOCAL_RANK, each rank's "
            "card on its host; set LOCAL_RANK or name the card with --device cuda:N")
    dev = torch.device(f"cuda:{local_rank()}" if name == "cuda" else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return dev


def code_config(code: str):
    """The CodeConfig of `--code`: an alist path, else a standard code name."""
    from nbldpc_tpu_torch.utils.config import CodeConfig

    if "/" in code or code.endswith(".alist"):
        return CodeConfig(path=code)
    return CodeConfig(name=code)


def build_config(args):
    from nbldpc_tpu_torch.utils.config import RunConfig, apply_overrides, load_config

    cfg = load_config(args.config) if args.config else RunConfig()
    if args.code:
        cfg = dataclasses.replace(cfg, code=code_config(args.code))
    if args.decoder:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, kind=args.decoder))
    if args.iters:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, max_iters=args.iters))
    if args.snr:
        cfg = dataclasses.replace(cfg, channel=dataclasses.replace(cfg.channel, ebn0_db=tuple(args.snr)))
    if args.frames:
        cfg = dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim, max_frames=args.frames))
    if args.random_codewords:
        cfg = dataclasses.replace(cfg, channel=dataclasses.replace(cfg.channel, zero_codeword=False))
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    return cfg


def cmd_run(args) -> int:
    cfg = build_config(args)
    device = resolve_device(args.device)

    from nbldpc_tpu_torch import sim
    from nbldpc_tpu_torch.parallel import dist, mesh
    from nbldpc_tpu_torch.utils import report as rep

    rep.setup_logging()
    if device.type == "cuda":
        import torch

        torch.cuda.set_device(device)
    dist.initialize(device.type, args.backend)
    rank, world = dist.process_info()
    layout = None
    if not args.no_mesh and world > 1:
        layout = mesh.make_layout(snr=args.mesh_snr, data=args.mesh_data)

    def progress(t, counters):
        rep.emit_step_record(t, counters)

    if args.profile:
        from pathlib import Path

        import torch.profiler as tp

        acts = [tp.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(tp.ProfilerActivity.CUDA)
        with tp.profile(activities=acts) as prof:
            result = sim.run_sweep(cfg, device, progress, layout)
        Path(args.profile).mkdir(parents=True, exist_ok=True)
        name = "trace.json" if world == 1 else f"trace_rank{rank}.json"
        prof.export_chrome_trace(str(Path(args.profile) / name))
    else:
        result = sim.run_sweep(cfg, device, progress, layout)

    print(result.table())
    print(f"throughput: {result.throughput_syms_per_s:.3e} coded symbols/s")
    if args.report:
        rep.save_report(result, args.report, cfg)
    return 0


def cmd_gen_codes(args) -> int:
    """Write every standard code's alist to args.out (default codes/, whose
    files it reproduces byte for byte)."""
    from pathlib import Path

    from nbldpc_tpu_torch.code import save_alist
    from nbldpc_tpu_torch.codegen import build_standard_code, standard_names
    from nbldpc_tpu_torch.utils.config import CODES_DIR

    out = Path(args.out) if args.out else CODES_DIR
    out.mkdir(parents=True, exist_ok=True)
    for name in standard_names():
        spec = build_standard_code(name)
        save_alist(spec, out / f"{name}.alist")
        print(f"wrote {out / (name + '.alist')}  (n={spec.n} m={spec.m} q={spec.q})")
    return 0


def cmd_bench(args) -> int:
    from nbldpc_tpu_torch import bench

    return bench.main(args.row)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbldpc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_run_parser(sub)
    pg = sub.add_parser("gen-codes", help="regenerate the standard code files")
    pg.add_argument("--out", help="output directory (default: the repository's codes/)")
    pb = sub.add_parser("bench", help="run the H100 throughput benchmark")
    pb.add_argument("--row", action="append",
                    help="run only this bench row (bench.ROWS names; repeatable; "
                         "default: every row)")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "gen-codes":
        return cmd_gen_codes(args)
    return cmd_bench(args)


if __name__ == "__main__":
    raise SystemExit(main())
