"""The layout sweep: one sim step's counters across rank layouts.

The counterpart of benchmarks/scaling_cpu.py. The multi-SNR GF(256) QSPA
step (gf256_n255_k175, 4 iterations at the fixed budget, S = 2 SNR points
x B = 16 frames, sigma = linspace(0.55, 0.75, 2), seed 0) runs, with the
same total work and the same noise, on the layouts (snr, data) of LAYOUTS:
each on the subgroup of the first snr * data ranks
(`parallel.mesh.make_layout` over `torch.distributed.new_group`), each
rank decoding its block and the counters all-reduced in the subgroup, as
`sim.run_sweep` runs a step (`sim.step_counters`). Every layout must give
the counters of (1, 1): the determinism contract behind the scaling
target (the only traffic between ranks is the [6, S] counter all-reduce).
Where the JAX script shards over virtual devices of one process, here one
rank drives one device, so the largest layout needs 8 ranks:

    python -m torch.distributed.run --standalone --nproc-per-node 8 \\
        -m nbldpc_tpu_torch.benchmarks.scaling [--device cuda|cuda:N|cpu]
        [--backend nccl|gloo] [--tag h100] [--out DIR]

A world of fewer than 8 ranks is refused. `--device cuda` puts rank r on
card LOCAL_RANK mod the card count, `cuda:N` every rank on card N. Ranks
that share a card need gloo (NCCL refuses two ranks on one card), which
is then the default; nccl otherwise on cards, gloo on the CPU. Each
layout runs one warm-up step, then one step timed on the host clock
(`step_s`, the fetch of its all-reduced counters included).

Rank 0 writes DIR/scaling_<tag>.json (default DIR: this package's
results/): the JAX result's keys (counters, the (1, 1) layout's; rows of
devices, mesh, step_s and counters_identical_to_1dev; note), each row
with the launches of every kernel wrapper on each rank
(`kernels.launch_counts`, zeroed before the layout), and, in place of the
physical core count, the device fields, the backend and the ranks on each
card. It exits 1 when a layout's counters differ from (1, 1)'s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from nbldpc_tpu_torch.benchmarks import RESULTS, device_fields
from nbldpc_tpu_torch.cli import resolve_device

CODE = "gf256_n255_k175"
ITERS = 4
S, B = 2, 16                       # fixed total work
SIGMA_ENDS = (0.55, 0.75)
SEED = 0
LAYOUTS = ((1, 1), (1, 2), (2, 2), (2, 4))
WORLD = max(snr * data for snr, data in LAYOUTS)
COMMAND = ("python -m torch.distributed.run --standalone --nproc-per-node "
           f"{WORLD} -m nbldpc_tpu_torch.benchmarks.scaling")
NOTE = ("identical seeds and identical total work across every layout give "
        "identical per-SNR counters (the determinism contract behind the "
        "scaling target); step_s is one step on the host clock, for "
        "reference: ranks that time-share one card (or the CPU's cores) "
        "are no scaling measurement")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nbldpc_tpu_torch.benchmarks.scaling")
    ap.add_argument("--device", default="cuda",
                    help="cuda (card LOCAL_RANK mod the card count), cuda:N or cpu")
    ap.add_argument("--backend", choices=["nccl", "gloo"],
                    help="default: gloo on the CPU or when ranks share a card, else nccl")
    ap.add_argument("--tag", default="h100")
    ap.add_argument("--out", default=str(RESULTS), help="directory of the record")
    return ap


def rank_device(name: str):
    """This rank's device: resolve_device's, with "cuda" taking card
    LOCAL_RANK mod the card count."""
    import torch

    from nbldpc_tpu_torch.parallel.dist import local_rank

    device = resolve_device(name)
    if name == "cuda":
        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device


def run_layouts(device) -> list:
    """(counters, step_s, launches) of each layout of LAYOUTS on this rank:
    the all-reduced counters of the layout's timed step and its seconds
    (None on a rank outside the layout), and this rank's launches."""
    import torch
    import torch.distributed as tdist

    from nbldpc_tpu_torch.graph import TannerGraph
    from nbldpc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nbldpc_tpu_torch.parallel import mesh
    from nbldpc_tpu_torch.sim import make_sim_step, step_counters, step_generator
    from nbldpc_tpu_torch.utils.config import CodeConfig, DecoderConfig

    graph = TannerGraph(CodeConfig(name=CODE).load(), device=device)
    dec = DecoderConfig(kind="qspa", max_iters=ITERS, early_term=False, stats_each_iter=False)
    sigmas = torch.linspace(*SIGMA_ENDS, S, dtype=torch.float32, device=device)
    rank = tdist.get_rank()
    out = []
    for snr, data in LAYOUTS:
        group = tdist.new_group(list(range(snr * data)))
        reset_launch_counts()
        counters, step_s = None, None
        if rank < snr * data:
            layout = mesh.make_layout(snr, data, group)
            step = make_sim_step(graph, dec, B, S, block=layout.block(S, B))
            step_counters(step, step_generator(SEED, 0, device), sigmas, layout)
            tdist.barrier(group=group)
            t0 = time.perf_counter()
            got = step_counters(step, step_generator(SEED, 0, device), sigmas, layout)
            step_s = time.perf_counter() - t0
            counters = {k: v.tolist() for k, v in got.items()}
        out.append((counters, step_s, {k: v for k, v in launch_counts().items() if v}))
    return out


def pick_backend(device, name: str, backend) -> str:
    """The group's backend: the one asked for, else gloo on the CPU or when
    ranks share a card (how many share one is read before joining:
    torch.distributed.run's LOCAL_WORLD_SIZE over the host's cards), else
    nccl. NCCL with ranks sharing a card raises: it refuses them."""
    import os

    import torch

    from nbldpc_tpu_torch.parallel import dist

    if device.type != "cuda":
        return backend or "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.declared_world()))
    shared = name != "cuda" or local > torch.cuda.device_count()
    if shared and backend == "nccl":
        raise ValueError("ranks share a card: NCCL refuses two ranks on one card; "
                         "use --backend gloo")
    return backend or ("gloo" if shared else "nccl")


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = rank_device(args.device)

    import torch
    import torch.distributed as tdist

    from nbldpc_tpu_torch.parallel import dist

    if dist.declared_world() < WORLD:
        raise ValueError(f"the layout sweep needs {WORLD} ranks, one a block of its "
                         f"largest layout {LAYOUTS[-1]}, and the environment names "
                         f"{dist.declared_world()}: run `{COMMAND}`")
    backend = pick_backend(device, args.device, args.backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.initialize(device.type, backend)
    try:
        ranks = [None] * tdist.get_world_size()
        tdist.all_gather_object(ranks, (str(device), run_layouts(device)))
        rank = tdist.get_rank()
    finally:
        tdist.destroy_process_group()
    if rank != 0:
        return 0
    devices = [d for d, _ in ranks]
    base = ranks[0][1][0][0]
    rows = []
    for i, (snr, data) in enumerate(LAYOUTS):
        counters, step_s, _ = ranks[0][1][i]
        rows.append({"devices": snr * data, "mesh": {"snr": snr, "data": data},
                     "step_s": step_s, "counters_identical_to_1dev": counters == base,
                     "launches_ranks": [r[i][2] for _, r in ranks]})
        print(json.dumps(rows[-1]), flush=True)
    result = {
        "code": CODE, "iters": ITERS, "n_snr": S, "batch": B,
        "sigmas": torch.linspace(*SIGMA_ENDS, S, dtype=torch.float32).tolist(),
        "seed": SEED, "world": len(devices), "backend": backend,
        "ranks_per_card": (max(devices.count(d) for d in devices)
                           if device.type == "cuda" else None),
        **device_fields(device),
        "counters": base, "rows": rows, "note": NOTE,
    }
    out = Path(args.out) / f"scaling_{args.tag}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2))
    ok = all(r["counters_identical_to_1dev"] for r in rows)
    print(f"{'all layouts: counters identical' if ok else 'a layout changed the counters'}"
          f"; wrote {out}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
