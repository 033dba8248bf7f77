"""Layout microbenchmarks (P5-P7) on one GPU: frames innermost against
checks innermost.

The counterpart of benchmarks/micro_layout.py, which compared two layouts
of the resident QSPA kernel's state on the TPU: [q, dc, M, TB] (frames
innermost, "new") and [q, dc, TB, M] (checks innermost, "old"). The same
questions, each answered by a hand-written CUDA kernel
(nbldpc_tpu_torch/kernels/micro.py) that takes its layout as strides:

  elem_new, elem_old    P5: the rotation + softmax elementwise chain,
                        X <- softmax_q(rot(X)) - 0.5, in each layout;
  route_new             P6: down-route to the edges by an index table,
                        scale, sum back per node, blend, post [Q, N, TB];
                        the TPU's three lowerings of it (r3_id, r3_tr, rep)
                        differ only in how they met the MXU's output-order
                        rule, so here they are one case;
  route_old             P7: the same function with post [Q, TB, N].

Shapes are those of the GF(16) (204,102) code: Q = 16, DC = 4, M = 102
checks, N = 204 variables, TB = 128 frames ("new") or 64 ("old").

    python -m nbldpc_tpu_torch.benchmarks.micro_layout [--iters 50] [--reps 6]
        [--only NAME] [--device cuda|cpu]

times each case at `iters` and 4 `iters` iterations inside one call (the
best of reps / 2 pairs of calls, CUDA events on a card) and prints one
JSON line per case: ms_low, ms_high, the slope us_per_iter and
ns_per_frame_iter, which cancels the launch overhead, with the device's
name and, on a card, its power limit. `--device cpu` runs the plain
PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from nbldpc_tpu_torch.benchmarks import device_fields, first_call_s, time_ms
from nbldpc_tpu_torch.cli import resolve_device
from nbldpc_tpu_torch.kernels import micro

Q, DC, M, N, TB_NEW, TB_OLD = 16, 4, 102, 204, 128, 64
ROT_BITS = micro.ROT_BITS

# case -> the kernel wrapper it launches
WRAPPERS = {"elem_new": micro.rot_softmax, "elem_old": micro.rot_softmax,
            "route_new": micro.route, "route_old": micro.route}
NAMES = tuple(WRAPPERS)


def make_inputs(seed: int = 0, Q: int = Q, DC: int = DC, M: int = M, N: int = N,
                TB_NEW: int = TB_NEW, TB_OLD: int = TB_OLD) -> dict:
    """The probes' inputs as CPU tensors. vn [DC M] (each edge slot
    e = j M + m -> a random variable), rb_new [4, DC, M, 1] and rb_old [4,
    DC, 1, M] are the JAX script's numpy draws, in its order, bit for bit;
    the states it draws with jax.random come from the same numpy generator
    after them: post_new [Q, N, TB_NEW], post_old [Q, TB_OLD, N], x_new
    [Q, DC, M, TB_NEW] and x_old [Q, DC, TB_OLD, M] (normal, x minus 1)."""
    rng = np.random.default_rng(seed)
    vn = rng.integers(0, N, size=DC * M)
    rb_new = rng.integers(0, 2, size=(ROT_BITS, DC, M, 1)).astype(np.float32)
    rb_old = rng.integers(0, 2, size=(ROT_BITS, DC, 1, M)).astype(np.float32)
    post_new = rng.standard_normal((Q, N, TB_NEW), dtype=np.float32)
    post_old = rng.standard_normal((Q, TB_OLD, N), dtype=np.float32)
    x_new = rng.standard_normal((Q, DC, M, TB_NEW), dtype=np.float32) - 1.0
    x_old = rng.standard_normal((Q, DC, TB_OLD, M), dtype=np.float32) - 1.0
    arrays = dict(vn=vn.astype(np.int32), rb_new=rb_new, rb_old=rb_old, post_new=post_new,
                  post_old=post_old, x_new=x_new, x_old=x_old)
    out = {k: torch.from_numpy(v) for k, v in arrays.items()}
    out["nbr"] = micro.route_tables(vn, N)
    return out


def case(name: str, inputs: dict, device: torch.device) -> tuple:
    """(kernel, plain, frames) of case `name`, its inputs on `device`:
    kernel(iters) calls the wrapper (the CUDA kernel for a card tensor),
    plain(iters) the plain version; frames is the case's frame count."""
    layout = name.split("_")[1]
    if name in ("elem_new", "elem_old"):
        x, rb = inputs[f"x_{layout}"].to(device), inputs[f"rb_{layout}"].to(device)
        frames = x.shape[3] if layout == "new" else x.shape[2]
        return (lambda it: micro.rot_softmax(x, rb, it, layout),
                lambda it: micro.rot_softmax_plain(x, rb, it), frames)
    if name in ("route_new", "route_old"):
        post = inputs[f"post_{layout}"].to(device)
        vn, nbr = inputs["vn"].to(device), inputs["nbr"].to(device)
        frames = post.shape[2] if layout == "new" else post.shape[1]
        return (lambda it: micro.route(post, vn, nbr, it, layout),
                lambda it: micro.route_plain(post, vn, nbr, it, layout), frames)
    raise ValueError(f"unknown case {name!r}; cases: {NAMES}")


def _best_ms(fn, device: torch.device, reps: int) -> float:
    """The best of max(1, reps // 2) timings of two back-to-back calls,
    per call."""
    return min(time_ms(fn, device, 2) / 2 for _ in range(max(1, reps // 2)))


def bench_slope(fn, device: torch.device, reps: int, frames: int, i1: int, i2: int) -> dict:
    """fn(iters) timed at i1 and i2 iterations; the slope cancels the
    per-call overhead."""
    t1 = _best_ms(lambda: fn(i1), device, reps)
    t2 = _best_ms(lambda: fn(i2), device, reps)
    per_iter_ms = (t2 - t1) / (i2 - i1)
    return {"ms_low": t1, "ms_high": t2, "us_per_iter": per_iter_ms * 1e3,
            "ns_per_frame_iter": per_iter_ms * 1e6 / frames}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbldpc_tpu_torch.benchmarks.micro_layout")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--only", default="", help="run the cases whose name contains this")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be >= 1")
    device = resolve_device(args.device)
    inputs = make_inputs()
    i1, i2 = args.iters, 4 * args.iters
    for name in NAMES:
        if args.only and args.only not in name:
            continue
        kernel, _, frames = case(name, inputs, device)
        first = first_call_s(lambda: kernel(i1), device)
        r = {"case": name, **bench_slope(kernel, device, args.reps, frames, i1, i2),
             "iters": [i1, i2], "frames": frames, "first_call_s": first,
             **device_fields(device)}
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
