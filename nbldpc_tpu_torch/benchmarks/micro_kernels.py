"""Routing and check-node microbenchmarks (P1-P4) on one GPU.

The counterpart of benchmarks/micro_pallas.py, which asked the TPU how to
route the Tanner graph inside a kernel. The same four questions, each
answered by a hand-written CUDA kernel (nbldpc_tpu_torch/kernels/micro.py):

  flat_constant_gather      P1: the edge routing and GF permutation as one
                            flat index table, x <- x[perm] + 1;
  per_edge_row_moves        P2: the same as per-edge row moves, a partner
                            row and a slot permutation per edge;
  matmul_onehot_routing     P3: the routing as a one-hot GEMM, x <- A x + 1
                            (a TF32 tensor-core GEMM, exact for a one-hot
                            A, one launch per iteration);
  cn_iteration_prob_domain  P4: one probability-domain QSPA check-node
                            iteration (normalize, WHT, leave-one-out
                            product, WHT).

Shapes are those of the GF(16) (204,102) flagship: E = 408 edges, Q = 16,
BT = 128 frames; each call runs ITERS = 20 iterations.

    python -m nbldpc_tpu_torch.benchmarks.micro_kernels [--only NAME] [--reps 50]
        [--device cuda|cpu]

prints one JSON line per case: ms per call and us per iteration (CUDA
events over `reps` calls after one warm-up call), the device's name and,
on a card, its power limit. `--device cpu` runs the plain PyTorch
versions on the CPU (matmul_onehot_routing there allocates the 170 MB
operator).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from nbldpc_tpu_torch.benchmarks import device_fields, first_call_s, time_ms
from nbldpc_tpu_torch.cli import resolve_device
from nbldpc_tpu_torch.kernels import micro

E, Q, BT = 408, 16, 128   # GF(16) (204,102) flagship shapes
ITERS = 20                # iterations inside one call

# case -> the kernel wrapper it launches
WRAPPERS = {"cn_iteration_prob_domain": micro.cn_iteration,
            "flat_constant_gather": micro.flat_gather,
            "matmul_onehot_routing": micro.onehot_gemm,
            "per_edge_row_moves": micro.row_moves}
NAMES = tuple(WRAPPERS)


def make_inputs(seed: int = 0, E: int = E, Q: int = Q, BT: int = BT) -> tuple:
    """x [E, Q, BT] f32 uniform in [0, 1) and perm, a permutation of the E Q
    rows (int32): micro_pallas.make_inputs's numpy draws, bit for bit."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((E, Q, BT), dtype=np.float32))
    perm = torch.from_numpy(rng.permutation(E * Q).astype(np.int32))
    return x, perm


def case(name: str, x: torch.Tensor, perm: torch.Tensor, iters: int = ITERS) -> tuple:
    """(kernel, plain) of case `name` on x's device, each a call of no
    arguments: `kernel` calls the wrapper (the CUDA kernel for a card
    tensor), `plain` the plain version, on the same inputs and tables."""
    if name == "flat_constant_gather":
        p = perm.to(x.device)
        return (lambda: micro.flat_gather(x, p, iters),
                lambda: micro.flat_gather_plain(x, p, iters))
    if name == "per_edge_row_moves":
        pi, perms = (t.to(x.device) for t in micro.row_tables(perm, x.shape[1]))
        return (lambda: micro.row_moves(x, pi, perms, iters),
                lambda: micro.row_moves_plain(x, pi, perms, iters))
    if name == "matmul_onehot_routing":
        A = micro.onehot_matrix(perm, x.device)
        return (lambda: micro.onehot_gemm(A, x, iters),
                lambda: micro.onehot_gemm_plain(A, x, iters))
    if name == "cn_iteration_prob_domain":
        return (lambda: micro.cn_iteration(x, iters),
                lambda: micro.cn_iteration_plain(x, iters))
    raise ValueError(f"unknown case {name!r}; cases: {NAMES}")


def run_case(name: str, x: torch.Tensor, perm: torch.Tensor, reps: int) -> dict:
    """Time `reps` calls of case `name` after one warm-up call."""
    kernel, _ = case(name, x, perm)
    first = first_call_s(kernel, x.device)
    ms = time_ms(kernel, x.device, reps) / reps
    return {"case": name, "ms_per_call": ms, "us_per_iter": ms / ITERS * 1e3,
            "iters": ITERS, "reps": reps, "shape": list(x.shape), "first_call_s": first,
            **device_fields(x.device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbldpc_tpu_torch.benchmarks.micro_kernels")
    ap.add_argument("--only", default=None, help="run the cases whose name contains this")
    ap.add_argument("--reps", type=int, default=50, help="timed calls per case")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    x, perm = make_inputs()
    x = x.to(device)
    for name in NAMES:
        if args.only and args.only not in name:
            continue
        print(json.dumps(run_case(name, x, perm, args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
