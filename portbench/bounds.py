"""The least time the card could take for a kernel's work: operations and
bytes from shapes and from the frame-iterations a run needed, against the
published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).

A frozen copy of the smoke run's bound arithmetic (chip_smoke.py: bound,
qspa_edge_ops, resident_bytes, resident_qspa_bound, tems_check_ops,
route_bounds, sim_step_bounds), taking a code's shape instead of the
program's graph object. An exp, a log, a compare or a select counts as one
operation, as an add does; each input byte is read once and each output
byte written once.
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_F32_OPS = 67e12        # f32 outside the tensor cores, operations/s
PEAK_HBM_BYTES = 3.35e12    # HBM bytes/s


class Shape(NamedTuple):
    """A code's sizes: field q = 2^p, N variables, M checks, the largest
    check and variable degrees, and the number of edges."""

    q: int
    p: int
    n: int
    m: int
    dc_max: int
    dv_max: int
    edges: int


def shape_of(code) -> Shape:
    """The Shape of a reference.Code."""
    return Shape(code.q, code.p, code.n, code.m, code.dc_max, code.dv, code.edges)


def bound(ops: float, nbytes: float, peak_ops: float = PEAK_F32_OPS) -> dict:
    """The larger of ops at peak_ops and nbytes at the HBM rate, in ms, and
    which one sets it."""
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return ({"bound_ms": t_ops, "bound_by": "operations"} if t_ops >= t_bytes
            else {"bound_ms": t_bytes, "bound_by": "bytes"})


def qspa_edge_ops(q: int) -> int:
    """One QSPA check-node update of one edge: subtract, exp, softmax sum
    and divide, the forward WHT, about three products of the leave-one-out
    prefix x suffix, the inverse WHT, then scale, floor and log."""
    return 10 * q + 2 * q * (q.bit_length() - 1)


def resident_bytes(g: Shape, B: int) -> int:
    """A resident decode's inputs read once and outputs written once: LLRs,
    graph tables, hard decisions, done flags and iteration counts."""
    E = g.m * g.dc_max
    tables = E * (2 + g.q + g.p) + g.n * g.dv_max + g.q
    return 4 * (B * g.n * g.q + tables + B * g.n + B) + B


def resident_qspa_bound(g: Shape, B: int, frame_iters: int) -> dict:
    """K0: every frame-iteration the run needed updates each edge and adds
    each variable's dv messages and prior, then compares for the decision;
    the start normalizes the prior. Bytes: the decode's inputs and outputs."""
    per_iter = g.edges * qspa_edge_ops(g.q) + g.n * g.q * (g.dv_max + 2)
    return bound(frame_iters * per_iter + B * 2 * g.n * g.q, resident_bytes(g, B))


def tems_check_ops(q: int, dc: int, n_r: int) -> int:
    """One T-EMS check node: per column max, argmax, subtract and permute
    (4 q), the per-row top-3 over the columns (3 q), then per column the
    two-deviation candidates (3 operations each: q (q - 1) for the exact
    scan; n_r argmax rounds of 2 q and n_r q candidates with n_r > 0) and
    the output rotation, offset and clip (3 q)."""
    scan = 3 * q * (q - 1) if n_r == 0 else 2 * n_r * q + 3 * n_r * q
    return dc * (4 * q + 3 * q) + dc * (scan + 3 * q)


def tems_cn_bound(g: Shape, B: int, n_r: int) -> dict:
    """K5 on U [M, dc, q, B]: its operations, U read and the output written."""
    return bound(g.m * B * tems_check_ops(g.q, g.dc_max, n_r),
                 2 * 4 * g.m * g.dc_max * g.q * B)


def route_bounds(g: Shape, B: int) -> dict:
    """Each routing half at B frames. route_down reads the posterior, each
    real VN slot's Cv rows and the real slots' down_idx rows, and writes
    every U row: a subtraction, a max and a subtraction an element.
    route_up reads the real CN slots' Chat rows, the LLRs and the real VN
    slots' up_idx rows, and writes every Cv row and the posterior: an add a
    slot and one more for the LLR."""
    q, E = g.q, g.edges
    cn_slots, vn_slots = g.m * g.dc_max, g.n * g.dv_max
    down = bound(3 * E * q * B,
                 4 * B * q * (g.n + E + cn_slots) + 4 * E * q + cn_slots)
    up = bound(B * q * (vn_slots + g.n),
               4 * B * q * (E + 2 * g.n + vn_slots) + 4 * E * q + vn_slots)
    return {"route_down": down, "route_up": up}


def channel_bound(g: Shape, S: int, B: int) -> dict:
    """channel_llr on a step of S x B all-zero-codeword frames: reads p
    noise floats a symbol and sigma and scale, writes q LLRs a symbol; y
    takes 2 operations a bit, an LLR p products, p - 1 adds, a negation and
    a product."""
    q, p, F = g.q, g.p, S * B * g.n
    return bound(F * (2 * p + q * (2 * p + 1)), 4 * F * (p + q) + 8 * S)
