"""The comparison that decides `correct`: the program's counters of sampled
window steps against the reference's counters of the same steps.

Each number is a gap summed over the sampled steps and SNR slots:
  frames_gap          the largest |difference| in frames (exact: limit 0);
  converged_gap       |difference| in frames done, over the frames;
  frame_errors_gap    |difference| in frame errors, over the frames;
  symbol_errors_gap   |difference| in symbol errors, over the frames;
  bit_errors_gap      |difference| in bit errors, over the frames;
  iter_sum_gap        |difference| in the sum of iterations, over the
                      reference's sum.
A run is correct when it checked at least one step and every number is at
or under its limit (limits/<cell>.json); a cell with no limits is never
correct.
"""

from __future__ import annotations

import numpy as np

# counter rows, in the sweep's order (frames, frame_errors, symbol_errors,
# bit_errors, iter_sum, converged)
ROWS = {"frames": 0, "frame_errors": 1, "symbol_errors": 2, "bit_errors": 3,
        "iter_sum": 4, "converged": 5}
NUMBERS = ("frames_gap", "converged_gap", "frame_errors_gap", "symbol_errors_gap",
           "bit_errors_gap", "iter_sum_gap")


def numbers(prog: np.ndarray, ref: np.ndarray) -> dict:
    """prog, ref [k, 6, S] int64 -> {number: value}."""
    prog, ref = np.asarray(prog, np.int64), np.asarray(ref, np.int64)
    if prog.shape != ref.shape or prog.ndim != 3 or prog.shape[0] == 0:
        raise ValueError(f"counters of shapes {prog.shape} and {ref.shape}")
    gap = np.abs(prog - ref).sum(axis=(0, 2))
    frames = max(int(ref[:, 0].sum()), 1)
    out = {"frames_gap": int(np.abs(prog[:, 0] - ref[:, 0]).max())}
    for name in ("converged", "frame_errors", "symbol_errors", "bit_errors"):
        out[f"{name}_gap"] = float(gap[ROWS[name]]) / frames
    out["iter_sum_gap"] = float(gap[ROWS["iter_sum"]]) / max(int(ref[:, 4].sum()), 1)
    return out


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}) of the numbers against their
    limits; a number with no limit fails."""
    table = {k: {"value": values[k], "limit": limits.get(k)} for k in NUMBERS}
    ok = all(v["limit"] is not None and v["value"] <= v["limit"] for v in table.values())
    return ok, table
