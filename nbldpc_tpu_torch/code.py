"""Non-binary parity-check code: spec container + alist-style file I/O.

File format (non-binary alist):

    N M q
    dv_max dc_max
    dv_1 ... dv_N           (column degrees)
    dc_1 ... dc_M           (row degrees)
    # then, one line per column n: dv_n pairs "row value" (rows 1-based)
    # then, one line per row m:    dc_m pairs "col value" (cols 1-based)

Entries are the nonzero H[m, n] in GF(q) \\ {0}.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from nbldpc_tpu_torch.gf import get_field


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """A parity-check code over GF(q), held sparse as per-row lists."""

    q: int
    n: int                 # variable nodes (code length in symbols)
    m: int                 # check nodes
    row_cols: tuple        # tuple of np.ndarray[int32]: columns of each row
    row_vals: tuple        # tuple of np.ndarray[int32]: GF values of each row

    @property
    def k(self) -> int:
        """Design dimension n - m."""
        return self.n - self.m

    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def num_edges(self) -> int:
        return int(sum(len(c) for c in self.row_cols))

    @property
    def dc(self) -> np.ndarray:
        return np.array([len(c) for c in self.row_cols], dtype=np.int32)

    @property
    def dv(self) -> np.ndarray:
        dv = np.zeros(self.n, dtype=np.int32)
        for cols in self.row_cols:
            np.add.at(dv, cols, 1)
        return dv

    def dense_h(self) -> np.ndarray:
        H = np.zeros((self.m, self.n), dtype=np.int32)
        for mi, (cols, vals) in enumerate(zip(self.row_cols, self.row_vals)):
            H[mi, cols] = vals
        return H

    def validate(self) -> None:
        gf = get_field(self.q)
        for mi, (cols, vals) in enumerate(zip(self.row_cols, self.row_vals)):
            if len(cols) != len(vals):
                raise ValueError(f"row {mi}: cols/vals length mismatch")
            if len(np.unique(cols)) != len(cols):
                raise ValueError(f"row {mi}: duplicate column")
            if np.any(vals <= 0) or np.any(vals >= gf.q):
                raise ValueError(f"row {mi}: values outside GF({self.q})*")
            if np.any(cols < 0) or np.any(cols >= self.n):
                raise ValueError(f"row {mi}: column index out of range")

    @staticmethod
    def from_dense(H: np.ndarray, q: int) -> "CodeSpec":
        """The CodeSpec of a dense H [m, n] over GF(q) (nonzeros in column
        order)."""
        H = np.asarray(H, dtype=np.int32)
        m, n = H.shape
        row_cols, row_vals = [], []
        for mi in range(m):
            cols = np.nonzero(H[mi])[0].astype(np.int32)
            row_cols.append(cols)
            row_vals.append(H[mi, cols].astype(np.int32))
        return CodeSpec(q=q, n=n, m=m, row_cols=tuple(row_cols), row_vals=tuple(row_vals))


def save_alist(spec: CodeSpec, path) -> None:
    spec.validate()
    dv = spec.dv
    dc = spec.dc
    col_rows = [[] for _ in range(spec.n)]
    col_vals = [[] for _ in range(spec.n)]
    for mi, (cols, vals) in enumerate(zip(spec.row_cols, spec.row_vals)):
        for c, v in zip(cols, vals):
            col_rows[c].append(mi)
            col_vals[c].append(v)
    lines = [
        f"{spec.n} {spec.m} {spec.q}",
        f"{int(dv.max())} {int(dc.max())}",
        " ".join(str(int(x)) for x in dv),
        " ".join(str(int(x)) for x in dc),
    ]
    for n_ in range(spec.n):
        lines.append(" ".join(f"{r + 1} {v}" for r, v in zip(col_rows[n_], col_vals[n_])))
    for mi in range(spec.m):
        lines.append(
            " ".join(f"{c + 1} {v}" for c, v in zip(spec.row_cols[mi], spec.row_vals[mi]))
        )
    Path(path).write_text("\n".join(lines) + "\n")


def load_alist(path) -> CodeSpec:
    toks = Path(path).read_text().split("\n")
    toks = [t for t in toks if t.strip() and not t.lstrip().startswith("#")]
    n, m, q = (int(x) for x in toks[0].split())
    dv = [int(x) for x in toks[2].split()]
    dc = [int(x) for x in toks[3].split()]
    if len(dv) != n or len(dc) != m:
        raise ValueError(f"{path}: degree list length mismatch")
    row_lines = toks[4 + n : 4 + n + m]
    row_cols, row_vals = [], []
    for mi, line in enumerate(row_lines):
        nums = [int(x) for x in line.split()]
        if len(nums) != 2 * dc[mi]:
            raise ValueError(f"{path}: row {mi}: expected {dc[mi]} pairs")
        row_cols.append(np.array(nums[0::2], dtype=np.int32) - 1)
        row_vals.append(np.array(nums[1::2], dtype=np.int32))
    spec = CodeSpec(q=q, n=n, m=m, row_cols=tuple(row_cols), row_vals=tuple(row_vals))
    spec.validate()
    return spec


def random_regular_spec(q: int, n: int, m: int, seed: int, dv: int = 2) -> CodeSpec:
    """A random code over GF(q) from its seed: every variable in dv distinct
    checks, every check of degree dv n / m, random nonzero weights."""
    rng = np.random.default_rng(seed)
    dc = dv * n // m
    while True:
        sockets = rng.permutation(np.repeat(np.arange(n), dv)).reshape(m, dc)
        if all(len(set(r)) == dc for r in sockets):
            break
    spec = CodeSpec(q=q, n=n, m=m,
                    row_cols=tuple(np.sort(r).astype(np.int32) for r in sockets),
                    row_vals=tuple(rng.integers(1, q, size=dc).astype(np.int32)
                                   for _ in range(m)))
    spec.validate()
    return spec
