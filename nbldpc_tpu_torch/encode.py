"""Systematic encoder over GF(q).

Gaussian elimination runs once on the host (the native library, with the
numpy loop as its plain version); the per-frame encode is a device
computation. Multiplication by a fixed weight w is linear over GF(2) on
the p-bit image of a symbol: bit i of w * 2^j is entry (j, i) of its p x p
binary matrix. So the whole parity map is one binary matrix G [K p, M p],
and

    parity bits = (info bits @ G) mod 2

is one float32 matrix product: every term is 0 or 1, so its sums are exact
integers while K p < 2^24 (K p <= 6400 on every code in codes/), in full
f32 or in TF32, which keeps 0 and 1 exact and accumulates in f32. The
reference scans the K info symbols (one gather and XOR a symbol); the
product does the same work in one launch.

    enc = Encoder(spec, device="cuda")
    cw = enc.encode(u)          # u [..., K] int -> cw [..., N] int32, H cw = 0
"""

from __future__ import annotations

import numpy as np
import torch

from nbldpc_tpu_torch import native
from nbldpc_tpu_torch.code import CodeSpec
from nbldpc_tpu_torch.gf import GF, get_field


def gf_row_reduce(H: np.ndarray, gf: GF) -> tuple:
    """Row-reduce H over GF(q) with column pivoting, in the native library.

    Returns (R, rank, pivot_cols): R [m, n] int32 is the reduced matrix
    (rows scaled so pivots are 1, eliminated above and below), pivot_cols
    [rank] int32 the pivot column of each of the first `rank` rows."""
    return native.gf_row_reduce(np.asarray(H), gf.q, gf.mul, gf.inv)


def gf_row_reduce_plain(H: np.ndarray, gf: GF) -> tuple:
    """gf_row_reduce as a numpy loop: the same pivoting, the same result."""
    R = np.asarray(H, dtype=np.int64).copy()
    m, n = R.shape
    pivot_cols = []
    r = 0
    for c in range(n):
        if r == m:
            break
        nz = np.nonzero(R[r:, c])[0]
        if len(nz) == 0:
            continue
        pr = r + int(nz[0])
        if pr != r:
            R[[r, pr]] = R[[pr, r]]
        R[r] = gf.gmul(R[r], gf.ginv(R[r, c]))          # pivot to 1
        rows = np.nonzero(R[:, c])[0]
        rows = rows[rows != r]
        if len(rows):
            R[rows] ^= gf.gmul(R[rows, c][:, None], R[r][None, :])
        pivot_cols.append(c)
        r += 1
    return R.astype(np.int32), r, np.array(pivot_cols, dtype=np.int32)


class Encoder:
    """Systematic GF(q) encoder of a full-rank H, on one device.

    From the reduced form R of H (R[:, piv_cols] = I), the parity symbol of
    pivot row r is c[piv_cols[r]] = sum_k P[r, k] u[k] over GF(q), with P =
    R[:, info_cols] [M, K] and u the info symbols, which fill info_cols in
    order.  encode(u [..., K]) -> codeword [..., N] int32 in the original
    column order, with H c = 0.
    """

    def __init__(self, spec: CodeSpec, device):
        gf = get_field(spec.q)
        self.spec = spec
        self.gf = gf
        self.device = torch.device(device)
        R, rank, piv = gf_row_reduce(spec.dense_h(), gf)
        if rank != spec.m:
            raise ValueError(f"H is rank-deficient ({rank} < {spec.m}); cannot encode")
        n, m, p = spec.n, spec.m, gf.p
        info_cols = np.setdiff1d(np.arange(n), piv)
        self.P = R[:m, info_cols].astype(np.int32)                     # [M, K]
        self.info_cols = info_cols.astype(np.int32)
        self.piv_cols = piv.astype(np.int32)
        self.k = n - m

        # G[k p + j, r p + i] = bit i of P[r, k] * 2^j
        pows = 1 << np.arange(p)
        prod = gf.gmul(self.P.T[:, None, :], pows[None, :, None])     # [K, p(j), M]
        G = (prod[:, :, :, None] >> np.arange(p)) & 1                  # [K, p(j), M, p(i)]
        self._G = torch.from_numpy(G.reshape(self.k * p, m * p).astype(np.float32)).to(
            self.device)
        self._shifts = torch.arange(p, dtype=torch.int32, device=self.device)
        # column c of the codeword is column order[c] of [u | parity]
        order = np.empty(n, dtype=np.int64)
        order[info_cols] = np.arange(self.k)
        order[piv] = self.k + np.arange(m)
        self._order = torch.from_numpy(order).to(self.device)

    def encode(self, u: torch.Tensor) -> torch.Tensor:
        """u [..., K] ints in [0, q) on the encoder's device -> codeword
        [..., N] int32 with H c = 0."""
        u = u.to(torch.int32)
        p, m = self.gf.p, self.spec.m
        bits = ((u[..., None] >> self._shifts) & 1).to(torch.float32)  # [..., K, p]
        par = torch.matmul(bits.reshape(*u.shape[:-1], self.k * p), self._G)
        par = torch.remainder(par, 2.0).to(torch.int32).reshape(*u.shape[:-1], m, p)
        parity = (par << self._shifts).sum(dim=-1, dtype=torch.int32)  # [..., M]
        return torch.cat([u, parity], dim=-1).index_select(-1, self._order)
