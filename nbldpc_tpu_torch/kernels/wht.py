"""Fast Walsh-Hadamard transform along the GF(q) axis.

The QSPA check-node update is a convolution over (GF(2^p), +) = (Z_2)^p,
which the WHT diagonalizes: WHT(x *xor* y) = WHT(x) . WHT(y), with
H[a, b] = (-1)^popcount(a & b). W(W(x)) = q x.
"""

from __future__ import annotations

import numpy as np
import torch


def wht_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Unnormalized WHT along `axis` (length q = 2^p): p butterfly stages,
    each writing (lo + hi, lo - hi) for every block of 2h symbols."""
    axis = axis % x.ndim
    q = x.shape[axis]
    p = q.bit_length() - 1
    if 1 << p != q:
        raise ValueError("q must be a power of two")
    shape = x.shape
    lead, tail = shape[:axis], shape[axis + 1:]
    for i in range(p):
        h = 1 << i
        y = x.reshape(lead + (q // (2 * h), 2, h) + tail)
        a = y.select(len(lead) + 1, 0)
        b = y.select(len(lead) + 1, 1)
        x = torch.stack([a + b, a - b], dim=len(lead) + 1).reshape(shape)
    return x


def wht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized WHT along the last dim (the q-last decode path)."""
    return wht_axis(x, -1)


def iwht(x: torch.Tensor) -> torch.Tensor:
    """Inverse WHT along the last dim: wht(x) / q."""
    return wht(x) / x.shape[-1]


def wht_matrix(q: int) -> np.ndarray:
    """Dense [q, q] Hadamard matrix H[a,b] = (-1)^popcount(a & b) (for tests)."""
    a = np.arange(q)
    pc = np.zeros((q, q), dtype=np.int64)
    ab = a[:, None] & a[None, :]
    for bit in range(q.bit_length() - 1):
        pc += (ab >> bit) & 1
    return np.where(pc % 2 == 0, 1.0, -1.0)
