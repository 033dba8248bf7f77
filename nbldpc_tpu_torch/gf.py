"""GF(2^p) arithmetic as precomputed tables (host-side numpy).

The host operations (gmul, gdiv, ginv, matmul, matvec) serve one-time set-up:
the encoder's row reduction and code generation. Field math never runs in
the decode loop: multiplication by an edge weight
is folded into int index tables (graph.py) that the decoders gather with.
Supported fields: GF(2^p) for p = 1..8 (q = 2..256). Addition is XOR;
multiplication uses exp/log tables over a primitive polynomial.
"""

from __future__ import annotations

import functools

import numpy as np

# Primitive polynomials for GF(2^p), LSB-first bitmask including the x^p term.
PRIM_POLY = {
    2: 0b11,          # x + 1
    4: 0b111,         # x^2 + x + 1
    8: 0b1011,        # x^3 + x + 1
    16: 0b10011,      # x^4 + x + 1
    32: 0b100101,     # x^5 + x^2 + 1
    64: 0b1000011,    # x^6 + x + 1
    128: 0b10001001,  # x^7 + x^3 + 1
    256: 0b100011101, # x^8 + x^4 + x^3 + x^2 + 1 (0x11D)
}


class GF:
    """Tables for one field GF(q), q = 2^p.

    exp [2(q-1)] alpha^i (doubled), log [q] (log[0] unused), mul [q, q],
    inv [q] (inv[0] = 0), bits [q, p] binary image, LSB first.
    """

    def __init__(self, q: int):
        if q not in PRIM_POLY:
            raise ValueError(f"q={q} unsupported; need a power of two in 2..256")
        self.q = q
        self.p = q.bit_length() - 1
        poly = PRIM_POLY[q]

        exp = np.zeros(2 * (q - 1), dtype=np.int32)
        log = np.zeros(q, dtype=np.int32)
        x = 1
        for i in range(q - 1):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & q:
                x ^= poly
        if x != 1:  # LFSR returns to 1 iff poly is primitive
            raise ValueError(f"polynomial {poly:#b} is not primitive for q={q}")
        exp[q - 1:] = exp[: q - 1]
        self.exp = exp
        self.log = log

        a = np.arange(q)
        la, lb = log[a][:, None], log[a][None, :]
        mul = exp[(la + lb) % (q - 1)].copy()
        mul[0, :] = 0
        mul[:, 0] = 0
        self.mul = mul.astype(np.int32)

        inv = np.zeros(q, dtype=np.int32)
        inv[1:] = exp[(q - 1 - log[1:q]) % (q - 1)]
        self.inv = inv

        self.bits = ((a[:, None] >> np.arange(self.p)[None, :]) & 1).astype(np.int32)

    # ---- host-side array operations (encoder elimination, code generation) ----

    def gmul(self, a, b) -> np.ndarray:
        """Elementwise product of integer arrays or scalars."""
        return self.mul[np.asarray(a, dtype=np.int64), np.asarray(b, dtype=np.int64)]

    def gdiv(self, a, b) -> np.ndarray:
        """Elementwise a / b (b nonzero)."""
        return self.mul[np.asarray(a, dtype=np.int64), self.inv[np.asarray(b, dtype=np.int64)]]

    def ginv(self, a) -> np.ndarray:
        """Elementwise inverse (inv[0] = 0)."""
        return self.inv[np.asarray(a, dtype=np.int64)]

    def matmul(self, A, B) -> np.ndarray:
        """A @ B over GF(q): sums are XOR, products field products."""
        A = np.asarray(A, dtype=np.int64)
        B = np.asarray(B, dtype=np.int64)
        out = np.zeros((A.shape[0], B.shape[1]), dtype=np.int64)
        for k in range(A.shape[1]):
            out ^= self.mul[A[:, k][:, None], B[k, :][None, :]]
        return out.astype(np.int32)

    def matvec(self, A, x) -> np.ndarray:
        """A @ x over GF(q) for a vector x."""
        return self.matmul(A, np.asarray(x).reshape(-1, 1)).ravel()


@functools.lru_cache(maxsize=None)
def get_field(q: int) -> GF:
    """Cached field tables (immutable; safe to share)."""
    return GF(q)
