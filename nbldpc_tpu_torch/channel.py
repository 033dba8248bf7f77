"""Binary-image BPSK modulation, AWGN channel, q-ary LLR-vector init.

Conventions:
  - GF(2^p) symbol -> p bits LSB-first (gf.GF.bits) -> BPSK x = 1 - 2b.
  - Eb/N0 in dB with code rate R: sigma^2 = 1 / (2 R 10^(EbN0/10)) per
    coded BPSK dimension.
  - llr[a] = log P(y | symbol a) up to an additive constant:
        llr[..., a] = -(2/sigma^2) * sum_i y_i * bits(a)_i
Noise comes from an explicit torch.Generator, so a run is reproducible.
"""

from __future__ import annotations

import numpy as np
import torch

from nbldpc_tpu_torch.gf import get_field


def ebn0_to_sigma(ebn0_db, rate: float):
    """Noise std-dev per BPSK dimension for Eb/N0 (dB) at code rate R."""
    ebn0 = 10.0 ** (np.asarray(ebn0_db, dtype=np.float64) / 10.0)
    return np.sqrt(1.0 / (2.0 * rate * ebn0))


def _bits(q: int, device, dtype) -> torch.Tensor:
    return torch.as_tensor(get_field(q).bits, dtype=dtype, device=device)


def modulate(symbols: torch.Tensor, q: int) -> torch.Tensor:
    """GF(q) symbols [..., N] int -> BPSK [..., N, p] float32 (bit 0 -> +1).

    The bits come by shifts, not by a gather from the [q, p] table: on an
    H100 that gather was the costliest part of a random-codeword sim step
    outside the decode."""
    shifts = torch.arange(q.bit_length() - 1, dtype=symbols.dtype, device=symbols.device)
    b = ((symbols[..., None] >> shifts) & 1).to(torch.float32)
    return 1.0 - 2.0 * b


def awgn(gen: torch.Generator, x: torch.Tensor, sigma) -> torch.Tensor:
    """y = x + sigma * n, n drawn from `gen` (on x's device)."""
    noise = torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    return x + torch.as_tensor(sigma, dtype=x.dtype, device=x.device) * noise


def llr_init(y: torch.Tensor, sigma, q: int) -> torch.Tensor:
    """Channel observations [..., N, p] -> symbol log-likelihoods [..., N, q].

    `sigma` is a scalar or broadcasts against y with trailing [..., 1, 1].
    The [.., p] x [q, p] contraction is summed in bit order in f32: it is
    tiny, and an exact f32 sum keeps the LLRs every decoder reads free of
    reduced-precision matmul modes.
    """
    bits = _bits(q, y.device, y.dtype)                     # [q, p]
    acc = y[..., 0:1] * bits[:, 0]
    for t in range(1, bits.shape[1]):
        acc = acc + y[..., t : t + 1] * bits[:, t]
    scale = 2.0 / torch.as_tensor(sigma, dtype=y.dtype, device=y.device) ** 2
    return scale * -acc


def transmit(gen: torch.Generator, codeword: torch.Tensor, sigma, q: int) -> torch.Tensor:
    """codeword [..., N] -> llr [..., N, q]: modulate + AWGN + LLR init."""
    return llr_init(awgn(gen, modulate(codeword, q), sigma), sigma, q)


def inject_errors(codeword: torch.Tensor, positions, values, q: int) -> torch.Tensor:
    """Deterministic symbol corruption (fault injection for decoder tests):
    XOR-add GF error values at the given positions of the last axis."""
    err = torch.zeros_like(codeword)
    err[..., torch.as_tensor(positions, dtype=torch.long)] = torch.as_tensor(
        values, dtype=codeword.dtype, device=codeword.device)
    return codeword ^ err


def perfect_llr(codeword: torch.Tensor, q: int, confidence: float = 40.0) -> torch.Tensor:
    """Noiseless LLRs for a codeword [..., N] -> [..., N, q]: 0 at the
    codeword's symbol, -confidence elsewhere."""
    onehot = torch.nn.functional.one_hot(codeword.long(), q).to(torch.float32)
    return confidence * (onehot - 1.0)
