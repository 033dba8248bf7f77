"""One QSPA check-node phase on [M, dc, q, B] (CUDA kernel + plain version).

softmax over q -> WHT -> leave-one-out sign/log-magnitude product over dc
-> inverse WHT / q -> floor -> log -> max-renormalize. Pad slots arrive as
log-delta0 (graph.gather_cn_x_bl), whose spectrum is all ones and adds
exactly 0 to the leave-one-out log-sum, so the update needs no masks.

`cn_update` launches csrc/cn_qspa.cu for a CUDA tensor and runs
`cn_update_plain` for a CPU tensor.
"""

from __future__ import annotations

import torch

from nbldpc_tpu_torch.kernels.wht import wht_axis

PROB_FLOOR = 1e-12
MAG_TINY = 1e-30


def _sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` left to right (keepdim)."""
    s = x.narrow(dim, 0, 1)
    for i in range(1, x.shape[dim]):
        s = s + x.narrow(dim, i, 1)
    return s


def _softmax_sum(e: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """Sum of e over q, its dim `dim` ([M, dc, q, B]: 2; q-last: -1), in
    K1's association (keepdim): with L = 32 for q >= 32 (1 below), the
    symbols l, l + L, ... of each l left to right, then a pairwise tree over
    l (l and l ^ h at h = 1, 2, ..., L / 2); for q < 32 that is left to
    right. The kernel takes it whatever lanes hold a frame.

    The inverse WHT cancels to values near 1e-12, so a sum taken in another
    order moves the log-tail outputs by up to ~1e-2; in one order the
    kernel and this version round alike, and so do the two layouts."""
    dim = dim % e.ndim
    lead, q, tail = e.shape[:dim], e.shape[dim], e.shape[dim + 1:]
    L = 1 if q < 32 else 32
    p = _sum_in_order(e.reshape(lead + (q // L, L) + tail), dim).squeeze(dim)  # L at dim
    while p.shape[dim] > 1:
        p = p.reshape(lead + (p.shape[dim] // 2, 2) + tail)
        p = p.select(dim + 1, 0) + p.select(dim + 1, 1)
    return p


def cn_update_plain(U: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch check-node update: U [M, dc, q, B] f32 -> same."""
    cn_update_plain.calls += 1
    q = U.shape[2]
    e = torch.exp(U - U.amax(dim=2, keepdim=True))
    P = e / _softmax_sum(e)
    F = wht_axis(P, axis=2)                              # spectra, |F| <= 1
    sign = torch.where(F < 0, -1.0, 1.0).to(F.dtype)
    logmag = torch.log(F.abs() + MAG_TINY)
    lsum = _sum_in_order(logmag, 1)                      # over dc
    ssum = sign[:, 0:1]
    for j in range(1, U.shape[1]):
        ssum = ssum * sign[:, j : j + 1]
    G = (ssum * sign) * torch.exp(lsum - logmag)         # leave-one-out
    Q = torch.clamp_min(wht_axis(G, axis=2) / q, PROB_FLOOR)
    Chat = torch.log(Q)
    return Chat - Chat.amax(dim=2, keepdim=True)


cn_update_plain.calls = 0


def cn_update(U: torch.Tensor) -> torch.Tensor:
    """Check-node update U [M, dc, q, B] f32 -> same: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if U.device.type == "cpu":
        return cn_update_plain(U)
    if U.device.type != "cuda":
        raise ValueError(f"cn_update: unsupported device {U.device}")
    if U.dtype != torch.float32 or U.ndim != 4 or not U.is_contiguous():
        raise ValueError("cn_update: U must be a contiguous [M, dc, q, B] float32 tensor")
    if U.shape[2] not in (2, 4, 8, 16, 32, 64, 128, 256):
        raise ValueError(f"cn_update: q={U.shape[2]} unsupported")
    from nbldpc_tpu_torch.kernels import _build

    return _build.launch_cn(cn_update, "cn_qspa_update", U)


cn_update.launches = 0
