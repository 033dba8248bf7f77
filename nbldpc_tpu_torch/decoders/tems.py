"""T-EMS: Trellis Extended Min-Sum decoder (delta-domain check-node update).

Messages are re-expressed relative to each edge's most reliable symbol
z_j; per output (column j, row a) the check takes the best deviation path
with at most two deviations:

    dW_j(eta) = max( m1x_j(eta),                                 # 1 deviation
                     max_{e1 ^ e2 = eta} dev(e1) + dev(e2) )     # 2 deviations
    C_j(a)    = dW_j(a ^ beta ^ z_j)        beta = XOR_i z_i  (syndrome symbol)

m1x/m2x are the per-row best/second-best deviations over the columns other
than j, taken from a per-row top-3 (value, column) table; a two-deviation
column collision substitutes the second-best side. n_r > 0 restricts the
first deviation e1 to the n_r most reliable rows (ranked per column by m1x,
ties to the lower row) while e2 = eta ^ e1 stays free.

The same decoder as the JAX package's decoders/tems.py, in both layouts.
XOR permutes are index gathers; every candidate is one f32 add and the rest
is max and select, so any scan order gives the same values. T-EMS has no
parameters beyond the decoder config (offset, n_r), and the graph tables
come over through convert.py, so no other state is carried across.

Implementations (`cn_impl`):
  "kernel" - kernels/cn_tems.py's CUDA check-node kernel inside decode_bl,
             with kernels/route.py's routing kernels;
  "torch"  - decode_bl with the plain check-node update and routing (the
             semantic reference, and what runs on the CPU);
  "auto"   - "kernel" for a CUDA tensor, "torch" for a CPU tensor.

`batch_last=False` runs the q-last path instead: common.decode with
tems_cn_update, messages [B, M, dc, q], plain PyTorch on the input's
device; `cn_impl="kernel"` is refused there (ValueError), where the JAX
package quietly runs XLA.
"""

from __future__ import annotations

import torch

from nbldpc_tpu_torch.decoders import common
from nbldpc_tpu_torch.graph import TannerGraph

NEG = -1e30
CN_IMPLS = ("auto", "kernel", "torch")


def _iota(q: int, device) -> torch.Tensor:
    return torch.arange(q, device=device).view(1, 1, q, 1)


def _xor_gather(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out[..., a, :] = x[..., a ^ h, :] along dim 2 (h broadcasts)."""
    idx = _iota(x.shape[2], x.device) ^ h
    return torch.gather(x, 2, idx.expand(x.shape))


def _top3_stacked(dU: torch.Tensor):
    """Per-row top-3 (value, column) over the dc axis (dim 1) of [M, dc, q, B]:
    a compare/shift cascade in column order with strict >, so ties keep the
    earlier column. Returns (m1, c1, m2, c2, m3), each [M, 1, q, B]."""
    first = dU[:, 0:1]
    m1 = torch.full_like(first, NEG)
    m2, m3 = m1, m1
    c1 = torch.zeros(first.shape, dtype=torch.int64, device=dU.device)
    c2 = c1
    for j in range(dU.shape[1]):
        v = dU[:, j:j + 1]
        b1 = v > m1
        b2 = (v > m2) & ~b1
        b3 = (v > m3) & ~b1 & ~b2
        m3 = torch.where(b1 | b2, m2, torch.where(b3, v, m3))
        m2 = torch.where(b1, m1, torch.where(b2, v, m2))
        c2 = torch.where(b1, c1, torch.where(b2, j, c2))
        m1 = torch.where(b1, v, m1)
        c1 = torch.where(b1, j, c1)
    return m1, c1, m2, c2, m3


def _two_deviation_dense(m1x, c1x, m2x) -> torch.Tensor:
    """dw(eta) = max over e1 ^ e2 = eta (e1, e2 != 0) of the two-deviation
    sum, with the equal-column collision fix (dw is NEG where none exists)."""
    q = m1x.shape[2]
    iota = _iota(q, m1x.device)
    dw = torch.full_like(m1x, NEG)
    for e1 in range(1, q):
        idx = torch.arange(q, device=m1x.device) ^ e1
        mp, sp, cp = (t.index_select(2, idx) for t in (m1x, m2x, c1x))
        v1, v2, ce = (t[:, :, e1:e1 + 1] for t in (m1x, m2x, c1x))
        cand = torch.where(ce == cp, torch.maximum(v1 + sp, v2 + mp), v1 + mp)
        cand = torch.where(iota == e1, NEG, cand)            # e2 = 0 forbidden
        dw = torch.maximum(dw, cand)
    return dw


def _two_deviation_bubble(m1x, c1x, m2x, n_r: int) -> torch.Tensor:
    """Truncated two-deviation search: e1 runs over the n_r rows with the
    largest m1x (row 0 excluded through the 2*NEG sentinel; each round takes
    the max and the lowest row reaching it, then sets it to 2*NEG), e2 stays
    free. The one-deviation term m1x stays exact. With n_r >= q the rounds
    past the q-th re-pick row 0, as the JAX package does."""
    q = m1x.shape[2]
    iota = _iota(q, m1x.device)
    run = torch.where(iota == 0, 2.0 * NEG, m1x)
    picks = []
    for _ in range(n_r):
        mx = run.amax(dim=2, keepdim=True)
        idx = torch.where(run >= mx, iota, q).amin(dim=2, keepdim=True)
        run = torch.where(iota == idx, 2.0 * NEG, run)
        picks.append((mx, torch.gather(m2x, 2, idx), torch.gather(c1x, 2, idx), idx))
    dw = m1x
    for v1, v2, c, idx in picks:
        # candidates indexed by e2; shifted to eta = e2 ^ e1 at the end
        cand = torch.where(c == c1x, torch.maximum(v1 + m2x, v2 + m1x), v1 + m1x)
        cand = torch.where(iota == 0, NEG, cand)             # e2 = 0 forbidden
        dw = torch.maximum(dw, _xor_gather(cand, idx))
    return dw


def _cn_tems_core(U: torch.Tensor, n_r: int = 0) -> torch.Tensor:
    """T-EMS check-node core on normalized U [M, dc, q, B] (max over q = 0,
    pad slots log-delta0: argmax 0, NEG deviation rows, 0 added to beta).
    Returns the extrinsics before the offset correction."""
    M, dc, q, B = U.shape
    if dc < 3:
        raise ValueError(f"the T-EMS top-3 scheme needs dc >= 3 edges per check, got {dc}")
    iota = _iota(q, U.device)
    z = torch.argmax(U, dim=2, keepdim=True)                 # ties: lowest symbol
    dU = _xor_gather(U, z)
    beta = z[:, 0:1]
    for j in range(1, dc):
        beta = beta ^ z[:, j:j + 1]

    m1, c1, m2, c2, m3 = _top3_stacked(dU)
    jcol = torch.arange(dc, device=U.device).view(1, dc, 1, 1)
    is_j0 = c1 == jcol
    is_j1 = c2 == jcol
    m1x = torch.where(is_j0, m2, m1)
    c1x = torch.where(is_j0, c2, c1)
    m2x = torch.where(is_j0 | is_j1, m3, m2)

    if n_r:
        dw = _two_deviation_bubble(m1x, c1x, m2x, n_r)
    else:
        dw = torch.maximum(_two_deviation_dense(m1x, c1x, m2x), m1x)
    dw = torch.where(iota == 0, 0.0, dw)                     # zero deviations
    return _xor_gather(dw, beta ^ z)                         # C_j(a) = dW(a ^ beta ^ z_j)


def tems_cn_update(U: torch.Tensor, graph: TannerGraph, offset: float = 0.0,
                   n_r: int = 0) -> torch.Tensor:
    """q-last CN update, U [B, M, dc_max, q] log-domain x-domain -> same:
    normalized, pad slots set to log-delta0, the core in its [M, dc, q, B]
    layout, then (out - max) + offset clipped to [NEG, 0] and pad outputs
    0. n_r > 0 selects the truncated-deviation search."""
    mask = graph.cn_mask[None, :, :, None]                    # [1, M, dc, 1]
    U = U - U.amax(dim=-1, keepdim=True)
    d0 = torch.full((graph.q,), NEG, dtype=U.dtype, device=U.device)
    d0[0] = 0.0
    U = torch.where(mask, U, d0)
    out = _cn_tems_core(U.permute(1, 2, 3, 0), n_r).permute(3, 0, 1, 2)
    out = torch.clamp_max((out - out.amax(dim=-1, keepdim=True)) + offset, 0.0)
    return torch.where(mask, torch.clamp_min(out, NEG), 0.0)


def tems_cn_update_bl(U: torch.Tensor, graph: TannerGraph | None = None,
                      offset: float = 0.0, n_r: int = 0) -> torch.Tensor:
    """Batch-last CN update: U [M, dc_max, q, B] log-domain x-domain -> same.

    Maskless: pad CN slots arrive as log-delta0 (graph.gather_cn_x_bl) and
    pad outputs are never routed. No clamp at NEG, unlike EMS. `graph` is
    unused; it keeps the decode_bl CN signature."""
    U = U - U.amax(dim=2, keepdim=True)
    out = _cn_tems_core(U, n_r)
    return torch.clamp_max((out - out.amax(dim=2, keepdim=True)) + offset, 0.0)


def pick_impl(cn_impl: str, llr: torch.Tensor) -> str:
    """Resolve "auto" from the tensor's device."""
    if cn_impl not in CN_IMPLS:
        raise ValueError(f"cn_impl={cn_impl!r}; expected one of {CN_IMPLS}")
    if cn_impl != "auto":
        return cn_impl
    return "kernel" if llr.device.type == "cuda" else "torch"


def decode(
    graph: TannerGraph,
    llr: torch.Tensor,
    max_iters: int = 20,
    offset: float = 0.0,
    early_term: bool = True,
    cn_impl: str = "auto",
    stats_each_iter: bool = True,
    n_r: int = 0,
    batch_last: bool = True,
) -> common.DecodeResult:
    """T-EMS decode of a batch: llr [B, N, q] f32 -> DecodeResult.

    n_r > 0 truncates the two-deviation search to the n_r most reliable
    rows; stats_each_iter=False is the fixed-budget throughput mode
    (ignored by the q-last path, batch_last=False). With early_term the
    check node computes only the frames not yet done (decode_bl's frame
    list)."""
    from nbldpc_tpu_torch.kernels import cn_tems

    if graph.dc_max < 3:
        raise ValueError(f"the T-EMS top-3 scheme needs dc >= 3, the code has {graph.dc_max}")
    if not batch_last:
        common.check_q_last_impl(cn_impl)
        cn = lambda U, g: tems_cn_update(U, g, offset, n_r)
        return common.decode(graph, llr, cn, max_iters, early_term)
    impl = pick_impl(cn_impl, llr)
    fn = cn_tems.cn_update if impl == "kernel" else cn_tems.cn_update_plain
    cn = lambda U, _graph, active, out: fn(U, offset, n_r, active, out)
    return common.decode_bl(graph, llr, cn, max_iters, early_term,
                            stats_each_iter=stats_each_iter, route=impl)
