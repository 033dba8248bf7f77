"""QSPA: q-ary sum-product decoder with a Hadamard-domain check-node update.

The CN update is a circular convolution over (GF(2^p), +), computed in the
Walsh-Hadamard domain: softmax -> WHT -> leave-one-out product over the
check's dc edges (sign/log-magnitude form, so products over 50 iterations
do not underflow) -> inverse WHT -> floor -> log. The GF weight
permutations live in the routing gathers (graph.gather_*_x_bl).

Three implementations (`cn_impl`):
  "resident" - kernels/qspa_resident.py: the whole decode in one CUDA
               kernel, probability-domain BP, any batch size (K0 for
               q <= 32, K0-cl for 32 < q <= 256);
  "kernel"   - kernels/cn_qspa.py's CUDA check-node kernel (K1) inside
               decode_bl, with kernels/route.py's routing kernels;
  "torch"    - decode_bl with the plain check-node update and routing (the
               semantic reference, and what runs on the CPU);
  "auto"     - "resident" for a CUDA tensor (every q <= 256: the resident
               kernels take any batch, so the JAX package's tile rule has
               no counterpart), "torch" for a CPU tensor.
The resident path can differ from the log-domain paths in rare fp ties.

`batch_last=False` runs the q-last path instead: common.decode with
qspa_cn_update, messages [B, M, dc, q], plain PyTorch on the input's
device. It has one implementation and one precision, so a kernel
`cn_impl` ("resident", "kernel") or mm_precision="bf16" is refused there
(ValueError), where the JAX package quietly runs f32 XLA.

`mm_precision` ("f32" or "bf16", as the JAX package's DecoderConfig) is the
element of the resident path's stored state: "bf16" keeps the prior, the
posterior and the edge messages in bf16 with the probability-domain
stretch in f32 (kernels/qspa_resident.py). Only the resident path has the
mode, as in the JAX package: "kernel" and "torch" (and so "auto" on a CPU
tensor) decode in f32 whatever it says, and so do EMS and T-EMS, which
never see it. Any other value raises ValueError.
"""

from __future__ import annotations

import torch

from nbldpc_tpu_torch.decoders import common
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import cn_qspa
from nbldpc_tpu_torch.kernels import qspa_resident as qr
from nbldpc_tpu_torch.kernels.wht import wht

CN_IMPLS = ("auto", "resident", "kernel", "torch")
MM_PRECISIONS = tuple(qr.PRECISIONS)


def qspa_cn_update(U: torch.Tensor, graph: TannerGraph) -> torch.Tensor:
    """q-last CN update, U [B, M, dc_max, q] log-domain x-domain -> same.

    Pad slots are set to delta0 after the softmax (the convolution
    identity) and their outputs to 0. The sums run in the batch-last plain
    version's association (the softmax's over q as K1's, the log-magnitudes'
    over dc left to right), so both layouts round alike."""
    q = graph.q
    mask = graph.cn_mask[None, :, :, None]
    e = torch.exp(U - U.amax(dim=-1, keepdim=True))
    P = e / cn_qspa._softmax_sum(e, -1)                   # prob domain
    delta0 = torch.zeros(q, dtype=P.dtype, device=P.device)
    delta0[0] = 1.0
    P = torch.where(mask, P, delta0)
    F = wht(P)                                            # spectra, |F| <= 1
    sign = torch.where(F < 0, -1.0, 1.0).to(F.dtype)
    logmag = torch.log(F.abs() + cn_qspa.MAG_TINY)
    lsum = cn_qspa._sum_in_order(logmag, 2)               # over dc
    ssum = sign[:, :, 0:1]
    for j in range(1, U.shape[2]):
        ssum = ssum * sign[:, :, j:j + 1]
    G = (ssum * sign) * torch.exp(lsum - logmag)          # leave-one-out
    Q = torch.clamp_min(wht(G) / q, cn_qspa.PROB_FLOOR)
    Chat = torch.log(Q)
    return torch.where(mask, Chat - Chat.amax(dim=-1, keepdim=True), 0.0)


def qspa_cn_update_bl(U: torch.Tensor, graph: TannerGraph) -> torch.Tensor:
    """Batch-last CN update, U [M, dc_max, q, B] log-domain x-domain -> same.

    Maskless: pad CN slots arrive as log-delta0, whose spectrum adds exactly
    0 to the leave-one-out log-sum, and pad outputs are never read."""
    return cn_qspa.cn_update_plain(U)


def qspa_cn_update_bl_kernel(U: torch.Tensor, graph: TannerGraph) -> torch.Tensor:
    """The CUDA check-node kernel (plain version on a CPU tensor)."""
    return cn_qspa.cn_update(U)


def pick_impl(cn_impl: str, graph: TannerGraph, llr: torch.Tensor) -> str:
    """Resolve "auto" from the tensor's device and the field size."""
    if cn_impl not in CN_IMPLS:
        raise ValueError(f"cn_impl={cn_impl!r}; expected one of {CN_IMPLS}")
    if cn_impl != "auto":
        return cn_impl
    return "resident" if llr.device.type == "cuda" else "torch"


def decode(
    graph: TannerGraph,
    llr: torch.Tensor,
    max_iters: int = 20,
    early_term: bool = True,
    cn_impl: str = "auto",
    mm_precision: str = "f32",
    stats_each_iter: bool = True,
    batch_last: bool = True,
) -> common.DecodeResult:
    """QSPA decode of a batch: llr [B, N, q] f32 -> DecodeResult.
    batch_last=False: the q-last path (stats_each_iter is ignored there)."""
    if mm_precision not in MM_PRECISIONS:
        raise ValueError(f"mm_precision={mm_precision!r}; expected one of {MM_PRECISIONS}")
    if not batch_last:
        common.check_q_last_impl(cn_impl)
        if mm_precision != "f32":
            raise ValueError(f"mm_precision={mm_precision!r}: the q-last path "
                             "(batch_last=False) decodes in f32 only")
        return common.decode(graph, llr, qspa_cn_update, max_iters, early_term)
    impl = pick_impl(cn_impl, graph, llr)
    if impl == "resident":
        dec = qr.get_resident_decoder(graph, max_iters, early_term, stats_each_iter,
                                      mm_precision)
        hard, done, iters = qr.resident_decode(dec, llr)
        return common.DecodeResult(hard=hard, done=done, iters=iters)
    cn = common.full_width(qspa_cn_update_bl_kernel if impl == "kernel"
                           else qspa_cn_update_bl)
    return common.decode_bl(graph, llr, cn, max_iters, early_term,
                            stats_each_iter=stats_each_iter, route=impl)
