"""Whole-decode resident EMS (q <= 32, classic merge): CUDA kernel + plain version.

The same decode as the JAX package's resident EMS kernel:
  prior = llr - max_q llr;  post = prior;  lc = 0        (lc in c-domain)
  per iteration, per edge e = (m, j) with variable v and weight h:
    Ve    = post[v] - lc[e], minus its max over q
    U(x)  = Ve(h^-1 x)                       (gather through perm_down);
            pad slots are forced to delta0 = (0, NEG, ...)
    O     = classic EMS check-node update of the check's dc operands
            (decoders/ems._cn_ems_core), then (O - max) + offset, min 0,
            max NEG
    lc[e](c) = O(h c)                        (gather through perm_up)
  post[v] = prior[v] + sum of lc over v's edges, in vn_edge slot order
  hard = argmax over q (ties to the lowest symbol), syndrome by syn_k bits.
EMS has only adds and max, so the kernel, which adds in this association,
gives the same hard decisions, done flags and iteration counts.

`resident_decode` launches csrc/ems_resident.cu for a CUDA tensor and runs
`decode_plain` for a CPU tensor. Both take llr [B, N, q] and return
(hard [B, N] int32, done [B] bool, iters [B] int32).
"""

from __future__ import annotations

import torch

from nbldpc_tpu_torch.decoders import ems
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import qspa_resident as qr

MAX_DC = 32
# most frames one block of csrc/ems_resident.cu holds (kMaxFrames there)
MAX_FRAMES = 3


def _bank_stride(n: int) -> int:
    """n rounded up to 4 (mod 32): consecutive checks' rows 4 banks apart."""
    return n + (4 - n) % 32


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def ems_smem_layout(n: int, m: int, dc: int, dv: int, q: int) -> tuple:
    """(frames per block, shared bytes per block) of csrc/ems_resident.cu's
    launch, which computes the same in `layout` and `block_bytes`: the
    routing tables as bytes and 16-bit words, then per frame prior and
    posterior [N, q], each check's dc lc rows and its dc - 2 backward
    partials, each padded to 4 (mod 32) floats, each check's 2 dc - 2 kept
    masks and the hard decisions as bytes; as many frames as fit in
    MAX_SMEM_BYTES, up to MAX_FRAMES (one frame when none fits: the wrapper
    then refuses the code)."""
    E, p = m * dc, q.bit_length() - 1
    cs = _bank_stride(dc * q)
    bs = _bank_stride((dc - 2) * q)
    frame = (2 * _round_up(n * q, 4) + m * (cs + bs) + _round_up(m * (2 * dc - 2), 4)
             + _round_up(-(-n // 4), 4))
    tables = _round_up(E * q + 2 * E + 2 * n * dv + E * p, 16)
    frames = MAX_FRAMES
    while frames > 1 and tables + 4 * frames * frame > qr.MAX_SMEM_BYTES:
        frames -= 1
    return frames, tables + 4 * frames * frame


class ResidentEMS(qr.ResidentQSPA):
    """Tables and options of one resident EMS decode configuration: the
    resident QSPA's routing tables, with the EMS check-node update."""

    def __init__(self, graph: TannerGraph, max_iters: int, nm: int | None = None,
                 offset: float = 0.0, early_term: bool = True,
                 stats_each_iter: bool = True):
        if graph.q > 32:
            raise ValueError("the resident EMS decoder supports q <= 32")
        if graph.dc_max > MAX_DC:
            raise ValueError(f"the resident EMS decoder supports dc <= {MAX_DC}")
        super().__init__(graph, max_iters, early_term, stats_each_iter)
        self.nm = min(graph.q if nm is None else int(nm), graph.q)
        if self.nm < 1:
            raise ValueError(f"nm={nm} must be >= 1")
        self.offset = float(offset)
        g = graph
        self.frames_per_block, self.smem_bytes = ems_smem_layout(
            g.n, g.m, g.dc_max, g.dv_max, g.q)

    def _iteration(self, prior, post, lc):
        """One EMS iteration on [rows, q, B] tensors; returns (post, lc)."""
        g = self.graph
        q, m, dc = g.q, g.m, g.dc_max
        B = prior.shape[-1]
        U = self._down(post, lc)
        U = U - U.amax(dim=1, keepdim=True)
        if g.has_cn_pads:
            d0 = ems._delta0(q, U.device).view(q, 1)
            U = torch.where(self._real[:, None, None], U, d0)
        O = torch.stack(ems._cn_ems_core(list(U.view(m, dc, q, B).unbind(1)), self.nm), 1)
        return self._up(prior, ems._postprocess(O, self.offset, dim=2).reshape(-1, B))


def decode_plain(dec: ResidentEMS, llr: torch.Tensor):
    """Plain PyTorch resident EMS decode: llr [B, N, q] -> (hard, done, iters)."""
    decode_plain.calls += 1
    return qr.run_plain(dec, llr)


decode_plain.calls = 0


def resident_decode(dec: ResidentEMS, llr: torch.Tensor):
    """Resident EMS decode of llr [B, N, q] f32: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if llr.device.type == "cpu":
        return decode_plain(dec, llr)
    return _launch(dec, llr)


def _launch(dec: ResidentEMS, llr: torch.Tensor):
    """Check llr and launch the kernel; raises ValueError on anything it does
    not take: a code whose block needs more than MAX_SMEM_BYTES of shared
    memory (before any device check), a CPU tensor, a bad shape or dtype."""
    g = dec.graph
    hard, done, iters = qr.checked_outputs(dec, llr, "resident_decode", dec.smem_bytes)
    if llr.device.type != "cuda":
        raise ValueError(f"resident_decode: unsupported device {llr.device}")
    if llr.shape[0] == 0:
        return hard, done, iters
    from nbldpc_tpu_torch.kernels import _build

    _build.launch(resident_decode, "ems_resident_decode", llr.device,
                  llr.data_ptr(), hard.data_ptr(), done.data_ptr(), iters.data_ptr(),
                  llr.shape[0], g.n, g.m, g.dc_max, g.dv_max, g.q, dec.nm, dec.offset,
                  dec.cn_vn.data_ptr(), dec.cn_real.data_ptr(), dec.perm_down.data_ptr(),
                  dec.vn_edge.data_ptr(), dec.syn_k.data_ptr(),
                  dec.max_iters, int(dec.early_term), int(dec.stats_each_iter))
    return hard, done, iters


resident_decode.launches = 0


def get_resident_ems(graph: TannerGraph, max_iters: int, nm: int, offset: float,
                     early_term: bool, stats_each_iter: bool = True) -> ResidentEMS:
    """A ResidentEMS for this configuration, cached on the graph."""
    key = ("ems", int(max_iters), int(nm), float(offset), bool(early_term),
           bool(stats_each_iter))
    cache = graph.__dict__.setdefault("_resident_cache", {})
    if key not in cache:
        cache[key] = ResidentEMS(graph, max_iters, nm, offset, early_term,
                                 stats_each_iter)
    return cache[key]
