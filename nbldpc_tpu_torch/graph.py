"""Tanner graph as dense padded index tables, held as torch tensors.

Edge ordering is CN-major: edge slot (m, j) has flat id m * dc_max + j.
Irregular codes are padded to [M, dc_max] / [N, dv_max] and masked.
Messages are batch-last, [M, dc_max, q, B] / [N, dv_max, q, B] (the
decoders' decode_bl), or q-last, [B, M, dc_max, q] / [B, N, dv_max, q]
(common.decode, batch_last=False).

GF edge weights are folded into permutation tables:
  perm_down[m, j, a] = h_mj^{-1} * a   (variable->check: U(a) = V[perm_down])
  perm_up[m, j, a]   = h_mj * a        (check->variable: C(a) = Chat[perm_up])
and into the combined routing tables down_idx / up_idx, so no field
arithmetic runs in the decode loop: only index gathers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nbldpc_tpu_torch.code import CodeSpec
from nbldpc_tpu_torch.gf import get_field

# Log-domain "minus infinity" written into pad CN slots; exp(PAD_NEG - max)
# is exactly 0.0 in f32, so the softmax of a pad slot is exactly delta0.
PAD_NEG = -1e30

# Names of the host tables, in the order convert.py and the tests use.
TABLE_NAMES = ("cn_vn", "cn_w", "cn_mask", "vn_edge", "vn_mask",
               "cn_slot_of_vn_slot", "perm_down", "perm_up", "down_idx",
               "up_idx", "syn_k")


def host_tables(spec: CodeSpec) -> dict:
    """numpy index tables of a code's Tanner graph (see module docstring)."""
    gf = get_field(spec.q)
    q, n, m = spec.q, spec.n, spec.m
    dc, dv = spec.dc, spec.dv
    dc_max, dv_max = int(dc.max()), int(dv.max())

    cn_vn = np.zeros((m, dc_max), dtype=np.int32)          # pad -> vn 0
    cn_w = np.ones((m, dc_max), dtype=np.int32)            # pad -> weight 1
    cn_mask = np.zeros((m, dc_max), dtype=bool)
    for mi, (cols, vals) in enumerate(zip(spec.row_cols, spec.row_vals)):
        cn_vn[mi, : len(cols)] = cols
        cn_w[mi, : len(cols)] = vals
        cn_mask[mi, : len(cols)] = True

    # VN-side slots hold the flat CN-major edge ids of each variable's edges
    # in increasing check order; pad slots point one past the last edge.
    vn_edge = np.full((n, dv_max), m * dc_max, dtype=np.int32)
    vn_fill = np.zeros(n, dtype=np.int32)
    cn_slot_of_vn_slot = np.full((m, dc_max), n * dv_max, dtype=np.int32)
    for mi in range(m):
        for j in range(int(dc[mi])):
            v = int(cn_vn[mi, j])
            s = int(vn_fill[v])
            vn_edge[v, s] = mi * dc_max + j
            cn_slot_of_vn_slot[mi, j] = v * dv_max + s
            vn_fill[v] += 1
    if not np.array_equal(vn_fill, dv):
        raise ValueError("edge bookkeeping mismatch")
    vn_mask = np.arange(dv_max)[None, :] < dv[:, None]

    a = np.arange(q, dtype=np.int64)
    w = cn_w.astype(np.int64)
    perm_down = gf.mul[gf.inv[w][:, :, None], a[None, None, :]]
    perm_up = gf.mul[w[:, :, None], a[None, None, :]]

    # Routing and GF permutation in one gather per phase:
    #   down_idx: (VN-major V, c-domain) -> (CN-major U, x-domain)
    #   up_idx:   (CN-major Chat, x-domain) -> (VN-major C, c-domain)
    # Pad slots point one past the end of the flat source (clipped, then
    # overwritten by the pad fix-up).
    vn_flat_size = n * dv_max * q
    cn_flat_size = m * dc_max * q
    down_idx = np.where(
        cn_mask[:, :, None],
        cn_slot_of_vn_slot[:, :, None].astype(np.int64) * q + perm_down,
        vn_flat_size + a[None, None, :],
    ).astype(np.int32)
    pu_flat = perm_up.reshape(m * dc_max, q)
    ve = vn_edge.astype(np.int64)
    up_idx = np.where(
        vn_mask[:, :, None],
        ve[:, :, None] * q + pu_flat[np.minimum(ve, m * dc_max - 1)],
        cn_flat_size,
    ).astype(np.int32)

    # Syndrome bit-decomposition: syn_k[m, j, t] = h_mj * 2^t (0 on pads),
    # so h*c = XOR_t bit_t(c) * syn_k.
    pows = (1 << np.arange(gf.p)).astype(np.int64)
    syn_k = gf.mul[cn_w.astype(np.int64)[:, :, None], pows[None, None, :]]
    syn_k = np.where(cn_mask[:, :, None], syn_k, 0).astype(np.int32)

    return {
        "cn_vn": cn_vn, "cn_w": cn_w, "cn_mask": cn_mask,
        "vn_edge": vn_edge, "vn_mask": vn_mask,
        "cn_slot_of_vn_slot": cn_slot_of_vn_slot,
        "perm_down": perm_down.astype(np.int32),
        "perm_up": perm_up.astype(np.int32),
        "down_idx": down_idx, "up_idx": up_idx, "syn_k": syn_k,
    }


class TannerGraph:
    """A CodeSpec's Tanner graph as index tensors on one device."""

    def __init__(self, spec: CodeSpec, device, tables: dict | None = None):
        self.spec = spec
        self.gf = get_field(spec.q)
        self.device = torch.device(device)
        self.q, self.n, self.m = spec.q, spec.n, spec.m
        self.dc_max = int(spec.dc.max())
        self.dv_max = int(spec.dv.max())
        if tables is None:
            host = host_tables(spec)
        else:  # e.g. convert.graph_tables_from_numpy: tensors or arrays
            host = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
                    for k, v in tables.items()}
        self.np = host
        self.has_cn_pads = not bool(host["cn_mask"].all())
        self.has_vn_pads = not bool(host["vn_mask"].all())
        t = {k: torch.from_numpy(np.ascontiguousarray(host[k])).to(self.device)
             for k in TABLE_NAMES}
        for name in TABLE_NAMES:
            setattr(self, name, t[name])
        # int64 gather indices, clipped like jnp.take(mode="clip")
        self._down = t["down_idx"].reshape(-1).long().clamp_(
            max=self.n * self.dv_max * self.q - 1)
        self._up = t["up_idx"].reshape(-1).long().clamp_(
            max=self.m * self.dc_max * self.q - 1)
        self._cn_vn = t["cn_vn"].reshape(-1).long()
        self._vn_edge = t["vn_edge"].reshape(-1).long()
        self._cn_slot = t["cn_slot_of_vn_slot"].reshape(-1).long()

    @functools.cached_property
    def _pad_block(self) -> torch.Tensor:
        """Log-domain delta0 [q, 1] read by pad CN slots: (0, PAD_NEG, ...)."""
        blk = torch.full((self.q, 1), PAD_NEG, dtype=torch.float32,
                         device=self.device)
        blk[0] = 0.0
        return blk

    # ---- batch-last routing: messages [M, dc, q, B] / [N, dv, q, B] ----

    def gather_vn_x_bl(self, Chat: torch.Tensor) -> torch.Tensor:
        """[M, dc_max, q, B] x-domain -> [N, dv_max, q, B] c-domain.

        Pad VN slots become 0, the additive identity of the posterior sum."""
        flat = Chat.reshape(self.m * self.dc_max * self.q, Chat.shape[-1])
        out = flat.index_select(0, self._up).reshape(
            self.n, self.dv_max, self.q, -1)
        if self.has_vn_pads:
            out = torch.where(self.vn_mask[:, :, None, None], out, 0.0)
        return out

    def gather_cn_x_bl(self, Vv: torch.Tensor) -> torch.Tensor:
        """[N, dv_max, q, B] c-domain -> [M, dc_max, q, B] x-domain.

        Pad CN slots become log-delta0, so CN updates need no masks."""
        flat = Vv.reshape(self.n * self.dv_max * self.q, Vv.shape[-1])
        out = flat.index_select(0, self._down).reshape(
            self.m, self.dc_max, self.q, -1)
        if self.has_cn_pads:
            out = torch.where(self.cn_mask[:, :, None, None], out,
                              self._pad_block.to(Vv.dtype))
        return out

    def syndrome_bl(self, hard: torch.Tensor) -> torch.Tensor:
        """hard [N, B] int32 -> syndrome [M, B] int32 (0 == satisfied)."""
        return syndrome(hard, self._cn_vn, self.syn_k)

    # ---- q-last routing: messages [B, M, dc, q] / [B, N, dv, q] ----

    def _take(self, x: torch.Tensor, idx: torch.Tensor, rows: int, slots: int,
              pad_row: bool) -> torch.Tensor:
        """Rows idx of x's flat [B, slots', q] form -> [B, rows, slots, q];
        pad_row appends the all-zero row that pad indices point at."""
        B = x.shape[0]
        flat = x.reshape(B, -1, self.q)
        if pad_row:
            flat = torch.cat([flat, flat.new_zeros(B, 1, self.q)], dim=1)
        return flat.index_select(1, idx).reshape(B, rows, slots, self.q)

    def gather_vn(self, C: torch.Tensor) -> torch.Tensor:
        """CN-major [B, M, dc_max, q] -> VN-major [B, N, dv_max, q]; pad VN
        slots read an appended all-zero row."""
        return self._take(C, self._vn_edge, self.n, self.dv_max, pad_row=True)

    def gather_cn(self, Vv: torch.Tensor) -> torch.Tensor:
        """VN-major [B, N, dv_max, q] -> CN-major [B, M, dc_max, q]; pad CN
        slots read an appended all-zero row (CN updates mask them)."""
        return self._take(Vv, self._cn_slot, self.m, self.dc_max, pad_row=True)

    def gather_cn_x(self, Vv: torch.Tensor) -> torch.Tensor:
        """VN-major c-domain [B, N, dv_max, q] -> CN-major x-domain U [B, M,
        dc_max, q], U_e(a) = V_e(h_e^{-1} a): routing and GF permutation in
        one gather of the flat [B, N dv_max q]. Pad CN slots become
        log-delta0 (skipped for CN-regular codes)."""
        B = Vv.shape[0]
        out = Vv.reshape(B, -1).index_select(1, self._down).reshape(
            B, self.m, self.dc_max, self.q)
        if self.has_cn_pads:
            out = torch.where(self.cn_mask[None, :, :, None], out,
                              self._pad_block[:, 0].to(Vv.dtype))
        return out

    def gather_vn_x(self, Chat: torch.Tensor) -> torch.Tensor:
        """CN-major x-domain [B, M, dc_max, q] -> VN-major c-domain C [B, N,
        dv_max, q], C_e(a) = Chat_e(h_e a), in one gather of the flat [B, M
        dc_max q]. Pad VN slots become 0 (skipped for VN-regular codes)."""
        B = Chat.shape[0]
        out = Chat.reshape(B, -1).index_select(1, self._up).reshape(
            B, self.n, self.dv_max, self.q)
        if self.has_vn_pads:
            out = torch.where(self.vn_mask[None, :, :, None], out, 0.0)
        return out

    def permute_down(self, V: torch.Tensor) -> torch.Tensor:
        """Per-edge GF weight: U(a) = V(h^{-1} a), V [B, M, dc_max, q]."""
        return torch.gather(V, 3, self.perm_down.long()[None].expand(V.shape))

    def permute_up(self, Chat: torch.Tensor) -> torch.Tensor:
        """Inverse weight map: C(a) = Chat(h a), Chat [B, M, dc_max, q]."""
        return torch.gather(Chat, 3, self.perm_up.long()[None].expand(Chat.shape))

    def syndrome(self, hard: torch.Tensor) -> torch.Tensor:
        """hard [B, N] int32 -> syndrome [B, M] int32 (0 == satisfied)."""
        return syndrome(hard.T, self._cn_vn, self.syn_k).T


def xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of x's entries along `dim` (0 where `dim` is empty)."""
    dim = dim % x.ndim
    if x.shape[dim] == 0:
        return x.new_zeros(x.shape[:dim] + x.shape[dim + 1:])
    out = x.select(dim, 0)
    for j in range(1, x.shape[dim]):
        out = out ^ x.select(dim, j)
    return out


def syndrome(hard: torch.Tensor, cn_vn: torch.Tensor, syn_k: torch.Tensor) -> torch.Tensor:
    """Syndromes of checks given as rows of cn_vn (flat int64 [M' dc]) and
    syn_k [M', dc, p]: hard [N, B] int32 -> [M', B] int32 (0 == satisfied)."""
    m, dc, p = syn_k.shape
    sym = hard.index_select(0, cn_vn).reshape(m, dc, -1)
    x = torch.zeros_like(sym)
    for t in range(p):
        x = x ^ (((sym >> t) & 1) * syn_k[:, :, t : t + 1])
    return xor_reduce(x, 1)
