"""EMS: Extended Min-Sum decoder with nm-truncated configuration sets.

Log-domain max-sum check-node update over (GF(2^p), +), restricted to the
nm most reliable entries of each message, with forward/backward elementary
merges and offset correction. The same decoder as the JAX package's
decoders/ems.py, in two variants:

  classic - every elementary merge combines an ACC operand in compensated
            dense form (entries outside its top-nm hold the smallest kept
            value) with an OP operand in list form (entries outside its
            top-nm are NEG); partials are re-extracted after every merge;
            edge outputs are dense. Merges scan all q symbols for q <= 64
            and the nm list entries above that; both give the same values.
  bubble  - operands stay sorted nm-lists; a merge takes the top-nm of a
            static staircase of candidate pairs plus floor-valued fill
            candidates, deduplicated by GF index; final outputs are dense.

Top-nm extraction is nm rounds of (max, lowest index reaching it, set it to
NEG): ties go to the lower GF index, and when fewer than nm entries are
finite, NEG entries are kept the same way. XOR permutes are index gathers;
max is rounding-free, so any scan order gives the same values.

Implementations (`cn_impl`):
  "resident" - kernels/ems_resident.py: the whole decode in one CUDA kernel
               (q <= 32, classic merge, any batch size);
  "kernel"   - kernels/cn_ems.py's CUDA check-node kernel inside decode_bl,
               with kernels/route.py's routing kernels;
  "torch"    - decode_bl with the plain check-node update and routing (the
               semantic reference, and what runs on the CPU);
  "auto"     - "resident" for a CUDA tensor when q <= 32 and the merge is
               classic, else "kernel"; "torch" for a CPU tensor.

`batch_last=False` runs the q-last path instead: common.decode with
ems_cn_update (the classic merge), messages [B, M, dc, q], plain PyTorch
on the input's device. A kernel `cn_impl` ("resident", "kernel") or
merge="bubble" is refused there (ValueError), where the JAX package
quietly runs classic XLA.
"""

from __future__ import annotations

import torch

from nbldpc_tpu_torch.decoders import common
from nbldpc_tpu_torch.graph import TannerGraph

NEG = -1e30
# Classic merges scan all q symbols up to this field size, the nm list
# entries above it.
DENSE_MERGE_MAX_Q = 64
CN_IMPLS = ("auto", "resident", "kernel", "torch")
MERGES = ("classic", "bubble")


def _delta0(q: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Identity of the max-xor-convolution: 0 at symbol 0, NEG elsewhere."""
    d = torch.full((q,), NEG, dtype=dtype, device=device)
    d[0] = 0.0
    return d


def _iota(q: int, device) -> torch.Tensor:
    return torch.arange(q, device=device).view(1, q, 1)


def _xor_idx(q: int, h: int, device) -> torch.Tensor:
    return torch.arange(q, device=device) ^ h


# ---- classic ----------------------------------------------------------------
# Per-slot tensors are [M, q, B] (q on dim 1); list entries vals/idxs are
# [M, 1, B] each, in descending order.


def _top_extract(x: torch.Tensor, nm: int):
    """Stable top-nm of x over dim 1 -> (lst, dense, vals, idxs).

    `lst` is x on the kept entries and NEG elsewhere; `dense` fills the
    rest with the compensation value vals[nm-1]."""
    q = x.shape[1]
    iota = _iota(q, x.device)
    run = x
    removed = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    vals, idxs = [], []
    for _ in range(nm):
        mx = run.amax(dim=1, keepdim=True)
        idx = torch.where(run >= mx, iota, q).amin(dim=1, keepdim=True)
        sel = iota == idx
        removed = removed | sel
        run = torch.where(sel, NEG, run)
        vals.append(mx)
        idxs.append(idx)
    lst = torch.where(removed, x, NEG)
    dense = torch.where(removed, x, vals[-1])
    return lst, dense, vals, idxs


def _merge_dense(accM: torch.Tensor, opM: torch.Tensor) -> torch.Tensor:
    """out[a] = max_b opM[b] + accM[a ^ b], scanning all q symbols b."""
    q = accM.shape[1]
    out = None
    for b in range(q):
        cand = opM[:, b:b + 1] + accM.index_select(1, _xor_idx(q, b, accM.device))
        out = cand if out is None else torch.maximum(out, cand)
    return out


def _merge_scan(accM: torch.Tensor, vals, idxs) -> torch.Tensor:
    """out[a] = max_t vals[t] + accM[a ^ idxs[t]] over the nm list entries."""
    q = accM.shape[1]
    iota = _iota(q, accM.device)
    out = None
    for v, i in zip(vals, idxs):
        cand = v + torch.gather(accM, 1, (iota ^ i).expand(accM.shape))
        out = cand if out is None else torch.maximum(out, cand)
    return out


def _cn_ems_core(Ujs: list, nm: int) -> list:
    """Classic truncated forward/backward EMS over one check's dc operands
    (normalized x-domain [M, q, B], pads as delta0) -> dc extrinsic outputs."""
    dc = len(Ujs)
    if dc < 2:
        raise ValueError("the EMS check-node update needs dc >= 2 edges per check")
    q = Ujs[0].shape[1]
    if nm >= q:
        merge = lambda acc, op: _merge_dense(acc[1], op[0])
        extract = lambda x: (x, x, None, None)
    elif q <= DENSE_MERGE_MAX_Q:
        merge = lambda acc, op: _merge_dense(acc[1], op[0])
        extract = lambda x: _top_extract(x, nm)
    else:
        merge = lambda acc, op: _merge_scan(acc[1], op[2], op[3])
        extract = lambda x: _top_extract(x, nm)

    quads = [extract(u) for u in Ujs]
    F = [None] * dc                       # F[j]: merge of U[0..j-1]
    F[1] = quads[0]
    for j in range(2, dc):
        F[j] = extract(merge(F[j - 1], quads[j - 1]))
    B = [None] * dc                       # B[j]: merge of U[j+1..dc-1]
    B[dc - 2] = quads[dc - 1]
    for j in range(dc - 3, -1, -1):
        B[j] = extract(merge(B[j + 1], quads[j + 1]))
    outs = []
    for j in range(dc):
        if j == 0:
            outs.append(B[0][1])
        elif j == dc - 1:
            outs.append(F[dc - 1][1])
        else:
            outs.append(merge(F[j], B[j]))
    return outs


# ---- bubble -----------------------------------------------------------------
# A list is (vals [M, nm, B] descending, idxs [M, nm, B], comp [M, 1, B]).


def bubble_pairs(nm: int, budget: int = 2) -> list:
    """Static staircase candidate set: (t+1)*(s+1) <= budget*nm, lex order."""
    return [(t, s) for t in range(nm) for s in range(nm)
            if (t + 1) * (s + 1) <= budget * nm]


def _top_list(x: torch.Tensor, nm: int):
    """Top-nm (vals, idxs) of x over dim 1, descending, ties -> lower index."""
    _, _, vals, idxs = _top_extract(x, nm)
    return torch.cat(vals, 1), torch.cat(idxs, 1)


def _pair_candidates(acc, op, TS):
    """Staircase pair values a_t + b_s, their GF indices, and the floor f."""
    accV, accI, accC = acc
    opV, opI, _ = op
    T, S = TS
    cv = accV.index_select(1, T) + opV.index_select(1, S)
    ci = accI.index_select(1, T) ^ opI.index_select(1, S)
    f = opV[:, 0:1] + accC
    return cv, ci, f


def _merge_bubble(acc, op, TS, nm: int, q: int):
    """Top-nm of the staircase candidates above the floor f = opv_0 +
    acc_comp plus min(2nm, q) fill candidates of value f at GF indices
    0, 1, ...; picking a GF index retires every candidate on it. Ties go to
    the first position (staircase in lex (t, s) order, then the fills)."""
    cv, ci, f = _pair_candidates(acc, op, TS)
    nf = min(2 * nm, q)
    M, _, B = cv.shape
    cv = torch.cat([torch.where(cv > f, cv, NEG), f.expand(M, nf, B)], 1)
    ci = torch.cat([ci, torch.arange(nf, device=ci.device).view(1, nf, 1)
                    .expand(M, nf, B)], 1)
    P = cv.shape[1]
    iota = _iota(P, cv.device)
    run = cv
    vals, idxs = [], []
    for _ in range(nm):
        mx = run.amax(dim=1, keepdim=True)
        pos = torch.where(run >= mx, iota, P).amin(dim=1, keepdim=True)
        pick = torch.gather(ci, 1, pos)
        run = torch.where(ci == pick, NEG, run)
        vals.append(torch.maximum(mx, f))
        idxs.append(pick)
    return torch.cat(vals, 1), torch.cat(idxs, 1), vals[-1]


def _merge_bubble_dense(acc, op, TS, q: int) -> torch.Tensor:
    """Final-output merge: out[a] = max(f, max over staircase pairs landing
    on a of their value), f the compensation floor."""
    cv, ci, f = _pair_candidates(acc, op, TS)
    iota = _iota(q, cv.device)
    out = f.expand(f.shape[0], q, f.shape[2])
    for p in range(cv.shape[1]):
        out = torch.maximum(out, torch.where(iota == ci[:, p:p + 1],
                                             cv[:, p:p + 1], NEG))
    return out


def _scatter_list(lst, q: int) -> torch.Tensor:
    """List -> dense: kept entries at their GF indices, the rest at comp;
    written largest-last, so the larger value wins at duplicate indices."""
    vals, idxs, comp = lst
    iota = _iota(q, vals.device)
    out = comp.expand(comp.shape[0], q, comp.shape[2])
    for t in reversed(range(vals.shape[1])):
        out = torch.where(iota == idxs[:, t:t + 1], vals[:, t:t + 1], out)
    return out


def _cn_ems_bubble_core(Ujs: list, nm: int) -> list:
    """Bubble forward/backward EMS over one check's dc operands."""
    dc = len(Ujs)
    if dc < 2:
        raise ValueError("the EMS check-node update needs dc >= 2 edges per check")
    q = Ujs[0].shape[1]
    dev = Ujs[0].device
    pairs = bubble_pairs(nm)
    TS = (torch.tensor([t for t, _ in pairs], device=dev),
          torch.tensor([s for _, s in pairs], device=dev))
    quads = []
    for u in Ujs:
        v, i = _top_list(u, nm)
        quads.append((v, i, v[:, nm - 1:nm]))
    F = [None] * dc
    F[1] = quads[0]
    for j in range(2, dc):
        F[j] = _merge_bubble(F[j - 1], quads[j - 1], TS, nm, q)
    B = [None] * dc
    B[dc - 2] = quads[dc - 1]
    for j in range(dc - 3, -1, -1):
        B[j] = _merge_bubble(B[j + 1], quads[j + 1], TS, nm, q)
    outs = []
    for j in range(dc):
        if j == 0:
            outs.append(_scatter_list(B[0], q))
        elif j == dc - 1:
            outs.append(_scatter_list(F[dc - 1], q))
        else:
            outs.append(_merge_bubble_dense(F[j], B[j], TS, q))
    return outs


# ---- check-node update and decode -------------------------------------------


def _postprocess(O: torch.Tensor, offset: float, dim: int) -> torch.Tensor:
    """(O - max) + offset, then min(., 0), then max(., NEG)."""
    O = O - O.amax(dim=dim, keepdim=True)
    return torch.clamp_min(torch.clamp_max(O + offset, 0.0), NEG)


def ems_cn_update(U: torch.Tensor, graph: TannerGraph, nm: int = 16,
                  offset: float = 0.0) -> torch.Tensor:
    """q-last classic CN update, U [B, M, dc_max, q] log-domain x-domain ->
    same: normalized, pad slots set to delta0 (the merge identity), the
    classic core in its [M, q, B] layout, the offset over q, pad outputs 0.
    Every step is max, select, gather or one add an element, so the values
    are those of the batch-last update."""
    q = graph.q
    mask = graph.cn_mask[None, :, :, None]
    U = U - U.amax(dim=-1, keepdim=True)
    U = torch.where(mask, U, _delta0(q, U.device, U.dtype))
    Ub = U.permute(1, 2, 3, 0)                                # [M, dc, q, B]
    outs = _cn_ems_core([Ub[:, j] for j in range(Ub.shape[1])], min(nm, q))
    O = torch.stack(outs, dim=1).permute(3, 0, 1, 2)          # [B, M, dc, q]
    return torch.where(mask, _postprocess(O, offset, dim=-1), 0.0)


def ems_cn_update_bl(U: torch.Tensor, graph: TannerGraph | None = None,
                     nm: int = 16, offset: float = 0.0,
                     merge: str = "classic") -> torch.Tensor:
    """Batch-last CN update: U [M, dc_max, q, B] log-domain x-domain -> same.

    Pad CN slots arrive as log-delta0, the merge identity, from
    graph.gather_cn_x_bl, so no masking is needed (pad outputs are never
    routed). `graph` is unused; it keeps the decode_bl CN signature."""
    if merge not in MERGES:
        raise ValueError(f"merge={merge!r}; expected one of {MERGES}")
    q = U.shape[2]
    U = U - U.amax(dim=2, keepdim=True)
    Ujs = [U[:, j] for j in range(U.shape[1])]                 # [M, q, B]
    core = _cn_ems_bubble_core if merge == "bubble" else _cn_ems_core
    outs = core(Ujs, min(nm, q))
    return _postprocess(torch.stack(outs, dim=1), offset, dim=2)


def pick_impl(cn_impl: str, graph: TannerGraph, llr: torch.Tensor,
              merge: str = "classic") -> str:
    """Resolve "auto" from the tensor's device, the field size and the merge."""
    if cn_impl not in CN_IMPLS:
        raise ValueError(f"cn_impl={cn_impl!r}; expected one of {CN_IMPLS}")
    if merge not in MERGES:
        raise ValueError(f"merge={merge!r}; expected one of {MERGES}")
    if cn_impl == "resident" and merge == "bubble":
        raise ValueError("the resident EMS decoder runs the classic merge only")
    if cn_impl != "auto":
        return cn_impl
    if llr.device.type != "cuda":
        return "torch"
    return "resident" if graph.q <= 32 and merge == "classic" else "kernel"


def decode(
    graph: TannerGraph,
    llr: torch.Tensor,
    max_iters: int = 20,
    nm: int = 16,
    offset: float = 0.0,
    early_term: bool = True,
    cn_impl: str = "auto",
    stats_each_iter: bool = True,
    merge: str = "classic",
    batch_last: bool = True,
) -> common.DecodeResult:
    """EMS decode of a batch: llr [B, N, q] f32 -> DecodeResult.
    batch_last=False: the q-last path (stats_each_iter is ignored there)."""
    if not batch_last:
        common.check_q_last_impl(cn_impl)
        if merge != "classic":
            raise ValueError(f"merge={merge!r}: the q-last path (batch_last=False) "
                             "runs the classic merge only")
        cn = lambda U, g: ems_cn_update(U, g, nm, offset)
        return common.decode(graph, llr, cn, max_iters, early_term)
    impl = pick_impl(cn_impl, graph, llr, merge)
    if impl == "resident":
        from nbldpc_tpu_torch.kernels import ems_resident as er

        dec = er.get_resident_ems(graph, max_iters, nm, offset, early_term,
                                  stats_each_iter)
        hard, done, iters = er.resident_decode(dec, llr)
        return common.DecodeResult(hard=hard, done=done, iters=iters)
    from nbldpc_tpu_torch.kernels import cn_ems

    if merge == "bubble":
        fn = cn_ems.cn_update_bubble if impl == "kernel" else cn_ems.cn_update_bubble_plain
    else:
        fn = cn_ems.cn_update if impl == "kernel" else cn_ems.cn_update_plain
    cn = common.full_width(lambda U, _graph: fn(U, nm, offset))
    return common.decode_bl(graph, llr, cn, max_iters, early_term,
                            stats_each_iter=stats_each_iter, route=impl)
