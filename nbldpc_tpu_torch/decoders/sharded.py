"""Edge-sharded decoding: one decode's code graph split over the ranks of a
process group (the counterpart of nbldpc_tpu/decoders/sharded.py).

For codes too long for one device, rank r of W owns the checks
[r M/W, (r+1) M/W) and the variables [r N/W, (r+1) N/W) as contiguous
blocks, and holds the check messages and the variable state (Cv, the
posterior) of its blocks only. The check-node and variable-node updates
are local; decode_bl's two routing gathers become two all_to_all_single
exchanges an iteration:
  down: each (variable, slot) row [q, B] of Vv goes to its check's owner;
  up:   each (check, slot) row [q, B] of Chat goes to its variable's owner;
and after each exchange the receiver gathers the rows into place through
the edge's GF permutation. The decisions are all-gathered for the
syndromes of each check block, and the frames' done flags all-reduced,
so the host's early-termination test reads the same flags on every rank.

The equations and their summation order are common.decode_bl's (with
per-iteration decisions), so hard, done and iters equal it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as tdist

from nbldpc_tpu_torch.decoders import common
from nbldpc_tpu_torch.graph import TannerGraph, syndrome


@dataclasses.dataclass
class Route:
    """One exchange of rows [q, B] between the ranks: rank r sends rows
    `send` of its local rows, `send_split[d]` of them to rank d, receives
    `recv_split[s]` rows from rank s, and gathers the flat received rows
    by `gather` (int64 [rows_out * q], clipped; pad rows are masked)."""

    send: torch.Tensor
    send_split: list
    recv_split: list
    gather: torch.Tensor


def _route(rank, world, src_own, dst_own, key, src_row, dst_row, perm, q, device) -> Route:
    """The exchange of edge rows from the owner src_own[e] (its local row
    src_row[e]) to dst_own[e] (local row dst_row[e]), both sides in the
    order of `key` within a pair of ranks; perm [rows_out, q]: the symbol
    of the received row that each output symbol reads."""
    out = np.flatnonzero(src_own == rank)
    out = out[np.lexsort((key[out], dst_own[out]))]
    inc = np.flatnonzero(dst_own == rank)
    inc = inc[np.lexsort((key[inc], src_own[inc]))]
    pos = np.full(perm.shape[0], len(inc), dtype=np.int64)      # pads: past the end
    pos[dst_row[inc]] = np.arange(len(inc))
    gather = np.minimum(pos[:, None] * q + perm, len(inc) * q - 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    return Route(send=t(src_row[out]),
                 send_split=np.bincount(dst_own[out], minlength=world).tolist(),
                 recv_split=np.bincount(src_own[inc], minlength=world).tolist(),
                 gather=t(gather.reshape(-1)))


@dataclasses.dataclass
class ShardPlan:
    """A rank's blocks of the code graph and its two exchanges."""

    n0: int            # first variable of the block
    n1: int
    down: Route        # Vv rows (v, s) -> U rows (m, j), x-domain by perm_down
    up: Route          # Chat rows (m, j) -> Cv rows (v, s), c-domain by perm_up
    cn_mask: torch.Tensor   # [M_r, dc]
    vn_mask: torch.Tensor   # [N_r, dv]
    cn_vn: torch.Tensor     # int64 [M_r dc]: the block's variables (global ids)
    syn_k: torch.Tensor     # [M_r, dc, p]


def shard_plan(graph: TannerGraph, world: int, rank: int) -> ShardPlan:
    """Split tables of the edge-sharded decode for `rank` of `world`, built
    once on the host from the graph's tables."""
    t = graph.np
    M, N, dc, dv, q = graph.m, graph.n, graph.dc_max, graph.dv_max, graph.q
    if M % world or N % world:
        raise ValueError(f"M={M} checks and N={N} variables must divide by {world} ranks")
    Mr, Nr = M // world, N // world
    m0, n0 = rank * Mr, rank * Nr
    em, ej = np.nonzero(t["cn_mask"])                   # real edges, CN-major
    edge = em * dc + ej                                 # CN-major edge id
    slot = t["cn_slot_of_vn_slot"][em, ej].astype(np.int64)   # v * dv + s
    c_own, v_own = em // Mr, slot // dv // Nr
    cn_rows = slice(m0, m0 + Mr)
    vn_edge = t["vn_edge"][n0 : n0 + Nr].reshape(-1).astype(np.int64)
    perm_up = t["perm_up"].reshape(M * dc, q)[np.minimum(vn_edge, M * dc - 1)]
    dev = graph.device
    return ShardPlan(
        n0=n0, n1=n0 + Nr,
        down=_route(rank, world, v_own, c_own, edge, slot - n0 * dv, edge - m0 * dc,
                    t["perm_down"][cn_rows].reshape(Mr * dc, q), q, dev),
        up=_route(rank, world, c_own, v_own, slot, edge - m0 * dc, slot - n0 * dv,
                  perm_up, q, dev),
        cn_mask=graph.cn_mask[cn_rows], vn_mask=graph.vn_mask[n0 : n0 + Nr],
        cn_vn=graph.cn_vn[cn_rows].reshape(-1).long(), syn_k=graph.syn_k[cn_rows])


def _exchange(rows: torch.Tensor, route: Route, group) -> torch.Tensor:
    """rows [R, q, B] -> the received rows gathered flat: [rows_out * q, B]."""
    send = rows.index_select(0, route.send)
    recv = send.new_empty((sum(route.recv_split), *send.shape[1:]))
    tdist.all_to_all_single(recv, send, route.recv_split, route.send_split, group=group)
    return recv.reshape(-1, rows.shape[-1]).index_select(0, route.gather)


def decode_edge_sharded(
    graph: TannerGraph,
    llr: torch.Tensor,
    cn_update_bl: common.CnUpdateFn,
    max_iters: int,
    early_term: bool = True,
    group=None,
) -> common.DecodeResult:
    """llr [B, N, q] (the same on every rank) -> DecodeResult (the same on
    every rank), the code graph split over the ranks of `group` (None: the
    default group). Every rank of the group calls it."""
    world, rank = tdist.get_world_size(group), tdist.get_rank(group)
    plan = shard_plan(graph, world, rank)
    B, q = llr.shape[0], graph.q
    Mr, Nr = plan.cn_mask.shape[0], plan.n1 - plan.n0
    pad = graph._pad_block.to(llr.dtype)

    def decided(hard_r: torch.Tensor) -> torch.Tensor:
        """This block's decisions [N_r, B] -> every variable's [N, B]."""
        parts = [torch.empty_like(hard_r) for _ in range(world)]
        tdist.all_gather(parts, hard_r.contiguous(), group=group)
        return torch.cat(parts)

    def satisfied(hard_r: torch.Tensor) -> torch.Tensor:
        """[B] bool: every check of the frame satisfied, on every rank."""
        bad = (syndrome(decided(hard_r), plan.cn_vn, plan.syn_k) != 0).sum(
            dim=0, dtype=torch.int32)
        tdist.all_reduce(bad, group=group)
        return bad == 0

    llr_t = llr.permute(1, 2, 0)[plan.n0 : plan.n1]               # [N_r, q, B]
    llr_t = llr_t - llr_t.amax(dim=1, keepdim=True)
    Cv = torch.zeros((Nr, graph.dv_max, q, B), dtype=llr_t.dtype, device=llr.device)
    posterior = llr_t
    hard = common.argmax_q(llr_t)
    done = satisfied(hard)
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)

    for _ in range(max_iters):
        if early_term and bool(done.all()):
            break
        Vv = posterior[:, None] - Cv                              # leave-one-out
        Vv = Vv - Vv.amax(dim=2, keepdim=True)                    # normalize (q)
        U = _exchange(Vv.reshape(Nr * graph.dv_max, q, B), plan.down, group)
        U = torch.where(plan.cn_mask[:, :, None, None],
                        U.reshape(Mr, graph.dc_max, q, B), pad)   # pads: log-delta0
        Chat = cn_update_bl(U, graph)
        Cv = _exchange(Chat.reshape(Mr * graph.dc_max, q, B), plan.up, group)
        Cv = torch.where(plan.vn_mask[:, :, None, None],
                         Cv.reshape(Nr, graph.dv_max, q, B), 0.0)
        posterior = llr_t + Cv.sum(dim=1)
        hard_new = common.argmax_q(posterior)
        done_new = satisfied(hard_new)
        iters = iters + (~done).to(torch.int32)
        hard = torch.where(done[None, :], hard, hard_new)
        done = done | done_new

    return common.DecodeResult(hard=decided(hard).T.contiguous(), done=done, iters=iters)
