"""Shared decoder loop: VN update, tentative decision, syndrome check.

    init V = prior -> [CN update -> VN update -> decision -> syndrome] x iters

The entry (the LLRs batch-last and normalized, and their decision) is
kernels/sim_step.py's prior_bl, and the routing around the CN update
(leave-one-out, normalization and the gather to the check slots; the
gather back and the posterior sum) is kernels/route.py: their CUDA kernels
with route="kernel", their plain versions with route="torch".

Batch-last layout (decode_bl, every decoder's default): messages [M,
dc_max, q, B] / [N, dv_max, q, B], priors [N, q, B], hard decisions [N,
B]. q-last layout (decode and vn_update, the decoders' batch_last=False):
messages [B, M, dc_max, q] / [B, N, dv_max, q], priors [B, N, q], plain
PyTorch on the input's device, no kernel. Messages are log-domain,
normalized so the max over q is 0. Once a frame is done its hard/done/iters
outputs are frozen. The routing keeps computing it (no dynamic shapes);
decode_bl hands its CN update the list of frames not yet done, which the
T-EMS check node computes alone and the others ignore.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import route as routing
from nbldpc_tpu_torch.kernels import sim_step
from nbldpc_tpu_torch.utils.trace import span

ROUTES = ("torch", "kernel")


class DecodeResult(NamedTuple):
    hard: torch.Tensor    # [B, N] int32 tentative symbol decisions
    done: torch.Tensor    # [B] bool: syndrome satisfied
    iters: torch.Tensor   # [B] int32: iterations run until convergence/budget


CnUpdateFn = Callable[[torch.Tensor, TannerGraph], torch.Tensor]
# decode_bl's CN update: (U, graph, active, out) -> Chat, where `active`
# lists the frames it must compute (None: all) and `out` is its previous
# output (None at first), whose other columns it may keep
CnUpdateBlFn = Callable[[torch.Tensor, TannerGraph, torch.Tensor | None,
                         torch.Tensor | None], torch.Tensor]


def full_width(cn_update: CnUpdateFn) -> CnUpdateBlFn:
    """A CN update of (U, graph) as decode_bl's: it computes every frame and
    ignores the list and the previous output."""
    return lambda U, graph, _active, _out: cn_update(U, graph)


def active_frames(done: torch.Tensor, n_active: int) -> torch.Tensor:
    """done [B] bool and its count of False -> the frames not done, int32
    [n_active] in ascending order, built on done's device with no host
    sync (the first n_active entries of a stable sort of done)."""
    return torch.argsort(done, stable=True)[:n_active].to(torch.int32)


def argmax_q(post: torch.Tensor) -> torch.Tensor:
    """[N, q, B] -> [N, B] int32 (ties go to the lowest symbol)."""
    return torch.argmax(post, dim=1).to(torch.int32)


def satisfied(graph: TannerGraph, hard: torch.Tensor) -> torch.Tensor:
    """hard [N, B] -> [B] bool: every check of the frame is satisfied."""
    return (graph.syndrome_bl(hard) == 0).all(dim=0)


def _decision(graph: TannerGraph, llr: torch.Tensor, C: torch.Tensor) -> tuple:
    """q-last: CN outputs C [B, M, dc, q] (x-domain) -> (Cv [B, N, dv, q],
    posterior [B, N, q] = llr + the slot sum, hard [B, N] int32)."""
    Cv = graph.gather_vn_x(C)
    posterior = llr + Cv.sum(dim=2)                             # pad slots are 0
    return Cv, posterior, torch.argmax(posterior, dim=-1).to(torch.int32)


def _leave_one_out(graph: TannerGraph, posterior: torch.Tensor,
                   Cv: torch.Tensor) -> torch.Tensor:
    """q-last: the var->check messages U [B, M, dc, q] (x-domain,
    normalized) of the posterior [B, N, q] less each slot's extrinsic."""
    Vv = posterior[:, :, None, :] - Cv
    return graph.gather_cn_x(Vv - Vv.amax(dim=-1, keepdim=True))


def vn_update(graph: TannerGraph, llr: torch.Tensor, C: torch.Tensor) -> tuple:
    """q-last variable-node phase: llr [B, N, q], C [B, M, dc, q] -> (U [B,
    M, dc, q] var->check messages in the x-domain, posterior [B, N, q],
    hard [B, N])."""
    Cv, posterior, hard = _decision(graph, llr, C)
    return _leave_one_out(graph, posterior, Cv), posterior, hard


def check_q_last_impl(cn_impl: str) -> None:
    """Raise ValueError unless cn_impl asks for what the q-last path runs,
    plain PyTorch ("auto" or "torch"): it has no kernel to launch."""
    if cn_impl not in ("auto", "torch"):
        raise ValueError(f"cn_impl={cn_impl!r}: the q-last path (batch_last=False) "
                         "runs plain PyTorch only")


def decode(
    graph: TannerGraph,
    llr: torch.Tensor,
    cn_update: CnUpdateFn,
    max_iters: int,
    early_term: bool = True,
) -> DecodeResult:
    """q-last decode of llr [B, N, q] with a q-last CN update ([B, M, dc, q]
    -> same), in plain PyTorch on llr's device.

    The state carries the VN-major extrinsics Cv and the posterior. Every
    iteration takes the decision and the syndrome, so `iters` counts the
    iterations each frame ran before it was done, whatever the mode.
    early_term=True stops once every frame is done (checked on the host
    each iteration)."""
    B = llr.shape[0]
    llr = llr - llr.amax(dim=-1, keepdim=True)
    Cv = llr.new_zeros((B, graph.n, graph.dv_max, graph.q))
    posterior = llr
    hard = torch.argmax(llr, dim=-1).to(torch.int32)
    done = (graph.syndrome(hard) == 0).all(dim=-1)
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
    for _ in range(max_iters):
        if early_term and bool(done.all()):
            break
        C = cn_update(_leave_one_out(graph, posterior, Cv), graph)
        Cv, posterior, hard_new = _decision(graph, llr, C)
        done_new = (graph.syndrome(hard_new) == 0).all(dim=-1)
        iters = iters + (~done).to(torch.int32)
        hard = torch.where(done[:, None], hard, hard_new)
        done = done | done_new
    return DecodeResult(hard=hard, done=done, iters=iters)


def decode_bl(
    graph: TannerGraph,
    llr: torch.Tensor,
    cn_update_bl: CnUpdateBlFn,
    max_iters: int,
    early_term: bool = True,
    stats_each_iter: bool = True,
    route: str = "torch",
) -> DecodeResult:
    """Batch-last decode of llr [B, N, q] (transposed once at entry/exit).

    The state carries the VN-major extrinsics and the posterior, so each
    iteration does one down-gather and one up-gather: route="kernel" runs
    them, and the entry (prior_bl), through the wrappers of kernels/route.py
    and kernels/sim_step.py (the CUDA kernels on a CUDA tensor),
    route="torch" through their plain versions.

    cn_update_bl is called as (U, graph, active, out), `out` its previous
    output (None at first). early_term=True stops once every frame is done:
    the host reads the count of frames not done each iteration, its one
    sync, and `active` lists those frames (int32, ascending; None where no
    frame is done, and always without early_term). A CN update may compute
    only the listed columns and keep the others of `out` (the T-EMS check
    node does): a done frame's messages are then its last ones, which only
    its frozen outputs could read. Each frame's messages depend on its own
    LLRs alone, so the result is bit for bit that of a full-width update.

    stats_each_iter=False (fixed-budget throughput mode,
    forced True when early_term is set) skips the per-iteration decision:
    `done` stays at its initial value during the loop, frames done at
    initialization report 0 iterations and the rest max_iters, and the
    decision is taken after the loop.

    Spans (utils/trace.py), as the JAX loop's scopes: `decode_bl.entry`,
    then each iteration `decode_bl.sync` (the host's read of the count of
    frames not done, with early_term), `decode_bl.route_down` (JAX's
    vn_update), `decode_bl.cn_update` (with the frame list),
    `decode_bl.route_up` (posterior) and
    `decode_bl.syndrome` (the decision, the syndrome and the merge of
    done). decode_bl.loop_iterations counts the iterations the loop ran,
    decode_bl.frame_iterations the decode's frames times those.
    """
    if route not in ROUTES:
        raise ValueError(f"route={route!r}; expected one of {ROUTES}")
    if route == "kernel":
        prior_bl, route_down, route_up = (sim_step.prior_bl, routing.route_down,
                                          routing.route_up)
    else:
        prior_bl, route_down, route_up = (sim_step.prior_bl_plain, routing.route_down_plain,
                                          routing.route_up_plain)
    B = llr.shape[0]
    stats_each_iter = bool(stats_each_iter) or early_term
    with span("decode_bl.entry"):
        llr, hard = prior_bl(llr.contiguous())                 # [N, q, B], [N, B]
        Cv = torch.zeros((graph.n, graph.dv_max, graph.q, B), dtype=llr.dtype,
                         device=llr.device)
        posterior = llr
        done = satisfied(graph, hard)
        iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
        Chat = active = None

    for _ in range(max_iters):
        if early_term:
            with span("decode_bl.sync"):
                n_active = B - int(done.sum())
            if n_active == 0:
                break
        decode_bl.loop_iterations += 1
        decode_bl.frame_iterations += B
        with span("decode_bl.route_down"):
            U = route_down(posterior, Cv, graph)               # [M, dc, q, B]
        with span("decode_bl.cn_update"):
            if early_term and n_active < B:
                active = active_frames(done, n_active)
            Chat = cn_update_bl(U, graph, active, Chat)
        with span("decode_bl.route_up"):
            Cv, posterior = route_up(Chat, llr, graph)         # [N, dv, q, B], [N, q, B]
        with span("decode_bl.syndrome"):
            iters = iters + (~done).to(torch.int32)
            if stats_each_iter:
                hard_new = argmax_q(posterior)
                done_new = satisfied(graph, hard_new)
                hard = torch.where(done[None, :], hard, hard_new)
                done = done | done_new

    if not stats_each_iter:
        with span("decode_bl.syndrome"):
            hard = argmax_q(posterior)
            done = satisfied(graph, hard)
    return DecodeResult(hard=hard.T.contiguous(), done=done, iters=iters)


decode_bl.loop_iterations = 0
decode_bl.frame_iterations = 0
