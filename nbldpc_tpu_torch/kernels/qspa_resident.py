"""Whole-decode resident QSPA (q <= 256): CUDA kernels + plain version.

Probability-domain BP, the same decode as the JAX package's resident
kernels: the state (prior, posterior, edge messages) is never
renormalized, the check-node softmax takes no max-subtraction, the
leave-one-out product of spectra is a direct prefix x suffix product, and
the extrinsic is floored at 1e-12 before the log. The invariants that make
this safe: every edge message lies in [log(1e-12), 0], so the largest
permuted variable message of a real slot is >= -27.6 (dv - 1) and its
exp cannot underflow to an all-zero row.

It differs from the log-domain decode_bl path in rare floating-point ties,
so each is held against its own counterpart.

`resident_decode` runs `decode_plain` for a CPU tensor; for a CUDA tensor
it launches csrc/qspa_resident.cu (K0, a few frames' state in one block's
shared memory, laid out by `k0_smem_layout`) for q <= 32 and K0-cl for
32 < q <= 256: csrc/qspa_cluster.cu
(a frame's state in the shared memory of a thread-block cluster, as
`plan_cluster` lays it out) when the code's state fits a cluster of 8,
else csrc/qspa_resident_cl.cu (a frame a cluster too, as `plan_scratch`
lays it out, its edge messages in a global slice a cluster). All take
llr [B, N, q] and return (hard [B, N] int32, done [B] bool, iters [B]
int32).

mm_precision="bf16" (the JAX package's mm_dtype=bfloat16) stores the
log-domain state in bf16: the prior, the posterior, the edge messages and
the variable-to-check values, each rounded to nearest even from f32 where
the JAX kernels cast it (see `ResidentQSPA._round`); the probability-domain
stretch (softmax, WHT, leave-one-out products, inverse WHT, log) and every
sum stay f32. The bf16 kernels are the same sources built with a 2-byte
state element: their own C entry points (`*_bf16`), layouts and launch
counters (`launches_bf16` on each wrapper).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from nbldpc_tpu_torch.decoders.common import argmax_q, satisfied
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels.wht import wht_axis
from nbldpc_tpu_torch.utils.trace import span

PROB_FLOOR = 1e-12
# per-block shared memory a kernel may ask for on sm_90
MAX_SMEM_BYTES = 232448
# the largest field K0 takes; above it K0-cl, up to MAX_Q
K0_MAX_Q = 32
MAX_Q = 256
# most frames one block of K0 holds (kMaxFrames in csrc/qspa_resident.cu)
K0_MAX_FRAMES = 4
# K0-cl's cluster kernel: blocks per cluster, warps per block by q (csrc/
# qspa_cluster.cu, max_warps), the largest check degree (a syndrome lane
# per edge)
CLUSTER_SIZES = (1, 2, 4, 8)
CLUSTER_WARPS = {64: 24, 128: 24, 256: 16}
CLUSTER_MAX_DC = 32
# bytes of one element of the stored state by mm_precision
PRECISIONS = {"f32": 4, "bf16": 2}


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def k0_smem_layout(n: int, m: int, dc: int, dv: int, q: int, es: int = 4) -> tuple:
    """(frames per block, shared bytes per block) of K0's launch for a large
    batch with state elements of `es` bytes (4: f32, 2: bf16), which
    csrc/qspa_resident.cu computes the same in `layout` and `block_bytes`:
    the routing tables as bytes and 16-bit words (each check's perm_down
    rows padded to an odd number of its load units of min(q, 16) bytes, at
    least 4; edge variables [E]; the variables' lc offsets [N dv]; syn_k [E
    p]), then per frame prior and posterior [N, q], each check's dc lc rows
    padded so that consecutive checks start 16 (mod 32) bytes apart (f32
    at q = 2: 8 (mod 16)), and the hard decisions as bytes, each part a
    multiple of 16 bytes. Checks of degree 4 at q <= 16 (two threads a
    check) take one frame a block; other codes as many frames as fit in
    MAX_SMEM_BYTES, up to K0_MAX_FRAMES (one frame when none fits: the
    wrapper then refuses the code), and a batch of B < 2 x K0_MAX_FRAMES x
    SMs frames gets max(1, B // (2 SMs)) frames a block."""
    E, p = m * dc, q.bit_length() - 1
    vec, al = (min(q, 4), 4) if es == 4 else (8, 8)
    unit = min(max(q, 4), 16)
    ps = _round_up(dc * q, unit)
    ps += 0 if (ps // unit) % 2 else unit
    cs = dc * q + (vec - dc * q % (2 * vec)) % (2 * vec)
    frame = 2 * _round_up(n * q, al) + m * cs + _round_up(-(-n // es), al)
    tables = _round_up(m * ps + 2 * E + 2 * n * dv + E * p, 16)
    frames = 1 if q <= 16 and dc == 4 else K0_MAX_FRAMES
    while frames > 1 and tables + es * frames * frame > MAX_SMEM_BYTES:
        frames -= 1
    return frames, tables + es * frames * frame


@functools.lru_cache(maxsize=None)
def compiled_field(q: int) -> tuple:
    """The exp-order basis of GF(q) (0, 1, a, a^2, ...) that K0 was compiled
    with (csrc/qspa_resident.cu, qspa_resident_field)."""
    from nbldpc_tpu_torch.kernels import _build

    out = (ctypes.c_int * q)()
    _build.check(_build.library().qspa_resident_field(q, out), "qspa_resident_field")
    return tuple(out)


def k0_plan(dec: ResidentQSPA, B: int, device) -> dict:
    """K0's launch for B frames at dec's precision, as the kernel computes
    it on `device`: frames and threads a block, blocks an SM, grid, shared
    bytes a block."""
    from nbldpc_tpu_torch.kernels import _build

    g = dec.graph
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        _build.check(_build.library().qspa_resident_plan(
            B, g.n, g.m, g.dc_max, g.dv_max, g.q, int(dec.es == 2), out), "qspa_resident_plan")
    return dict(zip(("frames_per_block", "threads", "blocks_per_sm", "grid", "smem_bytes"),
                    out))


def log_mismatches(device) -> int:
    """How many of the 2,130,706,432 positive normal finite floats x give a
    K0 log (csrc/qspa_resident.cu, log_normal) other than CUDA's logf(x),
    bit for bit: 0 when K0's extrinsic log is exact."""
    from nbldpc_tpu_torch.kernels import _build

    out = torch.empty(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        _build.check(_build.library().qspa_resident_log_mismatches(
            out.data_ptr(), _build.stream_ptr(device)), "qspa_resident_log_mismatches")
    return int(out.item())


def cluster_smem_bytes(q: int, dc: int, dv: int, rows: int, checks: int,
                       round_checks: int, es: int = 4, in_place: bool = False) -> int:
    """Shared memory of one block of the cluster kernel (csrc/qspa_cluster.cu,
    dyn_bytes), plus its static n2e [q], log [q] and exp [2q] int tables.
    Buffered (f32 or bf16): prior and posterior rows and the checks'
    message rows (elements of `es` bytes), a round's edge rows of q + 4
    floats and their sums, hard decisions, two flags and the rank's tables.
    In place (f32): posterior rows, the checks' message rows of q + 4
    floats (the check phase's buffer) and their sums, hard decisions, two
    flags and the tables; the prior waits in global memory."""
    ints = rows + checks * dc + rows * dv + rows + 2
    if in_place:
        return 4 * (rows * q + checks * dc * (q + 5) + ints) + 16 * q
    return (es * (2 * rows * q + checks * dc * q)
            + 4 * (round_checks * dc * (q + 5) + ints) + 16 * q)


@dataclasses.dataclass(frozen=True, eq=False)
class ClusterPlan:
    """How the cluster kernel spreads one frame over `size` blocks (ranks):
    rank r owns the checks [r * checks, (r + 1) * checks) with their message
    rows, and the variables v with vn_rank[v] == r, at posterior row
    vn_row[v]; each block runs `warps` warps in `smem_bytes` of shared
    memory. Its layout: buffered (the check phase runs `round_checks`
    checks at a time through a buffer) or `in_place` (the message rows are
    the buffer, every check at once; the priors in a global scratch)."""
    size: int
    warps: int
    checks: int             # checks per rank
    rows: int               # posterior rows per rank (the fullest rank's)
    round_checks: int
    vn_rank: np.ndarray     # [N]
    vn_row: np.ndarray      # [N]
    smem_bytes: int
    in_place: bool


def _place_variables(vn_edge: np.ndarray, E: int, dc: int, size: int, checks: int):
    """Each variable on the rank of one of its checks, the least loaded of
    them (first in slot order on a tie) while it has fewer than
    ceil(N / size) variables, else on the least loaded rank."""
    n = vn_edge.shape[0]
    cap = math.ceil(n / size)
    count = np.zeros(size, dtype=np.int64)
    rank = np.empty(n, dtype=np.int32)
    row = np.empty(n, dtype=np.int32)
    for v in range(n):
        cands = [int(e) // dc // checks for e in vn_edge[v] if e < E]
        open_ = [r for r in cands if count[r] < cap]
        r = min(open_, key=lambda r: count[r]) if open_ else int(np.argmin(count))
        rank[v], row[v] = r, count[r]
        count[r] += 1
    return rank, row, int(count.max())


def cluster_plan_at(graph: TannerGraph, size: int, es: int = 4,
                    in_place: bool = False) -> ClusterPlan | None:
    """The cluster kernel's partition of a frame over a cluster of `size`
    blocks, state elements of `es` bytes: buffered, its check rounds
    through the buffer as few as fit; or `in_place` (f32). None where it
    does not fit a block's shared memory."""
    g = graph
    q, m, dc, dv = g.q, g.m, g.dc_max, g.dv_max
    checks = math.ceil(m / size)
    rank, row, rows = _place_variables(g.np["vn_edge"], m * dc, dc, size, checks)
    if max(rows, checks * dc) > 0xFFFF:
        return None
    for rounds in ((1,) if in_place else range(1, checks + 1)):
        round_checks = math.ceil(checks / rounds)
        smem = cluster_smem_bytes(q, dc, dv, rows, checks, round_checks, es, in_place)
        if smem <= MAX_SMEM_BYTES:
            return ClusterPlan(size, CLUSTER_WARPS[q], checks, rows, round_checks, rank, row,
                               smem, in_place)
    return None


def plan_cluster(graph: TannerGraph, es: int = 4) -> ClusterPlan | None:
    """The cluster kernel's partition for 32 < q <= 256, state elements of
    `es` bytes: buffered, the smallest cluster that holds a frame; in f32,
    in place where that holds a frame on fewer blocks (more frames on the
    card at once). None when nothing fits (or dc exceeds the kernel's
    limit): K0-cl then runs the scratch kernel."""
    g = graph
    if not K0_MAX_Q < g.q <= MAX_Q or g.dc_max > CLUSTER_MAX_DC:
        return None
    plans = [p for size in CLUSTER_SIZES for in_place in (False, True)[:1 + (es == 4)]
             if (p := cluster_plan_at(g, size, es, in_place)) is not None]
    return plans[0] if plans else None


def scratch_smem_bytes(q: int, dc: int, dv: int, rows: int, checks: int,
                       round_checks: int, post_shared: bool, es: int = 4) -> int:
    """Shared memory of one block of K0-cl's scratch kernel: the posterior
    rows (when they stay on chip; elements of `es` bytes), the round
    buffer (a round's edge rows of q + 4 floats, at least two a warp: the
    variable phase stages its LLR rows there) and the round's sums, max_q
    llr and the hard decision of each row, two flags and the rank's tables
    (csrc/qspa_resident_cl.cu, dyn_bytes), plus its static n2e [q], log [q]
    and exp [2q] int tables."""
    buf_rows = max(round_checks * dc, 2 * CLUSTER_WARPS[q])
    return (es * (rows * q if post_shared else 0)
            + 4 * (buf_rows * (q + 4) + round_checks * dc + 2 * rows + 2 + checks * dc
                   + rows * dv + rows) + 16 * q)


@dataclasses.dataclass(frozen=True, eq=False)
class ScratchPlan(ClusterPlan):
    """The scratch kernel's partition of a frame over a cluster (the fields
    of ClusterPlan), whether the posterior rows stay in shared memory
    (`post_shared`), and the state elements (f32 or bf16) of one cluster's
    slice of the global scratch: the edge messages [size * checks * dc,
    q], then, unless post_shared, the posterior [size * rows, q]."""
    post_shared: bool
    slice_elems: int


def plan_scratch(graph: TannerGraph, es: int = 4) -> ScratchPlan | None:
    """The scratch kernel's partition for 32 < q <= 256 and dc <= 32, state
    elements of `es` bytes: of
    the clusters in CLUSTER_SIZES whose ranks hold their share of the
    posterior in shared memory, the one whose ranks run their checks in
    the fewest rounds (every round costs five block barriers and a serial
    sum), the smaller on a tie; where none holds it, clusters of 8 with the
    posterior in the slice. Its check rounds as few as fit. None when
    nothing fits (or q or dc is out of range)."""
    g = graph
    q, m, dc, dv = g.q, g.m, g.dc_max, g.dv_max
    if not K0_MAX_Q < q <= MAX_Q or dc > CLUSTER_MAX_DC:
        return None
    E = m * dc
    for shared, sizes in ((True, CLUSTER_SIZES), (False, CLUSTER_SIZES[-1:])):
        best = None
        for size in sizes:
            checks = math.ceil(m / size)
            rank, row, rows = _place_variables(g.np["vn_edge"], E, dc, size, checks)
            most = 0
            while most < checks and scratch_smem_bytes(q, dc, dv, rows, checks, most + 1,
                                                       shared, es) <= MAX_SMEM_BYTES:
                most += 1
            if most < 1 or rows > 0xFFFF or checks * dc > 0xFFFF:
                continue
            rounds = math.ceil(checks / most)
            if best is None or rounds < best[0]:
                round_checks = math.ceil(checks / rounds)
                best = (rounds, ScratchPlan(
                    size, CLUSTER_WARPS[q], checks, rows, round_checks, rank, row,
                    scratch_smem_bytes(q, dc, dv, rows, checks, round_checks, shared, es),
                    False, shared, size * (checks * dc + (0 if shared else rows)) * q))
        if best is not None:
            return best[1]
    return None


def cluster_tables(graph: TannerGraph, plan: ClusterPlan) -> dict:
    """The int32 tables of the cluster kernel, by rank (each rank copies its
    slice into shared memory): edge_info [size, checks * dc] = shift << 20 |
    rank << 16 | posterior row of the variable of each of the rank's edge
    slots, -1 on pads (`cn_shift`: h^-1 x = exp[log x + shift]); row_src
    [size, rows, dv] = rank << 16 | message row of
    each slot of the variable at each posterior row, -1 on pads and unused
    rows; row_var [size, rows] the variable at each row, -1 if unused."""
    g = graph
    dc, E = g.dc_max, g.m * g.dc_max
    size, checks, rows = plan.size, plan.checks, plan.rows
    vn_rank, vn_row = plan.vn_rank.astype(np.int64), plan.vn_row.astype(np.int64)
    vn_loc = (vn_rank << 16) | vn_row
    at = vn_rank * rows + vn_row
    row_var = np.full(size * rows, -1, dtype=np.int64)
    row_var[at] = np.arange(g.n)
    # rank r's slots are those of checks [r checks, (r + 1) checks); past M, pads
    e = np.minimum(np.arange(size * checks * dc), E - 1)
    real = (np.arange(size * checks * dc) < E) & g.np["cn_mask"].reshape(-1)[e]
    info = (cn_shift(g)[e] << 20) | vn_loc[g.np["cn_vn"].reshape(-1)[e]]
    ve = g.np["vn_edge"].astype(np.int64)
    r = ve // dc // checks
    row_src = np.full((size * rows, g.dv_max), -1, dtype=np.int64)
    row_src[at] = np.where(ve < E, (r << 16) | (ve - r * checks * dc), -1)
    return {"edge_info": np.where(real, info, -1), "row_src": row_src.reshape(-1),
            "row_var": row_var}


def cn_shift(graph: TannerGraph) -> np.ndarray:
    """[M * dc] (q - 1 - log h) mod (q - 1) of each edge slot's weight h
    (1 on pads)."""
    q = graph.q
    return ((q - 1 - graph.gf.log[graph.np["cn_w"].astype(np.int64)]) % (q - 1)).reshape(-1)


class ResidentQSPA:
    """Tables and options of one resident decode configuration;
    mm_precision "f32" or "bf16", the element of the stored state."""

    def __init__(self, graph: TannerGraph, max_iters: int, early_term: bool = True,
                 stats_each_iter: bool = True, mm_precision: str = "f32"):
        if graph.q > MAX_Q:
            raise ValueError(f"the resident decoder supports q <= {MAX_Q}")
        if mm_precision not in PRECISIONS:
            raise ValueError(f"mm_precision={mm_precision!r}; expected one of "
                             f"{tuple(PRECISIONS)}")
        self.mm_precision = mm_precision
        self.es = es = PRECISIONS[mm_precision]
        self.graph = graph
        self.max_iters = int(max_iters)
        self.early_term = bool(early_term)
        # throughput mode (False) only exists for a fixed budget
        self.stats_each_iter = bool(stats_each_iter) or self.early_term
        g, dev = graph, graph.device
        q, m, dc = g.q, g.m, g.dc_max
        E = m * dc
        # K0's block (K0-cl's layout is the kernel's own)
        self.frames_per_block, self.smem_bytes = (
            k0_smem_layout(g.n, m, dc, g.dv_max, q, es) if q <= K0_MAX_Q else (0, 0))

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

        host = g.np
        gf = g.gf
        # exp-order basis: 0, alpha^0, alpha^1, ..., alpha^(q-2)
        n2e = np.concatenate([[0], gf.exp[: q - 1]])
        self.cn_vn = t(host["cn_vn"].reshape(-1))
        self.cn_real = t(host["cn_mask"].reshape(-1))
        self.perm_down = t(host["perm_down"].reshape(-1))
        self.vn_edge = t(host["vn_edge"].reshape(-1))
        self.syn_k = t(host["syn_k"].reshape(-1))
        self.n2e = t(n2e)
        self.n2e_list = [int(x) for x in n2e]

        # plain-version gather indices over flat [rows * q, B] views
        pd = host["perm_down"].reshape(E, q).astype(np.int64)
        pu = host["perm_up"].reshape(E, q).astype(np.int64)
        e_q = np.arange(E, dtype=np.int64)[:, None] * q
        self._idx_post = torch.from_numpy(
            (host["cn_vn"].reshape(E, 1).astype(np.int64) * q + pd).reshape(-1)).to(dev)
        self._idx_lc = torch.from_numpy((e_q + pd).reshape(-1)).to(dev)
        self._idx_up = torch.from_numpy((e_q + pu).reshape(-1)).to(dev)
        self._vn_edge = torch.from_numpy(
            np.minimum(host["vn_edge"], E - 1).astype(np.int64)).to(dev)
        self._real = torch.from_numpy(host["cn_mask"].reshape(E)).to(dev)

        # K0-cl's cluster kernel: its partition (None: the scratch kernel,
        # whose partition and tables `scratch_layout` makes when first asked)
        self._set_cluster_plan(plan_cluster(g, es) if q > K0_MAX_Q else None)

    def _set_cluster_plan(self, plan: ClusterPlan | None) -> None:
        """Run K0-cl's cluster kernel under `plan` and its tables: plan_cluster's
        at construction; in tests and kernel timings, another partition of
        the code (cluster_plan_at), which decodes every frame the same."""
        self.cluster_plan = plan
        self.__dict__.pop("cluster", None)
        self.__dict__.pop("_prior", None)
        if plan is not None:
            g = self.graph
            host = dict(cluster_tables(g, plan), gf_log=g.gf.log, gf_exp=g.gf.exp)
            self.cluster = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32))
                            .to(g.device) for k, v in host.items()}

    # ---- plain version ----------------------------------------------------

    def _round(self, x):
        """x as the stored state holds it: itself in f32; in bf16 rounded to
        nearest even, kept in an f32 tensor (the arithmetic stays f32)."""
        return x.to(torch.bfloat16).to(torch.float32) if self.es == 2 else x

    def _down(self, post, lc):
        """x-domain edge inputs [E, q, B]: post[v](h^-1 x) - lc[e](h^-1 x),
        rounded to the state's element."""
        B = post.shape[-1]
        return self._round(post.reshape(-1, B).index_select(0, self._idx_post)
                           - lc.reshape(-1, B).index_select(0, self._idx_lc)
                           ).view(-1, self.graph.q, B)

    def _up(self, prior, lcx):
        """x-domain edge outputs [E * q, B] -> (post, c-domain lc), each
        rounded to the state's element: post sums each variable's messages
        in vn_edge slot order (in f32), then adds the prior."""
        g = self.graph
        lc = self._round(lcx).index_select(0, self._idx_up).view(g.m * g.dc_max, g.q, -1)
        acc = None
        for s in range(g.dv_max):
            vals = lc.index_select(0, self._vn_edge[:, s])
            if g.has_vn_pads:
                vals = torch.where(g.vn_mask[:, s, None, None], vals, 0.0)
            acc = vals if acc is None else acc + vals
        return self._round(prior + self._round(acc)), lc

    def _iteration(self, prior, post, lc):
        """One BP iteration on [rows, q, B] tensors; returns (post, lc)."""
        g = self.graph
        q, m, dc = g.q, g.m, g.dc_max
        B = prior.shape[-1]
        Ex = torch.exp(self._down(post, lc))
        S = Ex[:, self.n2e_list[0]]
        for k in self.n2e_list[1:]:
            S = S + Ex[:, k]
        P = Ex / S[:, None]
        if g.has_cn_pads:
            delta0 = torch.zeros(q, 1, dtype=P.dtype, device=P.device)
            delta0[0] = 1.0
            P = torch.where(self._real[:, None, None], P, delta0)
        F = wht_axis(P, axis=1).view(m, dc, q, B)
        outs = []
        runp = None
        for j in range(dc):
            sj = None
            for k in range(dc - 1, j, -1):
                sj = F[:, k] if sj is None else sj * F[:, k]
            if runp is None:
                G = sj if sj is not None else torch.ones_like(F[:, j])
            else:
                G = runp if sj is None else runp * sj
            runp = F[:, j] if runp is None else runp * F[:, j]
            W = wht_axis(G, axis=1)
            outs.append(torch.log(torch.clamp_min(W * (1.0 / q), PROB_FLOOR)))
        return self._up(prior, torch.stack(outs, dim=1).reshape(-1, B))


def run_plain(dec, llr: torch.Tensor):
    """The resident decode loop in plain PyTorch around dec._iteration:
    llr [B, N, q] -> (hard, done, iters)."""
    g = dec.graph
    B = llr.shape[0]
    prior = llr.permute(1, 2, 0).to(torch.float32)
    prior = dec._round(prior - prior.amax(dim=1, keepdim=True))
    post = prior
    lc = torch.zeros(g.m * g.dc_max, g.q, B, dtype=torch.float32, device=llr.device)
    hard = argmax_q(post)
    done0 = satisfied(g, hard)
    done = done0
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
    for _ in range(dec.max_iters):
        if dec.stats_each_iter and bool(done.all()):
            break                       # every output is final
        post, lc = dec._iteration(prior, post, lc)
        if not dec.stats_each_iter:
            iters = iters + (~done0).to(torch.int32)
            continue
        hard_new = argmax_q(post)
        done_new = satisfied(g, hard_new)
        hard = torch.where(done[None, :], hard, hard_new)
        iters = iters + (~done).to(torch.int32)
        done = done | done_new
    if not dec.stats_each_iter:
        hard = argmax_q(post)
        done = satisfied(g, hard)
    return hard.T.contiguous(), done, iters


def decode_plain(dec: ResidentQSPA, llr: torch.Tensor):
    """Plain PyTorch resident decode: llr [B, N, q] -> (hard, done, iters)."""
    decode_plain.calls += 1
    return run_plain(dec, llr)


decode_plain.calls = 0


def checked_outputs(dec, llr: torch.Tensor, name: str, smem_bytes: int = 0):
    """Check llr for a resident kernel that needs `smem_bytes` of shared
    memory per block; allocate its (hard, done, iters)."""
    g = dec.graph
    if llr.device != dec.cn_vn.device:
        raise ValueError(f"llr on {llr.device}, graph tables on {dec.cn_vn.device}")
    if (llr.dtype != torch.float32 or llr.ndim != 3 or not llr.is_contiguous()
            or llr.shape[1:] != (g.n, g.q)):
        raise ValueError(
            f"{name}: llr must be a contiguous [B, {g.n}, {g.q}] float32 tensor")
    if smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: a block needs {smem_bytes} B of "
                         f"shared memory, more than {MAX_SMEM_BYTES}")
    B = llr.shape[0]
    return (torch.empty((B, g.n), dtype=torch.int32, device=llr.device),
            torch.empty(B, dtype=torch.bool, device=llr.device),
            torch.empty(B, dtype=torch.int32, device=llr.device))


def _entry(dec: ResidentQSPA, name: str) -> tuple:
    """(C entry point, launch counter) of kernel `name` at dec's precision:
    the f32 build counts on `launches`, the bf16 build on `launches_bf16`."""
    return (name, "launches") if dec.es == 4 else (f"{name}_bf16", "launches_bf16")


def resident_decode(dec: ResidentQSPA, llr: torch.Tensor):
    """Resident decode of llr [B, N, q] f32: the plain version for a CPU
    tensor; for a CUDA tensor K0 (q <= 32) or K0-cl (32 < q <= 256), each
    built for dec's precision."""
    if llr.device.type == "cpu":
        return decode_plain(dec, llr)
    if dec.graph.q > K0_MAX_Q:
        return resident_decode_cl(dec, llr)
    return _launch(dec, llr)


def _launch(dec: ResidentQSPA, llr: torch.Tensor):
    """Check llr and launch K0, counting the launch on resident_decode
    (launches, or launches_bf16 in bf16); raises ValueError on anything it does not take: a code whose block
    needs more than MAX_SMEM_BYTES of shared memory (before any device
    check), a tensor off the card, a bad shape or dtype, or a field whose
    exp table differs from the one K0 was compiled with."""
    g = dec.graph
    hard, done, iters = checked_outputs(dec, llr, "resident_decode", dec.smem_bytes)
    if llr.device.type != "cuda":
        raise ValueError(f"resident_decode: unsupported device {llr.device}")
    if llr.shape[0] == 0:
        return hard, done, iters
    if compiled_field(g.q) != tuple(dec.n2e_list):
        raise ValueError(f"resident_decode: K0's GF({g.q}) exp table "
                         f"{compiled_field(g.q)} is not the graph's {dec.n2e_list}")
    from nbldpc_tpu_torch.kernels import _build

    # the persistent grid's frame counter (zeroed by the launch)
    scratch = torch.empty(1, dtype=torch.int32, device=llr.device)
    name, counter = _entry(dec, "qspa_resident_decode")
    _build.launch(resident_decode, name, llr.device,
                  llr.data_ptr(), hard.data_ptr(), done.data_ptr(), iters.data_ptr(),
                  scratch.data_ptr(), llr.shape[0], g.n, g.m, g.dc_max, g.dv_max, g.q,
                  dec.cn_vn.data_ptr(), dec.cn_real.data_ptr(), dec.perm_down.data_ptr(),
                  dec.vn_edge.data_ptr(), dec.syn_k.data_ptr(),
                  dec.max_iters, int(dec.early_term), int(dec.stats_each_iter),
                  counter=counter)
    return hard, done, iters


resident_decode.launches = 0
resident_decode.launches_bf16 = 0


def _plan_cluster_args(plan: ClusterPlan) -> tuple:
    """The cluster plan as the C entry points take it."""
    return (plan.size, plan.rows, plan.checks, plan.round_checks, plan.warps,
            int(plan.in_place), plan.smem_bytes)


def _prior_scratch(dec: ResidentQSPA, device) -> tuple:
    """(scratch, clusters): in place, the global scratch of the cluster
    kernel's priors on `device`, a slice of size x rows x q floats for each
    of the clusters that run at once (cluster_occupancy), made once per
    decoder and device (its launches share it, in stream order); buffered,
    (None, 0)."""
    plan = dec.cluster_plan
    if not plan.in_place:
        return None, 0
    made = dec.__dict__.setdefault("_prior", {})
    if device not in made:
        clusters = cluster_occupancy(dec, device)
        made[device] = (torch.empty(clusters * plan.size * plan.rows * dec.graph.q,
                                    dtype=torch.float32, device=device), clusters)
    return made[device]


def resident_decode_cl(dec: ResidentQSPA, llr: torch.Tensor):
    """K0-cl on a CUDA tensor llr [B, N, q] f32, q in {64, 128, 256}: the
    cluster kernel (csrc/qspa_cluster.cu, a persistent grid of clusters, a
    frame a cluster, each frame's state in its blocks' shared memory, laid
    out by `dec.cluster_plan`; in place the priors in `_prior_scratch`); a
    code whose state no cluster holds goes to
    `resident_decode_cl_scratch`. Each launch adds the blocks of the grid
    the library launched (min(B, occupancy) clusters of `plan.size`) to
    `grid_blocks` and its clusters, the frames it holds at once, to
    `frame_slots`; the library call is the span `qspa_cluster.launch`.
    Raises ValueError on a tensor it does not take, a CPU tensor included;
    the kernel's own check of the plan raises RuntimeError."""
    plan = dec.cluster_plan
    if plan is None:
        return resident_decode_cl_scratch(dec, llr)
    g = dec.graph
    name, counter = _entry(dec, "qspa_cluster_decode")
    if llr.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {llr.device}")
    hard, done, iters = checked_outputs(dec, llr, name)
    B = llr.shape[0]
    if B == 0:
        return hard, done, iters
    from nbldpc_tpu_torch.kernels import _build

    c = dec.cluster
    prior, clusters = _prior_scratch(dec, llr.device)
    blocks, slots = ctypes.c_int(0), ctypes.c_int(0)
    with span("qspa_cluster.launch"):
        _build.launch(resident_decode_cl, name, llr.device,
                      llr.data_ptr(), hard.data_ptr(), done.data_ptr(), iters.data_ptr(),
                      None if prior is None else prior.data_ptr(), clusters,
                      B, g.n, g.m, g.dc_max, g.dv_max, g.q, *_plan_cluster_args(plan),
                      c["edge_info"].data_ptr(), c["row_src"].data_ptr(),
                      c["row_var"].data_ptr(), dec.n2e.data_ptr(), c["gf_log"].data_ptr(),
                      c["gf_exp"].data_ptr(),
                      dec.max_iters, int(dec.early_term), int(dec.stats_each_iter),
                      ctypes.byref(blocks), ctypes.byref(slots), counter=counter)
    resident_decode_cl.grid_blocks += blocks.value
    resident_decode_cl.frame_slots += slots.value
    return hard, done, iters


resident_decode_cl.launches = 0
resident_decode_cl.launches_bf16 = 0
resident_decode_cl.grid_blocks = 0
resident_decode_cl.frame_slots = 0


def cluster_occupancy(dec: ResidentQSPA, device) -> int:
    """cudaOccupancyMaxActiveClusters of the cluster kernel at dec's plan:
    the clusters of the persistent grid."""
    from nbldpc_tpu_torch.kernels import _build

    g = dec.graph
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        name = _entry(dec, "qspa_cluster_occupancy")[0]
        _build.check(getattr(_build.library(), name)(
            g.q, g.dc_max, g.dv_max, *_plan_cluster_args(dec.cluster_plan),
            ctypes.byref(out)), name)
    return out.value


def scratch_layout(dec: ResidentQSPA) -> tuple:
    """(plan_scratch of dec's graph, its tables on dec's device: those of
    cluster_tables plus the field's log and exp), made once per decoder;
    the plan is None where no partition fits."""
    if "_scratch" not in dec.__dict__:
        g = dec.graph
        plan = plan_scratch(g, dec.es) if g.q > K0_MAX_Q else None
        tables = {}
        if plan is not None:
            host = dict(cluster_tables(g, plan), gf_log=g.gf.log, gf_exp=g.gf.exp)
            tables = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32)).to(g.device)
                      for k, v in host.items()}
        dec._scratch = (plan, tables)
    return dec._scratch


def _plan_args(plan: ScratchPlan) -> tuple:
    """The plan as the C entry points take it."""
    return (plan.size, plan.rows, plan.checks, plan.round_checks, plan.warps,
            plan.smem_bytes, int(plan.post_shared))


def scratch_occupancy(dec: ResidentQSPA, device) -> int:
    """cudaOccupancyMaxActiveClusters of the scratch kernel at dec's
    plan_scratch: the clusters its persistent grid runs at once."""
    from nbldpc_tpu_torch.kernels import _build

    g, (plan, _) = dec.graph, scratch_layout(dec)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        name = _entry(dec, "qspa_scratch_occupancy")[0]
        _build.check(getattr(_build.library(), name)(
            g.q, g.dc_max, g.dv_max, *_plan_args(plan), ctypes.byref(out)), name)
    return out.value


def resident_decode_cl_scratch(dec: ResidentQSPA, llr: torch.Tensor):
    """K0-cl's scratch kernel (csrc/qspa_resident_cl.cu) on a CUDA tensor
    llr [B, N, q] f32, q in {64, 128, 256}, for codes whose state no
    cluster holds: a persistent grid of min(B, occupancy) clusters, a frame
    a cluster as `plan_scratch` lays it out, each cluster's edge messages
    (and, for the largest codes, its posterior) in its own slice of a
    scratch of grid x plan.slice_elems state elements. Raises ValueError on a
    tensor it does not take, a CPU tensor included, or a code no plan fits;
    the kernel's own check of the plan raises RuntimeError."""
    g = dec.graph
    name, counter = _entry(dec, "qspa_resident_cl_decode")
    if llr.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {llr.device}")
    hard, done, iters = checked_outputs(dec, llr, name)
    plan, c = scratch_layout(dec)
    if plan is None:
        raise ValueError(f"{name}: no cluster partition of GF({g.q}) N = {g.n}, "
                         f"dc = {g.dc_max} fits the shared memory")
    B = llr.shape[0]
    if B == 0:
        return hard, done, iters
    from nbldpc_tpu_torch.kernels import _build

    grid = min(B, scratch_occupancy(dec, llr.device))
    scratch = torch.empty(grid * plan.slice_elems, device=llr.device,
                          dtype=torch.float32 if dec.es == 4 else torch.bfloat16)
    _build.launch(resident_decode_cl_scratch, name, llr.device,
                  llr.data_ptr(), hard.data_ptr(), done.data_ptr(), iters.data_ptr(),
                  scratch.data_ptr(), grid, B, g.n, g.m, g.dc_max, g.dv_max, g.q,
                  *_plan_args(plan), c["edge_info"].data_ptr(),
                  c["row_src"].data_ptr(), c["row_var"].data_ptr(), dec.n2e.data_ptr(),
                  c["gf_log"].data_ptr(), c["gf_exp"].data_ptr(),
                  dec.max_iters, int(dec.early_term), int(dec.stats_each_iter),
                  counter=counter)
    return hard, done, iters


resident_decode_cl_scratch.launches = 0
resident_decode_cl_scratch.launches_bf16 = 0


def get_resident_decoder(graph: TannerGraph, max_iters: int, early_term: bool,
                         stats_each_iter: bool = True,
                         mm_precision: str = "f32") -> ResidentQSPA:
    """A ResidentQSPA for this configuration, cached on the graph."""
    key = (int(max_iters), bool(early_term), bool(stats_each_iter), mm_precision)
    cache = graph.__dict__.setdefault("_resident_cache", {})
    if key not in cache:
        cache[key] = ResidentQSPA(graph, max_iters, early_term, stats_each_iter,
                                  mm_precision)
    return cache[key]
