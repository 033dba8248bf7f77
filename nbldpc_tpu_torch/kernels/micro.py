"""The routing and layout probes (P1-P7) as Hopper microbenchmarks: CUDA
kernels and their plain PyTorch versions.

Counterparts of the TPU probes in benchmarks/micro_pallas.py (P1-P4) and
benchmarks/micro_layout.py (P5-P7). Each wrapper checks its inputs, runs
the plain version for a CPU tensor and launches its kernel for a CUDA
tensor, counting the launch on its `launches` attribute:

  flat_gather(x, perm, iters)          P1  csrc/micro_gather.cu, micro_flat_gather
  row_moves(x, pi, perms, iters)       P2  csrc/micro_gather.cu, micro_row_moves
  onehot_gemm(A, x, iters)             P3  csrc/micro_onehot_gemm.cu, one launch
                                           per iteration
  cn_iteration(x, iters)               P4  csrc/micro_cn.cu, micro_cn_iteration
  rot_softmax(x, rb, iters, layout)    P5  csrc/micro_layout.cu, micro_rot_softmax
  route(post, vn, nbr, iters, layout)  P6, P7  csrc/micro_layout.cu, micro_route

P1-P4 work on x [E, Q, BT] (frames innermost). P5 takes X [Q, DC, M, TB]
("new", frames innermost) or [Q, DC, TB, M] ("old", checks innermost), P6
and P7 post [Q, N, TB] ("new") or [Q, TB, N] ("old"); one kernel serves
both layouts through strides. Index tables are int32 and come from the
makers below (`row_tables`, `onehot_matrix`, `route_tables`), which keep
every index in range; the wrappers do not read the tables back, since that
would wait on the card inside every timed call. P3 is the exception: its
kernel is exact only for a one-hot A and an x its split can hold, so
`onehot_gemm` checks both (`check_onehot`) and waits once per call.

Every kernel repeats its plain version's arithmetic in the same order
(sums over q serial in q, the route sums in ascending edge order, IEEE
division, expf), so each agrees with it exactly on the H100.
"""

from __future__ import annotations

import numpy as np
import torch

from nbldpc_tpu_torch.kernels import _build
from nbldpc_tpu_torch.kernels.wht import wht_axis

# the probes' fixed constants: P4's check degree, P5's rotation bits
DC_CN = 4
ROT_BITS = 4
PROB_FLOOR = 1e-12
# the field sizes the register-resident kernels (P4, P5) are built for
KERNEL_QS = (2, 4, 8, 16, 32)
# a block's shared memory on the H100 (227 KB)
MAX_SHARED_BYTES = 232448
# frames a lane of the route kernel holds (csrc/micro_layout.cu, kRouteVec)
ROUTE_VEC = 2


# --- table makers -----------------------------------------------------------

def row_tables(perm, Q: int) -> tuple:
    """P2's tables from P1's flat permutation of E * Q rows, as
    micro_pallas.run_row_moves makes them: pi [E], the source edge row of
    each edge row (its first slot's), and perms [E, Q], each slot's source
    slot. int32 tensors."""
    p = torch.as_tensor(np.asarray(perm)).long().reshape(-1, Q)
    return (p[:, 0] // Q).int(), (p % Q).int()


def onehot_matrix(perm, device=None) -> torch.Tensor:
    """P3's routing operator: A [R, R] f32 with A[i, perm[i]] = 1, so that
    A @ x gathers row perm[i] of x into row i."""
    idx = torch.as_tensor(np.asarray(perm)).long().to(device)
    R = idx.numel()
    A = torch.zeros((R, R), dtype=torch.float32, device=device)
    A[torch.arange(R, device=device), idx] = 1.0
    return A


def onehot_to_index(wd) -> torch.Tensor:
    """P6's one-hot down-routing operator Wd [E, N] (Wd[e, vn[e]] = 1) ->
    vn [E] int32. Raises unless every row holds exactly one 1."""
    wd = np.asarray(wd)
    if wd.ndim != 2 or not (np.isin(wd, (0, 1)).all() and (wd.sum(axis=1) == 1).all()):
        raise ValueError("Wd must be [E, N] with exactly one 1 per row")
    return torch.from_numpy(wd.argmax(axis=1).astype(np.int32))


def elist_to_index(e_list) -> torch.Tensor:
    """P7's per-slot operators e_list [DC, N, M] (e_list[j, vn[j M + m], m]
    = 1) -> vn [DC * M] int32, edge e = j M + m. Raises unless every
    (j, m) column holds exactly one 1."""
    el = np.asarray(e_list)
    if el.ndim != 3 or not (np.isin(el, (0, 1)).all() and (el.sum(axis=1) == 1).all()):
        raise ValueError("e_list must be [DC, N, M] with exactly one 1 per (j, m)")
    return torch.from_numpy(el.argmax(axis=1).reshape(-1).astype(np.int32))


def gather_shared_bytes(R: int, E: int = 0) -> int:
    """Shared bytes of a P1 (E 0) or P2 block on R = E Q rows, as
    csrc/micro_gather.cu's gather_smem counts them: two buffers of R + 1
    floats (the last, a pad slot's cell), the stage of the rows a block
    stores (R + 2 floats, 2 the cluster's blocks) and, for P2, 2 E + 8 ints
    (an edge's class and rank in it, the edge at each half of each pair,
    four class counts)."""
    return 4 * (3 * R + 4 + (2 * E + 8 if E else 0))


def row_schedule(pi, Q: int) -> np.ndarray:
    """A host twin of P2's slot order (csrc/micro_gather.cu,
    row_slots_paired, builds its own on the card; nothing reads this but
    the tests of the pairing's property), the destination row of each
    slot (-1: a pad slot). At Q = 16 a warp holds two
    edges, one a half-warp, paired by class 2 (e % 2) + pi[e] % 2: classes 0
    with 3 and 1 with 2 (both parities differ: no bank conflict on either
    side), then the rest in class order 0, 3, 1, 2 (the kernel orders the
    edges of a class by shared atomics; here they ascend). Other Q: rows in
    order."""
    pi = np.asarray(pi).astype(np.int64)
    E = pi.size
    if Q != 16:
        return np.arange(E * Q)
    e = np.arange(E)
    by = [e[2 * (e % 2) + pi % 2 == c] for c in range(4)]
    m03, m12 = min(by[0].size, by[3].size), min(by[1].size, by[2].size)
    halves = [*np.stack([by[0][:m03], by[3][:m03]], 1).reshape(-1),
              *np.stack([by[1][:m12], by[2][:m12]], 1).reshape(-1),
              *by[0][m03:], *by[3][m03:], *by[1][m12:], *by[2][m12:]]
    edge = np.asarray(halves + [-1] * (len(halves) % 2), np.int64).repeat(16)
    rows = edge * 16 + np.tile(np.arange(16), edge.size // 16)
    return np.where(edge >= 0, rows, -1)


def route_shared_bytes(N: int, E: int, D: int, warps: int = 1) -> int:
    """Shared bytes of a route block of `warps` warps, as
    csrc/micro_layout.cu's route_smem counts them: two buffers of P + 1
    positions (P = N rounded up to 32, the last the zero cell) of ROUTE_VEC
    floats a warp, the table (max(D, 1) rows a slot of 32 nodes, whatever
    nbr holds, and four more read ahead), and the build's scratch (order,
    positions, degrees, 32 bins, nbr, vn, the slots' first rows)."""
    S = (N + 31) // 32
    rows = S * max(D, 1)
    floats = warps * 2 * (32 * S + 1) * ROUTE_VEC
    return 4 * (floats + 32 * (rows + 4) + 3 * N + 32 + N * D + E + S + 1)


def route_tables(vn, N: int) -> torch.Tensor:
    """The up-routing table of P6/P7: nbr [N, D] int32, row n the edges e
    with vn[e] = n in ascending order, padded with -1; D is the largest
    degree (at least 1). The sum in that order is the one-hot GEMM's."""
    v = np.asarray(vn).astype(np.int64)
    if v.size and not (0 <= v.min() and v.max() < N):
        raise ValueError(f"vn must lie in [0, {N})")
    deg = np.bincount(v, minlength=N)
    D = max(int(deg.max()) if v.size else 0, 1)
    nbr = np.full((N, D), -1, np.int32)
    fill = np.zeros(N, np.int64)
    for e, n in enumerate(v):
        nbr[n, fill[n]] = e
        fill[n] += 1
    return torch.from_numpy(nbr)


# --- input checks -----------------------------------------------------------

def _check(name: str, t: torch.Tensor, ndim: int, dtype=torch.float32) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} tensor, "
                         f"got {t.dtype} {list(t.shape)}")


def _same_device(name: str, x: torch.Tensor, *tables: torch.Tensor) -> None:
    if any(t.device != x.device for t in tables):
        raise ValueError(f"{name}: every input must be on {x.device}")


def _check_iters(name: str, iters: int) -> int:
    if int(iters) < 0:
        raise ValueError(f"{name}: iters={iters} must be >= 0")
    return int(iters)


def _kernel_q(name: str, q: int) -> None:
    if q not in KERNEL_QS:
        raise ValueError(f"{name}: q={q} not in {KERNEL_QS}")


def _check_shared(name: str, nbytes: int) -> None:
    if nbytes > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: a block needs {nbytes} bytes of shared memory, "
                         f"more than {MAX_SHARED_BYTES}")


def _serial_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` left to right (the kernels' order), keeping the dim."""
    s = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        s = s + x.select(dim, i)
    return s.unsqueeze(dim)


# --- P1: flat constant gather ----------------------------------------------

def flat_gather_plain(x: torch.Tensor, perm: torch.Tensor, iters: int) -> torch.Tensor:
    """iters x: x <- x.reshape(E Q, BT)[perm] + 1, on x [E, Q, BT]."""
    E, Q, BT = x.shape
    idx = perm.long()
    for _ in range(iters):
        x = x.reshape(E * Q, BT)[idx].reshape(E, Q, BT) + 1.0
    return x


def flat_gather(x: torch.Tensor, perm: torch.Tensor, iters: int) -> torch.Tensor:
    """P1 on x [E, Q, BT] f32 and perm [E Q] int32 (any table of rows in
    range; micro_kernels passes a permutation)."""
    name = "micro_flat_gather"
    _check(name, x, 3)
    _check(name, perm, 1, torch.int32)
    _same_device(name, x, perm)
    E, Q, BT = x.shape
    if perm.numel() != E * Q:
        raise ValueError(f"{name}: perm has {perm.numel()} entries, x has {E * Q} rows")
    iters = _check_iters(name, iters)
    if x.device.type == "cpu":
        return flat_gather_plain(x, perm, iters)
    _check_shared(name, gather_shared_bytes(E * Q))
    out = torch.empty_like(x)
    if x.numel():
        _build.launch(flat_gather, name, x.device, x.data_ptr(), out.data_ptr(),
                      perm.data_ptr(), E * Q, BT, iters)
    return out


flat_gather.launches = 0


# --- P2: per-edge row moves -------------------------------------------------

def row_moves_plain(x: torch.Tensor, pi: torch.Tensor, perms: torch.Tensor,
                    iters: int) -> torch.Tensor:
    """iters x: x[e, s, :] <- x[pi[e], perms[e, s], :] + 1."""
    rows, slots = pi.long()[:, None], perms.long()
    for _ in range(iters):
        x = x[rows, slots] + 1.0
    return x


def row_moves(x: torch.Tensor, pi: torch.Tensor, perms: torch.Tensor,
              iters: int) -> torch.Tensor:
    """P2 on x [E, Q, BT] f32 with pi [E] and perms [E, Q] int32."""
    name = "micro_row_moves"
    _check(name, x, 3)
    _check(name, pi, 1, torch.int32)
    _check(name, perms, 2, torch.int32)
    _same_device(name, x, pi, perms)
    E, Q, BT = x.shape
    if pi.shape != (E,) or perms.shape != (E, Q):
        raise ValueError(f"{name}: pi {list(pi.shape)} and perms {list(perms.shape)} "
                         f"do not fit x {list(x.shape)}")
    iters = _check_iters(name, iters)
    if x.device.type == "cpu":
        return row_moves_plain(x, pi, perms, iters)
    _check_shared(name, gather_shared_bytes(E * Q, E))
    out = torch.empty_like(x)
    if x.numel():
        _build.launch(row_moves, name, x.device, x.data_ptr(), out.data_ptr(),
                      pi.data_ptr(), perms.data_ptr(), E, Q, BT, iters)
    return out


row_moves.launches = 0


# --- P3: one-hot GEMM routing -----------------------------------------------

def onehot_gemm_plain(A: torch.Tensor, x: torch.Tensor, iters: int) -> torch.Tensor:
    """iters x: x <- A @ x.reshape(E Q, BT) + 1 (f32; on a card with TF32
    off the one-hot product is exact)."""
    E, Q, BT = x.shape
    for _ in range(iters):
        x = (A @ x.reshape(E * Q, BT)).reshape(E, Q, BT) + 1.0
    return x


# the least nonzero |x| whose three TF32 parts (hi, mid, lo) are all normal
ONEHOT_X_MIN = 2.0 ** -103


def check_onehot(A: torch.Tensor, x: torch.Tensor, name: str = "micro_onehot_gemm") -> None:
    """Raises unless A is one-hot (each row all 0 but at most one 1) and
    every x is finite and 0 or at least ONEHOT_X_MIN in magnitude: what the
    kernel's exact split of x needs (csrc/micro_onehot_gemm.cu)."""
    ones = torch.count_nonzero(A, dim=1)
    mag = x.abs()
    ok = ((ones <= 1).all() & (A.sum(dim=1) == ones).all()
          & (torch.isfinite(x) & ((mag == 0) | (mag >= ONEHOT_X_MIN))).all())
    if not bool(ok):
        raise ValueError(f"{name}: A must be one-hot (0/1, at most one 1 per row) and "
                         f"x finite with each entry 0 or of magnitude >= 2^-103")


def onehot_gemm(A: torch.Tensor, x: torch.Tensor, iters: int) -> torch.Tensor:
    """P3 on A [E Q, E Q] and x [E, Q, BT] f32: one call of the GEMM (three
    exact TF32 tensor-core products, split K, +1 epilogue) per iteration,
    between two buffers. Raises unless A is one-hot and x fits the split
    (`check_onehot`), on either device."""
    name = "micro_onehot_gemm"
    _check(name, A, 2)
    _check(name, x, 3)
    _same_device(name, x, A)
    E, Q, BT = x.shape
    if A.shape != (E * Q, E * Q):
        raise ValueError(f"{name}: A {list(A.shape)} does not fit x {list(x.shape)}")
    iters = _check_iters(name, iters)
    check_onehot(A, x, name)
    if x.device.type == "cpu":
        return onehot_gemm_plain(A, x, iters)
    if iters == 0 or x.numel() == 0:
        return x.clone()
    bufs = [torch.empty_like(x) for _ in range(min(iters, 2))]
    src = x
    for i in range(iters):
        dst = bufs[i % 2]
        _build.launch(onehot_gemm, name, x.device, A.data_ptr(), src.data_ptr(),
                      dst.data_ptr(), E * Q, BT, E * Q)
        src = dst
    return src


onehot_gemm.launches = 0


# --- P4: one probability-domain check-node iteration ------------------------

def cn_iteration_plain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """iters x, on x [E, Q, BT] as M = E / 4 checks of degree 4: normalize
    over q, WHT, leave-one-out product over the 4 edges by prefix and
    suffix, WHT / Q, floor at 1e-12."""
    E, Q, BT = x.shape
    M = E // DC_CN
    for _ in range(iters):
        p = x / (_serial_sum(x, 1) + 1e-30)
        f0, f1, f2, f3 = wht_axis(p, 1).reshape(M, DC_CN, Q, BT).unbind(1)
        pre2 = f0 * f1
        pre3 = pre2 * f2
        suf1 = f3 * f2
        suf0 = suf1 * f1
        loo = torch.stack([suf0, f0 * suf1, pre2 * f3, pre3], dim=1).reshape(E, Q, BT)
        x = torch.clamp_min(wht_axis(loo, 1) / Q, PROB_FLOOR)
    return x


def cn_iteration(x: torch.Tensor, iters: int) -> torch.Tensor:
    """P4 on x [E, Q, BT] f32, E a multiple of 4, Q a power of two."""
    name = "micro_cn_iteration"
    _check(name, x, 3)
    E, Q, BT = x.shape
    if E % DC_CN or Q & (Q - 1) or Q < 2:
        raise ValueError(f"{name}: needs E % 4 == 0 and Q a power of two, got {list(x.shape)}")
    iters = _check_iters(name, iters)
    if x.device.type == "cpu":
        return cn_iteration_plain(x, iters)
    _kernel_q(name, Q)
    out = torch.empty_like(x)
    if x.numel():
        _build.launch(cn_iteration, name, x.device, x.data_ptr(), out.data_ptr(),
                      E, Q, BT, iters)
    return out


cn_iteration.launches = 0


# --- P5: rotation + softmax chain, two layouts ------------------------------

def _blend_rot(z: torch.Tensor, rb: torch.Tensor) -> torch.Tensor:
    """P5's rotation of z = X[1:] as the JAX probe writes it: for each bit
    t, z <- z (1 - b_t) + roll(z, 2^t mod L) b_t."""
    L = z.shape[0]
    for t in range(rb.shape[0]):
        s = (1 << t) % L
        rolled = torch.cat([z[L - s:], z[:L - s]])
        b = rb[t]
        z = z * (1.0 - b) + rolled * b
    return z


def rot_softmax_plain(x: torch.Tensor, rb: torch.Tensor, iters: int) -> torch.Tensor:
    """iters x: X <- softmax_q(rot(X)) - 0.5, q on axis 0; rot rolls X[1:]
    (L = Q - 1 rows) by 2^t mod L where bit t of RB is set, as the blend
    Z (1 - b) + rolled b. Layout-agnostic: RB broadcasts over the frames."""
    for _ in range(iters):
        ex = torch.exp(torch.cat([x[:1], _blend_rot(x[1:], rb)]))
        x = ex / _serial_sum(ex, 0) - 0.5
    return x


def rot_amounts(rb: torch.Tensor, Q: int) -> tuple:
    """P5's rotation of each column as one roll, as csrc/micro_layout.cu
    forms it: (r, flat), shaped like RB[0]. flat where every RB entry of
    the column is 0 or 1; there the blend is a roll of X[1:] by r = sum_t
    b_t (2^t mod L) mod L (r is 0 elsewhere)."""
    L = Q - 1
    flat = ((rb == 0) | (rb == 1)).all(dim=0)
    shifts = torch.tensor([(1 << t) % L for t in range(rb.shape[0])], device=rb.device)
    r = ((rb == 1).long() * shifts.view(-1, *[1] * (rb.ndim - 1))).sum(dim=0) % L
    return torch.where(flat, r, 0), flat


def rot_softmax_rolled(x: torch.Tensor, rb: torch.Tensor, iters: int) -> torch.Tensor:
    """P5 in the kernel's scheme: iteration 0 blends as rot_softmax_plain;
    later iterations roll X[1:] of the flat columns by their rot_amounts
    and blend the others. It equals rot_softmax_plain, NaN where it has
    NaN: after one iteration every value is finite or its column all NaN,
    where the blend by 0 and 1 is the roll but for the sign of a zero,
    which exp erases."""
    L = x.shape[0] - 1
    r, flat = rot_amounts(rb, L + 1)
    idx = (torch.arange(L, device=x.device).view(-1, *[1] * (x.ndim - 1)) - r) % L
    for it in range(iters):
        z = _blend_rot(x[1:], rb)
        if it:
            z = torch.where(flat, torch.gather(x[1:], 0, idx.expand_as(z)), z)
        ex = torch.exp(torch.cat([x[:1], z]))
        x = ex / _serial_sum(ex, 0) - 0.5
    return x


def _elem_dims(name: str, x: torch.Tensor, rb: torch.Tensor, layout: str) -> tuple:
    """(Q, DC, M, TB) of P5's X and RB in `layout`, or ValueError."""
    Q = x.shape[0]
    if layout == "new":
        _, DC, M, TB = x.shape
        want = (ROT_BITS, DC, M, 1)
    elif layout == "old":
        _, DC, TB, M = x.shape
        want = (ROT_BITS, DC, 1, M)
    else:
        raise ValueError(f"{name}: layout {layout!r} is not 'new' or 'old'")
    if tuple(rb.shape) != want or Q < 2:
        raise ValueError(f"{name}: RB {list(rb.shape)} does not fit X {list(x.shape)} "
                         f"in the {layout} layout (want {list(want)})")
    return Q, DC, M, TB


def rot_softmax(x: torch.Tensor, rb: torch.Tensor, iters: int,
                layout: str = "new") -> torch.Tensor:
    """P5 on X [Q, DC, M, TB] with RB [4, DC, M, 1] ("new") or X [Q, DC,
    TB, M] with RB [4, DC, 1, M] ("old"), f32, RB in {0, 1} (any other
    entry is blended, as the plain version does, every iteration)."""
    name = "micro_rot_softmax"
    _check(name, x, 4)
    _check(name, rb, 4)
    _same_device(name, x, rb)
    Q, DC, M, TB = _elem_dims(name, x, rb, layout)
    iters = _check_iters(name, iters)
    if x.device.type == "cpu":
        return rot_softmax_plain(x, rb, iters)
    _kernel_q(name, Q)
    sq, sj = x.stride(0), x.stride(1)
    sm, sb = (x.stride(2), x.stride(3)) if layout == "new" else (x.stride(3), x.stride(2))
    out = torch.empty_like(x)
    if x.numel():
        _build.launch(rot_softmax, name, x.device, x.data_ptr(), rb.data_ptr(),
                      out.data_ptr(), Q, DC, M, TB, sq, sj, sm, sb, iters)
    return out


rot_softmax.launches = 0


# --- P6, P7: down-route, up-route, blend; two layouts -----------------------

def route_plain(post: torch.Tensor, vn: torch.Tensor, nbr: torch.Tensor, iters: int,
                layout: str = "new") -> torch.Tensor:
    """iters x: lc = 0.999 post[:, vn, :]; pn[n] = sum of lc[:, e] over
    nbr[n] (ascending e; -1 pads add 0); post <- 0.5 pn + 0.5 post."""
    x = post if layout == "new" else post.transpose(1, 2)     # [Q, N, TB]
    Q, _, TB = x.shape
    E = vn.numel()
    down = vn.long()
    up = torch.where(nbr >= 0, nbr, E).long()                  # pads -> a zero row
    zero = x.new_zeros((Q, 1, TB))
    for _ in range(iters):
        lc = torch.cat([x[:, down, :] * 0.999, zero], dim=1)
        pn = lc[:, up[:, 0], :]
        for k in range(1, up.shape[1]):
            pn = pn + lc[:, up[:, k], :]
        x = pn * 0.5 + x * 0.5
    return x if layout == "new" else x.transpose(1, 2).contiguous()


def route(post: torch.Tensor, vn: torch.Tensor, nbr: torch.Tensor, iters: int,
          layout: str = "new") -> torch.Tensor:
    """P6 on post [Q, N, TB] ("new") or P7 on post [Q, TB, N] ("old"), f32,
    with vn [E] and nbr [N, D] int32 from `route_tables`."""
    name = "micro_route"
    _check(name, post, 3)
    _check(name, vn, 1, torch.int32)
    _check(name, nbr, 2, torch.int32)
    _same_device(name, post, vn, nbr)
    if layout not in ("new", "old"):
        raise ValueError(f"{name}: layout {layout!r} is not 'new' or 'old'")
    Q = post.shape[0]
    N, TB = post.shape[1:] if layout == "new" else post.shape[:0:-1]
    if nbr.shape[0] != N or nbr.shape[1] < 1:
        raise ValueError(f"{name}: nbr {list(nbr.shape)} does not fit post "
                         f"{list(post.shape)} in the {layout} layout")
    iters = _check_iters(name, iters)
    if post.device.type == "cpu":
        return route_plain(post, vn, nbr, iters, layout)
    E, D = vn.numel(), nbr.shape[1]
    _check_shared(name, route_shared_bytes(N, E, D))
    sq = post.stride(0)
    sn, sb = (post.stride(1), post.stride(2)) if layout == "new" else (post.stride(2),
                                                                       post.stride(1))
    out = torch.empty_like(post)
    if post.numel():
        _build.launch(route, name, post.device, post.data_ptr(), out.data_ptr(),
                      vn.data_ptr(), nbr.data_ptr(), Q, N, TB, E, D, sq, sn, sb, iters)
    return out


route.launches = 0

# every kernel wrapper of this module, for counters
WRAPPERS = (flat_gather, row_moves, onehot_gemm, cn_iteration, rot_softmax, route)
