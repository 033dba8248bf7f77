"""K0-cl's cluster partition (kernels/qspa_resident.py: plan_cluster,
cluster_plan_at, cluster_tables, cn_shift) and the tables the cluster
kernel (csrc/qspa_cluster.cu) reads: each check and variable owned by one
rank, each rank within a block's shared memory, the cluster sizes and
layouts of the repo's codes, the scratch path for a code no
cluster holds, and the log/exp form of h^-1 x equal to the graph's
perm_down table."""

from pathlib import Path

import numpy as np
import pytest

from nbldpc_tpu_torch.code import random_regular_spec
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import qspa_resident as qr
from nbldpc_tpu_torch.utils.config import CodeConfig

from tests.test_torch_qspa import port_graph

CODES = Path(__file__).resolve().parents[1] / "codes"
ALISTS = sorted(p.stem for p in CODES.glob("*.alist"))


# random codes of the card tests: (q, N, M, seed)
RANDOM = {"gf128_n96_m24": (128, 96, 24, 7),     # one block, buffered
          "gf64_n1800_m600": (64, 1800, 600, 3)}   # 8 blocks in place, none buffered


def _graph(name):
    if name in RANDOM:
        q, n, m, seed = RANDOM[name]
        return TannerGraph(random_regular_spec(q, n, m, seed=seed), "cpu")
    return TannerGraph(CodeConfig(path=str(CODES / f"{name}.alist")).load(), "cpu")


def _layout(plan):
    """cluster_smem_bytes' layout arguments for `plan`."""
    return 4, plan.in_place


PLANNED = ["gf64_n576_k480", "gf256_n255_k175", "gf128_n96_m24"]


def perm_from_logs(gf_log, gf_exp, shift, q):
    """h^-1 x for every edge slot and symbol, [E, q], as the cluster kernel
    computes it: exp[log x + shift], 0 for x = 0."""
    x = np.arange(q)
    out = gf_exp[gf_log[x][None, :] + np.asarray(shift).reshape(-1, 1)]
    return np.where(x[None, :] == 0, 0, out)


@pytest.mark.parametrize("code", PLANNED)
def test_plan_owns_each_check_and_variable_once(code):
    g = _graph(code)
    plan = qr.plan_cluster(g)
    # rank r runs the checks [r checks, min(M, (r + 1) checks)), as the kernel
    ranges = [range(r * plan.checks, min(g.m, (r + 1) * plan.checks))
              for r in range(plan.size)]
    assert sorted(m for rg in ranges for m in rg) == list(range(g.m))
    row_var = qr.cluster_tables(g, plan)["row_var"].reshape(plan.size, plan.rows)
    used = row_var[row_var >= 0]
    assert np.array_equal(np.sort(used), np.arange(g.n))     # each variable once
    assert np.array_equal(row_var[plan.vn_rank, plan.vn_row], np.arange(g.n))
    # the fullest rank sets the rows, no rank holds more
    assert np.bincount(plan.vn_rank, minlength=plan.size).max() == plan.rows


@pytest.mark.parametrize("code", PLANNED)
def test_plan_fits_shared_memory(code):
    g = _graph(code)
    plan = qr.plan_cluster(g)
    assert plan.smem_bytes <= qr.MAX_SMEM_BYTES == 232448
    for r in range(plan.size):
        rows = int((plan.vn_rank == r).sum())
        checks = max(0, min(plan.checks, g.m - r * plan.checks))
        mine = qr.cluster_smem_bytes(g.q, g.dc_max, g.dv_max, rows, checks,
                                     plan.round_checks, *_layout(plan))
        assert mine <= plan.smem_bytes
    # the next smaller cluster does not fit one frame, in either layout
    # (buffered even one check per round; in place the prior off chip)
    if plan.size > 1:
        half = plan.size // 2
        checks = -(-g.m // half)
        rows = -(-g.n // half)
        assert (qr.cluster_smem_bytes(g.q, g.dc_max, g.dv_max, rows, checks, 1)
                > qr.MAX_SMEM_BYTES)
        assert (qr.cluster_smem_bytes(g.q, g.dc_max, g.dv_max, rows, checks, checks, 4, True)
                > qr.MAX_SMEM_BYTES)


@pytest.mark.parametrize("code,sizes", [("gf256_n255_k175", (4,)), ("gf64_n576_k480", (1, 2, 4)),
                                        ("gf128_n96_m24", (1, 2))])
def test_plan_cluster_size(code, sizes):
    plan = qr.plan_cluster(_graph(code))
    assert plan.size in sizes
    assert plan.warps == qr.CLUSTER_WARPS[_graph(code).q]
    assert 1 <= plan.round_checks <= plan.checks


def test_oversize_code_takes_the_scratch_path():
    # GF(256), N = 1200, dv = 2: 4.9 MB of state per frame
    g = TannerGraph(random_regular_spec(256, 1200, 400, seed=3), "cpu")
    assert qr.plan_cluster(g) is None
    dec = qr.ResidentQSPA(g, 2)
    assert dec.cluster_plan is None and not hasattr(dec, "cluster")
    # K0 covers q <= 32: no plan there either
    assert qr.ResidentQSPA(_graph("gf16_n204_k102"), 2).cluster_plan is None


def _unpack(t):
    """(rank, row) of each entry of an edge_info or row_src table."""
    return (t >> 16) & 0xF, t & 0xFFFF


@pytest.mark.parametrize("code", PLANNED)
def test_cluster_tables_route_every_message(code):
    g = _graph(code)
    plan = qr.plan_cluster(g)
    t = qr.cluster_tables(g, plan)
    dc, dv, E = g.dc_max, g.dv_max, g.m * g.dc_max
    row_var = t["row_var"].reshape(plan.size, plan.rows)
    # each posterior row's message sources: its variable's edges, in slot order
    src = t["row_src"].reshape(plan.size, plan.rows, dv)
    vn_edge = g.np["vn_edge"]
    for r in range(plan.size):
        for i in range(plan.rows):
            v = row_var[r, i]
            want = vn_edge[v] if v >= 0 else np.full(dv, E)
            assert np.array_equal(src[r, i] < 0, want >= E)       # pads, and only pads
            sr, row = _unpack(src[r, i][want < E])
            e = want[want < E].astype(np.int64)
            # the rank that owns the edge's check, the edge's row among its messages
            assert np.array_equal(sr, e // dc // plan.checks)
            assert np.array_equal(sr * plan.checks * dc + row, e)
    # each edge slot of each rank: its variable's posterior (rank, row)
    info = t["edge_info"].reshape(plan.size, plan.checks * dc)
    for r in range(plan.size):
        for k in range(plan.checks * dc):
            e = r * plan.checks * dc + k
            if e >= E or not g.np["cn_mask"].reshape(-1)[e]:
                assert info[r, k] == -1
                continue
            vr, row = _unpack(info[r, k])
            assert row_var[vr, row] == g.np["cn_vn"].reshape(-1)[e]


@pytest.mark.parametrize("code", ALISTS)
def test_perm_from_logs_matches_perm_down_codes(code):
    g = _graph(code)
    got = perm_from_logs(g.gf.log, g.gf.exp, qr.cn_shift(g), g.q)
    assert np.array_equal(got, g.np["perm_down"].reshape(-1, g.q))   # pads included


@pytest.mark.parametrize("code", PLANNED)
def test_perm_from_logs_matches_perm_down_planned(code):
    g = _graph(code)
    plan = qr.plan_cluster(g)
    info = qr.cluster_tables(g, plan)["edge_info"]
    E = g.m * g.dc_max
    real = info[:E] >= 0                       # the kernel's shift of each real slot
    got = perm_from_logs(g.gf.log, g.gf.exp, info[:E][real] >> 20, g.q)
    assert np.array_equal(got, g.np["perm_down"].reshape(-1, g.q)[real])


@pytest.mark.parametrize("name", ["gf4_tiny", "gf16_tiny", "gf4_n96", "gf16_irr", "gf4_dv3"])
def test_perm_from_logs_matches_perm_down_small_codes(small_codes, name):
    g = port_graph(small_codes[name])
    got = perm_from_logs(g.gf.log, g.gf.exp, qr.cn_shift(g), g.q)
    assert np.array_equal(got, g.np["perm_down"].reshape(-1, g.q))


# K0-cl's scratch kernel (csrc/qspa_resident_cl.cu): its partition
# (plan_scratch) for the codes no cluster holds, GF(256) from about N = 600
# and GF(64) from about N = 2250 (random dv = 2 codes, M = N / 3; the
# cluster kernel's in-place layout holds them up to there), and for a code
# whose posterior no cluster of 8 holds either (GF(256), N = 2400)
OVERSIZE = {"gf256_n720": (256, 720, 240), "gf256_n1200": (256, 1200, 400),
            "gf64_n2400": (64, 2400, 800), "gf256_n2400": (256, 2400, 800)}


def _oversize(name):
    q, n, m = OVERSIZE[name]
    return TannerGraph(random_regular_spec(q, n, m, seed=3), "cpu")


@pytest.mark.parametrize("name", list(OVERSIZE))
def test_scratch_plan_exists_where_no_cluster_fits(name):
    g = _oversize(name)
    assert qr.plan_cluster(g) is None
    plan = qr.plan_scratch(g)
    assert plan is not None and plan.size in qr.CLUSTER_SIZES
    assert plan.warps == qr.CLUSTER_WARPS[g.q]
    assert 1 <= plan.round_checks <= plan.checks
    # the posterior stays on chip but for the largest code
    assert plan.post_shared == (name != "gf256_n2400")
    # the smallest cluster that holds it ... (GF(256), N = 1200: 8 ranks)
    if name == "gf256_n1200":
        assert plan.size == 8


@pytest.mark.parametrize("name", list(OVERSIZE))
def test_scratch_plan_owns_each_check_and_variable_once(name):
    g = _oversize(name)
    plan = qr.plan_scratch(g)
    ranges = [range(r * plan.checks, min(g.m, (r + 1) * plan.checks))
              for r in range(plan.size)]
    assert sorted(m for rg in ranges for m in rg) == list(range(g.m))
    row_var = qr.cluster_tables(g, plan)["row_var"].reshape(plan.size, plan.rows)
    assert np.array_equal(np.sort(row_var[row_var >= 0]), np.arange(g.n))
    assert np.array_equal(row_var[plan.vn_rank, plan.vn_row], np.arange(g.n))
    assert np.bincount(plan.vn_rank, minlength=plan.size).max() == plan.rows


@pytest.mark.parametrize("name", list(OVERSIZE))
def test_scratch_plan_fits_shared_memory_and_the_l2(name):
    g = _oversize(name)
    plan = qr.plan_scratch(g)
    assert plan.smem_bytes == qr.scratch_smem_bytes(
        g.q, g.dc_max, g.dv_max, plan.rows, plan.checks, plan.round_checks, plan.post_shared)
    assert plan.smem_bytes <= qr.MAX_SMEM_BYTES
    # as few rounds as fit: one round fewer would not
    rounds = -(-plan.checks // plan.round_checks)
    if rounds > 1:
        assert qr.scratch_smem_bytes(g.q, g.dc_max, g.dv_max, plan.rows, plan.checks,
                                     -(-plan.checks // (rounds - 1)),
                                     plan.post_shared) > qr.MAX_SMEM_BYTES
    # a slice: every rank's message rows, and the posterior if it is off chip
    E_rows = plan.size * plan.checks * g.dc_max
    assert plan.slice_elems == g.q * (E_rows + (0 if plan.post_shared else
                                                 plan.size * plan.rows))
    # at chip_smoke's OVERSIZE (GF(256), N = 1200) the slices of the 15
    # clusters of 8 that run at once on the H100 (its occupancy), 37 MB,
    # fit 40 MiB of its 50 MB L2 (the grid is not capped to the L2: PERF.md)
    if name == "gf256_n1200":
        assert plan.size == 8 and 15 * 4 * plan.slice_elems <= 40 * 2**20


def _fewest_rounds(g):
    """(rounds, size) of the cluster size whose ranks, the posterior in
    shared memory, run their checks in the fewest rounds (the smaller on a
    tie), from the shared-memory formula alone."""
    best = None
    for size in qr.CLUSTER_SIZES:
        checks = -(-g.m // size)
        rows = qr._place_variables(g.np["vn_edge"], g.m * g.dc_max, g.dc_max, size, checks)[2]
        fits = [c for c in range(1, checks + 1) if qr.scratch_smem_bytes(
            g.q, g.dc_max, g.dv_max, rows, checks, c, True) <= qr.MAX_SMEM_BYTES]
        if fits and (best is None or -(-checks // max(fits)) < best[0]):
            best = (-(-checks // max(fits)), size)
    return best


@pytest.mark.parametrize("q,n,m", [(64, 576, 96), (256, 255, 85), (128, 96, 24),
                                   (256, 480, 160), (64, 1800, 600)])
def test_scratch_plan_takes_the_fewest_rounds(q, n, m):
    # the scratch kernel takes every code of 32 < q <= 256, dc <= 32
    g = TannerGraph(random_regular_spec(q, n, m, seed=3), "cpu")
    plan = qr.plan_scratch(g)
    assert plan.post_shared and plan.smem_bytes <= qr.MAX_SMEM_BYTES
    assert (-(-plan.checks // plan.round_checks), plan.size) == _fewest_rounds(g)
    assert qr.plan_scratch(_graph("gf16_n204_k102")) is None      # K0's field


# The layout plan_cluster picks by shape (f32): in place where that holds
# a frame on fewer blocks than buffered (more frames on the card at once),
# else buffered; bf16 always buffered
@pytest.mark.parametrize("code,size,in_place", [
    ("gf256_n255_k175", 4, True),       # buffered: 8 blocks; in place: 4
    ("gf64_n576_k480", 4, False),       # 4 blocks either way: buffered
    ("gf128_n96_m24", 1, False),        # 1 block either way: buffered
    ("gf64_n1800_m600", 8, True)])      # no cluster holds it buffered
def test_plan_cluster_layout_by_shape(code, size, in_place):
    g = _graph(code)
    plan = qr.plan_cluster(g)
    assert (plan.size, plan.in_place) == (size, in_place)
    buffered = next((p for s in qr.CLUSTER_SIZES if (p := qr.cluster_plan_at(g, s)) is not None),
                    None)
    assert buffered is None or not buffered.in_place
    # in place exactly where buffered takes more blocks (or none holds it)
    assert in_place == (buffered is None or buffered.size > plan.size)
    bf16 = qr.plan_cluster(g, es=2)
    assert not bf16.in_place


@pytest.mark.parametrize("code,size", [("gf256_n255_k175", 4), ("gf256_n255_k175", 8),
                                       ("gf64_n576_k480", 4), ("gf128_n96_m24", 1)])
def test_in_place_plan_fits_shared_memory(code, size):
    """In place (f32): the posterior rows, the message rows q + 4 floats
    apart and their sums, hard decisions and tables within a block, every
    check in one round, the priors off chip: fewer bytes than buffered in
    one round at the same size; config 5's code fits 4 blocks so, where
    buffered needs 8."""
    g = _graph(code)
    plan = qr.cluster_plan_at(g, size, 4, True)
    assert plan is not None and plan.in_place and plan.round_checks == plan.checks
    assert plan.smem_bytes == qr.cluster_smem_bytes(
        g.q, g.dc_max, g.dv_max, plan.rows, plan.checks, plan.checks, *_layout(plan))
    assert plan.smem_bytes <= qr.MAX_SMEM_BYTES
    assert plan.smem_bytes < qr.cluster_smem_bytes(g.q, g.dc_max, g.dv_max, plan.rows,
                                                   plan.checks, plan.checks)
    if (code, size) == ("gf256_n255_k175", 4):
        assert plan.smem_bytes == 217384
        assert qr.cluster_plan_at(g, 4) is None
