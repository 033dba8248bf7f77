"""BASELINE config 5's QSPA half (configs/gf256_sweep_2host.json: GF(256)
(255,175), 50 checks of degree 6 and 30 of degree 7, QSPA, 20 iterations,
early termination, 8 Eb/N0 points) on the CPU: the port's sweep step held
to the benchmark's plain reference (portbench/reference.py), K0-cl's
cluster partition of the code, its grid and frame-slot counters, and the
readers of K0-cl's three per-layer metrics. This file imports no JAX."""

import types

import numpy as np
import pytest
import torch

from nbldpc_tpu_torch import sim
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import counted, launch_counts, reset_launch_counts
from nbldpc_tpu_torch.kernels import qspa_resident as qr
from nbldpc_tpu_torch.utils.config import load_config
from portbench import bounds, manifest, reference

torch.set_num_threads(1)

CONFIG = manifest.ROOT / "configs" / "gf256_sweep_2host.json"
S, B = 8, 4                         # the file's 8 slots, 4 frames each
SEED, T = 2**31 + 27, 0             # step 0: slot 0 (2.0 dB) ends with a frame in error
# cn_impl: decode_bl's plain path (the CPU's default), K0-cl's plain version
IMPLS = {"torch": "auto", "resident": "resident"}


@pytest.fixture(scope="module")
def cfg():
    return load_config(CONFIG)


@pytest.fixture(scope="module")
def code():
    return reference.load_code("gf256_n255_k175")


@pytest.fixture(scope="module")
def graph(cfg):
    return TannerGraph(cfg.code.load(), "cpu")


def _ref(cfg, code, dtype):
    dec = reference.Decoder(code, "cpu", "qspa", cfg.decoder.max_iters, dtype=dtype)
    return reference.step_counters(code, dec, SEED, T, cfg.channel.ebn0_db, B, S * B)


@pytest.fixture(scope="module")
def ref(cfg, code):
    return _ref(cfg, code, torch.float32)


@pytest.fixture(scope="module", params=list(IMPLS))
def port(request, cfg, graph):
    """The port's counters [6, S] of the step, as run_sweep builds it, and
    the program's counters after it."""
    step = sim.make_sim_step(graph, cfg.decoder, B, S, cn_impl=IMPLS[request.param])
    sig = torch.tensor([sim.ebn0_to_sigma(e, graph.spec.k / graph.n)
                        for e in cfg.channel.ebn0_db], dtype=torch.float32)
    reset_launch_counts()
    out = sim.step_counters(step, sim.step_generator(SEED, T, "cpu"), sig)
    return np.stack([out[k] for k in reference.COUNTERS]), launch_counts()


def _outside(got, want, n: int, p: int, max_iters: int) -> list:
    """The counters of one slot that differ by more than one frame can move
    them. f32 sums taken in another order (the port's LLRs and posterior
    against the reference's) can flip a near-tie of one frame's decision,
    and then that frame's path: it may turn done or not (converged, frame
    errors: 1), err in up to all its N symbols and N p bits, and run up to
    max_iters iterations more or fewer. `frames` is exact."""
    room = {"frames": 0, "frame_errors": 1, "symbol_errors": n, "bit_errors": n * p,
            "iter_sum": max_iters, "converged": 1}
    return [k for i, k in enumerate(reference.COUNTERS)
            if abs(int(got[i]) - int(want[i])) > room[k]]


def _slots_differing(got, want) -> int:
    return int((np.asarray(got) != np.asarray(want)).any(axis=0).sum())


def test_the_config_is_config5(cfg, code):
    assert (cfg.code.name, cfg.decoder.kind, cfg.decoder.max_iters) == (
        "gf256_n255_k175", "qspa", 20)
    assert cfg.decoder.early_term and len(cfg.channel.ebn0_db) == S
    assert [idx.shape for idx in code.degree_groups()] == [(50, 6), (30, 7)]


@pytest.mark.parametrize("slot", range(S))
def test_step_counters_match_the_reference(port, ref, code, cfg, slot):
    got, _ = port
    assert got[0, slot] == ref[0, slot] == B
    assert _outside(got[:, slot], ref[:, slot], code.n, code.p, cfg.decoder.max_iters) == []


def test_step_differs_from_the_reference_in_one_slot_at_most(port, ref):
    # one frame flipping, as above, moves one slot; 32 frames give it ~0.3%
    # at the rate the card's checks saw (<= 1e-4 a frame)
    got, _ = port
    assert _slots_differing(got, ref) <= 1
    assert ref[1, 0] >= 1 and ref[4].sum() > S * B       # errors and iterations to compare


def test_a_bfloat16_reference_fails_the_tolerances(cfg, code, ref):
    bf = _ref(cfg, code, torch.bfloat16)
    outside = [_outside(bf[:, s], ref[:, s], code.n, code.p, cfg.decoder.max_iters)
               for s in range(S)]
    assert any(outside) or _slots_differing(bf, ref) > 1


def test_the_cpu_step_leaves_the_grid_counter_at_zero(port):
    _, counts = port
    assert counts["qspa_cluster.grid_blocks"] == counts["qspa_cluster.frame_slots"] == 0
    assert counts["qspa_resident_cl"] == counts["qspa_resident_cl_bf16"] == 0


def _each_edge_once(graph, code, plan):
    assert plan.size * plan.checks >= graph.m
    t = qr.cluster_tables(graph, plan)
    dc, E = graph.dc_max, graph.m * graph.dc_max
    info = t["edge_info"]
    real = info >= 0
    # the 510 edges on slots of dc 7: the 50 checks of degree 6 leave a pad each
    assert int(real.sum()) == code.edges == 510 and dc == 7
    slots = np.flatnonzero(real)
    assert np.array_equal(np.sort(slots), np.unique(slots)) and slots.max() < E
    assert np.array_equal(np.sort(graph.np["cn_vn"].reshape(-1)[slots]),
                          np.sort(code.edge_var))
    # each real edge is the source of one message row, of its variable's row
    src = t["row_src"].reshape(plan.size * plan.rows, graph.dv_max)
    rank, row = src >> 16, src & 0xFFFF
    edge = (rank * plan.checks * dc + row)[src >= 0]
    assert np.array_equal(np.sort(edge), slots)


def test_plan_cluster_spreads_the_code_over_eight_blocks_each_edge_once(graph, code):
    # buffered, the code takes 8 blocks; plan_cluster takes it in place (below)
    plan = qr.cluster_plan_at(graph, 8)
    assert (plan.size, plan.in_place) == (8, False)
    _each_edge_once(graph, code, plan)


def test_plan_cluster_takes_the_code_in_place_on_four_blocks_each_edge_once(graph, code):
    plan = qr.plan_cluster(graph)
    assert (plan.size, plan.in_place) == (4, True)
    _each_edge_once(graph, code, plan)


def test_grid_blocks_is_a_counter_of_the_program():
    _is_a_counter_of_the_program("grid_blocks")


def test_frame_slots_is_a_counter_of_the_program():
    _is_a_counter_of_the_program("frame_slots")


def _is_a_counter_of_the_program(counter):
    names = {name: (fn, attr) for name, fn, attr in counted()}
    assert names[f"qspa_cluster.{counter}"] == (qr.resident_decode_cl, counter)
    setattr(qr.resident_decode_cl, counter, 7)
    assert launch_counts()[f"qspa_cluster.{counter}"] == 7
    reset_launch_counts()
    assert launch_counts()[f"qspa_cluster.{counter}"] == 0


CLUSTER_KERNEL = "void (anonymous namespace)::qspa_cluster_kernel<256, float>(float const*)"


def _ctx(code, **over):
    counters = np.zeros((2, 6, 8), np.int64)
    counters[0, 4, 0], counters[1, 4, 0] = 13000, 13100          # iter_sum of each step
    ctx = {"kernels": {CLUSTER_KERNEL: [0.044, 2]}, "S": 8, "B": 512,
           "shape": bounds.shape_of(code), "counters": counters,
           "launches": {"qspa_resident_cl": 10, "qspa_resident_cl_bf16": 0,
                        "qspa_cluster.grid_blocks": 1200, "qspa_cluster.frame_slots": 300}}
    ctx.update(over)
    return ctx


def test_k0cl_roofline_on_a_hand_built_ctx(code):
    # bound by operations: a frame-iteration updates 510 edges at 10 q + 2 q
    # log2 q each and adds N q (dv + 2); the start 2 N q a frame; 67e12 ops/s
    per_iter = 510 * (10 * 256 + 2 * 256 * 8) + 255 * 256 * 4
    ms = sum(it * per_iter + 4096 * 2 * 255 * 256 for it in (13000, 13100)) / 67e12 * 1e3
    got = manifest.load_reader("k0cl_roofline")(_ctx(code))
    assert got == pytest.approx(100 * ms * 1e-3 / 0.044) and 3.2 < got < 3.3


@pytest.mark.parametrize("kernels", [
    {}, {"void (anonymous namespace)::qspa_resident_kernel<16, 4, 1, float>()": [1.0, 2]},
    {"void (anonymous namespace)::qspa_scratch_kernel<256, float>()": [1.0, 2]}],
    ids=["none", "k0", "scratch"])
def test_k0cl_roofline_is_none_without_the_cluster_kernel(code, kernels):
    assert manifest.load_reader("k0cl_roofline")(_ctx(code, kernels=kernels)) is None


@pytest.fixture
def card_of_132_sms(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))


def test_grid_sm_share_on_a_hand_built_ctx(code, card_of_132_sms):
    # 10 launches of 15 clusters of 8 blocks on 132 SMs
    got = manifest.load_reader("k0cl.grid_sm_share")(_ctx(code))
    assert got == pytest.approx(100 * 120 / 132)


@pytest.mark.parametrize("launches", [
    {"qspa_resident": 10},                                        # no counter: the parent
    {"qspa_resident_cl": 0, "qspa_resident_cl_bf16": 0, "qspa_cluster.grid_blocks": 0},
    {"qspa_resident_cl_scratch": 3, "qspa_cluster.grid_blocks": 0}],
    ids=["absent", "k0", "scratch"])
def test_grid_sm_share_is_none_without_a_cluster_launch(code, card_of_132_sms, launches):
    assert manifest.load_reader("k0cl.grid_sm_share")(_ctx(code, launches=launches)) is None


def test_grid_sm_share_is_none_without_a_card(code, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert manifest.load_reader("k0cl.grid_sm_share")(_ctx(code)) is None


def test_frames_in_flight_on_a_hand_built_ctx(code):
    # 10 launches of 30 clusters of 4 blocks, a frame a cluster
    assert manifest.load_reader("k0cl.frames_in_flight")(_ctx(code)) == 30
    # f32 and bf16 launches together: 4 of 30 clusters and 2 of 15 clusters
    mixed = _ctx(code, launches={"qspa_resident_cl": 4, "qspa_resident_cl_bf16": 2,
                                 "qspa_cluster.grid_blocks": 4 * 30 * 4 + 2 * 15 * 4,
                                 "qspa_cluster.frame_slots": 4 * 30 + 2 * 15})
    assert manifest.load_reader("k0cl.frames_in_flight")(mixed) == 25


@pytest.mark.parametrize("launches", [
    {"qspa_resident": 10},                                        # no counter: the parent
    {"qspa_resident_cl": 0, "qspa_resident_cl_bf16": 0, "qspa_cluster.frame_slots": 0},
    {"qspa_resident_cl_scratch": 3, "qspa_cluster.grid_blocks": 0,
     "qspa_cluster.frame_slots": 0}],
    ids=["absent", "k0", "scratch"])
def test_frames_in_flight_is_none_without_a_cluster_launch(code, launches):
    assert manifest.load_reader("k0cl.frames_in_flight")(_ctx(code, launches=launches)) is None
