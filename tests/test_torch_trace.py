"""The port's spans (utils/trace.py) and its layer counters, on the CPU:
tiny sweeps through QSPA and T-EMS, both in decode_bl's plain path. No JAX
is imported."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbldpc_tpu_torch import sim
from nbldpc_tpu_torch.decoders import qspa
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import launch_counts, reset_launch_counts
from nbldpc_tpu_torch.utils import config as tcfg
from nbldpc_tpu_torch.utils import trace

torch.set_num_threads(2)

SWEEP_SPANS = ("sweep.plan", "sweep.generator", "sweep.fetch", "sweep.account",
               "sweep.checkpoint")
STEP_SPANS = ("step.noise", "step.channel", "step.decode", "step.count")
DECODE_BL_SPANS = ("decode_bl.entry", "decode_bl.sync", "decode_bl.route_down",
                   "decode_bl.cn_update", "decode_bl.route_up", "decode_bl.syndrome")
SPANS = SWEEP_SPANS + STEP_SPANS + DECODE_BL_SPANS
COUNTERS = ("sweep.loop_ns", "decode_bl.loop_iterations", "decode_bl.frame_iterations",
            "cn_tems.frame_iterations", "qspa_cluster.grid_blocks", "qspa_cluster.frame_slots")
S, B, STEPS = 2, 8, 3
DECODERS = {"qspa": tcfg.DecoderConfig(kind="qspa", max_iters=6),
            "tems": tcfg.DecoderConfig(kind="tems", max_iters=6, offset=0.5, tems_nr=2)}


def _cfg(kind):
    return tcfg.RunConfig(
        code=tcfg.CodeConfig(name="gf4_n96_k48"), decoder=DECODERS[kind],
        channel=tcfg.ChannelConfig(ebn0_db=(0.5, 1.5)),
        sim=tcfg.SimConfig(frames_per_step=B, max_frames=STEPS * B,
                           max_frame_errors=10**9, seed=2**31 + 7))


@pytest.fixture(params=list(DECODERS))
def kind(request):
    return request.param


def _sweep(kind, monkeypatch, progress=None):
    """run_sweep of the tiny config with counters zeroed first; returns the
    result and the largest `iters` of each step's decode."""
    largest = []
    get_decode_fn = sim.get_decode_fn

    def recording(dec, cn_impl="auto"):
        fn = get_decode_fn(dec, cn_impl)

        def decode(graph, llr):
            res = fn(graph, llr)
            largest.append(int(res.iters.max()))
            return res
        return decode

    monkeypatch.setattr(sim, "get_decode_fn", recording)
    reset_launch_counts()
    return sim.run_sweep(_cfg(kind), torch.device("cpu"), progress), largest


def test_spans_are_cpu_ops_nested_in_their_layer(kind, monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res, _ = _sweep(kind, monkeypatch)
    events = [e for e in prof.events() if e.name in SPANS]
    assert {e.name for e in events} == set(SPANS)
    assert not [e for e in events if e.is_user_annotation]
    assert {e.device_type for e in events} == {torch.autograd.DeviceType.CPU}
    by_name = {n: [e.time_range for e in events if e.name == n] for n in SPANS}
    assert res.steps == STEPS
    assert len(by_name["sweep.fetch"]) == len(by_name["step.decode"]) == STEPS
    # every decode_bl span lies inside one step.decode, no step or sweep
    # span inside another
    for name in DECODE_BL_SPANS:
        for r in by_name[name]:
            assert sum(d.start <= r.start and r.end <= d.end
                       for d in by_name["step.decode"]) == 1, name
    outer = [(n, r) for n in SWEEP_SPANS + STEP_SPANS for r in by_name[n]]
    for n, r in outer:
        assert not [m for m, o in outer if o is not r and o.start <= r.start
                    and r.end <= o.end], n


def test_counters(kind, monkeypatch):
    t0 = time.perf_counter_ns()
    res, largest = _sweep(kind, monkeypatch)
    wall = time.perf_counter_ns() - t0
    got = launch_counts()
    assert len(largest) == res.steps == STEPS and sum(largest) > 0
    assert got["decode_bl.loop_iterations"] == sum(largest)
    assert got["decode_bl.frame_iterations"] == S * B * sum(largest)
    assert 0 < got["sweep.loop_ns"] < wall
    # the frame-iterations the frames needed, within those the loop ran
    assert 0 < int(res.counters.iter_sum.sum()) <= got["decode_bl.frame_iterations"]
    reset_launch_counts()
    assert {k: launch_counts()[k] for k in COUNTERS} == dict.fromkeys(COUNTERS, 0)


def test_the_counters_join_the_registry_under_dotted_names():
    names = list(launch_counts())
    assert [n for n in names if "." in n] == list(COUNTERS)


def test_step_counters_alone_leaves_the_loop_counter():
    g = TannerGraph(tcfg.CodeConfig(name="gf4_n96_k48").load(), "cpu")
    step = sim.make_sim_step(g, DECODERS["qspa"], B, S)
    reset_launch_counts()
    sim.step_counters(step, sim.step_generator(3, 0, g.device),
                      torch.tensor([0.9, 0.8]))
    got = launch_counts()
    assert got["sweep.loop_ns"] == 0 and got["decode_bl.loop_iterations"] > 0


def test_the_q_last_decode_moves_no_counter():
    g = TannerGraph(tcfg.CodeConfig(name="gf4_n96_k48").load(), "cpu")
    llr = torch.randn(4, g.n, g.q)
    reset_launch_counts()
    qspa.decode(g, llr, 3, early_term=False, batch_last=False)
    assert not any(launch_counts().values())


class _Counting:
    """Stands in for _RecordFunctionFast: counts entries and exits."""

    entered = exited = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Counting.entered += 1

    def __exit__(self, *exc):
        _Counting.exited += 1


@pytest.fixture
def counting(monkeypatch):
    _Counting.entered = _Counting.exited = 0
    monkeypatch.setattr(trace, "_RecordFunctionFast", _Counting)
    return _Counting


def test_no_profiler_enters_no_op(kind, monkeypatch, counting):
    _sweep(kind, monkeypatch)
    assert counting.entered == counting.exited == 0
    with profile(activities=[ProfilerActivity.CPU]):
        _sweep(kind, monkeypatch)
    assert counting.entered == counting.exited > 0


class _Stop(Exception):
    pass


def test_a_raising_progress_closes_every_span(kind, monkeypatch, counting):
    monkeypatch.setattr(trace, "_recording", lambda: True)

    def progress(t, counters):
        if t == 2:
            raise _Stop

    with pytest.raises(_Stop):
        _sweep(kind, monkeypatch, progress)
    assert counting.entered == counting.exited > 0
    # the loop's own time stops at the raise: plan, generator and account
    # of two steps
    assert launch_counts()["sweep.loop_ns"] > 0


def test_a_profiler_may_start_or_stop_inside_an_open_span():
    prof = profile(activities=[ProfilerActivity.CPU])
    with trace.span("x.outer"):
        prof.start()
        with trace.span("x.inner"):
            torch.ones(2) + 1
    prof.stop()
    assert {e.name for e in prof.events()} >= {"x.inner"}
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with trace.span("x.outer"):
        torch.ones(2) + 1
        prof.stop()
    assert "x.outer" in {e.name for e in prof.events()}


def test_span_adds_its_nanoseconds_to_its_counter():
    class Owner:
        ns = 5

    with trace.span("x.y", (Owner, "ns")):
        time.sleep(0.002)
    assert Owner.ns >= 5 + 2_000_000
    with pytest.raises(ValueError):
        with trace.span("x.y", (Owner, "ns")):
            raise ValueError
    assert Owner.ns >= 5 + 2_000_000
