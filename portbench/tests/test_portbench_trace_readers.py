"""The readers of the program's spans and layer counters (sweep.host_share,
sweep.idle_share, step.idle_share, decode_bl.idle_share,
decode_bl.loop_useful_share): each on a hand-built ctx, and on a tiny
traced run on the CPU through run_cell (no device, so no idle gaps)."""

import time

import numpy as np
import pytest
import torch

from portbench import manifest, run

NEW = ("sweep.host_share", "sweep.idle_share", "step.idle_share", "decode_bl.idle_share",
       "decode_bl.loop_useful_share")
IDLE = ("sweep.idle_share", "step.idle_share", "decode_bl.idle_share")


def _ctx(**over):
    counters = np.zeros((2, 6, 4), np.int64)
    counters[:, 4] = 10                                  # iter_sum: 80 in all
    ctx = {"window_s": 2.0, "counters": counters, "S": 4, "B": 4,
           "launches": {"cn_tems": 10, "sweep.loop_ns": 100_000_000,
                        "decode_bl.loop_iterations": 10, "decode_bl.frame_iterations": 16 * 10},
           "idle_gaps": [["host code", 0.5], ["cudaStreamSynchronize", 0.3],
                         ["decode_bl.sync", 0.06], ["step.channel", 0.04],
                         ["sweep.fetch", 0.02], ["decode_bl.route_down", 0.02],
                         ["sweep.plan", 0.01], ["sweep_like", 1.0], ["step", 1.0]]}
    ctx.update(over)
    return ctx


@pytest.mark.parametrize("name,value", [
    ("sweep.host_share", 5.0),               # 0.1 s of 2
    ("sweep.idle_share", 1.5),               # 0.03 s
    ("step.idle_share", 2.0),                # 0.04 s
    ("decode_bl.idle_share", 4.0),           # 0.08 s
    ("decode_bl.loop_useful_share", 50.0),   # 80 of 160
])
def test_reader_on_a_hand_built_ctx(name, value):
    assert manifest.load_reader(name)(_ctx()) == pytest.approx(value)


def test_the_counted_useful_share_equals_the_inferred_one():
    ctx = _ctx()
    counted = manifest.load_reader("decode_bl.loop_useful_share")(ctx)
    assert counted == pytest.approx(manifest.load_reader("decode_bl.useful_share")(ctx))


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_counters_reads_none(name):
    # the parent's registry: kernel counters alone; its gaps carry no span
    ctx = _ctx(launches={"cn_tems": 10}, idle_gaps=[["host code", 0.5]])
    assert manifest.load_reader(name)(ctx) is None


@pytest.mark.parametrize("name", IDLE)
def test_a_run_without_idle_gaps_reads_none(name):
    assert manifest.load_reader(name)(_ctx(idle_gaps=[])) is None


@pytest.mark.parametrize("name", ["decode_bl.idle_share", "decode_bl.loop_useful_share"])
def test_a_path_without_decode_bl_reads_none(name):
    # K0's path: the sweep's counter moves, decode_bl's loop never runs
    launches = {"qspa_resident": 10, "sweep.loop_ns": 100_000_000,
                "decode_bl.loop_iterations": 0, "decode_bl.frame_iterations": 0}
    assert manifest.load_reader(name)(_ctx(launches=launches)) is None


@pytest.mark.parametrize("name", ["sweep.idle_share", "step.idle_share"])
def test_spans_with_no_gap_in_the_top_ten_read_zero(name):
    assert manifest.load_reader(name)(_ctx(idle_gaps=[["host code", 0.5]])) == 0.0


@pytest.mark.parametrize("cell_name", ["gf16_qspa.waterfall", "gf64_tems.waterfall"])
def test_a_traced_cpu_run_reads_the_counters(cell_name):
    torch.set_num_threads(4)
    cell = manifest.load_cell(cell_name)
    out = run.run_cell(cell, 2**31 + 303, 0.01, True, torch.device("cpu"),
                       time.perf_counter(), frames=4, check_steps=1)
    metrics = out["result"]["metrics"]
    reports = {m["name"] for m in cell.per_layer}
    assert {"sweep.host_share", "sweep.idle_share", "step.idle_share"} <= reports
    share = metrics["sweep.host_share"]["value"]
    assert 0 < share < 100 and metrics["sweep.host_share"]["unit"] == "%"
    # the CPU has no device ops, so no idle gaps to read
    assert not set(IDLE) & set(metrics)
    if "decode_bl.loop_useful_share" in reports:
        useful = metrics["decode_bl.loop_useful_share"]["value"]
        assert 0 < useful <= 100
    else:
        assert "decode_bl.loop_useful_share" not in metrics
