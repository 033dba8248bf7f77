"""A whole run on the CPU at a tiny size (the program's plain paths; the
look for a card skipped), sound and with the timed path broken underneath
(faults.py): the sound run is correct, and each fault a cell can have
makes `correct` false."""

import contextlib
import time

import pytest
import torch

from portbench import faults, manifest, run

CELLS = ["gf16_qspa.waterfall", "gf64_tems.waterfall"]
FRAMES = 4


def _run(cell, fault=None):
    torch.set_num_threads(4)
    with (faults.planted(fault, len(cell.workload["ebn0_db"])) if fault
          else contextlib.nullcontext()):
        out = run.run_cell(cell, 2**31 + 101, 0.01, False, torch.device("cpu"),
                           time.perf_counter(), frames=FRAMES, check_steps=2)
    return out["result"]


@pytest.fixture(params=CELLS)
def cell(request):
    return manifest.load_cell(request.param)


def test_a_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 2 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_fault_makes_the_run_incorrect(cell, fault):
    res = _run(cell, fault)
    assert not res["correct"], res["checks"]
