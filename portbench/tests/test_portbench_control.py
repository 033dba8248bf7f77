"""The control on the card, at each cell's own size: the reference in the
program's place one precision below the configuration's f32 (QSPA: the
program's own bf16 path, K0 with mm_precision="bf16"; T-EMS, which has
none: the reference in bfloat16) fails the cell's limits on three seeds,
where the program passes them.

    python3 -m pytest portbench/tests/test_portbench_control.py -q -m cuda
"""

import pytest
import torch

from portbench import calibrate, check, manifest, run

CELLS = ["gf16_qspa.waterfall", "gf64_tems.waterfall"]
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    run.fix_caches()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(cuda_device, name):
    cell = manifest.load_cell(name)
    for seed in SEEDS:
        prog, ctrl = calibrate.readings(cell, seed, 3.0, cuda_device, control=True)
        vals = lambda r: {k: r[k] for k in check.NUMBERS}
        assert check.judge(vals(prog), cell.limits)[0], prog
        assert not check.judge(vals(ctrl), cell.limits)[0], ctrl
