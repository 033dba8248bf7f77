"""The one generator of the benchmark's traffic: a cell's sweep, as the
program's RunConfig, from its configuration and workload files.

The traffic of a cell is the Eb/N0 point of each SNR slot of the step
(workloads/<cell>.json "ebn0_db"): the sweep decodes frames_per_step frames
at each slot every step, all-zero codewords under AWGN, the noise drawn
from (seed, step index). The stop rules of the configuration lie beyond any
window (configs/<config>.json), so no slot is reallocated inside one.
"""

from __future__ import annotations

import dataclasses


def run_config(cell, seed: int, frames: int | None = None, max_steps: int | None = None,
               **decoder):
    """The program's RunConfig of `cell` at `seed`. frames: frames a slot
    instead of the configuration's (the CPU tests' small runs); max_steps:
    stop after that many steps (the warm-up); decoder: DecoderConfig fields
    to replace (the control's precision)."""
    from nbldpc_tpu_torch.utils.config import (ChannelConfig, CodeConfig, DecoderConfig,
                                               RunConfig, SimConfig)

    rc = cell.config["run_config"]
    sim = dict(rc["sim"], seed=int(seed))
    if frames is not None:
        sim["frames_per_step"] = int(frames)
    if max_steps is not None:
        sim["max_frames"] = int(max_steps) * sim["frames_per_step"]
    channel = dict(rc["channel"], ebn0_db=tuple(cell.workload["ebn0_db"]))
    return RunConfig(code=CodeConfig(**rc["code"]),
                     decoder=dataclasses.replace(DecoderConfig(**rc["decoder"]), **decoder),
                     channel=ChannelConfig(**channel), sim=SimConfig(**sim))

