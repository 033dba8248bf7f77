"""The readings that the limits of `correct` are set from, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 4 \
        [--control] [--fault unchanged|half|altered]

For each seed: one window of the cell (warm-up included), a sample of its
steps drawn from the seed as a run draws it, and the numbers of
check.numbers against the reference (one JSON line, "kind": "program").
With --control, the same for the control: the program's own bf16 path
where the configuration's decoder has one (QSPA's resident kernel,
mm_precision="bf16"), else the reference computed in bfloat16 on the same
steps ("kind": "control"). With --fault, the program's numbers with that
fault (faults.py) planted under the timed path ("kind": "fault:<name>").
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

from portbench import check, faults, manifest, run


def readings(cell, seed: int, seconds: float, device, control: bool, frames=None,
             check_steps=None, fault=None) -> list:
    """The program's numbers for `seed` (with `fault` planted, if given)
    and, with `control`, the control's."""
    import torch

    k = cell.workload["check_steps"] if check_steps is None else check_steps
    with (faults.planted(fault, len(cell.workload["ebn0_db"])) if fault
          else contextlib.nullcontext()):
        window = run.measure(cell, seed, seconds, device, frames=frames)
    pos = run.sample_steps(window, seed, k)
    idx = [window.indices[i] for i in pos]
    ref = run.reference_counters(cell, seed, idx, device, frames)
    out = [{"kind": f"fault:{fault}" if fault else "program", "seed": seed, "steps": idx,
            **check.numbers(window.counters()[pos], ref)}]
    if not control:
        return out
    if cell.config["run_config"]["decoder"]["kind"] == "qspa":
        w = run.measure(cell, seed, seconds, device, frames=frames, mm_precision="bf16")
        pos = run.sample_steps(w, seed, k)
        idx = [w.indices[i] for i in pos]
        got = w.counters()[pos]
        ref = run.reference_counters(cell, seed, idx, device, frames)
        how = "program, mm_precision bf16"
    else:
        got = run.reference_counters(cell, seed, idx, device, frames, dtype=torch.bfloat16)
        how = "reference in bfloat16"
    out.append({"kind": "control", "how": how, "seed": seed, "steps": idx,
                **check.numbers(got, ref)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=faults.FAULTS)
    args = ap.parse_args(argv)
    run.fix_caches()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("calibrate needs a CUDA device")
    cell = manifest.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for rec in readings(cell, seed, args.seconds, device, args.control,
                            fault=args.fault):
            print(json.dumps({"workload": cell.name, **rec,
                              "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
