"""One run of one benchmark cell on one card.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the program (nbldpc_tpu_torch), warms up a short sweep of the cell's
own configuration and traffic, then drives the program's
`sim.run_sweep` for `--seconds`: its host loop, its one counter fetch a
step, its stop rules and slot reallocation. The window opens at the
sweep's first `progress` call and closes at the first one past the
length; every step between is timed by those calls and its counters kept.
After the window the reference recomputes a sample of the window's steps,
drawn from the seed, and the comparison decides `correct`.

--trace 0 prints the cell's end-to-end metrics, --trace 1 runs
torch.profiler over the window and prints the per-layer metrics, the
device's busy and window seconds and a breakdown. The last line of
standard output is the result (JSON); the numbers compared, each beside
its limit, are the last lines of standard error and the result's last
key. Exit codes: 0 a result, 2 no card or no program, 3 JAX loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from portbench import bounds, check, manifest, reference, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "nbldpc_tpu")
COUNTERS = reference.COUNTERS


class WindowClosed(Exception):
    """Raised from the sweep's progress callback to end the window."""


class Window:
    """run_sweep's progress callback: opens the window at its first call,
    then keeps each step's counters [6, S] and generator index, and closes
    the window (WindowClosed) at the first call `seconds` past the opening
    with at least `min_steps` steps."""

    def __init__(self, seconds: float, min_steps: int = 2, profiler=None, sync=None):
        self.seconds, self.min_steps = seconds, min_steps
        self.profiler, self.sync = profiler, sync
        self.start = self.end = None
        self.prev, self.steps, self.indices = None, [], []
        self.launches = {}
        self.warm = (0.0, 0.0)         # the warm-up sweep's start and end

    def __call__(self, t: int, counters) -> None:
        snap = np.stack([np.asarray(getattr(counters, k), np.int64) for k in COUNTERS])
        if self.start is None:
            self.prev = snap
            self.launches = _launch_counts()
            if self.profiler is not None:
                self.profiler.start()
            self.start = time.perf_counter()
            return
        now = time.perf_counter()
        self.steps.append(snap - self.prev)
        self.prev = snap
        self.indices.append(t - 1)
        if now - self.start >= self.seconds and len(self.steps) >= self.min_steps:
            if self.profiler is not None:
                self.sync()
                self.profiler.stop()
            self.end = now
            self.launches = {k: v - self.launches.get(k, 0)
                             for k, v in _launch_counts().items()}
            raise WindowClosed

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def counters(self) -> np.ndarray:
        return np.stack(self.steps)                       # [steps, 6, S]


def _launch_counts() -> dict:
    from nbldpc_tpu_torch.kernels import launch_counts

    return launch_counts()


def forbidden_modules(modules=None) -> list:
    """The top-level module names in FORBIDDEN that `modules` (sys.modules)
    holds, each name compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def fix_caches() -> None:
    """Every build and kernel cache of the run at a fixed path inside the
    checkout (the program builds its CUDA library in build/nbldpc_tpu_torch
    there by itself)."""
    build = manifest.ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def sweep(cfg, device, window: Window | None = None):
    """run_sweep(cfg) on `device`, ended by `window` if one is given."""
    from nbldpc_tpu_torch.sim import run_sweep

    try:
        return run_sweep(cfg, device, progress=window)
    except WindowClosed:
        return None


def measure(cell, seed: int, seconds: float, device, profiler=None, frames=None,
            min_steps: int = 2, **decoder) -> Window:
    """Warm up, then one window of the cell's sweep; returns the Window."""
    import torch

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    warm = cell.workload["warm_steps"]
    t = time.perf_counter()
    sweep(traffic.run_config(cell, seed, frames, max_steps=warm, **decoder), device)
    sync()
    window = Window(seconds, min_steps, profiler, sync)
    window.warm = (t, time.perf_counter())
    sweep(traffic.run_config(cell, seed, frames, **decoder), device, window)
    if window.end is None:
        raise RuntimeError("the sweep ended before the window closed")
    return window


def sample_steps(window: Window, seed: int, k: int) -> list:
    """Positions in the window of k steps drawn from the seed."""
    rng = np.random.default_rng([int(seed), 1])
    n = len(window.steps)
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def reference_counters(cell, seed: int, indices: list, device, frames=None,
                       dtype=None) -> np.ndarray:
    """The reference's counters [k, 6, S] of the steps with these generator
    indices."""
    import torch

    rc, w = cell.config["run_config"], cell.workload
    dec = rc["decoder"]
    code = reference.load_code(cell.config["reference_code"])
    decoder = reference.Decoder(code, device, dec["kind"], dec["max_iters"],
                                offset=dec.get("offset", 0.0), n_r=dec.get("tems_nr", 0),
                                dtype=dtype or torch.float32)
    B = frames or rc["sim"]["frames_per_step"]
    block = min(w["reference_block"], B * len(w["ebn0_db"]))
    return np.stack([reference.step_counters(code, decoder, seed, t, w["ebn0_db"], B, block)
                     for t in indices])


def per_layer(cell, window: Window, red: dict, frames=None) -> dict:
    """{metric: {"value", "unit"}} of the cell's per-layer metrics that their
    readers find something to read for."""
    rc = cell.config["run_config"]
    code = reference.load_code(cell.config["reference_code"])
    ctx = {**red, "window_s": window.window_s, "steps": len(window.steps),
           "S": len(cell.workload["ebn0_db"]), "B": frames or rc["sim"]["frames_per_step"],
           "shape": bounds.shape_of(code), "decoder": rc["decoder"],
           "counters": window.counters(), "launches": window.launches}
    out = {}
    for m in cell.per_layer:
        value = manifest.load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t0: float,
             frames=None, check_steps=None) -> dict:
    """One run of `cell`: the result's keys (correct, attempted, failed,
    metrics, device, breakdown with a trace, checks) and `window` (steps,
    frames, seconds) for the line before it."""
    import torch

    on_card = device.type == "cuda"
    if on_card:
        torch.empty(1, device=device)          # the CUDA context, before the warm-up
    profiler = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        profiler = profile(activities=acts)
    window = measure(cell, seed, seconds, device, profiler, frames)
    setup_s = window.start - t0
    w0, w1 = window.warm
    parts = {"to_warm_up": w0 - t0, "warm_up": w1 - w0, "window_sweep_start": window.start - w1}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    S = len(cell.workload["ebn0_db"])
    B = frames or cell.config["run_config"]["sim"]["frames_per_step"]
    code = reference.load_code(cell.config["reference_code"])
    n_frames = int(window.counters()[:, 0].sum())
    info = {"steps": len(window.steps), "frames": n_frames, "window_s": window.window_s,
            "frames_per_step": S * B, "setup_s": setup_s, "setup_parts": parts}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": len(window.steps), "failed": 0}
    if traced:
        red = trace.reduce(profiler.events())
        del profiler
        result["metrics"] = per_layer(cell, window, red, frames)
        dev.update(busy_s=red["busy_s"], window_s=window.window_s)
        result["device"] = dev
        result["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    else:
        values = {"symbols_per_s": n_frames * code.n / window.window_s, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = dev
    if on_card:
        torch.cuda.empty_cache()
    k = cell.workload["check_steps"] if check_steps is None else check_steps
    pos = sample_steps(window, seed, k)
    prog = window.counters()[pos]
    t_ref = time.perf_counter()
    ref = reference_counters(cell, seed, [window.indices[i] for i in pos], device, frames)
    info["reference_s"] = time.perf_counter() - t_ref
    correct, table = check.judge(check.numbers(prog, ref), cell.limits)
    result["correct"] = correct and len(pos) > 0
    result["checks"] = table
    info["checked_steps"] = [window.indices[i] for i in pos]
    return {"result": result, "window": info}


def card_power() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t0 = time.perf_counter()
    args = parse(argv)
    fix_caches()
    import torch

    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    try:
        import nbldpc_tpu_torch.sim  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded in the run: {found}", file=sys.stderr)
        return 3
    result = out["result"]
    print(json.dumps({"workload": args.workload, "seed": args.seed, "card": card_power(),
                      **out["window"]}), flush=True)
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
