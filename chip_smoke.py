"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order, each printing one JSON line (any failure exits non-zero):
  1. device   - card name, power limit and compute capability (9, 0)
  2. build    - nvcc builds csrc/*.cu into build/nbldpc_tpu_torch/
  3. cn_qspa  - the check-node kernel against its plain version
  4. resident - the whole-decode kernel against its plain version, also at
                the main path's shape and mode
  5. cn_ems   - the EMS check-node kernels (classic and bubble) against
                their plain version, exact to 0.0
  6. ems_resident - the whole-decode EMS kernel against its plain version,
                in the modes of phase 4 and at nm = 8; agreement 1.0
  7. cn_tems  - the T-EMS check-node kernel against its plain version at
                GF(16), GF(64) (BASELINE config 4's shape, exact scan and
                n_r = 8) and GF(256), exact to 0.0
  8. main     - `nbldpc_tpu_torch.cli.main(["run", ...])` at the flagship
                config plus a GF(64) run (the check-node kernel's path),
                with every launch counter read around it; FER held to the
                JAX package's recorded statistics
  9. main_ems - `cli.main(["run", ...])` on the three EMS paths: GF(16) EMS
                (resident kernel), GF(256) classic and bubble EMS (check-node
                kernels), each held to its JAX FER record
 10. main_tems - `cli.main(["run", ...])` on BASELINE config 4
                (configs/gf64_tems_earlyterm.json, 1024 frames per step):
                path D at its n_r = 8, path E with the exact scan, each
                held to its JAX FER record
 11. bench    - sim-step throughput, kernel paths and plain torch paths,
                QSPA, EMS and T-EMS
Then the kernels summary, the card line, and the final status line.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def two_prop_z(k1: int, n1: int, k2: int, n2: int) -> float:
    p = (k1 + k2) / (n1 + n2)
    se = math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    return 0.0 if se == 0 else (k1 / n1 - k2 / n2) / se


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "card": card, "capability": list(cap),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if tuple(cap) != (9, 0):
        fail(f"compute capability {cap}, expected (9, 0)")
    return card.splitlines()[0]


def phase_build():
    from nbldpc_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(path.relative_to(ROOT))})


def _graph(code: str, device):
    from nbldpc_tpu_torch.graph import TannerGraph
    from nbldpc_tpu_torch.utils.config import CodeConfig

    return TannerGraph(CodeConfig(name=code).load(), device=device)


def _u_for(g, B: int, device):
    """Check-node inputs with the code's real pad structure, from a seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    Vv = torch.from_numpy(
        (rng.standard_normal((g.n, g.dv_max, g.q, B)) * 3.0).astype(np.float32)
    ).to(device)
    return g.gather_cn_x_bl(Vv).contiguous()


def phase_cn_qspa(device, main_b64: int):
    """K1 at the flagship shape, the GF(64) main-path shape and GF(256)."""
    import torch

    from nbldpc_tpu_torch.kernels import cn_qspa

    rows = []
    for code, B in (("gf16_n204_k102_c8", 8192), ("gf64_n576_k480", main_b64),
                    ("gf256_n255_k175", 256)):
        g = _graph(code, device)
        U = _u_for(g, B, device)
        out = cn_qspa.cn_update(U)
        ref = cn_qspa.cn_update_plain(U)
        torch.cuda.synchronize()
        real = g.cn_mask[:, :, None, None].expand_as(ref)
        diff = (out - ref).abs()
        head = real & (ref > -15)
        tail = real & (ref <= -15)
        err = float(diff[head].max())
        tail_err = float(diff[tail].max()) if bool(tail.any()) else 0.0
        finite = bool(torch.isfinite(out[real]).all())
        plain1 = cuda_ms(lambda: cn_qspa.cn_update_plain(U), 5)
        k1 = cuda_ms(lambda: cn_qspa.cn_update(U), 20)
        k2 = cuda_ms(lambda: cn_qspa.cn_update(U), 20)
        plain2 = cuda_ms(lambda: cn_qspa.cn_update_plain(U), 5)
        row = {"phase": "cn_qspa", "shape": list(U.shape),
               "max_abs_err_above_-15": err, "max_abs_err_tail": tail_err,
               "ms": (k1 + k2) / 2, "plain_ms": (plain1 + plain2) / 2,
               "ms_runs": [k1, k2], "plain_ms_runs": [plain1, plain2]}
        emit(row)
        if not finite:
            fail(f"cn_qspa {list(U.shape)}: non-finite outputs")
        if not err <= 1e-4:
            fail(f"cn_qspa {list(U.shape)}: max abs err {err} > 1e-4")
        rows.append(row)
    return rows


def _llrs(g, frames_per_snr: int, snrs, device):
    """All-zero-codeword LLRs [S * frames, N, q] at the given Eb/N0 points."""
    import torch

    from nbldpc_tpu_torch.channel import ebn0_to_sigma, llr_init
    from nbldpc_tpu_torch.sim import step_generator

    sig = torch.tensor([float(ebn0_to_sigma(s, g.spec.k / g.n)) for s in snrs],
                       device=device).repeat_interleave(frames_per_snr)[:, None, None]
    gen = step_generator(1234, len(snrs), device)
    y = 1.0 + sig * torch.randn((sig.shape[0], g.n, g.gf.p), generator=gen,
                                device=device)
    return llr_init(y, sig, g.q).contiguous()


def phase_resident(device):
    """K0 against its plain version on identical LLRs: the three modes at
    2048 frames, then the main path's shape and mode (2 x 8192 frames at
    1.5 and 2.0 dB, 50 iterations, early termination), where it is timed."""
    import torch

    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    g = _graph("gf16_n204_k102_c8", device)
    small, main = _llrs(g, 2048, [1.5], device), _llrs(g, 8192, [1.5, 2.0], device)
    modes = {"a_early_term": (small, 50, True, True),
             "b_throughput": (small, 50, False, False),
             "c_one_iter": (small, 1, False, True),
             "d_main_path": (main, 50, True, True)}
    worst = 0
    result = {}
    for name, (llr, iters, et, stats) in modes.items():
        B = llr.shape[0]
        dec = qr.ResidentQSPA(g, iters, et, stats)
        hk, dk, ik = qr.resident_decode(dec, llr)
        hp, dp, ip = qr.decode_plain(dec, llr)
        torch.cuda.synchronize()
        same = (hk == hp).all(dim=1) & (dk == dp) & (ik == ip)
        agree = float(same.float().mean())
        fe_k = int((hk != 0).any(dim=1).sum())
        fe_p = int((hp != 0).any(dim=1).sum())
        z = two_prop_z(fe_k, B, fe_p, B)
        rec = {"phase": "resident", "mode": name, "frames": B, "agreement": agree,
               "frame_errors_kernel": fe_k, "frame_errors_plain": fe_p, "z": z}
        if name == "c_one_iter":
            worst = max(int((hk - hp).abs().max()), int((ik - ip).abs().max()),
                        int((dk != dp).sum() > 0))
            if agree < 0.999:
                emit(rec)
                fail(f"resident mode {name}: agreement {agree} < 0.999")
        elif agree < 0.995 or abs(z) >= 3:
            emit(rec)
            fail(f"resident mode {name}: agreement {agree}, z {z}")
        if name in ("b_throughput", "d_main_path"):
            p1 = cuda_ms(lambda: qr.decode_plain(dec, llr), 1)
            k1 = cuda_ms(lambda: qr.resident_decode(dec, llr), 5)
            k2 = cuda_ms(lambda: qr.resident_decode(dec, llr), 5)
            p2 = cuda_ms(lambda: qr.decode_plain(dec, llr), 1)
            rec.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                       ms_runs=[k1, k2], plain_ms_runs=[p1, p2])
            result.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
        emit(rec)
    result["max_abs_err"] = worst
    return result


def _hold_cn(phase: str, device, code: str, B: int, kern, plain, args, **label) -> dict:
    """A check-node kernel against its plain version on the same U, timed
    plain, kernel, kernel, plain: max abs error must be 0.0 and every output
    finite."""
    import torch

    U = _u_for(_graph(code, device), B, device)
    out = kern(U, *args)
    ref = plain(U, *args)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    finite = bool(torch.isfinite(out).all())
    p1 = cuda_ms(lambda: plain(U, *args), 1)
    k1 = cuda_ms(lambda: kern(U, *args), 10)
    k2 = cuda_ms(lambda: kern(U, *args), 10)
    p2 = cuda_ms(lambda: plain(U, *args), 1)
    row = {"phase": phase, **label, "shape": list(U.shape), "max_abs_err": err,
           "finite": finite, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}
    emit(row)
    if not finite:
        fail(f"{phase} {label} {list(U.shape)}: non-finite outputs")
    if err != 0.0:
        fail(f"{phase} {label} {list(U.shape)}: max abs err {err} != 0.0")
    return row


def phase_cn_ems(device):
    """K2 (classic) and K2b (bubble) against their plain versions."""
    from nbldpc_tpu_torch.kernels import cn_ems

    classic = (cn_ems.cn_update, cn_ems.cn_update_plain)
    bubble = (cn_ems.cn_update_bubble, cn_ems.cn_update_bubble_plain)
    cases = [("gf16_n204_k102", 8192, "classic", classic, 16, 0.3),
             ("gf64_n576_k480", 1024, "classic", classic, 8, 0.1),
             ("gf64_n576_k480", 1024, "bubble", bubble, 8, 0.0),
             ("gf256_n255_k175", 512, "classic", classic, 16, 0.1),
             ("gf256_n255_k175", 512, "bubble", bubble, 16, 0.0)]
    rows = {}
    for code, B, merge, (kern, plain), nm, offset in cases:
        rows.setdefault(merge, []).append(_hold_cn(
            "cn_ems", device, code, B, kern, plain, (nm, offset),
            merge=merge, nm=nm, offset=offset))
    return rows


def phase_ems_resident(device):
    """K3 against its plain version on identical LLRs (gf16_n204_k102,
    offset 0.3): nm = 16 in the three modes at 2048 frames and at the main
    path's shape (2 x 8192 frames, 1.5 and 2.0 dB, 50 iterations, early
    termination), then nm = 8; agreement must be 1.0."""
    import torch

    from nbldpc_tpu_torch.kernels import ems_resident as er

    g = _graph("gf16_n204_k102", device)
    small, main = _llrs(g, 2048, [1.5], device), _llrs(g, 8192, [1.5, 2.0], device)
    modes = {"a_early_term": (small, 50, True, True, 16),
             "b_throughput": (small, 50, False, False, 16),
             "c_one_iter": (small, 1, False, True, 16),
             "d_main_path": (main, 50, True, True, 16),
             "e_nm8": (small, 50, True, True, 8)}
    worst = 0
    result = {}
    for name, (llr, iters, et, stats, nm) in modes.items():
        B = llr.shape[0]
        dec = er.ResidentEMS(g, iters, nm, 0.3, et, stats)
        hk, dk, ik = er.resident_decode(dec, llr)
        hp, dp, ip = er.decode_plain(dec, llr)
        torch.cuda.synchronize()
        same = (hk == hp).all(dim=1) & (dk == dp) & (ik == ip)
        agree = float(same.float().mean())
        worst = max(worst, int((hk - hp).abs().max()), int((ik - ip).abs().max()),
                    int((dk != dp).any()))
        fe_k = int((hk != 0).any(dim=1).sum())
        fe_p = int((hp != 0).any(dim=1).sum())
        rec = {"phase": "ems_resident", "mode": name, "nm": nm, "frames": B,
               "agreement": agree, "frame_errors_kernel": fe_k,
               "frame_errors_plain": fe_p}
        if name in ("b_throughput", "d_main_path"):
            p1 = cuda_ms(lambda: er.decode_plain(dec, llr), 1)
            k1 = cuda_ms(lambda: er.resident_decode(dec, llr), 5)
            k2 = cuda_ms(lambda: er.resident_decode(dec, llr), 5)
            p2 = cuda_ms(lambda: er.decode_plain(dec, llr), 1)
            rec.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                       ms_runs=[k1, k2], plain_ms_runs=[p1, p2])
            result.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
        emit(rec)
        if agree != 1.0:
            fail(f"ems_resident mode {name}: agreement {agree} != 1.0")
    result["max_abs_err"] = worst
    return result


def phase_cn_tems(device):
    """K5 against its plain version (offset 2.0, config 4's) at GF(16),
    config 4's shape with the exact scan and n_r = 8, and GF(256)."""
    from nbldpc_tpu_torch.kernels import cn_tems

    cases = [("gf16_n204_k102", 8192, 0), ("gf64_n576_k480", 1024, 0),
             ("gf64_n576_k480", 1024, 8), ("gf256_n255_k175", 512, 8)]
    return [_hold_cn("cn_tems", device, code, B, cn_tems.cn_update,
                     cn_tems.cn_update_plain, (2.0, n_r), n_r=n_r, offset=2.0)
            for code, B, n_r in cases]


def _counted():
    """(name, function, attribute) of every kernel wrapper and plain version."""
    from nbldpc_tpu_torch.kernels import cn_ems, cn_qspa, cn_tems
    from nbldpc_tpu_torch.kernels import ems_resident as er
    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    return [("qspa_resident", qr.resident_decode, "launches"),
            ("qspa_resident_plain", qr.decode_plain, "calls"),
            ("cn_qspa", cn_qspa.cn_update, "launches"),
            ("cn_qspa_plain", cn_qspa.cn_update_plain, "calls"),
            ("ems_resident", er.resident_decode, "launches"),
            ("ems_resident_plain", er.decode_plain, "calls"),
            ("cn_ems", cn_ems.cn_update, "launches"),
            ("cn_ems_plain", cn_ems.cn_update_plain, "calls"),
            ("cn_ems_bubble", cn_ems.cn_update_bubble, "launches"),
            ("cn_ems_bubble_plain", cn_ems.cn_update_bubble_plain, "calls"),
            ("cn_tems", cn_tems.cn_update, "launches"),
            ("cn_tems_plain", cn_tems.cn_update_plain, "calls")]


def _counters():
    return {name: getattr(fn, attr) for name, fn, attr in _counted()}


def _reset_counters():
    for _, fn, attr in _counted():
        setattr(fn, attr, 0)


def phase_main(main_b64: int):
    """The user's entry point, flagship config; then a GF(64) run."""
    from nbldpc_tpu_torch import cli

    out_dir = ROOT / "build" / "nbldpc_tpu_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    rep16, rep64 = out_dir / "smoke_gf16.json", out_dir / "smoke_gf64.json"
    _reset_counters()
    t0 = time.perf_counter()
    rc16 = cli.main(["run", "--code", "gf16_n204_k102_c8", "--decoder", "qspa",
                     "--snr", "1.5", "2.0", "--iters", "50",
                     "--set", "sim.frames_per_step=8192",
                     "--set", "sim.max_frames=16384",
                     "--set", "sim.max_frame_errors=1000000",
                     "--report", str(rep16)])
    t16 = time.perf_counter() - t0
    rc64 = cli.main(["run", "--code", "gf64_n576_k480", "--decoder", "qspa",
                     "--snr", "3.0", "--iters", "10",
                     "--set", f"sim.frames_per_step={main_b64}",
                     "--set", f"sim.max_frames={main_b64}",
                     "--report", str(rep64)])
    counts = _counters()
    r16 = json.loads(rep16.read_text())
    r64 = json.loads(rep64.read_text())
    ref = next(e for e in json.loads(
        (ROOT / "benchmarks/results/fer_curves_r5.json").read_text())
        if e["config"] == "gf16_qspa_c8_50it")
    i_ref = ref["ebn0_db"].index(1.5)
    k_ref, n_ref = ref["frame_errors"][i_ref], ref["frames"][i_ref]
    fe, fr = r16["frame_errors"], r16["frames"]
    z = two_prop_z(fe[0], fr[0], k_ref, n_ref)
    emit({"phase": "main", "launches": counts, "seconds_gf16": t16,
          "fer_gf16": r16["fer"], "frames_gf16": fr, "frame_errors_gf16": fe,
          "reference_1.5dB": [k_ref, n_ref], "z_vs_reference": z,
          "fer_gf64": r64["fer"], "frames_gf64": r64["frames"]})
    if rc16 != 0 or rc64 != 0:
        fail(f"cli.main returned {rc16}, {rc64}")
    if counts["qspa_resident"] < 1 or counts["cn_qspa"] < 1:
        fail(f"a kernel of the main path never launched: {counts}")
    if counts["qspa_resident_plain"] or counts["cn_qspa_plain"]:
        fail(f"a plain version ran on the main path: {counts}")
    if not r16["fer"][1] < r16["fer"][0]:
        fail(f"FER(2.0 dB) {r16['fer'][1]} not below FER(1.5 dB) {r16['fer'][0]}")
    if not abs(z) < 3.3:
        fail(f"FER at 1.5 dB inconsistent with the reference: z = {z}")
    if not all(0.0 <= f <= 1.0 for f in r64["fer"]) or r64["frames"][0] != main_b64:
        fail(f"GF(64) run: bad report {r64}")
    return counts


# Paths through the user's entry point: (name, cli arguments, the kernel it
# must launch, JAX FER record in fer_curves_r5.json, Eb/N0 of the
# comparison, frames per SNR point).
EMS_PATHS = [
    ("A_gf16_ems_resident",
     ["--config", "configs/gf16_ems_nm16.json", "--snr", "1.5", "2.0", "--iters", "20",
      "--set", "sim.frames_per_step=4096", "--set", "sim.max_frames=8192"],
     "ems_resident", "gf16_ems_nm16_20it", 1.5, 8192),
    ("B_gf256_ems_classic",
     ["--code", "gf256_n255_k175", "--decoder", "ems", "--set", "decoder.nm=16",
      "--set", "decoder.offset=0.1", "--iters", "10", "--snr", "2.5",
      "--set", "sim.frames_per_step=512", "--set", "sim.max_frames=2048"],
     "cn_ems", "gf256_ems_nm16_10it", 2.5, 2048),
    ("C_gf256_ems_bubble",
     ["--code", "gf256_n255_k175", "--decoder", "ems", "--set", "decoder.nm=16",
      "--set", "decoder.ems_merge=bubble", "--set", "decoder.offset=0.0",
      "--iters", "10", "--snr", "2.5",
      "--set", "sim.frames_per_step=512", "--set", "sim.max_frames=2048"],
     "cn_ems_bubble", "gf256_ems_bubble_10it", 2.5, 2048),
]
# BASELINE config 4 as it stands (n_r = 8, offset 2.0, 20 iterations, early
# termination, 1024 frames per step), then with the exact scan
_TEMS_ARGS = ["--config", "configs/gf64_tems_earlyterm.json", "--snr", "3.0", "3.5",
              "--set", "sim.max_frames=12288"]
TEMS_PATHS = [
    ("D_gf64_tems_nr8", _TEMS_ARGS, "cn_tems", "gf64_tems_nr8_20it", 3.5, 12288),
    ("E_gf64_tems_exact", [*_TEMS_ARGS, "--set", "decoder.tems_nr=0"],
     "cn_tems", "gf64_tems_20it", 3.5, 12288),
]


def phase_paths(phase: str, paths):
    """Paths through cli.main, counters zeroed just before each and read
    just after: the path's kernel launched, no plain version ran, FER falls
    from the first SNR point to the second, and the FER is consistent with
    the JAX record (|z| < 3.3). Returns each kernel's launches, summed over
    its paths."""
    from nbldpc_tpu_torch import cli

    out_dir = ROOT / "build" / "nbldpc_tpu_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    records = json.loads((ROOT / "benchmarks/results/fer_curves_r5.json").read_text())
    launches = {}
    for name, args, kernel, ref_name, snr, frames in paths:
        rep = out_dir / f"smoke_{name}.json"
        _reset_counters()
        t0 = time.perf_counter()
        rc = cli.main(["run", *args, "--set", "sim.max_frame_errors=1000000",
                       "--report", str(rep)])
        seconds = time.perf_counter() - t0
        counts = _counters()
        r = json.loads(rep.read_text())
        ref = next(e for e in records if e["config"] == ref_name)
        i_ref = ref["ebn0_db"].index(snr)
        k_ref, n_ref = ref["frame_errors"][i_ref], ref["frames"][i_ref]
        i = r["ebn0_db"].index(snr)
        z = two_prop_z(r["frame_errors"][i], r["frames"][i], k_ref, n_ref)
        emit({"phase": phase, "path": name, "launches": counts, "seconds": seconds,
              "ebn0_db": r["ebn0_db"], "fer": r["fer"], "frames": r["frames"],
              "frame_errors": r["frame_errors"], "avg_iters": r["avg_iters"],
              "reference": [ref_name, snr, k_ref, n_ref], "z_vs_reference": z})
        if rc != 0:
            fail(f"{name}: cli.main returned {rc}")
        if counts[kernel] < 1:
            fail(f"{name}: the {kernel} kernel never launched: {counts}")
        ran_plain = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
        if ran_plain:
            fail(f"{name}: a plain version ran on the path: {ran_plain}")
        if not all(0.0 <= f <= 1.0 for f in r["fer"]) or set(r["frames"]) != {frames}:
            fail(f"{name}: bad report {r}")
        if len(r["fer"]) > 1 and not r["fer"][1] < r["fer"][0]:
            fail(f"{name}: FER({r['ebn0_db'][1]} dB) {r['fer'][1]} not below "
                 f"FER({r['ebn0_db'][0]} dB) {r['fer'][0]}")
        if not abs(z) < 3.3:
            fail(f"{name}: FER at {snr} dB inconsistent with {ref_name}: z = {z}")
        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
    return launches


def phase_bench(card: str):
    from nbldpc_tpu_torch import bench

    rows = []
    for code, kind, (fast, plain) in bench.ROWS:
        for impl in (plain, fast, fast, plain):
            rec = bench.measure(code, impl, reps=10 if impl == fast else 3, kind=kind)
            rec.update(phase="bench", card=card)
            emit(rec)
            rows.append(rec)
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (ROOT / "nbldpc_tpu_torch" / "csrc").is_dir():
        fail("the nbldpc_tpu_torch package is not beside this script")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    main_b64 = 1024

    card = phase_device()
    phase_build()
    cn_rows = phase_cn_qspa(device, main_b64)
    res = phase_resident(device)
    ems_rows = phase_cn_ems(device)
    ems_res = phase_ems_resident(device)
    tems_rows = phase_cn_tems(device)
    counts = phase_main(main_b64)
    counts.update(phase_paths("main_ems", EMS_PATHS))
    counts.update(phase_paths("main_tems", TEMS_PATHS))
    phase_bench(card)

    k1 = cn_rows[0]
    emit({"kernels": [
        {"name": "qspa_resident", "route": "cuda",
         "source": "nbldpc_tpu_torch/csrc/qspa_resident.cu",
         "replaces": "nbldpc_tpu/kernels/qspa_resident.py:677",
         "launches": counts["qspa_resident"], "max_abs_err": res["max_abs_err"],
         "ms": res["ms"], "plain_ms": res["plain_ms"]},
        {"name": "cn_qspa", "route": "cuda",
         "source": "nbldpc_tpu_torch/csrc/cn_qspa.cu",
         "replaces": "nbldpc_tpu/kernels/cn_qspa.py:52",
         "launches": counts["cn_qspa"],
         "max_abs_err": max(r["max_abs_err_above_-15"] for r in cn_rows),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "ems_resident", "route": "cuda",
         "source": "nbldpc_tpu_torch/csrc/ems_resident.cu",
         "replaces": "nbldpc_tpu/kernels/ems_resident.py:145",
         "launches": counts["ems_resident"], "max_abs_err": ems_res["max_abs_err"],
         "ms": ems_res["ms"], "plain_ms": ems_res["plain_ms"]},
        *({"name": name, "route": "cuda",
           "source": "nbldpc_tpu_torch/csrc/cn_ems.cu",
           "replaces": replaces, "launches": counts[name],
           "max_abs_err": max(r["max_abs_err"] for r in ems_rows[merge]),
           "ms": ems_rows[merge][-1]["ms"], "plain_ms": ems_rows[merge][-1]["plain_ms"]}
          for name, merge, replaces in (
              ("cn_ems", "classic", "nbldpc_tpu/kernels/cn_ems.py:91"),
              ("cn_ems_bubble", "bubble", "nbldpc_tpu/kernels/cn_ems.py:101"))),
        {"name": "cn_tems", "route": "cuda",
         "source": "nbldpc_tpu_torch/csrc/cn_tems.cu",
         "replaces": "nbldpc_tpu/kernels/cn_tems.py:33",
         "launches": counts["cn_tems"],
         "max_abs_err": max(r["max_abs_err"] for r in tems_rows),
         # BASELINE config 4's check-node shape and n_r, the main path's
         "ms": tems_rows[2]["ms"], "plain_ms": tems_rows[2]["plain_ms"]},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
