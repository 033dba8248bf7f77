"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order, each printing one JSON line (any failure exits non-zero):
  1. device   - card name, power limit and compute capability (9, 0)
  2. build    - nvcc builds csrc/*.cu into build/nbldpc_tpu_torch/
  3. cn_qspa  - the check-node kernel against its plain version, at the
                flagship shape, the shapes of phase highq_qspa and config
                5's bench step
  4. resident - the whole-decode kernel (K0) against its plain version,
                also at the sweep shape of phase main (2 x 8192 frames,
                early termination) and at its bench row's step (8192
                frames x 50 iterations, throughput), timed there; then at
                GF(4) (BASELINE config 1's step and 8192 frames in
                throughput mode) and on a random GF(32) code, timed; then
                with several frames a block on more frames than the grid
                holds (a dv = 3 GF(4) code and the GF(32) code, early
                termination), so that slots refill while others decode
  5. resident_cl - the large-field whole-decode kernel (K0-cl: its cluster
                kernel) against the same plain version at GF(64) and
                GF(256) in the modes of phase 4, each batch holding
                converged and failed frames, and at BASELINE config 5's
                step (8 points x 512 frames, early termination); timed at
                GF(64) and at config 5's bench shape, beside the scratch
                kernel on the same LLRs; then K0-cl's scratch kernel, which
                takes the codes whose state no cluster holds, on two such
                codes (GF(256), N = 1200 and GF(64), N = 2400) in the modes
                of phase 4
  6. cn_ems   - the EMS check-node kernels (classic and bubble) against
                their plain version, exact to 0.0, both also on tie-heavy
                inputs (4 levels) and at config 5's step shape
  7. ems_resident - the whole-decode EMS kernel against its plain version,
                in the modes of phase 4 (its bench row's step included,
                timed there) and at nm = 8; agreement 1.0
  8. cn_tems  - the T-EMS check-node kernel against its plain version at
                GF(16), GF(64) (BASELINE config 4's shape, exact scan and
                n_r = 8, and n_r = 8 on tie-heavy inputs) and GF(256),
                exact to 0.0
  9. highq_qspa - `qspa.decode` through K0-cl against `qspa.decode` through
                the check-node kernel (K1) on the same LLRs, GF(64) and
                GF(256): symbol agreement > 0.99, done agreement > 0.95
 10. main     - `nbldpc_tpu_torch.cli.main(["run", ...])` at the flagship
                config plus a GF(64) QSPA run (K0-cl's cluster kernel) and
                a GF(256) run on the N = 1200 code (its scratch kernel),
                with every launch counter read around it; FER held to the
                JAX package's recorded statistics
 11. main_qspa - `cli.main(["run", "--config", ...])` on BASELINE configs 1
                (configs/gf4_qspa_pr1.json, GF(4), 20 iterations, early
                termination, 2.5 dB) and 2 (configs/gf16_qspa_batch4k.json,
                GF(16) (204,102), 50 iterations at the fixed budget, at
                1.5 dB only), 16384 frames each, both through K0, each held
                to its JAX FER record
 12. main_ems - `cli.main(["run", ...])` on the three EMS paths: GF(16) EMS
                (resident kernel), GF(256) classic and bubble EMS (check-node
                kernels), each held to its JAX FER record
 13. main_tems - `cli.main(["run", ...])` on BASELINE config 4
                (configs/gf64_tems_earlyterm.json, 1024 frames per step):
                path D at its n_r = 8, path E with the exact scan, each
                held to its JAX FER record
 14. main_cfg5 - `cli.main(["run", ...])` on BASELINE config 5
                (configs/gf256_sweep_2host.json, all 8 points, 20
                iterations, 512 frames per point and step; max_frames cut
                to 2048 per point): QSPA through K0-cl and the EMS half
                through K2; then GF(256) QSPA at 10 iterations, 2.5 dB,
                16384 frames, held to its JAX FER record
 15. random_cw - random codewords: the encoder on the card against the
                encoder on the CPU, bit for bit, on every code in codes/
                and the codes this script makes, at 8192 frames (q <= 32)
                or 4096, every codeword satisfying H; K0 (flagship, GF(4),
                GF(32)), K0-cl's cluster kernel (GF(64), GF(256)), its
                scratch kernel (OVERSIZE) and K3 (GF(16)) against their
                plain versions on LLRs of random codewords in the modes of
                phase 4, a frame done exactly when its decision satisfies
                H, >= 99% of frames done and right at each code's higher
                Eb/N0; the five paths of phases 10-14 with a FER record
                (K0, K0-cl, K3, K2, K5) through `cli.main(["run",
                "--random-codewords", ...])`, each held to that record
                (K2's: the JAX package's own random-codeword FER,
                tests/data/fer_random_cw_jax.json: its EMS at nm < q
                breaks ties toward symbol 0);
                the flagship bench step in both modes and the encoder
                alone, timed
 16. bench    - sim-step throughput, kernel paths and plain torch paths,
                QSPA, EMS, T-EMS and config 5's QSPA and EMS halves (EMS
                with each merge)
 17. micro    - the probes P1-P7: the two entry points
                (nbldpc_tpu_torch.benchmarks.micro_kernels and .micro_layout)
                as a user runs them, counters read around them; then each
                probe kernel against its plain version at the JAX scripts'
                full shapes, exact (max abs error 0.0; P5 at 50 and 200
                iterations; P6 and P7 past +-inf), timed with its bound
                (P5 with its special-function-unit floor beside), P3 also
                against chained torch.addmm calls (cuBLAS SGEMM, TF32 off)
                as its library time
 18. multi_rank - runs across processes on the one card. A: phase main's
                flagship sweep on a one-rank NCCL group (sim.run_sweep under
                a layout), counters equal to no group's, K0 launched; the
                group's cost a step and the noise draw timed. B: two ranks
                sharing card 0 over gloo, started by torch.distributed.run
                with this script as the rank program (--multi-rank-worker):
                `cli run` on config 5 with --mesh-snr 2 and on the flagship
                sweep with --mesh-data 2, each rank's counters equal to one
                process's, K0-cl or K0 launched on each rank and no plain
                version. C: the edge-sharded decode (decoders/sharded.py)
                on the two ranks with K1, hard/done/iters equal to decode_bl
                through K1 and the routing kernels (which that decode_bl
                must launch, with no plain version), both early_term modes.
                Two ranks time-sharing one card are no scaling
                measurement; and the edge-sharded decode
                with K2 (classic EMS) and K5 (T-EMS), equal to decode_bl
                through the same kernel
 19. resident_bf16 - bf16 message storage (mm_precision="bf16"): the bf16
                builds of K0 (flagship, GF(4)), K0-cl's cluster kernel
                (config 5's code on a cluster of 4, GF(64) (576,480) on 2)
                and its scratch kernel (OVERSIZE; OVERSIZE_GF64 called
                directly: a bf16 cluster of 8 holds it) against the bf16
                plain version in the modes of phase 4, the bench rows'
                steps and on random codewords, each timed beside its f32
                build in the same run with both builds' launch plans;
                the JAX package's bf16 device-test invariants on K0 and on
                K0-cl; the flagship and GF(256) FER gates in bf16 against
                the f32 records (|z| < 3.3) and the scratch kernel's path,
                through cli.main
 20. fer_harness - the coding-performance harness as a user runs it, cut
                to 4096 frames a point (nbldpc_tpu_torch.benchmarks:
                fer_curves on gf4_qspa_c8_20it (K0) and
                gf256_ems_bubble_10it (K2b), offset_sweep on
                gf64_tems_nr8_20it at offsets 1.5 and 2.0 (K5),
                ber_precision at 1.5 and 2.0 dB (K0 and its bf16 build)),
                counters zeroed before each and read after; each record
                file well formed, each point with >= 10 frame errors on
                both sides (and not at FER 1 on both) held to the JAX
                records (fer_curves_r5.json, offset_sweep_r5.json) by
                compare_records (|z| under the Bonferroni bound at
                family-wise 0.001, at least one point held), and bf16 to
                f32 the same way as a sanity check only (the same noise
                decoded twice: correlated, so a loose bound; phase 19
                holds the bf16 builds exactly)
 21. throughput - the throughput harness. A: run_all as a user runs it
                (nbldpc_tpu_torch.benchmarks.run_all: all 18 configurations
                of the JAX script at its batches and budgets, 10 timed
                steps a block), counters zeroed before and read after;
                every record well formed, each configuration launching its
                kernel (THROUGHPUT_KERNELS) once a step (K0, K0 bf16, K0-cl,
                K3) or once an iteration (K2, K2b, K5, each with the two
                routing kernels) and nothing else.
                B: K3 on the QC and chunk8 GF(16) codes and K0 on the QC
                GF(16) and GF(4) codes against their plain versions at
                sigma 0.7 in the modes of phase 4, agreement 1.0. C: the
                layout sweep (benchmarks.scaling) on 8 ranks sharing card 0
                over gloo (torch.distributed.run, this script as the rank
                program: --scaling-worker): counters identical across the
                layouts (1,1), (1,2), (2,2), (2,4), K0-cl launched on every
                rank that holds a block and on no other. Ranks time-sharing
                one card are no scaling measurement
 22. routing  - decode_bl's routing kernels (csrc/route.cu: route_down, the
                leave-one-out, normalization and gather to the check slots;
                route_up, the gather back and the posterior sum). A: each
                against its plain version at config 5's step shape
                (GF(256) (255,175), 4096 frames) and config 4's (GF(64)
                (576,480), 1024 frames), exact (max abs error 0.0), timed
                with its bound. B: decode_bl through them against decode_bl
                through the plain routing with K1, K2, K2b and K5, early
                termination and fixed budget, hard/done/iters equal. Every
                path above that runs decode_bl on the card (phases 9, 12-15,
                18 C, 20, 21) must launch both routing kernels and no plain
                version
 23. sim_step - the sim step around the decode (csrc/sim_step.cu:
                channel_llr, the noise to q-ary LLRs; prior_bl, decode_bl's
                entry; count_errors, the six counters). A: each against its
                plain version at the flagship bench step (8192 frames),
                config 4's (1024 frames) and config 5's (8 Eb/N0 points x
                512 frames), all-zero and random codewords, exact (max abs
                error 0.0), timed with its bound (queued behind a sleep,
                and back to back). B: every bench row's step
                through the kernels against the plain step composition
                around the same decode, on one generator: counters equal,
                each step kernel launched once and no plain version. Every
                sim-step path above (phases 10-15, 18 B, 20, 21) must launch
                the channel and the counters, and each decode_bl path
                decode_bl's entry
 24. q_last   - the q-last decode path (each decoder's batch_last=False:
                common.decode in plain PyTorch, no kernel) against the
                batch-last paths on the same LLRs: QSPA on the flagship
                (8192 frames, 50 iterations, sigma 0.63, fixed budget and
                early termination) against the plain decode_bl, the K1 path
                and K0; EMS nm 16 on config 3's code (8192 frames, 50
                iterations) and at config 5's (512 frames, cut for time; 20
                iterations, 3.0 dB) against the plain path and the K2 path;
                T-EMS n_r 8 at config 4's (1024 frames, 20 iterations, 3.5
                dB) against the plain path and the K5 path. hard/done/iters
                frame for frame: the plain path, K2 and K5 exactly, K1 on
                >= 99.9% of the frames, K0 reported only; every decode
                twice, the second timed by CUDA events, one line of times
Then the kernels summary (each kernel's launches on the paths above, its
worst error against its plain version, its time, its plain version's time,
the bound of the same work and, for P3, the library call's time), the card
line, and the final status line. Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import contextlib
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


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls enqueued behind a
    sleeping kernel, after one warm-up: the host enqueues every call while
    the card sleeps, so the time is the card's alone. cuda_ms also counts
    the host's time per call where the host enqueues slower than the card
    runs (a probe call of tens of microseconds)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e5 * reps))       # ~0.1 ms a call, more than its host time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet): f32
# operations outside the tensor cores, TF32 in them, and HBM bytes.
PEAK_F32_OPS = 67e12
PEAK_TF32_OPS = 495e12          # dense, tensor cores
PEAK_HBM_BYTES = 3.35e12


def bound(ops: float, nbytes: float, peak_ops: float = PEAK_F32_OPS) -> dict:
    """The least time the card could take for work of `ops` operations at
    `peak_ops` per second (f32 by default) that reads its inputs once and
    writes its outputs once (`nbytes`): the larger of the two times, and
    which one sets it."""
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return ({"bound_ms": t_ops, "bound_by": "operations"} if t_ops >= t_bytes
            else {"bound_ms": t_bytes, "bound_by": "bytes"})


# Operation counts, the arithmetic each algorithm needs (an exp, a log, a
# compare or a select counts as one operation, as an add does).

def qspa_edge_ops(q: int) -> int:
    """One QSPA check-node update of one edge: subtract, exp, softmax sum
    and divide, the forward WHT, about three products of the leave-one-out
    prefix x suffix, the inverse WHT, then scale, floor and log."""
    return 10 * q + 2 * q * (q.bit_length() - 1)


def resident_bytes(g, B: int) -> int:
    """A resident decode's inputs read once and outputs written once: LLRs,
    graph tables (cn_vn, cn_real, perm_down, syn_k, vn_edge, n2e), hard
    decisions, done flags and iteration counts."""
    E = g.m * g.dc_max
    tables = E * (2 + g.q + g.gf.p) + g.n * g.dv_max + g.q
    return 4 * (B * g.n * g.q + tables + B * g.n + B) + B


def resident_qspa_bound(g, B: int, frame_iters: int, es: int = 4) -> dict:
    """K0 and K0-cl: every frame-iteration the run needed updates each real
    edge and adds each variable's dv messages and prior, then compares for
    the decision; the start normalizes the prior. The bytes are the
    decode's inputs and outputs, the same in f32 and bf16 (the LLRs stay
    f32). Beside it, `state_ms`: the stored state (elements of es bytes:
    each edge message and posterior row read and written, the prior read)
    moved once a frame-iteration at the HBM rate, the time a decode whose
    state left the chip every iteration would need for it alone."""
    per_iter = g.spec.num_edges * qspa_edge_ops(g.q) + g.n * g.q * (g.dv_max + 2)
    state = frame_iters * es * g.q * (2 * g.spec.num_edges + 3 * g.n)
    return {**bound(frame_iters * per_iter + B * 2 * g.n * g.q, resident_bytes(g, B)),
            "state_ms": state / PEAK_HBM_BYTES * 1e3}


def resident_ems_bound(g, B: int, frame_iters: int, nm: int) -> dict:
    """K3: every frame-iteration the run needed updates each check (classic
    EMS) and adds each variable's dv messages and prior, then compares for
    the decision; the start normalizes the prior."""
    per_iter = (g.m * ems_check_ops(g.q, g.dc_max, nm)
                + g.n * g.q * (g.dv_max + 2))
    return bound(frame_iters * per_iter + B * 2 * g.n * g.q, resident_bytes(g, B))


def ems_check_ops(q: int, dc: int, nm: int) -> int:
    """One classic EMS check node: normalize each operand, extract its top
    nm (nm rounds over q) when nm < q, 3 (dc - 2) merges of 2 q nm
    operations (each re-extracted when nm < q), then postprocess (max,
    subtract, offset, clip) each output."""
    nm = min(nm, q)
    extract = nm * q if nm < q else 0
    return dc * (2 * q + extract + 4 * q) + 3 * (dc - 2) * (2 * q * nm + extract)


def bubble_check_ops(q: int, dc: int, nm: int) -> int:
    """One bubble EMS check node: normalize and extract each operand's top
    nm, 3 (dc - 2) merges over the P staircase pairs (t + 1)(s + 1) <= 2 nm
    (add and xor per pair, nm extraction rounds over pairs and min(2 nm, q)
    fills), dense scatter and postprocess of each output."""
    pairs = sum(1 for t in range(nm) for s in range(nm) if (t + 1) * (s + 1) <= 2 * nm)
    merge = 2 * pairs + nm * (pairs + min(2 * nm, q))
    return dc * (2 * q + nm * q + 5 * q) + 3 * (dc - 2) * merge


def tems_check_ops(q: int, dc: int, n_r: int) -> int:
    """One T-EMS check node: per column max, argmax, subtract and permute
    (4 q), the per-row top-3 over the columns (3 q), then per column the
    two-deviation candidates (3 operations each: q (q - 1) for the exact
    scan; n_r argmax rounds of 2 q and n_r q candidates with n_r > 0) and
    the output rotation, offset and clip (3 q)."""
    scan = 3 * q * (q - 1) if n_r == 0 else 2 * n_r * q + 3 * n_r * q
    return dc * (4 * q + 3 * q) + dc * (scan + 3 * q)


def cn_qspa_elem_ops(q: int) -> int:
    """K1 per element of U: max-subtracted softmax (5), WHT, log-magnitude
    and sign (2), leave-one-out sums (3), exp and sign (2), inverse WHT,
    scale, floor, log (3) and max renormalization (2)."""
    return 17 + 2 * (q.bit_length() - 1)


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


def _u_for(g, B: int, device, levels: int = 0):
    """Check-node inputs with the code's real pad structure, from a seed:
    normal draws, or with `levels` > 0 multiples of 1.5 from that many
    values (ties in every extraction round)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    shape = (g.n, g.dv_max, g.q, B)
    v = rng.integers(0, levels, shape) * 1.5 if levels else rng.standard_normal(shape) * 3.0
    return g.gather_cn_x_bl(torch.from_numpy(v.astype(np.float32)).to(device)).contiguous()


def phase_cn_qspa(device):
    """K1 at the flagship shape, at the shapes its decode path runs in
    phase highq_qspa (frames x points of HIGHQ) and at config 5's bench
    step (the K1 path of bench row qspa_gf256_n255_k175). Returns the rows
    by label."""
    import torch

    from nbldpc_tpu_torch import bench
    from nbldpc_tpu_torch.kernels import cn_qspa

    cfg5 = bench.ROWS_BY_NAME["qspa_gf256_n255_k175"]
    cases = [("flagship", "gf16_n204_k102_c8", 8192),
             *((f"highq_{code}", code, frames * len(snrs)) for code, frames, snrs in HIGHQ),
             ("cfg5_bench", cfg5.code, cfg5.batch)]
    rows = {}
    for label, code, B in cases:
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
        row = {"phase": "cn_qspa", "case": label, "shape": list(U.shape),
               "max_abs_err_above_-15": err, "max_abs_err_tail": tail_err,
               "ms": (k1 + k2) / 2, "plain_ms": (plain1 + plain2) / 2,
               "ms_runs": [k1, k2], "plain_ms_runs": [plain1, plain2],
               **bound(U.numel() * cn_qspa_elem_ops(g.q), 2 * 4 * U.numel())}
        emit(row)
        if not finite:
            fail(f"cn_qspa {list(U.shape)}: non-finite outputs")
        if not err <= 1e-4:
            fail(f"cn_qspa {list(U.shape)}: max abs err {err} > 1e-4")
        rows[label] = row
    return rows


def _llrs(g, frames_per_snr: int, snrs, device, ebn0: bool = True):
    """All-zero-codeword LLRs [S * frames, N, q] at the given Eb/N0 points
    (with ebn0=False: at the given sigmas)."""
    import torch

    from nbldpc_tpu_torch.channel import ebn0_to_sigma, llr_init
    from nbldpc_tpu_torch.sim import step_generator

    sig = [float(ebn0_to_sigma(s, g.spec.k / g.n)) if ebn0 else s for s in snrs]
    sig = torch.tensor(sig, device=device).repeat_interleave(frames_per_snr)[:, None, None]
    gen = step_generator(1234, len(snrs), device)
    y = 1.0 + sig * torch.randn((sig.shape[0], g.n, g.gf.p), generator=gen,
                                device=device)
    return llr_init(y, sig, g.q).contiguous()


def _done_not_h(g, hard, done) -> int:
    """Frames whose done flag disagrees with H hard = 0 (the graph's
    syndrome, from the host's tables): done frames that fail H, and frames
    not done that satisfy it."""
    ok = ~(g.syndrome_bl(hard.T) != 0).any(dim=0)
    return int((ok != done).sum())


def _hold_resident(phase: str, code: str, g, modes: dict, timed, mixed=(),
                   scratch=False, cw=None, precision: str = "f32", fn=None) -> dict:
    """A resident QSPA kernel (K0 or K0-cl, by q and state size) against the
    plain version on identical LLRs, mode by mode: (llr, max_iters,
    early_term, stats_each_iter). A frame agrees when hard, done and iters
    all equal; one iteration (mode c_one_iter) needs agreement >= 0.999,
    every other mode >= 0.995 with frame-error counts (against the
    codewords cw, the all-zero codeword when None) within |z| < 3; in every
    mode the kernel marks a frame done exactly when its hard decision
    satisfies H. In the modes in `mixed` the plain decode must leave some
    frames in error and decode the others right. The modes in `timed` are
    timed plain, kernel, kernel, plain (with `scratch`, K0-cl's scratch
    kernel twice in the middle); the last of them gives ms, plain_ms and
    the bound. Each mode's record also holds the share of frames the kernel
    marks done with hard == cw (`done_right`). `precision` is the state's
    element of kernel and plain version; in bf16 the timed modes time the
    f32 build beside (f32, bf16, bf16, f32: `f32_ms`) and record both
    builds' launch plans. `fn` calls one kernel's wrapper in place of
    qr.resident_decode's choice."""
    import torch

    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    worst = 0
    result = {"agreement_min": 1.0, "done_right": {}}
    ref = 0 if cw is None else cw
    fn = fn or qr.resident_decode
    for name, (llr, iters, et, stats) in modes.items():
        B = llr.shape[0]
        dec = qr.ResidentQSPA(g, iters, et, stats, precision)
        hk, dk, ik = fn(dec, llr)
        hp, dp, ip = qr.decode_plain(dec, llr)
        torch.cuda.synchronize()
        same = (hk == hp).all(dim=1) & (dk == dp) & (ik == ip)
        agree = float(same.float().mean())
        result["agreement_min"] = min(result["agreement_min"], agree)
        fe_k = int((hk != ref).any(dim=1).sum())
        fe_p = int((hp != ref).any(dim=1).sum())
        z = two_prop_z(fe_k, B, fe_p, B)
        done_right = float((dk & (hk == ref).all(dim=1)).float().mean())
        result["done_right"][name] = done_right
        not_h = _done_not_h(g, hk, dk)
        rec = {"phase": phase, "code": code, "mode": name, "frames": B,
               "iters": iters, "precision": precision, "agreement": agree,
               "frame_errors_kernel": fe_k,
               "frame_errors_plain": fe_p, "z": z, "done_right": done_right,
               "done_not_h": not_h}
        if not_h:
            emit(rec)
            fail(f"{phase} {code} mode {name}: {not_h} frames' done flags disagree with H")
        if name == "c_one_iter":
            worst = max(worst, int((hk - hp).abs().max()), int((ik - ip).abs().max()),
                        int((dk != dp).sum() > 0))
            if agree < 0.999:
                emit(rec)
                fail(f"{phase} {code} mode {name}: agreement {agree} < 0.999")
        elif agree < 0.995 or abs(z) >= 3:
            emit(rec)
            fail(f"{phase} {code} mode {name}: agreement {agree}, z {z}")
        if name in mixed and not 0 < fe_p < B:
            emit(rec)
            fail(f"{phase} {code} mode {name}: {fe_p} of {B} frames in error; "
                 f"the mode needs both converged and failed frames")
        if name in timed:
            p1 = cuda_ms(lambda: qr.decode_plain(dec, llr), 1)
            if precision == "bf16":
                dec32 = qr.ResidentQSPA(g, iters, et, stats)
                f1 = cuda_ms(lambda: fn(dec32, llr), 5)
            k1 = cuda_ms(lambda: fn(dec, llr), 5)
            if scratch:
                s1 = cuda_ms(lambda: qr.resident_decode_cl_scratch(dec, llr), 5)
                s2 = cuda_ms(lambda: qr.resident_decode_cl_scratch(dec, llr), 5)
                rec.update(scratch_ms=(s1 + s2) / 2, scratch_ms_runs=[s1, s2])
            k2 = cuda_ms(lambda: fn(dec, llr), 5)
            if precision == "bf16":
                f2 = cuda_ms(lambda: fn(dec32, llr), 5)
                rec.update(f32_ms=(f1 + f2) / 2, f32_ms_runs=[f1, f2],
                           plan=_resident_plans(dec, dec32, fn, B, llr.device))
            p2 = cuda_ms(lambda: qr.decode_plain(dec, llr), 1)
            rec.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                       ms_runs=[k1, k2], plain_ms_runs=[p1, p2],
                       **resident_qspa_bound(g, B, int(ik.sum()), dec.es))
            result.update({k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "scratch_ms", "f32_ms", "plan") if k in rec})
        emit(rec)
    result["max_abs_err"] = worst
    return result


def _resident_plans(dec, dec32, fn, B: int, device) -> dict:
    """The launch each build takes for B frames, bf16 and f32: K0's frames
    and threads a block, blocks an SM and grid; K0-cl's cluster size,
    warps, checks a round and clusters at once (cluster or scratch kernel,
    as `fn` runs it)."""
    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    out = {}
    for label, d in (("bf16", dec), ("f32", dec32)):
        if d.graph.q <= qr.K0_MAX_Q:
            out[label] = qr.k0_plan(d, B, device)
            continue
        scratch = fn is qr.resident_decode_cl_scratch or d.cluster_plan is None
        plan = qr.scratch_layout(d)[0] if scratch else d.cluster_plan
        out[label] = {"kernel": "scratch" if scratch else "cluster",
                      "cluster_size": plan.size, "warps": plan.warps,
                      "checks_per_round": plan.round_checks, "checks_per_rank": plan.checks,
                      "smem_bytes": plan.smem_bytes,
                      "clusters_at_once": (qr.scratch_occupancy if scratch
                                           else qr.cluster_occupancy)(d, device)}
    return out


def _bench_llrs(name: str, g, device):
    """LLRs of one step of bench row `name` (its batch at its noise)."""
    from nbldpc_tpu_torch import bench

    row = bench.ROWS_BY_NAME[name]
    return _llrs(g, row.batch, [row.noise], device, row.ebn0)


# K0 on a random GF(32) code: (q, n, m, seed), and its frames and Eb/N0;
# a random dv = 3 GF(4) code (q, n, m, seed, dv), and the Eb/N0 of K0's
# checks with several frames a block
K0_GF32 = (32, 192, 96, 11)
K0_GF32_FRAMES, K0_GF32_EBN0 = 2048, 2.0
K0_DV3 = (4, 96, 48, 5, 3)
K0_REFILL_EBN0 = 1.5


def phase_resident(device):
    """K0 against its plain version on identical LLRs: the three modes at
    2048 frames, phase main's sweep shape (2 x 8192 frames at 1.5 and 2.0
    dB, 50 iterations, early termination) and the step of bench row
    qspa_gf16_n204_k102_c8 (8192 frames, sigma 0.63, 50 iterations,
    throughput), timed in throughput mode at both sizes and at the sweep
    shape; the bench step's numbers go to the kernels summary. Then, each
    timed: GF(4) (96,48) at BASELINE config 1's step (512 frames at 2.5 dB,
    20 iterations, early termination) and at 8192 frames in throughput
    mode, and the K0_GF32 code (throughput, 50 iterations). Then K0 with
    several frames a block (checks a thread each) in early termination on
    more frames than its grid holds, frames a block x 32 (the most blocks
    an SM runs) x SMs + 37, on K0_DV3 and K0_GF32 (20 iterations): a
    block's slots finish at different iterations and take new frames while
    its other slots decode. Last, K0's log against logf on every positive
    normal float, bit for bit."""
    import torch

    from nbldpc_tpu_torch.code import random_regular_spec
    from nbldpc_tpu_torch.graph import TannerGraph
    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    code = "gf16_n204_k102_c8"
    g = _graph(code, device)
    small, sweep = _llrs(g, 2048, [1.5], device), _llrs(g, 8192, [1.5, 2.0], device)
    modes = {"a_early_term": (small, 50, True, True),
             "b_throughput": (small, 50, False, False),
             "c_one_iter": (small, 1, False, True),
             "d_sweep_shape": (sweep, 50, True, True),
             "e_bench_shape": (_bench_llrs("qspa_gf16_n204_k102_c8", g, device),
                               50, False, False)}
    res = _hold_resident("resident", code, g, modes,
                         ("b_throughput", "d_sweep_shape", "e_bench_shape"))
    g4 = _graph("gf4_n96_k48", device)
    res4 = _hold_resident("resident", "gf4_n96_k48", g4, {
        "f_gf4_cfg1_step": (_llrs(g4, 512, [2.5], device), 20, True, True),
        "g_gf4_throughput": (_llrs(g4, 8192, [2.5], device), 20, False, False)},
        ("f_gf4_cfg1_step", "g_gf4_throughput"))
    g32 = TannerGraph(random_regular_spec(*K0_GF32), device=device)
    res32 = _hold_resident("resident", "gf32_random", g32, {
        "h_gf32_throughput": (_llrs(g32, K0_GF32_FRAMES, [K0_GF32_EBN0], device),
                              50, False, False)}, ("h_gf32_throughput",))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    refill = []
    for code, gr, mode in (("gf4_dv3_random", TannerGraph(random_regular_spec(*K0_DV3), device),
                            "i_refill_gf4_dv3"),
                           ("gf32_random", g32, "j_refill_gf32")):
        frames = qr.ResidentQSPA(gr, 20).frames_per_block
        if frames < 2:
            fail(f"resident: {code} takes {frames} frame a block")
        llr = _llrs(gr, frames * 32 * sms + 37, [K0_REFILL_EBN0], device)
        refill.append(_hold_resident("resident", code, gr, {mode: (llr, 20, True, True)}, (),
                                     (mode,)))
    parts = (res, res4, res32, *refill)
    res["agreement_min"] = min(r["agreement_min"] for r in parts)
    res["max_abs_err"] = max(r["max_abs_err"] for r in parts)
    bad = qr.log_mismatches(device)
    emit({"phase": "resident", "log_mismatches_over_positive_normal_floats": bad})
    if bad:
        fail(f"resident: K0's log differs from logf on {bad} positive normal floats")
    return res


# The large-field checks: (code, frames per Eb/N0 point, points) of phase
# resident_cl (the modes of phase 4 at 20 iterations) and of phase
# highq_qspa; at these points some frames of each batch fail to converge
HIGHQ = (("gf64_n576_k480", 1024, [3.0, 3.5]), ("gf256_n255_k175", 512, [2.0, 2.5]))
# A GF(256) code whose state (4.9 MB a frame) no cluster holds: K0-cl's
# scratch kernel decodes it. (n, m, seed) of a random dv = 2 code, and
# the frames and Eb/N0 of its checks in phases resident_cl and main; and a
# GF(64) code no cluster holds either (2.5 MB a frame), checked and timed
# beside it in phase resident_cl
OVERSIZE = (1200, 400, 3)
OVERSIZE_FRAMES, OVERSIZE_EBN0 = 512, 2.5
OVERSIZE_GF64 = (2400, 800, 3)


def oversize_spec(q: int = 256):
    """The OVERSIZE code over GF(256), or OVERSIZE_GF64 over GF(64)."""
    from nbldpc_tpu_torch.code import random_regular_spec

    return random_regular_spec(q, *(OVERSIZE if q == 256 else OVERSIZE_GF64))


def phase_resident_cl(device):
    """K0-cl's cluster kernel against the plain version at GF(64) and
    GF(256) in the modes of phase 4, each batch with converged and failed
    frames; at GF(256) also at BASELINE config 5's step as `cli run`
    decodes it (512 frames at each of its 8 points, 20 iterations, early
    termination) and at its bench shape (4096 frames at 3.0 dB, 20
    iterations at the fixed budget). Each code's plan and
    cudaOccupancyMaxActiveClusters first. Timed at GF(64) in throughput
    mode and at the bench shape, whose numbers go to the kernels summary,
    with the scratch kernel beside. Then the scratch kernel on the
    OVERSIZE code and on OVERSIZE_GF64, each with its plan first, in the
    three modes, timed in throughput mode. Returns the two kernels'
    summaries (the scratch kernel's at OVERSIZE, with OVERSIZE_GF64's time
    beside)."""
    from nbldpc_tpu_torch import bench
    from nbldpc_tpu_torch.graph import TannerGraph
    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    cfg = json.loads((ROOT / CFG5).read_text())
    worst, result = 0, {"agreement_min": 1.0}
    for code, frames, snrs in HIGHQ:
        g = _graph(code, device)
        dec = qr.ResidentQSPA(g, 1)
        plan = dec.cluster_plan
        emit({"phase": "resident_cl", "code": code, "cluster_size": plan.size,
              "in_place": plan.in_place,
              "warps": plan.warps, "checks_per_rank": plan.checks,
              "checks_per_round": plan.round_checks, "rows_per_rank": plan.rows,
              "smem_bytes": plan.smem_bytes,
              "max_active_clusters": qr.cluster_occupancy(dec, device)})
        llr = _llrs(g, frames, snrs, device)
        modes = {"a_early_term": (llr, 20, True, True),
                 "b_throughput": (llr, 20, False, False),
                 "c_one_iter": (llr, 1, False, True)}
        mixed = ("a_early_term", "b_throughput")
        timed = ("b_throughput",)
        row = bench.ROWS_BY_NAME["qspa_gf256_n255_k175"]
        if code == cfg["code"]["name"]:
            d = cfg["decoder"]
            modes["d_bench_shape"] = (_llrs(g, row.batch, [row.noise], device),
                                      row.iters, False, False)
            modes["e_cfg5_step"] = (
                _llrs(g, cfg["sim"]["frames_per_step"], cfg["channel"]["ebn0_db"], device),
                d["max_iters"], d["early_term"], True)
            mixed += ("e_cfg5_step",)
            timed = ("d_bench_shape",)
        r = _hold_resident("resident_cl", code, g, modes, timed, mixed, scratch=True)
        worst = max(worst, r.pop("max_abs_err"))
        result["agreement_min"] = min(result["agreement_min"], r.pop("agreement_min"))
        result.update(r)
    result["max_abs_err"] = worst
    scratch = {}
    for q, code in ((256, "oversize_gf256_n1200"), (64, "oversize_gf64_n2400")):
        g = TannerGraph(oversize_spec(q), device)
        dec = qr.ResidentQSPA(g, 1)
        if dec.cluster_plan is not None:
            fail(f"resident_cl: {code} fits a cluster")
        plan, _ = qr.scratch_layout(dec)
        emit({"phase": "resident_cl", "code": code, "kernel": "scratch",
              "cluster_size": plan.size, "warps": plan.warps, "checks_per_rank": plan.checks,
              "checks_per_round": plan.round_checks, "rows_per_rank": plan.rows,
              "post_shared": plan.post_shared, "smem_bytes": plan.smem_bytes,
              "slice_bytes": dec.es * plan.slice_elems,
              "max_active_clusters": qr.scratch_occupancy(dec, device)})
        llr = _llrs(g, OVERSIZE_FRAMES, [OVERSIZE_EBN0], device)
        modes = {"a_early_term": (llr, 20, True, True),
                 "b_throughput": (llr, 20, False, False),
                 "c_one_iter": (llr, 1, False, True)}
        scratch[q] = _hold_resident("resident_cl", code, g, modes, ("b_throughput",))
    out = scratch[256]
    out["max_abs_err"] = max(r["max_abs_err"] for r in scratch.values())
    out["agreement_min"] = min(r["agreement_min"] for r in scratch.values())
    out.update({f"gf64_{k}": scratch[64][k] for k in ("ms", "plain_ms", "bound_ms")})
    return result, out


def _hold_cn(phase: str, device, code: str, B: int, kern, plain, args, check_ops,
             levels: int = 0, **label) -> dict:
    """A check-node kernel against its plain version on the same U, timed
    plain, kernel, kernel, plain: max abs error must be 0.0 and every output
    finite. check_ops(q, dc, *args) counts the operations of one (check,
    frame) for the bound."""
    import torch

    U = _u_for(_graph(code, device), B, device, levels)
    M, dc, q, _ = U.shape
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
           "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
           **bound(M * B * check_ops(q, dc, *args), 2 * 4 * U.numel())}
    emit(row)
    if not finite:
        fail(f"{phase} {label} {list(U.shape)}: non-finite outputs")
    if err != 0.0:
        fail(f"{phase} {label} {list(U.shape)}: max abs err {err} != 0.0")
    return row


def phase_cn_ems(device):
    """K2 (classic) and K2b (bubble) against their plain versions."""
    from nbldpc_tpu_torch.kernels import cn_ems

    classic = (cn_ems.cn_update, cn_ems.cn_update_plain, ems_check_ops)
    bubble = (cn_ems.cn_update_bubble, cn_ems.cn_update_bubble_plain, bubble_check_ops)
    # levels > 0: tie-heavy inputs; the last case of each merge is config
    # 5's step shape (8 points x 512 frames): its EMS half as `cli run`
    # decodes it in phase main_cfg5, and bench row ems_bubble_gf256_n255_k175
    cases = [("gf16_n204_k102", 8192, "classic", classic, 16, 0.3, 0),
             ("gf64_n576_k480", 1024, "classic", classic, 8, 0.1, 0),
             ("gf64_n576_k480", 1024, "bubble", bubble, 8, 0.0, 0),
             ("gf256_n255_k175", 512, "classic", classic, 16, 0.1, 0),
             ("gf256_n255_k175", 512, "bubble", bubble, 16, 0.0, 0),
             ("gf256_n255_k175", 512, "classic", classic, 16, 0.1, 4),
             ("gf256_n255_k175", 512, "bubble", bubble, 16, 0.0, 4),
             ("gf256_n255_k175", 4096, "classic", classic, 16, 0.1, 0),
             ("gf256_n255_k175", 4096, "bubble", bubble, 16, 0.0, 0)]
    rows = {}
    for code, B, merge, (kern, plain, ops), nm, offset, levels in cases:
        rows.setdefault(merge, []).append(_hold_cn(
            "cn_ems", device, code, B, kern, plain, (nm, offset),
            lambda q, dc, nm, _offset, ops=ops: ops(q, dc, nm), levels,
            merge=merge, nm=nm, offset=offset, tie_levels=levels))
    return rows


def _hold_ems(phase: str, code: str, g, modes: dict, timed=(), cw=None,
              offset: float = 0.3) -> dict:
    """K3 against its plain version (at `offset`) on identical LLRs, mode by
    mode: (llr, max_iters, early_term, stats_each_iter, nm). Agreement
    (hard, done and iters all equal) must be 1.0, and the kernel must mark
    a frame done exactly when its hard decision satisfies H. Frame errors
    count against the codewords cw (the all-zero codeword when None). The
    modes in `timed` are timed plain, kernel, kernel, plain; the last of
    them gives ms, plain_ms and the bound. Each mode's record also holds
    the share of frames the kernel marks done with hard == cw
    (`done_right`)."""
    import torch

    from nbldpc_tpu_torch.kernels import ems_resident as er

    worst = 0
    result = {"done_right": {}}
    ref = 0 if cw is None else cw
    for name, (llr, iters, et, stats, nm) in modes.items():
        B = llr.shape[0]
        dec = er.ResidentEMS(g, iters, nm, offset, et, stats)
        hk, dk, ik = er.resident_decode(dec, llr)
        hp, dp, ip = er.decode_plain(dec, llr)
        torch.cuda.synchronize()
        same = (hk == hp).all(dim=1) & (dk == dp) & (ik == ip)
        agree = float(same.float().mean())
        worst = max(worst, int((hk - hp).abs().max()), int((ik - ip).abs().max()),
                    int((dk != dp).any()))
        done_right = float((dk & (hk == ref).all(dim=1)).float().mean())
        result["done_right"][name] = done_right
        not_h = _done_not_h(g, hk, dk)
        rec = {"phase": phase, "code": code, "mode": name, "nm": nm, "frames": B,
               "agreement": agree, "frame_errors_kernel": int((hk != ref).any(dim=1).sum()),
               "frame_errors_plain": int((hp != ref).any(dim=1).sum()),
               "done_right": done_right, "done_not_h": not_h}
        if name in timed:
            p1 = cuda_ms(lambda: er.decode_plain(dec, llr), 1)
            k1 = cuda_ms(lambda: er.resident_decode(dec, llr), 5)
            k2 = cuda_ms(lambda: er.resident_decode(dec, llr), 5)
            p2 = cuda_ms(lambda: er.decode_plain(dec, llr), 1)
            rec.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                       ms_runs=[k1, k2], plain_ms_runs=[p1, p2],
                       **resident_ems_bound(g, B, int(ik.sum()), nm))
            result.update({k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
        emit(rec)
        if agree != 1.0 or not_h:
            fail(f"{phase} {code} mode {name}: agreement {agree} != 1.0 or "
                 f"{not_h} frames' done flags disagree with H")
    result["max_abs_err"] = worst
    return result


def phase_ems_resident(device):
    """K3 against its plain version on identical LLRs (gf16_n204_k102,
    offset 0.3): nm = 16 in the three modes at 2048 frames and at path A's
    sweep shape (2 x 8192 frames, 1.5 and 2.0 dB, 50 iterations, early
    termination), nm = 8, then the step of bench row ems_gf16_n204_k102
    (8192 frames, sigma 0.63, 50 iterations, throughput); agreement must be
    1.0. Timed in throughput mode, at the sweep shape and at the bench
    step, whose numbers go to the kernels summary. In every mode a frame
    is done exactly when its hard decision satisfies H."""
    g = _graph("gf16_n204_k102", device)
    small, sweep = _llrs(g, 2048, [1.5], device), _llrs(g, 8192, [1.5, 2.0], device)
    modes = {"a_early_term": (small, 50, True, True, 16),
             "b_throughput": (small, 50, False, False, 16),
             "c_one_iter": (small, 1, False, True, 16),
             "d_sweep_shape": (sweep, 50, True, True, 16),
             "e_nm8": (small, 50, True, True, 8),
             "f_bench_shape": (_bench_llrs("ems_gf16_n204_k102", g, device),
                               50, False, False, 16)}
    return _hold_ems("ems_resident", "gf16_n204_k102", g, modes,
                     ("b_throughput", "d_sweep_shape", "f_bench_shape"))


def phase_cn_tems(device):
    """K5 against its plain version (offset 2.0, config 4's) at GF(16),
    config 4's shape with the exact scan and n_r = 8, GF(256), then config
    4's shape at n_r = 8 on tie-heavy inputs (4 levels); then K5 with a
    frame list (CN_TEMS_LISTS)."""
    from nbldpc_tpu_torch.kernels import cn_tems

    cases = [("gf16_n204_k102", 8192, 0, 0), ("gf64_n576_k480", 1024, 0, 0),
             ("gf64_n576_k480", 1024, 8, 0), ("gf256_n255_k175", 512, 8, 0),
             ("gf64_n576_k480", 1024, 8, 4)]
    rows = [_hold_cn("cn_tems", device, code, B, cn_tems.cn_update,
                     cn_tems.cn_update_plain, (2.0, n_r),
                     lambda q, dc, _offset, n_r: tems_check_ops(q, dc, n_r), levels,
                     n_r=n_r, offset=2.0, tie_levels=levels)
            for code, B, n_r, levels in cases]
    _hold_cn_tems_lists(device)
    return rows


# K5 with a frame list (decode_bl's frames not yet done) at config 4's shape
# [96, 12, 64, 1024], n_r = 8: (label, the listed frames) 40% and 10% of
# the frames drawn at random, and the second of four slots of 256 frames
CN_TEMS_LISTS = [("active40", 0.4), ("active10", 0.1), ("slot2", "slot")]


def _hold_cn_tems_lists(device) -> None:
    """K5 and its plain version each given the same U, list and an output
    filled with 7.0: the listed columns of the two outputs equal (max abs
    error 0.0) and finite, every other column of both still 7.0, and K5's
    counter moved by the listed frames in one launch."""
    import torch

    from nbldpc_tpu_torch.kernels import cn_tems

    B = 1024
    U = _u_for(_graph("gf64_n576_k480", device), B, device)
    for label, share in CN_TEMS_LISTS:
        if share == "slot":
            listed = (torch.arange(B) >= B // 4) & (torch.arange(B) < B // 2)
        else:
            listed = torch.rand(B, generator=torch.Generator().manual_seed(11)) < share
        active = torch.nonzero(listed).flatten().to(torch.int32).to(device)
        listed = listed.to(device)
        out, ref = torch.full_like(U, 7.0), torch.full_like(U, 7.0)
        launches, frames = cn_tems.cn_update.launches, cn_tems.cn_update.frame_iterations
        got = cn_tems.cn_update(U, 2.0, 8, active, out)
        counted = (cn_tems.cn_update.launches - launches,
                   cn_tems.cn_update.frame_iterations - frames)
        cn_tems.cn_update_plain(U, 2.0, 8, active, ref)
        torch.cuda.synchronize()
        err = float((out[..., listed] - ref[..., listed]).abs().max())
        kept = bool((out[..., ~listed] == 7.0).all()) and bool((ref[..., ~listed] == 7.0).all())
        finite = bool(torch.isfinite(out[..., listed]).all())
        n = active.numel()
        emit({"phase": "cn_tems", "case": f"list_{label}", "shape": list(U.shape), "n_r": 8,
              "offset": 2.0, "listed": n, "max_abs_err": err, "others_untouched": kept,
              "finite": finite, "launches": counted[0], "frames_counted": counted[1]})
        if got is not out or err != 0.0 or not kept or not finite or counted != (1, n):
            fail(f"cn_tems list {label} ({n} of {B} frames): max abs err {err}, others "
                 f"untouched {kept}, finite {finite}, launches and frames {counted}")


def _counters():
    from nbldpc_tpu_torch.kernels import launch_counts

    return launch_counts()


def _reset_counters():
    from nbldpc_tpu_torch.kernels import reset_launch_counts

    reset_launch_counts()


def _ran_plain(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if k.endswith("_plain") and v}


def _sum_counts(*counts: dict) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


# The check-node kernels that run inside decode_bl, where the two routing
# kernels (phase routing) run beside them once an iteration each, after
# decode_bl's entry (prior_bl, phase sim_step) once a decode; and the
# kernels of every sim step around its decode (phase sim_step): the channel
# and the counters
DECODE_BL_KERNELS = ("cn_qspa", "cn_ems", "cn_ems_bubble", "cn_tems")
ROUTE_KERNELS = ("route_down", "route_up")
STEP_KERNELS = ("channel_llr", "count_errors")


def _path_kernels(kernel: str, step: bool = False) -> tuple:
    """The kernels a decode through `kernel` must launch: decode_bl's entry
    and the routing kernels too where `kernel` runs inside decode_bl; with
    `step`, a sim step's, the channel and the counters too."""
    path = (kernel, "prior_bl", *ROUTE_KERNELS) if kernel in DECODE_BL_KERNELS else (kernel,)
    return (*path, *STEP_KERNELS) if step else path


def _step_launches(kernel: str, iters: int, frames: int, grid: tuple = (0, 0)) -> dict:
    """The counters of one fixed-budget sim step of `frames` frames through
    `kernel`: a whole-decode kernel once, a check-node kernel and the
    routing kernels once an iteration, decode_bl's entry, the channel and
    the counters once; in decode_bl, its loop's iterations and the frames
    times those (K5's frames too: a fixed budget retires none); K0-cl's
    cluster kernel adds `grid`, its grid's blocks and clusters
    (_cluster_grid)."""
    out = {k: iters if k in DECODE_BL_KERNELS + ROUTE_KERNELS else 1
           for k in _path_kernels(kernel, step=True)}
    if kernel in DECODE_BL_KERNELS:
        out.update({"decode_bl.loop_iterations": iters,
                    "decode_bl.frame_iterations": frames * iters})
    if kernel == "cn_tems":
        out["cn_tems.frame_iterations"] = frames * iters
    if kernel == "qspa_resident_cl":
        out["qspa_cluster.grid_blocks"], out["qspa_cluster.frame_slots"] = grid
    return out


def _cluster_grid(code: str, frames: int, device) -> tuple:
    """(blocks, clusters) of the persistent grid K0-cl's f32 cluster kernel
    launches for `frames` frames of `code`: min(frames,
    cudaOccupancyMaxActiveClusters) clusters of the plan's size, a frame
    each."""
    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    dec = qr.ResidentQSPA(_graph(code, device), 1)
    clusters = min(frames, qr.cluster_occupancy(dec, device))
    return clusters * dec.cluster_plan.size, clusters


def _idle(counts: dict, kernel: str, step: bool = False) -> list:
    """The kernels of a path through `kernel` (a sim step's, with `step`)
    that `counts` shows never launched."""
    return [k for k in _path_kernels(kernel, step) if counts.get(k, 0) < 1]


def phase_highq_qspa(device):
    """`qspa.decode` through K0-cl ("resident") against `qspa.decode` through
    K1 inside decode_bl ("kernel") on the same LLRs, 20 iterations with
    early termination, at the shapes of phase resident_cl: the thresholds
    of the JAX package's own device test of its large-field resident
    kernel (symbol agreement > 0.99, done agreement > 0.95). Counters are
    zeroed just before each decode and read just after; returns the
    launches summed over the decodes."""
    import torch

    from nbldpc_tpu_torch.decoders import qspa

    total = {}
    for code, frames, snrs in HIGHQ:
        g = _graph(code, device)
        llr = _llrs(g, frames, snrs, device)
        out, counts = {}, {}
        for impl, kernel in (("resident", "qspa_resident_cl"), ("kernel", "cn_qspa")):
            _reset_counters()
            out[impl] = qspa.decode(g, llr, max_iters=20, early_term=True, cn_impl=impl)
            torch.cuda.synchronize()
            counts[impl] = _counters()
            if _idle(counts[impl], kernel) or _ran_plain(counts[impl]):
                fail(f"highq_qspa {code} {impl}: {kernel} did not run alone: "
                     f"{counts[impl]}")
        r, k = out["resident"], out["kernel"]
        sym = float((r.hard == k.hard).float().mean())
        done = float((r.done == k.done).float().mean())
        emit({"phase": "highq_qspa", "code": code, "frames": llr.shape[0],
              "ebn0_db": snrs, "symbol_agreement": sym, "done_agreement": done,
              "converged_resident": int(r.done.sum()), "converged_kernel": int(k.done.sum()),
              "launches": {impl: {n: v for n, v in c.items() if v}
                           for impl, c in counts.items()}})
        if not (sym > 0.99 and done > 0.95):
            fail(f"highq_qspa {code}: symbol agreement {sym}, done agreement {done}")
        total = _sum_counts(total, *counts.values())
    return total


# The flagship sweep (phases main and multi_rank): 2 x 8192 frames, 8192 a
# step, 50 iterations, early termination
FLAGSHIP_SWEEP = ["--code", "gf16_n204_k102_c8", "--decoder", "qspa", "--snr", "1.5", "2.0",
                  "--iters", "50", "--set", "sim.frames_per_step=8192",
                  "--set", "sim.max_frames=16384", "--set", "sim.max_frame_errors=1000000"]


def phase_main(main_b64: int):
    """The user's entry point, flagship config (K0); then a GF(64) QSPA run
    (K0-cl's cluster kernel) and a run on the OVERSIZE code (its scratch
    kernel), counters zeroed before each of the two and read after."""
    from nbldpc_tpu_torch import cli
    from nbldpc_tpu_torch.code import save_alist

    out_dir = ROOT / "build" / "nbldpc_tpu_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    rep16, rep64 = out_dir / "smoke_gf16.json", out_dir / "smoke_gf64.json"
    big, repbig = out_dir / "oversize_gf256_n1200.alist", out_dir / "smoke_oversize.json"
    save_alist(oversize_spec(), big)
    _reset_counters()
    t0 = time.perf_counter()
    rc16 = cli.main(["run", *FLAGSHIP_SWEEP, "--report", str(rep16)])
    t16 = time.perf_counter() - t0
    rc64 = cli.main(["run", "--code", "gf64_n576_k480", "--decoder", "qspa",
                     "--snr", "3.0", "--iters", "10",
                     "--set", f"sim.frames_per_step={main_b64}",
                     "--set", f"sim.max_frames={main_b64}",
                     "--report", str(rep64)])
    counts64 = _counters()
    _reset_counters()
    rcbig = cli.main(["run", "--code", str(big), "--decoder", "qspa",
                      "--snr", str(OVERSIZE_EBN0), "--iters", "10",
                      "--set", f"sim.frames_per_step={OVERSIZE_FRAMES}",
                      "--set", f"sim.max_frames={OVERSIZE_FRAMES}",
                      "--report", str(repbig)])
    countsbig = _counters()
    counts = _sum_counts(counts64, countsbig)
    r16 = json.loads(rep16.read_text())
    r64 = json.loads(rep64.read_text())
    rbig = json.loads(repbig.read_text())
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
          "fer_gf64": r64["fer"], "frames_gf64": r64["frames"],
          "fer_oversize": rbig["fer"], "frames_oversize": rbig["frames"]})
    if rc16 != 0 or rc64 != 0 or rcbig != 0:
        fail(f"cli.main returned {rc16}, {rc64}, {rcbig}")
    if (counts["qspa_resident"] < 1 or counts64["qspa_resident_cl"] < 1
            or countsbig["qspa_resident_cl_scratch"] < 1 or countsbig["qspa_resident_cl"]
            or _idle(counts64, "qspa_resident_cl", step=True)
            or _idle(countsbig, "qspa_resident_cl_scratch", step=True)):
        fail(f"a kernel of the main path never launched: {counts64}, {countsbig}")
    if _ran_plain(counts):
        fail(f"a plain version ran on the main path: {counts}")
    if not r16["fer"][1] < r16["fer"][0]:
        fail(f"FER(2.0 dB) {r16['fer'][1]} not below FER(1.5 dB) {r16['fer'][0]}")
    if not abs(z) < 3.3:
        fail(f"FER at 1.5 dB inconsistent with the reference: z = {z}")
    if not all(0.0 <= f <= 1.0 for f in r64["fer"]) or r64["frames"][0] != main_b64:
        fail(f"GF(64) run: bad report {r64}")
    if not all(0.0 <= f <= 1.0 for f in rbig["fer"]) or rbig["frames"][0] != OVERSIZE_FRAMES:
        fail(f"oversize run: bad report {rbig}")
    return counts


# Paths through the user's entry point: (name, cli arguments, the kernel it
# must launch, JAX FER record in fer_curves_r5.json, Eb/N0 of the
# comparison, frames per SNR point).
# BASELINE configs 1 and 2 as their files stand, but for the frames (16384,
# and no stop at a count of frame errors) and, for config 2, its points
# (1.5 dB of 1.0 ... 3.0); both decode through K0
BASELINE_QSPA_PATHS = [
    ("F_cfg1_gf4_qspa",
     ["--config", "configs/gf4_qspa_pr1.json", "--set", "sim.max_frames=16384"],
     "qspa_resident", "gf4_qspa_20it", 2.5, 16384),
    ("G_cfg2_gf16_qspa",
     ["--config", "configs/gf16_qspa_batch4k.json", "--set", "channel.ebn0_db=[1.5]",
      "--set", "sim.max_frames=16384"],
     "qspa_resident", "gf16_qspa_50it", 1.5, 16384),
]
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


def fer_records() -> list:
    """The JAX package's FER records: benchmarks/results/fer_curves_r5.json
    (all-zero codeword) and tests/data/fer_random_cw_jax.json (random
    codewords, for the configurations whose reference decoder is not
    codeword-symmetric; written by tests/fer_random_cw_jax.py)."""
    return [e for f in ("benchmarks/results/fer_curves_r5.json",
                        "tests/data/fer_random_cw_jax.json")
            for e in json.loads((ROOT / f).read_text())]


def phase_paths(phase: str, paths):
    """Paths through cli.main, counters zeroed just before each and read
    just after: the path's kernel launched, no plain version ran, FER falls
    from the first SNR point to the second, and the FER is consistent with
    the JAX record (|z| < 3.3). Returns each kernel's launches, summed over
    the paths."""
    from nbldpc_tpu_torch import cli

    out_dir = ROOT / "build" / "nbldpc_tpu_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    records = fer_records()
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
        if _idle(counts, kernel, step=True):
            fail(f"{name}: the kernels {_idle(counts, kernel, step=True)} never launched: "
                 f"{counts}")
        ran_plain = _ran_plain(counts)
        if ran_plain:
            fail(f"{name}: a plain version ran on the path: {ran_plain}")
        if not all(0.0 <= f <= 1.0 for f in r["fer"]) or set(r["frames"]) != {frames}:
            fail(f"{name}: bad report {r}")
        if len(r["fer"]) > 1 and not r["fer"][1] < r["fer"][0]:
            fail(f"{name}: FER({r['ebn0_db'][1]} dB) {r['fer'][1]} not below "
                 f"FER({r['ebn0_db'][0]} dB) {r['fer'][0]}")
        if not abs(z) < 3.3:
            fail(f"{name}: FER at {snr} dB inconsistent with {ref_name}: z = {z}")
        launches = _sum_counts(launches, counts)
    return launches


# BASELINE config 5 as the file stands (GF(256) (255,175), 8 Eb/N0 points,
# 20 iterations, early termination, 512 frames per point and step, stop at
# 200 frame errors), with sim.max_frames cut from 50000 to CFG5_FRAMES per
# point; `mesh` asks for 2 SNR groups and is ignored on one card. QSPA
# (K0-cl), then the EMS half (nm = 16, offset 0.1: K2).
CFG5 = "configs/gf256_sweep_2host.json"
CFG5_FRAMES = 2048
CFG5_PATHS = [
    ("a_cfg5_qspa", [], "qspa_resident_cl"),
    ("c_cfg5_ems", ["--decoder", "ems", "--set", "decoder.nm=16",
                    "--set", "decoder.offset=0.1"], "cn_ems"),
]
# GF(256) QSPA at 10 iterations, 2.5 dB, against the JAX record
CFG5_FER_PATH = [
    ("b_gf256_qspa_10it",
     ["--code", "gf256_n255_k175", "--decoder", "qspa", "--iters", "10", "--snr", "2.5",
      "--set", "sim.frames_per_step=4096", "--set", "sim.max_frames=16384"],
     "qspa_resident_cl", "gf256_qspa_10it", 2.5, 16384),
]


def phase_cfg5():
    """Config 5's two decoders through cli.main, counters zeroed just before
    each and read just after: its kernel launched, no plain version ran (and
    K1 not on the QSPA path), every point reached its stop rule, FER in
    [0, 1] and lower at the last point than at the first. Then the FER
    gate. Returns the launches summed over the paths."""
    from nbldpc_tpu_torch import cli

    out_dir = ROOT / "build" / "nbldpc_tpu_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = json.loads((ROOT / CFG5).read_text())
    errors_stop = cfg["sim"]["max_frame_errors"]
    launches = {}
    for name, extra, kernel in CFG5_PATHS:
        rep = out_dir / f"smoke_{name}.json"
        _reset_counters()
        t0 = time.perf_counter()
        rc = cli.main(["run", "--config", CFG5, *extra,
                       "--set", f"sim.max_frames={CFG5_FRAMES}", "--report", str(rep)])
        seconds = time.perf_counter() - t0
        counts = _counters()
        r = json.loads(rep.read_text())
        emit({"phase": "main_cfg5", "path": name, "config": CFG5,
              "reduced": {"sim.max_frames": [cfg["sim"]["max_frames"], CFG5_FRAMES]},
              "launches": counts, "seconds": seconds, "ebn0_db": r["ebn0_db"],
              "fer": r["fer"], "frames": r["frames"], "frame_errors": r["frame_errors"],
              "avg_iters": r["avg_iters"]})
        if rc != 0:
            fail(f"{name}: cli.main returned {rc}")
        if _idle(counts, kernel, step=True):
            fail(f"{name}: the kernels {_idle(counts, kernel, step=True)} never launched: "
                 f"{counts}")
        if _ran_plain(counts) or (kernel == "qspa_resident_cl" and (
                counts["cn_qspa"] or counts["route_down"] or counts["route_up"])):
            fail(f"{name}: another implementation ran on the path: {counts}")
        stopped = all(f >= CFG5_FRAMES or e >= errors_stop
                      for f, e in zip(r["frames"], r["frame_errors"]))
        if (r["ebn0_db"] != cfg["channel"]["ebn0_db"] or not stopped
                or not all(0.0 <= f <= 1.0 for f in r["fer"])):
            fail(f"{name}: bad report {r}")
        if not r["fer"][-1] < r["fer"][0]:
            fail(f"{name}: FER at {r['ebn0_db'][-1]} dB not below {r['ebn0_db'][0]} dB")
        launches = _sum_counts(launches, counts)
    return _sum_counts(launches, phase_paths("main_cfg5", CFG5_FER_PATH))


# Phase random_cw. The whole-decode kernels on LLRs of random codewords:
# (the kernel that must launch, code, iterations, Eb/N0 points, frames a
# point); at the first point some frames fail, at the second >= 99% must be
# done and right in the early-termination mode. K0 on the flagship code,
# GF(4) and the K0_GF32 code, K0-cl's cluster kernel at GF(64) and GF(256),
# its scratch kernel on OVERSIZE, K3 on GF(16) (nm 16, offset 0.3).
RANDOM_CW_HOLDS = [
    ("qspa_resident", "gf16_n204_k102_c8", 50, (1.5, 2.5), 2048),
    ("qspa_resident", "gf4_n96_k48", 20, (2.5, 4.5), 2048),
    ("qspa_resident", "gf32_random", 50, (1.5, 3.5), K0_GF32_FRAMES),
    ("qspa_resident_cl", "gf64_n576_k480", 20, (3.5, 4.0), 1024),
    ("qspa_resident_cl", "gf256_n255_k175", 20, (2.0, 3.0), 512),
    ("qspa_resident_cl_scratch", "oversize_gf256_n1200", 20, (2.0, 2.5), OVERSIZE_FRAMES),
    ("ems_resident", "gf16_n204_k102", 50, (1.5, 3.0), 2048),
]
# The paths of phases 10-14 that carry a FER record, in random-codeword
# mode: the flagship (K0), GF(256) QSPA (K0-cl), GF(16) EMS (K3), GF(256)
# classic EMS (K2) and config 4's T-EMS (K5). Under channel and decoder
# symmetry the all-zero-codeword record is the yardstick; where the JAX
# package's own FER depends on the codeword (EMS with nm < q breaks ties
# toward the lowest symbol), its random-codeword record is.
RANDOM_CW_PATHS = [
    (f"R_{name}", [*args, "--random-codewords"], kernel, ref, snr, frames)
    for name, args, kernel, ref, snr, frames in (
        ("gf16_qspa_c8",
         ["--code", "gf16_n204_k102_c8", "--decoder", "qspa", "--snr", "1.5", "2.0",
          "--iters", "50", "--set", "sim.frames_per_step=8192",
          "--set", "sim.max_frames=16384"],
         "qspa_resident", "gf16_qspa_c8_50it", 1.5, 16384),
        *CFG5_FER_PATH, *EMS_PATHS[:2], TEMS_PATHS[0])]


def _cw_llrs(g, frames: int, ebn0: float, device, seed: int):
    """(LLRs [frames, N, q], codewords [frames, N]) of random codewords at
    ebn0 dB: the info symbols and the noise from one generator, the
    codewords from the port's encoder on the card."""
    import torch

    from nbldpc_tpu_torch.channel import ebn0_to_sigma, transmit
    from nbldpc_tpu_torch.encode import Encoder
    from nbldpc_tpu_torch.sim import step_generator

    gen = step_generator(seed, 0, device)
    enc = Encoder(g.spec, device)
    u = torch.randint(0, g.q, (frames, enc.k), generator=gen, device=device, dtype=torch.int32)
    cw = enc.encode(u)
    sigma = float(ebn0_to_sigma(ebn0, g.spec.k / g.n))
    return transmit(gen, cw, sigma, g.q).contiguous(), cw


def _smoke_spec(code: str):
    """A code of this script by name: codes/<name>, or one made from a seed."""
    from nbldpc_tpu_torch.code import random_regular_spec
    from nbldpc_tpu_torch.utils.config import CodeConfig

    made = {"gf32_random": lambda: random_regular_spec(*K0_GF32),
            "gf4_dv3_random": lambda: random_regular_spec(*K0_DV3),
            "oversize_gf256_n1200": lambda: oversize_spec(256),
            "oversize_gf64_n2400": lambda: oversize_spec(64)}
    return made[code]() if code in made else CodeConfig(name=code).load()


def encoder_bound(spec, B: int) -> dict:
    """The encoder's bound: the product (u bits [B, K p] @ G [K p, M p],
    two operations a term, at the f32 peak), and its bytes: u read, G read,
    the codewords written (int32)."""
    p = spec.q.bit_length() - 1
    k = spec.n - spec.m
    return bound(2 * B * (k * p) * (spec.m * p), 4 * (B * k + k * p * spec.m * p + B * spec.n))


def phase_random_cw(device, card: str):
    """Random codewords on the card. 1: the encoder on the card equals the
    encoder on the CPU bit for bit, on every codes/*.alist and the codes
    this script makes (OVERSIZE, OVERSIZE_GF64, K0_GF32, K0_DV3), at 8192
    frames for q <= 32 and 4096 above, and H c = 0 for every frame
    (graph.syndrome_bl on the card). 2: RANDOM_CW_HOLDS, each kernel
    against its plain version on the same LLRs in the modes of phase 4
    (K0 and K0-cl to its thresholds, K3 frame for frame), done exactly when
    H hard = 0, and at the second Eb/N0 >= 99% of frames done with hard ==
    cw under early termination. 3: RANDOM_CW_PATHS through cli.main, as
    phase_paths holds them. 4: the flagship bench step (8192 frames x 50
    iterations, sigma 0.63) in both modes and the encoder alone, by CUDA
    events. Returns the paths' launches."""
    import torch

    from nbldpc_tpu_torch import bench
    from nbldpc_tpu_torch.encode import Encoder
    from nbldpc_tpu_torch.graph import TannerGraph
    from nbldpc_tpu_torch.sim import make_sim_step, step_generator
    from nbldpc_tpu_torch.utils.config import DecoderConfig

    codes = sorted(p.stem for p in (ROOT / "codes").glob("*.alist"))
    for code in (*codes, "oversize_gf256_n1200", "oversize_gf64_n2400", "gf32_random",
                 "gf4_dv3_random"):
        spec = _smoke_spec(code)
        B = 8192 if spec.q <= 32 else 4096
        enc = Encoder(spec, device)
        gen = step_generator(77, 0, device)
        u = torch.randint(0, spec.q, (B, enc.k), generator=gen, device=device,
                          dtype=torch.int32)
        cw = enc.encode(u)
        same = bool(torch.equal(cw.cpu(), Encoder(spec, "cpu").encode(u.cpu())))
        g = TannerGraph(spec, device)
        bad_h = int((g.syndrome_bl(cw.T) != 0).any(dim=0).sum())
        rec = {"phase": "random_cw", "part": "encoder", "code": code, "frames": B,
               "equal_to_cpu": same, "frames_failing_h": bad_h,
               "nonzero_symbols": float((cw != 0).float().mean())}
        emit(rec)
        if not same or bad_h:
            fail(f"random_cw: the encoder on {code}: equal to the CPU's {same}, "
                 f"{bad_h} codewords fail H")

    for kernel, code, iters, snrs, frames in RANDOM_CW_HOLDS:
        g = TannerGraph(_smoke_spec(code), device)
        for i, ebn0 in enumerate(snrs):
            llr, cw = _cw_llrs(g, frames, ebn0, device, seed=100 + i)
            modes = {"a_early_term": (llr, iters, True, True),
                     "b_throughput": (llr, iters, False, False),
                     "c_one_iter": (llr, 1, False, True)}
            label = f"{code}@{ebn0}dB"
            _reset_counters()
            if kernel == "ems_resident":
                right = _hold_ems("random_cw", label, g,
                                  {k: (*v, 16) for k, v in modes.items()}, cw=cw)["done_right"]
            else:
                right = _hold_resident("random_cw", label, g, modes, (), cw=cw)["done_right"]
            counts = _counters()
            launched = {k: counts[k] for k in ("qspa_resident", "qspa_resident_cl",
                                               "qspa_resident_cl_scratch", "ems_resident")}
            if launched[kernel] != len(modes) or sum(launched.values()) != len(modes):
                fail(f"random_cw {label}: {kernel} did not decode alone: {launched}")
            if i == 1 and right["a_early_term"] < 0.99:
                fail(f"random_cw {label}: {right['a_early_term']} of frames done "
                     f"and right, below 0.99")

    # the random-codeword record where the reference has one (its decoder
    # is not codeword-symmetric there), else the all-zero record
    have = {e["config"] for e in fer_records()}
    launches = phase_paths("random_cw", [
        (name, args, kernel, f"{ref}_random_cw" if f"{ref}_random_cw" in have else ref,
         snr, frames) for name, args, kernel, ref, snr, frames in RANDOM_CW_PATHS])

    row = bench.ROWS_BY_NAME["qspa_gf16_n204_k102_c8"]
    spec = _smoke_spec(row.code)
    g = TannerGraph(spec, device)
    dec = DecoderConfig(kind="qspa", max_iters=row.iters, early_term=False,
                        stats_each_iter=False)
    enc = Encoder(spec, device)
    steps = {"zero": make_sim_step(g, dec, row.batch, 1),
             "random": make_sim_step(g, dec, row.batch, 1, enc)}
    sig = torch.tensor([row.noise], dtype=torch.float32, device=device)
    gen = step_generator(0, 0, device)
    ms = {k: [] for k in steps}
    for mode in ("zero", "random", "random", "zero"):
        ms[mode].append(cuda_ms(lambda m=mode: steps[m](gen, sig), 10))
    u = torch.randint(0, spec.q, (1, row.batch, enc.k), generator=gen, device=device,
                      dtype=torch.int32)
    enc_runs = [cuda_ms(lambda: enc.encode(u), 50) for _ in range(2)]
    step_zero, step_random = (sum(ms[k]) / 2 for k in ("zero", "random"))
    enc_ms = sum(enc_runs) / 2
    emit({"phase": "random_cw", "part": "timing", "row": row.name, "card": card,
          "step_ms_zero_codeword": step_zero, "step_ms_random_codeword": step_random,
          "random_minus_zero_ms": step_random - step_zero,
          "step_ms_runs": ms, "encoder_ms": enc_ms, "encoder_ms_runs": enc_runs,
          "encoder_share_of_random_step": enc_ms / step_random,
          **{f"encoder_{k}": v for k, v in encoder_bound(spec, row.batch).items()}})
    return launches


# Phase resident_bf16. bf16 message storage (mm_precision="bf16"): the
# holds, (label, kernel, code, Eb/N0 points, frames a point, iterations),
# each in the modes a_early_term, b_throughput (timed beside the f32 build)
# and c_one_iter: K0 at the flagship and GF(4) (96,48); K0-cl's cluster
# kernel at config 5's code (a cluster of 4 in bf16) and GF(64) (576,480)
# (2); its scratch kernel on OVERSIZE (no bf16 cluster holds it) and,
# called directly, on OVERSIZE_GF64 (a bf16 cluster of 8 holds it).
BF16_HOLDS = [
    ("k0_flagship", "qspa_resident", "gf16_n204_k102_c8", [1.5], 2048, 50),
    ("k0_gf4", "qspa_resident", "gf4_n96_k48", [2.5], 8192, 20),
    ("k0cl_cfg5", "qspa_resident_cl", "gf256_n255_k175", [2.0, 2.5], 512, 20),
    ("k0cl_gf64", "qspa_resident_cl", "gf64_n576_k480", [3.0, 3.5], 1024, 20),
    ("scratch_gf256", "qspa_resident_cl_scratch", "oversize_gf256_n1200", [2.5],
     OVERSIZE_FRAMES, 20),
    ("scratch_gf64", "qspa_resident_cl_scratch", "oversize_gf64_n2400", [2.5],
     OVERSIZE_FRAMES, 20),
]
# the bench rows' steps of the two bf16 rows, held and timed as well
BF16_BENCH = {"k0_flagship": "qspa_gf16_n204_k102_c8_bf16",
              "k0cl_cfg5": "qspa_gf256_n255_k175_bf16"}
# random codewords: (label, code, Eb/N0, frames, iterations)
BF16_RANDOM_CW = [("k0_flagship", "gf16_n204_k102_c8", 2.0, 2048, 50),
                  ("k0cl_cfg5", "gf256_n255_k175", 2.5, 512, 20),
                  ("scratch_gf256", "oversize_gf256_n1200", 2.5, OVERSIZE_FRAMES, 20)]
# tests/test_pallas.py:test_resident_kernel_bf16_device (the JAX package's
# device test of its bf16 mode): make_peg_code(204, 102, 16, dv=2,
# seed=1), 256 random codewords at 2.0 dB, 20 iterations, throughput; on
# K0 there, on K0-cl at config 5's code (2.0 dB: ~20% of frames fail
# within 10 iterations)
BF16_INVARIANTS = [("k0", (204, 102, 16, 2, 1), 2.0), ("k0cl", "gf256_n255_k175", 2.0)]
# the FER gates of phases main and main_cfg5 with the state in bf16,
# against the same JAX records (|z| < 3.3), and the scratch kernel's path
BF16_PATHS = [
    ("H_flagship_bf16", [*FLAGSHIP_SWEEP, "--set", "decoder.mm_precision=bf16"],
     "qspa_resident_bf16", "gf16_qspa_c8_50it", 1.5, 16384),
    ("I_gf256_qspa_10it_bf16", [*CFG5_FER_PATH[0][1], "--set", "decoder.mm_precision=bf16"],
     "qspa_resident_cl_bf16", "gf256_qspa_10it", 2.5, 16384),
]


def _bf16_invariants(label, g, llr, cw, fn) -> dict:
    """JAX's device-test invariants of bf16 against f32 on one kernel: more
    than 128 frames converge under both; the frames converged under both
    agree on > 99.9% of symbols; the converged counts differ by at most
    max(8, 3 sigma); fe16 <= fe32 + max(6, 0.15 fe32) frame errors against
    the codewords."""
    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    out = {}
    for p in ("f32", "bf16"):
        out[p] = fn(qr.ResidentQSPA(g, 20, False, False, p), llr)
    (h32, d32, _), (h16, d16, _) = out["f32"], out["bf16"]
    both = d32 & d16
    nfr = d32.shape[0]
    p32 = float(d32.sum()) / nfr
    sigma = math.sqrt(max(p32 * (1 - p32), 0.02) * nfr)
    fe32 = int((h32 != cw).any(dim=1).sum())
    fe16 = int((h16 != cw).any(dim=1).sum())
    agree = float((h32[both] == h16[both]).float().mean()) if int(both.sum()) else 0.0
    rec = {"phase": "resident_bf16", "part": "jax_device_invariants", "kernel": label,
           "frames": nfr, "converged_both": int(both.sum()),
           "converged_f32": int(d32.sum()), "converged_bf16": int(d16.sum()),
           "symbol_agreement_converged": agree,
           "converged_diff_limit": max(8, int(3 * sigma)),
           "frame_errors_f32": fe32, "frame_errors_bf16": fe16,
           "frame_errors_limit": fe32 + max(6, int(0.15 * fe32))}
    rec["held"] = bool(rec["converged_both"] > 128 and agree > 0.999
                       and abs(rec["converged_f32"] - rec["converged_bf16"])
                       <= rec["converged_diff_limit"]
                       and fe16 <= rec["frame_errors_limit"])
    emit(rec)
    if not rec["held"]:
        fail(f"resident_bf16: JAX's bf16 device invariants fail on {label}: {rec}")
    return rec


def phase_resident_bf16(device, card: str):
    """bf16 message storage. A: each bf16 kernel against its bf16 plain
    version (BF16_HOLDS, the bench rows' steps, BF16_RANDOM_CW), as
    _hold_resident holds the f32 builds, timed beside its f32 build with
    both builds' plans. B: JAX's device-test invariants (BF16_INVARIANTS).
    C: the FER gates (BF16_PATHS) and the scratch kernel's path (the
    OVERSIZE code) through cli.main, counters zeroed before each and read
    after. Returns (the kernels summary records by label, the paths'
    launches)."""
    from nbldpc_tpu_torch import bench, cli
    from nbldpc_tpu_torch.code import save_alist
    from nbldpc_tpu_torch.codegen import make_peg_code
    from nbldpc_tpu_torch.graph import TannerGraph
    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    fns = {"qspa_resident": qr.resident_decode, "qspa_resident_cl": qr.resident_decode_cl,
           "qspa_resident_cl_scratch": qr.resident_decode_cl_scratch}
    summary = {}
    for label, kernel, code, snrs, frames, iters in BF16_HOLDS:
        g = TannerGraph(_smoke_spec(code), device)
        llr = _llrs(g, frames, snrs, device)
        modes = {"a_early_term": (llr, iters, True, True),
                 "b_throughput": (llr, iters, False, False),
                 "c_one_iter": (llr, 1, False, True)}
        timed = ("b_throughput",)
        if label in BF16_BENCH:
            row = bench.ROWS_BY_NAME[BF16_BENCH[label]]
            modes["d_bench_shape"] = (_llrs(g, row.batch, [row.noise], device, row.ebn0),
                                      row.iters, False, False)
            timed = ("d_bench_shape",)
        fn = fns[kernel]
        _reset_counters()
        res = _hold_resident("resident_bf16", code, g, modes, timed, precision="bf16", fn=fn)
        counts = _counters()
        # (the f32 build's launches: its timing beside)
        if counts[f"{kernel}_bf16"] < len(modes) or any(
                counts[f"{k}_bf16"] for k in fns if k != kernel):
            fail(f"resident_bf16 {label}: {kernel}'s bf16 build did not decode alone: {counts}")
        for _, _, ebn0_cw, f_cw, it_cw in [c for c in BF16_RANDOM_CW if c[0] == label]:
            llr_cw, cw = _cw_llrs(g, f_cw, ebn0_cw, device, seed=300)
            r = _hold_resident("resident_bf16", f"{code}@{ebn0_cw}dB_random_cw", g,
                               {"a_early_term": (llr_cw, it_cw, True, True),
                                "b_throughput": (llr_cw, it_cw, False, False)}, (),
                               cw=cw, precision="bf16", fn=fn)
            res["agreement_min"] = min(res["agreement_min"], r["agreement_min"])
            res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])
        summary[label] = res

    for label, code, ebn0 in BF16_INVARIANTS:
        if label == "k0":
            n, m, q, dv, seed = code
            g = TannerGraph(make_peg_code(n, m, q, dv=dv, seed=seed), device)
            fn = qr.resident_decode
        else:
            g = _graph(code, device)
            fn = qr.resident_decode_cl
        llr, cw = _cw_llrs(g, 256, ebn0, device, seed=5)
        _bf16_invariants(label, g, llr, cw, fn)

    launches = phase_paths("resident_bf16", BF16_PATHS)
    out_dir = ROOT / "build" / "nbldpc_tpu_torch"
    big, rep = out_dir / "oversize_gf256_n1200.alist", out_dir / "smoke_oversize_bf16.json"
    save_alist(oversize_spec(), big)
    _reset_counters()
    rc = cli.main(["run", "--code", str(big), "--decoder", "qspa", "--snr", str(OVERSIZE_EBN0),
                   "--iters", "10", "--set", f"sim.frames_per_step={OVERSIZE_FRAMES}",
                   "--set", f"sim.max_frames={OVERSIZE_FRAMES}",
                   "--set", "decoder.mm_precision=bf16", "--report", str(rep)])
    counts = _counters()
    r = json.loads(rep.read_text())
    emit({"phase": "resident_bf16", "path": "J_oversize_bf16", "launches": counts,
          "fer": r["fer"], "frames": r["frames"]})
    if (rc != 0 or counts["qspa_resident_cl_scratch_bf16"] < 1 or _ran_plain(counts)
            or counts["qspa_resident_cl_scratch"] or counts["qspa_resident_cl_bf16"]
            or r["frames"][0] != OVERSIZE_FRAMES or not 0.0 <= r["fer"][0] <= 1.0):
        fail(f"resident_bf16: the scratch kernel's bf16 path: rc {rc}, {counts}, {r}")
    return summary, _sum_counts(launches, counts)


# Phase fer_harness: (module, its arguments, the kernels that must launch);
# each writes <module>_smoke.json into build/nbldpc_tpu_torch/
FER_HARNESS_FRAMES = 4096
FER_HARNESS_RUNS = [
    ("fer_curves", ["--only", "gf4_qspa_c8_20it", "--max-frames", str(FER_HARNESS_FRAMES)],
     _path_kernels("qspa_resident", step=True)),
    ("fer_curves", ["--only", "gf256_ems_bubble_10it", "--max-frames", str(FER_HARNESS_FRAMES)],
     _path_kernels("cn_ems_bubble", step=True)),
    ("offset_sweep", ["--only", "gf64_tems_nr8", "--offsets", "1.5,2.0"],
     _path_kernels("cn_tems", step=True)),
    ("ber_precision", ["--frames", str(FER_HARNESS_FRAMES), "--snrs", "1.5", "2.0"],
     ("qspa_resident", "qspa_resident_bf16", *STEP_KERNELS)),
]


def phase_fer_harness():
    """The three harness entry points (FER_HARNESS_RUNS) on the card,
    counters zeroed just before each and read just after: its kernels
    launched and no plain version ran. Then their records: the configs,
    points and keys expected, and compare_records holding the fer_curves
    points to fer_curves_r5.json, the offset rows to offset_sweep_r5.json
    and, as a sanity check against gross disagreement (the two decode
    the same noise), ber_precision's bf16 points to its f32 points.
    Returns the launches summed over the runs."""
    import torch

    from nbldpc_tpu_torch import benchmarks
    from nbldpc_tpu_torch.benchmarks import ber_precision, fer_curves, offset_sweep

    out_dir = ROOT / "build" / "nbldpc_tpu_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    mods = {"fer_curves": fer_curves, "offset_sweep": offset_sweep,
            "ber_precision": ber_precision}
    files = {name: out_dir / f"{name}_smoke.json" for name in mods}
    for f in files.values():
        f.unlink(missing_ok=True)
    launches = {}
    for name, args, kernels in FER_HARNESS_RUNS:
        _reset_counters()
        t0 = time.perf_counter()
        rc = mods[name].main([*args, "--tag", "smoke", "--out", str(out_dir)])
        seconds = time.perf_counter() - t0
        counts = _counters()
        emit({"phase": "fer_harness", "run": name, "args": args, "seconds": seconds,
              "launches": {k: v for k, v in counts.items() if v}})
        if rc != 0:
            fail(f"fer_harness {name} {args}: main returned {rc}")
        idle = [k for k in kernels if counts[k] < 1]
        if idle or _ran_plain(counts):
            fail(f"fer_harness {name} {args}: kernels {idle} never launched, or a plain "
                 f"version ran: {counts}")
        launches = _sum_counts(launches, counts)

    card = benchmarks.device_fields(torch.device("cuda", 0))
    try:
        recs = {name: json.loads(f.read_text()) for name, f in files.items()}
    except (OSError, ValueError) as e:
        fail(f"fer_harness: a record file is missing or malformed: {e}")
    curves, offsets, (prec,) = recs["fer_curves"], recs["offset_sweep"], recs["ber_precision"]
    ref_keys = set(json.loads((ROOT / "benchmarks/results/fer_curves_r5.json").read_text())[0])
    sweeps = {s[0]: s for s in fer_curves.SWEEPS}
    stops = {a.only: a for a in (fer_curves.parser().parse_args(args)
                                 for name, args, _ in FER_HARNESS_RUNS if name == "fer_curves")}
    if ([r["config"] for r in curves] != ["gf256_ems_bubble_10it", "gf4_qspa_c8_20it"]
            or any(set(r) != ref_keys | set(card) or r["card"] != card["card"]
                   or r["ebn0_db"] != sweeps[r["config"]][3]
                   or not all(0.0 <= f <= 1.0 for f in r["fer"])
                   or not all(f >= stops[r["config"]].max_frames or e >= stops[r["config"]].max_fe
                              for f, e in zip(r["frames"], r["frame_errors"]))
                   for r in curves)):
        fail(f"fer_harness: bad fer_curves records {curves}")
    if ([r["config"] for r in offsets] != ["gf64_tems_nr8_20it"]
            or [row["offset"] for row in offsets[0]["rows"]] != [1.5, 2.0]
            or offsets[0]["best_offset"] not in (1.5, 2.0) or offsets[0]["card"] != card["card"]):
        fail(f"fer_harness: bad offset_sweep record {offsets}")
    modes = prec.get("modes", {})
    if (set(modes) != {"f32", "bf16"} or prec["card"] != card["card"]
            or any(m["frames"] != [FER_HARNESS_FRAMES] * 2 or not all(
                0.0 <= f <= 1.0 for f in m["fer"]) for m in modes.values())):
        fail(f"fer_harness: bad ber_precision record {prec}")

    for label, port, ref in (
            ("fer_curves", curves, "benchmarks/results/fer_curves_r5.json"),
            ("offset_sweep", offsets, "benchmarks/results/offset_sweep_r5.json"),
            ("bf16_vs_f32", ber_precision.as_curve(prec, "bf16"),
             ber_precision.as_curve(prec, "f32"))):
        if isinstance(ref, str):
            ref = json.loads((ROOT / ref).read_text())
        cmp = fer_curves.compare_records(port, ref)
        emit({"phase": "fer_harness", "compare": label, "held": cmp["held"],
              "threshold": cmp["threshold"], "ok": cmp["ok"],
              "points": [[p["config"], p["x"], p["port"], p["reference"], p["z"], p["held"]]
                         for p in cmp["points"]]})
        if not cmp["ok"]:
            fail(f"fer_harness {label}: {cmp['held']} points held, failed: {cmp['failed']}")
    return launches


def phase_bench(card: str):
    from nbldpc_tpu_torch import bench

    rows = []
    for row in bench.ROWS:
        # plain first and last, the kernel path in the middle
        for impl in (*row.impls[::-1], *row.impls):
            rec = bench.measure(row, impl, reps=10 if impl == row.impls[0] else 3)
            rec.update(phase="bench", card=card)
            emit(rec)
            rows.append(rec)
    return rows


# The probe kernels of phase 17: (name, source, the TPU kernels they replace)
MICRO_KERNELS = [
    ("micro_flat_gather", "micro_gather.cu", "benchmarks/micro_pallas.py:54"),
    ("micro_row_moves", "micro_gather.cu", "benchmarks/micro_pallas.py:73"),
    ("micro_onehot_gemm", "micro_onehot_gemm.cu", "benchmarks/micro_pallas.py:96"),
    ("micro_cn_iteration", "micro_cn.cu", "benchmarks/micro_pallas.py:119"),
    ("micro_rot_softmax", "micro_layout.cu", "benchmarks/micro_layout.py:61"),
    ("micro_route", "micro_layout.cu",
     "benchmarks/micro_layout.py:79, benchmarks/micro_layout.py:145"),
]
# micro_layout's default depth (phase 17 also holds the kernels at 4x it)
MICRO_LAYOUT_ITERS = 50
# the deeper depth at which phase 17 also holds P1 and P2 (10x the entry
# point's 20)
MICRO_GATHER_DEEP = 200


def _equal_err(out, ref) -> float:
    """Max abs error over the entries that differ (0.0 when all are equal,
    inf included; NaN where a NaN differs)."""
    differ = out != ref
    return float((out - ref).abs()[differ].max()) if bool(differ.any()) else 0.0


def micro_bounds(name: str, inputs: dict, iters: int) -> dict:
    """The bound of one probe call: each input read once, each output
    written once; operations as its docstring in csrc counts them."""
    if name in ("micro_flat_gather", "micro_row_moves", "micro_onehot_gemm",
                "micro_cn_iteration"):
        E, Q, BT = inputs["x"].shape
        R, xb = E * Q, 4 * 2 * E * Q * BT
        if name == "micro_flat_gather":
            return bound(iters * R * BT, xb + 4 * R)
        if name == "micro_row_moves":
            return bound(iters * R * BT, xb + 4 * (R + E))
        if name == "micro_onehot_gemm":
            # the arithmetic the kernel does, three TF32 tensor-core
            # products; the one f32 product's bound beside it
            return {**bound(iters * 3 * 2 * R * R * BT, xb + 4 * R * R, PEAK_TF32_OPS),
                    "bound_f32_ms": bound(iters * 2 * R * R * BT, xb + 4 * R * R)["bound_ms"]}
        # normalize (Q adds, Q divides), two WHTs, 1.5 products, scale, floor
        per_elem = 5.5 + 2 * (Q.bit_length() - 1)
        return bound(iters * per_elem * R * BT, xb)
    if name == "micro_rot_softmax":
        x = inputs["x"]
        Q = x.shape[0]
        cols = x.numel() // Q
        # 4 bits x (Q - 1) rolled elements x (2 multiplies, 1 add); exp,
        # the serial sum, divide and subtract over Q; beside it the floor of
        # the special-function units: Q exps a column and iteration at 16
        # MUFU.EX2 a clock an SM
        sms, hz = sm_count_and_clock()
        return {**bound(iters * cols * (12 * (Q - 1) + 4 * Q - 1),
                        4 * (2 * x.numel() + inputs["rb"].numel())),
                "sfu_floor_ms": iters * cols * Q / (16 * sms * hz) * 1e3,
                "sm_clock_hz": hz}
    post, vn, nbr = inputs["post"], inputs["vn"], inputs["nbr"]
    Q = post.shape[0]
    N = nbr.shape[0]
    frames = post.numel() // (Q * N)
    E = vn.numel()
    reached = int((nbr[:, 0] >= 0).sum())          # nodes with an edge
    # per (q, frame): E scales, E - reached adds, and the blend of N nodes
    per = Q * (E + (E - reached) + 3 * N)
    return bound(iters * frames * per,
                 4 * (2 * post.numel() + E + nbr.numel()))


def sm_count_and_clock() -> tuple:
    """(SMs, the card's maximum SM clock in Hz, from nvidia-smi)."""
    import torch

    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout
    return (torch.cuda.get_device_properties(0).multi_processor_count,
            float(mhz.strip().splitlines()[0]) * 1e6)


def _hold_micro(name: str, case: str, kernel, plain, inputs: dict, hold_iters: tuple,
                time_iters: int, library=None, exact_inf=False) -> dict:
    """One probe kernel against its plain version on the same inputs at
    each depth of hold_iters; then both timed at time_iters, plain, kernel,
    kernel, plain, with the library call (if any) beside, all by cuda_ms;
    the kernel also queued behind a sleep (queued_ms: a probe call is tens
    of microseconds, as short as the wrapper's host time). kernel(iters) and
    plain(iters) run the probe. Every probe kernel repeats its plain
    version's operations in the same order (P4's IEEE divisions and P5's
    expf included, measured on the H100), so max abs error must be 0.0;
    with exact_inf the outputs may hold +-inf."""
    import torch

    err, finite, inf_entries = 0.0, True, 0
    for iters in hold_iters:
        out, ref = kernel(iters), plain(iters)
        torch.cuda.synchronize()
        err = max(err, _equal_err(out, ref))
        finite = finite and bool(torch.isfinite(out).all())
        inf_entries = max(inf_entries, int(torch.isinf(ref).sum()))
    row = {"phase": "micro", "kernel": name, "case": case, "hold_iters": list(hold_iters),
           "max_abs_err": err, "finite": finite, "inf_entries": inf_entries,
           "iters": time_iters}
    p1 = cuda_ms(lambda: plain(time_iters), 3)
    k1 = cuda_ms(lambda: kernel(time_iters), 20)
    k2 = cuda_ms(lambda: kernel(time_iters), 20)
    p2 = cuda_ms(lambda: plain(time_iters), 3)
    row.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, ms_runs=[k1, k2],
               plain_ms_runs=[p1, p2], queued_ms=queued_ms(lambda: kernel(time_iters), 20),
               library_ms=None, **micro_bounds(name, inputs, time_iters))
    if library is not None:
        out = kernel(time_iters)
        row["library_err"] = _equal_err(out, library())
        row["library_ms"] = (cuda_ms(library, 3) + cuda_ms(library, 3)) / 2
    emit(row)
    if err != 0.0 or not (finite or exact_inf):
        fail(f"micro {case}: max abs err {err} against the plain version, "
             f"finite {finite}")
    if library is not None and row["library_err"] != 0.0:
        fail(f"micro {case}: the library call differs by {row['library_err']}")
    return row


def phase_micro(device, card: str):
    """P1-P7. The entry points as a user runs them (counters zeroed just
    before, read just after), then each kernel against its plain version at
    the JAX scripts' full shapes: P1-P4 at their 20 iterations (P1 and P2
    held at 200 as well), P5-P7 held at micro_layout's deeper depth (200:
    the route passes +-inf there) and timed at its default 50. Returns
    (launches, the timed row by kernel with its worst error over the
    kernel's cases)."""
    import torch

    from nbldpc_tpu_torch.benchmarks import micro_kernels as mk
    from nbldpc_tpu_torch.benchmarks import micro_layout as ml
    from nbldpc_tpu_torch.kernels import micro

    _reset_counters()
    t0 = time.perf_counter()
    rcs = [mk.main(["--reps", "20"]),
           ml.main(["--iters", str(MICRO_LAYOUT_ITERS), "--reps", "6"])]
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in _counters().items() if k.startswith("micro_")}
    emit({"phase": "micro", "entry_points": ["micro_kernels", "micro_layout"], "rcs": rcs,
          "launches": counts, "seconds": seconds, "card": card})
    idle = [k for k, v in counts.items() if v < 1]
    if rcs != [0, 0] or idle:
        fail(f"micro entry points: rcs {rcs}, kernels never launched {idle}")

    rows = {}
    x, perm = mk.make_inputs(0)
    x = x.to(device)
    R, BT = x.shape[0] * x.shape[1], x.shape[2]
    for case in mk.NAMES:
        name = f"micro_{mk.WRAPPERS[case].__name__}"
        if case in ("flat_constant_gather", "per_edge_row_moves"):
            # the calls at each depth, tables on the card, made before any timing
            at = {it: mk.case(case, x, perm, it) for it in (mk.ITERS, MICRO_GATHER_DEEP)}
            rows[name] = _hold_micro(name, case, lambda it, at=at: at[it][0](),
                                     lambda it, at=at: at[it][1](), {"x": x},
                                     (mk.ITERS, MICRO_GATHER_DEEP), mk.ITERS)
            continue
        kernel, plain = mk.case(case, x, perm)
        library = None
        if case == "matmul_onehot_routing":
            A, ones = micro.onehot_matrix(perm, device), torch.ones((R, BT), device=device)

            def library(A=A, ones=ones):
                y = x.reshape(R, BT)
                for _ in range(mk.ITERS):
                    y = torch.addmm(ones, A, y)
                return y.reshape(x.shape)
        rows[name] = _hold_micro(name, case, lambda _it, f=kernel: f(),
                                 lambda _it, f=plain: f(), {"x": x}, (mk.ITERS,), mk.ITERS,
                                 library)
        if library is not None:
            # the share of P3's ms that its input check (one wait) takes
            emit({"phase": "micro", "kernel": name, "case": case,
                  "check_ms": cuda_ms(lambda: micro.check_onehot(A, x), 20)})
    inp = ml.make_inputs(0)
    for case in ml.NAMES:
        name = f"micro_{ml.WRAPPERS[case].__name__}"
        kernel, plain, _ = ml.case(case, inp, device)
        layout = case.split("_")[1]
        if case.startswith("elem"):
            tensors = {"x": inp[f"x_{layout}"], "rb": inp[f"rb_{layout}"]}
        else:
            tensors = {"post": inp[f"post_{layout}"], "vn": inp["vn"], "nbr": inp["nbr"]}
        hold = (MICRO_LAYOUT_ITERS, 4 * MICRO_LAYOUT_ITERS) if case.startswith("elem") \
            else (4 * MICRO_LAYOUT_ITERS,)
        row = _hold_micro(name, case, kernel, plain, tensors, hold, MICRO_LAYOUT_ITERS,
                          exact_inf=case.startswith("route"))
        if case.endswith("new"):
            rows[name] = row
        else:
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], row["max_abs_err"])
    return counts, rows


# Phase multi_rank. A: the flagship sweep of phase main (2 x 8192 frames,
# 8192 a step, 50 iterations, early termination) on a one-rank NCCL group.
# B and C on two ranks that share card 0 (gloo: NCCL refuses two ranks on
# one card), launched by torch.distributed.run: B, config 5's file as it
# stands with --mesh-snr 2 (sim.max_frames cut as in phase main_cfg5), then
# the flagship sweep with --mesh-data 2 (4096 frames a rank); C, the
# edge-sharded decode with K1 on config 5's field and check degree (the
# generator of gf256_n255_k175 at N = 256: N = 255 does not divide by 2),
# 512 frames, 20 iterations, both early_term modes.
MULTI_RANK_RUNS = [
    ("cfg5_mesh_snr2", ["--config", CFG5, "--set", f"sim.max_frames={CFG5_FRAMES}",
                        "--mesh-snr", "2"], "qspa_resident_cl"),
    ("flagship_mesh_data2", [*FLAGSHIP_SWEEP, "--mesh-data", "2"], "qspa_resident"),
]
SHARDED_CODE = (256, 80, 256, 2, 1)     # make_peg_code(n, m, q, dv, seed)
SHARDED_FRAMES, SHARDED_ITERS, SHARDED_EBN0 = 512, 20, 2.5
# case C with the other check-node kernels, early termination: (record,
# the kernel's counter, decoder, its options) - K2 at config 5's EMS
# decoder (nm 16, offset 0.1), K5 at config 4's T-EMS decoder (n_r 8,
# offset 2.0)
SHARDED_OTHER = [("sharded_k2_early1", "cn_ems", "ems", {"nm": 16, "offset": 0.1}),
                 ("sharded_k5_early1", "cn_tems", "tems", {"n_r": 8, "offset": 2.0})]
COUNTER_NAMES = ("frames", "frame_errors", "symbol_errors", "bit_errors", "iter_sum",
                 "converged")


def cli_run(args: list) -> dict:
    """cli.main(["run", *args]) with every launch counter zeroed just before
    and read just after: its return code, seconds, launches and the
    counters of its last step record (the all-reduced counters on a rank)."""
    import logging

    from nbldpc_tpu_torch import cli

    class Last(logging.Handler):
        record = None

        def emit(self, record):
            self.record = json.loads(record.getMessage())

    last = Last()
    log = logging.getLogger("nbldpc")
    log.addHandler(last)
    try:
        _reset_counters()
        t0 = time.perf_counter()
        rc = cli.main(["run", *args])
        seconds = time.perf_counter() - t0
        counts = _counters()
    finally:
        log.removeHandler(last)
    return {"rc": rc, "seconds": seconds, "launches": {k: v for k, v in counts.items() if v},
            "counters": {k: last.record[k] for k in COUNTER_NAMES}}


def _sweep_config(args: list):
    """The RunConfig that `cli run` builds from args."""
    import argparse

    from nbldpc_tpu_torch import cli

    ap = argparse.ArgumentParser()
    cli._add_run_parser(ap.add_subparsers(dest="cmd"))
    return cli.build_config(ap.parse_args(["run", *args]))


def _sharded_llrs(device):
    """LLRs of random codewords of the SHARDED_CODE, the same on every rank."""
    import torch

    from nbldpc_tpu_torch.channel import ebn0_to_sigma, llr_init, modulate
    from nbldpc_tpu_torch.codegen import make_peg_code
    from nbldpc_tpu_torch.encode import Encoder
    from nbldpc_tpu_torch.graph import TannerGraph

    n, m, q, dv, seed = SHARDED_CODE
    spec = make_peg_code(n, m, q, dv=dv, seed=seed)
    g = TannerGraph(spec, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(15)
    u = torch.randint(0, q, (SHARDED_FRAMES, spec.n - spec.m), generator=gen,
                      device=device, dtype=torch.int32)
    x = modulate(Encoder(spec, device).encode(u), q)
    sigma = float(ebn0_to_sigma(SHARDED_EBN0, spec.k / spec.n))
    noise = torch.randn(x.shape, generator=gen, device=device)
    return g, llr_init(x + sigma * noise, sigma, q)


def multi_rank_worker() -> int:
    """One rank of cases B and C (started by torch.distributed.run from
    phase_multi_rank): the cli runs of MULTI_RANK_RUNS on card 0 over gloo,
    then the edge-sharded decode; writes its records to
    build/nbldpc_tpu_torch/multi_rank/rank<r>.json."""
    import os

    import torch

    sys.path.insert(0, str(ROOT))
    from nbldpc_tpu_torch.decoders import qspa, sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rank = int(os.environ["RANK"])
    out_dir = ROOT / "build" / "nbldpc_tpu_torch" / "multi_rank"
    records = {}
    for name, args, _ in MULTI_RANK_RUNS:
        rec = cli_run([*args, "--device", "cuda:0", "--backend", "gloo",
                       "--report", str(out_dir / f"{name}.json")])
        records[name] = rec
    g, llr = _sharded_llrs(device)
    for early in (True, False):
        _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sharded.decode_edge_sharded(g, llr, qspa.qspa_cn_update_bl_kernel,
                                          SHARDED_ITERS, early)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counters()
        _reset_counters()
        ref = qspa.decode(g, llr, SHARDED_ITERS, early, cn_impl="kernel")
        torch.cuda.synchronize()
        records[f"sharded_early{int(early)}"] = {
            "seconds": seconds, "launches": {k: v for k, v in counts.items() if v},
            "ref_launches": {k: v for k, v in _counters().items() if v},
            "equal": {k: bool(torch.equal(a, b))
                      for k, a, b in zip(("hard", "done", "iters"), got, ref)},
            "converged": int(got.done.sum()), "max_iters": int(got.iters.max())}
    from nbldpc_tpu_torch.decoders import ems, tems
    from nbldpc_tpu_torch.kernels import cn_ems, cn_tems

    kernels = {"ems": lambda o: lambda U, _g: cn_ems.cn_update(U, o["nm"], o["offset"]),
               "tems": lambda o: lambda U, _g: cn_tems.cn_update(U, o["offset"], o["n_r"])}
    for name, _, kind, opts in SHARDED_OTHER:
        _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sharded.decode_edge_sharded(g, llr, kernels[kind](opts), SHARDED_ITERS, True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counters()
        _reset_counters()
        ref = {"ems": ems, "tems": tems}[kind].decode(g, llr, SHARDED_ITERS, early_term=True,
                                                      cn_impl="kernel", **opts)
        torch.cuda.synchronize()
        records[name] = {
            "seconds": seconds, "launches": {k: v for k, v in counts.items() if v},
            "ref_launches": {k: v for k, v in _counters().items() if v},
            "equal": {k: bool(torch.equal(a, b))
                      for k, a, b in zip(("hard", "done", "iters"), got, ref)},
            "converged": int(got.done.sum()), "max_iters": int(got.iters.max())}
    for name, rec in records.items():
        emit({"rank": rank, "run": name, "launches": rec["launches"]})
    (out_dir / f"rank{rank}.json").write_text(json.dumps(records))
    return 0


def phase_multi_rank(device, card: str) -> dict:
    """Cases A, B and C (above). Returns the launches of their paths, summed
    over the ranks."""
    import os
    import shutil

    import torch
    import torch.distributed as tdist

    from nbldpc_tpu_torch import sim
    from nbldpc_tpu_torch.parallel import mesh

    out_dir = ROOT / "build" / "nbldpc_tpu_torch" / "multi_rank"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)

    # A: one rank over NCCL against no group, in turns
    cfg = _sweep_config(FLAGSHIP_SWEEP)
    runs = {}
    tdist.init_process_group("nccl", init_method=f"file://{out_dir}/store_a", rank=0,
                             world_size=1)
    try:
        layout = mesh.make_layout()
        # a warm-up sweep each (NCCL's communicator starts at the first
        # all-reduce), then in turns
        for label in ("none", "nccl", "none", "nccl", "nccl", "none"):
            _reset_counters()
            res = sim.run_sweep(cfg, device, layout=layout if label == "nccl" else None)
            counts = _counters()
            runs.setdefault(label, []).append((res, counts))
        S, B = len(cfg.channel.ebn0_db), cfg.sim.frames_per_step
        slots = layout.block(S, B)[0]
        out = torch.ones((6, S), dtype=torch.int64, device=device)

        def group_work():            # what run_sweep adds to a step under a layout
            full = torch.zeros((6, S), dtype=torch.int64, device=device)
            full[:, slots] = out
            tdist.all_reduce(full, group=layout.group)

        group_ms = cuda_ms(group_work, 200)
        allreduce_ms = cuda_ms(lambda: tdist.all_reduce(out, group=layout.group), 200)
        t0 = time.perf_counter()
        for _ in range(200):
            group_work()
            torch.cuda.synchronize()
        group_host_ms = (time.perf_counter() - t0) * 1e3 / 200
    finally:
        tdist.destroy_process_group()
    g = _graph("gf16_n204_k102_c8", device)
    shape = (S, B, g.n, g.gf.p)
    draw_ms = cuda_ms(lambda: torch.randn(shape, device=device), 20)
    half_ms = cuda_ms(lambda: torch.randn((S, B // 2, g.n, g.gf.p), device=device), 20)
    want = runs["none"][0][0].counters.asdict()
    rec_a = {"phase": "multi_rank", "case": "A_nccl_world1", "card": card,
             "sweep": FLAGSHIP_SWEEP, "steps": runs["nccl"][0][0].steps,
             "counters_equal": all(r.counters.asdict() == want for lab in runs
                                   for r, _ in runs[lab]),
             "launches": {k: v for k, v in runs["nccl"][0][1].items() if v},
             "ms_per_step_warmup_first": {lab: [r.wall_seconds * 1e3 / r.steps
                                                for r, _ in runs[lab]] for lab in runs},
             "group_ms_per_step_events": group_ms, "group_ms_per_step_host": group_host_ms,
             "allreduce_alone_ms_events": allreduce_ms,
             "noise_draw_ms": {"global": draw_ms, "bytes_global": 4 * math.prod(shape),
                               "data2_block": half_ms, "redundant": draw_ms - half_ms}}
    emit(rec_a)
    counts_a = _sum_counts(*(c for _, c in runs["nccl"]))
    if not rec_a["counters_equal"]:
        fail(f"multi_rank A: counters differ from the no-group run: {rec_a}")
    if counts_a["qspa_resident"] < 1 or _ran_plain(counts_a):
        fail(f"multi_rank A: K0 did not run alone: {counts_a}")

    # B and C: two ranks on card 0
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.split("\n")[0]
    if mode.strip() != "Default":
        fail(f"compute mode {mode!r}: two processes cannot share the card")
    single = {}
    for name, args, _ in MULTI_RANK_RUNS:
        single[name] = cli_run([*args, "--device", "cuda:0",
                                "--report", str(out_dir / f"{name}_single.json")])
    t0 = time.perf_counter()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "2", str(ROOT / "chip_smoke.py"),
                           "--multi-rank-worker"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"multi_rank: torch.distributed.run returned {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    print("\n".join(line for line in proc.stdout.splitlines()
                    if line.startswith('{"rank"')), flush=True)
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(2)]
    counts = counts_a
    for name, _, kernel in MULTI_RANK_RUNS:
        rep = json.loads((out_dir / f"{name}.json").read_text())
        one = json.loads((out_dir / f"{name}_single.json").read_text())
        rec = {"phase": "multi_rank", "case": f"B_{name}", "card": card,
               "reduced": ({"sim.max_frames": [50000, CFG5_FRAMES]}
                           if name.startswith("cfg5") else {}),
               "counters_single": single[name]["counters"],
               "counters_ranks": [r[name]["counters"] for r in ranks],
               "launches_ranks": [r[name]["launches"] for r in ranks],
               "steps": rep["steps"],
               "ms_per_step_two_ranks_one_card_not_scaling":
                   rep["wall_seconds"] * 1e3 / rep["steps"],
               "ms_per_step_single": one["wall_seconds"] * 1e3 / one["steps"],
               "fer": rep["fer"], "frames": rep["frames"]}
        emit(rec)
        for r, got in enumerate(ranks):
            if got[name]["rc"] != 0 or got[name]["counters"] != single[name]["counters"]:
                fail(f"multi_rank B {name}: rank {r} differs from one process: {rec}")
            if _idle(got[name]["launches"], kernel, step=True) or _ran_plain(
                    got[name]["launches"]):
                fail(f"multi_rank B {name}: rank {r} did not run {kernel} alone: {rec}")
            counts = _sum_counts(counts, got[name]["launches"])
        if rep["frames"] != one["frames"] or rep["fer"] != one["fer"]:
            fail(f"multi_rank B {name}: report differs from one process")
    from nbldpc_tpu_torch.decoders import qspa

    g, llr = _sharded_llrs(device)
    for early in (1, 0):
        name = f"sharded_early{early}"
        qspa.decode(g, llr, SHARDED_ITERS, bool(early), cn_impl="kernel")     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qspa.decode(g, llr, SHARDED_ITERS, bool(early), cn_impl="kernel")
        torch.cuda.synchronize()
        rec = {"phase": "multi_rank", "case": f"C_{name}", "card": card,
               "code": "make_peg_code(%d, %d, %d, dv=%d, seed=%d)" % SHARDED_CODE,
               "frames": SHARDED_FRAMES, "iters": SHARDED_ITERS, "ebn0_db": SHARDED_EBN0,
               "ranks": [r[name] for r in ranks], "launch_seconds": seconds,
               "decode_bl_k1_seconds_one_process": time.perf_counter() - t0}
        emit(rec)
        for r, got in enumerate(ranks):
            if not all(got[name]["equal"].values()):
                fail(f"multi_rank C {name}: rank {r} differs from decode_bl: {rec}")
            if got[name]["launches"].get("cn_qspa", 0) < 1 or _ran_plain(got[name]["launches"]):
                fail(f"multi_rank C {name}: rank {r} did not run K1 alone: {rec}")
            ref = got[name]["ref_launches"]
            if _idle(ref, "cn_qspa") or _ran_plain(ref):
                fail(f"multi_rank C {name}: rank {r}'s decode_bl did not run K1 and the "
                     f"routing kernels alone: {rec}")
            counts = _sum_counts(counts, got[name]["launches"], ref)
    for name, kernel, kind, opts in SHARDED_OTHER:
        rec = {"phase": "multi_rank", "case": f"C_{name}", "card": card, "decoder": kind,
               **opts, "code": "make_peg_code(%d, %d, %d, dv=%d, seed=%d)" % SHARDED_CODE,
               "frames": SHARDED_FRAMES, "iters": SHARDED_ITERS, "ebn0_db": SHARDED_EBN0,
               "ranks": [r[name] for r in ranks]}
        emit(rec)
        for r, got in enumerate(ranks):
            if not all(got[name]["equal"].values()):
                fail(f"multi_rank C {name}: rank {r} differs from decode_bl: {rec}")
            if got[name]["launches"].get(kernel, 0) < 1 or _ran_plain(got[name]["launches"]):
                fail(f"multi_rank C {name}: rank {r} did not run {kernel} alone: {rec}")
            ref = got[name]["ref_launches"]
            if _idle(ref, kernel) or _ran_plain(ref):
                fail(f"multi_rank C {name}: rank {r}'s decode_bl did not run {kernel} and "
                     f"the routing kernels alone: {rec}")
            counts = _sum_counts(counts, got[name]["launches"], ref)
    return counts


# Phase throughput. A: each run_all configuration's kernel (the one
# cn_impl="auto" picks on the card) and its launches a step: 1 for a
# whole-decode kernel, one an iteration for a check-node kernel in decode_bl
THROUGHPUT_KERNELS = {
    "gf4_qspa_20it": "qspa_resident", "gf16_qspa_50it": "qspa_resident",
    "gf16_qspa_50it_bf16": "qspa_resident_bf16", "gf16_ems_nm16_20it": "ems_resident",
    "gf64_tems_20it": "cn_tems", "gf256_qspa_10it": "qspa_resident_cl",
    "gf256_ems_nm16_10it": "cn_ems", "gf256_qspa_10it_4snr": "qspa_resident_cl",
    "gf256_ems_nm16_10it_4snr": "cn_ems", "gf256_ems_bubble_10it": "cn_ems_bubble",
    "gf64_tems_nr8_20it": "cn_tems", "gf64_tems_nr4_20it": "cn_tems",
    "gf16_qspa_qc_slot_50it": "qspa_resident", "gf4_qspa_qc_20it": "qspa_resident",
    "gf16_ems_qc_slot_20it": "ems_resident", "gf16_qspa_c8_50it": "qspa_resident",
    "gf4_qspa_c8_20it": "qspa_resident", "gf16_ems_c8_20it": "ems_resident"}
# B: (kernel, code, iterations) never held on the card before, each held
# against its plain version on THROUGHPUT_HOLD_FRAMES frames at sigma 0.7
# (a configuration's first SNR slot) in the modes of phase 4; K3 at the
# configurations' EMS decoder, nm 16, offset 0.0
THROUGHPUT_HOLDS = [("ems_resident", "gf16_n204_k102_qc", 20),
                    ("ems_resident", "gf16_n204_k102_c8", 20),
                    ("qspa_resident", "gf16_n204_k102_qc", 50),
                    ("qspa_resident", "gf4_n96_k48_qc", 20)]
THROUGHPUT_HOLD_FRAMES = 1024


def scaling_worker() -> int:
    """One rank of phase throughput's case C (started by
    torch.distributed.run): the layout sweep on card 0 over gloo, counters
    zeroed before and read after; writes its launches to
    build/nbldpc_tpu_torch/scaling/rank<r>.json."""
    import os

    sys.path.insert(0, str(ROOT))
    from nbldpc_tpu_torch.benchmarks import scaling

    out_dir = ROOT / "build" / "nbldpc_tpu_torch" / "scaling"
    _reset_counters()
    rc = scaling.main(["--device", "cuda:0", "--backend", "gloo", "--tag", "smoke",
                       "--out", str(out_dir)])
    (out_dir / f"rank{os.environ['RANK']}.json").write_text(
        json.dumps({"rc": rc, "launches": _counters()}))
    return rc


def phase_throughput(device, card: str) -> dict:
    """A: nbldpc_tpu_torch.benchmarks.run_all as a user runs it, all 18
    configurations at the JAX script's batches, counters zeroed before and
    read after; each record well formed, with its configuration's kernel
    (THROUGHPUT_KERNELS) launched once a step or an iteration and nothing
    else. B: THROUGHPUT_HOLDS, agreement 1.0. C: the layout sweep
    (benchmarks/scaling) on 8 ranks sharing card 0 over gloo, this script
    as the rank program: identical counters across the layouts, K0-cl
    launched on every rank that holds a block and on no other, no plain
    version. Returns the launches of A and C."""
    import os
    import shutil

    from nbldpc_tpu_torch import benchmarks
    from nbldpc_tpu_torch.benchmarks import run_all, scaling

    out_dir = ROOT / "build" / "nbldpc_tpu_torch"
    out = out_dir / "run_all_smoke.json"
    out.unlink(missing_ok=True)
    _reset_counters()
    t0 = time.perf_counter()
    rc = run_all.main(["--tag", "smoke", "--out", str(out_dir)])
    seconds = time.perf_counter() - t0
    total = _counters()
    if rc != 0:
        fail(f"throughput: run_all returned {rc}")
    recs = json.loads(out.read_text())
    fields = benchmarks.device_fields(device)
    rows, bad = [], []
    for r, (name, code, deckw, iters, batch, n_snr) in zip(recs, run_all.CONFIGS):
        kernel = THROUGHPUT_KERNELS[name]
        ran = {k: v for k, v in r["launches"].items() if v}
        n = _graph(code, "cpu").n
        rows.append([name, r["ms_per_step"], r["wall_ms_per_step"], r["first_call_s"],
                     r["frames_per_s"], ran])
        if ((r["config"], r["code"], r["iters"], r["batch"], r["n_snr"])
                != (name, code, iters, batch, n_snr)
                or ran != {k: r["steps"] * n for k, n in _step_launches(
                    kernel, iters, batch * n_snr,
                    _cluster_grid(code, batch * n_snr, device)
                    if kernel == "qspa_resident_cl" else (0, 0)).items()}
                or r["timing"] != "cuda_events" or not r["mm_precision_applied"]
                or not (0 < r["ms_per_step"] < math.inf and 0 < r["wall_ms_per_step"] < math.inf)
                or not math.isclose(r["symbols_per_s"], r["frames_per_s"] * n, rel_tol=1e-12)
                or {k: r.get(k) for k in fields} != fields):
            bad.append(name)
    emit({"phase": "throughput", "case": "A_run_all", "card": card, "seconds": seconds,
          "reps": recs[0]["reps"] if recs else None,
          "rows_config_ms_wall_ms_first_call_s_frames_per_s_launches": rows})
    # run_all zeroes the counters before each configuration: what they hold
    # after it is its last configuration's record
    if len(recs) != len(run_all.CONFIGS) or bad or total != recs[-1]["launches"]:
        fail(f"throughput A: {len(recs)} records, bad {bad}, the counters {total} "
             f"against the last record's")

    for kernel, code, iters in THROUGHPUT_HOLDS:
        g = _graph(code, device)
        llr = _llrs(g, THROUGHPUT_HOLD_FRAMES, [0.7], device, ebn0=False)
        modes = {"a_early_term": (llr, iters, True, True),
                 "b_throughput": (llr, iters, False, False),
                 "c_one_iter": (llr, 1, False, True)}
        _reset_counters()
        if kernel == "qspa_resident":
            res = _hold_resident("throughput", code, g, modes, ())
            agree = res["agreement_min"]
        else:
            _hold_ems("throughput", code, g, {k: (*m, 16) for k, m in modes.items()},
                      offset=0.0)
            agree = 1.0                        # _hold_ems fails below 1.0
        counts = _counters()
        if agree != 1.0 or counts[kernel] != len(modes) or counts[f"{kernel}_plain"] != len(modes):
            fail(f"throughput B {kernel} {code}: agreement {agree}, launches {counts}")

    run_dir = out_dir / "scaling"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", str(scaling.WORLD), str(ROOT / "chip_smoke.py"),
                           "--scaling-worker"], cwd=ROOT, env={**os.environ,
                                                               "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"throughput C: torch.distributed.run returned {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    rec = json.loads((run_dir / "scaling_smoke.json").read_text())
    ranks = [json.loads((run_dir / f"rank{r}.json").read_text()) for r in range(scaling.WORLD)]
    emit({"phase": "throughput", "case": "C_scaling", "card": card, "seconds": seconds,
          "backend": rec["backend"], "ranks_per_card": rec["ranks_per_card"],
          "counters": rec["counters"],
          "rows": [{k: row[k] for k in ("mesh", "step_s", "counters_identical_to_1dev",
                                        "launches_ranks")} for row in rec["rows"]]})
    # scaling zeroes the counters before each layout: what a rank's hold
    # after it are its launches in the last layout, as the record has them
    launches = _sum_counts(*(r["launches"] for r in recs),
                           *(ran for row in rec["rows"] for ran in row["launches_ranks"]))
    for r, got in enumerate(ranks):
        last = rec["rows"][-1]["launches_ranks"][r]
        if got["rc"] != 0 or {k: v for k, v in got["launches"].items() if v} != last:
            fail(f"throughput C: rank {r} returned {got['rc']} or its launches "
                 f"{got['launches']} differ from the record's {last}")
    for row in rec["rows"]:
        frames = scaling.S * scaling.B // row["devices"]
        want = [_step_launches("qspa_resident_cl", scaling.ITERS, frames,
                               _cluster_grid(scaling.CODE, frames, device))
                if r < row["devices"] else {} for r in range(scaling.WORLD)]
        if not row["counters_identical_to_1dev"] or row["launches_ranks"] != [
                {k: 2 * v for k, v in w.items()} for w in want]:
            fail(f"throughput C: layout {row['mesh']}: {row}")
    if (rec["backend"], rec["ranks_per_card"], rec.get("card")) != ("gloo", scaling.WORLD,
                                                                     fields["card"]):
        fail(f"throughput C: record {rec['backend']}, {rec['ranks_per_card']}, "
             f"{rec.get('card')}")
    return launches


# Phase routing. A: the two step shapes the routing kernels run at on the
# main paths (label, code, frames): config 5's (GF(256) (255,175), 8 points
# x 512 frames; its EMS half, the bubble merge and the K1 path) and config
# 4's (GF(64) (576,480), 1024 frames; T-EMS)
ROUTE_SHAPES = [("cfg5", "gf256_n255_k175", 4096), ("cfg4", "gf64_n576_k480", 1024)]
# B: decode_bl through the routing kernels against the plain routing, the
# same check-node kernel in both: (kernel, code, frames, Eb/N0, its
# arguments after U: nm and offset, or offset and n_r)
ROUTE_DECODES = [("cn_qspa", "gf256_n255_k175", 512, 2.5, ()),
                 ("cn_ems", "gf256_n255_k175", 512, 2.5, (16, 0.1)),
                 ("cn_ems_bubble", "gf256_n255_k175", 512, 2.5, (16, 0.0)),
                 ("cn_tems", "gf64_n576_k480", 1024, 3.5, (2.0, 8))]


def route_inputs(g, B: int, device) -> tuple:
    """(posterior [N, q, B], Cv [N, dv, q, B] with 0 on pad VN slots, Chat
    [M, dc, q, B], llr [N, q, B]): normal draws x 3 from a numpy seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(3)

    def draw(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 3.0).astype(np.float32)).to(device)

    post = draw(g.n, g.q, B)
    Cv = torch.where(g.vn_mask[:, :, None, None], draw(g.n, g.dv_max, g.q, B), 0.0)
    return post, Cv.contiguous(), draw(g.m, g.dc_max, g.q, B), draw(g.n, g.q, B)


def route_bounds(g, B: int) -> dict:
    """The least time of each routing half at B frames. route_down reads the
    posterior once, each real VN slot's Cv rows (the pad slots' rows are
    never routed) and the real slots' down_idx rows, and writes every U row
    (log-delta0 on pad CN slots): a subtraction, a max and a subtraction an
    element. route_up reads the real CN slots' Chat rows, the LLRs and the
    real VN slots' up_idx rows, and writes every Cv row and the posterior:
    an add a slot and one more for the LLR."""
    q, E = g.q, g.spec.num_edges
    cn_slots, vn_slots = g.m * g.dc_max, g.n * g.dv_max
    down = bound(3 * E * q * B,
                 4 * B * q * (g.n + E + cn_slots) + 4 * E * q + cn_slots)
    up = bound(B * q * (vn_slots + g.n),
               4 * B * q * (E + 2 * g.n + vn_slots) + 4 * E * q + vn_slots)
    return {"route_down": down, "route_up": up}


def phase_routing(device, card: str) -> dict:
    """A: route_down and route_up (kernels/route.py, csrc/route.cu) against
    their plain versions at ROUTE_SHAPES on the same inputs (normal draws
    from a seed, Cv 0 on pad VN slots): every output equal, max abs error
    0.0, finite; timed plain, kernel, kernel, plain beside their bounds.
    B: ROUTE_DECODES in the early-termination and fixed-budget modes,
    hard/done/iters equal, the kernel run launching its CN kernel and both
    routing kernels once an iteration and no plain version. Returns the
    rows of A by kernel and shape."""
    import torch

    from nbldpc_tpu_torch.decoders import common
    from nbldpc_tpu_torch.kernels import cn_ems, cn_qspa, cn_tems, route

    rows = {"route_down": {}, "route_up": {}}
    for label, code, B in ROUTE_SHAPES:
        g = _graph(code, device)
        post, Cv, Chat, llr = route_inputs(g, B, device)
        bounds = route_bounds(g, B)
        for name, kern, plain, args in (
                ("route_down", route.route_down, route.route_down_plain, (post, Cv, g)),
                ("route_up", route.route_up, route.route_up_plain, (Chat, llr, g))):
            outs = kern(*args)
            refs = plain(*args)
            outs, refs = ((outs,), (refs,)) if name == "route_down" else (outs, refs)
            torch.cuda.synchronize()
            equal = all(torch.equal(o, r) for o, r in zip(outs, refs))
            err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            p1 = cuda_ms(lambda: plain(*args), 2)
            k1 = cuda_ms(lambda: kern(*args), 10)
            k2 = cuda_ms(lambda: kern(*args), 10)
            p2 = cuda_ms(lambda: plain(*args), 2)
            row = {"phase": "routing", "case": "A", "kernel": name, "shape": label,
                   "code": code, "frames": B, "card": card, "equal": equal,
                   "max_abs_err": err, "finite": finite, "ms": (k1 + k2) / 2,
                   "plain_ms": (p1 + p2) / 2, "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
                   **bounds[name]}
            emit(row)
            if not (equal and err == 0.0 and finite):
                fail(f"routing {name} {label}: equal {equal}, max abs err {err}, "
                     f"finite {finite}")
            rows[name][label] = row
        del post, Cv, Chat, llr, outs, refs
        torch.cuda.empty_cache()

    fns = {"cn_qspa": cn_qspa.cn_update, "cn_ems": cn_ems.cn_update,
           "cn_ems_bubble": cn_ems.cn_update_bubble, "cn_tems": cn_tems.cn_update}
    for kernel, code, frames, ebn0, args in ROUTE_DECODES:
        g = _graph(code, device)
        llr = _llrs(g, frames, [ebn0], device)

        def cn(U, _g, active, out, fn=fns[kernel], args=args):
            # K5 takes decode_bl's frame list; the others compute every frame
            return fn(U, *args, active, out) if kernel == "cn_tems" else fn(U, *args)

        for early, stats in ((True, True), (False, False)):
            _reset_counters()
            got = common.decode_bl(g, llr, cn, 20, early, stats, route="kernel")
            torch.cuda.synchronize()
            counts = _counters()
            ref = common.decode_bl(g, llr, cn, 20, early, stats, route="torch")
            equal = {k: bool(torch.equal(a, b))
                     for k, a, b in zip(("hard", "done", "iters"), got, ref)}
            its = int(got.iters.max()) if early else 20
            ran = {k: v for k, v in counts.items() if v}
            emit({"phase": "routing", "case": "B", "kernel": kernel, "code": code,
                  "frames": frames, "ebn0_db": ebn0, "early_term": early, "equal": equal,
                  "converged": int(got.done.sum()), "iterations": its, "launches": ran})
            # K5 computes the frames not yet done: with early termination the
            # frame-iterations `iters` counts, else every frame
            k5_frames = int(got.iters.sum()) if early else frames * its
            want = {k: v for k, v in ((kernel, its), ("route_down", its), ("route_up", its),
                                      ("decode_bl.loop_iterations", its),
                                      ("decode_bl.frame_iterations", frames * its),
                                      ("cn_tems.frame_iterations",
                                       k5_frames * (kernel == "cn_tems"))) if v}
            if not all(equal.values()) or ran != {**want, "prior_bl": 1}:
                fail(f"routing B {kernel} early_term={early}: equal {equal}, launches {ran} "
                     f"for {its} iterations")
    return rows


# Phase sim_step. A: the step shapes the three kernels of csrc/sim_step.cu
# run at on the main paths (label, code, SNR slots' Eb/N0 or sigma, frames a
# slot, whether the slots are Eb/N0): the flagship bench step (sigma 0.63,
# 8192 frames; K0 after the channel), config 4's (3.5 dB, 1024 frames;
# T-EMS in decode_bl) and config 5's (its file's 8 Eb/N0 points x 512
# frames; K0-cl, or K1, K2 and K2b in decode_bl)
SIM_STEP_SHAPES = [("flagship", "gf16_n204_k102_c8", [0.63], 8192, False),
                   ("cfg4", "gf64_n576_k480", [3.5], 1024, True),
                   ("cfg5", "gf256_n255_k175", None, 512, True)]
SIM_STEP_NAMES = ("channel_llr", "prior_bl", "count_errors")


def sim_step_inputs(g, B: int, sigmas, device, seed: int = 7) -> tuple:
    """(noise [S, B, N, p], sig [S], cw [S, B, N] int32, iters [S B] int32,
    done [S B] bool) of a step of S = len(sigmas) slots x B frames: the
    noise drawn as a sim step draws it, the rest from the same generator."""
    import torch

    from nbldpc_tpu_torch.sim import step_generator

    S = len(sigmas)
    gen = step_generator(seed, 0, device)
    noise = torch.randn((S, B, g.n, g.gf.p), generator=gen, device=device)
    cw = torch.randint(0, g.q, (S, B, g.n), generator=gen, device=device, dtype=torch.int32)
    iters = torch.randint(0, 21, (S * B,), generator=gen, device=device, dtype=torch.int32)
    done = torch.rand(S * B, generator=gen, device=device) < 0.5
    return noise, torch.tensor(sigmas, dtype=torch.float32, device=device), cw, iters, done


def sim_step_bounds(g, S: int, B: int, codeword: bool) -> dict:
    """The least time of each kernel on a step of S x B frames. channel_llr
    reads the noise (p floats a symbol; with a codeword, its symbol) and
    sigma and scale, and writes q LLRs a symbol: y takes 2 operations a bit,
    an LLR p products, p - 1 adds, a negation and a product. prior_bl reads
    q floats a symbol and writes q and the decision: a max, a subtraction
    and a compare a value. count_errors reads the decisions (and codewords),
    the iterations and done flags, and writes six int64 a slot: a xor, a
    compare, a mask, a popcount and two adds a symbol."""
    q, p, F = g.q, g.gf.p, S * B * g.n
    cw_bytes = 4 * F if codeword else 0
    return {"channel_llr": bound(F * (2 * p + q * (2 * p + 1)),
                                 4 * F * (p + q) + 8 * S + cw_bytes),
            "prior_bl": bound(3 * F * q, 4 * F * (2 * q + 1)),
            "count_errors": bound(6 * F, 4 * F + cw_bytes + 5 * S * B + 48 * S)}


def _same_bits(a, b) -> bool:
    """The same shape, dtype and values, float32 compared bit for bit
    (signed zeros included)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


@contextlib.contextmanager
def plain_step_functions():
    """sim_step's three wrappers replaced by their plain versions while the
    context lasts: a sim step built inside it (make_sim_step binds the
    channel and the counters when it builds the step; decode_bl looks
    prior_bl up at each call) is the plain step composition around the
    same decode."""
    from nbldpc_tpu_torch.kernels import sim_step

    saved = {name: getattr(sim_step, name) for name in SIM_STEP_NAMES}
    for name in SIM_STEP_NAMES:
        setattr(sim_step, name, getattr(sim_step, f"{name}_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(sim_step, name, fn)


def phase_sim_step(device, card: str) -> tuple:
    """A: channel_llr, prior_bl and count_errors (kernels/sim_step.py,
    csrc/sim_step.cu) against their plain versions at SIM_STEP_SHAPES,
    chained as a step chains them, all-zero and random codewords: every
    output equal bit for bit (max abs error 0.0); timed on the all-zero
    codeword plain, kernel, kernel, plain beside their bounds. B: every
    bench row's kernel step (bench._step, the row's full batch) against the
    plain step composition around the same decode on the same generator:
    counters equal, the channel and the counters launched once (decode_bl's
    entry once on the decode_bl paths, never on the whole-decode kernels)
    and no plain version. Returns the rows of A by kernel and shape, and
    B's launches."""
    import torch

    from nbldpc_tpu_torch import bench
    from nbldpc_tpu_torch.channel import ebn0_to_sigma
    from nbldpc_tpu_torch.kernels import sim_step
    from nbldpc_tpu_torch.sim import stack, step_generator

    cfg5_points = json.loads((ROOT / CFG5).read_text())["channel"]["ebn0_db"]
    rows = {name: {} for name in SIM_STEP_NAMES}
    for label, code, points, B, ebn0 in SIM_STEP_SHAPES:
        g = _graph(code, device)
        points = cfg5_points if points is None else points
        sigmas = [float(ebn0_to_sigma(x, g.spec.k / g.n)) if ebn0 else x for x in points]
        noise, sig, cw_all, iters, done = sim_step_inputs(g, B, sigmas, device)
        S, N, q, p = len(sigmas), g.n, g.q, g.gf.p
        for codeword in (False, True):
            cw = cw_all if codeword else None
            llr = sim_step.channel_llr(noise, sig, q, cw)
            flat = llr.reshape(S * B, N, q)
            prior, hard0 = sim_step.prior_bl(flat)
            hard = hard0.T.contiguous()
            counters = sim_step.count_errors(hard, cw, iters, done, S, B, p)
            # name: (kernel, plain version, arguments, the kernel's outputs)
            calls = {
                "channel_llr": (sim_step.channel_llr, sim_step.channel_llr_plain,
                                (noise, sig, q, cw), (llr,)),
                "prior_bl": (sim_step.prior_bl, sim_step.prior_bl_plain, (flat,),
                             (prior, hard0)),
                "count_errors": (sim_step.count_errors, sim_step.count_errors_plain,
                                 (hard, cw, iters, done, S, B, p), tuple(counters.values()))}
            bounds = sim_step_bounds(g, S, B, codeword)
            for name, (kern, plain, args, outs) in calls.items():
                ref = plain(*args)
                ref = tuple(ref.values()) if isinstance(ref, dict) else (
                    ref if isinstance(ref, tuple) else (ref,))
                torch.cuda.synchronize()
                equal = all(_same_bits(o, r) for o, r in zip(outs, ref))
                err = max(float((o.double() - r.double()).abs().max()) if o.numel() else 0.0
                          for o, r in zip(outs, ref))
                row = {"phase": "sim_step", "case": "A", "kernel": name, "shape": label,
                       "code": code, "slots": S, "frames": B, "codeword": codeword,
                       "card": card, "equal": equal, "max_abs_err": err}
                if not codeword:
                    # the kernel's calls queued behind a sleep (device time;
                    # back to back, events_ms, a call's host time shows where
                    # it is longer); the plain chains back to back
                    heavy = 3 if name != "count_errors" else 10
                    p1 = cuda_ms(lambda: plain(*args), heavy)
                    k1 = queued_ms(lambda: kern(*args), 20)
                    k2 = queued_ms(lambda: kern(*args), 20)
                    events = cuda_ms(lambda: kern(*args), 20)
                    p2 = cuda_ms(lambda: plain(*args), heavy)
                    row.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, ms_runs=[k1, k2],
                               events_ms=events, plain_ms_runs=[p1, p2], **bounds[name])
                    rows[name][label] = row
                emit(row)
                if not (equal and err == 0.0):
                    fail(f"sim_step {name} {label} codeword={codeword}: equal {equal}, "
                         f"max abs err {err}")
                rows[name][label]["max_abs_err"] = max(rows[name][label]["max_abs_err"], err)
            del llr, flat, prior, hard0, hard, counters, calls, outs, ref
        del noise, cw_all
        torch.cuda.empty_cache()

    total = {}
    for row in bench.ROWS:
        for impl in (i for i in row.impls if i != "torch"):
            step, sig, _, _ = bench._step(row, impl)
            _reset_counters()
            got = stack(step(step_generator(0, 0, device), sig))
            torch.cuda.synchronize()
            counts = _counters()
            with plain_step_functions():
                ref_step, _, _, _ = bench._step(row, impl)
                want = stack(ref_step(step_generator(0, 0, device), sig))
            ran = {k: v for k, v in counts.items() if v}
            equal = bool(torch.equal(got, want))
            launched = {k: counts[k] for k in SIM_STEP_NAMES}
            emit({"phase": "sim_step", "case": "B", "row": row.name, "cn_impl": impl,
                  "frames": row.batch, "iters": row.iters, "equal": equal,
                  "counters": got.cpu().tolist(), "launches": ran})
            if not equal or _ran_plain(counts) or launched != {
                    "channel_llr": 1, "count_errors": 1, "prior_bl": int(impl == "kernel")}:
                fail(f"sim_step B {row.name} {impl}: counters equal {equal}, launches {ran}")
            total = _sum_counts(total, counts)
    return rows, total


# Phase q_last: the q-last decode path (batch_last=False) against the
# batch-last paths on the same LLRs (the port's channel, a fixed seed): (label,
# code, decoder, keywords, frames, iterations, noise, noise as Eb/N0 (else
# sigma), early termination, the kernel paths: cn_impl -> (the kernel the
# path launches, the least frame agreement with the q-last path, or None
# where it is only reported)). Frame agreement: hard, done and iters all
# equal. The plain path (cn_impl="torch") is held at Q_LAST_PLAIN_MIN on
# every shape. K2 and K5 are exact to their plain versions, as are the
# routing kernels, so their paths are held exactly; K1 rounds exp and log
# apart from its plain version (phase cn_qspa), which a frame that never
# converges may amplify over 50 iterations; K0 runs probability-domain BP,
# reported only. Config 5's EMS shape is cut to 512 frames for time (its
# bench step has 4096). tems_cfg4_early: with early termination K5 computes
# only the frames not yet done (decode_bl's frame list), so its path, held
# exactly to the q-last path as the plain path is, is held frame for frame
# to the plain path, and K5's counter to the frame-iterations `iters` counts.
Q_LAST_PLAIN_MIN = 1.0
Q_LAST_CASES = [
    ("qspa_flagship", "gf16_n204_k102_c8", "qspa", {}, 8192, 50, 0.63, False, False,
     {"kernel": ("cn_qspa", 0.999), "resident": ("qspa_resident", None)}),
    ("qspa_flagship_early", "gf16_n204_k102_c8", "qspa", {}, 8192, 50, 0.63, False, True,
     {"kernel": ("cn_qspa", 0.999), "resident": ("qspa_resident", None)}),
    ("ems_cfg3", "gf16_n204_k102", "ems", {"nm": 16, "offset": 0.3}, 8192, 50, 0.63, False,
     False, {"kernel": ("cn_ems", 1.0)}),
    ("ems_cfg5", "gf256_n255_k175", "ems", {"nm": 16, "offset": 0.1}, 512, 20, 3.0, True,
     False, {"kernel": ("cn_ems", 1.0)}),
    ("tems_cfg4", "gf64_n576_k480", "tems", {"n_r": 8, "offset": 2.0}, 1024, 20, 3.5, True,
     False, {"kernel": ("cn_tems", 1.0)}),
    ("tems_cfg4_early", "gf64_n576_k480", "tems", {"n_r": 8, "offset": 2.0}, 1024, 20, 3.5,
     True, True, {"kernel": ("cn_tems", 1.0)}),
]


def _twice(fn) -> tuple:
    """(fn()'s result, the launch counts of that call, the device ms of a
    second call between CUDA events): the second call must return the same
    tensors."""
    import torch

    _reset_counters()
    first = fn()
    torch.cuda.synchronize()
    counts = _counters()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    second = fn()
    end.record()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail(f"q_last: a decode gave other outputs on its second call ({fn})")
    return first, counts, start.elapsed_time(end)


def _frame_agreement(a, b) -> dict:
    """Frames whose hard, done and iters all agree; the first that does not,
    with the fields that differ there."""
    import torch

    same = (a.hard == b.hard).all(dim=1) & (a.done == b.done) & (a.iters == b.iters)
    bad = (~same).nonzero().flatten()
    first = int(bad[0]) if bad.numel() else None
    return {"agreement": float(same.float().mean()), "differing_frames": int(bad.numel()),
            "first_differing_frame": first,
            "first_differs_in": None if first is None else [
                k for k in ("hard", "done", "iters")
                if not torch.equal(getattr(a, k)[first], getattr(b, k)[first])]}


def phase_q_last(device, card: str) -> list:
    """Q_LAST_CASES: each decode through the q-last path (plain PyTorch, no
    kernel launched), the plain batch-last path and its kernel paths, on the
    same LLRs, every output on the card; hard/done/iters compared frame for
    frame and held to the case's least agreement; a q-last frame done
    exactly when its decision satisfies H. Each decode runs twice, the
    second between CUDA events. Returns the times a case, also emitted as
    one line."""
    from nbldpc_tpu_torch.decoders import ems, qspa, tems

    decoders = {"qspa": qspa.decode, "ems": ems.decode, "tems": tems.decode}
    times = []
    for label, code, kind, kw, frames, iters, noise, ebn0, early, paths in Q_LAST_CASES:
        g = _graph(code, device)
        llr = _llrs(g, frames, [noise], device, ebn0=ebn0)
        dec = decoders[kind]
        ql, counts, ql_ms = _twice(lambda: dec(g, llr, iters, early_term=early,
                                               batch_last=False, **kw))
        bad_h = _done_not_h(g, ql.hard, ql.done)
        ran = {k: v for k, v in counts.items() if v}
        on_card = all(t.device == llr.device for t in ql)
        row = {"phase": "q_last", "case": label, "code": code, "decoder": kind, **kw,
               "frames": frames, "iters": iters, "noise": noise, "ebn0": ebn0,
               "early_term": early, "card": card, "converged": int(ql.done.sum()),
               "frame_errors": int((ql.hard != 0).any(dim=1).sum()),
               "iterations_run": int(ql.iters.max()), "done_not_h": bad_h, "ms": ql_ms}
        emit({**row, "path": "q_last", "launches": ran, "on_card": on_card})
        if ran or bad_h or not on_card:
            fail(f"q_last {label}: launches {ran}, done against H {bad_h}, on card {on_card}")
        timing = {"case": label, "q_last_ms": ql_ms}
        for impl, (kernel, least) in {"torch": (None, Q_LAST_PLAIN_MIN), **paths}.items():
            got, counts, ms = _twice(lambda: dec(g, llr, iters, early_term=early,
                                                 cn_impl=impl, **kw))
            ran = {k: v for k, v in counts.items() if v}
            agree = _frame_agreement(ql, got)
            emit({**row, "path": impl, "kernel": kernel, "ms": ms, "launches": ran,
                  "least_agreement": least, **agree})
            timing["plain_ms" if impl == "torch" else f"{kernel}_ms"] = ms
            if kernel is not None and (not ran.get(kernel) or _ran_plain(counts)):
                fail(f"q_last {label} {impl}: {kernel} did not run alone: {ran}")
            k5_frames = int(got.iters.sum()) if early else frames * iters
            if kernel == "cn_tems" and ran.get("cn_tems.frame_iterations") != k5_frames:
                fail(f"q_last {label} {impl}: K5 computed "
                     f"{ran.get('cn_tems.frame_iterations')} frames, not {k5_frames}")
            if least is not None and agree["agreement"] < least:
                fail(f"q_last {label} {impl}: frame agreement {agree['agreement']} "
                     f"below {least}: {agree}")
        times.append(timing)
        del llr, ql, got
    emit({"phase": "q_last", "case": "times", "card": card, "decodes": times})
    return times


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
    cn_rows = phase_cn_qspa(device)
    res = phase_resident(device)
    res_cl, res_scratch = phase_resident_cl(device)
    ems_rows = phase_cn_ems(device)
    ems_res = phase_ems_resident(device)
    tems_rows = phase_cn_tems(device)
    counts = _sum_counts(phase_highq_qspa(device), phase_main(main_b64),
                         phase_paths("main_qspa", BASELINE_QSPA_PATHS),
                         phase_paths("main_ems", EMS_PATHS),
                         phase_paths("main_tems", TEMS_PATHS), phase_cfg5(),
                         phase_random_cw(device, card))
    phase_bench(card)
    micro_counts, micro_rows = phase_micro(device, card)
    counts = _sum_counts(counts, micro_counts, phase_multi_rank(device, card))
    bf16, bf16_counts = phase_resident_bf16(device, card)
    counts = _sum_counts(counts, bf16_counts, phase_fer_harness(),
                         phase_throughput(device, card))
    route_rows = phase_routing(device, card)
    step_rows, step_counts = phase_sim_step(device, card)
    counts = _sum_counts(counts, step_counts)
    phase_q_last(device, card)

    def entry(name, source, replaces, max_abs_err, timed, **extra):
        """One kernel of the summary: `timed` holds its ms, plain_ms and
        bound of one timed shape. library_ms is null unless `extra` gives
        it: no single PyTorch call computes any of these functions but
        P3's one-hot product (the routing halves are a gather and
        elementwise work each, several calls)."""
        return {"name": name, "route": "cuda", "source": f"nbldpc_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": counts.get(name, 0),
                "max_abs_err": max_abs_err,
                **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": None, **extra}

    kernels = [
        # K0 and K3 at their bench rows' steps (8192 frames x 50 iterations)
        entry("qspa_resident", "qspa_resident.cu",
              "nbldpc_tpu/kernels/qspa_resident.py:677", res["max_abs_err"], res,
              agreement_min=res["agreement_min"]),
        # the shape of its GF(256) decode path in phase highq_qspa
        entry("cn_qspa", "cn_qspa.cu", "nbldpc_tpu/kernels/cn_qspa.py:52",
              max(r["max_abs_err_above_-15"] for r in cn_rows.values()),
              cn_rows["highq_gf256_n255_k175"]),
        entry("qspa_resident_cl", "qspa_cluster.cu",
              "nbldpc_tpu/kernels/qspa_resident.py:192", res_cl["max_abs_err"], res_cl,
              agreement_min=res_cl["agreement_min"], scratch_ms=res_cl["scratch_ms"]),
        # K0-cl for codes no cluster holds, at the OVERSIZE code (and
        # OVERSIZE_GF64's times beside)
        entry("qspa_resident_cl_scratch", "qspa_resident_cl.cu",
              "nbldpc_tpu/kernels/qspa_resident.py:192", res_scratch["max_abs_err"],
              res_scratch, agreement_min=res_scratch["agreement_min"],
              **{k: v for k, v in res_scratch.items() if k.startswith("gf64_")}),
        entry("ems_resident", "ems_resident.cu",
              "nbldpc_tpu/kernels/ems_resident.py:145", ems_res["max_abs_err"], ems_res),
        # classic and bubble at config 5's step shape
        *(entry(name, "cn_ems.cu", replaces,
                max(r["max_abs_err"] for r in ems_rows[merge]), ems_rows[merge][-1])
          for name, merge, replaces in (
              ("cn_ems", "classic", "nbldpc_tpu/kernels/cn_ems.py:91"),
              ("cn_ems_bubble", "bubble", "nbldpc_tpu/kernels/cn_ems.py:101"))),
        # BASELINE config 4's check-node shape and n_r, the main path's
        entry("cn_tems", "cn_tems.cu", "nbldpc_tpu/kernels/cn_tems.py:33",
              max(r["max_abs_err"] for r in tems_rows), tems_rows[2]),
        # decode_bl's routing, replacing the two XLA scopes of JAX's loop
        # body, at config 5's step (config 4's times beside)
        *(entry(name, "route.cu", f"nbldpc_tpu/decoders/common.py:{line}",
                max(r["max_abs_err"] for r in route_rows[name].values()),
                route_rows[name]["cfg5"],
                **{f"cfg4_{k}": route_rows[name]["cfg4"][k]
                   for k in ("ms", "plain_ms", "bound_ms")})
          for name, line in (("route_down", "215"), ("route_up", "221"))),
        # the sim step around the decode, replacing XLA code of JAX's step:
        # config 5's step, the flagship's and config 4's times beside
        *(entry(name, "sim_step.cu", replaces,
                max(r["max_abs_err"] for r in step_rows[name].values()),
                step_rows[name]["cfg5"],
                **{f"{label}_{k}": step_rows[name][label][k]
                   for label in ("flagship", "cfg4") for k in ("ms", "plain_ms", "bound_ms")})
          for name, replaces in (("channel_llr", "nbldpc_tpu/sim.py:151"),
                                 ("prior_bl", "nbldpc_tpu/decoders/common.py:200"),
                                 ("count_errors", "nbldpc_tpu/sim.py:153"))),
        # the bf16 builds (mm_precision="bf16") at their bench rows' steps
        # (the scratch kernel at OVERSIZE, OVERSIZE_GF64's times beside),
        # each with its f32 build's time in the same run and both plans
        *(entry(f"{name}_bf16", source, "nbldpc_tpu/kernels/qspa_resident.py:" + line,
                bf16[label]["max_abs_err"], bf16[label],
                agreement_min=bf16[label]["agreement_min"], f32_ms=bf16[label]["f32_ms"],
                plan=bf16[label]["plan"],
                **({f"gf64_{k}": bf16["scratch_gf64"][k] for k in ("ms", "f32_ms", "plain_ms",
                                                                  "bound_ms")}
                   if label == "scratch_gf256" else {}))
          for name, source, line, label in (
              ("qspa_resident", "qspa_resident.cu", "677", "k0_flagship"),
              ("qspa_resident_cl", "qspa_cluster.cu", "192", "k0cl_cfg5"),
              ("qspa_resident_cl_scratch", "qspa_resident_cl.cu", "192", "scratch_gf256"))),
        # the probes at the JAX scripts' full shapes; micro_rot_softmax and
        # micro_route timed in the "new" layout at 50 iterations
        *(entry(name, source, replaces, micro_rows[name]["max_abs_err"], micro_rows[name],
                library_ms=micro_rows[name]["library_ms"])
          for name, source, replaces in MICRO_KERNELS),
    ]
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        fail(f"kernels never launched on a path: {idle}")
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    WORKERS = {"--multi-rank-worker": multi_rank_worker, "--scaling-worker": scaling_worker}
    raise SystemExit(WORKERS[sys.argv[1]]() if sys.argv[1:] and sys.argv[1] in WORKERS
                     else main())
