"""Time the resident EMS decode (K3), the T-EMS check node (K5), the
resident QSPA decode (K0), K0-cl's two kernels, the QSPA check node (K1),
the EMS check nodes (K2b bubble, K2 classic beside it), decode_bl's two
routing kernels and the probes P1, P2, P4, P5 and P6/P7 of one tree at the
shapes their paths (the probes: their entry points) run, with a digest of
every output, so that two trees compare on one card.

    python nbldpc_tpu_torch/benchmarks/kernel_ab.py [--root DIR] [--steps]
                                    [--builds k0_frames1,k3_frames1,...]
                                    [--only k1,k2b,...]

--root is the repository root whose nbldpc_tpu_torch is timed (default:
the one holding this file), e.g. a `git archive` of another commit: the
script calls only wrappers that every tree since the T-EMS port has (the
k0cl cases: since the scratch kernel's redesign, which added
`scratch_occupancy`), and the case k0_gf32 builds its code by that tree's
code.random_regular_spec (a tree without it stops there).
--steps adds the sim steps of the bench rows qspa_gf16_n204_k102_c8,
qspa_gf16_n204_k102, ems_gf16_n204_k102 and tems_gf64_n576_k480, the
K0-cl and K1 paths of qspa_gf256_n255_k175, ems_gf256_n255_k175 (K2) and
ems_bubble_gf256_n255_k175 (K2b), each with a digest of its first timed
step's counters.
--builds builds the --root tree's csrc/qspa_resident.cu,
csrc/qspa_resident_cl.cu, csrc/ems_resident.cu, csrc/cn_tems.cu,
csrc/cn_qspa.cu or csrc/cn_ems.cu once per named edit of BUILDS (the
design choices and the parts of K0, K0-cl's scratch kernel, K3, K5, K1 and
K2b) and times each build beside the library's kernel.
--only keeps the kernel cases whose names start with one of the given
prefixes (k0cl for K0-cl: its scratch kernel on the codes no cluster
holds, both its kernels on two that one does, the cluster kernel also in
bf16 and at config 5's cell step, and, where the tree has
`cluster_plan_at`, under every other f32 partition of those codes that
fits (cluster size, layout); p1, p2, p4, p5, route_new
and route_old for the probes; p1, p2, p5 and the route also time those
probes at 0 and 200 iterations; route_cfg for decode_bl's routing kernels
at config 5's and config 4's steps, which a tree from before them reports
as absent; plain route keeps both; sim_step for the sim step's kernels
(the channel, decode_bl's entry, the counters) at the flagship's, config
4's and config 5's steps, absent from a tree before them; k5_gf64_nr8
also times K5 at 4096 frames with and without a frame list, the lists
absent from a tree whose cn_update takes none).

Prints the card's name and power limit, then one JSON line per case:
device ms (CUDA events, mean over `reps` calls after one warm-up; for the
probes, whose calls take tens of microseconds, also `queued_ms`: the calls
enqueued behind a sleeping kernel, so that the host's time per call is
not counted) and a digest of the outputs (equal digests: equal outputs,
-0 counted as +0).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(HERE))
# chip_smoke's helpers import the package only when called, so they use
# the tree that --root puts first on the path
from chip_smoke import (CFG5, K0_GF32, OVERSIZE_EBN0, OVERSIZE_FRAMES,  # noqa: E402
                        SIM_STEP_SHAPES, _graph, _llrs, _u_for, cuda_ms, oversize_spec,
                        queued_ms, route_inputs, sim_step_inputs)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t + 0.0 if t.is_floating_point() else t    # -0 -> +0
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# (case, frames per point, noise, noise is Eb/N0, iterations,
# early_term, stats_each_iter, nm): the bench step of ems_gf16_n204_k102,
# chip_smoke.py's sweep shape, its throughput mode and its nm = 8 mode
K3_CASES = [("k3_bench", 8192, [0.63], False, 50, False, False, 16),
            ("k3_sweep", 8192, [1.5, 2.0], True, 50, True, True, 16),
            ("k3_2048", 2048, [1.5], True, 50, False, False, 16),
            ("k3_nm8", 2048, [1.5], True, 50, True, True, 8)]
# (case, code, frames per point, noise, noise is Eb/N0, iterations,
# early_term, stats_each_iter): the bench step of qspa_gf16_n204_k102_c8,
# chip_smoke.py's sweep shape and its 2048-frame throughput mode, BASELINE
# config 1's step (GF(4), 512 frames, 20 iterations, early termination) and
# the same at 8192 frames in throughput mode, and chip_smoke.py's random
# GF(32) code (K0_GF32)
K0_CASES = [("k0_bench", "gf16_n204_k102_c8", 8192, [0.63], False, 50, False, False),
            ("k0_sweep", "gf16_n204_k102_c8", 8192, [1.5, 2.0], True, 50, True, True),
            ("k0_2048", "gf16_n204_k102_c8", 2048, [1.5], True, 50, False, False),
            ("k0_gf4_cfg1", "gf4_n96_k48", 512, [2.5], True, 20, True, True),
            ("k0_gf4_8192", "gf4_n96_k48", 8192, [2.5], True, 20, False, False),
            ("k0_gf32", "gf32_random", 2048, [2.0], True, 50, False, False)]
# (case, q, iterations, early_term, stats_each_iter): K0-cl's scratch
# kernel on chip_smoke.py's codes no cluster holds (oversize_spec: GF(256),
# N = 1200, and GF(64), N = 2400), 512 frames at 2.5 dB in the three modes
# of its phase resident_cl, throughput (the timed one) first
K0CL_CASES = [(f"k0cl_scratch_gf{q}{suffix}", q, iters, et, stats)
              for q in (256, 64)
              for suffix, iters, et, stats in (("", 20, False, False), ("_early", 20, True, True),
                                               ("_one_iter", 1, False, True))]
# (case, code, frames per point, Eb/N0 points (None: config 5's 8),
# (iterations, early_term, stats_each_iter), precision): K0-cl's cluster
# kernel and, beside it, its scratch kernel on the codes a cluster holds:
# config 5's bench step (20 iterations, throughput) in f32 and bf16, phase
# resident_cl's GF(64) (576,480) shape, and config 5's sim step as the
# cell gf256_qspa.cfg5 decodes it (512 frames at each of its 8 points, 20
# iterations, early termination; scratch kernel not run)
K0CL_CLUSTER_CASES = [
    ("k0cl_cluster_cfg5", "gf256_n255_k175", 4096, [3.0], (20, False, False), "f32"),
    ("k0cl_cluster_gf64", "gf64_n576_k480", 2048, [3.0], (20, False, False), "f32"),
    ("k0cl_cluster_cfg5_bf16", "gf256_n255_k175", 4096, [3.0], (20, False, False), "bf16"),
    ("k0cl_cluster_cfg5_cell", "gf256_n255_k175", 512, None, (20, True, True), "f32")]
# (case, code, frames, n_r, tie levels): chip_smoke.py's phase cn_tems
K5_CASES = [("k5_gf16_exact", "gf16_n204_k102", 8192, 0, 0),
            ("k5_gf64_exact", "gf64_n576_k480", 1024, 0, 0),
            ("k5_gf64_nr8", "gf64_n576_k480", 1024, 8, 0),
            ("k5_gf64_nr8_ties", "gf64_n576_k480", 1024, 8, 4),
            ("k5_gf256_nr8", "gf256_n255_k175", 512, 8, 0)]
# (case, code, frames, n_r, frames listed): K5 at config 4's check node and
# 4096 frames, at full width and with a frame list (decode_bl's retired
# frames): 40% and 10% of the frames drawn at random, and the first quarter
# (one SNR slot of four); a tree whose cn_update takes no list reports those
# as absent
K5_LIST_CASES = [("k5_gf64_nr8_4096", "gf64_n576_k480", 4096, 8, None),
                 ("k5_gf64_nr8_4096_active40", "gf64_n576_k480", 4096, 8, 0.4),
                 ("k5_gf64_nr8_4096_active10", "gf64_n576_k480", 4096, 8, 0.1),
                 ("k5_gf64_nr8_4096_slot25", "gf64_n576_k480", 4096, 8, "slot")]
# (case, code, frames): K1 at [102,4,16,8192], at phase highq_qspa's GF(64)
# shape [96,12,64,2048] and at config 5's bench step [80,7,256,4096]
K1_CASES = [("k1_gf16", "gf16_n204_k102", 8192),
            ("k1_gf64", "gf64_n576_k480", 2048),
            ("k1_gf256_cfg5", "gf256_n255_k175", 4096)]
# (case, code, frames, nm, tie levels, merge): K2b at phase cn_ems's
# shapes and config 5's EMS step, once on tie-heavy inputs; K2 (classic)
# beside it at the same shapes
EMS_CASES = [(f"{k}_{label}", code, B, nm, levels, merge)
             for k, merge in (("k2b", "bubble"), ("k2", "classic"))
             for label, code, B, nm, levels in (
                 ("gf64_nm8", "gf64_n576_k480", 1024, 8, 0),
                 ("gf256_512", "gf256_n255_k175", 512, 16, 0),
                 ("gf256_512_ties", "gf256_n255_k175", 512, 16, 4),
                 ("gf256_cfg5", "gf256_n255_k175", 4096, 16, 0))]

# (case, code, frames): decode_bl's routing kernels (route_down, route_up)
# at config 5's step [GF(256) (255,175), 4096 frames] and config 4's
# [GF(64) (576,480), 1024 frames], on chip_smoke's phase-routing inputs
# (chip_smoke.route_inputs)
ROUTE_CASES = [("route_cfg5", "gf256_n255_k175", 4096), ("route_cfg4", "gf64_n576_k480", 1024)]
# the sim step's kernels (csrc/sim_step.cu) at chip_smoke's SIM_STEP_SHAPES,
# all-zero codeword: (case, code, Eb/N0 points or sigmas (None: config
# 5's points), frames a slot, whether the points are Eb/N0)
SIM_STEP_CASES = [(f"sim_step_{label}", *rest) for label, *rest in SIM_STEP_SHAPES]

# (case, iterations): the probes at their entry points' shapes and depths,
# P1, P2 and P4 at micro_kernels' x [408,16,128], P5 at micro_layout's X
# [16,4,102,128] ("new") and [16,4,64,102] ("old"), P6 and P7 at its post
# [16,204,128] and [16,64,204]; P1, P2, P5 and the route also at 0 and 200
# iterations (their fixed cost and slope)
PROBE_CASES = [("p1", 20), ("p2", 20), ("p4", 20), ("p5_new", 50), ("p5_old", 50),
               ("route_new", 50), ("route_old", 50)]
PROBE_DEPTHS = [(f"{probe}_{iters}", iters)
                for probe in ("p1", "p2", "p5_new", "p5_old", "route_new", "route_old")
                for iters in (0, 200)]


def _probe(case: str, iters: int, device):
    """The wrapper call of one PROBE_CASES or PROBE_DEPTHS entry."""
    import torch

    from nbldpc_tpu_torch.benchmarks import micro_kernels as mk
    from nbldpc_tpu_torch.benchmarks import micro_layout as ml
    from nbldpc_tpu_torch.kernels import micro

    if case.startswith(("p1", "p2")):
        x, perm = mk.make_inputs(0)
        name = "flat_constant_gather" if case.startswith("p1") else "per_edge_row_moves"
        return mk.case(name, x.to(device), perm, iters)[0]
    if case == "p4":
        x = mk.make_inputs(0)[0].to(device)
        return lambda: micro.cn_iteration(x, iters)
    layout = case.split("_")[1]
    inp = ml.make_inputs(0)
    if case.startswith("p5"):
        x, rb = inp[f"x_{layout}"].to(device), inp[f"rb_{layout}"].to(device)
        return lambda: micro.rot_softmax(x, rb, iters, layout)
    post = inp[f"post_{layout}"].to(device)
    vn, nbr = inp["vn"].to(device), inp["nbr"].to(device)
    return lambda: micro.route(post, vn, nbr, iters, layout)


def _k0_graph(code: str, device):
    if code != "gf32_random":
        return _graph(code, device)
    from nbldpc_tpu_torch.code import random_regular_spec
    from nbldpc_tpu_torch.graph import TannerGraph

    return TannerGraph(random_regular_spec(*K0_GF32), device=device)


def _k0_case(case, device):
    """(decoder, llr) of one K0_CASES entry."""
    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    _, code, frames, noise, ebn0, iters, et, stats = case
    g = _k0_graph(code, device)
    return qr.ResidentQSPA(g, iters, et, stats), _llrs(g, frames, noise, device, ebn0)


def _k0cl_case(case, device):
    """(decoder, llr) of one K0CL_CASES entry."""
    from nbldpc_tpu_torch.graph import TannerGraph
    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    _, q, iters, et, stats = case
    g = TannerGraph(oversize_spec(q), device=device)
    return (qr.ResidentQSPA(g, iters, et, stats),
            _llrs(g, OVERSIZE_FRAMES, [OVERSIZE_EBN0], device))


def run_kernels(device, reps: int, only=()):
    """Every case, or those whose name starts with one of `only`."""
    import torch

    from nbldpc_tpu_torch.kernels import cn_ems, cn_qspa, cn_tems
    from nbldpc_tpu_torch.kernels import ems_resident as er
    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    def keep(cases):
        return [c for c in cases if not only or c[0].startswith(tuple(only))]

    g = _graph("gf16_n204_k102", device)
    for case, frames, noise, ebn0, iters, et, stats, nm in keep(K3_CASES):
        llr = _llrs(g, frames, noise, device, ebn0)
        dec = er.ResidentEMS(g, iters, nm, 0.3, et, stats)
        out = er.resident_decode(dec, llr)
        yield {"case": case, "frames": llr.shape[0], "iters": iters, "nm": nm,
               "frame_iterations": int(out[2].sum()), "digest": _digest(*out),
               "ms": cuda_ms(lambda: er.resident_decode(dec, llr), reps)}
    for case in keep(K0_CASES):
        dec, llr = _k0_case(case, device)
        out = qr.resident_decode(dec, llr)
        yield {"case": case[0], "code": case[1], "frames": llr.shape[0], "iters": case[5],
               "frame_iterations": int(out[2].sum()), "digest": _digest(*out),
               "ms": cuda_ms(lambda: qr.resident_decode(dec, llr), reps)}
    for case in keep(K0CL_CASES):
        dec, llr = _k0cl_case(case, device)
        out = qr.resident_decode_cl_scratch(dec, llr)
        yield {"case": case[0], "frames": llr.shape[0], "iters": case[2],
               "frame_iterations": int(out[2].sum()), "digest": _digest(*out),
               "frames_at_once": qr.scratch_occupancy(dec, device),
               "cluster_size": qr.scratch_layout(dec)[0].size,
               "ms": cuda_ms(lambda: qr.resident_decode_cl_scratch(dec, llr), reps)}
    for case, code, frames, points, mode, precision in keep(K0CL_CLUSTER_CASES):
        g = _graph(code, device)
        points = json.loads((HERE / CFG5).read_text())["channel"]["ebn0_db"] \
            if points is None else points
        dec = qr.ResidentQSPA(g, *mode, mm_precision=precision)
        llr = _llrs(g, frames, points, device)
        out = qr.resident_decode_cl(dec, llr)
        plan = dec.cluster_plan
        rec = {"case": case, "code": code, "frames": llr.shape[0], "iters": mode[0],
               "early_term": mode[1], "precision": precision,
               "frame_iterations": int(out[2].sum()), "digest": _digest(*out),
               "cluster_size": plan.size, "in_place": getattr(plan, "in_place", False),
               "ms": cuda_ms(lambda: qr.resident_decode_cl(dec, llr), reps)}
        if not mode[1]:
            scratch = qr.resident_decode_cl_scratch(dec, llr)
            rec.update(scratch_digest=_digest(*scratch), scratch_ms=cuda_ms(
                lambda: qr.resident_decode_cl_scratch(dec, llr), reps))
        yield rec
        # every other f32 partition of the code that fits (size, layout),
        # where the tree can set one: each decodes every frame the same, so
        # its digest is the plan's
        if precision != "f32" or not hasattr(qr, "cluster_plan_at"):
            continue
        for size in qr.CLUSTER_SIZES:
            for in_place in (False, True):
                other = qr.cluster_plan_at(g, size, 4, in_place)
                if other is None or (size, in_place) == (plan.size, plan.in_place):
                    continue
                dec._set_cluster_plan(other)
                yield {"case": f"{case}_c{size}{'_in_place' if in_place else ''}",
                       "cluster_size": size, "in_place": in_place,
                       "digest": _digest(*qr.resident_decode_cl(dec, llr)),
                       "ms": cuda_ms(lambda: qr.resident_decode_cl(dec, llr), reps)}
        dec._set_cluster_plan(plan)
    for case, code, B, n_r, levels in keep(K5_CASES):
        U = _u_for(_graph(code, device), B, device, levels)
        out = cn_tems.cn_update(U, 2.0, n_r)
        yield {"case": case, "shape": list(U.shape), "n_r": n_r, "tie_levels": levels,
               "digest": _digest(out),
               "ms": cuda_ms(lambda: cn_tems.cn_update(U, 2.0, n_r), 10 * reps)}
    for case, code, B, n_r, share in keep(K5_LIST_CASES):
        if share is not None and "active" not in inspect.signature(cn_tems.cn_update).parameters:
            yield {"case": case, "absent": True}
            continue
        U = _u_for(_graph(code, device), B, device)
        if share is None:
            active, out = None, None
        elif share == "slot":
            active, out = torch.arange(B // 4, dtype=torch.int32, device=device), U.clone()
        else:
            listed = torch.rand(B, generator=torch.Generator().manual_seed(3)) < share
            active = torch.nonzero(listed).flatten().to(torch.int32).to(device)
            out = U.clone()
        res = cn_tems.cn_update(U, 2.0, n_r, *(() if active is None else (active, out)))
        yield {"case": case, "shape": list(U.shape), "n_r": n_r,
               "frames_listed": B if active is None else active.numel(),
               "digest": _digest(res if active is None else res[..., active.long()]),
               "ms": cuda_ms(lambda: cn_tems.cn_update(
                   U, 2.0, n_r, *(() if active is None else (active, out))), 10 * reps)}
        del U, out
        torch.cuda.empty_cache()
    for case, code, B in keep(K1_CASES):
        g = _graph(code, device)
        U = _u_for(g, B, device)
        out = cn_qspa.cn_update(U)
        ref = cn_qspa.cn_update_plain(U)
        real = g.cn_mask[:, :, None, None].expand_as(ref)
        # the tree's own plain version, above -15 (the card's threshold)
        err = float((out - ref).abs()[real & (ref > -15)].max())
        yield {"case": case, "shape": list(U.shape), "digest": _digest(out),
               "max_abs_err_above_-15": err, "finite": bool(torch.isfinite(out[real]).all()),
               "ms": cuda_ms(lambda: cn_qspa.cn_update(U), 4 * reps)}
    for case, code, B, nm, levels, merge in keep(EMS_CASES):
        U = _u_for(_graph(code, device), B, device, levels)
        fn = cn_ems.cn_update_bubble if merge == "bubble" else cn_ems.cn_update
        out = fn(U, nm, 0.0)
        yield {"case": case, "shape": list(U.shape), "nm": nm, "tie_levels": levels,
               "digest": _digest(out), "ms": cuda_ms(lambda: fn(U, nm, 0.0), 2 * reps)}
    for case, code, B in keep(ROUTE_CASES):
        try:
            from nbldpc_tpu_torch.kernels import route
        except ImportError:
            yield {"case": case, "absent": True}
            continue
        g = _graph(code, device)
        post, Cv, Chat, llr = route_inputs(g, B, device)
        yield {"case": case, "kernel": "route_down", "frames": B,
               "digest": _digest(route.route_down(post, Cv, g)),
               "ms": cuda_ms(lambda: route.route_down(post, Cv, g), 4 * reps)}
        yield {"case": case, "kernel": "route_up", "frames": B,
               "digest": _digest(*route.route_up(Chat, llr, g)),
               "ms": cuda_ms(lambda: route.route_up(Chat, llr, g), 4 * reps)}
        del post, Cv, Chat, llr
        torch.cuda.empty_cache()
    for case, code, points, B, ebn0 in keep(SIM_STEP_CASES):
        try:
            from nbldpc_tpu_torch.kernels import sim_step
        except ImportError:
            yield {"case": case, "absent": True}
            continue
        from nbldpc_tpu_torch.channel import ebn0_to_sigma

        g = _graph(code, device)
        points = json.loads((HERE / CFG5).read_text())["channel"]["ebn0_db"] \
            if points is None else points
        sigmas = [float(ebn0_to_sigma(x, g.spec.k / g.n)) if ebn0 else x for x in points]
        noise, sig, _, iters, done = sim_step_inputs(g, B, sigmas, device)
        S = len(sigmas)
        llr = sim_step.channel_llr(noise, sig, g.q)
        flat = llr.reshape(S * B, g.n, g.q)
        prior, hard0 = sim_step.prior_bl(flat)
        hard = hard0.T.contiguous()
        counters = sim_step.count_errors(hard, None, iters, done, S, B, g.gf.p)
        for name, fn, out in (
                ("channel_llr", lambda: sim_step.channel_llr(noise, sig, g.q), (llr,)),
                ("prior_bl", lambda: sim_step.prior_bl(flat), (prior, hard0)),
                ("count_errors", lambda: sim_step.count_errors(hard, None, iters, done, S, B,
                                                               g.gf.p),
                 tuple(counters.values()))):
            yield {"case": case, "kernel": name, "slots": S, "frames": B,
                   "digest": _digest(*out), "ms": cuda_ms(fn, 10 * reps),
                   "queued_ms": queued_ms(fn, 10 * reps)}
        del noise, llr, flat, prior, hard0, hard
        torch.cuda.empty_cache()
    for case, iters in keep(PROBE_CASES + PROBE_DEPTHS):
        fn = _probe(case, iters, device)
        out = fn()
        yield {"case": case, "shape": list(out.shape), "iters": iters,
               "digest": _digest(out), "ms": cuda_ms(fn, 20 * reps),
               "queued_ms": queued_ms(fn, 20 * reps)}


def run_steps():
    from nbldpc_tpu_torch import bench
    from nbldpc_tpu_torch.sim import stack, step_generator

    rows = bench.ROWS_BY_NAME
    # config 5's step through the bubble merge (bench row
    # ems_bubble_gf256_n255_k175), made from the classic row so that a tree
    # without that row runs it too
    bubble = rows["ems_gf256_n255_k175"]._replace(
        name="ems_bubble_gf256_n255_k175",
        config=(("nm", 16), ("offset", 0.0), ("ems_merge", "bubble")))
    steps = [*((rows[name], rows[name].impls[0], 10) for name in (
        "qspa_gf16_n204_k102_c8", "qspa_gf16_n204_k102", "ems_gf16_n204_k102",
        "tems_gf64_n576_k480")),
        (rows["qspa_gf256_n255_k175"], "resident", 3),
        (rows["qspa_gf256_n255_k175"], "kernel", 3), (rows["ems_gf256_n255_k175"], "kernel", 3),
        (bubble, "kernel", 3)]
    for row, impl, reps in steps:
        rec = bench.measure(row, impl, reps=reps)
        step, sig, device, _ = bench._step(row, impl)
        yield {"case": f"step_{row.name}", "cn_impl": impl, "ms": rec["ms_per_step"],
               "frame_errors_last_step": rec["frame_errors_last_step"],
               "digest": _digest(stack(step(step_generator(0, 0, device), sig)))}


# Trial builds: name -> (source in csrc/, [(text, its replacement), ...]).
# k3_framesN sets kMaxFrames, the most frames a K3 block holds, to N;
# k3_no_vn and k3_no_merge drop the variable-node phase or the merges' max
# (wrong outputs: their times say what that part costs); k5_warps16 keeps
# 16 warps a K5 block however few blocks fit an SM; k5_shuffles reduces
# over a full warp by shuffles instead of __reduce_*_sync.
BUILDS = {
    # K0: its check phase a thread per check with the spectra through
    # shared memory (k0_check) instead of a pair of threads per check of
    # degree 4 at q <= 16; one
    # frame a block in the one-thread mode too (k0_frames1); pairs up to 4
    # frames a block, 832 threads (k0_pair4);
    # CUDA's logf instead of the branch-free log; the variable phase, the
    # whole check phase, the exp-order sum (x[0] + 1 instead), the softmax
    # division (a product instead) or the log dropped
    "k0_check": ("qspa_resident.cu", [("q <= 16 && dc == 4 ? kPair : kCheck",
                                       "false ? kPair : kCheck")]),
    "k0_frames1": ("qspa_resident.cu", [("constexpr int kMaxFrames = 4;",
                                         "constexpr int kMaxFrames = 1;")]),
    "k0_pair4": ("qspa_resident.cu", [("return mode == kPair ? 1 : kMaxFrames;",
                                       "return kMaxFrames;"),
                                      ("mode == kPair ? 672", "mode == kPair ? 832")]),
    "k0_no_vn": ("qspa_resident.cu", [("vn_chunk<Q, S>(fbase, L.frame, L.off_lc, L.off_post, vno, i, dv, live);",
                                       ";")]),
    "k0_no_cn": ("qspa_resident.cu", [
        ("check_update<Q>(fr + L.off_post,", "if (false) check_update<Q>(fr + L.off_post,"),
        ("check_update_pair<Q>(fr + L.off_post,", "if (false) check_update_pair<Q>(fr + L.off_post,")]),
    "k0_no_sum": ("qspa_resident.cu", [("const float sum = exp_order_sum<Q>(x, x[0]);",
                                        "const float sum = x[0] + 1.0f;")]),
    "k0_no_div": ("qspa_resident.cu", [("x[a] = x[a] / sum;", "x[a] = x[a] * sum;")]),
    "k0_no_log": ("qspa_resident.cu", [("log_normal(fmaxf(g[a] * (1.0f / Q), kProbFloor))",
                                        "fmaxf(g[a] * (1.0f / Q), kProbFloor)")]),
    "k0_logf": ("qspa_resident.cu", [("log_normal(fmaxf(g[a] * (1.0f / Q), kProbFloor))",
                                      "logf(fmaxf(g[a] * (1.0f / Q), kProbFloor))")]),
    **{f"k3_frames{n}": ("ems_resident.cu", [("constexpr int kMaxFrames = 3;",
                                              f"constexpr int kMaxFrames = {n};")])
       for n in (1, 2, 3)},
    "k3_no_vn": ("ems_resident.cu", [("for (int i = tid; i < N * C; i += nt)",
                                      "for (int i = tid; i < 0; i += nt)")]),
    "k3_no_merge": ("ems_resident.cu", [("o[a] = b == 0 ? c : fmaxf(o[a], c);",
                                         "o[a] = b == 0 ? c : o[a];")]),
    # K1: CUDA's logf instead of log_normal; blocks of 4 warps at q >= 32;
    # a warp a frame at q = 32 and 64, half a warp at q = 128 and 256
    "k1_logf": ("cn_qspa.cu", [("lm[s] = log_normal(fabsf(x[s]) + kMagTiny);",
                                "lm[s] = logf(fabsf(x[s]) + kMagTiny);"),
                               ("v[s] = log_normal(fmaxf(", "v[s] = logf(fmaxf(")]),
    "k1_warps4": ("cn_qspa.cu", [("int threads = L == 1 ? 128 : 256;",
                                  "int threads = L == 1 ? 128 : 128;")]),
    "k1_l32": ("cn_qspa.cu", [("Q < 32 ? 1 : (Q <= 64 ? 16 : 32);",
                               "Q < 32 ? 1 : (Q <= 64 ? 32 : 32);")]),
    "k1_l16": ("cn_qspa.cu", [("Q < 32 ? 1 : (Q <= 64 ? 16 : 32);",
                               "Q < 32 ? 1 : (Q <= 64 ? 16 : 16);")]),
    # K2b: 4 register slots a lane whenever they hold the candidates (also
    # where 2 do); blocks of 4 warps; at most 85 registers a thread (3
    # blocks an SM)
    "k2b_slots4": ("cn_ems.cu", [("P <= 2 * L ? 2 : (P <= kSlots * L ? kSlots : 0)",
                                  "P <= kSlots * L ? kSlots : 0")]),
    "k2b_warps4": ("cn_ems.cu", [("  int warps = 8;\n  if (!bubble) {",
                                  "  int warps = bubble ? 4 : 8;\n  if (!bubble) {")]),
    "k2b_lb3": ("cn_ems.cu", [("__launch_bounds__(256, 4)\ncn_ems_bubble_kernel",
                               "__launch_bounds__(256, 3)\ncn_ems_bubble_kernel")]),
    # K0-cl's scratch kernel as this tree builds it (a frame a cluster,
    # messages in a slice): its check phase or its variable phase dropped,
    # or every cluster on one of 4 slices (10 MB at GF(256), N = 1200: the L2
    # holds them; wrong outputs: the time without device-memory traffic for
    # the messages), or the grid capped at 13 clusters (GF(256), N = 1200:
    # their slices and LLR rows, 48 MB, fit the 50 MB L2)
    "k0clx_no_cn": ("qspa_resident_cl.cu", [("cn_phase<Q, PS, T>(cl, r, logx, it == 0);",
                                             "if (false) cn_phase<Q, PS, T>(cl, r, logx, it == 0);")]),
    "k0clx_no_vn": ("qspa_resident_cl.cu", [("{ vn_phase<Q, PS, T>(",
                                             "{ if (false) vn_phase<Q, PS, T>(")]),
    "k0clx_l2": ("qspa_resident_cl.cu", [("T* slice = scratch + (size_t)cid * slice_floats(",
                                          "T* slice = scratch + (size_t)(cid % 4) * slice_floats(")]),
    "k0clx_grid13": ("qspa_resident_cl.cu", [("cfg.gridDim = dim3(grid * C);",
                                              "cfg.gridDim = dim3((grid < 13 ? grid : 13) * C);")]),
    "k5_warps16": ("cn_tems.cu", [("smem_bytes<Q>(dc, warps) > kMaxSmem / 3",
                                   "smem_bytes<Q>(dc, warps) > kMaxSmem")]),
    "k5_shuffles": ("cn_tems.cu", [(f"if constexpr (W == 32) {{\n    return __reduce_{op}_sync",
                                    f"if constexpr (W == 64) {{\n    return __reduce_{op}_sync")
                                   for op in ("max", "min")]),
}


class _TrialLibrary:
    """The kernel library with the C entry points of one trial build in
    place of its own (the wrappers call `_build.library()`)."""

    def __init__(self, path, base):
        self._lib, self._base = ctypes.CDLL(str(path)), base

    def __getattr__(self, name):
        from nbldpc_tpu_torch.kernels import _build

        try:
            fn = getattr(self._lib, name)
        except AttributeError:
            return getattr(self._base, name)
        fn.argtypes, fn.restype = _build.SIGNATURES[name], ctypes.c_int
        return fn


def builds_trial(device, names, reps: int):
    """The --root tree's K0, K0-cl's scratch kernel, K3, K5, K1 or K2b
    built with each edit of BUILDS: K0 builds timed at every K0 case,
    scratch builds at the throughput cases of K0CL_CASES (beside the
    library kernel on one round of frames, as many as run at once), K3
    builds at its bench step, K5, K1 and K2b builds at every K5, K1 or K2b
    case; `same` tells whether the outputs equal the library kernel's."""
    import torch

    from nbldpc_tpu_torch.kernels import _build, cn_tems
    from nbldpc_tpu_torch.kernels import ems_resident as er
    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    out_dir = _build.BUILD_DIR / "trial_builds"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        source, edits = BUILDS[name]
        src = (_build.CSRC / source).read_text()
        for old, new in edits:
            if old not in src:
                raise ValueError(f"build {name}: {old!r} is not in {source}")
            src = src.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(cu.with_suffix(".so")), str(cu)], stderr=subprocess.PIPE, text=True)
    for name, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for build {name}:\n{p.stderr.read()}")

    def entry(name, fn):
        f = getattr(ctypes.CDLL(str(out_dir / f"{name}.so")), fn)
        f.argtypes, f.restype = _build.SIGNATURES[fn], ctypes.c_int
        return f

    def checked(rc, name):
        if rc:
            msg = _build.library().nbldpc_error_string(rc).decode()
            raise RuntimeError(f"build {name}: CUDA error {rc}: {msg}")

    stream = _build.stream_ptr(device)
    def through(name, fn):
        """fn() with the wrappers calling build `name`'s entry points, its
        output and its time."""
        real = _build.library
        trial = _TrialLibrary(out_dir / f"{name}.so", real())
        _build.library = lambda: trial
        try:
            return fn(), cuda_ms(fn, reps)
        finally:
            _build.library = real

    scratch = [n for n in names if BUILDS[n][0] == "qspa_resident_cl.cu"]
    for case in [c for c in K0CL_CASES if c[0] in ("k0cl_scratch_gf256", "k0cl_scratch_gf64")]:
        if not scratch:
            break
        dec, llr = _k0cl_case(case, device)
        ref = _digest(*qr.resident_decode_cl_scratch(dec, llr))
        at_once = qr.scratch_occupancy(dec, device)
        one = llr[:at_once].contiguous()
        yield {"case": case[0], "build": "library", "frames": at_once,
               "ms_one_round": cuda_ms(lambda: qr.resident_decode_cl_scratch(dec, one), reps)}
        for name in scratch:
            outs, ms = through(name, lambda: qr.resident_decode_cl_scratch(dec, llr))
            yield {"case": case[0], "build": name, "ms": ms, "same": _digest(*outs) == ref}
    k0 = [n for n in names if BUILDS[n][0] == "qspa_resident.cu"]
    for case in K0_CASES if k0 else ():
        dec, llr = _k0_case(case, device)
        g, B = dec.graph, llr.shape[0]
        ref = _digest(*qr.resident_decode(dec, llr))
        outs = (torch.empty((B, g.n), dtype=torch.int32, device=device),
                torch.empty(B, dtype=torch.bool, device=device),
                torch.empty(B, dtype=torch.int32, device=device))
        next_frame = torch.empty(1, dtype=torch.int32, device=device)
        tables = [dec.cn_vn, dec.cn_real, dec.perm_down, dec.vn_edge, dec.syn_k]
        for name in k0:
            fn = entry(name, "qspa_resident_decode")
            ms = cuda_ms(lambda: checked(fn(
                llr.data_ptr(), *(o.data_ptr() for o in (*outs, next_frame)), B, g.n, g.m,
                g.dc_max, g.dv_max, g.q, *(x.data_ptr() for x in tables), dec.max_iters,
                int(dec.early_term), int(dec.stats_each_iter), stream), name), reps)
            yield {"case": case[0], "build": name, "ms": ms, "same": _digest(*outs) == ref}
    k3 = [n for n in names if n.startswith("k3")]
    if k3:
        g = _graph("gf16_n204_k102", device)
        _, frames, noise, ebn0, iters, et, stats, nm = K3_CASES[0]
        llr = _llrs(g, frames, noise, device, ebn0)
        dec = er.ResidentEMS(g, iters, nm, 0.3, et, stats)
        ref = _digest(*er.resident_decode(dec, llr))
        outs = (torch.empty((frames, g.n), dtype=torch.int32, device=device),
                torch.empty(frames, dtype=torch.bool, device=device),
                torch.empty(frames, dtype=torch.int32, device=device))
    for name in k3:
        fn = entry(name, "ems_resident_decode")
        ms = cuda_ms(lambda: checked(fn(
            llr.data_ptr(), *(o.data_ptr() for o in outs), frames, g.n, g.m, g.dc_max,
            g.dv_max, g.q, nm, 0.3, dec.cn_vn.data_ptr(), dec.cn_real.data_ptr(),
            dec.perm_down.data_ptr(), dec.vn_edge.data_ptr(), dec.syn_k.data_ptr(), iters,
            int(et), int(stats), stream), name), reps)
        yield {"case": "k3_bench", "build": name, "ms": ms, "same": _digest(*outs) == ref}
    k1 = [n for n in names if n.startswith("k1")]
    for case, code, B in K1_CASES if k1 else ():
        U = _u_for(_graph(code, device), B, device)
        from nbldpc_tpu_torch.kernels import cn_qspa

        ref = _digest(cn_qspa.cn_update(U))
        out = torch.empty_like(U)
        for name in k1:
            fn = entry(name, "cn_qspa_update")
            ms = cuda_ms(lambda: checked(fn(U.data_ptr(), out.data_ptr(), *U.shape, stream),
                                         name), 4 * reps)
            yield {"case": case, "build": name, "ms": ms, "same": _digest(out) == ref}
    k2b = [n for n in names if n.startswith("k2b")]
    bubble = [c for c in EMS_CASES if c[-1] == "bubble"]
    for case, code, B, nm, levels, _ in bubble if k2b else ():
        U = _u_for(_graph(code, device), B, device, levels)
        from nbldpc_tpu_torch.kernels import cn_ems

        ref = _digest(cn_ems.cn_update_bubble(U, nm, 0.0))
        out = torch.empty_like(U)
        for name in k2b:
            fn = entry(name, "cn_ems_update_bubble")
            ms = cuda_ms(lambda: checked(fn(U.data_ptr(), out.data_ptr(), *U.shape, nm, 0.0,
                                            stream), name), 2 * reps)
            yield {"case": case, "build": name, "ms": ms, "same": _digest(out) == ref}
    k5 = [n for n in names if n.startswith("k5")]
    for case, code, B, n_r, levels in K5_CASES if k5 else ():
        U = _u_for(_graph(code, device), B, device, levels)
        ref = _digest(cn_tems.cn_update(U, 2.0, n_r))
        out = torch.empty_like(U)
        # no frame list, where the entry point takes one
        no_list = (None, 0) if len(_build.SIGNATURES["cn_tems_update"]) == 11 else ()
        for name in k5:
            fn = entry(name, "cn_tems_update")
            ms = cuda_ms(lambda: checked(fn(U.data_ptr(), out.data_ptr(), *U.shape, n_r, 2.0,
                                            *no_list, stream), name), 10 * reps)
            yield {"case": case, "build": name, "ms": ms, "same": _digest(out) == ref}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--builds", default="")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="", help="comma-separated case-name prefixes")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    from nbldpc_tpu_torch import bench

    device = torch.device("cuda", 0)
    print(bench.card_info(), flush=True)
    runs = [run_kernels(device, args.reps, [o for o in args.only.split(",") if o])]
    if args.steps:
        runs.append(run_steps())
    if args.builds:
        runs.append(builds_trial(device, args.builds.split(","), args.reps))
    for run in runs:
        for rec in run:
            print(json.dumps({"root": str(root), **rec}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
