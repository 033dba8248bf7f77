"""CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX (the machine with the card has none) and skip
without a card. Run them there with:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

from pathlib import Path

import ctypes
import functools
import json
import math

import numpy as np
import pytest
import torch

from nbldpc_tpu_torch import bench
from nbldpc_tpu_torch.benchmarks import micro_kernels, micro_layout, run_all
from nbldpc_tpu_torch.channel import ebn0_to_sigma, llr_init, perfect_llr, transmit
from nbldpc_tpu_torch.code import CodeSpec, random_regular_spec
from nbldpc_tpu_torch.codegen import make_peg_code
from nbldpc_tpu_torch.convert import codespec_from_arrays
from nbldpc_tpu_torch.encode import Encoder
from nbldpc_tpu_torch.gf import get_field
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import cn_ems, cn_qspa, cn_tems
from nbldpc_tpu_torch.kernels import ems_resident as er
from nbldpc_tpu_torch.kernels import micro, route, sim_step
from nbldpc_tpu_torch.kernels import qspa_resident as qr
from nbldpc_tpu_torch.utils.config import CodeConfig

CODES = Path(__file__).resolve().parents[1] / "codes"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _graph(name, device):
    return TannerGraph(CodeConfig(path=str(CODES / f"{name}.alist")).load(), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["gf4_n96_k48", "gf16_n204_k102", "gf64_n576_k480",
                                  "gf256_n255_k175"])
def test_cn_kernel_matches_plain(cuda_device, code):
    g = _graph(code, cuda_device)
    rng = np.random.default_rng(1)
    Vv = torch.from_numpy((rng.standard_normal((g.n, g.dv_max, g.q, 200)) * 3.0)
                          .astype(np.float32)).to(cuda_device)
    U = g.gather_cn_x_bl(Vv).contiguous()
    before = cn_qspa.cn_update.launches
    out = cn_qspa.cn_update(U)
    assert cn_qspa.cn_update.launches == before + 1
    ref = cn_qspa.cn_update_plain(U)
    real = g.cn_mask[:, :, None, None].expand_as(ref)
    assert bool(torch.isfinite(out[real]).all())
    # same association order; exp/log may differ by an ulp, which the
    # inverse WHT's cancellation amplifies only in the deep log tail
    assert float((out - ref).abs()[real & (ref > -15)].max()) <= 1e-4


def _hold_cn_qspa(U, real=None):
    """K1 against its plain version on U: one launch, finite outputs, error
    <= 1e-4 where the plain output is above -15 (the deep log tail, where
    the inverse WHT cancels towards the 1e-12 floor, moves with an ulp of
    exp or log)."""
    before = cn_qspa.cn_update.launches
    out = cn_qspa.cn_update(U)
    assert cn_qspa.cn_update.launches == before + 1
    ref = cn_qspa.cn_update_plain(U)
    real = torch.ones_like(ref, dtype=torch.bool) if real is None else real
    assert bool(torch.isfinite(out[real]).all())
    assert float((out - ref).abs()[real & (ref > -15)].max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 37])
def test_cn_kernel_gf256_matches_plain(cuda_device, B):
    """K1 at GF(256): config 5's step (4096 frames) and a batch that is no
    multiple of a block's frames."""
    g = _graph("gf256_n255_k175", cuda_device)
    U = _random_u(g, B, cuda_device)
    _hold_cn_qspa(U, g.cn_mask[:, :, None, None].expand_as(U))


@pytest.mark.cuda
@pytest.mark.parametrize("q,dc", [(2, 3), (4, 17), (16, 5), (32, 17), (64, 3), (256, 9),
                                  (256, 33), (16, 110), (256, 210)])
def test_cn_kernel_shapes_match_plain(cuda_device, q, dc):
    """K1 at short and long checks on random inputs without pad slots: a
    block shrinks as its slots' log-magnitudes grow (dc = 33 at q = 256),
    and past shared memory the spectra are parked in the output (dc = 110
    at q = 16, a thread a frame; dc = 210 at q = 256, a warp a frame)."""
    rng = np.random.default_rng(q + dc)
    U = torch.from_numpy((rng.standard_normal((2, dc, q, 37)) * 3.0).astype(np.float32))
    _hold_cn_qspa(U.to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(1, False, True), (20, True, True), (20, False, False)])
@pytest.mark.parametrize("code", ["gf4_n96_k48", "gf16_n204_k102_c8"])
def test_resident_kernel_matches_plain(cuda_device, code, mode):
    g = _graph(code, cuda_device)
    _hold_resident(g, _zero_cw_llrs(g, 300, 1.5, cuda_device), mode)   # 300: no tile multiple


def _zero_cw_llrs(g, B, ebn0, device, seed=5):
    """LLRs of B all-zero codewords at ebn0 dB, [B, N, q] contiguous."""
    sigma = float(ebn0_to_sigma(ebn0, g.spec.k / g.n))
    gen = torch.Generator(device=device).manual_seed(seed)
    y = 1.0 + sigma * torch.randn((B, g.n, g.gf.p), generator=gen, device=device)
    return llr_init(y, sigma, g.q).contiguous()


def _random_cw_llrs(g, B, ebn0, device, seed=5):
    """(LLRs [B, N, q] contiguous, codewords [B, N] int32) of B random
    codewords at ebn0 dB: info symbols and noise from one generator, the
    codewords from the port's encoder on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    enc = Encoder(g.spec, device)
    u = torch.randint(0, g.q, (B, enc.k), generator=gen, device=device, dtype=torch.int32)
    cw = enc.encode(u)
    sigma = float(ebn0_to_sigma(ebn0, g.spec.k / g.n))
    return transmit(gen, cw, sigma, g.q).contiguous(), cw


def _satisfied(g, hard):
    """[B] bool: H hard = 0 for hard [B, N], by the graph's syndrome."""
    return ~(g.syndrome_bl(hard.T) != 0).any(dim=0)


# the launch counters of K0, K0-cl's cluster kernel and its scratch kernel
RESIDENT_COUNTERS = (qr.resident_decode, qr.resident_decode_cl, qr.resident_decode_cl_scratch)


def _hold_resident(g, llr, mode, kernel=None, direct=False, cw=None, precision="f32"):
    """One call of qr.resident_decode (with `direct`, of the wrapper
    `kernel` itself) against the plain resident decode on the same LLRs,
    both with state elements of `precision`. The call launches `kernel`
    once (by its counter of that precision: K0 for q <= 32, else by
    default K0-cl's cluster kernel, or its scratch kernel for a code whose
    state no cluster holds) and no other. Agreement (hard, done and
    iters all equal) >= 0.999 after one iteration, else >= 0.995 with
    frame-error counts (against the codewords cw, all-zero when None)
    within |z| < 3: exact but for ulp-level ties of exp/log that a later
    iteration may amplify. A frame the kernel marks done satisfies H.
    Returns the kernel's (hard, done, iters)."""
    dec = qr.ResidentQSPA(g, *mode, mm_precision=precision)
    if kernel is None:
        kernel = qr.resident_decode if g.q <= qr.K0_MAX_Q else qr.resident_decode_cl
    if g.q > qr.K0_MAX_Q and not direct:
        assert (dec.cluster_plan is None) == (kernel is qr.resident_decode_cl_scratch)
    counters = [(c, a) for c in RESIDENT_COUNTERS for a in ("launches", "launches_bf16")]
    mine = "launches" if precision == "f32" else "launches_bf16"
    before = [getattr(c, a) for c, a in counters]
    hk, dk, ik = (kernel if direct else qr.resident_decode)(dec, llr)
    assert [getattr(c, a) for c, a in counters] == [
        n + (c is kernel and a == mine) for (c, a), n in zip(counters, before)]
    assert bool(_satisfied(g, hk)[dk].all())
    hp, dp, ip = qr.decode_plain(dec, llr)
    same = (hk == hp).all(dim=1) & (dk == dp) & (ik == ip)
    agree = float(same.float().mean())
    if mode[0] == 1:
        assert agree >= 0.999
        return hk, dk, ik
    B = llr.shape[0]
    ref = 0 if cw is None else cw
    fe_k, fe_p = int((hk != ref).any(dim=1).sum()), int((hp != ref).any(dim=1).sum())
    pooled = (fe_k + fe_p) / (2 * B)
    se = math.sqrt(pooled * (1 - pooled) * 2 / B)
    z = 0.0 if se == 0 else (fe_k - fe_p) / B / se
    assert agree >= 0.995 and abs(z) < 3
    return hk, dk, ik


def _irregular_spec(q, seed, n=30, m=12):
    """A code over GF(q) with checks of degree 3-5 (CN pad slots) and
    variables of degree 1 to 4 (VN pad slots), random nonzero weights."""
    rng = np.random.default_rng(seed)
    cols = [np.sort(rng.choice(n, size=int(rng.integers(3, 6)), replace=False))
            for _ in range(m)]
    for v in sorted(set(range(n)) - set(np.concatenate(cols).tolist())):
        i = int(rng.integers(0, m))
        cols[i] = np.sort(np.append(cols[i], v))
    return codespec_from_arrays(q, n, m, cols, [rng.integers(1, q, size=len(c)) for c in cols])


# the codes of the K0 tests whose checks take a thread each (several
# frames a block): irregular GF(16) with CN and VN pad slots, dv = 3 GF(4)
# and dv = 2 GF(32)
K0_CODES = {"irregular_gf16": lambda: _irregular_spec(16, 4),
            "dv3_gf4": lambda: random_regular_spec(4, 96, 48, 5, dv=3),
            "gf32": lambda: random_regular_spec(32, 192, 96, 11)}
K0_MODES = [(1, False, True), (20, True, True), (20, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K0_MODES)
@pytest.mark.parametrize("q,n,m,seed,ebn0", [(2, 200, 100, 1, 2.0), (8, 120, 60, 2, 1.5),
                                             (32, 192, 96, 11, 2.0)])
def test_k0_random_codes_match_plain(cuda_device, q, n, m, seed, ebn0, mode):
    """K0 at q = 2, 8 (two threads a check) and 32 (a thread a check) on
    random dv = 2 codes, 299 frames: on an H100 a frame a block
    (test_k0_refills_multi_frame_blocks runs more)."""
    g = TannerGraph(random_regular_spec(q, n, m, seed), device=cuda_device)
    _hold_resident(g, _zero_cw_llrs(g, 299, ebn0, cuda_device), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K0_MODES)
@pytest.mark.parametrize("code", ["irregular_gf16", "dv3_gf4"])
def test_k0_pad_slots_and_dv3_match_plain(cuda_device, code, mode):
    g = TannerGraph(K0_CODES[code](), device=cuda_device)
    assert (g.has_cn_pads and g.has_vn_pads) if code == "irregular_gf16" else g.dv_max == 3
    _hold_resident(g, _zero_cw_llrs(g, 299, 1.5, cuda_device), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(20, True, True), (20, False, True), (20, False, False)])
@pytest.mark.parametrize("code", list(K0_CODES))
def test_k0_refills_multi_frame_blocks(cuda_device, code, mode):
    """K0 with several frames a block, in the early-termination, stats and
    throughput modes, on more frames than the grid holds: frames a block x
    32 (the most blocks an SM runs) x SMs + 37. With early termination or
    stats a block's slots finish at different iterations and take new
    frames from the counter while its other slots decode; the last frames
    leave slots empty."""
    g = TannerGraph(K0_CODES[code](), device=cuda_device)
    dec = qr.ResidentQSPA(g, *mode)
    assert dec.frames_per_block > 1
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    B = dec.frames_per_block * 32 * sms + 37
    _hold_resident(g, _zero_cw_llrs(g, B, 1.5, cuda_device), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K0_MODES)
@pytest.mark.parametrize("code", ["gf4_n96_k48", "gf16_n204_k102_c8"])
def test_k0_on_tied_llrs(cuda_device, code, mode):
    """LLRs from 4 levels: ties in every softmax, product and decision."""
    g = _graph(code, cuda_device)
    rng = np.random.default_rng(9)
    llr = torch.from_numpy((rng.integers(0, 4, (517, g.n, g.q)) * -1.5)
                           .astype(np.float32)).to(cuda_device)
    llr[:, :, 0] = 0.0                       # the all-zero codeword leads
    _hold_resident(g, llr.contiguous(), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 4, 8, 16, 32])
def test_k0_compiled_field_matches_gf(cuda_device, q):
    """The exp order K0 was compiled with is gf.py's: 0, then a^0 .. a^(q-2)."""
    from nbldpc_tpu_torch.gf import GF

    gf = GF(q)
    assert qr.compiled_field(q) == (0, *(int(x) for x in gf.exp[: q - 1]))


@pytest.mark.cuda
def test_k0_log_matches_logf(cuda_device):
    """K0's branch-free log equals logf on every positive normal float."""
    assert qr.log_mismatches(cuda_device) == 0


@pytest.mark.cuda
def test_k0_refuses_oversize_block(cuda_device):
    """A code whose one-frame block exceeds 232,448 B raises ValueError
    before any launch."""
    g = TannerGraph(random_regular_spec(32, 600, 300, 3), device=cuda_device)
    dec = qr.ResidentQSPA(g, 4)
    assert dec.frames_per_block == 1 and dec.smem_bytes > qr.MAX_SMEM_BYTES
    before = qr.resident_decode.launches
    with pytest.raises(ValueError, match="shared memory"):
        qr.resident_decode(dec, torch.zeros((2, g.n, g.q), device=cuda_device))
    assert qr.resident_decode.launches == before


RESIDENT_MODES = [(1, False, True), (20, True, True), (20, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RESIDENT_MODES)
@pytest.mark.parametrize("code,ebn0", [("gf64_n576_k480", 3.0), ("gf256_n255_k175", 2.0)])
def test_resident_cl_kernel_matches_plain(cuda_device, code, ebn0, mode):
    g = _graph(code, cuda_device)
    _hold_resident(g, _zero_cw_llrs(g, 300, ebn0, cuda_device), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RESIDENT_MODES)
def test_resident_cl_kernel_gf128(cuda_device, mode):
    g = TannerGraph(random_regular_spec(128, 96, 24, seed=7), device=cuda_device)
    _hold_resident(g, _zero_cw_llrs(g, 300, 2.5, cuda_device), mode)


@pytest.mark.cuda
def test_resident_cl_kernel_cfg5_bench_shape(cuda_device):
    # BASELINE config 5's bench step: 4096 frames at 3.0 dB, 20 iterations,
    # fixed budget (throughput mode)
    g = _graph("gf256_n255_k175", cuda_device)
    _hold_resident(g, _zero_cw_llrs(g, 4096, 3.0, cuda_device), (20, False, False))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cluster_grid_blocks_count_the_launched_grid(cuda_device, precision):
    """qspa_cluster.grid_blocks adds the grid each launch had, as the
    library reports it: min(B, cudaOccupancyMaxActiveClusters) clusters of
    the plan's size, in either precision, and nothing for no frames;
    qspa_cluster.frame_slots those clusters, a frame each."""
    from nbldpc_tpu_torch.kernels import launch_counts, reset_launch_counts

    g = _graph("gf256_n255_k175", cuda_device)
    dec = qr.ResidentQSPA(g, 20, mm_precision=precision)
    occupancy = qr.cluster_occupancy(dec, cuda_device)
    size = dec.cluster_plan.size
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert 1 <= occupancy and occupancy * size <= sms
    reset_launch_counts()
    for B in (4096, 5, 0):
        qr.resident_decode(dec, _zero_cw_llrs(g, B, 3.0, cuda_device))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["qspa_resident_cl" + ("" if precision == "f32" else "_bf16")] == 2
    assert counts["qspa_cluster.grid_blocks"] == (min(4096, occupancy) + min(5, occupancy)) * size
    assert counts["qspa_cluster.frame_slots"] == min(4096, occupancy) + min(5, occupancy)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cluster_prior_scratch_is_made_once(cuda_device, precision, monkeypatch):
    """In place (config 5's code in f32) the priors' scratch is made at the
    decoder's first launch on a device, one slice of size x rows x q floats
    for each cluster that runs at once, and every later launch reuses it
    without asking for the occupancy again; buffered (bf16) has none."""
    g = _graph("gf256_n255_k175", cuda_device)
    dec = qr.ResidentQSPA(g, 20, mm_precision=precision)
    occupancy, plan = qr.cluster_occupancy(dec, cuda_device), dec.cluster_plan
    asked = []
    monkeypatch.setattr(qr, "cluster_occupancy",
                        lambda *a: asked.append(a) or occupancy)
    for B in (5, 4096, 1):
        qr.resident_decode(dec, _zero_cw_llrs(g, B, 3.0, cuda_device))
    torch.cuda.synchronize()
    assert plan.in_place == (precision == "f32")
    if plan.in_place:
        scratch, clusters = dec._prior[torch.device(cuda_device)]
        assert len(asked) == 1 and clusters == occupancy
        assert scratch.numel() == occupancy * plan.size * plan.rows * g.q
    else:
        assert not asked and "_prior" not in dec.__dict__


@pytest.mark.cuda
def test_cfg5_sim_step_runs_the_cluster_kernel(cuda_device):
    """BASELINE config 5's QSPA step (8 slots x 512 frames) through
    make_sim_step, as run_sweep builds it: one K0-cl cluster launch, its
    grid and frame slots counted, no plain version and no K1."""
    from nbldpc_tpu_torch import sim
    from nbldpc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nbldpc_tpu_torch.utils.config import load_config

    cfg = load_config(CODES.parent / "configs" / "gf256_sweep_2host.json")
    g = TannerGraph(cfg.code.load(), device=cuda_device)
    points = cfg.channel.ebn0_db
    sig = torch.tensor([ebn0_to_sigma(x, g.spec.k / g.n) for x in points],
                       dtype=torch.float32, device=cuda_device)
    step = sim.make_sim_step(g, cfg.decoder, cfg.sim.frames_per_step, len(points))
    reset_launch_counts()
    out = sim.step_counters(step, sim.step_generator(2**31 + 27, 0, cuda_device), sig)
    ran = {k: v for k, v in launch_counts().items() if v}
    dec = qr.get_resident_decoder(g, cfg.decoder.max_iters, cfg.decoder.early_term)
    assert ran["qspa_resident_cl"] == 1
    assert ran["qspa_cluster.grid_blocks"] == (qr.cluster_occupancy(dec, cuda_device)
                                               * dec.cluster_plan.size)
    assert ran["qspa_cluster.frame_slots"] == qr.cluster_occupancy(dec, cuda_device)
    assert not [k for k in ran if k.endswith("_plain") or k.startswith("cn_qspa")]
    assert out["frames"].tolist() == [cfg.sim.frames_per_step] * len(points)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(1, False, True), (20, True, True)])
def test_resident_cl_scratch_kernel_oversize_code(cuda_device, mode):
    # GF(256), N = 1200, dv = 2: 4.9 MB of state per frame, more than a
    # cluster of 8 holds, so K0-cl runs its scratch kernel
    g = TannerGraph(random_regular_spec(256, 1200, 400, seed=3), device=cuda_device)
    _hold_resident(g, _zero_cw_llrs(g, 300, 2.5, cuda_device), mode,
                   qr.resident_decode_cl_scratch)


# K0-cl's scratch kernel (csrc/qspa_resident_cl.cu, a frame a cluster, the
# messages in a global slice a cluster) on random dv = 2 codes no cluster
# holds: GF(256) from about N = 600, GF(64) from about N = 2250
SCRATCH_CODES = {"gf256_n720": (256, 720, 240), "gf256_n1200": (256, 1200, 400),
                 "gf64_n2400": (64, 2400, 800)}
# and random codes the cluster kernel holds in place: GF(256) N = 480 and
# GF(64) N = 1800 on 8 blocks, the priors in global memory (the scratch
# kernel's until its in-place layout)
RANDOM_CODES = {**SCRATCH_CODES, "gf256_n480": (256, 480, 160), "gf64_n1800": (64, 1800, 600)}


@functools.lru_cache(maxsize=None)
def _random_graph(code, device):
    q, n, m = RANDOM_CODES[code]
    return TannerGraph(random_regular_spec(q, n, m, seed=3), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 300, 512])
@pytest.mark.parametrize("mode", RESIDENT_MODES)
@pytest.mark.parametrize("code", list(SCRATCH_CODES))
def test_resident_cl_scratch_kernel_codes_no_cluster_holds(cuda_device, code, mode, B):
    """One frame, a few, fewer than the clusters that run at once and more
    (512: a second round of frames)."""
    g = _random_graph(code, cuda_device)
    _hold_resident(g, _zero_cw_llrs(g, B, 2.5, cuda_device), mode,
                   qr.resident_decode_cl_scratch)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RESIDENT_MODES)
def test_resident_cl_scratch_kernel_posterior_in_slice(cuda_device, mode):
    # GF(256), N = 2400: no cluster of 8 holds even the posterior, which
    # then lives in the slice too
    g = TannerGraph(random_regular_spec(256, 2400, 800, seed=3), device=cuda_device)
    assert not qr.scratch_layout(qr.ResidentQSPA(g, 1))[0].post_shared
    _hold_resident(g, _zero_cw_llrs(g, 37, 2.5, cuda_device), mode,
                   qr.resident_decode_cl_scratch)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RESIDENT_MODES)
@pytest.mark.parametrize("code", ["irregular_gf64", "dc12_gf64", "dc20_gf128",
                                  "gf256_n255_k175"])
def test_resident_cl_scratch_kernel_any_code(cuda_device, code, mode):
    """The scratch kernel called on codes a cluster holds: check and
    variable pad slots (GF(64), degrees 3-5 and 1-4), check degrees above 8
    and 16 (the suffix products' two wider register sets), config 5's."""
    spec = {"irregular_gf64": lambda: _irregular_spec(64, 6),
            "dc12_gf64": lambda: random_regular_spec(64, 300, 50, seed=2),
            "dc20_gf128": lambda: random_regular_spec(128, 200, 20, seed=4)}.get(code)
    g = _graph(code, cuda_device) if spec is None else TannerGraph(spec(), device=cuda_device)
    _hold_resident(g, _zero_cw_llrs(g, 300, 2.5, cuda_device), mode,
                   qr.resident_decode_cl_scratch, direct=True)


# Each cluster of K0-cl's persistent grid decodes frame after frame; a
# frame's outputs must not depend on the cluster that takes it or on the
# frame that cluster decoded before (both kernels once read a frame's hard
# decisions out of shared memory while the next frame's init overwrote
# them, which an agreement >= 0.995 with the plain version let pass)
RUN_ON_CODES = [("cluster", "gf256_n255_k175", 2.0), ("cluster", "gf64_n576_k480", 3.0),
                ("scratch", "gf256_n255_k175", 2.0), ("scratch", "gf256_n1200", 2.5),
                ("scratch", "gf64_n1800", 2.5), ("cluster", "gf64_n1800", 2.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["16x", "at_once_plus_1", "odd"])
@pytest.mark.parametrize("mode", RESIDENT_MODES)
@pytest.mark.parametrize("kernel,code,ebn0", RUN_ON_CODES)
def test_resident_cl_frames_in_a_row_equal_frames_alone(cuda_device, kernel, code, ebn0, mode,
                                                        batch):
    """B = 16 x the clusters that run at once, so every cluster decodes 16
    frames in a row; one more frame than the clusters; an odd B between (2
    x the clusters + 7): hard, done and iters equal, bit for bit, those of
    each frame decoded alone (B = 1, one frame on one cluster)."""
    g = _random_graph(code, cuda_device) if code in RANDOM_CODES else _graph(code, cuda_device)
    dec = qr.ResidentQSPA(g, *mode)
    if kernel == "cluster":
        fn, at_once = qr.resident_decode_cl, qr.cluster_occupancy(dec, cuda_device)
    else:
        fn, at_once = qr.resident_decode_cl_scratch, qr.scratch_occupancy(dec, cuda_device)
    counter = fn.launches
    B = {"16x": 16 * at_once, "at_once_plus_1": at_once + 1, "odd": 2 * at_once + 7}[batch]
    llr = _zero_cw_llrs(g, B, ebn0, cuda_device)
    together = fn(dec, llr)
    alone = [fn(dec, llr[b:b + 1].contiguous()) for b in range(llr.shape[0])]
    assert fn.launches == counter + 1 + llr.shape[0]
    for got, want in zip(together, (torch.cat(parts) for parts in zip(*alone))):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RESIDENT_MODES)
@pytest.mark.parametrize("code", ["gf256_n255_k175", "gf64_n576_k480", "gf128_random"])
def test_resident_cl_two_kernels_agree_bit_for_bit(cuda_device, code, mode):
    """On codes a cluster holds, K0-cl's cluster kernel and its scratch
    kernel follow the same association order: equal hard, done and iters
    for every one of 300 frames."""
    g = (TannerGraph(random_regular_spec(128, 96, 24, seed=7), device=cuda_device)
         if code == "gf128_random" else _graph(code, cuda_device))
    dec = qr.ResidentQSPA(g, *mode)
    assert dec.cluster_plan is not None
    llr = _zero_cw_llrs(g, 300, 2.5, cuda_device)
    for a, b in zip(qr.resident_decode_cl(dec, llr), qr.resident_decode_cl_scratch(dec, llr)):
        assert torch.equal(a, b)


def _alternating_llrs(g, B, device):
    """LLRs of B all-zero codewords, 2.0 dB and 5.5 dB frames in turn."""
    low, high = _zero_cw_llrs(g, B, 2.0, device), _zero_cw_llrs(g, B, 5.5, device, seed=6)
    odd = (torch.arange(B, device=device) % 2 == 1)[:, None, None]
    return torch.where(odd, high, low).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RESIDENT_MODES)
@pytest.mark.parametrize("code", ["gf256_n255_k175", "gf64_n576_k480"])
def test_resident_cl_every_partition_decodes_unequal_frames_as_alone(cuda_device, code, mode):
    """Frames at 2.0 and 5.5 dB in turn, so neighbouring clusters run very
    different iteration counts: under every f32 partition of the code that
    fits (cluster size; buffered or in place), B = 2 x the clusters at
    once + 3 frames give hard, done and iters equal, bit for bit, to each
    frame decoded alone under the plan."""
    g = _graph(code, cuda_device)
    dec = qr.ResidentQSPA(g, *mode)
    plans = [p for size in qr.CLUSTER_SIZES for in_place in (False, True)
             if (p := qr.cluster_plan_at(g, size, 4, in_place)) is not None]
    assert any(p.in_place for p in plans) and any(not p.in_place for p in plans)
    B = 2 * max(qr.cluster_occupancy(dec, cuda_device), 32) + 3
    llr = _alternating_llrs(g, B, cuda_device)
    alone = [qr.resident_decode_cl(dec, llr[b:b + 1].contiguous()) for b in range(B)]
    want = [torch.cat(parts) for parts in zip(*alone)]
    if mode[1]:                 # early termination: the 2.0 dB frames run longer
        assert want[2][0::2].float().mean() > want[2][1::2].float().mean()
    for plan in plans:
        dec._set_cluster_plan(plan)
        got = qr.resident_decode_cl(dec, llr)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (plan.size, plan.in_place)


@pytest.mark.cuda
def test_resident_cl_wrapper_rejects_bad_input(cuda_device):
    g = _graph("gf64_n576_k480", cuda_device)
    dec = qr.ResidentQSPA(g, 2)
    good = torch.zeros((4, g.n, g.q), device=cuda_device)
    for bad in (good.double(),                             # wrong dtype
                torch.zeros((g.n, 4, g.q), device=cuda_device).transpose(0, 1),
                torch.zeros((4, g.n, g.q + 1), device=cuda_device)):
        with pytest.raises(ValueError):
            qr.resident_decode(dec, bad)
    with pytest.raises(ValueError, match="device"):
        qr.resident_decode_cl(dec, good.cpu())             # the kernel takes no CPU tensor
    before = qr.resident_decode_cl.launches
    hard, done, iters = qr.resident_decode(dec, good)
    assert qr.resident_decode_cl.launches == before + 1
    assert hard.shape == (4, g.n) and done.shape == (4,) and iters.shape == (4,)


@pytest.mark.cuda
def test_wrappers_reject_bad_input(cuda_device):
    g = _graph("gf16_n204_k102", cuda_device)
    dec = qr.ResidentQSPA(g, 2)
    with pytest.raises(ValueError):
        qr.resident_decode(dec, torch.zeros((4, g.n, g.q), dtype=torch.float64,
                                            device=cuda_device))
    with pytest.raises(ValueError):
        cn_qspa.cn_update(torch.zeros((2, 4, 16, 8), device=cuda_device).transpose(0, 1))


def _random_u(g, B, device, seed=1, levels=0):
    """Check-node inputs with the code's pad structure: normal draws, or with
    `levels` > 0 drawn from that many values, so every extraction meets ties."""
    rng = np.random.default_rng(seed)
    shape = (g.n, g.dv_max, g.q, B)
    v = (rng.integers(0, levels, shape) * 1.5 if levels
         else rng.standard_normal(shape) * 3.0)
    return g.gather_cn_x_bl(torch.from_numpy(v.astype(np.float32)).to(device)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["classic", "bubble"])
@pytest.mark.parametrize("code,nm,B,levels", [
    ("gf4_n96_k48", 2, 37, 0), ("gf16_n204_k102", 8, 37, 0), ("gf16_n204_k102", 16, 37, 0),
    ("gf64_n576_k480", 8, 37, 0), ("gf256_n255_k175", 16, 37, 0),
    ("gf256_n255_k175", 16, 4096, 0),                 # config 5's step
    ("gf4_n96_k48", 2, 37, 3), ("gf16_n204_k102", 8, 37, 4), ("gf64_n576_k480", 8, 37, 4),
    ("gf256_n255_k175", 16, 37, 4),                   # ties in every round
    # nm = q, and nm > 32: K2b's candidates in shared memory
    ("gf4_n96_k48", 4, 37, 0), ("gf4_n96_k48", 4, 37, 3), ("gf64_n576_k480", 48, 37, 0),
    ("gf64_n576_k480", 48, 37, 4), ("gf256_n255_k175", 32, 37, 4)])
def test_cn_ems_kernels_match_plain(cuda_device, code, nm, B, levels, merge):
    g = _graph(code, cuda_device)
    U = _random_u(g, B, cuda_device, levels=levels)   # 37: not a multiple of any tile
    kern, plain = ((cn_ems.cn_update, cn_ems.cn_update_plain) if merge == "classic"
                   else (cn_ems.cn_update_bubble, cn_ems.cn_update_bubble_plain))
    before = kern.launches
    out = kern(U, nm, 0.2)
    assert kern.launches == before + 1
    ref = plain(U, nm, 0.2)
    assert bool(torch.isfinite(out).all())
    # only adds and max, in the plain version's association: exact
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["classic", "bubble"])
@pytest.mark.parametrize("q,dc,nm", [(2, 2, 2), (16, 3, 16), (64, 2, 8), (256, 3, 16),
                                     (256, 9, 8), (32, 3, 32)])
def test_cn_ems_kernels_short_and_long_checks(cuda_device, q, dc, nm, merge):
    """Checks of degree 2 and 3 (no merge, one merge a chain) and 9, on
    tie-heavy inputs without pad slots: exact."""
    rng = np.random.default_rng(q + dc)
    U = torch.from_numpy((rng.integers(0, 4, (5, dc, q, 37)) * 1.5).astype(np.float32))
    U = U.to(cuda_device)
    kern, plain = ((cn_ems.cn_update, cn_ems.cn_update_plain) if merge == "classic"
                   else (cn_ems.cn_update_bubble, cn_ems.cn_update_bubble_plain))
    assert float((kern(U, nm, 0.2) - plain(U, nm, 0.2)).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(1, False, True), (20, True, True), (20, False, False)])
@pytest.mark.parametrize("code,nm", [("gf4_n96_k48", 4), ("gf16_n204_k102", 16),
                                     ("gf16_n204_k102", 8)])
def test_resident_ems_kernel_matches_plain(cuda_device, code, nm, mode):
    g = _graph(code, cuda_device)
    B = 300
    sigma = float(ebn0_to_sigma(1.5, g.spec.k / g.n))
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    y = 1.0 + sigma * torch.randn((B, g.n, g.gf.p), generator=gen, device=cuda_device)
    llr = llr_init(y, sigma, g.q).contiguous()
    dec = er.ResidentEMS(g, mode[0], nm, 0.3, mode[1], mode[2])
    before = er.resident_decode.launches
    hk, dk, ik = er.resident_decode(dec, llr)
    assert er.resident_decode.launches == before + 1
    hp, dp, ip = er.decode_plain(dec, llr)
    same = (hk == hp).all(dim=1) & (dk == dp) & (ik == ip)
    assert float(same.float().mean()) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(1, False, True), (20, True, True), (20, False, False)])
@pytest.mark.parametrize("nm", [8, 16])
def test_resident_ems_kernel_on_ties(cuda_device, nm, mode):
    # LLRs quantized to 7 levels: ties in every normalization, extraction,
    # merge and decision
    g = _graph("gf16_n204_k102", cuda_device)
    llr = _zero_cw_llrs(g, 300, 1.5, cuda_device)
    llr = ((llr / 2.0).round().clamp(-3.0, 3.0) * 2.0).contiguous()
    dec = er.ResidentEMS(g, mode[0], nm, 0.3, mode[1], mode[2])
    before = er.resident_decode.launches
    hk, dk, ik = er.resident_decode(dec, llr)
    assert er.resident_decode.launches == before + 1
    hp, dp, ip = er.decode_plain(dec, llr)
    same = (hk == hp).all(dim=1) & (dk == dp) & (ik == ip)
    assert float(same.float().mean()) == 1.0


# Random codewords through the whole-decode kernels. With the all-zero
# codeword every product h * 0 in a kernel's syndrome is 0, so its weight
# arithmetic never decided a frame; random codewords are also where the
# tie-breaks (argmax to the lowest symbol, EMS's top-nm stable by index)
# stop favouring the transmitted symbol. (kernel, code) of each case:
# K0 on the flagship code, GF(4) and a random GF(32) code, K0-cl's cluster
# kernel at GF(64) and GF(256), its scratch kernel on a GF(256) code no
# cluster holds, K3 on GF(16); and an Eb/N0 where some frames fail and one
# where nearly all decode.
RANDOM_CW_CASES = [("k0", "gf16_n204_k102_c8", (1.5, 2.5)), ("k0", "gf4_n96_k48", (2.5, 4.5)),
                   ("k0", "gf32", (1.5, 3.5)), ("cluster", "gf64_n576_k480", (3.5, 4.0)),
                   ("cluster", "gf256_n255_k175", (2.0, 3.0)),
                   ("scratch", "gf256_n1200", (2.0, 2.5)), ("k3", "gf16_n204_k102", (1.5, 3.0))]
RANDOM_CW_KERNELS = {"k0": qr.resident_decode, "cluster": qr.resident_decode_cl,
                     "scratch": qr.resident_decode_cl_scratch, "k3": er.resident_decode}


def _case_graph(code, device):
    if code == "gf32":
        return TannerGraph(K0_CODES["gf32"](), device=device)
    if code in RANDOM_CODES:
        return _random_graph(code, device)
    return _graph(code, device)


def _decoder(kernel, g, mode):
    return (er.ResidentEMS(g, mode[0], 16, 0.3, mode[1], mode[2]) if kernel == "k3"
            else qr.ResidentQSPA(g, *mode))


def _decode_both(kernel, dec, llr):
    """The case's kernel through its public wrapper (resident_decode, which
    launches it and no other) and the plain version, on the same LLRs:
    ((hard, done, iters) of the kernel, of the plain version)."""
    before = RANDOM_CW_KERNELS[kernel].launches
    out = (er.resident_decode if kernel == "k3" else qr.resident_decode)(dec, llr)
    assert RANDOM_CW_KERNELS[kernel].launches == before + 1
    plain = er.decode_plain if kernel == "k3" else qr.decode_plain
    return out, plain(dec, llr)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RESIDENT_MODES)
@pytest.mark.parametrize("kernel,code,ebn0s", RANDOM_CW_CASES)
def test_resident_kernels_on_random_codewords(cuda_device, kernel, code, ebn0s, mode):
    """Each whole-decode kernel against its plain version on LLRs of random
    codewords, 300 frames at each Eb/N0, in the three modes: K0 and K0-cl
    to the thresholds of _hold_resident, K3 frame for frame. At the higher
    Eb/N0 with early termination, >= 99% of frames are done and right."""
    g = _case_graph(code, cuda_device)
    for i, ebn0 in enumerate(ebn0s):
        llr, cw = _random_cw_llrs(g, 300, ebn0, cuda_device, seed=11 + i)
        assert not torch.equal(cw, torch.zeros_like(cw))
        if kernel == "k3":
            (hk, dk, ik), (hp, dp, ip) = _decode_both(kernel, _decoder(kernel, g, mode), llr)
            assert torch.equal(hk, hp) and torch.equal(dk, dp) and torch.equal(ik, ip)
        else:
            hk, dk, _ = _hold_resident(g, llr, mode, RANDOM_CW_KERNELS[kernel], cw=cw)
        if i == 1 and mode[1]:
            assert float((dk & (hk == cw).all(dim=1)).float().mean()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RESIDENT_MODES)
@pytest.mark.parametrize("kernel,code,ebn0s", RANDOM_CW_CASES)
def test_resident_syndrome_done_iff_h_satisfied(cuda_device, kernel, code, ebn0s, mode):
    """The kernels' own syndrome on random codewords at the lower Eb/N0
    (frames stop at different iterations, some never): a frame is done
    exactly when H hard = 0, by the graph's syndrome on the host's tables,
    in every mode (in throughput mode done is the final decision's)."""
    g = _case_graph(code, cuda_device)
    llr, _ = _random_cw_llrs(g, 300, ebn0s[0], cuda_device, seed=3)
    (hk, dk, ik), _ = _decode_both(kernel, _decoder(kernel, g, mode), llr)
    assert torch.equal(dk, _satisfied(g, hk))
    assert 0 < int(dk.sum()) or mode[0] == 1


def _inverse_weights(spec):
    """spec with every weight h replaced by h^-1."""
    inv = get_field(spec.q).inv
    return CodeSpec(q=spec.q, n=spec.n, m=spec.m, row_cols=spec.row_cols,
                    row_vals=tuple(inv[v].astype(np.int32) for v in spec.row_vals))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,code,ebn0s", RANDOM_CW_CASES)
def test_resident_syndrome_rejects_inverse_weight_words(cuda_device, kernel, code, ebn0s):
    """Words x with H' x = 0 for H' = H with each weight inverted, and H x
    != 0, as certain LLRs: a kernel whose syndrome took h^-1 for h (the
    sign of the log offset in K0-cl's syndrome_ok, or a syn_k table built
    from perm_down in K0 and K3) would find every such frame done before
    its first iteration. One iteration, early termination: no frame is done
    at iteration 0, and the kernel agrees with its plain version."""
    g = _case_graph(code, cuda_device)
    enc = Encoder(_inverse_weights(g.spec), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = enc.encode(torch.randint(0, g.q, (64, enc.k), generator=gen, device=cuda_device,
                                 dtype=torch.int32))
    assert not bool(_satisfied(g, x).any())
    llr = perfect_llr(x, g.q).contiguous()
    mode = (1, True, True)
    (hk, dk, ik), (hp, dp, ip) = _decode_both(kernel, _decoder(kernel, g, mode), llr)
    assert bool((ik == 1).all())
    assert torch.equal(dk, dp) and torch.equal(ik, ip) and torch.equal(hk, hp)
    assert torch.equal(dk, _satisfied(g, hk))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [4, 16, 64, 256])
def test_encoder_on_card_equals_cpu(cuda_device, q):
    """The encoder on the card equals the encoder on the CPU bit for bit
    (PEG codes from make_peg_code), and its codewords satisfy H there."""
    spec = make_peg_code(60, 30, q, dv=2, seed=q)
    u = torch.randint(0, q, (3, 257, spec.n - spec.m), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(q))
    on_card = Encoder(spec, cuda_device).encode(u.to(cuda_device))
    assert torch.equal(on_card.cpu(), Encoder(spec, "cpu").encode(u))
    g = TannerGraph(spec, cuda_device)
    assert bool(_satisfied(g, on_card.reshape(-1, spec.n)).all())


@pytest.mark.cuda
def test_ems_wrappers_reject_bad_input(cuda_device):
    g = _graph("gf16_n204_k102", cuda_device)
    dec = er.ResidentEMS(g, 2, 8, 0.3)
    with pytest.raises(ValueError):
        er.resident_decode(dec, torch.zeros((4, g.n, g.q), dtype=torch.float64,
                                            device=cuda_device))
    with pytest.raises(ValueError):
        er.resident_decode(dec, torch.zeros((4, g.n + 1, g.q), device=cuda_device))
    bad = torch.zeros((2, 4, 16, 8), device=cuda_device).transpose(0, 1)
    for fn in (cn_ems.cn_update, cn_ems.cn_update_bubble):
        with pytest.raises(ValueError):
            fn(bad, 8, 0.0)
        with pytest.raises(ValueError):
            fn(torch.zeros((2, 4, 12, 8), device=cuda_device), 8, 0.0)
        with pytest.raises(ValueError):
            fn(torch.zeros((2, 1, 16, 8), device=cuda_device), 8, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("code,n_r", [("gf16_n204_k102", 0), ("gf16_n204_k102", 8),
                                      ("gf64_n576_k480", 0), ("gf64_n576_k480", 8),
                                      ("gf256_n255_k175", 8)])
def test_cn_tems_kernel_matches_plain(cuda_device, code, n_r):
    g = _graph(code, cuda_device)
    U = _random_u(g, 37, cuda_device)             # not a multiple of any tile
    before = cn_tems.cn_update.launches
    out = cn_tems.cn_update(U, 2.0, n_r)
    assert cn_tems.cn_update.launches == before + 1
    ref = cn_tems.cn_update_plain(U, 2.0, n_r)
    assert bool(torch.isfinite(out).all())
    # one add per candidate, the rest max and select: exact
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [37, 1024])
@pytest.mark.parametrize("n_r", [0, 8])
@pytest.mark.parametrize("code", ["gf16_n204_k102", "gf64_n576_k480", "gf256_n255_k175"])
def test_cn_tems_kernel_on_ties(cuda_device, code, n_r, B):
    # 4 levels: ties in every argmax, top-3 column and n_r round
    g = _graph(code, cuda_device)
    U = _random_u(g, B, cuda_device, levels=4)
    before = cn_tems.cn_update.launches
    out = cn_tems.cn_update(U, 2.0, n_r)
    assert cn_tems.cn_update.launches == before + 1
    ref = cn_tems.cn_update_plain(U, 2.0, n_r)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.cuda
def test_cn_tems_wrapper_rejects_bad_input(cuda_device):
    good = torch.zeros((2, 4, 16, 8), device=cuda_device)
    with pytest.raises(ValueError, match="device"):
        cn_tems._launch(good.cpu(), 0.0, 0)                # the kernel takes no CPU tensor
    for bad in (good.double(),                             # wrong dtype
                good.transpose(0, 1),                      # not contiguous
                torch.zeros((2, 2, 16, 8), device=cuda_device),    # dc < 3
                torch.zeros((2, 4, 12, 8), device=cuda_device),    # q not a power of 2
                torch.zeros((2, 4, 512, 8), device=cuda_device)):  # q above 256
        with pytest.raises(ValueError):
            cn_tems.cn_update(bad, 0.0, 0)
    with pytest.raises(ValueError, match="n_r"):
        cn_tems.cn_update(good, 0.0, 16)                   # n_r >= q
    before = cn_tems.cn_update.launches
    cn_tems.cn_update(good, 0.0, 15)
    assert cn_tems.cn_update.launches == before + 1


# K5 with a frame list (decode_bl's retired frames): config 4's check node
# at 4096 frames with n_r 8, and the exact scan at [102, 4, 16, 8192]
K5_LIST_CASES = [("gf64_n576_k480", 4096, 8), ("gf16_n204_k102", 8192, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [7.0, None])
@pytest.mark.parametrize("share", [1.0, 0.4, 0.03, 0.0])
@pytest.mark.parametrize("code,B,n_r", K5_LIST_CASES)
def test_cn_tems_kernel_with_a_frame_list(cuda_device, code, B, n_r, share, fill):
    """The listed columns of `out` equal K5 at full width bit for bit, every
    other column is untouched (zeros where no `out` is given); one launch
    (none for an empty list), the listed frames counted."""
    g = _graph(code, cuda_device)
    U = _random_u(g, B, cuda_device)
    full = cn_tems.cn_update(U, 2.0, n_r)
    listed = torch.rand(B, generator=torch.Generator().manual_seed(5)) < share
    active = torch.nonzero(listed).flatten().to(torch.int32).to(cuda_device)
    out = None if fill is None else torch.full_like(U, fill)
    launches, frames = cn_tems.cn_update.launches, cn_tems.cn_update.frame_iterations
    got = cn_tems.cn_update(U, 2.0, n_r, active, out)
    torch.cuda.synchronize()
    assert got is out if out is not None else got.shape == U.shape
    n = active.numel()
    assert (n == B) == (share == 1.0) and (n == 0) == (share == 0.0)
    assert cn_tems.cn_update.launches == launches + (n > 0)
    assert cn_tems.cn_update.frame_iterations == frames + n
    listed = listed.to(cuda_device)
    assert torch.equal(got[..., listed], full[..., listed])
    assert bool((got[..., ~listed] == (fill or 0.0)).all())


@pytest.mark.cuda
def test_cn_tems_kernel_refuses_a_bad_frame_list(cuda_device):
    U = torch.zeros((2, 4, 16, 8), device=cuda_device)
    for bad in (torch.arange(3, device=cuda_device),                 # int64
                torch.arange(3, dtype=torch.int32),                  # on the CPU
                torch.arange(9, dtype=torch.int32, device=cuda_device)):   # more than B
        with pytest.raises(ValueError, match="active"):
            cn_tems.cn_update(U, 0.0, 0, bad, torch.empty_like(U))
    with pytest.raises(ValueError, match="out"):
        cn_tems.cn_update(U, 0.0, 0, torch.arange(3, dtype=torch.int32, device=cuda_device),
                          torch.empty((2, 4, 16, 9), device=cuda_device))


@pytest.mark.cuda
def test_tems_sweep_steps_with_retired_frames_equal_full_width(cuda_device, monkeypatch):
    """Three steps of gf64_tems_earlyterm (4 points x 1024 frames): the
    counters equal those of K5 at full width each iteration (no frame
    list), K5 launches as often, and it computes exactly the
    frame-iterations the frames needed."""
    from nbldpc_tpu_torch import sim
    from nbldpc_tpu_torch.decoders import common
    from nbldpc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nbldpc_tpu_torch.utils.config import load_config

    cfg = load_config(CODES.parent / "configs" / "gf64_tems_earlyterm.json")
    g = TannerGraph(cfg.code.load(), device=cuda_device)
    points = cfg.channel.ebn0_db
    sig = torch.tensor([ebn0_to_sigma(x, g.spec.k / g.n) for x in points],
                       dtype=torch.float32, device=cuda_device)
    step = sim.make_sim_step(g, cfg.decoder, cfg.sim.frames_per_step, len(points))

    def run():
        reset_launch_counts()
        out = [sim.step_counters(step, sim.step_generator(2**31 + 5, t, cuda_device), sig)
               for t in range(3)]
        return out, launch_counts()

    got, counts = run()
    monkeypatch.setattr(common, "active_frames", lambda done, n_active: None)
    ref, ref_counts = run()
    for a, b in zip(got, ref):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    iter_sum = sum(int(c["iter_sum"].sum()) for c in got)
    frames = len(points) * cfg.sim.frames_per_step
    assert counts["cn_tems"] == ref_counts["cn_tems"] == counts["decode_bl.loop_iterations"]
    assert counts["cn_tems.frame_iterations"] == iter_sum
    assert ref_counts["cn_tems.frame_iterations"] == frames * counts["decode_bl.loop_iterations"]
    assert iter_sum < ref_counts["cn_tems.frame_iterations"]


# The probes P1-P7 at the JAX scripts' full shapes. Each kernel repeats its
# plain version's operations in the same order, P4's IEEE divisions and
# P5's expf included (0.0 measured on the H100): exact.


def _micro_err(out, ref):
    """Max abs error, 0.0 where both are equal (inf included)."""
    differ = out != ref
    return float((out - ref).abs()[differ].max()) if bool(differ.any()) else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", micro_kernels.NAMES)
def test_micro_kernels_match_plain(cuda_device, name):
    torch.backends.cuda.matmul.allow_tf32 = False        # the plain P3 in full f32
    x, perm = micro_kernels.make_inputs(0)
    kernel, plain = micro_kernels.case(name, x.to(cuda_device), perm)
    wrapper = micro_kernels.WRAPPERS[name]
    before = wrapper.launches
    out = kernel()
    launched = micro_kernels.ITERS if name == "matmul_onehot_routing" else 1
    assert wrapper.launches == before + launched
    ref = plain()
    assert bool(torch.isfinite(out).all())
    assert _micro_err(out, ref) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("E,Q,BT", [(75, 4, 24),     # M = K = 300: ragged tiles, 10 K splits
                                    (7, 3, 5),       # K, N not multiples of 4: 4-byte copies
                                    (408, 16, 136)])  # two column tiles, the second ragged
def test_onehot_gemm_ragged_matches_plain_and_cublas(cuda_device, E, Q, BT):
    torch.backends.cuda.matmul.allow_tf32 = False        # the plain P3 in full f32
    x, perm = micro_kernels.make_inputs(3, E=E, Q=Q, BT=BT)
    x = x.to(cuda_device)
    A = micro.onehot_matrix(perm, cuda_device)
    before = micro.onehot_gemm.launches
    out = micro.onehot_gemm(A, x, 3)
    assert micro.onehot_gemm.launches == before + 3
    y, ones = x.reshape(E * Q, BT), torch.ones((E * Q, BT), device=cuda_device)
    for _ in range(3):
        y = torch.addmm(ones, A, y)
    assert _micro_err(out, micro.onehot_gemm_plain(A, x, 3)) == 0.0
    assert _micro_err(out, y.reshape(x.shape)) == 0.0


@pytest.mark.cuda
def test_onehot_gemm_rejects_what_the_split_cannot_hold(cuda_device):
    x, perm = micro_kernels.make_inputs(3, E=75, Q=4, BT=24)
    x = x.to(cuda_device)
    A = micro.onehot_matrix(perm, cuda_device)
    two_ones = A.clone()
    two_ones[0] = 1.0
    inf_x = x.clone()
    inf_x[1, 2, 3] = float("inf")
    before = micro.onehot_gemm.launches
    for bad_a, bad_x in ((two_ones, x), (A * 0.5, x), (A, inf_x), (A, x * 1e-40)):
        with pytest.raises(ValueError, match="one-hot"):
            micro.onehot_gemm(bad_a, bad_x, 1)
    assert micro.onehot_gemm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", micro_layout.NAMES)
def test_micro_layout_match_plain(cuda_device, name):
    inputs = micro_layout.make_inputs(0)
    kernel, plain, _ = micro_layout.case(name, inputs, cuda_device)
    wrapper = micro_layout.WRAPPERS[name]
    iters = 200                                          # the entry point's deeper depth
    before = wrapper.launches
    out = kernel(iters)
    assert wrapper.launches == before + 1
    ref = plain(iters)
    if name.startswith("route"):
        # past +-inf for the nodes of degree >= 3, never NaN: equal throughout
        assert bool(torch.isinf(ref).any()) and not bool(torch.isnan(out).any())
        assert torch.equal(out, ref)
    else:
        assert _micro_err(out, ref) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("BT", [1, 5, 33, 128])
@pytest.mark.parametrize("E", [4, 408])
@pytest.mark.parametrize("Q", micro.KERNEL_QS)
def test_micro_cn_iteration_edges_match_plain(cuda_device, Q, E, BT):
    """P4's four lanes a (check, frame) at every field it is built for, one
    check or 102, and frame counts that leave a block ragged."""
    x, _ = micro_kernels.make_inputs(Q + E + BT, E=E, Q=Q, BT=BT)
    x = x.to(cuda_device)
    before = micro.cn_iteration.launches
    out = micro.cn_iteration(x, 5)
    assert micro.cn_iteration.launches == before + 1
    ref = micro.cn_iteration_plain(x, 5)
    assert torch.equal(out, ref) and torch.equal(out.signbit(), ref.signbit())


@pytest.mark.cuda
@pytest.mark.parametrize("Q", micro.KERNEL_QS)
def test_micro_cn_iteration_wide_exponents_match_plain(cuda_device, Q):
    """P4's divisions over operands from 2^-70 to 2^70: inside [2^-60, 2^60]
    its shared-reciprocal sequence, outside it '/', both the IEEE quotient."""
    rng = np.random.default_rng(Q)
    x = rng.random((408, Q, 37)) * np.exp2(rng.integers(-70, 71, size=(408, Q, 37)))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    for iters in (1, 3):
        out, ref = micro.cn_iteration(x, iters), micro.cn_iteration_plain(x, iters)
        assert torch.equal(out, ref) and torch.equal(out.signbit(), ref.signbit())


def _same_bits(a, b) -> bool:
    """Equal NaN positions and, elsewhere, equal values with equal signs."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])
            and torch.equal(a[~nan].signbit(), b[~nan].signbit()))


@pytest.mark.cuda
@pytest.mark.parametrize("TB", [1, 33, 64])
@pytest.mark.parametrize("layout", ["new", "old"])
@pytest.mark.parametrize("Q", micro.KERNEL_QS)
def test_micro_rot_softmax_edges_match_plain(cuda_device, Q, layout, TB):
    """P5 with -0.0, +-inf, NaN and overflowing exps in X, an odd M, RB
    with a 0.5 entry (that column blends every iteration) and a -0.0, at
    TB = 1, 33 and 64 (in the new layout, where a check's frames lie side
    by side, a warp's columns then span every check, two checks or one,
    each check with its own roll; every roll is by selects, a value for
    each bit of r, whatever the warp shares), and 0,
    1 and 200 iterations: the plain version's bits, NaN where it has NaN."""
    rng = np.random.default_rng(Q + TB)
    DC, M = 3, 5
    shape = (Q, DC, M, TB) if layout == "new" else (Q, DC, TB, M)
    rb_shape = (micro.ROT_BITS, DC, M, 1) if layout == "new" else (micro.ROT_BITS, DC, 1, M)
    x = torch.from_numpy((rng.standard_normal(shape) * 30).astype(np.float32))
    flat = x.view(-1)
    flat[::7], flat[::11] = -0.0, 0.0
    flat[3], flat[5], flat[9] = float("inf"), -float("inf"), float("nan")
    rb = torch.from_numpy(rng.integers(0, 2, size=rb_shape).astype(np.float32))
    rb.view(-1)[2], rb.view(-1)[4] = 0.5, -0.0
    x, rb = x.to(cuda_device), rb.to(cuda_device)
    for iters in (0, 1, 200):
        before = micro.rot_softmax.launches
        out = micro.rot_softmax(x, rb, iters, layout)
        assert micro.rot_softmax.launches == before + 1
        assert _same_bits(out, micro.rot_softmax_plain(x, rb, iters))


def _route_edge_inputs(N: int, E: int, TB: int, layout: str, seed: int = 4):
    """vn with node 0 of degree 0 and node 2 of the largest degree D (9 or
    more), N not a multiple of 32; post >= 0 with a -0.0 every 7th entry (no
    NaN can arise past +-inf)."""
    rng = np.random.default_rng(seed)
    vn = rng.integers(1, N, size=E)
    vn[:9] = 2
    vn = vn.astype(np.int32)
    nbr = micro.route_tables(vn, N)
    shape = (3, N, TB) if layout == "new" else (3, TB, N)
    post = torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(np.float32))
    post.view(-1)[::7] = -0.0
    return post, torch.from_numpy(vn), nbr


@pytest.mark.cuda
@pytest.mark.parametrize("TB", [1, 31, 33])
@pytest.mark.parametrize("layout", ["new", "old"])
def test_micro_route_edges_match_plain(cuda_device, layout, TB):
    """P6/P7 with partial warps and blocks, nodes of degree 0 and D, signed
    zeros (one iteration shows whether a pad's +0 went missing) and 200
    iterations past +-inf: equal to the plain version, zeros' signs too."""
    post, vn, nbr = _route_edge_inputs(45, 100, TB, layout)
    assert int((nbr >= 0).sum(1).min()) == 0 and int((nbr >= 0).sum(1).max()) == nbr.shape[1]
    post, vn, nbr = post.to(cuda_device), vn.to(cuda_device), nbr.to(cuda_device)
    for iters in (1, 200):
        before = micro.route.launches
        out = micro.route(post, vn, nbr, iters, layout)
        assert micro.route.launches == before + 1
        ref = micro.route_plain(post, vn, nbr, iters, layout)
        assert torch.equal(out, ref) and torch.equal(out.signbit(), ref.signbit())
        assert not bool(torch.isnan(out).any())
    assert bool(torch.isinf(ref).any())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["new", "old"])
def test_micro_route_large_table_matches_plain(cuda_device, layout):
    """A larger graph than the probe's: 300 nodes in 10 slots, 1500 edges,
    a table of 65 rows."""
    post, vn, nbr = _route_edge_inputs(300, 1500, 3, layout, seed=7)
    post, vn, nbr = post.to(cuda_device), vn.to(cuda_device), nbr.to(cuda_device)
    for iters in (1, 30):
        out = micro.route(post, vn, nbr, iters, layout)
        ref = micro.route_plain(post, vn, nbr, iters, layout)
        assert torch.equal(out, ref) and torch.equal(out.signbit(), ref.signbit())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["new", "old"])
def test_micro_route_any_nbr_matches_plain(cuda_device, layout):
    """nbr need not be route_tables(vn): edges repeated within and across
    rows (six times E entries in all), pads between edges, a row of pads
    alone and a row of none."""
    rng = np.random.default_rng(11)
    N, E, D, TB = 45, 30, 9, 33
    vn = rng.integers(0, N, size=E).astype(np.int32)
    nbr = rng.integers(0, E, size=(N, D)).astype(np.int32)
    nbr[rng.random((N, D)) < 0.3] = -1
    nbr[0], nbr[1] = -1, rng.integers(0, E, size=D)
    assert int((nbr >= 0).sum()) > 6 * E
    shape = (3, N, TB) if layout == "new" else (3, TB, N)
    post = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    post.view(-1)[::5] = -0.0
    post, vn, nbr = (torch.from_numpy(a).to(cuda_device) if isinstance(a, np.ndarray)
                     else a.to(cuda_device) for a in (post, vn, nbr))
    for iters in (1, 20):
        out = micro.route(post, vn, nbr, iters, layout)
        ref = micro.route_plain(post, vn, nbr, iters, layout)
        assert torch.equal(out, ref) and torch.equal(out.signbit(), ref.signbit())


@pytest.mark.cuda
def test_micro_route_shared_memory_limit(cuda_device):
    """A graph whose one-warp block just fits the shared memory runs and
    equals the plain version (the wrapper's count agrees with the
    kernel's); one just past it is refused before any launch."""
    rng = np.random.default_rng(12)
    for N, fits in ((3500, True), (4000, False)):
        vn = rng.permutation(np.maximum(np.arange(N) - 3, 0)).astype(np.int32)
        nbr = micro.route_tables(vn, N)
        assert nbr.shape[1] == 4
        assert (micro.route_shared_bytes(N, N, 4) <= micro.MAX_SHARED_BYTES) == fits
        post = torch.from_numpy(rng.standard_normal((2, N, 3)).astype(np.float32))
        post, vn, nbr = post.to(cuda_device), torch.from_numpy(vn).to(cuda_device), \
            nbr.to(cuda_device)
        before = micro.route.launches
        if fits:
            out = micro.route(post, vn, nbr, 3)
            assert torch.equal(out, micro.route_plain(post, vn, nbr, 3))
            assert micro.route.launches == before + 1
        else:
            with pytest.raises(ValueError, match="shared memory"):
                micro.route(post, vn, nbr, 3)
            assert micro.route.launches == before


@pytest.mark.cuda
def test_micro_wrappers_reject_bad_input(cuda_device):
    x, perm = micro_kernels.make_inputs(0, E=8, Q=4, BT=4)
    x = x.to(cuda_device)
    with pytest.raises(ValueError, match="every input"):
        micro.flat_gather(x, perm, 1)                    # table left on the CPU
    with pytest.raises(ValueError):
        micro.flat_gather(x.double(), perm.to(cuda_device), 1)
    with pytest.raises(ValueError, match="q=64"):
        micro.cn_iteration(torch.zeros((8, 64, 4), device=cuda_device), 1)
    with pytest.raises(ValueError, match="shared memory"):
        big, bperm = micro_kernels.make_inputs(0, E=4096, Q=8, BT=2)
        micro.flat_gather(big.to(cuda_device), bperm.to(cuda_device), 1)
    before = micro.flat_gather.launches
    out = micro.flat_gather(x, perm.to(cuda_device), 0)
    assert micro.flat_gather.launches == before + 1 and torch.equal(out, x)


# P1 and P2 (csrc/micro_gather.cu): a block a frame, clusters of two
# frames moving the rows in and out, P2's edges paired by parity; exact.


def _gather_inputs(E, Q, BT, seed):
    """x with -0.0 every 5th entry (a copy keeps its sign: 0 iterations),
    P1's permutation and P2's tables made from it."""
    x, perm = micro_kernels.make_inputs(seed, E=E, Q=Q, BT=BT)
    x.view(-1)[::5] = -0.0
    return x, perm, micro.row_tables(perm, Q)


def _hold_gather(x, tables, iters_list=(0, 1, 200)):
    """P1 (one table) or P2 (two) against its plain version at each depth:
    one launch each, equal to the plain version, zeros' signs too."""
    wrapper, plain = ((micro.flat_gather, micro.flat_gather_plain) if len(tables) == 1
                      else (micro.row_moves, micro.row_moves_plain))
    for iters in iters_list:
        before = wrapper.launches
        out = wrapper(x, *tables, iters)
        assert wrapper.launches == before + 1
        ref = plain(x, *tables, iters)
        assert torch.equal(out, ref) and torch.equal(out.signbit(), ref.signbit())


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["p1", "p2"])
@pytest.mark.parametrize("BT", [1, 5, 33, 64, 128, 256])
@pytest.mark.parametrize("E,Q", [(13, 3), (1, 3), (1, 16), (37, 16), (408, 16)])
def test_micro_gather_edges_match_plain(cuda_device, E, Q, BT, probe):
    """P1 and P2 at frame counts that leave a cluster ragged (odd ones: a
    float a load), that fill clusters of 2 (even ones: two frames a
    float2), or more than run at once (256); R = E Q no multiple of 32
    (pad slots), an odd edge count at Q = 16 (a pair with one half empty),
    and 0, 1 and 200 iterations."""
    x, perm, (pi, perms) = _gather_inputs(E, Q, BT, E + Q + BT)
    tables = (perm,) if probe == "p1" else (pi, perms)
    _hold_gather(x.to(cuda_device), [t.to(cuda_device) for t in tables])


@pytest.mark.cuda
@pytest.mark.parametrize("E,Q", [(13, 3), (408, 16)])
def test_micro_gather_any_table_matches_plain(cuda_device, E, Q):
    """Tables that are no permutation: P1 with repeated rows and with every
    row reading row 0; P2 with pi repeating edges and perms rows that repeat
    slots."""
    rng = np.random.default_rng(E * Q)
    x, _, _ = _gather_inputs(E, Q, 37, 3)
    x = x.to(cuda_device)
    R = E * Q
    for perm in (rng.integers(0, R, R), np.zeros(R)):
        _hold_gather(x, [torch.from_numpy(perm.astype(np.int32)).to(cuda_device)], (1, 20))
    pi = rng.integers(0, 3, E).astype(np.int32)
    perms = rng.integers(0, Q, (E, Q)).astype(np.int32)
    assert len(set(pi)) < E and (perms[:, :1] == perms).sum() > E
    _hold_gather(x, [torch.from_numpy(t).to(cuda_device) for t in (pi, perms)], (1, 20))


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["p1", "p2"])
def test_micro_gather_shared_memory_limit(cuda_device, probe):
    """The largest frame whose block fits the shared memory runs and equals
    the plain version (the wrapper's count agrees with the kernel's); one
    row (P1) or edge (P2) more is refused before any launch."""
    Q = 1 if probe == "p1" else 16
    size = (lambda E: micro.gather_shared_bytes(E)) if probe == "p1" else \
        (lambda E: micro.gather_shared_bytes(E * 16, E))
    E = 1
    while size(E + 1) <= micro.MAX_SHARED_BYTES:
        E += 1
    wrapper = micro.flat_gather if probe == "p1" else micro.row_moves
    for E, fits in ((E, True), (E + 1, False)):
        x, perm, (pi, perms) = _gather_inputs(E, Q, 3, 5)
        tables = [t.to(cuda_device) for t in ((perm,) if probe == "p1" else (pi, perms))]
        x = x.to(cuda_device)
        if fits:
            _hold_gather(x, tables, (3,))
        else:
            before = wrapper.launches
            with pytest.raises(ValueError, match="shared memory"):
                wrapper(x, *tables, 3)
            assert wrapper.launches == before


# bf16 message storage (mm_precision="bf16"): each kernel's bf16 build
# against the bf16 plain version, at the thresholds of the f32 builds;
# (kernel, code, Eb/N0): K0 with two threads a check (the flagship, GF(4))
# and a thread a check (a random GF(32) code, a dv = 3 GF(4) code, whose
# bf16 build forms its spectra again), K0-cl's cluster kernel on the codes
# a cluster holds (in bf16 config 5's on 4 blocks, GF(64) on 2), its
# scratch kernel on codes no bf16 cluster holds (GF(256), N = 1200; GF(64)
# from about N = 3600) and, called directly, on the GF(64) N = 1800 code,
# which a bf16 cluster of 8 holds
BF16_SCRATCH_CODES = {"gf64_n3600": (64, 3600, 1200)}
BF16_CASES = [("k0", "gf16_n204_k102_c8", 1.5), ("k0", "gf4_n96_k48", 1.5),
              ("k0", "gf32_random", 2.0), ("k0", "dv3_gf4", 1.5),
              ("cluster", "gf256_n255_k175", 2.0), ("cluster", "gf64_n576_k480", 3.0),
              ("scratch", "gf256_n1200", 2.5), ("scratch", "gf64_n1800", 2.5),
              ("scratch", "gf64_n3600", 2.5)]
BF16_KERNELS = {"k0": qr.resident_decode, "cluster": qr.resident_decode_cl,
                "scratch": qr.resident_decode_cl_scratch}


def _bf16_graph(code, device):
    if code in RANDOM_CODES:
        return _random_graph(code, device)
    if code in BF16_SCRATCH_CODES:
        return TannerGraph(random_regular_spec(*BF16_SCRATCH_CODES[code], seed=3), device=device)
    if code == "gf32_random":
        return TannerGraph(random_regular_spec(32, 192, 96, 11), device=device)
    if code in K0_CODES:
        return TannerGraph(K0_CODES[code](), device=device)
    return _graph(code, device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RESIDENT_MODES)
@pytest.mark.parametrize("kernel,code,ebn0", BF16_CASES)
def test_resident_bf16_kernels_match_plain(cuda_device, kernel, code, ebn0, mode):
    g = _bf16_graph(code, cuda_device)
    plan = qr.ResidentQSPA(g, 1, mm_precision="bf16").cluster_plan
    if kernel == "cluster":
        assert plan.size == (4 if g.q == 256 else 2)
    _hold_resident(g, _zero_cw_llrs(g, 300, ebn0, cuda_device), mode, BF16_KERNELS[kernel],
                   direct=kernel == "scratch" and plan is not None, precision="bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RESIDENT_MODES)
@pytest.mark.parametrize("kernel,code,ebn0", [c for c in BF16_CASES if c[0] != "k0"])
def test_resident_cl_bf16_frames_in_a_row_equal_frames_alone(cuda_device, kernel, code, ebn0,
                                                             mode):
    """The bf16 builds of K0-cl's two kernels: every cluster decodes 16
    frames in a row, equal bit for bit to each frame decoded alone."""
    g = _bf16_graph(code, cuda_device)
    dec = qr.ResidentQSPA(g, *mode, mm_precision="bf16")
    if kernel == "cluster":
        fn, at_once = qr.resident_decode_cl, qr.cluster_occupancy(dec, cuda_device)
    else:
        fn, at_once = qr.resident_decode_cl_scratch, qr.scratch_occupancy(dec, cuda_device)
    counter = fn.launches_bf16
    llr = _zero_cw_llrs(g, 16 * at_once, ebn0, cuda_device)
    together = fn(dec, llr)
    alone = [fn(dec, llr[b:b + 1].contiguous()) for b in range(llr.shape[0])]
    assert fn.launches_bf16 == counter + 1 + llr.shape[0]
    for got, want in zip(together, (torch.cat(parts) for parts in zip(*alone))):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RESIDENT_MODES)
@pytest.mark.parametrize("code", ["gf256_n255_k175", "gf64_n576_k480"])
def test_resident_cl_bf16_two_kernels_agree_bit_for_bit(cuda_device, code, mode):
    """The bf16 builds of the cluster and scratch kernels, on codes a
    cluster holds: the same association order, equal outputs."""
    g = _graph(code, cuda_device)
    dec = qr.ResidentQSPA(g, *mode, mm_precision="bf16")
    llr = _zero_cw_llrs(g, 300, 2.5, cuda_device)
    for a, b in zip(qr.resident_decode_cl(dec, llr), qr.resident_decode_cl_scratch(dec, llr)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_resident_bf16_dispatch_on_card(cuda_device):
    """qspa.decode with mm_precision="bf16" launches the bf16 builds only:
    K0 at q <= 32, K0-cl's cluster kernel, its scratch kernel."""
    from nbldpc_tpu_torch.decoders import qspa

    for code, kernel in (("gf16_n204_k102_c8", qr.resident_decode),
                         ("gf256_n255_k175", qr.resident_decode_cl),
                         ("gf256_n1200", qr.resident_decode_cl_scratch)):
        g = _bf16_graph(code, cuda_device)
        llr = _zero_cw_llrs(g, 64, 2.5, cuda_device)
        before = [(c.launches, c.launches_bf16) for c in RESIDENT_COUNTERS]
        qspa.decode(g, llr, 5, True, cn_impl="auto", mm_precision="bf16")
        assert [(c.launches, c.launches_bf16) for c in RESIDENT_COUNTERS] == [
            (a, b + (c is kernel)) for c, (a, b) in zip(RESIDENT_COUNTERS, before)]


# Writes outside an output: each kernel below writes into the middle of a
# buffer whose ends hold a sentinel, which must survive.

_SENTINEL = 1234.5
_GUARD = 1 << 18


def _guarded_out(shape, device):
    n = math.prod(shape)
    buf = torch.full((n + 2 * _GUARD,), _SENTINEL, device=device)
    return buf, buf[_GUARD:_GUARD + n].view(shape)


def _guards_intact(buf) -> bool:
    torch.cuda.synchronize()
    return bool((buf[:_GUARD] == _SENTINEL).all() and (buf[-_GUARD:] == _SENTINEL).all())


@pytest.mark.cuda
@pytest.mark.parametrize("code,B", [("gf16_n204_k102_c8", 8192), ("gf64_n576_k480", 2048),
                                    ("gf256_n255_k175", 1024), ("gf256_n255_k175", 4096),
                                    ("gf256_n255_k175", 37)])
def test_cn_kernel_writes_only_its_output(cuda_device, code, B):
    """K1 at chip_smoke.py phase 3's shapes (and a ragged batch) writes its
    output and nothing on either side of it."""
    from nbldpc_tpu_torch.kernels import _build

    U = _random_u(_graph(code, cuda_device), B, cuda_device)
    buf, out = _guarded_out(U.shape, cuda_device)
    _build.check(_build.library().cn_qspa_update(U.data_ptr(), out.data_ptr(), *U.shape,
                                                 _build.stream_ptr(cuda_device)),
                 "cn_qspa_update")
    assert _guards_intact(buf)
    assert torch.equal(out, cn_qspa.cn_update(U))


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["gf256_n1200", "gf64_n1800"])
def test_resident_cl_scratch_writes_only_its_outputs(cuda_device, code):
    """K0-cl's scratch kernel writes its hard decisions, done flags and
    iteration counts and its slices of the scratch, and nothing on either
    side of any of them; its outputs equal the wrapper's."""
    from nbldpc_tpu_torch.kernels import _build

    g, B = _random_graph(code, cuda_device), 37
    dec = qr.ResidentQSPA(g, 20, False, False)
    llr = _zero_cw_llrs(g, B, 2.5, cuda_device)
    plan, c = qr.scratch_layout(dec)
    grid = min(B, qr.scratch_occupancy(dec, cuda_device))
    bufs, (hard, iters, scratch) = zip(*(_guarded_out(shape, cuda_device) for shape in (
        (B, g.n), (B,), (grid * plan.slice_elems,))))
    hard, iters = hard.view(torch.int32), iters.view(torch.int32)
    dbuf = torch.full((B + 2 * _GUARD,), 0xAB, dtype=torch.uint8, device=cuda_device)
    done = dbuf[_GUARD:_GUARD + B]
    _build.check(_build.library().qspa_resident_cl_decode(
        llr.data_ptr(), hard.data_ptr(), done.data_ptr(), iters.data_ptr(), scratch.data_ptr(),
        grid, B, g.n, g.m, g.dc_max, g.dv_max, g.q, plan.size, plan.rows, plan.checks,
        plan.round_checks, plan.warps, plan.smem_bytes, int(plan.post_shared),
        c["edge_info"].data_ptr(), c["row_src"].data_ptr(), c["row_var"].data_ptr(),
        dec.n2e.data_ptr(), c["gf_log"].data_ptr(), c["gf_exp"].data_ptr(),
        20, 0, 0, _build.stream_ptr(cuda_device)), "qspa_resident_cl_decode")
    assert all(_guards_intact(b) for b in bufs)
    assert bool((dbuf[:_GUARD] == 0xAB).all() and (dbuf[-_GUARD:] == 0xAB).all())
    want = qr.resident_decode_cl_scratch(dec, llr)
    assert torch.equal(hard, want[0]) and torch.equal(done.bool(), want[1])
    assert torch.equal(iters, want[2])


def _cluster_writes_only(device, g, precision):
    """The cluster kernel called directly on 37 frames at 2.5 dB, 20
    iterations at the fixed budget: its outputs, and in place the prior
    scratch, each between guards; the guards intact, the outputs the
    wrapper's, the grid's blocks and frame slots the library's."""
    from nbldpc_tpu_torch.kernels import _build

    B = 37
    dec = qr.ResidentQSPA(g, 20, False, False, mm_precision=precision)
    plan, c = dec.cluster_plan, dec.cluster
    clusters = min(B, qr.cluster_occupancy(dec, device))
    llr = _zero_cw_llrs(g, B, 2.5, device)
    shapes = [(B, g.n), (B,)]
    if plan.in_place:
        shapes.append((clusters * plan.size * plan.rows * g.q,))
    bufs, outs = zip(*(_guarded_out(shape, device) for shape in shapes))
    hard, iters = outs[0].view(torch.int32), outs[1].view(torch.int32)
    prior = outs[2].data_ptr() if plan.in_place else None
    dbuf = torch.full((B + 2 * _GUARD,), 0xAB, dtype=torch.uint8, device=device)
    done = dbuf[_GUARD:_GUARD + B]
    grid, slots = ctypes.c_int(0), ctypes.c_int(0)
    name = "qspa_cluster_decode" + ("" if precision == "f32" else "_bf16")
    _build.check(getattr(_build.library(), name)(
        llr.data_ptr(), hard.data_ptr(), done.data_ptr(), iters.data_ptr(), prior,
        0 if prior is None else clusters, B, g.n, g.m, g.dc_max, g.dv_max, g.q,
        *qr._plan_cluster_args(plan), c["edge_info"].data_ptr(), c["row_src"].data_ptr(),
        c["row_var"].data_ptr(), dec.n2e.data_ptr(), c["gf_log"].data_ptr(),
        c["gf_exp"].data_ptr(), 20, 0, 0, ctypes.byref(grid), ctypes.byref(slots),
        _build.stream_ptr(device)), name)
    assert (grid.value, slots.value) == (clusters * plan.size, clusters)
    assert all(_guards_intact(b) for b in bufs)
    assert bool((dbuf[:_GUARD] == 0xAB).all() and (dbuf[-_GUARD:] == 0xAB).all())
    want = qr.resident_decode_cl(dec, llr)
    assert torch.equal(hard, want[0]) and torch.equal(done.bool(), want[1])
    assert torch.equal(iters, want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["gf256_n255_k175", "gf64_n576_k480"])
def test_resident_cl_cluster_bf16_writes_only_its_outputs(cuda_device, code):
    """The cluster kernel's bf16 build writes its hard decisions, done
    flags and iteration counts, and nothing on either side of them."""
    _cluster_writes_only(cuda_device, _graph(code, cuda_device), "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["gf256_n255_k175", "gf64_n576_k480", "gf64_n1800"])
def test_resident_cl_cluster_writes_only_its_outputs(cuda_device, code):
    """The f32 build in each layout (config 5's code in place on 4 blocks;
    GF(64) (576,480) buffered; GF(64) N = 1800 in place on 8) writes its
    outputs and its prior scratch, and nothing on either side of them."""
    g = _random_graph(code, cuda_device) if code in RANDOM_CODES else _graph(code, cuda_device)
    _cluster_writes_only(cuda_device, g, "f32")


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["gf256_n1200", "gf64_n1800"])
def test_resident_cl_scratch_bf16_writes_only_its_outputs(cuda_device, code):
    """The scratch kernel's bf16 build writes its outputs and its bf16
    slices of the scratch, and nothing on either side of any of them."""
    from nbldpc_tpu_torch.kernels import _build

    g, B = _random_graph(code, cuda_device), 37
    dec = qr.ResidentQSPA(g, 20, False, False, mm_precision="bf16")
    llr = _zero_cw_llrs(g, B, 2.5, cuda_device)
    plan, c = qr.scratch_layout(dec)
    grid = min(B, qr.scratch_occupancy(dec, cuda_device))
    bufs, (hard, iters) = zip(*(_guarded_out(shape, cuda_device) for shape in ((B, g.n), (B,))))
    hard, iters = hard.view(torch.int32), iters.view(torch.int32)
    n = grid * plan.slice_elems                   # bf16: sentinel words of 0x1234
    sbuf = torch.full((n + 2 * _GUARD,), 0x1234, dtype=torch.int16, device=cuda_device)
    dbuf = torch.full((B + 2 * _GUARD,), 0xAB, dtype=torch.uint8, device=cuda_device)
    done = dbuf[_GUARD:_GUARD + B]
    _build.check(_build.library().qspa_resident_cl_decode_bf16(
        llr.data_ptr(), hard.data_ptr(), done.data_ptr(), iters.data_ptr(),
        sbuf[_GUARD:_GUARD + n].data_ptr(), grid, B, g.n, g.m, g.dc_max, g.dv_max, g.q,
        plan.size, plan.rows, plan.checks, plan.round_checks, plan.warps, plan.smem_bytes,
        int(plan.post_shared), c["edge_info"].data_ptr(), c["row_src"].data_ptr(),
        c["row_var"].data_ptr(), dec.n2e.data_ptr(), c["gf_log"].data_ptr(),
        c["gf_exp"].data_ptr(), 20, 0, 0, _build.stream_ptr(cuda_device)),
        "qspa_resident_cl_decode_bf16")
    assert all(_guards_intact(b) for b in bufs)
    assert bool((sbuf[:_GUARD] == 0x1234).all() and (sbuf[-_GUARD:] == 0x1234).all())
    assert bool((dbuf[:_GUARD] == 0xAB).all() and (dbuf[-_GUARD:] == 0xAB).all())
    want = qr.resident_decode_cl_scratch(dec, llr)
    assert torch.equal(hard, want[0]) and torch.equal(done.bool(), want[1])
    assert torch.equal(iters, want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["new", "old"])
def test_micro_rot_softmax_writes_only_its_output(cuda_device, layout):
    """P5 at micro_layout's shapes writes its output and nothing on either
    side of it."""
    from nbldpc_tpu_torch.kernels import _build

    inp = micro_layout.make_inputs(0)
    x, rb = inp[f"x_{layout}"].to(cuda_device), inp[f"rb_{layout}"].to(cuda_device)
    Q, DC = x.shape[:2]
    (M, TB), (sm, sb) = ((x.shape[2:], x.stride()[2:]) if layout == "new"
                         else (x.shape[:1:-1], x.stride()[:1:-1]))
    for iters in (0, 50):
        buf, out = _guarded_out(x.shape, cuda_device)
        _build.check(_build.library().micro_rot_softmax(
            x.data_ptr(), rb.data_ptr(), out.data_ptr(), Q, DC, M, TB, x.stride(0),
            x.stride(1), sm, sb, iters, _build.stream_ptr(cuda_device)), "micro_rot_softmax")
        assert _guards_intact(buf)
        assert torch.equal(out, micro.rot_softmax_plain(x, rb, iters))


@pytest.mark.cuda
@pytest.mark.parametrize("E,Q,BT", [(408, 16, 128), (13, 3, 5), (37, 16, 33)])
def test_micro_gather_writes_only_its_output(cuda_device, E, Q, BT):
    """P1 and P2 write their output and nothing on either side of it."""
    from nbldpc_tpu_torch.kernels import _build

    x, perm, (pi, perms) = _gather_inputs(E, Q, BT, 9)
    x, perm, pi, perms = (t.to(cuda_device) for t in (x, perm, pi, perms))
    lib, stream = _build.library(), _build.stream_ptr(cuda_device)
    for iters in (0, 20):
        buf, out = _guarded_out(x.shape, cuda_device)
        _build.check(lib.micro_flat_gather(x.data_ptr(), out.data_ptr(), perm.data_ptr(),
                                           E * Q, BT, iters, stream), "micro_flat_gather")
        assert _guards_intact(buf) and torch.equal(out, micro.flat_gather_plain(x, perm, iters))
        buf, out = _guarded_out(x.shape, cuda_device)
        _build.check(lib.micro_row_moves(x.data_ptr(), out.data_ptr(), pi.data_ptr(),
                                         perms.data_ptr(), E, Q, BT, iters, stream),
                     "micro_row_moves")
        assert _guards_intact(buf)
        assert torch.equal(out, micro.row_moves_plain(x, pi, perms, iters))


def _one_rank_nccl_group(path):
    import torch.distributed as tdist

    tdist.init_process_group("nccl", init_method=f"file://{path}/store", rank=0,
                             world_size=1)


@pytest.mark.cuda
def test_one_rank_nccl_sweep_equals_no_group(cuda_device, tmp_path):
    """The data-parallel sweep on a one-rank NCCL group (its counters
    all-reduced on the card) equals the sweep with no group, through K0."""
    import torch.distributed as tdist

    from nbldpc_tpu_torch import sim
    from nbldpc_tpu_torch.parallel import mesh
    from nbldpc_tpu_torch.utils import config as tcfg

    cfg = tcfg.RunConfig(
        code=tcfg.CodeConfig(name="gf16_n204_k102_c8"),
        decoder=tcfg.DecoderConfig(kind="qspa", max_iters=50),
        channel=tcfg.ChannelConfig(ebn0_db=(1.5, 2.0)),
        sim=tcfg.SimConfig(frames_per_step=2048, max_frames=4096, max_frame_errors=10**6,
                           seed=3))
    base = sim.run_sweep(cfg, cuda_device)
    _one_rank_nccl_group(tmp_path)
    try:
        before = qr.resident_decode.launches
        got = sim.run_sweep(cfg, cuda_device, layout=mesh.make_layout())
        assert qr.resident_decode.launches == before + got.steps
    finally:
        tdist.destroy_process_group()
    assert got.counters.asdict() == base.counters.asdict()
    assert got.counters.frames.tolist() == [4096, 4096]


@pytest.mark.cuda
@pytest.mark.parametrize("early", [True, False])
def test_sharded_decode_one_rank_k1_equals_decode_bl(cuda_device, tmp_path, early):
    """The edge-sharded decode with K1 on a one-rank NCCL group equals
    decode_bl through K1 (qspa.decode, cn_impl="kernel"), exactly."""
    import torch.distributed as tdist

    from nbldpc_tpu_torch.decoders import qspa, sharded

    g = _graph("gf256_n255_k175", cuda_device)
    llr = _zero_cw_llrs(g, 64, 2.5, cuda_device)
    ref = qspa.decode(g, llr, 20, early, cn_impl="kernel")
    _one_rank_nccl_group(tmp_path)
    try:
        before = cn_qspa.cn_update.launches
        got = sharded.decode_edge_sharded(g, llr, qspa.qspa_cn_update_bl_kernel, 20, early)
        assert cn_qspa.cn_update.launches > before
    finally:
        tdist.destroy_process_group()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# one run_all configuration of each kernel family, and the kernel it runs
RUN_ALL_FAMILIES = [("gf4_qspa_20it", "qspa_resident"),
                    ("gf16_qspa_50it_bf16", "qspa_resident_bf16"),
                    ("gf256_qspa_10it_4snr", "qspa_resident_cl"),
                    ("gf16_ems_nm16_20it", "ems_resident"),
                    ("gf256_ems_nm16_10it_4snr", "cn_ems"),
                    ("gf256_ems_bubble_10it", "cn_ems_bubble"),
                    ("gf64_tems_nr8_20it", "cn_tems")]


@pytest.mark.cuda
@pytest.mark.parametrize("config,kernel", RUN_ALL_FAMILIES)
def test_run_all_row_launches_its_kernel(cuda_device, tmp_path, config, kernel):
    """run_all --quick on one configuration: its kernel launches once a step
    (a whole-decode kernel) or once an iteration (a check-node kernel), and
    nothing else runs, no plain version in particular."""
    assert run_all.main(["--quick", "--only", config, "--out", str(tmp_path)]) == 0
    (rec,) = json.loads((tmp_path / "run_all_h100.json").read_text())
    per_step = 1 if "resident" in kernel else rec["iters"]
    # a check-node kernel runs inside decode_bl, between the two routing
    # kernels, after decode_bl's entry; every step runs the channel and the
    # counters once
    want = {name: rec["steps"] * per_step
            for name in ([kernel] if "resident" in kernel else [kernel, "route_down", "route_up"])}
    want.update({name: rec["steps"] for name in (
        ["channel_llr", "count_errors"] + ([] if "resident" in kernel else ["prior_bl"]))})
    if "resident" not in kernel:
        # decode_bl's loop counters; K5 computes every frame (a fixed budget)
        frames = rec["batch"] * rec["n_snr"]
        want.update({"decode_bl.loop_iterations": rec["steps"] * per_step,
                     "decode_bl.frame_iterations": rec["steps"] * per_step * frames})
        if kernel == "cn_tems":
            want["cn_tems.frame_iterations"] = rec["steps"] * per_step * frames
    if kernel == "qspa_resident_cl":
        # the persistent grid of each launch: min(frames, occupancy) clusters
        dec = qr.ResidentQSPA(_graph(rec["code"], cuda_device), rec["iters"])
        clusters = min(rec["batch"] * rec["n_snr"], qr.cluster_occupancy(dec, cuda_device))
        want["qspa_cluster.grid_blocks"] = rec["steps"] * dec.cluster_plan.size * clusters
        want["qspa_cluster.frame_slots"] = rec["steps"] * clusters
    assert {k: v for k, v in rec["launches"].items() if v} == want
    assert rec["config"] == config and rec["batch"] == 32 and rec["timing"] == "cuda_events"
    assert rec["device"] == torch.cuda.get_device_name(cuda_device)
    assert rec["mm_precision_applied"] and rec["ms_per_step"] > 0


# --- decode_bl's routing kernels (csrc/route.cu) -------------------------------

# code -> a function making its spec: config 5's and config 4's codes, the irregular codes
# with CN and VN pad slots at GF(16) and GF(64), dv = 3 at GF(4), and
# variables of degree up to 10
ROUTE_CODES = {**{name: lambda name=name: CodeConfig(path=str(CODES / f"{name}.alist")).load()
                  for name in ("gf256_n255_k175", "gf64_n576_k480")},
               "irregular_gf16": lambda: _irregular_spec(16, 4),
               "irregular_gf64": lambda: _irregular_spec(64, 6),
               "dv3_gf4": lambda: random_regular_spec(4, 96, 48, 5, dv=3),
               # variables of degree 2 to 10: torch's four-accumulator sum
               "dense_gf16": lambda: _irregular_spec(16, 9, n=12, m=20)}


def _route_inputs(g, B, device, seed=3, levels=0):
    """(posterior [N, q, B], Cv [N, dv, q, B] with zeros on pad VN slots,
    Chat [M, dc, q, B], llr [N, q, B]) from a numpy seed: normal draws, or
    with `levels` > 0 multiples of 1.5 from that many values (ties in every
    max)."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        v = rng.integers(0, levels, shape) * 1.5 if levels else rng.standard_normal(shape) * 3.0
        return torch.from_numpy(v.astype(np.float32)).to(device)

    Cv = torch.where(g.vn_mask[:, :, None, None], draw(g.n, g.dv_max, g.q, B), 0.0)
    return (draw(g.n, g.q, B), Cv.contiguous(), draw(g.m, g.dc_max, g.q, B),
            draw(g.n, g.q, B))


def _hold_route(g, B, device, levels=0):
    """Both routing kernels against their plain versions on the same inputs:
    equal (max abs error 0) and one launch each (none at B = 0)."""
    post, Cv, Chat, llr = _route_inputs(g, B, device, levels=levels)
    before = (route.route_down.launches, route.route_up.launches)
    U = route.route_down(post, Cv, g)
    Cv_k, post_k = route.route_up(Chat, llr, g)
    assert (route.route_down.launches, route.route_up.launches) == tuple(
        n + (B > 0) for n in before)
    U_p = route.route_down_plain(post, Cv, g)
    Cv_p, post_p = route.route_up_plain(Chat, llr, g)
    torch.cuda.synchronize()
    assert U.shape == (g.m, g.dc_max, g.q, B) and Cv_k.shape == Cv.shape
    assert post_k.shape == (g.n, g.q, B)
    for got, want in ((U, U_p), (Cv_k, Cv_p), (post_k, post_p)):
        assert torch.equal(got, want)
        assert got.numel() == 0 or float((got - want).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [0, 1, 37, 128])
@pytest.mark.parametrize("code", list(ROUTE_CODES))
def test_route_kernels_match_plain(cuda_device, code, B):
    g = TannerGraph(ROUTE_CODES[code](), device=cuda_device)
    _hold_route(g, B, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 8, 32, 128])
def test_route_kernels_match_plain_every_field(cuda_device, q):
    """The fields ROUTE_CODES leaves out, on random dv = 2 codes."""
    g = TannerGraph(random_regular_spec(q, 60, 30, q), device=cuda_device)
    _hold_route(g, 37, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("code,B,levels", [("gf256_n255_k175", 4096, 0),     # config 5's step
                                           ("gf64_n576_k480", 1024, 0),      # config 4's step
                                           ("gf256_n255_k175", 37, 3),       # ties in every max
                                           ("irregular_gf64", 37, 3)])
def test_route_kernels_match_plain_at_step_shapes(cuda_device, code, B, levels):
    g = TannerGraph(ROUTE_CODES[code](), device=cuda_device)
    _hold_route(g, B, cuda_device, levels)


# (label, code, the CN kernel as decode_bl calls it, Eb/N0): K1, K2, K2b and
# K5 on their paths' codes, K1 and K5 also on the code with CN and VN pads
ROUTE_DECODES = [
    ("k1", "gf256_n255_k175", lambda U, _g, _a, _o: cn_qspa.cn_update(U), 2.5),
    ("k1", "irregular_gf16", lambda U, _g, _a, _o: cn_qspa.cn_update(U), 3.0),
    ("k2", "gf256_n255_k175", lambda U, _g, _a, _o: cn_ems.cn_update(U, 16, 0.1), 2.5),
    ("k2", "gf64_n576_k480", lambda U, _g, _a, _o: cn_ems.cn_update(U, 8, 0.1), 3.0),
    ("k2b", "gf256_n255_k175", lambda U, _g, _a, _o: cn_ems.cn_update_bubble(U, 16, 0.0),
     2.5),
    ("k5", "gf64_n576_k480", lambda U, _g, a, o: cn_tems.cn_update(U, 2.0, 8, a, o), 3.5),
    ("k5", "irregular_gf16", lambda U, _g, a, o: cn_tems.cn_update(U, 2.0, 0, a, o), 3.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(20, True, True), (20, False, False)])
@pytest.mark.parametrize("label,code,cn,ebn0", ROUTE_DECODES,
                         ids=[f"{c[0]}-{c[1]}" for c in ROUTE_DECODES])
def test_decode_bl_route_kernels_equal_plain_routing(cuda_device, label, code, cn, ebn0, mode):
    """decode_bl through the routing kernels against decode_bl through their
    plain versions, the same CN kernel in both: hard, done and iters equal,
    in the early-termination and fixed-budget modes."""
    from nbldpc_tpu_torch.decoders import common

    iters, early, stats = mode
    g = TannerGraph(ROUTE_CODES[code](), device=cuda_device)
    llr = _zero_cw_llrs(g, 300, ebn0, cuda_device)
    before = route.route_down.launches
    got = common.decode_bl(g, llr, cn, iters, early, stats, route="kernel")
    ran = route.route_down.launches - before
    calls = route.route_down_plain.calls
    ref = common.decode_bl(g, llr, cn, iters, early, stats, route="torch")
    assert route.route_down_plain.calls - calls == ran >= 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_route_wrappers_reject_bad_input(cuda_device):
    g = _graph("gf16_n204_k102", cuda_device)
    post, Cv, Chat, llr = _route_inputs(g, 8, cuda_device)
    with pytest.raises(ValueError):
        route.route_down(post.double(), Cv, g)
    with pytest.raises(ValueError):
        route.route_down(post, Cv.double(), g)
    with pytest.raises(ValueError):
        route.route_up(Chat, llr.double(), g)
    # non-contiguous, wrong shape, off the tables' device
    with pytest.raises(ValueError):
        route.route_down(post.transpose(0, 1).contiguous().transpose(0, 1), Cv, g)
    with pytest.raises(ValueError):
        route.route_up(Chat.transpose(1, 2).contiguous().transpose(1, 2), llr, g)
    with pytest.raises(ValueError):
        route.route_down(post[:, :, :4], Cv, g)
    with pytest.raises(ValueError):
        route.route_up(Chat, llr.cpu(), g)
    before = (route.route_down.launches, route.route_up.launches)
    route.route_down(post, Cv, g)
    route.route_up(Chat, llr, g)
    assert (route.route_down.launches, route.route_up.launches) == (before[0] + 1, before[1] + 1)


# --- the sim step around the decode (csrc/sim_step.cu) -------------------------

SIM_STEP_N = 12          # symbols a frame in the kernel-level tests


def _bits_equal(a, b) -> bool:
    """The same float32 bit patterns (signed zeros included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _sim_step_inputs(q, S, B, device, seed=11):
    """(noise [S, B, N, p], sig [S], codewords [S, B, N] int32) from a numpy seed."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((S, B, SIM_STEP_N, q.bit_length() - 1)).astype(np.float32)
    sig = rng.uniform(0.4, 1.2, S).astype(np.float32)
    cw = rng.integers(0, q, (S, B, SIM_STEP_N)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (noise, sig, cw))


def _counters_equal(got: dict, want: dict) -> bool:
    return list(got) == list(want) and all(
        g.dtype == torch.int64 and torch.equal(g, w) for g, w in zip(got.values(),
                                                                  want.values()))


def _hold_sim_step(q, S, B, device, codeword, noise=None):
    """The three kernels against their plain versions on the same inputs,
    chained as a step chains them (the channel's LLRs into prior_bl, its
    decision into count_errors with random iterations and done flags):
    every output equal, one launch each (none at B = 0)."""
    base, sig, cw = _sim_step_inputs(q, S, B, device)
    noise = base if noise is None else noise
    cw = cw if codeword else None
    counts = [fn.launches for fn in (sim_step.channel_llr, sim_step.prior_bl,
                                     sim_step.count_errors)]
    llr = sim_step.channel_llr(noise, sig, q, cw)
    prior, hard0 = sim_step.prior_bl(llr.reshape(S * B, SIM_STEP_N, q))
    hard = hard0.T.contiguous()
    gen = torch.Generator(device=device).manual_seed(3)
    iters = torch.randint(0, 21, (S * B,), generator=gen, device=device, dtype=torch.int32)
    done = torch.rand(S * B, generator=gen, device=device) < 0.5
    out = sim_step.count_errors(hard, cw, iters, done, S, B, q.bit_length() - 1)
    assert [fn.launches for fn in (sim_step.channel_llr, sim_step.prior_bl,
                                   sim_step.count_errors)] == [c + (B > 0) for c in counts]
    llr_p = sim_step.channel_llr_plain(noise, sig, q, cw)
    prior_p, hard_p = sim_step.prior_bl_plain(llr_p.reshape(S * B, SIM_STEP_N, q))
    out_p = sim_step.count_errors_plain(hard, cw, iters, done, S, B, q.bit_length() - 1)
    torch.cuda.synchronize()
    assert _bits_equal(llr, llr_p) and _bits_equal(prior, prior_p)
    assert hard0.dtype == torch.int32 and torch.equal(hard0, hard_p)
    assert _counters_equal(out, out_p)
    assert out["frames"].tolist() == [B] * S


@pytest.mark.cuda
@pytest.mark.parametrize("codeword", [False, True])
@pytest.mark.parametrize("B", [0, 1, 7, 4096])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("q", [2, 4, 8, 16, 32, 64, 128, 256])
def test_sim_step_kernels_match_plain(cuda_device, q, S, B, codeword):
    _hold_sim_step(q, S, B, cuda_device, codeword)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [4, 64, 256])
def test_sim_step_kernels_match_plain_on_a_layout_block(cuda_device, q):
    """A layout's block of the step's noise (slots 1-2, frames 3-9 of
    [4, 16]) is not contiguous: the wrapper refuses it, and takes it as
    make_sim_step passes it, contiguous."""
    noise, sig, _ = _sim_step_inputs(q, 4, 16, cuda_device)
    view = noise[1:3, 3:10]
    assert not view.is_contiguous()
    with pytest.raises(ValueError):
        sim_step.channel_llr(view, sig[1:3], q)
    got = sim_step.channel_llr(view.contiguous(), sig[1:3], q)
    assert _bits_equal(got, sim_step.channel_llr_plain(view, sig[1:3], q))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 16, 64, 256])
def test_prior_bl_ties_and_special_values_match_plain(cuda_device, q):
    """Rows of equal values, integer values (ties in every max), signed
    zeros, infinities and NaNs: prior and decision equal to the plain
    version's (torch.amax and torch.argmax on the card)."""
    rng = np.random.default_rng(q)
    B, N = 70, 9
    llr = np.round(rng.standard_normal((B, N, q)) * 2.0).astype(np.float32)
    llr[0] = 1.5
    llr[1] = -0.0
    llr[2, :, 0] = np.inf
    llr[3, :, q // 2] = np.inf
    llr[3, :, q - 1] = np.inf
    llr[4] = -np.inf
    llr[5, :, q - 1] = np.nan
    llr[6, :, 1] = np.nan
    llr[6, :, 0] = np.nan
    x = torch.from_numpy(llr).to(cuda_device)
    before = sim_step.prior_bl.launches
    prior, hard = sim_step.prior_bl(x)
    assert sim_step.prior_bl.launches == before + 1
    prior_p, hard_p = sim_step.prior_bl_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(hard, hard_p)
    assert torch.equal(torch.isnan(prior), torch.isnan(prior_p))
    finite = ~torch.isnan(prior_p)
    assert torch.equal(prior[finite], prior_p[finite])


@pytest.mark.cuda
def test_sim_step_wrappers_reject_bad_input(cuda_device):
    q, S, B = 16, 2, 5
    noise, sig, cw = _sim_step_inputs(q, S, B, cuda_device)
    llr = sim_step.channel_llr(noise, sig, q, cw)
    flat = llr.reshape(S * B, SIM_STEP_N, q)
    hard = torch.zeros((S * B, SIM_STEP_N), dtype=torch.int32, device=cuda_device)
    iters = torch.zeros(S * B, dtype=torch.int32, device=cuda_device)
    done = torch.zeros(S * B, dtype=torch.bool, device=cuda_device)
    bad = [
        # wrong dtype
        lambda: sim_step.channel_llr(noise.double(), sig, q),
        lambda: sim_step.channel_llr(noise, sig, q, cw.long()),
        lambda: sim_step.prior_bl(flat.double()),
        lambda: sim_step.count_errors(hard.long(), None, iters, done, S, B, 4),
        lambda: sim_step.count_errors(hard, None, iters, done.int(), S, B, 4),
        # non-contiguous
        lambda: sim_step.channel_llr(noise.transpose(0, 1).contiguous().transpose(0, 1),
                                     sig, q),
        lambda: sim_step.prior_bl(flat.transpose(0, 1).contiguous().transpose(0, 1)),
        lambda: sim_step.count_errors(hard.T.contiguous().T, None, iters, done, S, B, 4),
        # an unsupported q (p bits of noise for q = 2^p), or p
        lambda: sim_step.channel_llr(torch.zeros((S, B, 3, 9), device=cuda_device), sig, 512),
        lambda: sim_step.prior_bl(torch.zeros((B, 3, 12), device=cuda_device)),
        lambda: sim_step.count_errors(hard, None, iters, done, S, B, 9),
        # shapes that disagree, a tensor off the card
        lambda: sim_step.channel_llr(noise, sig, 32),
        lambda: sim_step.channel_llr(noise, sig[:1], q),
        lambda: sim_step.count_errors(hard, cw[:, :, :3].contiguous(), iters, done, S, B, 4),
        lambda: sim_step.count_errors(hard, None, iters.cpu(), done, S, B, 4),
    ]
    before = [fn.launches for fn in (sim_step.channel_llr, sim_step.prior_bl,
                                     sim_step.count_errors)]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert [fn.launches for fn in (sim_step.channel_llr, sim_step.prior_bl,
                                   sim_step.count_errors)] == before


# every bench row's kernel implementation (the "torch" ones are plain)
SIM_STEP_ROWS = [(row.name, impl) for row in bench.ROWS for impl in row.impls
                 if impl != "torch"]


def _plain_composed_step(g, dec, impl, enc, gen, sig, S, B, monkeypatch) -> dict:
    """A sim step composed of the plain step functions around the same
    decode (decode_bl's entry through prior_bl_plain): noise and info
    symbols drawn from `gen` as make_sim_step draws them."""
    from nbldpc_tpu_torch import sim

    N, p, q = g.n, g.gf.p, g.q
    noise = torch.randn((S, B, N, p), generator=gen, device=g.device)
    cw = None if enc is None else enc.encode(torch.randint(
        0, q, (S, B, enc.k), generator=gen, device=g.device, dtype=torch.int32))
    llr = sim_step.channel_llr_plain(noise, sig, q, cw)
    with monkeypatch.context() as m:
        m.setattr(sim_step, "prior_bl", sim_step.prior_bl_plain)
        res = sim.get_decode_fn(dec, impl)(g, llr.reshape(S * B, N, q))
    return sim_step.count_errors_plain(res.hard, cw, res.iters, res.done, S, B, p)


@pytest.mark.cuda
@pytest.mark.parametrize("random_cw", [False, True])
@pytest.mark.parametrize("row,impl", SIM_STEP_ROWS)
def test_sim_step_through_kernels_equals_plain_composition(cuda_device, monkeypatch, row,
                                                           impl, random_cw):
    """make_sim_step through the kernels (2 SNR slots x 64 frames of the
    row's code and decoder) against the plain step functions around the same
    decode kernel on the same generator seed: counters equal, each step
    kernel launched once and no plain version run."""
    from nbldpc_tpu_torch import sim
    from nbldpc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nbldpc_tpu_torch.utils.config import DecoderConfig

    r = bench.ROWS_BY_NAME[row]
    S, B = 2, 64
    g = TannerGraph(CodeConfig(name=r.code).load(), device=cuda_device)
    dec = DecoderConfig(kind=r.kind, max_iters=r.iters, early_term=False,
                        stats_each_iter=False, **{"mm_precision": "f32", **dict(r.config)})
    enc = Encoder(g.spec, cuda_device) if random_cw else None
    sigma = float(ebn0_to_sigma(r.noise, g.spec.k / g.n)) if r.ebn0 else r.noise
    sig = torch.tensor([sigma, 1.2 * sigma], dtype=torch.float32, device=cuda_device)
    step = sim.make_sim_step(g, dec, B, S, enc, cn_impl=impl)
    reset_launch_counts()
    got = step(sim.step_generator(4, 0, cuda_device), sig)
    torch.cuda.synchronize()
    ran = {k: v for k, v in launch_counts().items() if v}
    want = _plain_composed_step(g, dec, impl, enc, sim.step_generator(4, 0, cuda_device), sig,
                                S, B, monkeypatch)
    assert _counters_equal(got, want)
    assert not [k for k in ran if k.endswith("_plain")]
    assert {k: ran.get(k) for k in ("channel_llr", "count_errors", "prior_bl")} == {
        "channel_llr": 1, "count_errors": 1, "prior_bl": 1 if impl == "kernel" else None}


# --- the q-last decode path (batch_last=False: plain PyTorch, no kernel) ------

# (label, code, decoder, keywords, Eb/N0): each decoder on small codes, and
# on the code with CN and VN pad slots
Q_LAST_CASES = [
    ("qspa", lambda: CodeConfig(name="gf4_n96_k48").load(), "qspa", {}, 2.0),
    ("qspa", lambda: _irregular_spec(16, 4), "qspa", {}, 3.0),
    ("ems", lambda: CodeConfig(name="gf16_n204_k102").load(), "ems", dict(nm=16), 2.0),
    ("ems", lambda: make_peg_code(48, 24, 64, dv=2, seed=3), "ems", dict(nm=8), 2.5),
    ("tems", lambda: CodeConfig(name="gf64_n576_k480").load(), "tems", dict(n_r=8), 3.5),
    ("tems", lambda: _irregular_spec(16, 4), "tems", dict(offset=0.5), 3.0),
]


def _q_last_decoders():
    from nbldpc_tpu_torch.decoders import ems, qspa, tems

    return {"qspa": qspa.decode, "ems": ems.decode, "tems": tems.decode}


@pytest.mark.cuda
@pytest.mark.parametrize("early_term", [True, False], ids=["early_term", "fixed"])
@pytest.mark.parametrize("label,spec,kind,kw,ebn0", Q_LAST_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(Q_LAST_CASES)])
def test_q_last_decode_equals_plain_decode_bl(cuda_device, label, spec, kind, kw, ebn0,
                                              early_term):
    """A q-last decode of a CUDA tensor returns CUDA tensors, launches no
    kernel and runs no plain kernel version, and gives the plain decode_bl's
    hard/done/iters frame for frame (dc and dv <= 5 and 4: the slot sums
    associate alike in both layouts)."""
    from nbldpc_tpu_torch.kernels import launch_counts, reset_launch_counts

    decode = _q_last_decoders()[kind]
    g = TannerGraph(spec(), device=cuda_device)
    llr = _zero_cw_llrs(g, 300, ebn0, cuda_device)
    reset_launch_counts()
    got = decode(g, llr, 10, early_term=early_term, batch_last=False, **kw)
    torch.cuda.synchronize()
    assert not any(launch_counts().values())
    assert all(t.device == llr.device for t in got)
    ref = decode(g, llr, 10, early_term=early_term, cn_impl="torch", **kw)
    for name, a, b in zip(("hard", "done", "iters"), got, ref):
        assert torch.equal(a, b), name
    assert 0 < int(got.done.sum())


@pytest.mark.cuda
def test_q_last_refusals_on_card(cuda_device):
    from nbldpc_tpu_torch.decoders import ems, qspa, tems

    g = _graph("gf16_n204_k102", cuda_device)
    llr = _zero_cw_llrs(g, 8, 2.0, cuda_device)
    for cn_impl in ("resident", "kernel"):
        with pytest.raises(ValueError, match="q-last"):
            qspa.decode(g, llr, cn_impl=cn_impl, batch_last=False)
        with pytest.raises(ValueError, match="q-last"):
            ems.decode(g, llr, cn_impl=cn_impl, batch_last=False)
    with pytest.raises(ValueError, match="q-last"):
        qspa.decode(g, llr, mm_precision="bf16", batch_last=False)
    with pytest.raises(ValueError, match="q-last"):
        ems.decode(g, llr, merge="bubble", batch_last=False)
    with pytest.raises(ValueError, match="q-last"):
        tems.decode(g, llr, cn_impl="kernel", batch_last=False)


# --- the program's spans on the card's timeline (utils/trace.py) -------------

# (decoder, code, Eb/N0 points, frames a step): K0's path and T-EMS in
# decode_bl with early termination, two steps each
TRACE_SWEEPS = [
    (dict(kind="qspa", max_iters=50), "gf16_n204_k102", (1.0, 2.0), 1024),
    (dict(kind="tems", max_iters=20, offset=2.0, tems_nr=8), "gf64_n576_k480", (3.0, 4.0), 256),
]


class _NoSpan:
    def __init__(self, name, into=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.cuda
@pytest.mark.parametrize("dec,code,ebn0,frames", TRACE_SWEEPS, ids=["qspa_k0", "tems_decode_bl"])
def test_spans_are_no_device_ops(cuda_device, monkeypatch, dec, code, ebn0, frames):
    """A short run_sweep under torch.profiler (CPU and CUDA): no CUDA-typed
    event bears a span's name (the spans are plain CPU ops, not user
    annotations), and portbench's reduction finds the same device ops as
    the same run with the spans made no-ops."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace as bench_trace

    from nbldpc_tpu_torch import sim
    from nbldpc_tpu_torch.decoders import common
    from nbldpc_tpu_torch.utils import config as tcfg

    cfg = tcfg.RunConfig(code=CodeConfig(name=code), decoder=tcfg.DecoderConfig(**dec),
                         channel=tcfg.ChannelConfig(ebn0_db=ebn0),
                         sim=tcfg.SimConfig(frames_per_step=frames, max_frames=2 * frames,
                                            max_frame_errors=10**9, seed=2**31 + 11))

    def traced():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sim.run_sweep(cfg, cuda_device)
            torch.cuda.synchronize()
        return list(prof.events())

    sim.run_sweep(cfg, cuda_device)                     # builds and warms up
    events = traced()
    names = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    spans = {n for n in names if n.startswith(("sweep.", "step.", "decode_bl."))}
    assert {"sweep.plan", "sweep.fetch", "step.decode"} <= spans
    assert ("decode_bl.sync" in spans) == (dec["kind"] == "tems")
    assert not [e.name for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA and e.name in spans]
    kernels = set(bench_trace.reduce(events)["kernels"])
    monkeypatch.setattr(sim, "span", _NoSpan)
    monkeypatch.setattr(common, "span", _NoSpan)
    bare = traced()
    assert not {e.name for e in bare} & spans
    assert set(bench_trace.reduce(bare)["kernels"]) == kernels
