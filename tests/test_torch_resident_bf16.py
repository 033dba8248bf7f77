"""bf16 message storage (mm_precision="bf16") in the port's resident QSPA
decode: the plain version, as it runs on the CPU, against the JAX
package's resident kernels built with mm_dtype=bfloat16 in interpret
mode, hard decisions, done flags and iteration counts equal frame for
frame; the bf16 layouts of K0 and K0-cl; the dispatch.

The JAX kernels are compiled with XLA's xla_allow_excess_precision off.
With it on (XLA's default), XLA forwards the f32 posterior of an
iteration to that iteration's decision in place of the bf16 value the
kernel stores and reads back, so its per-iteration decisions are taken on
a posterior the kernel source never holds (ROADMAP queue 3, reference
caveats)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbldpc_tpu.graph as jgraph
from nbldpc_tpu.codegen import make_peg_code
from nbldpc_tpu.kernels.qspa_resident import ResidentQSPA as JaxResidentQSPA
from nbldpc_tpu.kernels.qspa_resident import ResidentQSPAFL

from nbldpc_tpu_torch import sim
from nbldpc_tpu_torch.code import load_alist
from nbldpc_tpu_torch.decoders import qspa as tqspa
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import qspa_resident as qr
from nbldpc_tpu_torch.utils.config import DecoderConfig

from tests.test_torch_qspa import noisy_llrs, port_graph

torch.set_num_threads(1)

CODES = Path(__file__).resolve().parents[1] / "codes"
# (max_iters, early_term, stats_each_iter), as test_torch_resident.py
MODES = {"early_term": (8, True, True), "fixed": (8, False, True),
         "throughput": (6, False, False)}


def jax_bf16(kernel_cls, spec, iters, et, stats, llr):
    """The JAX resident kernel with bf16 state in interpret mode, compiled
    without excess precision: (hard, done, iters) as numpy arrays."""
    kern = kernel_cls(jgraph.TannerGraph(spec), iters, et, stats_each_iter=stats,
                      mm_dtype=jnp.bfloat16)
    x = jnp.asarray(llr)
    fn = jax.jit(lambda a: kern(a, tb=llr.shape[0], interpret=True))
    out = fn.lower(x).compile({"xla_allow_excess_precision": False})(x)
    return [np.asarray(a) for a in out]


def plain_bf16(spec, iters, et, stats, llr):
    dec = qr.ResidentQSPA(port_graph(spec), iters, et, stats, "bf16")
    launches = qr.resident_decode.launches_bf16, qr.resident_decode_cl.launches_bf16
    out = qr.resident_decode(dec, torch.from_numpy(llr))
    # CPU: the plain version, no kernel
    assert (qr.resident_decode.launches_bf16, qr.resident_decode_cl.launches_bf16) == launches
    return [t.numpy() for t in out]


def assert_same(got, want):
    for name, a, b in zip(("hard", "done", "iters"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("code", ["gf16_tiny", "gf4_dv3", "gf16_irr"])
def test_resident_bf16_plain_matches_jax_fl_interpret(small_codes, code, mode):
    """q <= 32 (K0's fields): JAX's frames-on-lanes kernel ResidentQSPAFL."""
    spec = small_codes[code]
    iters, et, stats = MODES[mode]
    _, llr = noisy_llrs(spec, 16, 2.0, seed=4)
    got = plain_bf16(spec, iters, et, stats, llr)
    assert_same(got, jax_bf16(ResidentQSPAFL, spec, iters, et, stats, llr))
    assert 0 < got[1].sum() < len(got[1])          # converged and failed frames


def test_resident_bf16_plain_matches_jax_cl_interpret_gf64():
    """32 < q (K0-cl's fields): JAX's checks-on-lanes kernel ResidentQSPA
    on a GF(64) PEG code of test_torch_resident_cl.py's size, early
    termination."""
    spec = make_peg_code(24, 8, 64, dv=2, seed=3)
    _, llr = noisy_llrs(spec, 16, 2.0, seed=4)
    got = plain_bf16(spec, 8, True, True, llr)
    assert_same(got, jax_bf16(JaxResidentQSPA, spec, 8, True, True, llr))
    assert 0 < got[1].sum() < len(got[1])


def tied_llrs(spec, frames: int, seed: int):
    """Noisy LLRs whose runner-up symbol of every row sits 2^-10 of the
    best's magnitude (and 1e-3) below the best: distinct in f32, often the
    same bf16 value once an iteration's messages are added."""
    _, llr = noisy_llrs(spec, frames, 1.5, seed=seed)
    top = np.argsort(-llr, axis=2)
    b, v = np.meshgrid(np.arange(frames), np.arange(spec.n), indexing="ij")
    best = llr[b, v, top[..., 0]]
    llr[b, v, top[..., 1]] = best - np.abs(best) * np.float32(2**-10) - np.float32(1e-3)
    return llr.astype(np.float32)


@pytest.mark.parametrize("mode", ["fixed", "throughput"])
def test_resident_bf16_argmax_ties_match_jax(small_codes, mode):
    """Ties in the bf16 posterior go to the lowest symbol, as JAX's hard_of
    breaks them; the case holds ties (checked on the plain posterior)."""
    spec = small_codes["gf16_tiny"]
    iters, et, stats = MODES[mode]
    llr = tied_llrs(spec, 16, seed=9)
    dec = qr.ResidentQSPA(port_graph(spec), iters, et, stats, "bf16")
    g, B = dec.graph, llr.shape[0]
    prior = torch.from_numpy(llr).permute(1, 2, 0)
    prior = dec._round(prior - prior.amax(dim=1, keepdim=True))
    post, lc, ties = prior, torch.zeros(g.m * g.dc_max, g.q, B), 0
    for _ in range(iters):
        post, lc = dec._iteration(prior, post, lc)
        top2 = post.topk(2, dim=1).values
        ties += int((top2[:, 0] == top2[:, 1]).sum())
    assert ties > 0
    assert_same(plain_bf16(spec, iters, et, stats, llr),
                jax_bf16(ResidentQSPAFL, spec, iters, et, stats, llr))


def _code(name):
    return TannerGraph(load_alist(CODES / f"{name}.alist"), "cpu")


@pytest.mark.parametrize("code,size,smem", [("gf256_n255_k175", 4, 215984),
                                            ("gf64_n576_k480", 2, 208392)])
def test_cluster_plan_bf16(code, size, smem):
    """bf16 state halves the ranks a buffered cluster needs: config 5's
    GF(256) code from 8 blocks to 4, GF(64) (576,480) from 4 to 2 (f32's
    buffered layout; f32 takes config 5's code in place, on 4)."""
    g = _code(code)
    plan = qr.plan_cluster(g, es=2)
    assert (plan.size, plan.smem_bytes) == (size, smem)
    assert qr.ResidentQSPA(g, 4, mm_precision="bf16").cluster_plan.size == size
    f32 = next(p for s in qr.CLUSTER_SIZES if (p := qr.cluster_plan_at(g, s)) is not None)
    assert f32.size == 2 * size and not f32.in_place
    assert qr.cluster_smem_bytes(g.q, g.dc_max, g.dv_max, plan.rows, plan.checks,
                                 plan.round_checks, 2) == smem
    if size > 1:                                  # the next smaller cluster does not fit
        half = size // 2
        assert qr.cluster_smem_bytes(g.q, g.dc_max, g.dv_max, -(-g.n // half),
                                     -(-g.m // half), 1, 2) > qr.MAX_SMEM_BYTES


def test_scratch_plan_bf16():
    """The scratch kernel's bf16 plan: the posterior rows and the slice in
    2-byte elements; as many or fewer rounds than f32's."""
    from nbldpc_tpu_torch.code import random_regular_spec

    g = TannerGraph(random_regular_spec(256, 1200, 400, 3), "cpu")
    p32, p16 = qr.plan_scratch(g), qr.plan_scratch(g, es=2)
    assert p16.smem_bytes <= qr.MAX_SMEM_BYTES
    assert p16.smem_bytes == qr.scratch_smem_bytes(g.q, g.dc_max, g.dv_max, p16.rows,
                                                   p16.checks, p16.round_checks,
                                                   p16.post_shared, 2)
    assert p16.slice_elems == g.q * p16.size * (p16.checks * g.dc_max
                                                + (0 if p16.post_shared else p16.rows))
    rounds = [-(-p.checks // p.round_checks) for p in (p32, p16)]
    assert rounds[1] <= rounds[0]


def test_k0_layout_bf16():
    """K0 at the flagship in bf16: tables 11,424 B as in f32; a frame 2 x
    3,264 bf16 of prior and posterior, 102 checks x 72 bf16 of lc rows (64
    padded to 16 (mod 32) bytes) and 104 bf16 of hard bytes = 27,952 B."""
    g = _code("gf16_n204_k102_c8")
    assert qr.k0_smem_layout(g.n, g.m, g.dc_max, g.dv_max, g.q, 2) == (1, 11424 + 27952)
    dec = qr.ResidentQSPA(g, 4, mm_precision="bf16")
    assert (dec.frames_per_block, dec.smem_bytes) == (1, 39376)
    assert qr.k0_smem_layout(g.n, g.m, g.dc_max, g.dv_max, g.q) == (1, 11424 + 54064)


def test_bf16_dispatch(small_codes):
    g = port_graph(small_codes["gf16_tiny"])
    _, llr = noisy_llrs(small_codes["gf16_tiny"], 6, 1.5, seed=2)
    x = torch.from_numpy(llr)
    calls = qr.decode_plain.calls
    res = tqspa.decode(g, x, max_iters=4, cn_impl="resident", mm_precision="bf16")
    assert qr.decode_plain.calls == calls + 1
    dec = qr.get_resident_decoder(g, 4, True, True, "bf16")
    assert dec.mm_precision == "bf16" and dec is not qr.get_resident_decoder(g, 4, True, True)
    assert_same([t.numpy() for t in res], [t.numpy() for t in qr.decode_plain(dec, x)])
    for bad in ("fp16", "bfloat16", None):
        with pytest.raises(ValueError, match="mm_precision"):
            tqspa.decode(g, x, max_iters=4, cn_impl="resident", mm_precision=bad)
        with pytest.raises(ValueError, match="mm_precision"):
            qr.ResidentQSPA(g, 4, mm_precision=bad)
    # the bf16 kernels take no CPU tensor
    with pytest.raises(ValueError, match="device"):
        qr._launch(dec, x)


@pytest.mark.parametrize("kind,cn_impl", [("qspa", "torch"), ("qspa", "kernel"),
                                          ("qspa", "auto"), ("ems", "auto"),
                                          ("tems", "auto")])
def test_non_resident_paths_ignore_bf16(small_codes, kind, cn_impl):
    """Only the resident QSPA decode has the mode: the check-node paths,
    EMS and T-EMS decode the same in f32 and "bf16"."""
    g = port_graph(small_codes["gf16_tiny"])
    _, llr = noisy_llrs(small_codes["gf16_tiny"], 6, 1.5, seed=2)
    x = torch.from_numpy(llr)
    outs = [sim.get_decode_fn(DecoderConfig(kind=kind, max_iters=4, mm_precision=p),
                              cn_impl)(g, x) for p in ("f32", "bf16")]
    assert_same([t.numpy() for t in outs[0]], [t.numpy() for t in outs[1]])
