"""The port's EMS check-node updates (classic and bubble), its K2 wrapper
and its batch-last EMS decode against the JAX package (XLA path and the
Pallas K2 kernel in interpret mode). Inputs are made with numpy from a seed
and go to both packages. EMS has only adds and max, so the two packages
agree exactly; the stated tolerance is atol 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbldpc_tpu.graph as jgraph
from nbldpc_tpu.codegen import make_peg_code
from nbldpc_tpu.decoders import ems as jems
from nbldpc_tpu.kernels.cn_ems import ems_cn_update_bl_pallas

from nbldpc_tpu_torch import sim
from nbldpc_tpu_torch.decoders import ems as pems
from nbldpc_tpu_torch.kernels import cn_ems
from nbldpc_tpu_torch.utils import config as tcfg

from tests.test_torch_qspa import noisy_llrs, port_graph, random_u

torch.set_num_threads(1)

ATOL = 1e-6


@pytest.fixture(scope="module")
def highq_codes():
    return {q: make_peg_code(12, 6, q, dv=2, seed=5) for q in (64, 256)}


def _spec(small_codes, highq_codes, q):
    return small_codes["gf16_tiny"] if q == 16 else highq_codes[q]


CLASSIC = [(16, 4), (16, 8), (16, 16), (64, 8), (256, 16)]


@pytest.mark.parametrize("q,nm", CLASSIC)
def test_cn_classic_matches_jax(small_codes, highq_codes, q, nm):
    jg = jgraph.TannerGraph(_spec(small_codes, highq_codes, q))
    _, U = random_u(jg, B=6, seed=q + nm)
    want = np.asarray(jems.ems_cn_update_bl(jnp.asarray(U), jg, nm=nm, offset=0.3))
    got = pems.ems_cn_update_bl(torch.from_numpy(U), None, nm=nm, offset=0.3).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("q,nm", [(16, 8), (64, 8), (256, 16)])
def test_cn_classic_ties_match_jax(small_codes, highq_codes, q, nm):
    """Inputs from four levels, so every extraction round meets ties, which
    go to the lowest symbol in both packages."""
    jg = jgraph.TannerGraph(_spec(small_codes, highq_codes, q))
    _, U = random_u(jg, B=6, seed=q)
    U = (np.random.default_rng(q).integers(0, 4, U.shape) * 1.5).astype(np.float32)
    want = np.asarray(jems.ems_cn_update_bl(jnp.asarray(U), jg, nm=nm, offset=0.1))
    got = pems.ems_cn_update_bl(torch.from_numpy(U), None, nm=nm, offset=0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("q,nm", [(64, 8), (256, 16)])
def test_cn_bubble_matches_jax(highq_codes, q, nm):
    jg = jgraph.TannerGraph(highq_codes[q])
    _, U = random_u(jg, B=6, seed=2 * q)
    want = np.asarray(jems.ems_cn_update_bl(jnp.asarray(U), jg, nm=nm, offset=0.1,
                                            merge="bubble"))
    got = pems.ems_cn_update_bl(torch.from_numpy(U), None, nm=nm, offset=0.1,
                                merge="bubble").numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("q,nm,dc", [(16, 8, 4), (16, 16, 4), (64, 8, 4), (256, 16, 4),
                                     (16, 8, 3), (64, 8, 3), (256, 16, 3)])
def test_cn_bubble_ties_match_jax(q, nm, dc):
    """Inputs from four levels, so every extraction round and every merge
    meets ties (lowest symbol, lowest staircase position), and retired
    candidates are picked again; q = 16 is the shape K2b packs two frames
    a warp for, dc = 3 the shortest merge chain."""
    jg = jgraph.TannerGraph(make_peg_code(6 * dc // 2, 6, q, dv=2, seed=5))
    assert jg.dc_max == dc
    U = (np.random.default_rng(q + dc).integers(0, 4, (jg.m, dc, q, 6)) * 1.5
         ).astype(np.float32)
    want = np.asarray(jems.ems_cn_update_bl(jnp.asarray(U), jg, nm=nm, offset=0.1,
                                            merge="bubble"))
    got = pems.ems_cn_update_bl(torch.from_numpy(U), None, nm=nm, offset=0.1,
                                merge="bubble").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bubble_pairs_and_candidates():
    pairs = pems.bubble_pairs(16)
    assert pairs == jems.bubble_pairs(16)
    assert len(pairs) + min(2 * 16, 256) == 119      # K2b's candidate count


def test_k2_wrapper_matches_jax_kernel_interpret(small_codes):
    """The JAX K2 in interpret mode against the port's cn_ems.cn_update on a
    CPU tensor, which runs the plain version and launches nothing."""
    jg = jgraph.TannerGraph(small_codes["gf16_tiny"])
    _, U = random_u(jg, B=8, seed=31)
    want = np.asarray(ems_cn_update_bl_pallas(jnp.asarray(U), jg, nm=8, offset=0.1,
                                              interpret=True))
    launches, calls = cn_ems.cn_update.launches, cn_ems.cn_update_plain.calls
    got = cn_ems.cn_update(torch.from_numpy(U), 8, 0.1).numpy()
    assert cn_ems.cn_update.launches == launches
    assert cn_ems.cn_update_plain.calls == calls + 1
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    b_launches = cn_ems.cn_update_bubble.launches
    cn_ems.cn_update_bubble(torch.from_numpy(U), 8, 0.1)
    assert cn_ems.cn_update_bubble.launches == b_launches


MODES = {"early_term": dict(early_term=True),
         "throughput": dict(early_term=False, stats_each_iter=False)}


def _assert_same(res, ref):
    np.testing.assert_array_equal(res.hard.numpy(), np.asarray(ref.hard))
    np.testing.assert_array_equal(res.done.numpy(), np.asarray(ref.done))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    assert res.hard.dtype == torch.int32 and res.iters.dtype == torch.int32


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("code", ["gf16_tiny", "gf4_dv3", "gf16_irr"])
def test_decode_matches_jax(small_codes, code, mode):
    spec = small_codes[code]
    _, llr = noisy_llrs(spec, 16, 2.0, seed=3)
    kw = dict(max_iters=8, nm=8, offset=0.3, **MODES[mode])
    ref = jems.decode(jgraph.TannerGraph(spec), jnp.asarray(llr), use_pallas="no", **kw)
    res = pems.decode(port_graph(spec), torch.from_numpy(llr), cn_impl="torch", **kw)
    _assert_same(res, ref)


def test_decode_bubble_matches_jax(highq_codes):
    spec = highq_codes[64]
    _, llr = noisy_llrs(spec, 8, 3.0, seed=4)
    kw = dict(max_iters=4, nm=8, offset=0.0, merge="bubble")
    ref = jems.decode(jgraph.TannerGraph(spec), jnp.asarray(llr), use_pallas="no", **kw)
    calls = cn_ems.cn_update_bubble_plain.calls
    res = pems.decode(port_graph(spec), torch.from_numpy(llr), cn_impl="auto", **kw)
    assert cn_ems.cn_update_bubble_plain.calls > calls
    _assert_same(res, ref)


def test_dispatch(small_codes, highq_codes):
    g16 = port_graph(small_codes["gf16_tiny"])
    g64 = port_graph(highq_codes[64])
    llr16 = torch.zeros((2, g16.n, g16.q))
    assert pems.pick_impl("auto", g16, llr16) == "torch"
    assert pems.pick_impl("auto", g64, torch.zeros((2, g64.n, 64))) == "torch"
    for impl in ("resident", "kernel", "torch"):
        assert pems.pick_impl(impl, g16, llr16) == impl
    assert pems.pick_impl("kernel", g16, llr16, merge="bubble") == "kernel"
    with pytest.raises(ValueError, match="classic"):
        pems.pick_impl("resident", g16, llr16, merge="bubble")
    with pytest.raises(ValueError):
        pems.pick_impl("pallas", g16, llr16)
    with pytest.raises(ValueError):
        pems.pick_impl("auto", g16, llr16, merge="stack")


def test_dispatch_auto_on_cuda_tensor(small_codes, highq_codes):
    """"auto" for a CUDA tensor: resident for q <= 32 and classic merge, the
    check-node kernel otherwise (an object on a CUDA device stands in for
    the tensor: pick_impl reads only its device)."""
    g16 = port_graph(small_codes["gf16_tiny"])
    g64 = port_graph(highq_codes[64])

    class Cuda:
        device = torch.device("cuda")

    assert pems.pick_impl("auto", g16, Cuda) == "resident"
    assert pems.pick_impl("auto", g16, Cuda, merge="bubble") == "kernel"
    assert pems.pick_impl("auto", g64, Cuda) == "kernel"


def test_sim_step_ems_counts(small_codes):
    g = port_graph(small_codes["gf16_tiny"])
    dec = tcfg.DecoderConfig(kind="ems", max_iters=4, nm=8, offset=0.3)
    calls = cn_ems.cn_update_plain.calls
    step = sim.make_sim_step(g, dec, batch_per_snr=8, n_snr=2)
    out = sim.fetch(step(sim.step_generator(3, 7, "cpu"), torch.tensor([1.2, 0.3])))
    assert cn_ems.cn_update_plain.calls > calls
    assert out["frames"].tolist() == [8, 8]
    assert np.all(out["converged"] <= 8) and np.all(out["bit_errors"] >= out["symbol_errors"])
    assert out["frame_errors"][1] <= out["frame_errors"][0]
    bub = dataclasses.replace(dec, ems_merge="bubble")
    out_b = sim.fetch(sim.make_sim_step(g, bub, 8, 1)(sim.step_generator(3, 7, "cpu"),
                                                     torch.tensor([0.3])))
    assert out_b["frames"].tolist() == [8]
