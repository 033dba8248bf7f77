"""The port's check-node update and batch-last QSPA decode against the JAX
package (XLA path and the Pallas K1 kernel in interpret mode) and the numpy
oracle. Inputs are made with numpy from a seed and go to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbldpc_tpu.graph as jgraph
from nbldpc_tpu.codegen import make_peg_code
from nbldpc_tpu.decoders import qspa as jqspa
from nbldpc_tpu.encode import Encoder
from nbldpc_tpu.kernels.cn_qspa import cn_update_pallas

from nbldpc_tpu_torch import convert
from nbldpc_tpu_torch.channel import ebn0_to_sigma
from nbldpc_tpu_torch.decoders import common
from nbldpc_tpu_torch.decoders import qspa as tqspa
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import cn_qspa
from nbldpc_tpu_torch.kernels import qspa_resident as qr

from tests.reference_model import OracleDecoder

torch.set_num_threads(1)


def port_graph(spec, device="cpu") -> TannerGraph:
    return TannerGraph(convert.codespec_from_arrays(
        spec.q, spec.n, spec.m, spec.row_cols, spec.row_vals), device=device)


def noisy_llrs(spec, frames: int, ebn0: float, seed: int):
    """Random codewords (numpy info symbols through the JAX encoder), BPSK,
    numpy AWGN: (codewords [B, N] int32, llr [B, N, q] float32)."""
    rng = np.random.default_rng(seed)
    enc = Encoder(spec)
    u = rng.integers(0, spec.q, size=(frames, enc.k)).astype(np.int32)
    cw = np.asarray(enc.encode(jnp.asarray(u)))
    bits = np.asarray(port_graph(spec).gf.bits, np.float32)        # [q, p]
    sigma = np.float32(ebn0_to_sigma(ebn0, spec.k / spec.n))
    y = (1.0 - 2.0 * bits[cw]) + sigma * rng.standard_normal(
        cw.shape + (bits.shape[1],)).astype(np.float32)
    llr = (-(2.0 / sigma**2) * (y.astype(np.float32) @ bits.T)).astype(np.float32)
    return cw, llr


def random_u(jg, B: int, seed: int) -> np.ndarray:
    """x-domain CN inputs with the real pad structure (JAX gather)."""
    rng = np.random.default_rng(seed)
    Vv = (rng.standard_normal((jg.n, jg.dv_max, jg.q, B)) * 3.0).astype(np.float32)
    return Vv, np.array(jax.jit(jg.gather_cn_x_bl)(jnp.asarray(Vv)))


@pytest.mark.parametrize("q,n,m", [(4, 12, 6), (16, 16, 8), (64, 12, 6), (256, 12, 6)])
def test_cn_plain_matches_jax(q, n, m):
    spec = make_peg_code(n, m, q, dv=2, seed=3)
    jg = jgraph.TannerGraph(spec)
    Vv, U = random_u(jg, B=8, seed=q)
    tg = port_graph(spec)
    # the port's routing gives the same U bit for bit
    np.testing.assert_array_equal(tg.gather_cn_x_bl(torch.from_numpy(Vv)).numpy(), U)
    got = cn_qspa.cn_update_plain(torch.from_numpy(U)).numpy()
    mask = jg.cn_mask_np[:, :, None, None]
    for want in (np.asarray(cn_update_pallas(jnp.asarray(U), interpret=True)),
                 np.asarray(jqspa.qspa_cn_update_bl(jnp.asarray(U), jg))):
        np.testing.assert_allclose(np.where(mask, got, 0.0), np.where(mask, want, 0.0),
                                   rtol=1e-5, atol=1e-5)
    # on a CPU tensor the wrapper runs the plain version, and launches nothing
    launches = cn_qspa.cn_update.launches
    np.testing.assert_array_equal(cn_qspa.cn_update(torch.from_numpy(U)).numpy(), got)
    assert cn_qspa.cn_update.launches == launches


def test_routing_and_syndrome_match_on_irregular(small_codes):
    spec = small_codes["gf16_irr"]
    jg, tg = jgraph.TannerGraph(spec), port_graph(spec)
    assert tg.has_cn_pads
    rng = np.random.default_rng(5)
    C = rng.standard_normal((jg.m, jg.dc_max, jg.q, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tg.gather_vn_x_bl(torch.from_numpy(C)).numpy(),
        np.asarray(jg.gather_vn_x_bl(jnp.asarray(C))))
    hard = rng.integers(0, jg.q, size=(jg.n, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        tg.syndrome_bl(torch.from_numpy(hard)).numpy(),
        np.asarray(jg.syndrome_bl(jnp.asarray(hard))))


MODES = {"early_term": dict(early_term=True),
         "fixed": dict(early_term=False),
         "throughput": dict(early_term=False, stats_each_iter=False)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("code", ["gf4_tiny", "gf16_tiny", "gf4_dv3", "gf16_irr"])
def test_decode_bl_matches_jax(small_codes, code, mode):
    spec = small_codes[code]
    _, llr = noisy_llrs(spec, 16, 2.0, seed=2)
    kw = MODES[mode]
    ref = jqspa.decode(jgraph.TannerGraph(spec), jnp.asarray(llr), max_iters=8,
                       cn_impl="xla", **kw)
    res = tqspa.decode(port_graph(spec), torch.from_numpy(llr), max_iters=8,
                       cn_impl="auto", **kw)
    np.testing.assert_array_equal(res.hard.numpy(), np.asarray(ref.hard))
    np.testing.assert_array_equal(res.done.numpy(), np.asarray(ref.done))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    assert res.hard.dtype == torch.int32 and res.iters.dtype == torch.int32


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ebn0", [1.0, 2.0])
@pytest.mark.parametrize("q", [64, 256])
def test_decode_bl_high_q_matches_jax(q, ebn0, mode):
    """QSPA decode_bl at q >= 32, where the plain check node sums the
    softmax in K1's association (residues mod 32, then a tree) and not in
    XLA's order: the decisions still agree with JAX frame for frame."""
    spec = make_peg_code(12, 6, q, dv=2, seed=3)
    _, llr = noisy_llrs(spec, 16, ebn0, seed=2)
    kw = MODES[mode]
    ref = jqspa.decode(jgraph.TannerGraph(spec), jnp.asarray(llr), max_iters=8,
                       cn_impl="xla", **kw)
    res = tqspa.decode(port_graph(spec), torch.from_numpy(llr), max_iters=8,
                       cn_impl="torch", **kw)
    np.testing.assert_array_equal(res.hard.numpy(), np.asarray(ref.hard))
    np.testing.assert_array_equal(res.done.numpy(), np.asarray(ref.done))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))


@pytest.mark.parametrize("code", ["gf4_tiny", "gf16_tiny"])
def test_messages_one_iter_match_oracle(small_codes, code):
    """Check->variable messages after one iteration, c-domain, at 2e-3."""
    spec = small_codes[code]
    _, llr = noisy_llrs(spec, 3, 2.0, seed=1)
    g = port_graph(spec)
    L = torch.from_numpy(llr).permute(1, 2, 0)
    L = L - L.amax(dim=1, keepdim=True)                     # [N, q, B]
    Vv = L[:, None].expand(g.n, g.dv_max, g.q, L.shape[-1])
    Vv = Vv - Vv.amax(dim=2, keepdim=True)
    Chat = tqspa.qspa_cn_update_bl(g.gather_cn_x_bl(Vv.contiguous()), g)
    pu = g.perm_up.long()                                   # C(a) = Chat(h a)
    oracle = OracleDecoder(spec, kind="qspa")
    for b in range(llr.shape[0]):
        _, _, _, C_o = oracle.decode(llr[b], max_iters=1, early_term=False,
                                     return_messages=True)
        C = torch.gather(Chat[..., b], 2, pu).numpy()
        for mi in range(spec.m):
            for j in range(len(spec.row_cols[mi])):
                np.testing.assert_allclose(C[mi, j], C_o[mi][j], rtol=2e-3, atol=2e-3,
                                           err_msg=f"frame {b} check {mi} slot {j}")


def test_dispatch_and_refusals(small_codes):
    g = port_graph(small_codes["gf16_tiny"])
    llr = torch.zeros((2, g.n, g.q))
    assert tqspa.pick_impl("auto", g, llr) == "torch"
    assert tqspa.pick_impl("resident", g, llr) == "resident"
    with pytest.raises(ValueError):
        tqspa.pick_impl("pallas", g, llr)
    # bf16 message storage decodes (the resident path's plain version on a
    # CPU tensor); an unknown precision is refused
    calls = qr.decode_plain.calls
    res = tqspa.decode(g, llr, max_iters=2, cn_impl="resident", mm_precision="bf16")
    assert qr.decode_plain.calls == calls + 1 and res.hard.shape == (2, g.n)
    with pytest.raises(ValueError, match="mm_precision"):
        tqspa.decode(g, llr, mm_precision="fp16")
    res = common.decode_bl(g, llr[:0], common.full_width(tqspa.qspa_cn_update_bl), 3)
    assert res.hard.shape == (0, g.n)
