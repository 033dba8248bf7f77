"""The port's resident QSPA decode (plain version, as it runs on the CPU)
against the JAX package's resident kernel ResidentQSPAFL in interpret mode:
hard decisions, done flags and iteration counts equal frame for frame."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbldpc_tpu.graph as jgraph
from nbldpc_tpu.kernels.qspa_resident import ResidentQSPAFL

from nbldpc_tpu_torch.code import load_alist, random_regular_spec
from nbldpc_tpu_torch.decoders import qspa as tqspa
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import qspa_resident as qr

from tests.test_torch_qspa import noisy_llrs, port_graph

torch.set_num_threads(1)

# (max_iters, early_term, stats_each_iter)
MODES = {"early_term": (8, True, True), "fixed": (8, False, True),
         "throughput": (6, False, False)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("code", ["gf16_tiny", "gf4_dv3", "gf16_irr"])
def test_resident_plain_matches_jax_interpret(small_codes, code, mode):
    spec = small_codes[code]
    iters, et, stats = MODES[mode]
    _, llr = noisy_llrs(spec, 16, 2.0, seed=4)
    h_j, d_j, i_j = ResidentQSPAFL(jgraph.TannerGraph(spec), iters, et,
                                   stats_each_iter=stats)(
        jnp.asarray(llr), tb=16, interpret=True)
    dec = qr.ResidentQSPA(port_graph(spec), iters, et, stats)
    launches = qr.resident_decode.launches
    h, d, i = qr.resident_decode(dec, torch.from_numpy(llr))
    assert qr.resident_decode.launches == launches    # CPU: plain version
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    assert h.dtype == torch.int32 and d.dtype == torch.bool and i.dtype == torch.int32


def test_resident_dispatch_caches_decoder(small_codes):
    g = port_graph(small_codes["gf16_tiny"])
    _, llr = noisy_llrs(small_codes["gf16_tiny"], 5, 2.5, seed=6)
    calls = qr.decode_plain.calls
    res = tqspa.decode(g, torch.from_numpy(llr), max_iters=4, cn_impl="resident")
    assert qr.decode_plain.calls == calls + 1
    assert res.hard.shape == (5, g.n)           # any batch size, no tile rule
    assert qr.get_resident_decoder(g, 4, True) is qr.get_resident_decoder(g, 4, True)
    gf64 = TannerGraph(load_alist(Path(__file__).resolve().parents[1]
                                  / "codes" / "gf64_n576_k480.alist"), "cpu")
    dec64 = qr.ResidentQSPA(gf64, 4)                # q <= 256: K0-cl on a card
    assert dec64.perm_down.numel() == gf64.m * gf64.dc_max * gf64.q
    llr64 = torch.zeros((1, gf64.n, gf64.q))
    assert tqspa.pick_impl("resident", gf64, llr64) == "resident"
    assert tqspa.pick_impl("auto", gf64, llr64) == "torch"     # CPU tensor
    with pytest.raises(ValueError, match="device"):
        qr.resident_decode_cl(dec64, llr64)         # the kernel takes no CPU tensor


# (code, frames per block, shared bytes per block) of K0's layout; checks
# of degree 4 at q <= 16 take one frame a block. GF(16) (204,102), dc = 4,
# dv = 2: tables 102 checks x 80 perm bytes (64 padded to 5 units of 16) +
# 2 x 408 + 2 x 408 + 408 x 4 syn bytes = 11,424 B; a frame 2 x 3,264
# floats of prior and posterior, 102 checks x 68 lc floats and 52 words of
# hard bytes = 54,064 B. GF(4) (96,48): tables 48 x 20 (16 padded to 5
# words) + 384 + 384 + 384 = 2,112 B; a frame 2 x 384 + 48 x 20 + 24
# floats = 7,008 B.
K0_LAYOUTS = [(f"gf16_n204_k102{v}", 1, 11424 + 54064) for v in ("", "_c8", "_qc")] + [
    (f"gf4_n96_k48{v}", 1, 2112 + 7008) for v in ("", "_c8", "_qc")]


@pytest.mark.parametrize("code,frames,nbytes", K0_LAYOUTS)
def test_k0_smem_layout(code, frames, nbytes):
    """The mirror of csrc/qspa_resident.cu's shared-memory layout at the
    checked-in codes over fields K0 takes."""
    g = TannerGraph(load_alist(Path(__file__).resolve().parents[1] / "codes"
                               / f"{code}.alist"), "cpu")
    dec = qr.ResidentQSPA(g, 4)
    assert (dec.frames_per_block, dec.smem_bytes) == (frames, nbytes)
    assert nbytes <= qr.MAX_SMEM_BYTES
    assert qr.k0_smem_layout(g.n, g.m, g.dc_max, g.dv_max, g.q) == (frames, nbytes)


def test_k0_refuses_oversize_block():
    """GF(32), N = 600, dv = 2, dc = 4: a one-frame block of 366,608 B
    (54,000 B of tables, 312,608 B of frame) raises ValueError before any
    device check or launch."""
    dec = qr.ResidentQSPA(TannerGraph(random_regular_spec(32, 600, 300, 3), "cpu"), 4)
    assert (dec.frames_per_block, dec.smem_bytes) == (1, 366608)
    launches = qr.resident_decode.launches
    with pytest.raises(ValueError, match="shared memory"):
        qr._launch(dec, torch.zeros((2, 600, 32)))
    assert qr.resident_decode.launches == launches
