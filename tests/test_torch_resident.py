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

from nbldpc_tpu_torch.code import load_alist
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
