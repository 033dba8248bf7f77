"""The port's resident EMS decode (plain version, as it runs on the CPU)
against the JAX package's resident EMS kernel ResidentEMS in interpret
mode: hard decisions, done flags and iteration counts equal frame for
frame, at nm = q and nm < q, offset 0.3."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbldpc_tpu.graph as jgraph
from nbldpc_tpu.kernels.ems_resident import ResidentEMS as JaxResidentEMS

from nbldpc_tpu_torch.code import load_alist
from nbldpc_tpu_torch.convert import codespec_from_arrays
from nbldpc_tpu_torch.decoders import ems as pems
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import cn_ems
from nbldpc_tpu_torch.kernels import ems_resident as er
from nbldpc_tpu_torch.kernels import qspa_resident as qr

from tests.test_torch_qspa import noisy_llrs, port_graph
from tests.test_torch_resident import MODES

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("trunc", ["nm_q", "nm_lt_q"])
@pytest.mark.parametrize("code", ["gf16_tiny", "gf4_dv3", "gf16_irr"])
def test_resident_ems_plain_matches_jax_interpret(small_codes, code, trunc, mode):
    spec = small_codes[code]
    nm = spec.q if trunc == "nm_q" else max(2, spec.q // 4)
    iters, et, stats = MODES[mode]
    _, llr = noisy_llrs(spec, 16, 2.0, seed=8)
    h_j, d_j, i_j = JaxResidentEMS(jgraph.TannerGraph(spec), iters, nm=nm, offset=0.3,
                                   early_term=et, stats_each_iter=stats)(
        jnp.asarray(llr), tb=16, interpret=True)
    dec = er.ResidentEMS(port_graph(spec), iters, nm, 0.3, et, stats)
    launches, calls = er.resident_decode.launches, er.decode_plain.calls
    h, d, i = er.resident_decode(dec, torch.from_numpy(llr))
    assert er.resident_decode.launches == launches    # CPU: plain version
    assert er.decode_plain.calls == calls + 1
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    assert h.dtype == torch.int32 and d.dtype == torch.bool and i.dtype == torch.int32


def test_resident_ems_matches_decode_bl(small_codes):
    """On a dv = 2 code the resident decode equals the batch-last decode."""
    spec = small_codes["gf16_tiny"]
    g = port_graph(spec)
    _, llr = noisy_llrs(spec, 12, 2.0, seed=9)
    kw = dict(max_iters=6, nm=8, offset=0.3, early_term=True)
    a = pems.decode(g, torch.from_numpy(llr), cn_impl="resident", **kw)
    b = pems.decode(g, torch.from_numpy(llr), cn_impl="torch", **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_resident_ems_dispatch_caches_decoder(small_codes):
    g = port_graph(small_codes["gf16_tiny"])
    _, llr = noisy_llrs(small_codes["gf16_tiny"], 5, 2.5, seed=6)
    calls, cn_calls = er.decode_plain.calls, cn_ems.cn_update_plain.calls
    res = pems.decode(g, torch.from_numpy(llr), max_iters=4, nm=8, cn_impl="resident")
    assert er.decode_plain.calls == calls + 1
    assert cn_ems.cn_update_plain.calls == cn_calls
    assert res.hard.shape == (5, g.n)           # any batch size, no tile rule
    assert (er.get_resident_ems(g, 4, 8, 0.3, True)
            is er.get_resident_ems(g, 4, 8, 0.3, True))
    assert er.get_resident_ems(g, 4, 8, 0.3, True).nm == 8
    assert er.ResidentEMS(g, 4, nm=99).nm == g.q
    gf64 = TannerGraph(load_alist(Path(__file__).resolve().parents[1]
                                  / "codes" / "gf64_n576_k480.alist"), "cpu")
    with pytest.raises(ValueError, match="q <= 32"):
        er.ResidentEMS(gf64, 4)


def test_resident_ems_smem_layout_and_refusal():
    """The mirror of csrc/ems_resident.cu's shared-memory layout. GF(16)
    (204,102), dc = 4, dv = 2: tables 408 x 16 perm bytes + 2 x 408 + 2 x
    408 + 408 x 4 syn bytes = 9,792 B; a frame 2 x 3,264 floats of prior
    and posterior, 102 checks x (68 lc + 36 scratch) floats, 612 mask words
    and 52 words of hard bytes = 71,200 B; three frames a block. A code
    whose one-frame block exceeds 232,448 B raises ValueError before any
    launch."""
    codes = Path(__file__).resolve().parents[1] / "codes"
    g = TannerGraph(load_alist(codes / "gf16_n204_k102.alist"), "cpu")
    dec = er.ResidentEMS(g, 4)
    assert (dec.frames_per_block, dec.smem_bytes) == (3, 9792 + 3 * 71200)
    assert dec.smem_bytes <= qr.MAX_SMEM_BYTES
    # GF(32), N = 600, dv = 2, dc = 4: ~390 KB a frame
    rng = np.random.default_rng(3)
    n, m = 600, 300
    sockets = rng.permutation(np.repeat(np.arange(n), 2)).reshape(m, 4)
    while any(len(set(r)) < 4 for r in sockets):
        sockets = rng.permutation(np.repeat(np.arange(n), 2)).reshape(m, 4)
    spec = codespec_from_arrays(32, n, m, [np.sort(r) for r in sockets],
                                [rng.integers(1, 32, size=4) for _ in range(m)])
    big = er.ResidentEMS(TannerGraph(spec, "cpu"), 4)
    assert big.frames_per_block == 1 and big.smem_bytes > qr.MAX_SMEM_BYTES
    launches = er.resident_decode.launches
    with pytest.raises(ValueError, match="shared memory"):
        er._launch(big, torch.zeros((2, n, 32)))
    assert er.resident_decode.launches == launches


def test_kernel_ab_trial_builds_apply():
    """Every trial build of benchmarks/kernel_ab.py names text that is in
    its kernel source, so `--builds` edits the kernels as they stand."""
    import importlib.util

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", root / "nbldpc_tpu_torch" / "benchmarks" / "kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    csrc = root / "nbldpc_tpu_torch" / "csrc"
    for name, (source, edits) in ab.BUILDS.items():
        text = (csrc / source).read_text()
        for old, _ in edits:
            assert text.count(old) == 1, (name, old)
