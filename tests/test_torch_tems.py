"""The port's T-EMS check-node update, its K5 wrapper, its batch-last decode
and the channel helpers against the JAX package (XLA path and the Pallas K5
kernel in interpret mode) and the numpy oracle. Inputs are made with numpy
from a seed and go to both packages. Every T-EMS candidate is one add and
the rest is max and select, so the two packages agree bitwise; the stated
tolerance is atol 1e-6."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbldpc_tpu.channel as jch
import nbldpc_tpu.graph as jgraph
from nbldpc_tpu.codegen import make_peg_code
from nbldpc_tpu.decoders import tems as jtems
from nbldpc_tpu.encode import Encoder
from nbldpc_tpu.kernels.cn_tems import tems_cn_update_bl_pallas

from nbldpc_tpu_torch import channel as tch
from nbldpc_tpu_torch import cli
from nbldpc_tpu_torch.decoders import tems
from nbldpc_tpu_torch.kernels import cn_tems

from tests.reference_model import OracleDecoder
from tests.test_torch_qspa import noisy_llrs, port_graph, random_u

torch.set_num_threads(1)

ATOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def highq_codes():
    return {q: make_peg_code(12, 6, q, dv=2, seed=5) for q in (64, 256)}


def _spec(small_codes, highq_codes, code):
    return small_codes[code] if code in small_codes else highq_codes[int(code[1:])]


@pytest.mark.parametrize("offset", [0.1, 2.0])
@pytest.mark.parametrize("code,n_r", [("gf16_tiny", 0), ("gf16_tiny", 4), ("q64", 0),
                                      ("q64", 8), ("q256", 8)])
def test_cn_matches_jax(small_codes, highq_codes, code, n_r, offset):
    jg = jgraph.TannerGraph(_spec(small_codes, highq_codes, code))
    _, U = random_u(jg, B=6, seed=jg.q + n_r)
    want = np.asarray(jtems.tems_cn_update_bl(jnp.asarray(U), jg, offset=offset, n_r=n_r))
    got = tems.tems_cn_update_bl(torch.from_numpy(U), None, offset, n_r).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("code,n_r", [("gf16_tiny", 0), ("q64", 8)])
def test_k5_wrapper_matches_jax_kernel_interpret(small_codes, highq_codes, code, n_r):
    """The JAX K5 in interpret mode against the port's cn_tems.cn_update on a
    CPU tensor, which runs the plain version and launches nothing."""
    jg = jgraph.TannerGraph(_spec(small_codes, highq_codes, code))
    _, U = random_u(jg, B=8, seed=37)
    want = np.asarray(tems_cn_update_bl_pallas(jnp.asarray(U), jg, offset=0.1, n_r=n_r,
                                               interpret=True))
    launches, calls = cn_tems.cn_update.launches, cn_tems.cn_update_plain.calls
    got = cn_tems.cn_update(torch.from_numpy(U), 0.1, n_r).numpy()
    assert cn_tems.cn_update.launches == launches
    assert cn_tems.cn_update_plain.calls == calls + 1
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("code,n_r", [("gf16_tiny", 0), ("gf16_tiny", 8), ("q64", 8)])
def test_plain_matches_jax_kernel_interpret_on_ties(small_codes, highq_codes, code, n_r):
    """Tie-heavy U (multiples of 1.5 from 4 levels, so every argmax, top-3
    column and n_r round meets ties): the port's plain check node equals the
    JAX K5 in interpret mode bit for bit, so the card's exactness against
    the plain version is exactness against JAX on ties."""
    jg = jgraph.TannerGraph(_spec(small_codes, highq_codes, code))
    rng = np.random.default_rng(11)
    Vv = (rng.integers(0, 4, (jg.n, jg.dv_max, jg.q, 8)) * 1.5).astype(np.float32)
    U = np.array(jg.gather_cn_x_bl(jnp.asarray(Vv)))
    want = np.asarray(tems_cn_update_bl_pallas(jnp.asarray(U), jg, offset=2.0, n_r=n_r,
                                               interpret=True))
    got = cn_tems.cn_update_plain(torch.from_numpy(U), 2.0, n_r).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


MODES = {"early_term": dict(early_term=True),
         "throughput": dict(early_term=False, stats_each_iter=False)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("code,n_r", [("gf16_tiny", 0), ("gf4_dv3", 0), ("gf16_irr", 0),
                                      ("q64", 8)])
def test_decode_matches_jax(small_codes, highq_codes, code, n_r, mode):
    spec = _spec(small_codes, highq_codes, code)
    _, llr = noisy_llrs(spec, 12, 3.0, seed=5)
    kw = dict(max_iters=6, offset=0.5, n_r=n_r, **MODES[mode])
    ref = jtems.decode(jgraph.TannerGraph(spec), jnp.asarray(llr), use_pallas="no", **kw)
    calls = cn_tems.cn_update_plain.calls
    res = tems.decode(port_graph(spec), torch.from_numpy(llr), cn_impl="torch", **kw)
    assert cn_tems.cn_update_plain.calls > calls
    np.testing.assert_array_equal(res.hard.numpy(), np.asarray(ref.hard))
    np.testing.assert_array_equal(res.done.numpy(), np.asarray(ref.done))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    assert res.hard.dtype == torch.int32 and res.iters.dtype == torch.int32


@pytest.mark.parametrize("code,n_r", [("gf16_tiny", 0), ("gf16_tiny", 4), ("q64", 8)])
def test_messages_one_iter_match_oracle(small_codes, highq_codes, code, n_r):
    """Check->variable messages after one iteration, c-domain, at 2e-3."""
    spec = _spec(small_codes, highq_codes, code)
    _, llr = noisy_llrs(spec, 2, 3.0, seed=41)
    g = port_graph(spec)
    L = torch.from_numpy(llr).permute(1, 2, 0)
    L = L - L.amax(dim=1, keepdim=True)                     # [N, q, B]
    Vv = L[:, None].expand(g.n, g.dv_max, g.q, L.shape[-1])
    Vv = Vv - Vv.amax(dim=2, keepdim=True)
    Chat = tems.tems_cn_update_bl(g.gather_cn_x_bl(Vv.contiguous()), g, 0.0, n_r)
    pu = g.perm_up.long()                                   # C(a) = Chat(h a)
    oracle = OracleDecoder(spec, kind="tems", n_r=n_r)
    for b in range(llr.shape[0]):
        _, _, _, C_o = oracle.decode(llr[b], max_iters=1, early_term=False,
                                     return_messages=True)
        C = torch.gather(Chat[..., b], 2, pu).numpy()
        for mi in range(spec.m):
            for j in range(len(spec.row_cols[mi])):
                np.testing.assert_allclose(C[mi, j], C_o[mi][j], rtol=2e-3, atol=2e-3,
                                           err_msg=f"frame {b} check {mi} slot {j}")


@pytest.mark.parametrize("code,n_r", [("gf4_tiny", 0), ("gf16_tiny", 4)])
def test_channel_helpers_and_noiseless_decode(small_codes, code, n_r):
    spec = small_codes[code]
    enc = Encoder(spec)
    u = np.random.default_rng(3).integers(0, spec.q, size=(3, enc.k)).astype(np.int32)
    cw = np.array(enc.encode(jnp.asarray(u)))          # a writable copy for torch
    llr = tch.perfect_llr(torch.from_numpy(cw), spec.q)
    np.testing.assert_array_equal(llr.numpy(), np.asarray(jch.perfect_llr(jnp.asarray(cw),
                                                                          spec.q)))
    pos, val = [0, 5, 7], [1, spec.q - 1, 2]
    bad = tch.inject_errors(torch.from_numpy(cw), pos, val, spec.q)
    np.testing.assert_array_equal(bad.numpy(),
                                  np.asarray(jch.inject_errors(jnp.asarray(cw), pos, val,
                                                               spec.q)))
    res = tems.decode(port_graph(spec), llr, max_iters=4, n_r=n_r)
    assert bool(res.done.all())
    np.testing.assert_array_equal(res.hard.numpy(), cw)


def test_dispatch_and_refusals(small_codes):
    llr = torch.zeros((2, 4, 16))
    assert tems.pick_impl("auto", llr) == "torch"
    for impl in ("kernel", "torch"):
        assert tems.pick_impl(impl, llr) == impl

    class Cuda:
        # pick_impl reads only the device of the tensor it is given
        device = torch.device("cuda")

    assert tems.pick_impl("auto", Cuda) == "kernel"
    with pytest.raises(ValueError):
        tems.pick_impl("resident", llr)
    with pytest.raises(ValueError, match="device"):
        cn_tems._launch(torch.zeros((2, 4, 16, 8)), 0.0, 0)   # the kernel takes no CPU tensor
    with pytest.raises(ValueError, match="dc >= 3"):
        tems.tems_cn_update_bl(torch.zeros((3, 2, 16, 4)))
    dc2 = port_graph(make_peg_code(8, 4, 16, dv=1, seed=1))
    assert dc2.dc_max == 2
    with pytest.raises(ValueError, match="dc >= 3"):
        tems.decode(dc2, torch.zeros((2, dc2.n, 16)))


def test_cli_run_gf64_tems_config_cpu(tmp_path):
    rep = tmp_path / "rep.json"
    calls = cn_tems.cn_update_plain.calls
    rc = cli.main(["run", "--config", str(ROOT / "configs" / "gf64_tems_earlyterm.json"),
                   "--device", "cpu", "--snr", "3.0", "4.5", "--iters", "2", "--frames", "16",
                   "--set", "sim.frames_per_step=16", "--report", str(rep)])
    assert rc == 0
    assert cn_tems.cn_update_plain.calls > calls
    got = json.loads(rep.read_text())
    assert got["frames"] == [16, 16]
    assert got["config"]["decoder"]["kind"] == "tems"
    assert got["config"]["decoder"]["tems_nr"] == 8
    assert all(0.0 <= f <= 1.0 for f in got["fer"])
    assert all(0.0 <= a <= 2.0 for a in got["avg_iters"])
