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


# --- frame retirement: the T-EMS check node computes only undone frames ------

RETIRE_CASES = [("gf16_tiny", 0), ("gf16_tiny", 8), ("q64", 0), ("q64", 8)]


def _mixed_llrs(spec):
    """16 frames, half at 1.0 dB and half at 4.0 dB, interleaved, so that
    frames retire at different iterations and some never do."""
    lo, hi = noisy_llrs(spec, 8, 1.0, seed=3)[1], noisy_llrs(spec, 8, 4.0, seed=4)[1]
    return torch.from_numpy(np.stack([lo, hi], axis=1).reshape(16, *lo.shape[1:]))


@pytest.mark.parametrize("code,n_r", RETIRE_CASES)
def test_retired_decode_equals_full_width(small_codes, highq_codes, code, n_r, monkeypatch):
    """decode_bl with its frame list returns what it does with none (the
    check node at full width every iteration), and the check node computes
    exactly the frame-iterations that `iters` counts."""
    from nbldpc_tpu_torch.decoders import common

    g = port_graph(_spec(small_codes, highq_codes, code))
    llr = _mixed_llrs(_spec(small_codes, highq_codes, code))
    cn = lambda U, _g, active, out: cn_tems.cn_update_plain(U, 0.5, n_r, active, out)
    before = cn_tems.cn_update.frame_iterations
    got = common.decode_bl(g, llr, cn, 12, early_term=True)
    counted = cn_tems.cn_update.frame_iterations - before
    monkeypatch.setattr(common, "active_frames", lambda done, n_active: None)
    ref = common.decode_bl(g, llr, cn, 12, early_term=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    iters = got.iters
    assert len(set(iters.tolist())) >= 3                  # frames retire at different times
    assert counted == int(iters.sum()) < 16 * int(iters.max())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("code,n_r", RETIRE_CASES)
def test_cn_tems_frame_iterations_counter(small_codes, highq_codes, code, n_r, mode):
    """tems.decode: the counter equals iters.sum() with early termination,
    and frames x the loop's iterations in the fixed-budget mode (no list)."""
    from nbldpc_tpu_torch.decoders import common
    from nbldpc_tpu_torch.kernels import launch_counts

    spec = _spec(small_codes, highq_codes, code)
    llr = _mixed_llrs(spec)
    before = launch_counts()
    res = tems.decode(port_graph(spec), llr, max_iters=12, offset=0.5, n_r=n_r,
                      cn_impl="torch", **MODES[mode])
    after = launch_counts()
    counted = after["cn_tems.frame_iterations"] - before["cn_tems.frame_iterations"]
    loops = after["decode_bl.loop_iterations"] - before["decode_bl.loop_iterations"]
    assert common.decode_bl.frame_iterations - before["decode_bl.frame_iterations"] \
        == 16 * loops
    if mode == "early_term":
        assert counted == int(res.iters.sum()) < 16 * loops
    else:
        assert counted == 16 * loops == 16 * 12


@pytest.mark.parametrize("pattern", ["none_done", "all_done", "one_left", "mixed"])
def test_active_frames_lists_the_frames_not_done(pattern):
    from nbldpc_tpu_torch.decoders import common

    B = 37
    done = {"none_done": torch.zeros(B, dtype=torch.bool),
            "all_done": torch.ones(B, dtype=torch.bool),
            "one_left": torch.arange(B) != 29,
            "mixed": torch.from_numpy(np.random.default_rng(2).random(B) < 0.6)}[pattern]
    n_active = int((~done).sum())
    got = common.active_frames(done, n_active)
    assert got.dtype == torch.int32 and got.shape == (n_active,)
    assert torch.equal(got, torch.nonzero(~done).flatten().to(torch.int32))


@pytest.mark.parametrize("fill", [7.0, None])
@pytest.mark.parametrize("share", [1.0, 0.4, 0.03, 0.0])
@pytest.mark.parametrize("code,n_r", RETIRE_CASES)
def test_plain_cn_with_a_list_writes_only_its_columns(small_codes, highq_codes, code, n_r,
                                                      share, fill):
    """The plain check node with a frame list: the listed columns of `out`
    equal the full-width update's, every other column keeps its value
    (zeros where no `out` is given)."""
    jg = jgraph.TannerGraph(_spec(small_codes, highq_codes, code))
    U = torch.from_numpy(random_u(jg, B=40, seed=9)[1])
    rng = np.random.default_rng(int(share * 100))
    active = torch.from_numpy(np.flatnonzero(rng.random(40) < share).astype(np.int32))
    if share == 1.0:
        assert active.numel() == 40
    full = cn_tems.cn_update_plain(U, 2.0, n_r)
    out = None if fill is None else torch.full_like(U, fill)
    before = cn_tems.cn_update.frame_iterations
    got = cn_tems.cn_update(U, 2.0, n_r, active, out)            # a CPU tensor: plain
    assert got is out if out is not None else got.shape == U.shape
    assert cn_tems.cn_update.frame_iterations == before + active.numel()
    listed = torch.zeros(40, dtype=torch.bool)
    listed[active.long()] = True
    assert torch.equal(got[..., listed], full[..., listed])
    assert bool((got[..., ~listed] == (fill or 0.0)).all())


def test_plain_cn_without_a_list_ignores_out():
    U = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 4, 16, 8))
                         .astype(np.float32))
    out = torch.full_like(U, 7.0)
    got = cn_tems.cn_update_plain(U, 0.0, 0, None, out)
    assert got is not out and bool((out == 7.0).all())
    assert torch.equal(got, cn_tems.cn_update_plain(U, 0.0, 0))


def test_frame_list_refusals():
    U = torch.zeros((2, 4, 16, 8))
    for bad in (torch.arange(3), torch.zeros((1, 3), dtype=torch.int32),
                torch.arange(9, dtype=torch.int32)):
        with pytest.raises(ValueError, match="active"):
            cn_tems.cn_update_plain(U, 0.0, 0, bad, torch.empty_like(U))


@pytest.mark.parametrize("launches,value", [
    ({"cn_tems": 10, "cn_tems.frame_iterations": 160}, 50.0),     # 80 of 160
    ({"cn_tems": 10, "cn_tems.frame_iterations": 80}, 100.0),
    ({"cn_tems": 10}, None),                                       # no counter: the parent
    ({"qspa_resident": 10, "cn_tems.frame_iterations": 0}, None),  # a path without K5
])
def test_k5_useful_share_reader(launches, value):
    from portbench import manifest

    counters = np.zeros((2, 6, 4), np.int64)
    counters[:, 4] = 10                                            # iter_sum: 80 in all
    got = manifest.load_reader("k5_useful_share")({"counters": counters, "S": 4, "B": 4,
                                                   "launches": launches})
    assert got == (None if value is None else pytest.approx(value))


@pytest.mark.parametrize("launches,kernels,share", [
    ({"cn_tems.frame_iterations": 160}, {"cn_tems_kernel_64": (2e-3, 10)}, 0.5),   # 160 of 320
    ({"cn_tems.frame_iterations": 320}, {"cn_tems_kernel_64": (2e-3, 10)}, 1.0),
    ({"cn_tems": 10}, {"cn_tems_kernel_64": (2e-3, 10)}, None),    # no counter: the parent
    ({"cn_tems.frame_iterations": 160}, {"k0_kernel": (2e-3, 10)}, None),     # K5 absent
])
def test_k5_frame_roofline_reader(launches, kernels, share):
    """k5_frame_roofline is k5_roofline (every launch charged S B frames)
    times the share of those frames K5 computed."""
    from portbench import bounds, manifest

    ctx = {"launches": launches, "kernels": kernels, "S": 4, "B": 8,
           "shape": bounds.Shape(64, 6, 576, 96, 12, 2, 1152), "decoder": {"tems_nr": 8}}
    got = manifest.load_reader("k5_frame_roofline")(ctx)
    if share is None:
        assert got is None
    else:
        assert got == pytest.approx(share * manifest.load_reader("k5_roofline")(ctx))


def test_traced_cpu_run_reads_k5_useful_share():
    """A tiny traced run of the T-EMS cell on the CPU: the check node
    computed exactly the frame-iterations the window's frames needed."""
    import time

    from portbench import manifest, run

    torch.set_num_threads(4)
    cell = manifest.load_cell("gf64_tems.waterfall")
    out = run.run_cell(cell, 2**31 + 77, 0.01, True, torch.device("cpu"),
                       time.perf_counter(), frames=4, check_steps=1)
    torch.set_num_threads(1)
    metrics = out["result"]["metrics"]
    assert metrics["k5_useful_share"]["value"] == 100.0
    assert metrics["k5_useful_share"]["unit"] == "%"
    assert metrics["decode_bl.loop_useful_share"]["value"] <= 100.0
