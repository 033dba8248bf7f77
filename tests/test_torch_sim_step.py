"""The sim step's work around the decode (kernels/sim_step.py's plain
versions: the channel, decode_bl's entry, the error counters) against the
JAX package on the same numpy draws, and make_sim_step's steps against the
composition of PyTorch ops the wrappers replaced."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbldpc_tpu.channel as jch
from nbldpc_tpu.codegen import make_peg_code

from nbldpc_tpu_torch import sim
from nbldpc_tpu_torch.channel import llr_init, modulate
from nbldpc_tpu_torch.decoders.common import argmax_q
from nbldpc_tpu_torch.encode import Encoder
from nbldpc_tpu_torch.kernels import sim_step
from nbldpc_tpu_torch.utils import config as tcfg

from tests.test_torch_qspa import port_graph

torch.set_num_threads(1)

QS = (2, 4, 16, 64, 256)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same float32 bit patterns (signed zeros included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _channel_draws(q: int, S: int, B: int, N: int, seed: int):
    """(noise [S, B, N, p], sig [S], codewords [S, B, N]) from a numpy seed."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((S, B, N, q.bit_length() - 1)).astype(np.float32)
    sig = rng.uniform(0.5, 1.1, S).astype(np.float32)
    return noise, sig, rng.integers(0, q, (S, B, N)).astype(np.int32)


# --- the channel ---------------------------------------------------------------

@pytest.mark.parametrize("codeword", [False, True])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("q", QS)
def test_channel_llr_plain_matches_jax(q, S, codeword):
    """JAX's step (nbldpc_tpu/sim.py:151-152): llr_init(x + sig noise), x the
    BPSK of the codeword (all ones for the zero codeword)."""
    noise, sig, cw = _channel_draws(q, S, 5, 7, seed=10 * q + S)
    got = sim_step.channel_llr_plain(torch.from_numpy(noise), torch.from_numpy(sig), q,
                                     torch.from_numpy(cw) if codeword else None)
    s4 = jnp.asarray(sig)[:, None, None, None]
    x = jch.modulate(jnp.asarray(cw), q) if codeword else jnp.ones(noise.shape, jnp.float32)
    want = np.asarray(jch.llr_init(x + s4 * jnp.asarray(noise), s4, q))
    assert got.shape == want.shape == (S, 5, 7, q) and got.dtype == torch.float32
    # f32 sums of p terms, in possibly different order: a few ulp
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("codeword", [False, True])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("q", QS)
def test_channel_llr_plain_is_the_former_composition(q, S, codeword):
    """Bit for bit the port's channel as make_sim_step composed it before:
    llr_init(1.0 + sig noise) or llr_init(modulate(cw) + sig noise)."""
    noise, sig, cw = _channel_draws(q, S, 4, 9, seed=20 * q + S)
    noise_t, cw_t = torch.from_numpy(noise), torch.from_numpy(cw)
    got = sim_step.channel_llr_plain(noise_t, torch.from_numpy(sig), q,
                                     cw_t if codeword else None)
    s4 = torch.from_numpy(sig).to(torch.float32)[:, None, None, None]
    y = modulate(cw_t, q) + s4 * noise_t if codeword else 1.0 + s4 * noise_t
    assert _bits_equal(got, llr_init(y, s4, q))


# --- decode_bl's entry ---------------------------------------------------------

@pytest.mark.parametrize("q", QS)
def test_prior_bl_plain_matches_jax(q):
    """JAX's decode_bl entry (nbldpc_tpu/decoders/common.py:200-203): the
    transpose to [N, q, B], llr - max over q, and the argmax, on rows with
    ties (a frame of equal values, a frame of integer values)."""
    rng = np.random.default_rng(q)
    llr = (rng.standard_normal((6, 9, q)) * 4.0).astype(np.float32)
    llr[1] = np.round(llr[1] / 4.0)                         # ties within rows
    llr[2, 3] = 1.5                                         # a row of one value
    prior, hard = sim_step.prior_bl_plain(torch.from_numpy(llr))
    j = jnp.transpose(jnp.asarray(llr), (1, 2, 0))
    j = j - jnp.max(j, axis=1, keepdims=True)
    np.testing.assert_array_equal(prior.numpy(), np.asarray(j))
    np.testing.assert_array_equal(hard.numpy(), np.asarray(jnp.argmax(j, axis=1)))
    assert prior.shape == (9, q, 6) and prior.is_contiguous() and hard.dtype == torch.int32
    assert torch.equal(hard, argmax_q(prior))


# --- the error counters --------------------------------------------------------

def _decisions(q: int, S: int, B: int, N: int, seed: int, codeword: bool):
    """(hard [S B, N], cw [S, B, N] (zeros without a codeword), iters [S B],
    done [S B]): errors on a fifth of the symbols, frame 0 of every slot
    all right and frame 1 all wrong."""
    rng = np.random.default_rng(seed)
    cw = (rng.integers(0, q, (S, B, N)) if codeword else np.zeros((S, B, N))).astype(np.int32)
    err = np.where(rng.random((S, B, N)) < 0.2, rng.integers(1, q, (S, B, N)), 0)
    err[:, 0] = 0
    err[:, 1] = rng.integers(1, q, (S, N))
    hard = (cw ^ err).astype(np.int32).reshape(S * B, N)
    iters = rng.integers(0, 21, S * B).astype(np.int32)
    return hard, cw, iters, rng.random(S * B) < 0.5


@pytest.mark.parametrize("codeword", [False, True])
@pytest.mark.parametrize("q,S", [(2, 1), (4, 3), (16, 3), (64, 1), (256, 3)])
def test_count_errors_plain_matches_jax(q, S, codeword):
    """The counter lines of JAX's step (nbldpc_tpu/sim.py:153-167), written
    out on the same arrays."""
    B, N, p = 6, 11, q.bit_length() - 1
    hard, cw, iters, done = _decisions(q, S, B, N, seed=q + S, codeword=codeword)
    got = sim_step.count_errors_plain(
        torch.from_numpy(hard), torch.from_numpy(cw) if codeword else None,
        torch.from_numpy(iters), torch.from_numpy(done), S, B, p)

    jh, jcw = jnp.asarray(hard).reshape(S, B, N), jnp.asarray(cw)
    sym_err = (jh != jcw).astype(jnp.int32)
    x = jh ^ jcw
    bit_err = sum(((x >> t) & 1) for t in range(p))
    want = {"frames": jnp.full((S,), B, jnp.int32),
            "frame_errors": jnp.sum(jnp.any(sym_err > 0, axis=-1), axis=1),
            "symbol_errors": jnp.sum(sym_err, axis=(1, 2)),
            "bit_errors": jnp.sum(bit_err, axis=(1, 2)),
            "iter_sum": jnp.sum(jnp.asarray(iters).reshape(S, B), axis=1),
            "converged": jnp.sum(jnp.asarray(done).reshape(S, B).astype(jnp.int32), axis=1)}
    assert list(got) == list(sim_step.COUNTERS)
    assert all(v.dtype == torch.int64 and v.shape == (S,) for v in got.values())
    assert {k: v.tolist() for k, v in got.items()} == {
        k: np.asarray(v).tolist() for k, v in want.items()}
    assert all(0 < f < B for f in got["frame_errors"].tolist())


# --- B = 0 and the wrappers on the CPU -------------------------------------------

def test_zero_frames():
    S, N, q, p = 2, 7, 16, 4
    noise = torch.zeros((S, 0, N, p))
    sig = torch.ones(S)
    for fn in (sim_step.channel_llr, sim_step.channel_llr_plain):
        assert fn(noise, sig, q).shape == (S, 0, N, q)
        assert fn(noise, sig, q, torch.zeros((S, 0, N), dtype=torch.int32)).shape == \
            (S, 0, N, q)
    for fn in (sim_step.prior_bl, sim_step.prior_bl_plain):
        prior, hard = fn(torch.zeros((0, N, q)))
        assert prior.shape == (N, q, 0) and hard.shape == (N, 0)
    empty = torch.zeros((0, N), dtype=torch.int32)
    for fn in (sim_step.count_errors, sim_step.count_errors_plain):
        got = fn(empty, None, torch.zeros(0, dtype=torch.int32),
                 torch.zeros(0, dtype=torch.bool), S, 0, p)
        assert {k: v.tolist() for k, v in got.items()} == {k: [0, 0] for k in sim_step.COUNTERS}


def _outputs(out) -> list:
    """A wrapper's output tensors: a dict's values, a tuple, or one tensor."""
    if isinstance(out, dict):
        return list(out.values())
    return list(out) if isinstance(out, tuple) else [out]


def test_wrappers_on_cpu_run_the_plain_versions():
    """On CPU tensors each wrapper runs its plain version (counted as a call)
    and launches nothing."""
    q, S, B, N = 16, 2, 3, 5
    noise, sig, cw = (torch.from_numpy(a) for a in _channel_draws(q, S, B, N, seed=1))
    hard, _, iters, done = (torch.from_numpy(a)
                            for a in _decisions(q, S, B, N, seed=2, codeword=False))
    pairs = [(sim_step.channel_llr, sim_step.channel_llr_plain, (noise, sig, q, cw)),
             (sim_step.prior_bl, sim_step.prior_bl_plain, (noise.reshape(S * B, N, 4),)),
             (sim_step.count_errors, sim_step.count_errors_plain,
              (hard, cw, iters, done, S, B, 4))]
    for kern, plain, args in pairs:
        launches, calls = kern.launches, plain.calls
        got = kern(*args)
        assert (kern.launches, plain.calls) == (launches, calls + 1)
        want = plain(*args)
        for a, b in zip(_outputs(got), _outputs(want), strict=True):
            assert torch.equal(a, b)


# --- the whole step --------------------------------------------------------------

def _former_frames(graph, decode_fn, encoder, sigmas, noise, u=None) -> dict:
    """make_sim_step's frames() as PyTorch ops, before kernels/sim_step.py."""
    S, B = noise.shape[:2]
    N, p, q = graph.n, graph.gf.p, graph.q
    sig = sigmas.to(torch.float32)[:, None, None, None]
    if u is None:
        cw = None
        y = 1.0 + sig * noise
    else:
        cw = encoder.encode(u)
        y = modulate(cw, q) + sig * noise
    llr = llr_init(y, sig, q)
    res = decode_fn(graph, llr.reshape(S * B, N, q))
    diff = res.hard.reshape(S, B, N)
    if cw is not None:
        diff = diff ^ cw
    sym_err = diff != 0
    bit_err = sum(((diff >> t) & 1) for t in range(p))
    return {
        "frames": torch.full((S,), B, dtype=torch.int64),
        "frame_errors": sym_err.any(dim=-1).sum(dim=1),
        "symbol_errors": sym_err.sum(dim=(1, 2)),
        "bit_errors": bit_err.sum(dim=(1, 2), dtype=torch.int64),
        "iter_sum": res.iters.reshape(S, B).sum(dim=1, dtype=torch.int64),
        "converged": res.done.reshape(S, B).sum(dim=1),
    }


# (decoder fields, code (n, m, q), sigmas): QSPA, EMS and T-EMS, each with
# early termination, on codes where some frames fail and some decode
STEP_DECODERS = [
    ({"kind": "qspa", "max_iters": 6}, (16, 8, 16), (0.95, 0.7)),
    ({"kind": "ems", "max_iters": 6, "nm": 8, "offset": 0.3}, (16, 8, 16), (0.95, 0.7)),
    ({"kind": "tems", "max_iters": 6, "offset": 2.0}, (24, 12, 4), (1.1, 0.8)),
]


def _step_counters(out: dict) -> dict:
    return {k: v.tolist() for k, v in out.items()}


@pytest.mark.parametrize("random_cw", [False, True])
@pytest.mark.parametrize("dec,code,sigmas", STEP_DECODERS,
                         ids=[d[0]["kind"] for d in STEP_DECODERS])
def test_step_counters_equal_the_former_composition(dec, code, sigmas, random_cw):
    """make_sim_step's step and its frames() on a fixed generator seed: the
    counters of the composition the wrappers replaced, counter for counter."""
    n, m, q = code
    spec = make_peg_code(n, m, q, dv=2, seed=3)
    g = port_graph(spec)
    S, B = len(sigmas), 24
    enc = Encoder(g.spec, "cpu") if random_cw else None
    cfg = tcfg.DecoderConfig(**dec)
    step = sim.make_sim_step(g, cfg, B, S, enc)
    decode_fn = sim.get_decode_fn(cfg)
    sig = torch.tensor(sigmas, dtype=torch.float32)

    got = step(sim.step_generator(5, 0, "cpu"), sig)
    gen = sim.step_generator(5, 0, "cpu")
    noise = torch.randn((S, B, g.n, g.gf.p), generator=gen)
    u = None if enc is None else torch.randint(0, q, (S, B, enc.k), generator=gen,
                                               dtype=torch.int32)
    want = _former_frames(g, decode_fn, enc, sig, noise, u)
    assert _step_counters(got) == _step_counters(want)
    assert _step_counters(step.frames(sig, noise, u)) == _step_counters(want)
    assert 0 < sum(want["frame_errors"].tolist()) < S * B


def test_step_on_a_layout_block_equals_the_former_composition():
    """A layout's block (slots 1-2, frames 8-15 of [3, 24]): the noise slice
    is not contiguous; the block's counters equal the composition's on it."""
    spec = make_peg_code(16, 8, 16, dv=2, seed=3)
    g = port_graph(spec)
    cfg = tcfg.DecoderConfig(kind="qspa", max_iters=6)
    block = (slice(1, 3), slice(8, 16))
    step = sim.make_sim_step(g, cfg, 24, 3, block=block)
    sig = torch.tensor([1.2, 0.95, 0.7], dtype=torch.float32)
    got = step(sim.step_generator(9, 0, "cpu"), sig)
    noise = torch.randn((3, 24, g.n, g.gf.p), generator=sim.step_generator(9, 0, "cpu"))
    want = _former_frames(g, sim.get_decode_fn(cfg), None, sig[block[0]],
                          noise[block].contiguous())
    assert _step_counters(got) == _step_counters(want)
    assert got["frames"].tolist() == [8, 8]
