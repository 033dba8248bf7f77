"""The port's sim engine, CLI, configs and checkpoints against the JAX
package's formats; the port imports no JAX."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nbldpc_tpu.channel as jch
import nbldpc_tpu.graph as jgraph
import nbldpc_tpu.sim as jsim
import nbldpc_tpu.utils.config as jcfg
from nbldpc_tpu.codegen import make_peg_code
from nbldpc_tpu.encode import Encoder as JaxEncoder
from nbldpc_tpu.utils.report import sweep_report as jax_sweep_report

from nbldpc_tpu_torch import cli, sim
from nbldpc_tpu_torch.encode import Encoder
from nbldpc_tpu_torch.code import save_alist
from nbldpc_tpu_torch.utils import config as tcfg

from tests.test_torch_qspa import port_graph

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny_alist(tmp_path_factory):
    from nbldpc_tpu.code import save_alist as jax_save_alist

    path = tmp_path_factory.mktemp("codes") / "tiny.alist"
    jax_save_alist(make_peg_code(16, 8, 4, dv=2, seed=5), path)
    return path


def _cfg(mod, path, ckpt=None):
    """The same tiny RunConfig in either package's dataclasses."""
    return mod.RunConfig(
        code=mod.CodeConfig(path=str(path)),
        decoder=mod.DecoderConfig(kind="qspa", max_iters=4),
        channel=mod.ChannelConfig(ebn0_db=(2.0,)),
        sim=mod.SimConfig(frames_per_step=16, max_frames=64, max_frame_errors=10**9,
                          seed=9, checkpoint_path=str(ckpt) if ckpt else None,
                          checkpoint_every=1),
    )


def test_cli_run_cpu_writes_jax_report_keys(tiny_alist, tmp_path):
    rep = tmp_path / "rep.json"
    rc = cli.main(["run", "--code", str(tiny_alist), "--snr", "1.0", "3.0",
                   "--iters", "4", "--frames", "32", "--set", "sim.frames_per_step=16",
                   "--device", "cpu", "--report", str(rep)])
    assert rc == 0
    got = json.loads(rep.read_text())
    jres = jsim.SweepResult(ebn0_db=[1.0, 3.0], counters=jsim.Counters.zeros(2),
                            wall_seconds=1.0, steps=1).finalize(16, 2)
    want = jax_sweep_report(jres, jcfg.RunConfig())
    assert set(got) == set(want)
    assert set(got["config"]) == set(want["config"])
    assert got["frames"] == [32, 32]
    assert got["steps"] == 2
    assert got["frame_errors"][0] >= got["frame_errors"][1]


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "configs").glob("*.json")))
def test_config_hash_equal_across_packages(name):
    path = ROOT / "configs" / name
    a, b = tcfg.load_config(path), jcfg.load_config(path)
    assert a.config_hash() == b.config_hash()
    over = ["decoder.max_iters=50", "channel.ebn0_db=[1.0,2.0]"]
    assert (tcfg.apply_overrides(a, over).config_hash()
            == jcfg.apply_overrides(b, over).config_hash())
    assert tcfg.RunConfig().config_hash() == jcfg.RunConfig().config_hash()


def test_jax_checkpoint_resumes_in_port(tiny_alist, tmp_path):
    ckpt = tmp_path / "sweep.ckpt"
    jcfg_run = _cfg(jcfg, tiny_alist, ckpt)

    def killer(t, counters):
        if t >= 2:
            raise KeyboardInterrupt    # crash in macro-batch 2 of 4

    with pytest.raises(KeyboardInterrupt):
        jsim.run_sweep(jcfg_run, mesh=None, progress=killer)
    saved = json.loads(ckpt.read_text())
    assert saved["step"] == 1

    tcfg_run = _cfg(tcfg, tiny_alist, ckpt)
    assert tcfg_run.config_hash() == jcfg_run.config_hash()
    res = sim.run_sweep(tcfg_run, device="cpu")
    assert res.steps == 3                          # resumed at t = 1
    assert res.counters.frames.tolist() == [64]
    for k in ("frame_errors", "symbol_errors", "bit_errors", "iter_sum"):
        assert getattr(res.counters, k)[0] >= saved["counters"][k][0]


def test_port_kill_and_resume_exact(tiny_alist, tmp_path):
    ref = sim.run_sweep(_cfg(tcfg, tiny_alist), device="cpu")
    cfg = _cfg(tcfg, tiny_alist, tmp_path / "sweep.ckpt")

    def killer(t, counters):
        if t >= 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        sim.run_sweep(cfg, device="cpu", progress=killer)
    resumed = sim.run_sweep(cfg, device="cpu")
    assert resumed.steps < ref.steps
    assert resumed.counters.asdict() == ref.counters.asdict()

    other = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, max_iters=5))
    with pytest.raises(ValueError, match="different config"):
        sim.run_sweep(other, device="cpu")


def test_finished_snr_slots_reallocated(tiny_alist):
    cfg = dataclasses.replace(
        _cfg(tcfg, tiny_alist),
        channel=tcfg.ChannelConfig(ebn0_db=(-4.0, 6.0)),
        sim=tcfg.SimConfig(frames_per_step=16, max_frames=96, max_frame_errors=3, seed=1),
    )
    res = sim.run_sweep(cfg, device="cpu")
    # point 0 stops on errors within a step; point 1 then gets all slots
    assert res.counters.frame_errors[0] >= 3
    assert res.counters.frames.sum() == res.steps * 2 * 16
    assert res.counters.frames[1] >= 96 or res.counters.frame_errors[1] >= 3


def test_sim_step_counts_and_generator(small_codes):
    g = port_graph(small_codes["gf16_tiny"])
    dec = tcfg.DecoderConfig(kind="qspa", max_iters=4)
    step = sim.make_sim_step(g, dec, batch_per_snr=8, n_snr=2)
    sig = torch.tensor([1.2, 0.3])
    a = sim.fetch(step(sim.step_generator(3, 7, "cpu"), sig))
    b = sim.fetch(step(sim.step_generator(3, 7, "cpu"), sig))
    assert {k: v.tolist() for k, v in a.items()} == {k: v.tolist() for k, v in b.items()}
    assert a["frames"].tolist() == [8, 8]
    assert np.all(a["converged"] <= 8) and np.all(a["bit_errors"] >= a["symbol_errors"])
    r_step = sim.make_sim_step(g, dec, 8, 2, Encoder(g.spec, "cpu"))
    r = sim.fetch(r_step(sim.step_generator(3, 7, "cpu"), sig))
    assert r["frames"].tolist() == [8, 8] and np.all(r["converged"] <= 8)
    t_step =sim.make_sim_step(g, dataclasses.replace(dec, kind="tems", tems_nr=4), 8, 2)
    t = sim.fetch(t_step(sim.step_generator(3, 7, "cpu"), sig))
    assert set(t) == set(a)
    assert all(v.shape == (2,) for v in t.values())
    assert t["frames"].tolist() == [8, 8]
    assert np.all(t["converged"] <= 8) and np.all(t["bit_errors"] >= t["symbol_errors"])


def test_cli_refusals(tiny_alist, monkeypatch):
    base = ["run", "--code", str(tiny_alist), "--frames", "16"]
    monkeypatch.setenv("NBLDPC_NUM_PROCS", "2")      # a group named by half an environment
    with pytest.raises(ValueError, match="NBLDPC_NUM_PROCS set without"):
        cli.main(base + ["--mesh-snr", "2", "--device", "cpu"])
    monkeypatch.delenv("NBLDPC_NUM_PROCS")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(base + ["--device", "cuda"])
    with pytest.raises(KeyError, match="no_such_code"):
        tcfg.CodeConfig(name="no_such_code").load()
    with pytest.raises(KeyError, match="no_such_code"):
        jcfg.CodeConfig(name="no_such_code").load()


def test_port_imports_no_jax():
    """Every module of the port imports with jax and nbldpc_tpu blocked."""
    code = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'nbldpc_tpu'):
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
import nbldpc_tpu_torch
for m in pkgutil.walk_packages(nbldpc_tpu_torch.__path__, 'nbldpc_tpu_torch.'):
    if m.name != 'nbldpc_tpu_torch.__main__':
        importlib.import_module(m.name)
importlib.import_module('chip_smoke')
bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'nbldpc_tpu')]
assert not bad, bad
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_save_alist_roundtrip(small_codes, tmp_path):
    from nbldpc_tpu_torch.code import load_alist

    g = port_graph(small_codes["gf16_irr"])
    save_alist(g.spec, tmp_path / "irr.alist")
    back = load_alist(tmp_path / "irr.alist")
    np.testing.assert_array_equal(back.dense_h(), g.spec.dense_h())


def _random_cfg(cfg):
    return dataclasses.replace(cfg, channel=dataclasses.replace(cfg.channel, zero_codeword=False))


# (code, decoder fields, sigmas): QSPA on three conftest codes; classic EMS
# at GF(256) with nm 16 < q, where the truncated operands' fill values tie
@pytest.mark.parametrize("code,dec,sigmas", [
    ("gf4_tiny", {"kind": "qspa"}, (0.95, 0.7)), ("gf16_tiny", {"kind": "qspa"}, (0.95, 0.7)),
    ("gf16_irr", {"kind": "qspa"}, (0.95, 0.7)),
    ("gf256_12", {"kind": "ems", "nm": 16, "offset": 0.1}, (0.8, 0.55))])
def test_random_codeword_step_matches_jax(small_codes, code, dec, sigmas):
    """One random-codeword step on numpy info symbols and noise equals the
    JAX composition on the same arrays (Encoder.encode -> modulate -> AWGN
    -> llr_init -> decode -> counters), counter for counter."""
    spec = (make_peg_code(12, 6, 256, dv=2, seed=3) if code == "gf256_12"
            else small_codes[code])
    g = port_graph(spec)
    S, B, q, N, p = 2, 24, g.q, g.n, g.gf.p
    step = sim.make_sim_step(g, tcfg.DecoderConfig(max_iters=6, **dec), B, S,
                             encoder=Encoder(g.spec, "cpu"))
    rng = np.random.default_rng(21)
    k = spec.n - spec.m
    u = rng.integers(0, q, size=(S, B, k)).astype(np.int32)
    noise = rng.standard_normal((S, B, N, p)).astype(np.float32)
    sig = np.asarray(sigmas, np.float32)
    got = sim.fetch(step.frames(torch.from_numpy(sig), torch.from_numpy(noise),
                                torch.from_numpy(u)))

    cw = JaxEncoder(spec).encode(jnp.asarray(u))
    s4 = jnp.asarray(sig)[:, None, None, None]
    llr = jch.llr_init(jch.modulate(cw, q) + s4 * jnp.asarray(noise), s4, q)
    res = jsim.get_decode_fn(jcfg.DecoderConfig(max_iters=6, **dec))(
        jgraph.TannerGraph(spec), llr.reshape(S * B, N, q))
    diff = np.asarray(res.hard).reshape(S, B, N) ^ np.asarray(cw)
    want = {"frames": [B] * S,
            "frame_errors": (diff != 0).any(axis=-1).sum(axis=1),
            "symbol_errors": (diff != 0).sum(axis=(1, 2)),
            "bit_errors": sum((diff >> t) & 1 for t in range(p)).sum(axis=(1, 2)),
            "iter_sum": np.asarray(res.iters).reshape(S, B).sum(axis=1),
            "converged": np.asarray(res.done).reshape(S, B).sum(axis=1)}
    assert {k_: v.tolist() for k_, v in got.items()} == {
        k_: np.asarray(v).tolist() for k_, v in want.items()}
    assert 0 < got["frame_errors"].sum() < S * B        # some frames fail, some decode
    assert (np.asarray(cw) != 0).any()


def test_random_codeword_sweep_counts_frames(tiny_alist):
    cfg = _random_cfg(_cfg(tcfg, tiny_alist))
    res = sim.run_sweep(cfg, device="cpu")
    assert res.counters.frames.tolist() == [64]
    assert res.steps == 4
    zero = sim.run_sweep(_cfg(tcfg, tiny_alist), device="cpu")
    assert res.counters.asdict() != zero.counters.asdict()


def test_random_codeword_kill_and_resume_exact(tiny_alist, tmp_path):
    ref = sim.run_sweep(_random_cfg(_cfg(tcfg, tiny_alist)), device="cpu")
    cfg = _random_cfg(_cfg(tcfg, tiny_alist, tmp_path / "sweep.ckpt"))

    def killer(t, counters):
        if t >= 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        sim.run_sweep(cfg, device="cpu", progress=killer)
    resumed = sim.run_sweep(cfg, device="cpu")
    assert resumed.steps < ref.steps
    assert resumed.counters.asdict() == ref.counters.asdict()


def _wilson(k: int, n: int, z: float = 3.29) -> tuple:
    """The Wilson score interval of k successes in n trials (z 3.29: 99.9%)."""
    p = k / n
    mid = (p + z * z / (2 * n)) / (1 + z * z / n)
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / (1 + z * z / n)
    return mid - half, mid + half


def test_random_codeword_fer_agrees_with_zero_codeword(tiny_alist):
    """Channel and decoder symmetry: on the same code and noise level the
    two modes' FER agree within Wilson intervals, at two Eb/N0 points."""
    base = dataclasses.replace(
        _cfg(tcfg, tiny_alist), channel=tcfg.ChannelConfig(ebn0_db=(1.0, 3.0)),
        sim=tcfg.SimConfig(frames_per_step=512, max_frames=2048, max_frame_errors=10**9,
                           seed=4))
    zero = sim.run_sweep(base, device="cpu").counters
    rand = sim.run_sweep(_random_cfg(base), device="cpu").counters
    for i in range(2):
        lo_z, hi_z = _wilson(int(zero.frame_errors[i]), int(zero.frames[i]))
        lo_r, hi_r = _wilson(int(rand.frame_errors[i]), int(rand.frames[i]))
        assert lo_z <= hi_r and lo_r <= hi_z, (i, zero.asdict(), rand.asdict())
    assert rand.frame_errors[0] > rand.frame_errors[1] > 0


def test_cli_run_random_codewords_cpu(tmp_path):
    rep = tmp_path / "rep.json"
    rc = cli.main(["run", "--code", "gf4_n96_k48", "--random-codewords", "--snr", "2.0",
                   "--iters", "5", "--frames", "64", "--set", "sim.frames_per_step=32",
                   "--device", "cpu", "--report", str(rep)])
    assert rc == 0
    got = json.loads(rep.read_text())
    assert got["frames"] == [64] and got["config"]["channel"]["zero_codeword"] is False
