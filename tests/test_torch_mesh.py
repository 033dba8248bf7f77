"""The port's multi-process sweep (parallel/, sim.run_sweep under a Layout,
rank-0 checkpoints and reports) on gloo ranks on the CPU.

Determinism contract: the all-reduced counters equal a single process's on
the same device type for every layout, with slot reallocation, in
random-codeword mode and across a resume. Rank workers are spawned from
this module (or are the CLI in subprocesses), join through a file store
and import no JAX: JAX is imported inside the tests that compare with it.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from nbldpc_tpu_torch import cli, sim
from nbldpc_tpu_torch.code import save_alist
from nbldpc_tpu_torch.codegen import make_peg_code
from nbldpc_tpu_torch.encode import Encoder
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.parallel import dist, mesh
from nbldpc_tpu_torch.utils import config as tcfg
from nbldpc_tpu_torch.utils import report
from nbldpc_tpu_torch.utils.checkpoint import Checkpointer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


# ---- running a function on gloo ranks ----

def _rank_main(rank, world, tmp, fn, args):
    torch.set_num_threads(1)
    os.environ.update(NBLDPC_COORDINATOR=f"file://{tmp}/store",
                      NBLDPC_NUM_PROCS=str(world), NBLDPC_PROC_ID=str(rank))
    if not dist.initialize("cpu"):
        raise RuntimeError("dist.initialize joined no group")
    try:
        result = fn(rank, *args)
        bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "nbldpc_tpu")]
        if bad:
            raise RuntimeError(f"a rank worker imported {bad[:3]}")
        Path(tmp, f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    finally:
        tdist.destroy_process_group()


def run_ranks(tmp: Path, world: int, fn, *args) -> list:
    """fn(rank, *args) on `world` spawned gloo ranks joined through
    NBLDPC_COORDINATOR=file://tmp/store; each rank's result, by rank."""
    tmp.mkdir(parents=True, exist_ok=True)
    mp.start_processes(_rank_main, args=(world, str(tmp), fn, args), nprocs=world,
                       join=True, start_method="spawn")
    return [pickle.loads(Path(tmp, f"rank{r}.pkl").read_bytes()) for r in range(world)]


# ---- configurations ----

def _cfg(path, ckpt=None, random_cw=False) -> tcfg.RunConfig:
    """Point 0 stops on 3 frame errors within its first step, point 1 runs
    to 96 frames: the slot reallocation gives it point 0's slots."""
    return tcfg.RunConfig(
        code=tcfg.CodeConfig(path=str(path)),
        decoder=tcfg.DecoderConfig(kind="qspa", max_iters=4),
        channel=tcfg.ChannelConfig(ebn0_db=(-4.0, 6.0), zero_codeword=not random_cw),
        sim=tcfg.SimConfig(frames_per_step=16, max_frames=96, max_frame_errors=3, seed=1,
                           checkpoint_path=str(ckpt) if ckpt else None,
                           checkpoint_every=1))


SHAPES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}


def _sweeps(rank, path, shapes, tmp):
    """The zero- and random-codeword sweeps on each layout; a sweep killed
    in step 2 and resumed; which ranks' Checkpointer.save and save_report
    write a file."""
    out = {}
    for snr, data in shapes:
        layout = mesh.make_layout(snr, data)
        for mode in ("zero", "random"):
            res = sim.run_sweep(_cfg(path, random_cw=mode == "random"), "cpu", layout=layout)
            out[(snr, data, mode)] = (res.counters.asdict(), res.steps)
    snr, data = shapes[0]
    layout = mesh.make_layout(snr, data)
    cfg = _cfg(path, ckpt=Path(tmp, "sweep.ckpt"))

    def killer(t, counters):
        if t >= 2:
            raise KeyboardInterrupt

    try:
        sim.run_sweep(cfg, "cpu", killer, layout)
    except KeyboardInterrupt:
        pass
    killed = json.loads(Path(tmp, "sweep.ckpt").read_text())
    res = sim.run_sweep(cfg, "cpu", layout=layout)
    out["resumed"] = (res.counters.asdict(), res.steps, killed["step"])
    probe_ckpt, probe_rep = Path(tmp, f"probe{rank}.ckpt"), Path(tmp, f"probe{rank}.json")
    Checkpointer(probe_ckpt, "h").save(1, res.counters)
    report.save_report(res, probe_rep)
    out["wrote"] = (probe_ckpt.exists(), probe_rep.exists())
    return out


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("codes") / "tiny.alist"
    save_alist(make_peg_code(16, 8, 4, dv=2, seed=5), path)
    return path


@pytest.fixture(scope="module")
def single(tiny):
    """Single-process sweeps: zero and random codewords."""
    return {mode: sim.run_sweep(_cfg(tiny, random_cw=mode == "random"), "cpu")
            for mode in ("zero", "random")}


@pytest.fixture(scope="module")
def ranks(tiny, tmp_path_factory):
    """Each rank's results of _sweeps, by world size."""
    out = {}
    for world, shapes in SHAPES.items():
        tmp = tmp_path_factory.mktemp(f"world{world}")
        out[world] = run_ranks(tmp, world, _sweeps, str(tiny), shapes, str(tmp))
    return out


# ---- layout ----

@pytest.mark.parametrize("snr,data", [(2, 4), (1, 0), (2, 0), (4, 0), (8, 0), (4, 2),
                                      (1, 8)])
def test_grid_matches_jax_make_mesh(snr, data):
    from nbldpc_tpu.parallel.mesh import make_mesh

    assert mesh.grid(8, snr, data) == tuple(make_mesh(snr=snr, data=data).shape.values())


@pytest.mark.parametrize("snr,data", [(3, 0), (2, 8), (16, 0)])
def test_grid_refuses_what_jax_make_mesh_refuses(snr, data):
    from nbldpc_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError):
        make_mesh(snr=snr, data=data)
    with pytest.raises(ValueError):
        mesh.grid(8, snr, data)


def test_grid_needs_every_rank():
    """JAX's make_mesh(snr=1, data=4) takes 4 of 8 devices; a layout of
    ranks must give every rank a block, so the port refuses it."""
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh.grid(8, 1, 4)
    with pytest.raises(ValueError):
        mesh.grid(8, 0, 0)


def test_layout_blocks_tile_the_batch():
    S, B = 4, 12
    for snr, data in [(1, 4), (2, 2), (4, 1), (2, 3)]:
        seen = np.zeros((S, B), int)
        for r in range(snr * data):
            lay = mesh.Layout(snr, data, r)
            assert lay.coords == (r // data, r % data)
            sl, fl = lay.block(S, B)
            assert (sl.stop - sl.start, fl.stop - fl.start) == (S // snr, B // data)
            seen[sl, fl] += 1
        assert (seen == 1).all()
    with pytest.raises(ValueError, match="SNR points"):
        mesh.Layout(2, 1, 0).block(3, 4)
    with pytest.raises(ValueError, match="frames a step"):
        mesh.Layout(1, 2, 0).block(2, 5)


def test_device_cuda_needs_local_rank_under_nbldpc_group(monkeypatch):
    """--device cuda in an NBLDPC_* group of several processes without
    LOCAL_RANK would put every rank on card 0: refused, naming LOCAL_RANK
    and --device cuda:N; with LOCAL_RANK, or one process, or a card named,
    the device resolves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("NBLDPC_COORDINATOR", "localhost:29500")
    monkeypatch.setenv("NBLDPC_NUM_PROCS", "2")
    monkeypatch.setenv("NBLDPC_PROC_ID", "1")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(ValueError, match=r"LOCAL_RANK.*--device cuda:N"):
        cli.resolve_device("cuda")
    assert cli.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert cli.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert cli.resolve_device("cuda") == torch.device("cuda", 1)
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setenv("NBLDPC_NUM_PROCS", "1")
    assert cli.resolve_device("cuda") == torch.device("cuda", 0)
    # through the entry point: refused before the group is joined
    monkeypatch.setenv("NBLDPC_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        cli.main(["run", "--code", "gf4_n96_k48", "--device", "cuda"])


def test_initialize_without_a_group_is_single_process(monkeypatch):
    for v in ("NBLDPC_COORDINATOR", "NBLDPC_NUM_PROCS", "NBLDPC_PROC_ID", "RANK",
              "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    assert dist.initialize("cpu") is False
    assert dist.process_info() == (0, 1)
    monkeypatch.setenv("NBLDPC_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="without NBLDPC_COORDINATOR"):
        dist.initialize("cpu")
    monkeypatch.setenv("NBLDPC_COORDINATOR", "file:///nonexistent/store")
    monkeypatch.setenv("NBLDPC_PROC_ID", "2")
    with pytest.raises(ValueError, match="rank 2 outside a group of 2"):
        dist.initialize("cpu")
    assert not tdist.is_initialized()


# ---- sweeps across ranks ----

@pytest.mark.parametrize("world,snr,data", [(2, 1, 2), (2, 2, 1), (4, 2, 2)])
@pytest.mark.parametrize("mode", ["zero", "random"])
def test_sharded_sweep_equals_single_process(ranks, single, world, snr, data, mode):
    want = single[mode]
    c = want.counters
    assert c.frame_errors[0] >= 3 and c.frames[0] == 16 < c.frames[1]
    assert c.frames.sum() == want.steps * 2 * 16     # point 0's slots reallocated
    for r, got in enumerate(ranks[world]):
        counters, steps = got[(snr, data, mode)]
        assert counters == want.counters.asdict(), (r, mode)
        assert steps == want.steps


def test_random_codeword_sweep_differs_from_zero(single):
    assert single["random"].counters.asdict() != single["zero"].counters.asdict()


@pytest.mark.parametrize("world", [2, 4])
def test_resumed_sweep_equals_uninterrupted(ranks, single, world):
    want = single["zero"]
    for r, got in enumerate(ranks[world]):
        counters, steps, killed_at = got["resumed"]
        assert killed_at == 1
        assert counters == want.counters.asdict(), r
        assert steps == want.steps - killed_at


@pytest.mark.parametrize("world", [2, 4])
def test_only_rank_0_writes(ranks, world):
    assert [got["wrote"] for got in ranks[world]] == (
        [(True, True)] + [(False, False)] * (world - 1))


def test_cli_two_ranks_equals_one_process(tiny, tmp_path):
    """`cli run --mesh-snr 2` on two processes joined through the
    environment; the report (rank 0's alone) equals a single process's."""
    args = ["run", "--code", str(tiny), "--snr", "-4.0", "6.0", "--iters", "4",
            "--frames", "96", "--set", "sim.frames_per_step=16",
            "--set", "sim.max_frame_errors=3", "--set", "sim.seed=1", "--device", "cpu"]
    env = {**os.environ, "NBLDPC_COORDINATOR": f"file://{tmp_path}/store",
           "NBLDPC_NUM_PROCS": "2", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-m", "nbldpc_tpu_torch", *args,
                               "--mesh-snr", "2", "--report", str(tmp_path / f"rep{i}.json")],
                              cwd=ROOT, env={**env, "NBLDPC_PROC_ID": str(i)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        assert "Eb/N0" in out
    assert not (tmp_path / "rep1.json").exists()
    got = json.loads((tmp_path / "rep0.json").read_text())
    assert cli.main([*args, "--report", str(tmp_path / "one.json")]) == 0
    want = json.loads((tmp_path / "one.json").read_text())
    for k in ("frames", "frame_errors", "ber", "ser", "fer", "avg_iters", "steps"):
        assert got[k] == want[k], k


# ---- the data-parallel step against the JAX composition ----

def _jax_counters(spec, dec, sig, noise, u):
    """JAX's encode -> modulate -> AWGN -> llr_init -> decode -> counters on
    the whole [S, B] batch."""
    import jax.numpy as jnp

    import nbldpc_tpu.channel as jch
    import nbldpc_tpu.graph as jgraph
    import nbldpc_tpu.sim as jsim
    import nbldpc_tpu.utils.config as jcfg
    from nbldpc_tpu.encode import Encoder as JaxEncoder

    S, B, N, p = noise.shape
    q = spec.q
    cw = JaxEncoder(spec).encode(jnp.asarray(u))
    s4 = jnp.asarray(sig)[:, None, None, None]
    llr = jch.llr_init(jch.modulate(cw, q) + s4 * jnp.asarray(noise), s4, q)
    res = jsim.get_decode_fn(jcfg.DecoderConfig(**dec))(
        jgraph.TannerGraph(spec), llr.reshape(S * B, N, q))
    diff = np.asarray(res.hard).reshape(S, B, N) ^ np.asarray(cw)
    return {"frames": [B] * S,
            "frame_errors": (diff != 0).any(axis=-1).sum(axis=1),
            "symbol_errors": (diff != 0).sum(axis=(1, 2)),
            "bit_errors": sum((diff >> t) & 1 for t in range(p)).sum(axis=(1, 2)),
            "iter_sum": np.asarray(res.iters).reshape(S, B).sum(axis=1),
            "converged": np.asarray(res.done).reshape(S, B).sum(axis=1)}


@pytest.mark.parametrize("snr,data", [(1, 2), (2, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("dec,sigmas", [({"kind": "qspa"}, (0.95, 0.7)),
                                        ({"kind": "ems", "nm": 8, "offset": 0.3},
                                         (0.9, 0.65))])
def test_dp_step_blocks_equal_jax_on_whole_batch(snr, data, dec, sigmas, monkeypatch):
    """Each rank's step on its block of one numpy draw, scattered and
    summed, equals the JAX composition on the whole batch; and the step's
    own draw, split into blocks, equals the unsplit step, each rank
    decoding its S_r B_r frames alone."""
    batches = []
    decode_fn = sim.get_decode_fn

    def spy(dec, cn_impl="auto"):
        fn = decode_fn(dec, cn_impl)
        return lambda graph, llr: batches.append(llr.shape[0]) or fn(graph, llr)

    monkeypatch.setattr(sim, "get_decode_fn", spy)
    spec = make_peg_code(16, 8, 16, dv=2, seed=7)
    g = TannerGraph(spec, "cpu")
    S, B, N, p = 2, 24, g.n, g.gf.p
    dec = {"max_iters": 6, **dec}
    enc = Encoder(spec, "cpu")
    rng = np.random.default_rng(snr * 10 + data)
    u = rng.integers(0, g.q, size=(S, B, enc.k)).astype(np.int32)
    noise = rng.standard_normal((S, B, N, p)).astype(np.float32)
    sig = np.asarray(sigmas, np.float32)
    cfg = tcfg.DecoderConfig(**dec)
    got = np.zeros((6, S), np.int64)
    drawn = np.zeros((6, S), np.int64)
    for r in range(snr * data):
        block = mesh.Layout(snr, data, r).block(S, B)
        sl, fl = block
        step = sim.make_sim_step(g, cfg, B, S, enc, block=block)
        out = sim.stack(step.frames(torch.from_numpy(sig[sl]),
                                    torch.from_numpy(noise[sl, fl]),
                                    torch.from_numpy(u[sl, fl])))
        assert out.shape == (6, S // snr)
        got[:, sl] += out.numpy()
        drawn[:, sl] += sim.stack(step(sim.step_generator(5, 3, "cpu"),
                                       torch.from_numpy(sig))).numpy()
    assert batches == [S * B // (snr * data)] * (2 * snr * data)
    want = _jax_counters(spec, dec, sig, noise, u)
    names = [f.name for f in dataclasses.fields(sim.Counters)]
    assert {k: v.tolist() for k, v in zip(names, got)} == {
        k: np.asarray(v).tolist() for k, v in want.items()}
    whole = sim.make_sim_step(g, cfg, B, S, enc)(sim.step_generator(5, 3, "cpu"),
                                                 torch.from_numpy(sig))
    assert drawn.tolist() == sim.stack(whole).tolist()
    assert 0 < got[1].sum() < S * B                   # some frames fail, some decode
