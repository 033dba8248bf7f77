"""The port's throughput harness and layout sweep
(nbldpc_tpu_torch/benchmarks/run_all.py and scaling.py) against the JAX
scripts benchmarks/run_all.py and benchmarks/scaling_cpu.py.

run_all's CONFIGS is held to the JAX script's row for row (loaded from its
file); scaling_cpu's constants are locals of its main(), read with ast.
The step a configuration builds is held to the JAX composition on the same
numpy noise, counter for counter; both entry points run here on the CPU,
the layout sweep on 8 gloo ranks spawned from this module. The ranks
import no JAX: JAX is imported inside the tests that compare with it.
"""

import ast
import importlib.util
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from nbldpc_tpu_torch import convert, sim
from nbldpc_tpu_torch.benchmarks import run_all, scaling
from nbldpc_tpu_torch.graph import TannerGraph

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_SCRIPTS = ROOT / "benchmarks"


def _load_jax_run_all():
    spec = importlib.util.spec_from_file_location("jax_harness_run_all",
                                                  JAX_SCRIPTS / "run_all.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- tables ------------------------------------------------------------------

def test_configs_equal_jax():
    jax_configs = _load_jax_run_all().CONFIGS
    assert len(run_all.CONFIGS) == len(jax_configs) == 18
    for mine, theirs in zip(run_all.CONFIGS, jax_configs):
        assert mine == theirs


def _scaling_main_nodes():
    tree = ast.parse((JAX_SCRIPTS / "scaling_cpu.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    return list(ast.walk(main))


def _call(nodes, name):
    """The first call of `name` (a function or method name) in nodes."""
    return next(n for n in nodes if isinstance(n, ast.Call)
                and getattr(n.func, "id", getattr(n.func, "attr", None)) == name)


def test_scaling_constants_equal_jax():
    nodes = _scaling_main_nodes()
    assert ast.literal_eval(_call(nodes, "build_standard_code").args[0]) == scaling.CODE
    dec = {k.arg: ast.literal_eval(k.value) for k in _call(nodes, "DecoderConfig").keywords}
    assert dec == {"kind": "qspa", "max_iters": scaling.ITERS, "early_term": False,
                   "stats_each_iter": False}
    (sb,) = [n for n in nodes if isinstance(n, ast.Assign)
             and isinstance(n.targets[0], ast.Tuple)
             and [t.id for t in n.targets[0].elts] == ["S", "B"]]
    assert ast.literal_eval(sb.value) == (scaling.S, scaling.B)
    lin = _call(nodes, "linspace")
    assert tuple(ast.literal_eval(a) for a in lin.args[:2]) == scaling.SIGMA_ENDS
    assert ast.literal_eval(_call(nodes, "PRNGKey").args[0]) == scaling.SEED
    (loop,) = [n for n in nodes if isinstance(n, ast.For)]
    assert ast.literal_eval(loop.iter) == scaling.LAYOUTS
    assert scaling.WORLD == 8


# --- the step a configuration builds, against the JAX composition -------------

def _peg(q, small_codes):
    """A small code of GF(q): conftest's at GF(4) and GF(16), else a PEG
    (12, 6) code."""
    from nbldpc_tpu.codegen import make_peg_code

    return {4: small_codes["gf4_tiny"], 16: small_codes["gf16_tiny"]}.get(q) or \
        make_peg_code(12, 6, q, dv=2, seed=3)


# QSPA, EMS nm 16, the bubble merge at offset 0.0 and T-EMS n_r 8, each on a
# small code of its configuration's field
@pytest.mark.parametrize("config, q", [("gf4_qspa_20it", 4), ("gf16_ems_nm16_20it", 16),
                                       ("gf256_ems_bubble_10it", 256),
                                       ("gf64_tems_nr8_20it", 64)])
def test_row_step_matches_jax(small_codes, config, q):
    """A configuration's step (run_all.row_step) at S = 4 on numpy noise
    equals the JAX composition on the same arrays (noise -> llr_init ->
    decode at the fixed budget -> counters), counter for counter."""
    import jax.numpy as jnp

    import nbldpc_tpu.channel as jch
    import nbldpc_tpu.graph as jgraph
    import nbldpc_tpu.sim as jsim
    import nbldpc_tpu.utils.config as jcfg

    (_, _, deckw, iters, _, _), = [c for c in run_all.CONFIGS if c[0] == config]
    spec = _peg(q, small_codes)
    g = TannerGraph(convert.codespec_from_arrays(spec.q, spec.n, spec.m, spec.row_cols,
                                                 spec.row_vals), device="cpu")
    S, B, N, p = 4, 8, g.n, g.gf.p
    step, sig = run_all.row_step(g, deckw, iters, B, S)
    assert sig.tolist() == pytest.approx([0.7, 0.75, 0.8, 0.85])
    noise = np.random.default_rng(5).standard_normal((S, B, N, p)).astype(np.float32)
    got = sim.fetch(step.frames(sig, torch.from_numpy(noise)))

    s4 = jnp.asarray(sig.numpy())[:, None, None, None]
    llr = jch.llr_init(1.0 + s4 * jnp.asarray(noise), s4, q)
    dec = jcfg.DecoderConfig(max_iters=iters, early_term=False, stats_each_iter=False,
                             **deckw)
    res = jsim.get_decode_fn(dec)(jgraph.TannerGraph(spec), llr.reshape(S * B, N, q))
    hard = np.asarray(res.hard).reshape(S, B, N)
    want = {"frames": [B] * S,
            "frame_errors": (hard != 0).any(axis=-1).sum(axis=1),
            "symbol_errors": (hard != 0).sum(axis=(1, 2)),
            "bit_errors": sum((hard >> t) & 1 for t in range(p)).sum(axis=(1, 2)),
            "iter_sum": np.asarray(res.iters).reshape(S, B).sum(axis=1),
            "converged": np.asarray(res.done).reshape(S, B).sum(axis=1)}
    assert {k: v.tolist() for k, v in got.items()} == {
        k: np.asarray(v).tolist() for k, v in want.items()}


# --- run_all on the CPU --------------------------------------------------------

def test_run_all_cpu_record_and_merge(tmp_path):
    out = tmp_path / "run_all_h100.json"
    common = ["--device", "cpu", "--quick", "--out", str(tmp_path)]
    assert run_all.main([*common, "--only", "gf4_qspa_20it"]) == 0
    (rec,) = json.loads(out.read_text())
    assert set(rec) >= {"config", "code", "iters", "batch", "n_snr", "symbols_per_s",
                        "frames_per_s", "timing", "first_call_s", "ms_per_step",
                        "wall_ms_per_step", "launches", "device"}
    assert "platform" not in rec and rec["device"] == "cpu"
    assert (rec["config"], rec["code"], rec["iters"], rec["batch"], rec["n_snr"]) == \
        ("gf4_qspa_20it", "gf4_n96_k48", 20, 32, 1)
    assert rec["symbols_per_s"] == rec["frames_per_s"] * 96
    assert rec["frames_per_s"] == pytest.approx(32 / (rec["ms_per_step"] * 1e-3))
    assert rec["timing"] == "host_clock" and rec["reps"] == 1 and rec["steps"] == 5
    assert rec["first_call_s"] > 0 and rec["wall_ms_per_step"] > 0
    assert rec["mm_precision"] == "f32" and rec["mm_precision_applied"]
    # the CPU runs the plain versions: one QSPA check-node update and one
    # of each routing half an iteration of each of the configuration's
    # steps, the channel, decode_bl's entry and the counters once a step,
    # and no kernel; decode_bl's loop counts its 20 iterations a step, and
    # its 32 frames at each of them (run_all drives no run_sweep loop)
    assert {k: v for k, v in rec["launches"].items() if v} == {
        "cn_qspa_plain": 5 * 20, "route_down_plain": 5 * 20, "route_up_plain": 5 * 20,
        "channel_llr_plain": 5, "prior_bl_plain": 5, "count_errors_plain": 5,
        "decode_bl.loop_iterations": 5 * 20, "decode_bl.frame_iterations": 5 * 20 * 32}
    # a later configuration, then the first again: merged in CONFIGS order,
    # the rerun replacing its record in place
    assert run_all.main([*common, "--only", "gf4_qspa_qc"]) == 0
    assert run_all.main([*common, "--only", "gf4_qspa_20it"]) == 0
    recs = json.loads(out.read_text())
    assert [r["config"] for r in recs] == ["gf4_qspa_20it", "gf4_qspa_qc_20it"]
    assert recs[1]["code"] == "gf4_n96_k48_qc" and recs[0]["ms_per_step"] != rec["ms_per_step"]


def test_run_all_bf16_row_on_the_cpu_says_f32(tmp_path):
    assert run_all.main(["--device", "cpu", "--only", "qspa_50it_bf16",
                         "--out", str(tmp_path)]) == 0
    (rec,) = json.loads((tmp_path / "run_all_h100.json").read_text())
    assert rec["config"] == "gf16_qspa_50it_bf16" and rec["batch"] == 32
    assert rec["mm_precision"] == "bf16" and rec["mm_precision_applied"] is False


# --- scaling on 8 gloo ranks on the CPU ----------------------------------------

def _scaling_rank(rank, world, tmp):
    torch.set_num_threads(1)
    os.environ.update(NBLDPC_COORDINATOR=f"file://{tmp}/store",
                      NBLDPC_NUM_PROCS=str(world), NBLDPC_PROC_ID=str(rank))
    rc = scaling.main(["--device", "cpu", "--tag", "cpu", "--out", f"{tmp}/out{rank}"])
    bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "nbldpc_tpu")]
    Path(tmp, f"rank{rank}.pkl").write_bytes(pickle.dumps((rc, bad)))


def test_scaling_on_eight_gloo_ranks(tmp_path):
    world = scaling.WORLD
    mp.start_processes(_scaling_rank, args=(world, str(tmp_path)), nprocs=world,
                       join=True, start_method="spawn")
    results = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes()) for r in range(world)]
    assert results == [(0, [])] * world
    # rank 0 alone writes the record
    written = sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.glob("out*/*"))
    assert written == ["out0/scaling_cpu.json"]
    rec = json.loads((tmp_path / "out0" / "scaling_cpu.json").read_text())
    assert set(rec) >= {"counters", "rows", "note", "device", "backend", "ranks_per_card"}
    assert rec["device"] == "cpu" and rec["backend"] == "gloo" and rec["world"] == 8
    assert [(r["mesh"]["snr"], r["mesh"]["data"]) for r in rec["rows"]] == \
        list(scaling.LAYOUTS)
    assert [r["devices"] for r in rec["rows"]] == [1, 2, 4, 8]
    assert all(r["counters_identical_to_1dev"] and r["step_s"] > 0 for r in rec["rows"])
    c = rec["counters"]
    assert c["frames"] == [16, 16] and c["iter_sum"] == [16 * 4, 16 * 4]
    # every rank that holds a block ran the decode (the plain version here),
    # and no other rank did
    for r in rec["rows"]:
        assert [bool(l) for l in r["launches_ranks"]] == \
            [i < r["devices"] for i in range(world)]


@pytest.mark.parametrize("world", [None, 4])
def test_scaling_refuses_a_smaller_world(tmp_path, monkeypatch, world):
    for v in ("NBLDPC_COORDINATOR", "NBLDPC_NUM_PROCS", "NBLDPC_PROC_ID", "RANK",
              "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    if world:
        monkeypatch.setenv("NBLDPC_COORDINATOR", f"file://{tmp_path}/store")
        monkeypatch.setenv("NBLDPC_NUM_PROCS", str(world))
        monkeypatch.setenv("NBLDPC_PROC_ID", "0")
    with pytest.raises(ValueError, match="--nproc-per-node 8 -m "
                                         "nbldpc_tpu_torch.benchmarks.scaling"):
        scaling.main(["--device", "cpu", "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists() and not (tmp_path / "store").exists()
