"""The port's coding-performance harness (nbldpc_tpu_torch/benchmarks/:
fer_curves, offset_sweep, ber_precision) against the JAX scripts
benchmarks/fer_curves.py, offset_sweep.py and ber_precision.py.

The JAX scripts are not a package: fer_curves and offset_sweep are loaded
from their files (their top level imports no JAX) and their tables held to
the port's row for row; ber_precision's defaults are read from its source
with ast. The port's entry points run here on the CPU, one step or a tiny
PEG code each, and compare_records is held to its stated threshold on
synthetic records. The checks that no module imports JAX and that every
entry point needs a card also cover the throughput harness (run_all,
scaling; tests/test_torch_throughput_harness.py holds the rest of it).
"""

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nbldpc_tpu_torch.benchmarks import (
    ber_precision, fer_curves, merge_records, offset_sweep, run_all, scaling,
)
from nbldpc_tpu_torch.code import save_alist
from nbldpc_tpu_torch.codegen import make_peg_code

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_harness_{name}",
                                                  ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _calls(name):
    """The ast Call nodes of benchmarks/<name>.py."""
    tree = ast.parse((ROOT / "benchmarks" / f"{name}.py").read_text())
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)]


def _keyword(calls, func, kw):
    """The literal value of keyword `kw` in the call of `func` (a name)."""
    for c in calls:
        if getattr(c.func, "id", None) == func:
            for k in c.keywords:
                if k.arg == kw:
                    return ast.literal_eval(k.value)
    raise KeyError((func, kw))


@pytest.fixture(scope="module")
def tiny_code(tmp_path_factory):
    path = tmp_path_factory.mktemp("codes") / "tiny_gf16.alist"
    save_alist(make_peg_code(48, 24, 16, dv=2, seed=1), path)
    return str(path)


# --- tables ----------------------------------------------------------------

def test_sweeps_equal_jax():
    jax_sweeps = _load("fer_curves").SWEEPS
    assert len(fer_curves.SWEEPS) == len(jax_sweeps) == 14
    for mine, theirs in zip(fer_curves.SWEEPS, jax_sweeps):
        assert mine == theirs


def test_offset_tables_equal_jax():
    jos = _load("offset_sweep")
    assert len(offset_sweep.CONFIGS) == len(jos.CONFIGS) == 5
    for mine, theirs in zip(offset_sweep.CONFIGS, jos.CONFIGS):
        assert mine == theirs
    assert offset_sweep.OFFSETS == jos.OFFSETS


@pytest.mark.parametrize("name, port, early_term", [
    ("fer_curves", fer_curves, True), ("offset_sweep", offset_sweep, None),
    ("ber_precision", ber_precision, False)])
def test_seeds_and_early_term_equal_jax(name, port, early_term):
    calls = _calls(name)
    assert port.SEED == _keyword(calls, "SimConfig", "seed")
    if early_term is not None:
        assert _keyword(calls, "DecoderConfig", "early_term") is early_term


def _jax_defaults(name):
    """{flag: default} of benchmarks/<name>.py's add_argument calls, read
    with ast (a flag without a default: None)."""
    out = {}
    for c in _calls(name):
        if getattr(c.func, "attr", None) == "add_argument":
            kws = {k.arg: k.value for k in c.keywords}
            out[ast.literal_eval(c.args[0])] = (ast.literal_eval(kws["default"])
                                                if "default" in kws else None)
    return out


@pytest.mark.parametrize("name, port", [
    ("fer_curves", fer_curves), ("offset_sweep", offset_sweep),
    ("ber_precision", ber_precision)])
def test_cli_defaults_equal_jax(name, port):
    """Every flag of the JAX script, with its default, is the port's, but
    --tag and --out: the port's records land in its own results/ (it adds
    --device, and fer_curves --compare)."""
    jax_defaults = _jax_defaults(name)
    mine = vars(port.parser().parse_args([]))
    assert mine["device"] == "cuda"
    for flag, default in jax_defaults.items():
        if flag not in ("--tag", "--out"):
            assert mine[flag.lstrip("-").replace("-", "_")] == default, flag
    if name == "ber_precision":
        assert jax_defaults == {"--code": "gf16_n204_k102", "--frames": 20000,
                                "--iters": 50, "--batch": 1024,
                                "--snrs": [1.0, 1.5, 2.0, 2.5], "--out": None}
        assert ber_precision.PRECISIONS == ("f32", "bf16")


def test_harness_imports_without_jax():
    """The harness's modules import nothing of JAX, of the JAX package or of
    benchmarks/, directly or through the port."""
    code = """
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'nbldpc_tpu', 'benchmarks'):
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
for m in ('fer_curves', 'offset_sweep', 'ber_precision', 'run_all', 'scaling'):
    importlib.import_module('nbldpc_tpu_torch.benchmarks.' + m)
bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'nbldpc_tpu', 'benchmarks')]
assert not bad, bad
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# --- the entry points on the CPU --------------------------------------------

def test_fer_curves_one_step(tmp_path):
    assert fer_curves.main(["--device", "cpu", "--only", "gf4_qspa_20it", "--max-fe", "1",
                            "--out", str(tmp_path)]) == 0
    recs = json.loads((tmp_path / "fer_curves_h100.json").read_text())
    ref = json.loads((ROOT / "benchmarks/results/fer_curves_r5.json").read_text())
    assert [r["config"] for r in recs] == ["gf4_qspa_20it"]
    r = recs[0]
    assert set(r) == set(ref[0]) | {"device"}
    assert r["device"] == "cpu" and r["code"] == "gf4_n96_k48" and r["steps"] == 1
    assert r["ebn0_db"] == [1.5, 2.0, 2.5, 3.0] and r["frames"] == [2048] * 4
    assert all(k >= 1 for k in r["frame_errors"])
    assert all(0.0 <= f <= 1.0 for f in r["fer"])
    assert r["fer"][-1] < r["fer"][0]


def test_merge_records(tmp_path):
    path = tmp_path / "recs.json"
    order = ["a", "b", "c"]
    merge_records(path, [{"config": "c", "v": 1}], "config", order)
    merge_records(path, [{"config": "a", "v": 2}], "config", order)
    merge_records(path, [{"config": "c", "v": 3}, {"config": "z", "v": 4}], "config", order)
    assert json.loads(path.read_text()) == [{"config": "a", "v": 2}, {"config": "c", "v": 3},
                                            {"config": "z", "v": 4}]


@pytest.mark.parametrize("deckw", [dict(kind="ems", nm=4, max_iters=5),
                                   dict(kind="tems", max_iters=5, tems_nr=4)])
def test_offset_sweep_tiny(tiny_code, deckw):
    offsets = [0.0, 0.3, 1.0]
    rec = offset_sweep.sweep_offsets("tiny", tiny_code, deckw, 2.0, 32, offsets,
                                     max_fe=4, max_frames=64, device=CPU)
    assert rec["config"] == "tiny" and rec["snr_db"] == 2.0 and rec["device"] == "cpu"
    assert [r["offset"] for r in rec["rows"]] == offsets
    for r in rec["rows"]:
        assert r["frames"] in (32, 64) and (r["frames"] == 64 or r["frame_errors"] >= 4)
        assert r["fer"] == r["frame_errors"] / r["frames"] and 0.0 <= r["ber"] <= 1.0
        assert 1.0 <= r["avg_iters"] <= 5.0 and r["wall_seconds"] > 0
    best = min(rec["rows"], key=lambda r: (r["fer"], r["ber"]))
    assert (rec["best_offset"], rec["best_fer"]) == (best["offset"], best["fer"])


def test_offset_sweep_main_merges(tmp_path, tiny_code, monkeypatch):
    monkeypatch.setattr(offset_sweep, "CONFIGS", [
        ("tiny_ems", tiny_code, dict(kind="ems", nm=4, max_iters=3), 2.0, 16),
        ("tiny_tems", tiny_code, dict(kind="tems", max_iters=3), 2.0, 16)])
    common = ["--device", "cpu", "--max-fe", "2", "--max-frames", "16", "--out", str(tmp_path)]
    assert offset_sweep.main(["--only", "tems", "--offsets", "1.0,2.0", *common]) == 0
    assert offset_sweep.main(["--only", "tiny_ems", "--offsets", "0.0", *common]) == 0
    recs = json.loads((tmp_path / "offset_sweep_h100.json").read_text())
    assert [r["config"] for r in recs] == ["tiny_ems", "tiny_tems"]
    assert [row["offset"] for row in recs[1]["rows"]] == [1.0, 2.0]


def test_ber_precision_tiny(tiny_code, tmp_path, capsys):
    modes = {p: ber_precision.precision_record(tiny_code, p, [1.0, 3.0], 64, 5, 32, CPU)[0]
             for p in ber_precision.PRECISIONS}
    for m in modes.values():
        assert m["frames"] == [64, 64] and m["fer"][1] <= m["fer"][0]
        assert all(0.0 <= x <= 1.0 for x in m["ber"] + m["ser"] + m["fer"])
        assert all(1.0 <= x <= 5.0 for x in m["avg_iters"])
    # on the CPU both precisions take the same torch path: the comparison is vacuous
    assert {k: v for k, v in modes["f32"].items() if k != "wall_s"} == \
        {k: v for k, v in modes["bf16"].items() if k != "wall_s"}
    assert ber_precision.main(["--code", tiny_code, "--frames", "32", "--iters", "2",
                               "--batch", "32", "--snrs", "2.0", "--device", "cpu",
                               "--out", str(tmp_path)]) == 0
    out = tmp_path / "ber_precision_h100.json"
    (rec,) = json.loads(out.read_text())
    # the last line: bf16 held to f32 (the same path on the CPU: z = 0)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["z"] == [0.0] and line["bf16_vs_f32"]["held"] == int(
        fer_curves.MIN_ERRORS <= rec["modes"]["f32"]["frame_errors"][0] < 32)
    assert rec["device"] == "cpu" and rec["code"] == tiny_code and rec["snrs_db"] == [2.0]
    assert set(rec["modes"]) == {"f32", "bf16"} and rec["modes"]["bf16"]["frames"] == [32]
    assert ber_precision.as_curve(rec, "bf16") == [
        {"config": tiny_code, "ebn0_db": [2.0], **rec["modes"]["bf16"]}]


@pytest.mark.parametrize("port, args", [
    (fer_curves, ["--only", "gf4_qspa_20it", "--max-fe", "1"]),
    (offset_sweep, ["--only", "gf16_ems", "--offsets", "0.3"]),
    (ber_precision, ["--frames", "32"]),
    (run_all, ["--only", "gf4_qspa_20it"]),
    (scaling, [])])
def test_entry_points_need_a_card(port, args, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main([*args, "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


# --- compare_records ----------------------------------------------------------

def _rec(config, snrs, errors, frames):
    return {"config": config, "ebn0_db": snrs, "frame_errors": errors, "frames": frames}


def test_family_threshold():
    assert fer_curves.family_threshold(1) == pytest.approx(3.2905, abs=1e-4)
    assert round(fer_curves.family_threshold(49), 2) == 4.26
    ref = json.loads((ROOT / "benchmarks/results/fer_curves_r5.json").read_text())
    cmp = fer_curves.compare_records(ref, ref)
    # 49 points with >= 10 errors a side, less the four GF(64) T-EMS 2.5 dB
    # points at FER 1 on both sides
    assert cmp["held"] == 45 and round(cmp["threshold"], 2) == 4.24 and cmp["ok"]
    assert all(p["z"] == 0.0 for p in cmp["points"]) and cmp["missing"] == []


def test_compare_saturated_point_not_held():
    ref = [_rec("a", [1.0, 2.0], [256, 100], [256, 1000])]
    port = [_rec("a", [1.0, 2.0], [256, 110], [256, 1000])]
    cmp = fer_curves.compare_records(port, ref)
    assert [p["held"] for p in cmp["points"]] == [False, True] and cmp["held"] == 1
    # FER 1 on one side only is held and judged
    port[0]["frame_errors"][0] = 200
    assert fer_curves.compare_records(port, ref)["held"] == 2


def test_compare_nothing_held_fails(tmp_path):
    ref = [_rec("a", [1.0, 2.0], [100, 40], [1000, 80000])]
    port = [_rec("a", [1.0, 2.0], [9, 3], [1000, 80000])]
    cmp = fer_curves.compare_records(port, ref)
    assert cmp["held"] == 0 and cmp["threshold"] is None and not cmp["ok"]
    # nor does a pair of files with no common point pass
    cmp = fer_curves.compare_records([_rec("b", [1.0], [100], [1000])], ref)
    assert cmp["points"] == [] and not cmp["ok"]
    (tmp_path / "p.json").write_text(json.dumps(port))
    (tmp_path / "r.json").write_text(json.dumps(ref))
    assert fer_curves.main(["--compare", str(tmp_path / "p.json"),
                            str(tmp_path / "r.json")]) == 1


def test_compare_missing_points_fail_the_files(tmp_path):
    ref = [_rec("a", [1.0, 2.0], [100, 40], [1000, 80000]),
           _rec("b", [1.0], [50], [1000])]
    port = [_rec("a", [1.0], [100], [1000])]
    cmp = fer_curves.compare_records(port, ref)
    # a run of some configurations is held to a full reference ...
    assert cmp["ok"] and cmp["held"] == 1
    assert cmp["missing"] == [["a", 2.0], ["b", 1.0]]
    # ... but a file compared on the command line must hold every point
    (tmp_path / "p.json").write_text(json.dumps(port))
    (tmp_path / "r.json").write_text(json.dumps(ref))
    assert fer_curves.main(["--compare", str(tmp_path / "p.json"),
                            str(tmp_path / "r.json")]) == 1
    (tmp_path / "p.json").write_text(json.dumps(ref))
    assert fer_curves.main(["--compare", str(tmp_path / "p.json"),
                            str(tmp_path / "r.json")]) == 0


def test_compare_one_point_and_not_held():
    port = [_rec("a", [1.0, 2.0], [120, 9], [1000, 20000])]
    ref = [_rec("a", [1.0, 2.0, 3.0], [100, 40, 3], [1000, 80000, 200000])]
    cmp = fer_curves.compare_records(port, ref)
    assert cmp["held"] == 1 and cmp["threshold"] == pytest.approx(3.2905, abs=1e-4)
    by_x = {p["x"]: p for p in cmp["points"]}
    assert set(by_x) == {1.0, 2.0}
    assert by_x[1.0]["held"] and by_x[1.0]["z"] == pytest.approx(
        fer_curves.two_prop_z(120, 1000, 100, 1000))
    # 9 errors on the port's side: listed with its counts, not judged
    assert not by_x[2.0]["held"] and by_x[2.0]["port"] == [9, 20000]
    assert cmp["ok"]


def test_compare_planted_gap_fails():
    rng = np.random.default_rng(0)
    ref, port = [], []
    for c in range(7):
        frames = [int(x) for x in rng.integers(2000, 20000, 7)]
        errors = [int(f * p) for f, p in zip(frames, rng.uniform(0.02, 0.3, 7))]
        ref.append(_rec(f"c{c}", list(range(7)), errors, frames))
        port.append(_rec(f"c{c}", list(range(7)), list(errors), list(frames)))
    cmp = fer_curves.compare_records(port, ref)
    assert cmp["held"] == 49 and cmp["ok"]
    port[3]["frame_errors"][4] = 3 * ref[3]["frame_errors"][4]
    cmp = fer_curves.compare_records(port, ref)
    assert not cmp["ok"]
    assert [(p["config"], p["x"]) for p in cmp["failed"]] == [("c3", 4)]


def test_compare_offset_rows(tmp_path):
    ref = json.loads((ROOT / "benchmarks/results/offset_sweep_r5.json").read_text())
    port = [{"config": "gf64_tems_nr8_20it", "rows": [
        {"offset": 2.0, "frame_errors": 151, "frames": 512},
        {"offset": 3.0, "frame_errors": 200, "frames": 256}]}]
    cmp = fer_curves.compare_records(port, ref)
    assert [p["x"] for p in cmp["points"]] == [2.0] and cmp["held"] == 1 and cmp["ok"]
    port[0]["rows"][0]["frame_errors"] = 3 * 151             # 3x the reference's FER
    assert not fer_curves.compare_records(port, ref)["ok"]
    (tmp_path / "p.json").write_text(json.dumps(port))
    assert fer_curves.main(["--compare", str(tmp_path / "p.json"),
                            str(ROOT / "benchmarks/results/offset_sweep_r5.json")]) == 1
