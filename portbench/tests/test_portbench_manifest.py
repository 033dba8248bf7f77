"""BENCHMARK.json and the files each of its entries names: the format's
charsets and limits, and a cell added as files alone."""

import json
import re
import shutil

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def man():
    return manifest.load_manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(man):
    assert set(man) == KEYS["top"]
    assert (manifest.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[section]:
            extra = set(e) - KEYS[section] - ({"workloads"} if section in (
                "end_to_end", "per_layer") else set())
            assert set(e) >= KEYS[section] and not extra, (section, e["name"])


def test_command_and_paths(man):
    assert 1 <= len(man["paths"]) <= 16 and 1 <= len(man["command"]) <= 32
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert all(_line(w) for w in man["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(man, section):
    names = [e["name"] for e in man[section]]
    assert len(names) == len(set(names))
    for e in man[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
    if section == "configs":
        for e in man[section]:
            assert e["source"] and len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])
    if section == "workloads":
        for e in man[section]:
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)
        pairs = [(e["config"], e["traffic"]) for e in man[section]]
        assert len(pairs) == len(set(pairs))


def test_metrics(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {}
    for m in man["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_cell_found_by_name(man):
    configs = {c["name"]: c for c in man["configs"]}
    for c in configs.values():
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (manifest.ROOT / c["file"]).exists()
    for w in man["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert cell.workload["config"] == w["config"] in configs
        assert cell.workload["traffic"] == w["traffic"]
        assert _line(cell.workload["why"])
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(cell.limits) >= {"frames_gap"}
        for m in cell.per_layer:
            assert callable(manifest.load_reader(m["name"]))
    for c in configs.values():
        assert any(w["config"] == c["name"] for w in man["workloads"])


def test_a_new_cell_is_files_alone(man, tmp_path):
    """A cell added as a manifest entry and a workload file is found with no
    edit of the harness."""
    here = tmp_path / "portbench"
    for d in ("configs", "workloads", "limits", "metrics", "codes"):
        shutil.copytree(manifest.HERE / d, here / d)
    new = {"name": "gf16_qspa.mid", "config": "gf16_qspa_batch4k", "traffic": "mid",
           "chips": 1, "why": "2.0 dB in all slots"}
    man = json.loads(json.dumps(man))
    man["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (here / "workloads" / "gf16_qspa.mid.json").write_text(json.dumps({
        "config": "gf16_qspa_batch4k", "traffic": "mid", "ebn0_db": [2.0] * 5,
        "warm_steps": 2, "check_steps": 4, "reference_block": 20480, "why": new["why"]}))
    cell = manifest.load_cell("gf16_qspa.mid", root=tmp_path, here=here)
    assert cell.workload["ebn0_db"] == [2.0] * 5 and cell.limits == {}
    names = {m["name"] for m in cell.per_layer}
    assert names >= {"channel_llr_roofline", "device.idle_share"}
    assert not names & {"k0_roofline", "route_roofline"}    # listed by cell
    with pytest.raises(KeyError):
        manifest.load_cell("gf16_qspa.none", root=tmp_path, here=here)

