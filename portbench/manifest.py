"""Find a cell's files by name.

BENCHMARK.json (at the checkout's root) lists the configurations, cells and
metrics; everything that belongs to one of them sits in a file of its own
under portbench/, found by its name:

  configs/<config>.json     the RunConfig as it is run, its source, what
                            was assumed and reduced;
  workloads/<cell>.json     the cell's traffic: the Eb/N0 point of each
                            SNR slot, the warm-up and the steps checked;
  limits/<cell>.json        the limit of each number `correct` compares;
  metrics/<metric>.py       the reader of a per-layer metric: read(ctx)
                            -> float or None.

A new cell, configuration or metric is a new entry and new files: nothing
here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict        # configs/<config>.json
    workload: dict      # workloads/<cell>.json
    limits: dict        # limits/<cell>.json ({} where none is set)
    end_to_end: list    # the manifest's end-to-end entries this cell reports
    per_layer: list     # the manifest's per-layer entries this cell reports


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files under `here`
    (KeyError for a name the manifest lacks)."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    entry = cells[name]
    config = json.loads((here / "configs" / f"{entry['config']}.json").read_text())
    workload = json.loads((here / "workloads" / f"{name}.json").read_text())
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: workloads/{name}.json names config "
                         f"{workload['config']!r}, BENCHMARK.json {entry['config']!r}")
    limits_file = here / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return Cell(name=name, chips=int(entry["chips"]), config=config, workload=workload,
                limits=limits,
                end_to_end=[m for m in man["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in man["per_layer"] if _reports(m, name)])


def load_reader(metric: str, here: Path = HERE):
    """metrics/<metric>.py's read function."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
