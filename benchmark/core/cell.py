"""Resolving a cell by name, and finding each part of it by name.

``BENCHMARK.json`` at the root of the checkout lists the cells: each names
a configuration (``configs[].file``, a JSON file of sizes and weights), a
traffic mix (``benchmark/traffic/<traffic>.json``, parameters read by the
general generator ``benchmark/traffic/<kind>.py`` that the mix names) and
its chips. Each metric is a reader ``benchmark/metrics/<metric>.py``, and
each cell's output limits are ``benchmark/limits/<cell>.json``. A later
cell, configuration, traffic mix or metric is new files and new entries,
never an edit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout
HERE = ROOT / "benchmark"
SPEC = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    """A cell as it runs: its ``name``, ``config`` (the configuration
    file's contents, with ``name``), ``traffic`` (the mix's parameters,
    with ``name``), ``chips``, the metrics it reports, as
    ``BENCHMARK.json`` lists them, and ``limits``: each number that decides
    ``correct``, with its limit and the readings it was set from."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``spec``), with its
    configuration, traffic mix and metrics. Raises ``KeyError`` for a name
    it does not list."""
    spec = spec if spec is not None else load_json(SPEC)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it lists {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = dict(load_json(ROOT / configs[w["config"]]["file"]), name=w["config"])
    traffic = dict(load_json(HERE / "traffic" / f"{w['traffic']}.json"), name=w["traffic"])
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
        limits=load_json(HERE / "limits" / f"{name}.json"),
    )


def kind(name: str):
    """The traffic generator ``benchmark/traffic/<name>.py``."""
    return importlib.import_module(f"benchmark.traffic.{name}")


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``benchmark/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def launch_kernels() -> dict:
    """The kernels that each of the program's launch counters launches:
    ``counts/launch_kernels*.json``, merged."""
    out: dict = {}
    for path in sorted((HERE / "counts").glob("launch_kernels*.json")):
        out.update(load_json(path))
    return out


def checkpoint(entry: dict) -> str:
    """The path of a configuration's committed checkpoint, after checking
    its SHA-256 against the configuration's: a changed file would change
    the cell."""
    path = ROOT / entry["checkpoint"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != entry["sha256"]:
        raise ValueError(f"{entry['checkpoint']}: SHA-256 {digest}, the configuration pins "
                         f"{entry['sha256']}")
    return str(path)
