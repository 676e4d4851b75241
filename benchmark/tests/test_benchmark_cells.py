"""BENCHMARK.json against the contract, and each cell resolved from its files
by name."""

import json
import re
from pathlib import Path

import pytest

from benchmark.core import cell as cells

SPEC = json.loads(cells.SPEC.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|units|head|expansion|_dim$|_rank$)")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_names():
    assert set(SPEC) == KEYS["top"]
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for group, kind in (("configs", "config"), ("workloads", "workload")):
        for e in SPEC[group]:
            assert set(e) == KEYS[kind], e["name"]
            assert NAME.match(e["name"]) and _line(e["why"])
    for group in ("end_to_end", "per_layer"):
        for m in SPEC[group]:
            assert set(m) - {"workloads"} == KEYS[group], m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [e["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for e in SPEC[g]]
    assert len(names) == len(set(names))


def test_command_paths_and_budget():
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells_max = 24
    assert (2 + 14 * cells_max) * (rs + 60) + cells_max * 2 * 90 + 1200 <= 43200


def test_bounds_and_metric_links():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cellnames = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        for w in m.get("workloads", cellnames):
            assert w in cellnames
            assert cells._reports(e2e[m["moves"]], w), (m["name"], w)


def test_configs_cover_cells_and_name_no_width():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and (cells.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and not any(WIDTHS.search(k) for k in c["reduced"])
        assert c["source"].startswith("https://")
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_from_its_files(name):
    c = cells.resolve(name)
    assert c.name == name and c.chips in (1, 4)
    assert c.config["name"] == name.split(".")[0]
    assert c.traffic["name"] == name.split(".", 1)[1]
    kind = cells.kind(c.traffic["kind"])
    for fn in ("setup", "route", "window", "numbers", "launch_counters"):
        assert callable(getattr(kind, fn))
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.metric_reader(m["name"]))
    assert c.limits and all({"limit", "lower", "upper"} <= set(v) for v in c.limits.values())
    assert {"setup_s", "frames_per_s"} <= {m["name"] for m in c.end_to_end}
    assert c.per_layer


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.resolve("no_such_config.no_such_traffic")


def test_checkpoints_are_pinned(tmp_path):
    for c in SPEC["configs"]:
        for form in cells.load_json(cells.ROOT / c["file"])["forms"].values():
            if "checkpoint" in form:
                assert Path(cells.checkpoint(form)).is_file()
    bad = tmp_path / "x.npz"
    bad.write_bytes(b"not the checkpoint")
    with pytest.raises(ValueError):
        cells.checkpoint({"checkpoint": str(bad), "sha256": "0" * 64})
