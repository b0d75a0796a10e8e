"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by the names it gives."""
import importlib
import json
import re
from pathlib import Path

import pytest

from port_bench import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_run_seconds_fits_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells_max = 24
    assert (2 + 14 * cells_max) * (rs + 60) + cells_max * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert _line(conf["source"]) and _line(conf["why"])
    assert conf["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"] and len(conf["reduced"]) <= 16
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(conf["file"]) == 1


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"])
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    mix = json.loads((ROOT / "port_bench" / "mixes" / f"{w['traffic']}.json").read_text())
    importlib.import_module(f"port_bench.generators.{mix['generator']}").Generator
    limits = json.loads((ROOT / "port_bench" / "limits" / f"{w['name']}.json").read_text())
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    cell = cells.load_cell(BENCH, w["name"], 1, "cpu")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(cells.metric_reader(m["name"]))
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


def test_four_chip_cells_within_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    e2e = m in BENCH["end_to_end"]
    keys = ({"name", "unit", "better", "bound", "source"} if e2e else
            {"name", "unit", "better", "source", "layer", "moves"})
    assert set(m) - {"workloads"} == keys
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    if e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert _line(m["layer"])
        assert m["moves"] in {x["name"] for x in BENCH["end_to_end"]}
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", names)) <= names


def test_setup_metric_and_layer_names():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
