"""Finding a cell's files by the names in ``BENCHMARK.json``.

A workload names a configuration (``configs/<config>.json``) and a traffic
mix (``mixes/<traffic>.json``); the mix names its generator
(``generators/<generator>.py``), the one general generator of that kind of
traffic.
The limits of the cell's correctness comparison are
``limits/<workload>.json``; each per-layer metric is read by
``metrics/<metric>.py``. Adding a cell, a mix or a metric adds files and
entries; no file here needs an edit.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    seed: int
    device: object
    end_to_end: list
    per_layer: list
    limits: dict


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(bench: dict, workload: str, seed: int, device,
              overrides: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``bench``; ``overrides`` replace top-level
    keys of the configuration and the mix (``{"cfg": {...}, "mix":
    {...}}``), which the CPU tests use to shrink a cell."""
    w = next((c for c in bench["workloads"] if c["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = load_json(HERE.parent / conf["file"])
    mix = load_json(HERE / "mixes" / f"{w['traffic']}.json")
    overrides = overrides or {}
    cfg.update(overrides.get("cfg", {}))
    mix.update(overrides.get("mix", {}))
    lim_path = HERE / "limits" / f"{workload}.json"
    limits = load_json(lim_path) if lim_path.exists() else {}
    return Cell(workload, cfg, mix, int(seed), device,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)],
                limits)


def generator(cell: Cell):
    mod = importlib.import_module(f"port_bench.generators.{cell.mix['generator']}")
    return mod.Generator(cell)


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
