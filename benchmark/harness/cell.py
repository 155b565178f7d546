"""Find a cell of `BENCHMARK.json` and everything it names, by name.

A cell names a configuration (its JSON file, given in `BENCHMARK.json`) and a
traffic mix (`traffic/<name>.json`). The traffic names its loop
(`loops/<loop>.py`), the configuration its track kind (`tracks/<kind>.py`),
and a per-layer metric is read by the reader of its family,
`metrics/<name up to its first dot>.py`, which serves `pathing_ms.online`
and `pathing_ms.sweep` alike. Adding a cell, a configuration, a mix or a
metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_module(path: Path) -> ModuleType:
    """Import a file of the harness by path (names may hold dots)."""
    name = "bench_" + re.sub(r"\W", "_", str(path.relative_to(BENCH).with_suffix("")))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``spec``, by default `BENCHMARK.json`."""
    spec = spec or json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=conf["name"],
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def loop_module(cell: Cell) -> ModuleType:
    return load_module(BENCH / "loops" / f"{cell.traffic['loop']}.py")


def track_module(cell: Cell) -> ModuleType:
    return load_module(BENCH / "tracks" / f"{cell.config['track']['kind']}.py")


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH / "metrics" / f"{name.split('.', 1)[0]}.py")
