"""The harness finds every configuration, traffic mix, loop, track kind and
per-layer metric by the names in BENCHMARK.json, and the file keeps to the
benchmark's format."""

import json
import re

import pytest

import trackdrive_cells
from harness import cell as cells

SPEC = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
HELD = trackdrive_cells.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"] + HELD["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_by_name(workload):
    cell = trackdrive_cells.load(workload)
    assert cell.config["name"] == cell.config_name
    assert cells.loop_module(cell).Loop
    assert cells.track_module(cell).Drive
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m["name"]).read)
        assert m["moves"] in names, f"{m['name']} moves a metric {workload} does not report"


@pytest.mark.parametrize("metric", sorted({m["name"] for m in SPEC["per_layer"] + HELD["per_layer"]}))
def test_every_metric_has_a_reader(metric):
    assert (cells.BENCH / "metrics" / f"{metric.split('.', 1)[0]}.py").is_file()
    assert callable(cells.metric_reader(metric).read)


def test_held_out_cells_are_not_in_the_benchmark():
    assert not {w["name"] for w in SPEC["workloads"]} & {w["name"] for w in HELD["workloads"]}
    assert {c["name"] for c in HELD["configs"]} == {w["config"] for w in HELD["workloads"]}


def test_spec_keeps_to_the_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    every = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    assert all(NAME.match(x["name"]) for x in every)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    layers = {}
    for m in SPEC["per_layer"]:
        assert "\t" not in m["layer"] and len(m["layer"]) <= 200
        layers.setdefault(m["layer"], m["layer"])
    for c in SPEC["configs"] + HELD["configs"]:
        conf = json.loads((cells.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"] == []
        assert {"path_gap_m", "unanswered", "reference_fallbacks"} <= set(conf["check"])
    assert len(json.dumps(SPEC)) < 64 * 1024
