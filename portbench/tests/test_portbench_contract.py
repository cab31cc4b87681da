"""BENCHMARK.json against the benchmark's contract, and the files the
harness finds by name."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
sys.path[:0] = [str(ROOT / "src"), str(PB)]

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [c["name"] for c in BENCH["configs"]]
                         + [w["name"] for w in BENCH["workloads"]]
                         + [w["traffic"] for w in BENCH["workloads"]]
                         + [k for c in BENCH["configs"] for k in c["reduced"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_direction(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "layer", "moves", "workloads"}


def test_names_unique():
    for group in (METRICS, BENCH["configs"], BENCH["workloads"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_moves_is_reported_by_each_cell_it_lists(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[metric["moves"]]
    for w in metric["workloads"]:
        assert "workloads" not in moved or w in moved["workloads"], (
            metric["name"], w)
    assert (PB / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    cfg = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    assert (ROOT / cfg["file"]).is_file()
    traffic = json.loads((PB / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    assert (PB / "drivers" / f"{traffic['driver']}.py").is_file()
    assert (PB / "limits" / f"{cell['name']}.json").is_file()
    e2e = [m for m in BENCH["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    assert len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_holds_the_config_as_run(cfg):
    from benchkit import configs
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    # every key that differs from the published value is listed
    assert sorted(data["published"]) == sorted(cfg["reduced"])
    configs.port_config(data)
