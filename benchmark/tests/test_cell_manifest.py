"""BENCHMARK.json against the benchmark's contract: its keys, names and
units, the files each entry names, bounds, layers and run length."""

import json
import os
import re

import pytest

from benchmark import manifest

from .conftest import ROOT

M = manifest.load(ROOT)
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"] and M["command"] == ["python3", "benchmark/run.py"]


@pytest.mark.parametrize("name", [e["name"] for e in M["configs"] + M["workloads"] + METRICS]
                         + [w["config"] for w in M["workloads"]]
                         + [w["traffic"] for w in M["workloads"]]
                         + [k for c in M["configs"] for k in c["reduced"]])
def test_names(name):
    assert manifest.NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_keys(metric):
    assert manifest.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert re.fullmatch(r"[\x20-\x7e]{1,200}", metric.get("layer", "x"))
    e2e = metric in M["end_to_end"]
    allowed = ({"name", "unit", "better", "bound", "source", "workloads"} if e2e else
               {"name", "unit", "better", "source", "layer", "moves", "workloads"})
    assert set(metric) <= allowed and set(metric) >= allowed - {"workloads"}
    assert metric["source"] in (("host_clock", "device_trace") if e2e else
                                ("device_trace", "program_span", "program_counter", "host_clock"))
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_unique_names():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds():
    bounds = {m["name"]: m["bound"] for m in M["end_to_end"]}
    assert bounds["setup_s"] <= 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())


def test_per_layer_moves_an_end_to_end_metric_each_cell_reports():
    for m in M["per_layer"]:
        e2e = [e for e in M["end_to_end"] if e["name"] == m["moves"]]
        assert e2e
        for cell in m.get("workloads", CELLS):
            assert manifest.reports(e2e[0], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    c = manifest.cell(ROOT, cell)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    c = manifest.cell(ROOT, cell)
    cfg = [e for e in M["configs"] if e["name"] == c.workload["config"]][0]
    assert cfg["file"].startswith("benchmark/configs/")
    assert os.path.isfile(os.path.join(ROOT, "benchmark", "drivers", f"{c.config['driver']}.py"))
    assert os.path.isfile(os.path.join(ROOT, "benchmark", "checks", f"{c.config['check']}.py"))
    for m in c.per_layer:
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "layer_metrics", f"{m['name']}.py"))
    assert set(c.limits) <= set(manifest.check(ROOT, c.config).NUMBERS) and c.limits
    assert re.fullmatch(r"[\x20-\x7e]{1,200}", c.workload["why"])
    assert c.workload["chips"] in (1, 4)


def test_config_files_are_distinct_and_sources_public():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    assert all(c["source"].startswith("https://") for c in M["configs"])


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = M["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_manifest_is_small():
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    json.dumps(M)
