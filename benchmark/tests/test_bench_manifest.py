"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
against the files the harness finds by that name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import common, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = run.manifest()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert len(BENCH["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = json.loads((common.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert cfg["reduced"] == [] and set(data["assumed"]) == {"train_images", "eval_images", "width", "height"}
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_are_data_found_by_name(cell):
    data = common.load_json("workloads", cell["name"])
    assert (data["config"], data["traffic"], data["chips"]) == (cell["config"], cell["traffic"], cell["chips"])
    common.load_json("traffic", cell["traffic"])
    assert (common.BENCH_DIR / "loops" / f"{data['loop']}.py").exists()
    assert data["limits"], "every cell compares at least one number"
    e2e = run.cell_metrics(BENCH, cell["name"], traced=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert run.cell_metrics(BENCH, cell["name"], traced=True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    assert callable(run.reader(metric["name"]))
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        for w in metric["workloads"]:
            assert metric["moves"] in {m["name"] for m in run.cell_metrics(BENCH, w, traced=False)}


def test_a_layer_is_named_alike_everywhere():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(layer == layer.strip() for layer in layers)
    assert {"data", "engine", "model step", "kernel K1", "device"} == layers
