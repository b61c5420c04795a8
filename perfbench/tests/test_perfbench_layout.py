"""The benchmark's files: every cell, configuration, traffic mix, driver and
per-layer metric is found by name, BENCHMARK.json keeps to its contract,
and a new cell file is picked up without editing any other file."""

from __future__ import annotations

import json
import math
import re
import shutil

import pytest
from tiny import PERFBENCH, ROOT

from benchlib import cells

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion)")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    cell = cells.load_cell(w["name"])
    assert (cell.config_name, cell.traffic_name, cell.chips, cell.why) == \
        (w["config"], w["traffic"], w["chips"], w["why"])
    assert cells.load_driver(cell.driver).run
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"perfbench/configs/{c['name']}.json"
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["reduced"] == c["reduced"] == []
    assert not any(WIDTH.search(k) for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_layer_metric_found_by_name(m):
    assert callable(cells.load_reader(m["name"]))
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    moved = e2e[m["moves"]]
    for cell in m["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["source"])
    assert all("\n" not in k and len(k) <= 200 for k in layers)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_enough(w):
    e2e = [m["name"] for m in cells.metrics_for(BENCH, w["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cells.metrics_for(BENCH, w["name"], "per_layer")


def test_check_fits_the_time_it_is_allowed():
    n = 24
    total = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


def test_new_cell_file_is_picked_up(tmp_path, monkeypatch):
    copy = tmp_path / "perfbench"
    shutil.copytree(PERFBENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    w = json.loads((copy / "workloads" / "offline60_f32.json").read_text())
    (copy / "traffic" / "offline_short.json").write_text(json.dumps(
        {"driver": "offline", "clip_seconds": 6, "pool": 2, "warmup": 1, "sample": 1,
         "sample_range": 4, "profiled": 1}))
    (copy / "workloads" / "offline_short_f32.json").write_text(json.dumps(
        dict(w, traffic="offline_short", why="short clips")))
    monkeypatch.setattr(cells, "HERE", copy)
    assert "offline_short_f32" in cells.cell_names()
    cell = cells.load_cell("offline_short_f32")
    assert cell.traffic["clip_seconds"] == 6 and cell.driver == "offline"
    assert math.isclose(cell.limits["stft"], w["limits"]["stft"])
