"""The result line: exactly the contract's keys, the cell's metrics and
nothing else, the compared numbers last; no result without a card."""

from __future__ import annotations

import contextlib
import io
import json

import pytest
from tiny import ROOT, run_cell

from benchlib import cells

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", ("offline60_f32", "stream16_f32"))
def test_end_to_end_line(name):
    rc, res, err = run_cell(name)
    assert rc == 0 and list(res) == KEYS
    want = {m["name"] for m in cells.metrics_for(BENCH, name, "end_to_end")}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    lines = err.strip().splitlines()
    assert lines[-1].startswith("check correct")
    assert [ln.split()[1] for ln in lines[-1 - len(res["checks"]):-1]] == list(res["checks"])


@pytest.mark.parametrize("name", ("offline60_bf16", "longform_f32", "stream16_f32"))
def test_traced_line(name):
    rc, res, _ = run_cell(name, trace=1)
    assert rc == 0 and list(res) == KEYS[:5] + ["breakdown", "checks"]
    want = {m["name"] for m in cells.metrics_for(BENCH, name, "per_layer")}
    # on the CPU the device-trace metrics find nothing to read and are left out
    assert set(res["metrics"]) <= want and res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())


def test_no_result_without_a_card():
    import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", "offline60_f32", "--seed", "1", "--seconds", "1"],
                      device="cpu")
    assert rc == 2 and out.getvalue() == ""
