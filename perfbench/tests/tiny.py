"""Shared by the benchmark's tests: the checkout on ``sys.path``, a cell cut
to a size a CPU test holds, a run of the harness in this process, and the
card fixture for tests marked ``gpu``."""

from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent
for _p in (str(PERFBENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def shrink(cell) -> None:
    """Small widths, 40-frame windows, 1 s clips, a few Griffin-Lim rounds,
    two streams with short chunks: the same code paths at CPU size."""
    c, t = cell.config, cell.traffic
    c["encoder"].update(input_shape=[40, 80], embed_size=16, num_conv_banks=2)
    c["decoder"].update(input_shape=[40, 61], steps_v=[
        {"embed_size": 16, "n_output": 80, "num_conv_banks": 3, "num_highwaynet_blocks": 1},
        {"embed_size": 16, "n_output": 201, "num_conv_banks": 2, "num_highwaynet_blocks": 1}])
    c["vocoder"]["n_iter"] = 4
    t.update(clip_seconds=1.0, pool=2, warmup=1, sample=1, sample_range=2, profiled=1)
    if t["driver"] == "stream":
        t.update(streams=2, clip_seconds=2.0, sample_range=3)
        t["geometry"].update(chunk_frames=40, context_frames=40, lookahead_frames=20)
        t["vocoder"]["n_iter"] = 3


def run_cell(name: str, seed: int = 7, seconds: float = 0.5, trace: int = 0, control: int = 0,
             on_system=None, alter=shrink, device: str = "cpu"):
    """(exit code, the last stdout line as a dict or None, stderr)."""
    import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace), "--control", str(control)],
                      require_chip=device != "cpu", device=device, alter_cell=alter,
                      on_system=on_system)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture
def card():
    """Skip where no CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
