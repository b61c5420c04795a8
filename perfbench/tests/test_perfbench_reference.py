"""The reference agrees with the port at a small size on the CPU, the
control fails, and neither the reference nor the harness loads JAX or the
JAX package (the reference not the port either): each checked by the
top-level name, the part before the first dot, whole."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from tiny import PERFBENCH, ROOT, run_cell

CELLS = ("offline60_f32", "offline60_bf16", "longform_f32", "stream16_f32")
SCAN = """
import sys, json
sys.path[:0] = [{perfbench!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(body: str) -> set[str]:
    code = SCAN.format(perfbench=str(PERFBENCH), root=str(ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_jax_or_either_package():
    mods = _top_level("import reference.pipeline, reference.stream, reference.precision")
    assert not mods & {"jax", "jaxlib", "flax", "speech_cloner_tpu", "speech_cloner_tpu_torch"}


def test_harness_imports_neither_jax_nor_the_jax_package():
    body = ("import run, tiny; rc = run.main(['--workload', 'stream16_f32', '--seed', '3', "
            "'--seconds', '0.2'], require_chip=False, device='cpu', alter_cell=tiny.shrink); "
            "assert rc == 0")
    mods = _top_level("sys.path.insert(0, %r)\n" % str(PERFBENCH / "tests") + body)
    assert "speech_cloner_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "speech_cloner_tpu"}


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    rc, res, err = run_cell(name, seed=2**33 + 5)
    assert rc == 0 and res["correct"], err[-2000:]
    assert res["failed"] == 0 and res["attempted"] >= 1
    # float32 cells read round-off, far inside their limits; the bf16 cell's
    # readings are its models' bf16 rounding
    margin = 1 if name.endswith("bf16") else 10
    for k, c in res["checks"].items():
        assert c["value"] is not None and c["value"] <= c["limit"] / margin, (k, c)


def test_bf16_control_fails():
    # fp8 operands in the models: the control of the bf16 configuration (TF32,
    # the f32 configurations' control, exists only on the card)
    rc, res, _ = run_cell("offline60_bf16", control=1)
    assert rc == 0 and not res["correct"]
