"""Find a cell, its configuration, its traffic mix, its driver and its
metrics by name, from their files.

Layout, relative to the ``perfbench`` folder:

- ``workloads/<cell>.json``: {"config", "traffic", "chips", "why", "limits"}
- ``configs/<config>.json``: the model configuration as it is run
- ``traffic/<mix>.json``: {"driver", ...the mix's parameters}
- ``traffic/<driver>.py``: the generator and timed loop of a kind of traffic
- ``layer_metrics/<metric>.py``: ``read(ctx)`` of one per-layer metric

``BENCHMARK.json`` at the checkout's root says which metrics each cell
reports. Adding a cell, a mix, a configuration or a metric adds files and
entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # the perfbench folder
ROOT = HERE.parent                                      # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def _load_module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    why: str
    limits: dict

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_cell(name: str) -> Cell:
    """The cell ``name`` with its configuration and traffic mix read."""
    w = read_json(HERE / "workloads" / f"{_name('cell', name)}.json")
    config = read_json(HERE / "configs" / f"{_name('config', w['config'])}.json")
    traffic = read_json(HERE / "traffic" / f"{_name('traffic', w['traffic'])}.json")
    return Cell(name=name, config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, chips=int(w["chips"]),
                why=w["why"], limits=dict(w["limits"]))


def cell_names() -> list[str]:
    return sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def load_driver(name: str):
    """The module ``traffic/<name>.py``: ``run(cell, system, opts)``."""
    return _load_module(HERE / "traffic" / f"{_name('driver', name)}.py", f"pb_driver_{name}")


def load_reader(metric: str):
    """``read(ctx)`` of ``layer_metrics/<metric>.py``."""
    tag = "pb_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", metric)
    return _load_module(HERE / "layer_metrics" / f"{_name('metric', metric)}.py", tag).read


def metrics_for(bench: dict, cell: str, kind: str) -> list[dict]:
    """The entries of ``bench[kind]`` ("end_to_end" or "per_layer") that
    ``cell`` reports: those without "workloads" and those that list it."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]
