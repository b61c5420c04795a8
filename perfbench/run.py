"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program
(``speech_cloner_tpu_torch``) and ``BENCHMARK.json``. ``--trace 0`` prints
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics (spans,
the profiler and the work counts). Either way the run compares what the
timed path produced with the plain reference (``perfbench/reference``) and
prints ``correct`` with each compared number beside its limit: under
"checks", the last key of the line, and as the last lines of stderr.

``--control 1`` puts the reference, one precision below the
configuration's, in the program's place (the check of the limits; the
benchmark's own runs never set it).

Exit codes: 0 with a result line; 2 without a card (or fewer cards than
the cell asks for); 3 when JAX or the JAX package is loaded once the
window has closed. Neither prints a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "speech_cloner_tpu")


def _paths() -> None:
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _caches() -> None:
    """Every build or kernel cache at a fixed place inside the checkout, and
    few host threads."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "2")     # one process, few threads: steadier host times


def loaded_forbidden() -> list[str]:
    """Modules whose top-level name is JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_block(ctx, chips: int, peak: int, profile: dict | None) -> dict:
    import torch

    if ctx.on_card:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
               "memory_peak_bytes": peak}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if profile is not None:
        out["busy_s"] = profile["busy_s"]
        out["window_s"] = profile["window_s"]
    return out


def run_once(argv=None, *, require_chip: bool = True, device: str = "cuda", alter_cell=None,
             on_system=None):
    """One run: (exit code, the result line as a dict or None, every reading).
    Tests pass ``require_chip=False`` and ``device="cpu"`` with
    ``alter_cell`` (shrink the cell) and ``on_system`` (break the system)."""
    args = parse(argv)
    _paths()
    _caches()
    import torch

    from benchlib import cells
    from benchlib.check import judge
    from benchlib.driving import RunContext
    from benchlib.trace import Clock

    cell = cells.load_cell(args.workload)
    if alter_cell:
        alter_cell(cell)
    if require_chip and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        print(f"run.py: cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2, None, None
    bench = cells.benchmark()
    ctx = RunContext(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     control=bool(args.control), device=torch.device(device),
                     clock=Clock(T_START), on_system=on_system)
    res = cells.load_driver(cell.driver).run(cell, ctx)

    found = loaded_forbidden()
    if found:
        print(f"run.py: JAX or the JAX package loaded in this process: {found}", file=sys.stderr)
        return 3, None, None

    metrics = {}
    if ctx.trace:
        for m in cells.metrics_for(bench, cell.name, "per_layer"):
            v = cells.load_reader(m["name"])(res.layer)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cells.metrics_for(bench, cell.name, "end_to_end"):
            metrics[m["name"]] = {"value": res.end_to_end[m["name"]], "unit": m["unit"]}

    correct, checks, failed = judge(res.numbers, cell.limits)
    out = {"correct": correct, "attempted": res.attempted, "failed": failed,
           "metrics": metrics,
           "device": device_block(ctx, cell.chips, res.memory_peak_bytes, res.profile)}
    if res.profile is not None:
        out["breakdown"] = {"device_ops": res.profile["device_ops"],
                            "idle_gaps": res.profile["idle_gaps"]}
    out["checks"] = checks
    return 0, out, res.numbers.values


def main(argv=None, **kwargs) -> int:
    rc, out, readings = run_once(argv, **kwargs)
    if out is None:
        return rc
    from benchlib.check import print_checks

    print(f"run.py: readings {json.dumps(readings)}; {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr)
    print_checks(out["checks"], out["correct"])
    print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
