"""Read a cell's compared numbers over many seeds in one process: the
program's (the lower readings of its limits) or the control's, the
reference one precision below the configuration's (the upper readings).

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 [--control 1] [--seconds 1]

One JSON line per seed: {"seed", "control", "correct", "readings"}; each
seed makes its own weights, inputs and system, as a run of ``run.py`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, out, readings = run.run_once(
                ["--workload", args.workload, "--seed", str(seed), "--seconds", str(args.seconds),
                 "--control", str(args.control)])
        if rc:
            print(err.getvalue()[-2000:], file=sys.stderr)
            return rc
        print(json.dumps({"seed": seed, "control": args.control, "correct": out["correct"],
                          "attempted": out["attempted"], "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
