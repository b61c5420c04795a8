#!/usr/bin/env python3
"""Hold the GRU scan's inference forward of one direction against another
build of the port, bit for bit, on one CUDA card.

    python3 gru_scan_bits.py --out A.pt [--root DIR]
    python3 gru_scan_bits.py --out B.pt --against A.pt

Runs `gru_scan` of the ``speech_cloner_tpu_torch`` package under ``--root``
(default: this script's directory; another checkout, such as an earlier
commit unpacked with ``git archive``, builds its own kernels into its own
``build/``) on seeded operands at each shape of SHAPES, float32 and
bfloat16, and saves the outputs and the plans to ``--out``. With
``--against`` it compares each output with the saved one: one JSON line
per shape with whether every bit is equal, the largest difference, and
both plans' row tiles, register columns and stage depths (at one row a
cluster every instance sums in the same order; with more rows the
register instance sums in other sets than the shared-memory kernel, so
its bits may move within the kernel's tolerance). Prints the
``nvidia-smi`` name and power-limit line first. Needs a card; exits 1
without one, and 2 when a compared shape's bits differ where both plans
have one row a cluster.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

# (T, B): a stream window (T = 1008; B = 1, 4, 16), a sequence-parallel
# shard (T = 3401, B = 1), a small ragged batch, the convert's B = 59
SHAPES = [(T, B, H) for T, B in ((77, 1), (77, 13), (1008, 1), (1008, 4), (1008, 16),
                                 (3401, 1), (400, 59)) for H in (40, 128, 256)]
DTYPES = (torch.float32, torch.bfloat16)


def operands(T, B, H, dtype, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    lim = math.sqrt(6.0 / (3 * H))
    rnd = lambda *s, scale=1.0: (scale * torch.randn(s, generator=g, device="cuda")).to(dtype)  # noqa: E731
    return rnd(T, B, 2 * H), rnd(T, B, H), rnd(H, 2 * H, scale=lim), rnd(H, H, scale=lim)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="where to save the outputs and plans")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="the checkout whose package runs the scans")
    ap.add_argument("--against", default=None, help="a file an earlier run saved")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gru_scan_bits: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from speech_cloner_tpu_torch.ops import cuda_kernels as ck

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    limits = ck.device_limits(torch.cuda.current_device())
    saved = {}
    for dt in DTYPES:
        for i, (T, B, H) in enumerate(SHAPES):
            gx, cx, Wg, Wc = operands(T, B, H, dt, seed=1000 + i)
            ys = ck.gru_scan(gx, cx, Wg, Wc, ck.pack_gru_weights(Wg, Wc))
            plan = ck.gru_scan_plan(H, B, *limits, elem_bytes=dt.itemsize)
            saved[f"{dt},{T},{B},{H}"] = {
                "ys": ys.cpu(), "rows": plan.rows, "reg_columns": plan.reg_columns,
                "stage_steps": plan.stage_steps, "module": ck.__file__}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, args.out)
    if args.against is None:
        return 0
    base, rc = torch.load(args.against), 0
    for key, new in saved.items():
        old = base[key]
        diff = (new["ys"].float() - old["ys"].float()).abs().max().item()
        equal = torch.equal(new["ys"], old["ys"])
        if not equal and new["rows"] == old["rows"] == 1:
            rc = 2
        print(json.dumps({"nvidia_smi": smi, "shape": key, "bits_equal": equal,
                          "max_abs_diff": diff, "rows": new["rows"], "rows_against": old["rows"],
                          "reg_columns": new["reg_columns"],
                          "reg_columns_against": old["reg_columns"],
                          "stage_steps": new["stage_steps"],
                          "stage_steps_against": old["stage_steps"]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
