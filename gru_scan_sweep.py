#!/usr/bin/env python3
"""Time the GRU scan kernel under several launch plans on one CUDA card.

    python3 gru_scan_sweep.py [--T 400] [--B 59] [--out FILE.jsonl]

For H in 40, 128, 256 (the widths of one convert), each cluster size that
fits and each row tile R, builds the plan with `gru_scan_plan` (R forced
through the plan's fields), checks the kernel
against `gru_scan_plain` (max-abs, limit 1e-4), times it with CUDA events
(mean of 20 launches after 3 warm-ups) and counts the distinct SMs its CTAs
ran on. Prints one JSON line per plan, the default plan marked, and the
``nvidia-smi`` name and power-limit line first; ``--out`` also writes the
JSON lines to a file. Needs a card; exits 1
without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

TOL = 1e-4


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=400)
    ap.add_argument("--B", type=int, default=59)
    ap.add_argument("--widths", type=int, nargs="+", default=[40, 128, 256])
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gru_scan_sweep: no CUDA device available", file=sys.stderr)
        return 1
    from speech_cloner_tpu_torch.ops import cuda_kernels as ck

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    limits = ck.device_limits(torch.cuda.current_device())
    lines = []
    gen = torch.Generator("cuda").manual_seed(0)
    T, B = args.T, args.B
    for H in args.widths:
        lim = math.sqrt(6.0 / (3 * H))
        gx = torch.randn((T, B, 2 * H), generator=gen, device="cuda")
        cx = torch.randn((T, B, H), generator=gen, device="cuda")
        Wg = lim * torch.randn((H, 2 * H), generator=gen, device="cuda")
        Wc = lim * torch.randn((H, H), generator=gen, device="cuda")
        ref = ck.gru_scan_plain(gx, cx, Wg, Wc)
        default = ck.gru_scan_plan(H, B, *limits)
        for C in (1, 2, 4, 8, 16):
            try:
                base = ck.gru_scan_plan(H, B, *limits, cluster=C)
            except RuntimeError:        # does not fit this cluster size
                continue
            packed = ck.pack_gru_weights(Wg, Wc, cluster=C)
            for R in ck.ROWS_PER_CTA:
                smem = ck.gru_scan_smem_bytes(H, C, R)
                if smem > limits[1]:
                    continue
                plan = dataclasses.replace(base, rows=R, clusters=-(-B // R),
                                           smem_bytes=smem)
                row = {"H": H, "B": B, "T": T, "C": C, "R": R, "threads": plan.threads,
                       "clusters": plan.clusters, "ctas": plan.ctas, "smem_bytes": smem,
                       "default": (C, R) == (default.cluster, default.rows)}
                sm_ids = torch.full((plan.ctas,), -1, dtype=torch.int32, device="cuda")
                try:        # a plan the card refuses is a row of the sweep
                    got = ck.gru_scan_launch(gx, cx, packed, plan, sm_ids=sm_ids)
                except RuntimeError as e:
                    row["error"] = str(e)
                else:
                    err = (got - ref).abs().max().item()
                    row.update(sms=len(set(sm_ids.tolist())), max_abs_err=err,
                               ok=err <= TOL)
                    row["ms"] = cuda_ms(lambda: ck.gru_scan_launch(gx, cx, packed, plan))
                    row["us_per_step"] = row["ms"] * 1000 / T
                lines.append(json.dumps({"nvidia_smi": smi, **row}))
                print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
