#!/usr/bin/env python3
"""Time the GRU scan kernels under several launch plans on one CUDA card.

    python3 gru_scan_sweep.py [--T 400] [--B 59 ...] [--dtype float32|bfloat16]
                              [--backward | --gates] [--dirs 1|2] [--stage-steps S]
                              [--default | --attribute] [--out FILE.jsonl]

Which kernel: the forward (float32 or, with ``--dtype bfloat16``, bf16
operands), with ``--gates`` the training forward (the gates r, u, c out
too), or with ``--backward`` the backward, of either operand type
(``--dirs 2``: both directions in one launch, of the inference forward, the
training forward or the backward). The bf16 training forward, backward and
both-directions inference forward take their staged instance (a ring of
S-step stages in shared memory filled and drained by the TMA) where the
plan gives a stage depth; ``--stage-steps S`` forces S for every plan (0:
the unstaged instance). For each H in ``--widths`` and each B:

- default (a plan sweep): each cluster size that fits and each row tile R,
  the plan built by `gru_scan_plan` with R forced through its fields; the
  kernel against its plain version, timed with CUDA events (mean of 20
  launches after 3 warm-ups), the distinct SMs its CTAs ran on (forward);
  ``--default`` times the default plan only (to compare two trees in turns);
- ``--attribute``: the default plan only, once per probe build of
  csrc/gru_scan.cu (``-DSCL_PROBE=<bits>``, each taking one part out of a
  step: the shared-memory weight loads, the bf16 widening, the shuffle
  reductions, the device-memory loads and stores, all products), so the
  differences from the full build attribute a step's time. The exchanges
  cannot be taken out without breaking the cluster's protocol: what remains
  with products, reductions and device memory all out ("floor") is the
  exchanges with the element-wise work. A staged instance's steps touch no
  device memory and its stage copies run in every build, so "global" is not
  timed on a staged plan and its "floor" keeps the copies; to see what device
  memory costs at that shape, attribute the unstaged instance
  (``--stage-steps 0``).

Prints one JSON line per row, the default plan marked, after the
``nvidia-smi`` name and power-limit line; ``--out`` also writes the JSON
lines to a file. Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

# kernel against plain version, max-abs (forward) or of the peak (training
# forward, backward): chip_smoke.py's KERNEL_TOL and TRAIN_TOL (bf16
# outputs: one bf16 ulp, 2^-7 of the peak, on top)
TOL = {"float32": 1e-4, "bfloat16": 2.0**-8 + 1e-4, "backward": 1e-4,
       "backward_bfloat16": 2.0**-7 + 1e-4}
# csrc/gru_scan.cu's probe bits
PROBES = {"full": 0, "weights": 1, "widen": 2, "shuffle": 4, "global": 8, "products": 16,
          "floor": 16 | 4 | 8}


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


@dataclasses.dataclass
class Case:
    """One kernel at one (T, B, H): its packing by cluster size, its launch
    with a plan, its error against the plain version."""
    pack: object
    launch: object
    error: object
    tol: float


def forward_case(ck, gen, T, B, H, dtype, dirs=1) -> Case:
    """The inference forward of one direction, or (``dirs`` 2) of both
    directions in one launch against `gru_scan_fused_plain`."""
    lim = math.sqrt(6.0 / (3 * H))
    rnd = lambda *s, scale=1.0: (scale * torch.randn(s, generator=gen, device="cuda")).to(dtype)  # noqa: E731
    lead = (dirs,) if dirs == 2 else ()
    gx, cx = rnd(*lead, T, B, 2 * H), rnd(*lead, T, B, H)
    Wg, Wc = rnd(*lead, H, 2 * H, scale=lim), rnd(*lead, H, H, scale=lim)
    if dirs == 2:
        ref = ck.gru_scan_fused_plain(gx, cx, Wg, Wc).float()
        pack = lambda C: torch.stack([ck.pack_gru_weights(a, b, cluster=C)  # noqa: E731
                                      for a, b in zip(Wg, Wc)])
    else:
        ref = ck.gru_scan_plain(gx, cx, Wg, Wc).float()
        pack = lambda C: ck.pack_gru_weights(Wg, Wc, cluster=C)  # noqa: E731
    return Case(pack,
                lambda packed, plan, sm_ids=None: ck.gru_scan_launch(gx, cx, packed, plan,
                                                                     sm_ids=sm_ids),
                lambda got: (got.float() - ref).abs().max().item(),
                TOL[str(dtype).removeprefix("torch.")])


def peak_error(got, refs) -> float:
    return max((g.float() - r.float()).abs().max().item()
               / max(r.float().abs().max().item(), 1e-30) for g, r in zip(got, refs))


def train_forward_case(ck, gen, T, B, H, dirs, dtype) -> Case:
    """The training forward (ys and the gates) of ``dirs`` directions."""
    lim = math.sqrt(6.0 / (3 * H))
    rnd = lambda *s, scale=1.0: (scale * torch.randn(s, generator=gen, device="cuda")).to(dtype)  # noqa: E731
    gx, cx = rnd(dirs, T, B, 2 * H), rnd(dirs, T, B, H)
    Wg, Wc = rnd(dirs, H, 2 * H, scale=lim), rnd(dirs, H, H, scale=lim)
    refs = ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)
    gates = torch.empty((dirs, T, B, 3 * H), dtype=torch.float32, device="cuda")

    def launch(packed, plan, sm_ids=None):
        if dirs == 1:
            ys = ck.gru_scan_launch(gx[0], cx[0], packed[0], plan, sm_ids, gates)[None]
        else:
            ys = ck.gru_scan_launch(gx, cx, packed, plan, sm_ids, gates)
        return ys, gates

    return Case(lambda C: torch.stack([ck.pack_gru_weights(a, b, cluster=C)
                                       for a, b in zip(Wg, Wc)]),
                launch, lambda got: peak_error(got, refs),
                TOL["backward" if dtype == torch.float32 else "backward_bfloat16"])


def backward_case(ck, gen, T, B, H, dirs, dtype=torch.float32) -> Case:
    lim = math.sqrt(6.0 / (3 * H))
    rnd = lambda *s, scale=1.0: (scale * torch.randn(s, generator=gen, device="cuda")).to(dtype)  # noqa: E731
    gx, cx = rnd(dirs, T, B, 2 * H), rnd(dirs, T, B, H)
    Wg, Wc = rnd(dirs, H, 2 * H, scale=lim), rnd(dirs, H, H, scale=lim)
    ys, gates = ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)
    dys = rnd(dirs, T, B, H)
    refs = ck.gru_scan_backward_plain(dys, ys, gates, Wg, Wc)

    return Case(lambda C: torch.stack([ck.pack_gru_weights_bwd(a, b, cluster=C)
                                       for a, b in zip(Wg, Wc)]),
                lambda packed, plan, sm_ids=None: ck.gru_scan_bwd_launch(
                    dys, ys, gates, packed, plan, stacked=dirs == 2),
                lambda got: peak_error(got, refs),
                TOL["backward" if dtype == torch.float32 else "backward_bfloat16"])


def plans(ck, H, B, limits, elem, dirs, backward, gates=False, stage_steps=None):
    """(default plan, [every plan of each cluster size and row tile that
    fits]); ``stage_steps`` forces the stage depth where it is not None."""
    kw = dict(elem_bytes=elem, dirs=dirs, backward=backward, gates=gates)
    default = ck.gru_scan_plan(H, B, *limits, stage_steps=stage_steps, **kw)
    out = []
    for C in (1, 2, 4, 8, 16):
        try:
            base = ck.gru_scan_plan(H, B, *limits, cluster=C, stage_steps=stage_steps, **kw)
        except (RuntimeError, ValueError):   # does not fit or cannot stage this cluster size
            continue
        threads = base.threads
        for R in ck.ROWS_PER_CTA:
            S = (ck.gru_stage_steps(H, C, R, limits[1], elem, backward, gates)
                 if stage_steps is None else
                 stage_steps if ck.gru_reg_columns(H, R, threads, backward, gates, True) else 0)
            smem = ck.gru_scan_smem_bytes(H, C, R, elem, backward, gates, S)
            if smem <= limits[1]:
                out.append(dataclasses.replace(base, rows=R, clusters=-(-B // R),
                                               smem_bytes=smem, stage_steps=S))
    return default, out


def time_plan(ck, case: Case, plan, packed, T: int, forward: bool) -> dict:
    row = {"C": plan.cluster, "R": plan.rows, "threads": plan.threads,
           "clusters": plan.clusters, "ctas": plan.ctas, "smem_bytes": plan.smem_bytes,
           "stage_steps": plan.stage_steps}
    row["reg_columns"] = plan.reg_columns    # the instance's; 0: weights in shared memory
    sm_ids = torch.full((plan.ctas,), -1, dtype=torch.int32, device="cuda") if forward else None
    try:        # a plan the card refuses is a row of the sweep
        got = case.launch(packed, plan, sm_ids)
    except RuntimeError as e:
        return {**row, "error": str(e)}
    err = case.error(got)
    row.update(max_err=err, ok=err <= case.tol)
    if sm_ids is not None:
        row["sms"] = len(set(sm_ids.tolist()))
    row["ms"] = cuda_ms(lambda: case.launch(packed, plan))
    row["us_per_step"] = row["ms"] * 1000 / T
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=400)
    ap.add_argument("--B", type=int, nargs="+", default=[59])
    ap.add_argument("--widths", type=int, nargs="+", default=[40, 128, 256])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--backward", action="store_true", help="the backward kernel")
    ap.add_argument("--gates", action="store_true",
                    help="the training forward (the gates out too)")
    ap.add_argument("--dirs", type=int, choices=(1, 2), default=1)
    ap.add_argument("--stage-steps", type=int, default=None,
                    help="stage depth S of the staged bf16 instances (0: unstaged)")
    ap.add_argument("--default", action="store_true", help="time the default plan only")
    ap.add_argument("--attribute", action="store_true",
                    help="time the default plan under each probe build")
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
    dtype = getattr(torch, args.dtype)
    elem = dtype.itemsize
    if args.backward and args.gates:
        ap.error("--backward and --gates name two kernels")
    kernel = ("gru_scan_fused" if args.dirs == 2 else "gru_scan") + (
        "_bwd" if args.backward else "_train" if args.gates else "")
    probes = {k: v for k, v in PROBES.items() if k != "widen" or args.dtype == "bfloat16"}
    libs = {}
    if args.attribute:              # every probe build at once, one nvcc each
        with concurrent.futures.ThreadPoolExecutor(len(probes)) as pool:
            libs = dict(zip(probes, pool.map(
                lambda bits: ck.load_library("gru_scan", (f"SCL_PROBE={bits}",)),
                probes.values())))
    lines = []
    gen = torch.Generator("cuda").manual_seed(0)
    T = args.T

    def emit(row):
        lines.append(json.dumps({"nvidia_smi": smi, "kernel": kernel, "dtype": args.dtype,
                                 "dirs": args.dirs, "stage_steps_arg": args.stage_steps, **row}))
        print(lines[-1], flush=True)

    for B in args.B:
        for H in args.widths:
            if args.backward:
                case = backward_case(ck, gen, T, B, H, args.dirs, dtype)
            elif args.gates:
                case = train_forward_case(ck, gen, T, B, H, args.dirs, dtype)
            else:
                case = forward_case(ck, gen, T, B, H, dtype, args.dirs)
            if args.default or args.attribute:
                default, every = ck.gru_scan_plan(
                    H, B, *limits, elem_bytes=elem, dirs=args.dirs, backward=args.backward,
                    gates=args.gates, stage_steps=args.stage_steps), []
            else:
                default, every = plans(ck, H, B, limits, elem, args.dirs, args.backward,
                                       args.gates, args.stage_steps)
            if args.attribute:
                packed = case.pack(default.cluster)
                load = ck.load_library
                try:
                    for name, lib in libs.items():
                        if name == "global" and default.stage_steps:
                            continue
                        ck.load_library = lambda *a, _lib=lib, **k: _lib  # noqa: E731
                        emit({"H": H, "B": B, "T": T, "probe": name, "bits": probes[name],
                              **time_plan(ck, case, default, packed, T,
                                          not args.backward)})
                finally:
                    ck.load_library = load
                continue
            for plan in [default] if args.default else every:
                emit({"H": H, "B": B, "T": T, "default": (plan.cluster, plan.rows) ==
                      (default.cluster, default.rows),
                      **time_plan(ck, case, plan, case.pack(plan.cluster), T,
                                  not args.backward)})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
