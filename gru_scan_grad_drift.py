#!/usr/bin/env python3
"""Measure the bf16 GRU scan's gradient on a CUDA card against the CPU's,
and how much of the gap the forward's bf16 outputs explain.

    python3 gru_scan_grad_drift.py [--shapes H,T,B ...] [--out FILE.jsonl] [--device cuda|cpu]

For each (H, T, B) (default 128,77,13 and 256,400,32: a ragged last stage
and row tile, and a train step's shape), both directions, bf16 operands
drawn from a seeded CPU generator (seed H), the loss sum(ys * w):
`gru_scan_fused` with autograd (`GruScan`: on the card the staged training
forward and backward, on the CPU the plain loops). Its ``ys`` row: the
elements whose bf16 value differs between the card's and the CPU's
forward, the largest difference, and a digest of each side's ys (it tells
which side moved when two runs differ); ``gates_max_err``: the float32
gates'.
Then, per gradient leaf (gx, cx, Wg_h, Wc_h), the card's gradient against

- ``cpu_forward``: the CPU's own gradient (the end-to-end gap);
- ``card_ys``: the CPU's backward (`gru_scan_train_backward`, then
  `gru_weight_grads`) run on the card's ys with the CPU's gates;
- ``card_forward``: the same run on the card's ys and gates (the card's
  backward alone);
- ``card_input_grads``: the CPU's `gru_weight_grads` of the card's ys,
  gates, dgx and dcx (the weight products alone; gx and cx are the card's
  own there);

each as the largest error, the largest ratio of error to the bf16 limit of
tests/test_torch_port_cuda.py (2^-7 |ref| + 1e-4 of the peak; at most 1
passes) and the elements over it. Prints one JSON line per shape after
the ``nvidia-smi`` name and power-limit line (with ``--device cpu``, a
rehearsal, the "card" is the CPU and there is no such line); ``--out``
also writes the lines to a file.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

LEAVES = ("gx", "cx", "Wg_h", "Wc_h")


def operands(D: int, T: int, B: int, H: int, seed: int) -> list[torch.Tensor]:
    """tests/test_torch_port_cuda.py stacked_operands on the CPU, in bf16."""
    ops = []
    for d in range(D):
        g = torch.Generator().manual_seed(seed + d)
        lim = math.sqrt(6.0 / (3 * H))
        ops.append([scale * torch.randn(shape, generator=g) for shape, scale in (
            ((T, B, 2 * H), 1.0), ((T, B, H), 1.0), ((H, 2 * H), lim), ((H, H), lim))])
    return [torch.stack(t).bfloat16() for t in zip(*ops)]


def against_limit(got: torch.Tensor, ref: torch.Tensor) -> dict:
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    limit = 2.0**-7 * ref.abs() + 1e-4 * ref.abs().max()
    return {"max_err": err.max().item(), "peak": ref.abs().max().item(),
            "worst_ratio": (err / limit.clamp(min=1e-30)).max().item(),
            "over_limit": int((err > limit).sum().item()), "elements": err.numel()}


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.view(torch.int16).numpy().tobytes()).hexdigest()[:16]


def measure(ck, H: int, T: int, B: int, dev: torch.device) -> dict:
    ops = operands(2, T, B, H, seed=H)
    w = torch.randn(2, T, B, H, generator=torch.Generator().manual_seed(13))
    runs = {}
    for where in ("cpu", dev):
        args = [t.detach().to(where).requires_grad_() for t in ops]
        ck.reset_launch_counts()
        ys = ck.gru_scan_fused(*args)
        (ys.float() * w.to(where)).sum().backward()
        with torch.no_grad():
            _, gates = ck.gru_scan_train_forward(*[a.detach() for a in args])
        runs[str(where)] = {"ys": ys.detach().cpu(), "gates": gates.cpu(),
                            "grads": [a.grad.cpu() for a in args],
                            "launches": {f"{k[0]},{k[1]}": n
                                         for k, n in ck.launch_counts.items() if n}}
    cpu, card = runs["cpu"], runs[str(dev)]
    dys = w.bfloat16()                      # the gradient of ys.float() * w
    Wg, Wc = ops[2], ops[3]

    def cpu_backward(ys, gates):            # GruScan.backward's steps on the CPU
        dgx, dcx = ck.gru_scan_train_backward(dys, ys, gates, Wg, Wc)
        return (dgx, dcx, *ck.gru_weight_grads(ys, gates, dgx, dcx))

    ys_diff = (card["ys"].float() - cpu["ys"].float()).abs()
    row = {"H": H, "T": T, "B": B, "dirs": 2, "device": str(dev),
           "card_launches": card["launches"],
           "ys": {"differing": int((ys_diff > 0).sum().item()), "elements": ys_diff.numel(),
                  "max_diff": ys_diff.max().item(),
                  "digest": {side: digest(runs[side]["ys"]) for side in ("cpu", str(dev))}},
           "gates_max_err": (card["gates"] - cpu["gates"]).abs().max().item()}
    dgx, dcx = card["grads"][:2]
    for name, refs in {
            "cpu_forward": cpu["grads"],
            "card_ys": cpu_backward(card["ys"], cpu["gates"]),
            "card_forward": cpu_backward(card["ys"], card["gates"]),
            "card_input_grads": (dgx, dcx, *ck.gru_weight_grads(card["ys"], card["gates"],
                                                                 dgx, dcx))}.items():
        row[name] = {leaf: against_limit(g, r)
                     for leaf, g, r in zip(LEAVES, card["grads"], refs)}
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["128,77,13", "256,400,32"],
                    help="H,T,B of each case")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("gru_scan_grad_drift: no CUDA device available", file=sys.stderr)
        return 1
    from speech_cloner_tpu_torch.ops import cuda_kernels as ck

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    lines = []
    for shape in args.shapes:
        H, T, B = (int(v) for v in shape.split(","))
        lines.append(json.dumps(measure(ck, H, T, B, torch.device(args.device))))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
