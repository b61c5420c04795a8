#!/usr/bin/env python3
"""Measure a CBHG's float32 gradient on a CUDA card against the CPU's.

    python3 cbhg_grad_gap.py [--out FILE.jsonl] [--device cuda|cpu]

The CBHG of tests/test_torch_port_cuda.py's card cases: the decoder's
step-1 width (embed 256, 4 banks, 2 highway layers, H = 128), seed-0
weights, x of B = 4, T = 100 from a seeded generator, train mode, the loss
sum(y^2); once with its GRU (the scan kernel's training forward and
backward on the card) and once with ``use_lstm``. For each gradient leaf:
its relative L2 distance from the CPU float64 gradient on the card in
float32 and on the CPU in float32, and chip_smoke.py train_parity's rule
(the card's within 1e-4 + 3 x the CPU float32's). Under three cuDNN
settings: the default, ``torch.backends.cudnn.deterministic = True``, and
cuDNN off (PyTorch's own convolution); TF32 off in all. Beside them, what
tells a fault in the port's layout from rounding:

- ``float64_on_card``: the LSTM CBHG in float64 on the card against the
  CPU's float64 (the GRU scan kernel takes float32 and bf16 only): a wrong
  tap or channel in the packed banks would show there, rounding would not;
- ``pool_flips``: the max-pool after the banks picks one of two neighbours;
  the positions where a float32 run picks the other one than float64 does
  (both nonzero), on the card and on the CPU;
- ``relu_flips``: each relu of the CBHG (after the banks' BN, after bn1,
  in each highway layer) decides where its gradient passes; the positions
  where a float32 run decides otherwise than float64 does, on the card and
  on the CPU, and the float64 input's magnitude there;
- ``forced_relu``: the card's float32 run again with every relu's decision
  taken from the CPU's float64 run (its input there within rounding of
  zero wherever they differ): each leaf against the rule again;
- ``backward_kernels``: the card's kernels in the backward by device time
  (torch.profiler), which name the convolution algorithms cuDNN chose.

Prints one JSON line per case and setting after the ``nvidia-smi`` name
and power-limit line (with ``--device cpu``, a rehearsal, the "card" is the
CPU and there is no such line); ``--out`` also writes the lines to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch

B, T, IN = 4, 100, 128
LIMIT_TOL, LIMIT_FACTOR = 1e-4, 3.0    # chip_smoke.py PARITY_TRAIN_TOL, PARITY_F32_FACTOR
SETTINGS = {"default": {}, "deterministic": {"deterministic": True},
            "cudnn_off": {"enabled": False}}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


@contextlib.contextmanager
def cudnn(**flags):
    old = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(torch.backends.cudnn, k, v)


RELU_SITES = ("banks", "bn1", "highway.0", "highway.1")   # the CBHG's relus, in call order


@contextlib.contextmanager
def relus(inputs: list, force: list | None = None):
    """Every torch.relu call inside: its input (float64, CPU) appended to
    ``inputs``; with ``force``, the call's decision (input > 0) taken from
    ``force``'s input of the same call instead of its own."""
    real = torch.relu

    def relu(x):
        i = len(inputs)
        inputs.append(x.detach().to("cpu", torch.float64))
        if force is None:
            return real(x)
        return torch.where((force[i] > 0).to(x.device), x, torch.zeros_like(x))

    torch.relu = relu
    try:
        yield
    finally:
        torch.relu = real


def run(use_lstm: bool, device, dtype, profile: bool = False, force=None) -> dict:
    """One train-mode forward and backward: {"grads": {leaf: float64 CPU
    tensor}, "pooled": the banks' output, "relu_inputs": [each relu's
    input] (float64 CPU), "backward_kernels": ...}; ``force``: another run's
    relu inputs, whose decisions this run takes."""
    from speech_cloner_tpu_torch.nn.modules import CBHG, CBHGConfig, cbhg_init

    cfg = CBHGConfig(256, 4, 2, use_lstm=use_lstm)
    params, state = cbhg_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(B, T, IN, generator=torch.Generator().manual_seed(1))
    model = CBHG(params, state, cfg).to(device, dtype)
    seen, inputs = {}, []
    model.banks.register_forward_hook(lambda m, i, o: seen.update(banks=o.detach()))
    with relus(inputs, force):
        loss = model(x.to(device, dtype), True).square().sum()
    assert len(inputs) == len(RELU_SITES), len(inputs)
    out = {}
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            loss.backward()
            torch.cuda.synchronize()
        ev = [e for e in p.key_averages() if getattr(e, "device_time_total", 0) > 0]
        ev.sort(key=lambda e: -e.device_time_total)
        out["backward_kernels"] = [{"name": e.key[:160], "count": e.count,
                                    "device_us": e.device_time_total} for e in ev[:16]]
    else:
        loss.backward()
    out["grads"] = {n: p.grad.detach().to("cpu", torch.float64)
                    for n, p in model.named_parameters()}
    out["pooled"] = seen["banks"].to("cpu", torch.float64)
    out["relu_inputs"] = inputs
    return out


def pool_flips(a: torch.Tensor, ref: torch.Tensor) -> int:
    """Positions where max(a_t, a_t+1) picks the other neighbour than in ref,
    where both are nonzero (relu's zeros tie on every device)."""
    sa = torch.sign(a[:, :-1] - a[:, 1:])
    sr = torch.sign(ref[:, :-1] - ref[:, 1:])
    live = (a[:, :-1] != 0) & (a[:, 1:] != 0)
    return int(((sa != sr) & live).sum())


def relu_flips(a: list, ref: list) -> dict:
    """Per relu site: the positions where ``a``'s decision (input > 0)
    differs from ``ref``'s, and ``ref``'s largest input magnitude there."""
    out = {}
    for site, x, r in zip(RELU_SITES, a, ref):
        flip = (x > 0) != (r > 0)
        out[site] = {"flips": int(flip.sum()),
                     "max_abs_f64_input": float(r[flip].abs().max()) if flip.any() else None}
    return out


def leaf_rows(card: dict, cpu32: dict, cpu64: dict) -> tuple[dict, list]:
    """Each leaf's distances from the float64 gradient and the rule; the
    leaves that fail it."""
    leaves, failing = {}, []
    for leaf, g64 in cpu64["grads"].items():
        card_l2, cpu_l2 = rel_l2(card["grads"][leaf], g64), rel_l2(cpu32["grads"][leaf], g64)
        limit = LIMIT_TOL + LIMIT_FACTOR * cpu_l2
        leaves[leaf] = {"card_l2": card_l2, "cpu_f32_l2": cpu_l2, "limit": limit,
                        "card_to_cpu_f32": card_l2 / max(cpu_l2, 1e-30),
                        "card_vs_cpu_f32_l2": rel_l2(card["grads"][leaf],
                                                     cpu32["grads"][leaf]),
                        "ok": card_l2 <= limit}
        if card_l2 > limit:
            failing.append(leaf)
    return leaves, failing


def case_lines(name: str, use_lstm: bool, device: str, cpu32: dict, cpu64: dict) -> list[dict]:
    lines = []
    for setting, flags in SETTINGS.items():
        with cudnn(**flags):
            card = run(use_lstm, device, torch.float32, profile=device == "cuda")
            forced = run(use_lstm, device, torch.float32, force=cpu64["relu_inputs"])
            card64 = (run(use_lstm, device, torch.float64)
                      if use_lstm and device == "cuda" else None)
        leaves, failing = leaf_rows(card, cpu32, cpu64)
        forced_leaves, forced_failing = leaf_rows(forced, cpu32, cpu64)
        line = {"case": name, "setting": setting, "B": B, "T": T, "H": 128,
                "leaves": len(leaves), "failing": failing, "per_leaf": leaves,
                "pool_flips": {"card_f32_vs_f64": pool_flips(card["pooled"], cpu64["pooled"]),
                               "cpu_f32_vs_f64": pool_flips(cpu32["pooled"], cpu64["pooled"]),
                               "positions": int(cpu64["pooled"][:, :-1].numel())},
                "relu_flips": {"card_f32_vs_f64": relu_flips(card["relu_inputs"],
                                                             cpu64["relu_inputs"]),
                               "cpu_f32_vs_f64": relu_flips(cpu32["relu_inputs"],
                                                            cpu64["relu_inputs"])},
                "forced_relu": {"failing": forced_failing,
                                "max_card_l2": max(v["card_l2"] for v in forced_leaves.values()),
                                "per_leaf": forced_leaves},
                "backward_kernels": card.get("backward_kernels")}
        if card64 is not None:
            line["float64_on_card"] = {
                "max_rel_l2": max(rel_l2(card64["grads"][k], g) for k, g in cpu64["grads"].items()),
                "pool_flips": pool_flips(card64["pooled"], cpu64["pooled"])}
        lines.append(line)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("cbhg_grad_gap: no CUDA device available", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = []
    for name, use_lstm in (("gru", False), ("lstm", True)):
        cpu32, cpu64 = (run(use_lstm, "cpu", dt) for dt in (torch.float32, torch.float64))
        for line in case_lines(name, use_lstm, args.device, cpu32, cpu64):
            print(json.dumps(line), flush=True)
            lines.append(json.dumps(line))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
