"""Time the Tacotron decoder on the card: its plain loop against its
captured step replayed (``models/tacotron.TacotronDecoder``).

    python tools/tts_decoder_probe.py [--batch 32] [--chars 154] [--steps 404] [--reps 5]

At the published widths, weights drawn from a seed, a random memory
[batch, chars, 256] with the rows' lengths spread over 1..chars, float32
with TF32 off, under `torch.inference_mode`. Prints one JSON line: the
card's name and power limit, and for each path (``loop``, ``replay``) the
median over ``reps`` calls of the device ms a call (CUDA events), the host
ms a call (host clock to the end of the enqueue), the device us a step, and
whether the replayed frames equal the loop's bits (``equal``, at chars a
multiple of the bucket) or their gap as a share of the peak (``gap``).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from speech_cloner_tpu_torch.models import tacotron as taco  # noqa: E402
from speech_cloner_tpu_torch.runtime.config import float32_products  # noqa: E402


def timed(fn, reps: int) -> dict:
    """Median device ms (CUDA events) and host ms (enqueue) of ``fn`` over ``reps`` calls."""
    dev, host = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = fn()
        e1.record()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        dev.append(e0.elapsed_time(e1))
    return {"device_ms": statistics.median(dev), "host_ms": statistics.median(host), "out": out}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--chars", type=int, default=154)
    ap.add_argument("--steps", type=int, default=404)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tts_decoder_probe: needs a CUDA card")
    float32_products("cuda")
    cfg = taco.TacotronConfig()
    params, _ = taco.init_tree(torch.Generator().manual_seed(0), cfg)
    dec = taco.TacotronDecoder(params["decoder"], cfg).cuda().eval()
    g = torch.Generator().manual_seed(1)
    memory = torch.randn(args.batch, args.chars, cfg.memory_size, generator=g).cuda()
    lengths = torch.randint(1, args.chars + 1, (args.batch,), generator=g)
    lengths[0] = args.chars
    lengths = lengths.cuda()
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip(),
           "torch": torch.__version__, "batch": args.batch, "chars": args.chars,
           "positions": taco.graph_positions(args.chars), "steps": args.steps}
    with torch.inference_mode():
        runs = {"loop": lambda: dec.loop(memory, lengths, args.steps),
                "replay": lambda: dec(memory, lengths, args.steps)}
        for name, fn in runs.items():
            fn()                                        # warm-up; the replay path captures here
            r = timed(fn, args.reps)
            out[name] = {"device_ms": r["device_ms"], "host_ms": r["host_ms"],
                         "device_us_a_step": 1e3 * r["device_ms"] / args.steps}
            runs[name] = r["out"]
        got, want = runs["replay"], runs["loop"]
        out["equal"] = bool(torch.equal(got, want))
        out["gap"] = float((got - want).abs().max() / want.abs().max())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
