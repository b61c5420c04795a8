#!/usr/bin/env python3
"""The JAX package's own bf16 gap at full width, on the CPU: the yardstick of
``chip_smoke.py``'s bf16 parity limit (``BF16_JAX_GAP``).

    JAX_PLATFORMS=cpu python tests/bf16_gap_full_width.py

The inputs are the ones ``chip_smoke.py``'s bf16 phase compares on the card:
the port's seed-0 weights (`init_trees`) at production geometry
(``EncoderConfig()``, ``DecoderConfig()``), and the port's CPU MFCC windows of
the first 3 windows of ``chip_smoke.synthetic_clip(60.0)``. The same trees
and windows go through the JAX package's ``forward_windows`` in float32 and
with ``compute_dtype=bfloat16``, and through the port's on the CPU in both.
Prints one JSON line: for mel, stft and ppg, max|jax_bf16 - jax_f32|, the
port's max|port_bf16 - jax_f32| and their ratio, max|port_f32 - jax_f32|, and
max|jax_f32| (absolute values, float32 outputs). Not collected by pytest: it
runs the full-width models once, which takes about a minute and ~2 GB.

torch keeps its default thread count here: its CPU oneDNN bf16 convolution
of the decoder's step-2 projection has been seen to return wrong values
with 1-4 intra-op threads on a CPU with AMX (ROADMAP, queue 3), which
would show as a port ratio far above 1 for stft.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from speech_cloner_tpu.models import decoder as jdec  # noqa: E402
from speech_cloner_tpu.models import encoder as jenc  # noqa: E402
from speech_cloner_tpu.ops.features import FeatureConfig as JFeatureConfig  # noqa: E402
from speech_cloner_tpu.pipeline import clone as jclone  # noqa: E402
from speech_cloner_tpu_torch.models import DecoderConfig, EncoderConfig  # noqa: E402
from speech_cloner_tpu_torch.ops import mfcc_input  # noqa: E402
from speech_cloner_tpu_torch.pipeline import make_pipeline  # noqa: E402
from speech_cloner_tpu_torch.pipeline.clone import init_trees  # noqa: E402


def to_jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), tree)


def main() -> None:
    t0 = time.perf_counter()
    tpipe = make_pipeline(EncoderConfig(), DecoderConfig(), seed=0, device="cpu")
    (ep, es), (dp, ds) = init_trees(EncoderConfig(), DecoderConfig(), 0)
    jpipe = jclone.ClonePipeline(jenc.EncoderConfig(), jdec.DecoderConfig(),
                                 JFeatureConfig(calc_mfcc_derivate=True),
                                 to_jax(ep), to_jax(es), to_jax(dp), to_jax(ds))
    jpipe_bf = dataclasses.replace(jpipe, compute_dtype=jnp.bfloat16)
    tpipe_bf = dataclasses.replace(tpipe, compute_dtype=torch.bfloat16)

    T = tpipe.enc_cfg.n_timesteps
    wav = chip_smoke.synthetic_clip(60.0)
    with torch.inference_mode():
        clip = torch.tensor(wav[: 3 * T * tpipe.feat_cfg.hop_length])
        x = mfcc_input(clip, tpipe.feat_cfg)[0][: 3 * T].reshape(3, T, -1)
        port_f32 = [a.numpy() for a in tpipe.forward_windows(x)]
        port_bf16 = [a.float().numpy() for a in tpipe_bf.forward_windows(x)]
    xj = jnp.asarray(x.numpy())
    jax_f32 = [np.asarray(a, np.float32) for a in jpipe.forward_windows(xj)]
    jax_bf16 = [np.asarray(a, np.float32) for a in jpipe_bf.forward_windows(xj)]

    out = {"windows": list(x.shape), "seconds": None}
    for name, pf, pb, jf, jb in zip(("mel", "stft", "ppg"), port_f32, port_bf16,
                                    jax_f32, jax_bf16):
        jax_gap = float(np.abs(jb - jf).max())
        port_gap = float(np.abs(pb - jf).max())
        out[name] = {"jax_bf16_gap": jax_gap, "port_bf16_gap": port_gap,
                     "ratio": port_gap / jax_gap,
                     "port_f32_vs_jax_f32": float(np.abs(pf - jf).max()),
                     "jax_f32_peak": float(np.abs(jf).max())}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
