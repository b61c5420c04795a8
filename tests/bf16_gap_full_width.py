#!/usr/bin/env python3
"""The JAX package's own bf16 gap at full width, on the CPU: the yardstick of
``chip_smoke.py``'s bf16 parity limits (``BF16_JAX_GAP``, and with
``--grads`` the per-leaf gradient gaps its train_parity phase reads).

    JAX_PLATFORMS=cpu python tests/bf16_gap_full_width.py
    JAX_PLATFORMS=cpu python tests/bf16_gap_full_width.py --grads

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

``--grads``: one encoder and one decoder train step at the inputs of
``chip_smoke.py``'s train_parity phase (`chip_smoke.train_parity_setup`: the
seed-0 weights at full width, dropout 0, B = 4, epoch 300), through the JAX
package's step loss with ``compute_dtype`` float32 and bfloat16 (the cast
inside the differentiated function, `_cast_floats`, op by op). For each
gradient leaf, JAX's own bf16 gap: the relative L2 distance of its bf16
gradient from its float32 one. Writes them, by leaf path, to
``tests/bf16_grad_gap_full_width.json`` (the constants train_parity holds
the card's bf16 gradients to), with the port's CPU bf16 gap and its ratio
for each leaf beside them, and prints a summary line. About 5 minutes and
~4 GB.

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


def jax_grads(compute_dtype) -> dict:
    """{name: (loss, {leaf path: gradient})} of the JAX step losses."""
    from speech_cloner_tpu.train import metrics as jmetrics
    from speech_cloner_tpu.train import steps as jsteps

    enc_cfg, dec_cfg, ((ep, es), (dp, ds)), (mfcc, phn, mel, stft) = \
        chip_smoke.train_parity_setup()
    je = jenc.EncoderConfig(**dataclasses.asdict(enc_cfg))
    d = dataclasses.asdict(dec_cfg)
    jd = jdec.DecoderConfig(**{**d, "step1": jdec.DecoderStepConfig(**d["step1"]),
                               "step2": jdec.DecoderStepConfig(**d["step2"])})
    cast = jsteps._cast_floats
    ep, es, dp, ds = (to_jax(t) for t in (ep, es, dp, ds))

    def enc_loss(p):
        logits, _ = jenc.apply(cast(p, compute_dtype), es, cast(jnp.asarray(mfcc), compute_dtype),
                               cfg=je, train=True, rng=jax.random.PRNGKey(0))
        return jmetrics.softmax_xent(logits.astype(jnp.float32), phn)

    logits, _ = jenc.apply(cast(ep, compute_dtype), es, cast(jnp.asarray(mfcc), compute_dtype),
                           cfg=je, train=False)
    ppg = jenc.posteriors(logits.astype(jnp.float32))
    f_mel = jsteps.f_mel_schedule(jnp.asarray(300, jnp.int32), jd.target_mel_step2_val)
    loss_cfg = jsteps.DecoderLossConfig()

    def dec_loss(p):
        y_mel, y_stft, _ = jdec.apply(cast(p, compute_dtype), ds, cast(ppg, compute_dtype),
                                      cfg=jd, train=True, rng=jax.random.PRNGKey(0),
                                      target_mel=cast(jnp.asarray(mel), compute_dtype),
                                      f_mel_pred=cast(f_mel, compute_dtype))
        return (jmetrics.weighted_mse(y_mel.astype(jnp.float32), mel, loss_cfg.mel_loss_weight)
                + jmetrics.weighted_mse(y_stft.astype(jnp.float32), stft,
                                        loss_cfg.stft_loss_weight))

    out = {}
    for name, fn, params in (("encoder", enc_loss, ep), ("decoder", dec_loss, dp)):
        loss, g = jax.value_and_grad(fn)(params)
        out[name] = (float(loss), chip_smoke.leaf_paths(jax.tree.map(np.asarray, g)))
    return out


def grads_main() -> None:
    t0 = time.perf_counter()
    jf, jb = jax_grads(None), jax_grads(jnp.bfloat16)
    pb = chip_smoke.port_train_grads("cpu", torch.float32, torch.bfloat16)
    out = {"what": "relative L2 distance of each gradient leaf from the JAX package's float32 "
                   "gradient at chip_smoke.train_parity_setup(): JAX's bf16 gradient "
                   "(leaves, the train_parity constants) and the port's CPU bf16 one "
                   "(port_leaves)", "batch": 4}
    for name in ("encoder", "decoder"):
        (lf, gf), (lb, gb), (lp, gp) = jf[name], jb[name], pb[name]
        jax_gap = {k: chip_smoke.rel_l2(gb[k], gf[k]) for k in gf}
        port_gap = {k: chip_smoke.rel_l2(gp[k], gf[k]) for k in gf}
        out[name] = {"loss_f32": lf, "loss_jax_bf16": lb, "loss_port_bf16": lp,
                     "max_jax_gap": max(jax_gap.values()),
                     "max_port_ratio": max(port_gap[k] / jax_gap[k] for k in gf),
                     "leaves": jax_gap, "port_leaves": port_gap}
    out["seconds"] = time.perf_counter() - t0
    chip_smoke.BF16_GRAD_GAP_FILE.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(json.dumps({k: ({kk: vv for kk, vv in v.items() if not kk.endswith("leaves")}
                          if isinstance(v, dict) else v) for k, v in out.items()}))


def main() -> None:
    if "--grads" in sys.argv[1:]:
        grads_main()
        return
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
