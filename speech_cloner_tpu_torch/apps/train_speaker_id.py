"""Speaker-ID verifier training: TIMIT power spectrograms -> speaker classes.

Counterpart of ``speech_cloner_tpu/apps/train_speaker_id.py``, with its
flags and defaults plus ``--device``:

  python -m speech_cloner_tpu_torch.apps.train_speaker_id --ds-path /data/TIMIT \
      [--model-path ./spk_ckpt] [--bf16] [--vocoded-augment 0.5] [--device cuda|cpu]

Trains the CNN of ``models/speaker_id.py`` on power_dB windows with
per-speaker 0.8/0.1/0.1 splits, validates every 5 steps (on clean windows,
and on fully vocoded ones when ``--vocoded-augment`` > 0 or
``--vocoded-val``) and saves the best weights over a 10-evaluation window,
BN statistics recalibrated first (``--bn-recal``). Checkpoints are
``speaker_id-<step>.npz`` train states with the ``speaker_id_cfg_d.json``
sidecar (geometry, the speaker-class mapping ``spk_id_v``, ``best_val``),
which the JAX package's ``load_speaker_model`` reads, and the other way
round; a run resumes from the newest. ``--vocoded-augment`` replaces that
share of each training batch by its Griffin-Lim resynthesis on the batch's
device (``train/augment.py``); its phases and choices come from a generator
seeded with ``--seed`` and the step. ``--bf16`` trains in mixed precision.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data.timit import TIMIT
from ..models import speaker_id as spk_m
from ..runtime.checkpoint import Checkpointer
from ..runtime.config import (
    DEFAULT_DS_CFG,
    feature_config_from_cfg_d,
    float32_products,
    load_cfg_d,
)
from ..runtime.tree import tree_map
from ..train import OptimizerConfig, make_train_state, speaker_eval_step, speaker_train_step
from ..train.augment import mix_vocoded
from ..train.bn_recal import collect_bn_state, load_state_tree, make_bn_stat_fn

CACHE = "phn_mfcc_cache.npz"
EVAL_EVERY = 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ds-path", required=True)
    ap.add_argument("--ds-cfg")
    ap.add_argument("--model-path", default="./spk_ckpt")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--n-epochs", type=int, default=1000)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bn-recal", type=int, default=8,
                    help="recalibrate BN statistics over k train batches before each "
                         "checkpoint save (0 = moving averages only)")
    ap.add_argument("--vocoded-augment", type=float, default=0.5,
                    help="share of training windows replaced by their Griffin-Lim "
                         "resynthesis, so the verifier knows converted audio; 0 = clean "
                         "windows only")
    ap.add_argument("--bf16", action="store_true",
                    help="mixed-precision training: bf16 forward and backward, float32 "
                         "master weights, Adam state, BN statistics and loss")
    ap.add_argument("--vocoded-val", action="store_true",
                    help="also score fully vocoded validation (always on when "
                         "--vocoded-augment > 0)")
    ap.add_argument("--time-fold", type=int, default=1,
                    help="fold k consecutive time frames into the conv input channels "
                         "(a different model; 1 = the reference architecture)")
    ap.add_argument("--keep-ckpts", type=int, default=5,
                    help="keep only the newest N checkpoints (0 = keep all)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; pass --device cpu to train on the CPU")
    dev = torch.device(args.device)
    float32_products(dev)

    ds_cfg_d = load_cfg_d(args.ds_cfg) if args.ds_cfg else dict(DEFAULT_DS_CFG)
    feat_cfg = feature_config_from_cfg_d(ds_cfg_d)
    ds = TIMIT(args.ds_path, feat_cfg, n_timesteps=ds_cfg_d.get("n_timesteps", 400),
               seed=args.seed, verbose=True)
    ds.build_spec_cache(CACHE)

    n_spk = ds.prepare_speaker_dicts(None)
    cfg = spk_m.SpeakerIdConfig(n_timesteps=ds.n_timesteps, n_features=feat_cfg.n_stft,
                                n_output=n_spk, time_fold=args.time_fold)
    print(f" n_speakers={n_spk}")

    split = {"split_key": "spk_id", "split_props_v": (0.8, 0.9)}
    filt_trn = {"split_d": {**split, "split_type": "trn"}}
    filt_val = {"split_d": {**split, "split_type": "val"}}
    # a tiny corpus can leave the 0.8-0.9 slice empty per speaker: validate on
    # the train filter so the val stream always yields
    if int(ds.get_ds_filter(filt_val).sum()) < args.batch_size:
        print(" WARNING: val split smaller than a batch; validating on train data")
        filt_val = filt_trn

    model = spk_m.init(torch.Generator().manual_seed(args.seed), cfg, device=dev)
    opt_cfg = OptimizerConfig(learning_rate=1e-4)
    opt = opt_cfg.make()
    ts = make_train_state(model, opt_cfg, args.seed + 1)
    compute_dtype = torch.bfloat16 if args.bf16 else None

    def on_dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def vocoded(power, seed: int, frac: float):
        return mix_vocoded(on_dev(power), feat_cfg, frac=frac,
                           generator=torch.Generator(dev).manual_seed(seed))

    augment = args.vocoded_augment > 0.0
    score_vocoded = augment or args.vocoded_val

    def batches(ds_filter_d):
        return ds.speaker_spec_sampler(args.batch_size, n_epochs=1, ds_filter_d=ds_filter_d,
                                       base_name=CACHE)

    def val_stream():
        while True:
            yield from batches(filt_val)

    ckpt = Checkpointer(args.model_path, "speaker_id")
    cfg_snapshot = {"n_timesteps": cfg.n_timesteps, "n_features": cfg.n_features,
                    "n_output": cfg.n_output, "time_fold": cfg.time_fold,
                    "spk_id_v": [str(s) for s in ds.all_spk_id_v]}

    # resume from the newest checkpoint; the sidecar carries best_val
    ts, resumed_at = ckpt.restore_into(ts, None)
    best_val = 0.0
    if resumed_at is not None:
        side = os.path.join(args.model_path, "speaker_id_cfg_d.json")
        if os.path.exists(side):
            with open(side) as f:
                best_val = float(json.load(f).get("best_val", 0.0))
        print(f" resume: speaker_id step {resumed_at} (best_val={best_val:.3f})")
        if args.max_steps is not None and resumed_at >= args.max_steps:
            print(" resume: already at max_steps; nothing to do")
            return model

    bn_stat_fn = make_bn_stat_fn(lambda x, bn_momentum: spk_m.apply(
        model, x, train=True, bn_momentum=bn_momentum)[1])

    def save(ts_now, step: int) -> None:
        """Save with BN statistics recalibrated over --bn-recal train batches
        (of the same clean/vocoded mixture training sees); training goes on
        with its own moving averages, as the JAX trainer's does."""
        if args.bn_recal:
            moving = tree_map(lambda t: t.detach().clone(), model.state_tree())
            recal_batches = ((vocoded(p, 910001 + i, args.vocoded_augment) if augment
                              else on_dev(p),)
                             for i, (_, _, p, _) in enumerate(batches(filt_trn)))
            load_state_tree(model, collect_bn_state(bn_stat_fn, recal_batches,
                                                    max_batches=args.bn_recal))
        ckpt.save(ts_now, step=step, config={**cfg_snapshot, "best_val": best_val})
        if args.bn_recal:
            load_state_tree(model, moving)
        if args.keep_ckpts:
            for s in ckpt.steps()[:-args.keep_ckpts]:
                os.remove(ckpt._path(s))

    val_iter = val_stream()
    val_hist: list[float] = []
    i_step = 0 if resumed_at is None else int(resumed_at)
    clean_acc = voc_acc = float("nan")
    for _ in range(args.n_epochs):
        for _, _, power, cls in batches(filt_trn):
            x = (vocoded(power, args.seed * 7919 + i_step, args.vocoded_augment) if augment
                 else on_dev(power))
            ts, m = speaker_train_step(ts, x, cls, model=model, opt_cfg=opt_cfg, opt=opt,
                                       compute_dtype=compute_dtype)
            if i_step % EVAL_EVERY == 0:
                _, _, vp, vc = next(val_iter)
                clean_acc = float(speaker_eval_step(model, vp, vc)["acc"])
                if score_vocoded:
                    # best weights are chosen on the mean of both domains: the
                    # verifier scores raw source audio and resynthesized output
                    voc_acc = float(speaker_eval_step(model, vocoded(vp, 811 + i_step, 1.0),
                                                      vc)["acc"])
                    val_hist.append((clean_acc + voc_acc) / 2.0)
                else:
                    val_hist.append(clean_acc)
            if i_step % 10 == 0:
                extra = (f" val_acc_clean={clean_acc:.3f} val_acc_vocoded={voc_acc:.3f}"
                         if score_vocoded else "")
                print(f" - step={i_step} trn_loss={float(m['loss']):.3f} "
                      f"trn_acc={float(m['acc']):.3f} val_acc={val_hist[-1]:.3f}" + extra,
                      flush=True)
            if (len(val_hist) > 10 and i_step % EVAL_EVERY == 0
                    and float(np.mean(val_hist[-10:])) > best_val):
                best_val = float(np.mean(val_hist[-10:]))
                save(ts, i_step)
            i_step += 1
            if args.max_steps is not None and i_step >= args.max_steps:
                save(ts, i_step)
                return model
    save(ts, i_step)
    return model


if __name__ == "__main__":
    main()
