"""Encoder training app: TIMIT -> phoneme-posterior encoder.

Counterpart of ``speech_cloner_tpu/apps/train_encoder.py``, with its flags
and defaults plus ``--device``:

  python -m speech_cloner_tpu_torch.apps.train_encoder \
      --ds-path /data/TIMIT --model-path ./enc_ckpt \
      [--enc-cfg hp/encoder_cfg_d.json --ds-cfg hp/ds_enc_cfg_d.json] \
      [--bf16] [--fused-gru] [--device cuda|cpu]

Checkpoints are ``encoder-<step>.npz`` train states that the JAX package's
trainers resume from, and the other way round. Batches come from the
dataset's ``.npz`` feature cache (``--loader auto`` or ``h5py``, the JAX
name of its per-step host reader). The dataset's window draws are seeded
with ``--seed``. ``--bf16`` trains in mixed precision (bf16 forward and
backward, float32 master weights, Adam state, BN statistics and loss; the
GRU scans through the bf16 training forward and backward kernels). Not
ported yet, refused: ``--loader native|device``, ``--n-data``/``--n-model``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ..data.timit import TIMIT
from ..models import encoder as enc_m
from ..runtime.checkpoint import Checkpointer
from ..runtime.config import DEFAULT_DS_CFG, feature_config_from_cfg_d, load_cfg_d
from ..train import OptimizerConfig, encoder_eval_step, encoder_train_step, make_train_state
from ..train.bn_recal import collect_bn_state, load_state_tree, make_bn_stat_fn
from ..train.loop import LoopConfig, run_training

CACHE = "phn_mfcc_cache.npz"


def refuse_unported(args) -> None:
    """The JAX flags whose paths are not ported yet raise, naming their item."""
    if args.loader in ("native", "device"):
        raise NotImplementedError(f"--loader {args.loader} is not ported yet (ROADMAP queue 1, "
                                  "\"Data runtime\": the packed and device-resident loaders)")
    if getattr(args, "n_data", 0) or getattr(args, "n_model", 1) != 1:
        raise NotImplementedError("--n-data/--n-model are not ported yet (ROADMAP queue 1, "
                                  "\"Parallel\")")


def add_common_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--n-epochs", type=int, default=99999)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bn-recal", type=int, default=8,
                    help="recalibrate BN moving stats over k train batches before each "
                         "validation/save; 0 = moving averages only (decay 0.999)")
    ap.add_argument("--steps-per-call", type=int, default=0,
                    help="group k steps between the loop's checks (0 = auto, 1 = off); "
                         "eager steps, kept for the JAX CLI's schedule")
    ap.add_argument("--loader", choices=("auto", "h5py", "native", "device"), default="auto",
                    help="auto / h5py: per-step reads of the .npz feature cache")
    ap.add_argument("--bf16", action="store_true",
                    help="mixed-precision training: bf16 forward and backward, float32 "
                         "master weights, Adam state, BN statistics and loss")
    ap.add_argument("--fused-gru", action="store_true",
                    help="both GRU directions in one scan (one kernel launch each way)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ds-path", required=True)
    ap.add_argument("--model-path", default="./enc_ckpt")
    ap.add_argument("--log-dir", default="./enc_stats_dir")
    ap.add_argument("--enc-cfg", help="reference-format encoder cfg json")
    ap.add_argument("--ds-cfg", help="reference-format ds cfg json")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--save-each-n-epochs", type=int, default=3)
    ap.add_argument("--n-data", type=int, default=0, help="not ported yet")
    ap.add_argument("--n-model", type=int, default=1, help="not ported yet")
    add_common_flags(ap)
    args = ap.parse_args(argv)
    refuse_unported(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; pass --device cpu to train on the CPU")

    ds_cfg_d = load_cfg_d(args.ds_cfg) if args.ds_cfg else dict(DEFAULT_DS_CFG)
    feat_cfg = feature_config_from_cfg_d(ds_cfg_d)
    if args.enc_cfg:
        enc_cfg_d = load_cfg_d(args.enc_cfg)
        cfg = enc_m.config_from_cfg_d(enc_cfg_d)
        opt_cfg = OptimizerConfig(
            learning_rate=enc_cfg_d.get("learning_rate", 1e-3),
            decay=enc_cfg_d.get("decay", 1e-3),
            beta1=enc_cfg_d.get("beta1", 0.9), beta2=enc_cfg_d.get("beta2", 0.999),
            epsilon=enc_cfg_d.get("epsilon", 1e-8))
    else:
        cfg = enc_m.EncoderConfig(n_timesteps=ds_cfg_d["n_timesteps"],
                                  input_dim=feat_cfg.input_dim)
        opt_cfg = OptimizerConfig()
    if args.fused_gru:
        cfg = dataclasses.replace(cfg, fused_gru=True)

    ds = TIMIT(args.ds_path, feat_cfg, n_timesteps=cfg.n_timesteps,
               ds_norm=tuple(ds_cfg_d.get("ds_norm", (0.0, 10.0))), seed=args.seed,
               verbose=True)
    ds.build_spec_cache(CACHE)

    def window_batches(ds_filter_d):
        return lambda: ds.window_sampler(batch_size=args.batch_size, n_epochs=1,
                                         ds_filter_d=ds_filter_d, base_name=CACHE)

    n_trn = int(ds.get_ds_filter({"ds_type": "TRAIN"}).sum())
    steps_per_epoch = max(n_trn // args.batch_size, 1)
    print(f" n_samples_trn={n_trn}  steps/epoch={steps_per_epoch}")

    model = enc_m.init(torch.Generator().manual_seed(args.seed), cfg, device=args.device)
    ts = make_train_state(model, opt_cfg, args.seed + 1)
    opt = opt_cfg.make()

    compute_dtype = torch.bfloat16 if args.bf16 else None

    def train_step(t, x, y):
        return encoder_train_step(t, x, y, model=model, opt_cfg=opt_cfg, opt=opt,
                                  compute_dtype=compute_dtype)

    def eval_step(t, x, y):
        return encoder_eval_step(model, x, y)

    bn_gen = torch.Generator(args.device)
    bn_stat_fn = make_bn_stat_fn(lambda x, y, bn_momentum: enc_m.apply(
        model, torch.as_tensor(x, device=args.device), train=True,
        generator=bn_gen.manual_seed(0), bn_momentum=bn_momentum)[1])

    def bn_recalibrate(ts_now):
        load_state_tree(model, collect_bn_state(
            bn_stat_fn, window_batches({"ds_type": "TRAIN"})(), max_batches=args.bn_recal))
        return ts_now

    def confusion_artifact(ts_now, step_now):
        """Validation confusion counts at save cadence as an .npy, and the
        top confused pairs."""
        from ..train.evaluate import eval_confusion, top_confusions

        cm = eval_confusion(model, window_batches({"ds_type": "TEST"})(), max_batches=8)
        np.save(os.path.join(args.log_dir, f"confusion_{int(step_now)}.npy"), cm)
        pairs = top_confusions(cm, ds.idx2phn, k=5)
        if pairs:
            print("   top confusions: " + ", ".join(
                f"{t}->{p} ({n}, {r:.0%})" for t, p, n, r in pairs))

    run_training(
        ts,
        train_batches=window_batches({"ds_type": "TRAIN"}),
        val_batches=window_batches({"ds_type": "TEST"}),
        train_step=train_step,
        eval_step=eval_step,
        loop_cfg=LoopConfig(n_epochs=args.n_epochs, steps_per_epoch=steps_per_epoch,
                            save_each_n_epochs=args.save_each_n_epochs,
                            steps_per_call=args.steps_per_call, max_steps=args.max_steps,
                            device=args.device),
        ckpt=Checkpointer(args.model_path, "encoder"),
        log_dir=args.log_dir,
        config_snapshot={"ds": ds_cfg_d, "model": json.loads(json.dumps(
            cfg, default=lambda o: o.__dict__))},
        artifact_fn=confusion_artifact,
        pre_eval_fn=bn_recalibrate if args.bn_recal else None,
    )
    return model


if __name__ == "__main__":
    main()
