"""Decoder training app: frozen encoder + target-speaker dataset -> decoder.

Counterpart of ``speech_cloner_tpu/apps/train_decoder.py``, with its flags
and defaults plus ``--device``:

  python -m speech_cloner_tpu_torch.apps.train_decoder \
      --ds-path /data/ARCTIC/cmu_arctic --spk-id slt --enc-ckpt ./enc_ckpt \
      [--ds-kind arctic|target] [--dec-cfg hp/decoder_cfg_d.json] [--bf16] [--fused-gru] \
      [--loader auto|h5py|native|device] [--device cuda|cpu]

``--enc-ckpt`` is a TF checkpoint prefix or a directory of
``encoder-<step>.npz``. Checkpoints are ``decoder-<step>.npz`` train states
in the JAX package's layout. ``--ds-kind target`` trains on a directory of
one speaker's audio files (``data/target_spk.py``): each batch is crops of
one file. ``--loader`` as in ``apps.train_encoder``; under ``device`` the
target kind's batches come from `DeviceWindows.file_batch_sampler`. At save
cadence the app writes a validation window's true and predicted
spectrograms as ``spec_<step>.npz`` (the JAX app draws a png). ``--bf16``
trains in mixed precision, the frozen encoder running in bf16 too (as the
JAX step casts it).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..data.arctic import ARCTIC
from ..data.dataset import SPEC_STREAMS
from ..data.device_dataset import from_npz
from ..data.target_spk import TargetSpeaker
from ..models import decoder as dec_m
from ..models import encoder as enc_m
from ..runtime.checkpoint import Checkpointer, load_encoder_weights
from ..runtime.config import (
    DEFAULT_DS_CFG,
    feature_config_from_cfg_d,
    float32_products,
    load_cfg_d,
)
from ..runtime.jax_params import encoder_from_jax
from ..train import (
    DecoderLossConfig,
    OptimizerConfig,
    decoder_eval_step,
    decoder_train_step,
    make_train_state,
)
from ..train.bn_recal import collect_bn_state, load_state_tree, make_bn_stat_fn
from ..train.loop import LoopConfig, run_training
from ..train.steps import encoder_ppg
from .train_encoder import add_common_flags, choose_loader

CACHE = "spec_cache.npz"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ds-path", required=True)
    ap.add_argument("--ds-kind", choices=("arctic", "target"), default="arctic")
    ap.add_argument("--spk-id", default="slt")
    ap.add_argument("--enc-ckpt", required=True)
    ap.add_argument("--enc-cfg", help="reference-format encoder cfg json")
    ap.add_argument("--dec-cfg", help="reference-format decoder cfg json")
    ap.add_argument("--ds-cfg", help="reference-format ds cfg json")
    ap.add_argument("--model-path", default="./dec_ckpt")
    ap.add_argument("--log-dir", default="./dec_stats_dir")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--save-each-n-epochs", type=int, default=10)
    ap.add_argument("--prop-val", type=float, default=0.02)
    add_common_flags(ap)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; pass --device cpu to train on the CPU")
    float32_products(args.device)

    ds_cfg_d = load_cfg_d(args.ds_cfg) if args.ds_cfg else dict(DEFAULT_DS_CFG)
    feat_cfg = feature_config_from_cfg_d(ds_cfg_d)
    enc_cfg = (enc_m.config_from_cfg_d(load_cfg_d(args.enc_cfg))
               if args.enc_cfg else enc_m.EncoderConfig())
    if args.dec_cfg:
        dec_cfg_d = load_cfg_d(args.dec_cfg)
        cfg = dec_m.config_from_cfg_d(dec_cfg_d)
        opt_cfg = OptimizerConfig(learning_rate=dec_cfg_d.get("learning_rate", 1e-3),
                                  decay=dec_cfg_d.get("decay", 1e-3))
        loss_cfg = DecoderLossConfig(mel_loss_weight=dec_cfg_d.get("mel_loss_weight", 400),
                                     stft_loss_weight=dec_cfg_d.get("stft_loss_weight", 400),
                                     loss_type=dec_cfg_d.get("loss_type", "sum"))
    else:
        cfg = dec_m.DecoderConfig(n_timesteps=enc_cfg.n_timesteps, input_dim=enc_cfg.n_output)
        opt_cfg, loss_cfg = OptimizerConfig(), DecoderLossConfig()
    if args.fused_gru:
        cfg = dataclasses.replace(cfg, step1=dataclasses.replace(cfg.step1, fused_gru=True),
                                  step2=dataclasses.replace(cfg.step2, fused_gru=True))
        enc_cfg = dataclasses.replace(enc_cfg, fused_gru=True)
    encoder = encoder_from_jax(*load_encoder_weights(args.enc_ckpt, enc_cfg), enc_cfg,
                               args.device).eval().requires_grad_(False)

    T = cfg.n_timesteps
    target = args.ds_kind == "target"
    if target:
        ds = TargetSpeaker(args.ds_path, feat_cfg, n_timesteps=T, seed=args.seed, verbose=True)
        ds_filter_d = None
    else:
        ds = ARCTIC(args.ds_path, feat_cfg, n_timesteps=T, seed=args.seed, verbose=True)
        ds_filter_d = {"spk_id": args.spk_id}
    ds.build_spec_cache(CACHE)
    f = ds.get_ds_filter(ds_filter_d)
    all_idx = np.flatnonzero(f)
    frames_v = [len(w) // feat_cfg.hop_length + 1 for w in ds.ds["wav"][f]]
    if target:
        # one file per batch: an epoch is one pass over the files longer than a window
        trn_utt = ds._val_split(all_idx, args.prop_val, True)
        steps_per_epoch = max(sum(1 for i in trn_utt
                                  if len(ds.ds["wav"][i]) // feat_cfg.hop_length + 1 > T), 1)
        print(f" n_files_trn={len(trn_utt)}  steps/epoch={steps_per_epoch}")
    else:
        n_trn = ds.get_n_windows(args.prop_val, ds_filter_d)[0]
        steps_per_epoch = max(n_trn // args.batch_size, 1)
        print(f" n_windows_trn={n_trn}  steps/epoch={steps_per_epoch}")

    # a val split too small for a batch would hang the loop: validate on
    # train data (one file makes a target-kind batch)
    n_val_utts = len(ds._val_split(all_idx, args.prop_val, False))
    val_needs = 1 if target else args.batch_size
    val_sample_trn = n_val_utts < val_needs
    if val_sample_trn:
        print(f" WARNING: val split has {n_val_utts} utterances (< {val_needs} "
              "needed); validating on train data")

    # the padded store holds every utterance at the longest one's length
    loader = choose_loader(args.loader, 4 * (feat_cfg.input_dim + feat_cfg.n_mels
                                             + feat_cfg.n_stft)
                           * len(frames_v) * max(frames_v, default=0))
    print(f" loader: {loader}")
    dw = None
    if loader == "device":
        dw = from_npz(ds.spec_cache_path(CACHE), SPEC_STREAMS, all_idx, T, device=args.device)
        print(f" device-resident dataset: {dw.nbytes / 1e6:.0f} MB, {len(all_idx)} utterances")
        # the validation split by position on the store's utterance axis
        trn_pos = ds._val_split(np.arange(len(all_idx)), args.prop_val, True)
        val_pos = trn_pos if val_sample_trn else ds._val_split(np.arange(len(all_idx)),
                                                                args.prop_val, False)
        sampler = dw.file_batch_sampler if target else dw.index_sampler

        def batches(sample_trn):
            return lambda: sampler(trn_pos if sample_trn else val_pos, args.batch_size,
                                   n_epochs=1, rng=ds.rng)
    else:
        if loader == "native":
            print(f" native loader: {ds.build_packed_cache(CACHE)}")

        def batches(sample_trn):
            window_sampler = (ds.packed_spec_window_sampler if loader == "native"
                              else ds.spec_window_sampler)
            return lambda: window_sampler(batch_size=args.batch_size, n_epochs=1,
                                          sample_trn=sample_trn, prop_val=args.prop_val,
                                          ds_filter_d=ds_filter_d, base_name=CACHE)

    def windows(batch):
        """A batch's (mfcc, mel, stft) windows: gathered on the device from
        index batches, as they are otherwise."""
        return dw.gather(*batch) if dw is not None else batch

    model = dec_m.init(torch.Generator().manual_seed(args.seed), cfg, device=args.device)
    ts = make_train_state(model, opt_cfg, args.seed + 1)
    opt = opt_cfg.make()

    compute_dtype = torch.bfloat16 if args.bf16 else None

    def train_step(t, *batch):
        return decoder_train_step(t, *windows(batch), encoder=encoder, model=model,
                                  loss_cfg=loss_cfg, opt_cfg=opt_cfg, opt=opt,
                                  compute_dtype=compute_dtype)

    def eval_step(t, *batch):
        return decoder_eval_step(model, *windows(batch), encoder=encoder, loss_cfg=loss_cfg)

    bn_gen = torch.Generator(args.device)
    bn_stat_fn = make_bn_stat_fn(lambda *batch, bn_momentum: dec_m.apply(
        model, encoder_ppg(encoder, windows(batch)[0]), train=True,
        generator=bn_gen.manual_seed(0), bn_momentum=bn_momentum)[2])

    def bn_recalibrate(ts_now):
        load_state_tree(model, collect_bn_state(bn_stat_fn, batches(True)(),
                                                max_batches=args.bn_recal))
        return ts_now

    @torch.no_grad()
    def spec_artifacts(ts_now, step_now):
        """A validation window's true and predicted mel and linear spectrograms."""
        try:
            mfcc, mel, stft = (torch.as_tensor(a)
                               for a in windows(next(iter(batches(val_sample_trn)()))))
        except StopIteration:
            return
        y_mel, y_stft = model(encoder_ppg(encoder, mfcc[:1]))
        np.savez(os.path.join(args.log_dir, f"spec_{step_now}.npz"), mel=mel[0].cpu().numpy(),
                 mel_pred=y_mel[0].cpu().numpy(), stft=stft[0].cpu().numpy(),
                 stft_pred=y_stft[0].cpu().numpy())

    run_training(
        ts,
        train_batches=batches(True),
        val_batches=batches(True) if val_sample_trn else batches(False),
        train_step=train_step,
        eval_step=eval_step,
        loop_cfg=LoopConfig(n_epochs=args.n_epochs, steps_per_epoch=steps_per_epoch,
                            save_each_n_epochs=args.save_each_n_epochs,
                            steps_per_call=args.steps_per_call, max_steps=args.max_steps,
                            device=args.device),
        ckpt=Checkpointer(args.model_path, "decoder"),
        log_dir=args.log_dir,
        config_snapshot={"ds": ds_cfg_d},
        artifact_fn=spec_artifacts,
        pre_eval_fn=bn_recalibrate if args.bn_recal else None,
    )
    return model


if __name__ == "__main__":
    main()
