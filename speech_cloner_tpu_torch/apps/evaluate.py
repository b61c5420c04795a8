"""Evaluation app: encoder frame accuracy, decoder losses, speaker-ID accuracy.

Counterpart of ``speech_cloner_tpu/apps/evaluate.py``, with its modes,
flags and defaults plus ``--device``:

  python -m speech_cloner_tpu_torch.apps.evaluate encoder \
      --ds-path /data/TIMIT --ckpt ./enc_ckpt

  python -m speech_cloner_tpu_torch.apps.evaluate decoder \
      --ds-path /data/ARCTIC/cmu_arctic --spk-id slt --enc-ckpt ./enc_ckpt --ckpt ./dec_ckpt

  python -m speech_cloner_tpu_torch.apps.evaluate speaker \
      --ds-path /data/TIMIT --ckpt ./spk_ckpt [--split val|tst|trn] [--vocoded]

encoder: frame accuracy over the TIMIT TEST windows and the most confused
phone pairs; decoder: losses and MCD over the target speaker's seed-0
validation windows; speaker: accuracy over a per-speaker 0.8/0.1/0.1
slice, on clean windows or (``--vocoded``) on their Griffin-Lim
resynthesis, whose phases come from a generator seeded with ``--seed`` and
the batch. A checkpoint is a TF prefix or a directory of ``.npz`` train
states (either package's).
"""

from __future__ import annotations

import argparse

import torch

from ..models import decoder as dec_m
from ..models import encoder as enc_m
from ..runtime.checkpoint import load_decoder_weights, load_encoder_weights
from ..runtime.config import DEFAULT_DS_CFG, feature_config_from_cfg_d, load_cfg_d
from ..runtime.jax_params import decoder_from_jax, encoder_from_jax
from ..train.evaluate import eval_acc, eval_confusion, eval_loss, top_confusions


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=("encoder", "decoder", "speaker"))
    ap.add_argument("--split", choices=("trn", "val", "tst"), default="val",
                    help="speaker mode: which per-speaker 0.8/0.1/0.1 slice to score")
    ap.add_argument("--ds-path", required=True)
    ap.add_argument("--ckpt", required=True, help="model to evaluate")
    ap.add_argument("--enc-ckpt", help="frozen encoder for decoder eval")
    ap.add_argument("--enc-cfg")
    ap.add_argument("--dec-cfg")
    ap.add_argument("--ds-cfg")
    ap.add_argument("--spk-id", default="slt")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--n-batches", type=int, default=100)
    ap.add_argument("--vocoded", action="store_true",
                    help="speaker mode: score Griffin-Lim-resynthesized windows instead of "
                         "clean ones (what the verifier judges in deployment)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-epochs", type=int, default=1,
                    help="speaker mode: sampler passes, each with fresh random crops of the "
                         "same held-out utterances")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; pass --device cpu to run on the CPU")
    dev = torch.device(args.device)

    ds_cfg_d = load_cfg_d(args.ds_cfg) if args.ds_cfg else dict(DEFAULT_DS_CFG)
    feat_cfg = feature_config_from_cfg_d(ds_cfg_d)
    enc_cfg = (enc_m.config_from_cfg_d(load_cfg_d(args.enc_cfg))
               if args.enc_cfg else enc_m.EncoderConfig())

    if args.mode == "encoder":
        from ..data.timit import TIMIT

        model = encoder_from_jax(*load_encoder_weights(args.ckpt, enc_cfg), enc_cfg, dev).eval()
        ds = TIMIT(args.ds_path, feat_cfg, n_timesteps=enc_cfg.n_timesteps, verbose=True)
        ds.build_spec_cache("phn_mfcc_cache.npz")

        def sampler():
            return ds.window_sampler(batch_size=args.batch_size, n_epochs=1,
                                     ds_filter_d={"ds_type": "TEST"},
                                     base_name="phn_mfcc_cache.npz")
        acc, n = eval_acc(model, sampler(), verbose=True)
        print(f" final acc over {n} frames: {acc:.4f}")
        cm = eval_confusion(model, sampler(), max_batches=args.n_batches)
        print(" top confused phone pairs (true->pred, count, rate):")
        for t, p, cnt, r in top_confusions(cm, ds.idx2phn, k=10):
            print(f"   {t:>5} -> {p:<5} {cnt:6d}  {r:.1%}")
    elif args.mode == "speaker":
        # the classifier's accuracy on a held-out slice, with the BN
        # statistics the checkpoint carries
        from ..data.timit import TIMIT
        from ..pipeline.verify import load_speaker_model
        from ..train import speaker_eval_step
        from ..train.augment import mix_vocoded

        model, spk_cfg, spk_id_v = load_speaker_model(args.ckpt, dev)
        ds = TIMIT(args.ds_path, feat_cfg, n_timesteps=spk_cfg.n_timesteps, verbose=True)
        ds.build_spec_cache("phn_mfcc_cache.npz")
        ds.prepare_speaker_dicts(None)
        split = {"split_key": "spk_id", "split_props_v": (0.8, 0.9), "split_type": args.split}
        # each batch weighs by its size: a smaller last batch counts less
        correct, n, n_batches = 0.0, 0, 0
        for _, _, power, cls in ds.speaker_spec_sampler(
                args.batch_size, n_epochs=args.n_epochs, ds_filter_d={"split_d": split},
                base_name="phn_mfcc_cache.npz"):
            power = torch.as_tensor(power, device=dev)
            if args.vocoded:
                power = mix_vocoded(power, feat_cfg, frac=1.0, generator=torch.Generator(
                    dev).manual_seed(args.seed + n_batches))
            m = speaker_eval_step(model, power, cls)
            correct += float(m["acc"]) * power.shape[0]
            n += power.shape[0]
            n_batches += 1
            if n_batches >= args.n_batches:
                break
        acc = correct / n if n else float("nan")
        domain = "vocoded" if args.vocoded else "clean"
        print(f" speaker-ID {args.split} ({domain}) accuracy over {n} windows "
              f"({len(spk_id_v)} classes): {acc:.4f}")
    else:
        from ..data.arctic import ARCTIC

        if not args.enc_ckpt:
            raise SystemExit("decoder eval requires --enc-ckpt")
        dec_cfg = (dec_m.config_from_cfg_d(load_cfg_d(args.dec_cfg))
                   if args.dec_cfg else dec_m.DecoderConfig())
        encoder = encoder_from_jax(*load_encoder_weights(args.enc_ckpt, enc_cfg), enc_cfg,
                                   dev).eval()
        model = decoder_from_jax(*load_decoder_weights(args.ckpt, dec_cfg), dec_cfg, dev).eval()
        ds = ARCTIC(args.ds_path, feat_cfg, n_timesteps=dec_cfg.n_timesteps, verbose=True)
        ds.build_spec_cache()
        sampler = ds.spec_window_sampler(batch_size=args.batch_size, n_epochs=1,
                                         sample_trn=False, prop_val=0.02,
                                         ds_filter_d={"spk_id": args.spk_id})
        loss, mel_l, stft_l, mcd = eval_loss(model, sampler, encoder=encoder, verbose=True)
        print(f" final: loss={loss:.3f} mel={mel_l:.3f} stft={stft_l:.3f} mcd={mcd:.2f}dB")


if __name__ == "__main__":
    main()
