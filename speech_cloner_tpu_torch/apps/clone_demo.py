"""Clone demo: three conversion scenarios and the speaker-ID verdict in one command.

Counterpart of ``speech_cloner_tpu/apps/clone_demo.py``, with its flags and
defaults plus ``--device``:

  TEST 1  self-reconstruction: a validation utterance of the target speaker
          through encoder and decoder; mel and stft losses, MCD, audio.
  TEST 2  target-speaker conversion: a second target utterance.
  TEST 3  other-speaker conversion: a source-speaker utterance in the
          target's voice, and with --spk-ckpt the speaker-ID verdict over
          --verify-utts source utterances.

  python -m speech_cloner_tpu_torch.apps.clone_demo \
      --target-path <arctic_root> --spk-id slt --source-spk bdl \
      --enc-ckpt <dir|tf-prefix> --dec-ckpt <dir> \
      [--spk-ckpt <dir> --target-timit-spk SLT0] [--out-dir ./clone_demo] [--device cuda|cpu]

The utterances come from the seed-0 validation split of the target speaker
(the last two of the speaker where it holds fewer than two). Each test
writes {true,pred}.wav and spec.png (``data/viz.spec_comparison``; without
matplotlib the picture is skipped with a message), and the run writes
``demo_report.json`` with the JAX app's keys. Conversion runs through
``ClonePipeline.convert`` on ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _losses(mel_true, mel_pred, stft_true, stft_pred, w=400.0):
    """w*MSE(mel) + w*MSE(stft) (the decoder's loss) over the common frames,
    and the mel-cepstral distortion in dB."""
    from ..train.metrics import mel_cepstral_distortion

    n = min(mel_true.shape[0], mel_pred.shape[0])
    mel_l = float(w * np.mean((mel_true[:n] - mel_pred[:n]) ** 2))
    stft_l = float(w * np.mean((stft_true[:n] - stft_pred[:n]) ** 2))
    mcd = float(mel_cepstral_distortion(torch.as_tensor(mel_true[:n]),
                                        torch.as_tensor(mel_pred[:n])))
    return {"mel_loss": mel_l, "stft_loss": stft_l, "loss": mel_l + stft_l, "mcd_db": mcd}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--target-path", required=True, help="ARCTIC-layout corpus root")
    ap.add_argument("--spk-id", default="slt")
    ap.add_argument("--source-spk", default="bdl")
    ap.add_argument("--enc-ckpt", required=True)
    ap.add_argument("--dec-ckpt", required=True)
    ap.add_argument("--spk-ckpt", help="speaker-ID model dir for verification")
    ap.add_argument("--target-timit-spk",
                    help="the target voice's class name in the speaker-ID model")
    ap.add_argument("--enc-cfg")
    ap.add_argument("--dec-cfg")
    ap.add_argument("--ds-cfg")
    ap.add_argument("--out-dir", default="./clone_demo")
    ap.add_argument("--n-iter", type=int, default=200)
    ap.add_argument("--realse", type=float, default=1.2)
    ap.add_argument("--prop-val", type=float, default=0.02)
    ap.add_argument("--verify-utts", type=int, default=4,
                    help="source utterances converted for the speaker-ID verdict (posterior "
                         "averaged over all their windows)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; pass --device cpu to run on the CPU")

    from ..data.arctic import ARCTIC
    from ..data.audio_io import write_riff_wav
    from ..data.viz import spec_comparison
    from ..models import decoder as dec_m
    from ..models import encoder as enc_m
    from ..ops import mfcc_input
    from ..pipeline.clone import make_pipeline
    from ..runtime.config import DEFAULT_DS_CFG, feature_config_from_cfg_d, load_cfg_d

    ds_cfg_d = load_cfg_d(args.ds_cfg) if args.ds_cfg else dict(DEFAULT_DS_CFG)
    feat_cfg = feature_config_from_cfg_d(ds_cfg_d)
    enc_cfg = (enc_m.config_from_cfg_d(load_cfg_d(args.enc_cfg))
               if args.enc_cfg else enc_m.EncoderConfig())
    dec_cfg = (dec_m.config_from_cfg_d(load_cfg_d(args.dec_cfg))
               if args.dec_cfg else dec_m.DecoderConfig())
    pipe = make_pipeline(enc_cfg, dec_cfg, feat_cfg, enc_ckpt=args.enc_ckpt,
                         dec_ckpt=args.dec_ckpt, device=args.device, n_iter=args.n_iter,
                         realse=args.realse)

    ds = ARCTIC(args.target_path, feat_cfg, n_timesteps=dec_cfg.n_timesteps, verbose=True)
    # the target speaker's seed-0 validation split: data the decoder never saw
    tgt_idx = np.flatnonzero(ds.get_ds_filter({"spk_id": args.spk_id}))
    val_idx = ds._val_split(tgt_idx, args.prop_val, sample_trn=False)
    if len(val_idx) < 2:
        val_idx = tgt_idx[-2:]
    src_idx = np.flatnonzero(ds.get_ds_filter({"spk_id": args.source_spk}))
    if len(src_idx) == 0:
        raise SystemExit(f"error: no utterances for source speaker {args.source_spk!r}")

    scenarios = [("test1_self_reconstruction", int(val_idx[0]), args.spk_id),
                 ("test2_target_speaker", int(val_idx[1]), args.spk_id),
                 ("test3_other_speaker", int(src_idx[0]), args.source_spk)]

    os.makedirs(args.out_dir, exist_ok=True)
    report = {"enc_ckpt": args.enc_ckpt, "dec_ckpt": args.dec_ckpt, "n_iter": args.n_iter,
              "tests": {}}
    sr = feat_cfg.sample_rate
    test3_wavs = None
    control_wavs = []  # the target's reconstructions (TESTS 1-2)
    for name, utt, spk in scenarios:
        wav_true = np.asarray(ds.ds["wav"][utt], np.float32)
        wav_pred, mel_pred, stft_pred, _ = pipe.convert(wav_true)

        # the true spectra of the waveform padded as convert pads it, cut to
        # the prediction's frames (the centered STFT has one frame more)
        wav_padded = pipe.pad_wav(wav_true).cpu()
        _, mel_true, stft_true = (a.numpy() for a in mfcc_input(wav_padded, feat_cfg))
        mel_true = mel_true[:mel_pred.shape[0]]
        stft_true = stft_true[:stft_pred.shape[0]]

        d = os.path.join(args.out_dir, name)
        os.makedirs(d, exist_ok=True)
        write_riff_wav(os.path.join(d, "true.wav"), wav_true, sr, norm=True)
        write_riff_wav(os.path.join(d, "pred.wav"), wav_pred, sr, norm=True)
        try:
            spec_comparison(mel_true, mel_pred, stft_true, stft_pred,
                            save_path=os.path.join(d, "spec.png"))
        except Exception as e:  # noqa: BLE001  (matplotlib is optional)
            print(f" (spec.png skipped: {e})")

        entry = {"utterance": int(utt), "speaker": spk,
                 "duration_s": round(len(wav_true) / sr, 2),
                 **_losses(mel_true, mel_pred, stft_true, stft_pred)}
        report["tests"][name] = entry
        print(f" {name}: spk={spk} dur={entry['duration_s']}s "
              f"mel_loss={entry['mel_loss']:.3f} stft_loss={entry['stft_loss']:.3f} "
              f"mcd={entry['mcd_db']:.2f}dB")
        if name.startswith("test3"):
            test3_wavs = (wav_true, wav_pred)
        else:
            control_wavs.append(wav_pred)

    # the speaker-ID verdict on the cross-speaker conversion (TEST 3), over
    # --verify-utts source utterances
    if args.spk_ckpt and test3_wavs is not None:
        from ..pipeline.verify import format_report, verify_conversion

        wavs_true, wavs_pred = [test3_wavs[0]], [test3_wavs[1]]
        for utt in src_idx[1:max(args.verify_utts, 1)]:
            w_t = np.asarray(ds.ds["wav"][int(utt)], np.float32)
            wavs_true.append(w_t)
            wavs_pred.append(pipe.convert(w_t)[0])
        v = verify_conversion(wavs_true, wavs_pred, args.spk_ckpt, feat_cfg,
                              target_spk_id=args.target_timit_spk,
                              wav_control=control_wavs or None, device=args.device)
        report["verification"] = v
        print(format_report(v))

    with open(os.path.join(args.out_dir, "demo_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f" report -> {os.path.join(args.out_dir, 'demo_report.json')}")
    return report


if __name__ == "__main__":
    main()
