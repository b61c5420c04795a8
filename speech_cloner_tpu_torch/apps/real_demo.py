"""Real-voice clone demo: a decoder trained on one narrator's speech, verified.

Counterpart of ``speech_cloner_tpu/apps/real_demo.py``, with its flags and
defaults plus ``--device``. The narrator's recording becomes the target
(``apps.make_narrator_corpus`` cuts it into a ``--ds-kind target`` corpus
and held-out chunks, and injects it into a TIMIT tree for the speaker-ID
verifier); the decoder trains on that corpus with a frozen encoder.

  TEST 1/2  self-reconstruction: the first two held-out chunks (never
            trained on, at any speed) through encoder and decoder; mel and
            stft losses, MCD, resynthesized audio.
  TEST 3    cross-speaker conversion: the first source file in the
            narrator's voice; with --spk-ckpt the speaker-ID verdict over
            --verify-utts source files, the held-out reconstructions as
            control.

  python -m speech_cloner_tpu_torch.apps.real_demo \
      --heldout-dir ./_real/heldout --source-dir <dir with source wavs> \
      --enc-ckpt <dir|tf-prefix> --dec-ckpt <dir> [--spk-ckpt <dir>] \
      [--target-timit-spk NARR0] [--out-dir ./real_demo] [--device cuda|cpu]

Each test writes {true,pred}.wav and spec.png (``data/viz.spec_comparison``;
without matplotlib the picture is skipped with a message), and the run
writes ``demo_report.json`` with the JAX app's keys. Conversion runs
through ``ClonePipeline.convert`` on ``--device``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--heldout-dir", required=True,
                    help="held-out narrator chunks (make_narrator_corpus)")
    ap.add_argument("--source-dir", required=True,
                    help="directory of source-speaker wavs to convert")
    ap.add_argument("--enc-ckpt", required=True)
    ap.add_argument("--dec-ckpt", required=True)
    ap.add_argument("--spk-ckpt", help="speaker-ID model dir for verification")
    ap.add_argument("--target-timit-spk", default="NARR0",
                    help="the narrator's class name in the speaker-ID model")
    ap.add_argument("--enc-cfg")
    ap.add_argument("--dec-cfg")
    ap.add_argument("--ds-cfg")
    ap.add_argument("--out-dir", default="./real_demo")
    ap.add_argument("--n-iter", type=int, default=200)
    ap.add_argument("--realse", type=float, default=1.2)
    ap.add_argument("--verify-utts", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; pass --device cpu to run on the CPU")

    from ..data.audio_io import load_audio, write_riff_wav
    from ..data.viz import spec_comparison
    from ..models import decoder as dec_m
    from ..models import encoder as enc_m
    from ..ops import mfcc_input
    from ..pipeline.clone import make_pipeline
    from ..runtime.config import DEFAULT_DS_CFG, feature_config_from_cfg_d, load_cfg_d
    from .clone_demo import _losses

    ds_cfg_d = load_cfg_d(args.ds_cfg) if args.ds_cfg else dict(DEFAULT_DS_CFG)
    feat_cfg = feature_config_from_cfg_d(ds_cfg_d)
    enc_cfg = (enc_m.config_from_cfg_d(load_cfg_d(args.enc_cfg))
               if args.enc_cfg else enc_m.EncoderConfig())
    dec_cfg = (dec_m.config_from_cfg_d(load_cfg_d(args.dec_cfg))
               if args.dec_cfg else dec_m.DecoderConfig())
    held = sorted(glob.glob(os.path.join(args.heldout_dir, "*.wav")))
    srcs = sorted(glob.glob(os.path.join(args.source_dir, "*.wav")))
    if not held:
        raise SystemExit(f"error: no held-out wavs under {args.heldout_dir}")
    if not srcs:
        raise SystemExit(f"error: no source wavs under {args.source_dir}")
    pipe = make_pipeline(enc_cfg, dec_cfg, feat_cfg, enc_ckpt=args.enc_ckpt,
                         dec_ckpt=args.dec_ckpt, device=args.device, n_iter=args.n_iter,
                         realse=args.realse)
    sr = feat_cfg.sample_rate

    os.makedirs(args.out_dir, exist_ok=True)
    report = {"enc_ckpt": args.enc_ckpt, "dec_ckpt": args.dec_ckpt, "n_iter": args.n_iter,
              "tests": {}}

    def convert_and_record(name: str, wav_true: np.ndarray, label: str) -> np.ndarray:
        wav_pred, mel_pred, stft_pred, _ = pipe.convert(wav_true)
        # the true spectra of the waveform padded as convert pads it, cut to
        # the prediction's frames (the centered STFT has one frame more)
        _, mel_true, stft_true = (a.numpy() for a in mfcc_input(pipe.pad_wav(wav_true).cpu(),
                                                                feat_cfg))
        mel_true = mel_true[:mel_pred.shape[0]]
        stft_true = stft_true[:stft_pred.shape[0]]
        d = os.path.join(args.out_dir, name)
        os.makedirs(d, exist_ok=True)
        write_riff_wav(os.path.join(d, "true.wav"), wav_true, sr, norm=True)
        write_riff_wav(os.path.join(d, "pred.wav"), wav_pred, sr, norm=True)
        try:
            spec_comparison(mel_true, mel_pred, stft_true, stft_pred,
                            save_path=os.path.join(d, "spec.png"))
        except ModuleNotFoundError as e:   # matplotlib is optional
            print(f" (spec.png skipped: {e})")
        entry = {"source": label, "duration_s": round(len(wav_true) / sr, 2),
                 **_losses(mel_true, mel_pred, stft_true, stft_pred)}
        report["tests"][name] = entry
        print(f" {name}: {label} dur={entry['duration_s']}s "
              f"mel_loss={entry['mel_loss']:.3f} stft_loss={entry['stft_loss']:.3f} "
              f"mcd={entry['mcd_db']:.2f}dB", flush=True)
        return wav_pred

    # TESTS 1-2: held-out narrator chunks (the decoder saw neither at any speed)
    control_wavs = [convert_and_record(f"test{i + 1}_heldout_reconstruction",
                                       load_audio(p, sr), os.path.basename(p))
                    for i, p in enumerate(held[:2])]

    # TEST 3: source files in the narrator's voice
    wavs_true, wavs_pred = [], []
    for k, p in enumerate(srcs[:max(args.verify_utts, 1)]):
        wav_true = load_audio(p, sr)
        wavs_pred.append(convert_and_record("test3_source_conversion", wav_true,
                                            os.path.basename(p)) if k == 0
                         else pipe.convert(wav_true)[0])
        wavs_true.append(wav_true)

    if args.spk_ckpt:
        from ..pipeline.verify import format_report, verify_conversion

        v = verify_conversion(wavs_true, wavs_pred, args.spk_ckpt, feat_cfg,
                              target_spk_id=args.target_timit_spk, wav_control=control_wavs,
                              device=args.device)
        report["verification"] = v
        print(format_report(v))

    with open(os.path.join(args.out_dir, "demo_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f" report -> {os.path.join(args.out_dir, 'demo_report.json')}")
    return report


if __name__ == "__main__":
    main()
