"""Voice conversion app: RIFF WAV file -> cloned wav.

Counterpart of ``speech_cloner_tpu/apps/convert.py``, with the same flags
and defaults plus ``--device``:

  python -m speech_cloner_tpu_torch.apps.convert \
      --input some.wav --output-dir ./out --enc-ckpt ./enc_ckpt \
      [--dec-ckpt ./dec_ckpt --n-iter 200 --realse 1.2 --t-s 0 --t-e 60] \
      [--bf16] [--device cuda|cpu] [--verify-ckpt ./spk_ckpt [--target-spk ID]] [--save-true]

A checkpoint is a TF checkpoint prefix (``<prefix>.index`` beside it) or a
directory of ``encoder-<step>.npz`` / ``decoder-<step>.npz`` as the JAX
package's trainers write them. ``--bf16`` runs the models in bf16 (float32
softmax and vocoder). ``--verify-ckpt`` (a ``speaker_id-<step>.npz``
directory, as ``apps.train_speaker_id`` of either package writes it)
classifies the source and the converted audio with the speaker-ID CNN on
the same device, prints the report and writes it as
``<stem>_verify.json``; ``--target-spk`` names the target's class in it.
Both are checked before any work: a ``--verify-ckpt`` directory without a
speaker-ID checkpoint, or ``--target-spk`` alone, is an error.
``--save-true`` also writes ``<stem>_true.wav``: the input's own power
spectrogram through the same Griffin-Lim (`true_resynthesis`), what the
vocoder alone makes of the input.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..data.audio_io import load_audio, write_riff_wav
from ..models import decoder as dec_m
from ..models import encoder as enc_m
from ..ops import from_power_to_wav, mfcc_input
from ..pipeline.clone import make_pipeline
from ..pipeline.verify import format_report, verify_conversion
from ..runtime.checkpoint import Checkpointer
from ..runtime.config import DEFAULT_DS_CFG, feature_config_from_cfg_d, load_cfg_d



def true_resynthesis(wav, feat_cfg, n_iter: int, device="cuda", seed: int = 0,
                     init_phase: torch.Tensor | None = None) -> torch.Tensor:
    """The input's own power spectrogram (``ops.mfcc_input``) vocoded by
    ``n_iter`` Griffin-Lim rounds on ``device``, realse 1, output mean-|y|
    0.045 (the JAX app's settings); the initial phase from a generator
    seeded with ``seed``, or ``init_phase``."""
    _, _, stft_true = mfcc_input(torch.as_tensor(np.asarray(wav, np.float32), device=device),
                                 feat_cfg)
    return from_power_to_wav(
        stft_true, P_dB_norm_factor=feat_cfg.P_dB_norm_factor,
        pre_emphasis=feat_cfg.pre_emphasis, hop_length=feat_cfg.hop_length,
        win_length=feat_cfg.win_length, mean_abs_amp_norm=0.045, n_iter=n_iter,
        n_fft=feat_cfg.n_fft_, realse=1.0,
        generator=torch.Generator(device).manual_seed(seed), init_phase=init_phase)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output-dir", default="./output")
    ap.add_argument("--enc-ckpt", required=True)
    ap.add_argument("--dec-ckpt")
    ap.add_argument("--enc-cfg")
    ap.add_argument("--dec-cfg")
    ap.add_argument("--ds-cfg")
    ap.add_argument("--t-s", type=float, default=0.0, help="start second")
    ap.add_argument("--t-e", type=float, default=60.0, help="end second")
    ap.add_argument("--n-iter", type=int, default=200)
    ap.add_argument("--realse", type=float, default=1.2)
    ap.add_argument("--gl-momentum", type=float, default=0.0,
                    help="Fast Griffin-Lim momentum (0 = reference algorithm)")
    ap.add_argument("--gl-unroll", type=int, default=1,
                    help="accepted for compatibility with the JAX CLI; no effect")
    ap.add_argument("--gl-dft", choices=("fft", "matmul"), default="matmul",
                    help="Griffin-Lim transform: 'matmul' multiplies by cos/sin "
                         "bases, 'fft' uses torch.fft")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 model compute (float32 softmax and vocoder)")
    ap.add_argument("--save-true", action="store_true",
                    help="also write the Griffin-Lim resynthesis of the input's own "
                         "spectrogram as <stem>_true.wav")
    ap.add_argument("--verify-ckpt",
                    help="speaker-ID model dir: classify source vs converted audio and "
                         "report the posterior shift")
    ap.add_argument("--target-spk", help="target voice's class in the speaker-ID model")
    args = ap.parse_args(argv)
    if args.target_spk and not args.verify_ckpt:
        ap.error("--target-spk needs --verify-ckpt")
    if args.verify_ckpt and Checkpointer(args.verify_ckpt, "speaker_id").latest_step() is None:
        ap.error(f"--verify-ckpt {args.verify_ckpt}: no speaker_id checkpoint there")

    ds_cfg_d = load_cfg_d(args.ds_cfg) if args.ds_cfg else dict(DEFAULT_DS_CFG)
    feat_cfg = feature_config_from_cfg_d(ds_cfg_d)
    enc_cfg = (enc_m.config_from_cfg_d(load_cfg_d(args.enc_cfg))
               if args.enc_cfg else enc_m.EncoderConfig())
    dec_cfg = (dec_m.config_from_cfg_d(load_cfg_d(args.dec_cfg))
               if args.dec_cfg else dec_m.DecoderConfig())
    if not args.dec_ckpt:
        print(" WARNING: no --dec-ckpt; using a randomly initialized decoder")
    if not os.path.exists(args.input):
        raise SystemExit(f"error: input file not found: {args.input}")

    pipe = make_pipeline(enc_cfg, dec_cfg, feat_cfg, enc_ckpt=args.enc_ckpt,
                         dec_ckpt=args.dec_ckpt, seed=0, device=args.device,
                         n_iter=args.n_iter, realse=args.realse,
                         gl_momentum=args.gl_momentum, gl_unroll=args.gl_unroll,
                         gl_dft=args.gl_dft,
                         compute_dtype=torch.bfloat16 if args.bf16 else None)

    print(f" loading {args.input}")
    sr = feat_cfg.sample_rate
    wav = load_audio(args.input, sr)
    wav = wav[int(args.t_s * sr): int(args.t_e * sr)]
    dur = len(wav) / sr

    t0 = time.perf_counter()
    wav_pred, _, _, _ = pipe.convert(wav)
    dt = time.perf_counter() - t0
    print(f" converted {dur:.1f}s in {dt:.2f}s on {args.device} "
          f"(RTF {dt / max(dur, 1e-9):.4f}, first call)")

    os.makedirs(args.output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.input))[0]
    out = os.path.join(args.output_dir, f"{stem}_pred.wav")
    write_riff_wav(out, wav_pred, sr, norm=True)
    print(f" wrote {out}")

    if args.verify_ckpt:
        report = verify_conversion(wav, wav_pred, args.verify_ckpt, feat_cfg,
                                   target_spk_id=args.target_spk, device=args.device)
        print(format_report(report))
        vp = os.path.join(args.output_dir, f"{stem}_verify.json")
        with open(vp, "w") as f:
            json.dump(report, f, indent=1)
        print(f" wrote {vp}")

    if args.save_true:
        with torch.inference_mode():
            wav_true = true_resynthesis(wav, feat_cfg, args.n_iter, args.device).cpu().numpy()
        out_t = os.path.join(args.output_dir, f"{stem}_true.wav")
        write_riff_wav(out_t, wav_true, sr, norm=True)
        print(f" wrote {out_t}")


if __name__ == "__main__":
    main()
