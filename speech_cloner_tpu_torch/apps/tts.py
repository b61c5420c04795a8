"""Text-to-speech app: sentences -> one RIFF wav each, a batch through Tacotron.

  python -m speech_cloner_tpu_torch.apps.tts \
      --text "First sentence." --text "Second one." --output-dir ./out \
      [--text-file lines.txt] [--cfg tacotron.json] [--seconds 3.5] \
      [--seed 0] [--device cuda|cpu]

Tacotron (``models/tacotron.py``) at the paper's widths by default (24 kHz,
80 mel bands, 1,025 bins, 50 Griffin-Lim rounds, realse 1.2), or as the
configuration file ``--cfg`` gives it ({"model", "features", "vocoder"},
the layout of ``perfbench/configs/tacotron_f32.json``). The weights are
drawn from ``--seed``: there is no trained Tacotron checkpoint to read, and
an untrained decoder has no stop rule, so each sentence speaks for
``--seconds`` (default: its characters at 15.2 a second, LJSpeech's rate),
80 frames a second at the 12.5 ms hop. Every sentence of the call is one
batch: ``SynthesisPipeline.synthesize_batch_pcm16``. Writes
``<output-dir>/tts_<i>.wav``.
"""

from __future__ import annotations

import argparse
import os
import time

from ..data.audio_io import write_riff_wav
from ..pipeline.tts import make_synthesis_pipeline, min_frames, pad_ids, text_ids
from ..runtime.config import load_cfg_d, tacotron_config_from_cfg_d

CHARS_PER_SECOND = 15.2     # LJSpeech's mean rate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--text", action="append", default=[], help="a sentence (repeatable)")
    ap.add_argument("--text-file", help="one sentence a line")
    ap.add_argument("--output-dir", default="./output")
    ap.add_argument("--cfg", help="configuration file ({model, features, vocoder})")
    ap.add_argument("--seconds", type=float,
                    help="seconds each sentence speaks for (default: from its length)")
    ap.add_argument("--seed", type=int, default=0, help="weights and Griffin-Lim phase")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    sentences = list(args.text)
    if args.text_file:
        with open(args.text_file, encoding="utf-8") as f:
            sentences += [ln.strip() for ln in f if ln.strip()]
    if not sentences or not all(sentences):
        ap.error("give at least one non-empty sentence (--text or --text-file)")
    cfg, feat, voc = tacotron_config_from_cfg_d(load_cfg_d(args.cfg) if args.cfg else {})
    pipe = make_synthesis_pipeline(cfg, feat, seed=args.seed, device=args.device, **voc)

    frames_per_s = feat.sample_rate / feat.hop_length
    rows = [text_ids(s, cfg.vocab_size) for s in sentences]
    seconds = [args.seconds or len(r) / CHARS_PER_SECOND for r in rows]
    frames = [max(round(frames_per_s * s), min_frames(feat)) for s in seconds]
    ids, lengths = pad_ids(rows)

    t0 = time.perf_counter()
    pcm = pipe.synthesize_batch_pcm16(ids, lengths, frames, seed=args.seed)
    dt = time.perf_counter() - t0
    total = sum(len(p) for p in pcm) / feat.sample_rate
    print(f" synthesized {len(pcm)} sentences, {total:.1f}s of audio in {dt:.2f}s on "
          f"{args.device} (first call)")

    os.makedirs(args.output_dir, exist_ok=True)
    for i, p in enumerate(pcm):
        out = os.path.join(args.output_dir, f"tts_{i}.wav")
        write_riff_wav(out, p, feat.sample_rate)
        print(f" wrote {out}")


if __name__ == "__main__":
    main()
