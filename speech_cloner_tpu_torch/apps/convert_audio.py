"""Batch audio converter: every .wav of a directory to 16 kHz mono mp3 (or
``--to``) beside it, with an ffmpeg binary.

Counterpart of ``speech_cloner_tpu/apps/convert_audio.py``:

  python -m speech_cloner_tpu_torch.apps.convert_audio --dir ./wavs \
      [--to mp3 --sample-rate 16000 --bitrate 128k]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--to", default="mp3")
    ap.add_argument("--sample-rate", type=int, default=16000)
    ap.add_argument("--bitrate", default="128k")
    args = ap.parse_args(argv)

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise SystemExit("ffmpeg not found on PATH")
    for name in sorted(os.listdir(args.dir)):
        if not name.lower().endswith(".wav"):
            continue
        src = os.path.join(args.dir, name)
        dst = os.path.join(args.dir, os.path.splitext(name)[0] + "." + args.to)
        print(f" {name} >>> {os.path.basename(dst)}")
        subprocess.run([ffmpeg, "-y", "-v", "quiet", "-i", src, "-ac", "1",
                        "-ar", str(args.sample_rate), "-ab", args.bitrate, dst], check=True)


if __name__ == "__main__":
    main()
