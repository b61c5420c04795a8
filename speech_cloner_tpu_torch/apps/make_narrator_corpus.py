"""Build a target-speaker training corpus from one long recording.

Counterpart of ``speech_cloner_tpu/apps/make_narrator_corpus.py``, with its
flags: the recording is cut into chunks every ~``--chunk-s`` seconds, each
cut snapped to the quietest 25 ms frame within ``--snap-s`` (a pause, not
mid-word); chunks of 2.5 s or less are dropped (a window sampler needs more
than 400 frames). The last ``--heldout`` chunks go unperturbed to
``<out>/heldout/heldXX.wav``; the others, at each ``--speeds`` factor
(polyphase resampling: pitch and duration move together), to
``<out>/target/cXX_sYYY.wav`` (a ``--ds-kind target`` corpus). The chunk
bounds and the resampling are numpy and scipy, so the files are the JAX
tool's, byte for byte.

With ``--timit-dir`` the same utterances join a TIMIT-layout tree as one
more speaker (``TRAIN/DR1/<--timit-spk>/``), with single-span placeholder
.PHN/.WRD/.TXT files (``h#`` over the whole file: the speaker-ID verifier
reads only power_dB windows and speaker labels; no encoder should train on
them), and the port's feature caches of that tree are removed
(``timit_cache.pickle``, ``spec_cache_*.npz``, ``phn_mfcc_cache_*.npz`` and
their ``.sclpack`` mirrors), or they would hide the new speaker.

``--clip`` defaults to the reference's 60 s narration, looked for under
``reference/`` in the repository (the JAX tool looks in the reference's own
directory).

  python -m speech_cloner_tpu_torch.apps.make_narrator_corpus \
      --out-dir ./_real [--clip <audio>] [--timit-dir ./_synth/timit]
"""

from __future__ import annotations

import argparse
import glob
import os
from fractions import Fraction
from pathlib import Path

import numpy as np

DEFAULT_CLIP = str(Path(__file__).resolve().parents[2] / "reference" / "slt_test_chptr16"
                   / "16 The Magic Art of the Great Humbug_true.mp3")
STALE_CACHES = ("timit_cache.pickle", "phn_mfcc_cache_*.npz", "phn_mfcc_cache_*.sclpack",
                "spec_cache_*.npz", "spec_cache_*.sclpack")


def energy_snapped_bounds(y: np.ndarray, sr: int, chunk_s: float, snap_s: float) -> list[int]:
    """Chunk boundaries every ~chunk_s, each at the lowest-RMS 25 ms frame
    (5 ms hop) within +/- snap_s."""
    win = int(0.025 * sr)
    hop = int(0.005 * sr)
    frames = np.lib.stride_tricks.sliding_window_view(y, win)[::hop]
    rms = np.sqrt(np.mean(frames**2, axis=1))
    bounds = [0]
    t = chunk_s * sr
    while t < len(y) - 0.5 * chunk_s * sr:
        lo = max(int((t - snap_s * sr) / hop), 0)
        hi = min(int((t + snap_s * sr) / hop), len(rms) - 1)
        i_min = lo + int(np.argmin(rms[lo:hi + 1]))
        bounds.append(i_min * hop + win // 2)
        t = bounds[-1] + chunk_s * sr
    bounds.append(len(y))
    return bounds


def speed_perturb(y: np.ndarray, factor: float) -> np.ndarray:
    """Speed change by ``factor`` (> 1 faster) by polyphase resampling."""
    if abs(factor - 1.0) < 1e-9:
        return y
    fr = Fraction(factor).limit_denominator(100)
    from scipy.signal import resample_poly

    return resample_poly(y, fr.denominator, fr.numerator).astype(np.float32)


def _clear_stale_caches(root: str):
    """A TIMIT tree gaining a speaker invalidates the caches derived from it."""
    for pat in STALE_CACHES:
        for p in glob.glob(os.path.join(root, pat)):
            os.remove(p)
            print(f" removed stale cache {p}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--clip", default=DEFAULT_CLIP)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--chunk-s", type=float, default=6.0)
    ap.add_argument("--snap-s", type=float, default=0.75)
    ap.add_argument("--speeds", default="0.9,1.0,1.1",
                    help="comma list of speed factors for the training chunks "
                         "('1.0' = no augmentation)")
    ap.add_argument("--heldout", type=int, default=2,
                    help="final chunks reserved unperturbed in <out>/heldout/, "
                         "excluded from <out>/target/")
    ap.add_argument("--sample-rate", type=int, default=16000)
    ap.add_argument("--timit-dir",
                    help="existing TIMIT-layout root to inject the narrator into as "
                         "speaker --timit-spk (for the verifier)")
    ap.add_argument("--timit-spk", default="FNARR0")
    args = ap.parse_args(argv)

    from ..data.audio_io import load_audio, write_riff_wav

    sr = args.sample_rate
    y = load_audio(args.clip, sr)
    print(f" clip: {args.clip!r}  {len(y) / sr:.1f}s @ {sr} Hz")
    bounds = energy_snapped_bounds(y, sr, args.chunk_s, args.snap_s)
    chunks = [y[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    chunks = [c for c in chunks if len(c) > 2.5 * sr]
    n_held = min(args.heldout, max(len(chunks) - 2, 0))
    train_chunks = chunks[: len(chunks) - n_held]
    held_chunks = chunks[len(chunks) - n_held:]
    speeds = [float(s) for s in args.speeds.split(",")]

    tgt_dir = os.path.join(args.out_dir, "target")
    held_dir = os.path.join(args.out_dir, "heldout")
    os.makedirs(tgt_dir, exist_ok=True)
    os.makedirs(held_dir, exist_ok=True)
    n_files, total_s = 0, 0.0
    for i, c in enumerate(train_chunks):
        for s in speeds:
            w = speed_perturb(c, s)
            write_riff_wav(os.path.join(tgt_dir, f"c{i:02d}_s{int(round(s * 100)):03d}.wav"),
                           w, sr)
            n_files += 1
            total_s += len(w) / sr
    for j, c in enumerate(held_chunks):
        write_riff_wav(os.path.join(held_dir, f"held{j:02d}.wav"), c, sr)
    print(f" target corpus: {n_files} files, {total_s:.1f}s "
          f"({len(train_chunks)} chunks x speeds {speeds})")
    print(f" held out: {n_held} unperturbed chunks -> {held_dir}")

    if args.timit_dir:
        spk_dir = os.path.join(args.timit_dir, "TRAIN", "DR1", args.timit_spk)
        os.makedirs(spk_dir, exist_ok=True)
        utts = [(f"c{i:02d}s{int(round(s * 100)):03d}", speed_perturb(c, s))
                for i, c in enumerate(train_chunks) for s in speeds]
        utts += [(f"h{j:02d}s100", c) for j, c in enumerate(held_chunks)]
        for stem, w in utts:
            base = os.path.join(spk_dir, stem)
            write_riff_wav(base + ".WAV", w, sr)
            span = f"0 {len(w)} h#\n"
            for ext in (".PHN", ".WRD"):
                with open(base + ext, "w") as f:
                    f.write(span)
            with open(base + ".TXT", "w") as f:
                f.write(f"0 {len(w)} [real narration chunk; placeholder "
                        f"phone labels -- speaker-ID use only]\n")
        _clear_stale_caches(args.timit_dir)
        print(f" injected {len(utts)} utterances as {args.timit_spk} under {spk_dir}")


if __name__ == "__main__":
    main()
