"""Synthetic corpus CLI: write TIMIT- and ARCTIC-layout training data.

Counterpart of ``speech_cloner_tpu/apps/make_synth_corpus.py`` (the same
flags, and from the same seed the same files): no speech corpus ships with
the repository, so this writes phoneme-labelled formant-synthesized
stand-ins (``data/synth_corpus.py``) on which ``apps.train_full`` and
``apps.clone_demo`` run the whole chain:

  python -m speech_cloner_tpu_torch.apps.make_synth_corpus --out-dir ./_synth \
      [--train-spk 24 --test-spk 8 --utts 16 --arctic-utts 120 --seed 0]

Writes <out-dir>/timit and <out-dir>/arctic. The ARCTIC 'slt' voice is the
TIMIT speaker FSLT0 (spk_id SLT0), so a speaker-ID model trained on the
TIMIT tree can name the conversion target.
"""

from __future__ import annotations

import argparse
import os

from ..data.synth_corpus import make_arctic_tree, make_timit_tree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--train-spk", type=int, default=24)
    ap.add_argument("--test-spk", type=int, default=8)
    ap.add_argument("--utts", type=int, default=16, help="utterances per TIMIT speaker")
    ap.add_argument("--arctic-utts", type=int, default=120, help="utterances per ARCTIC speaker")
    ap.add_argument("--n-phones", type=int, default=24, help="phones per utterance")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    timit_root = os.path.join(args.out_dir, "timit")
    arctic_root = os.path.join(args.out_dir, "arctic")
    make_timit_tree(timit_root, n_train_spk=args.train_spk, n_test_spk=args.test_spk,
                    n_utts=args.utts, n_phones=args.n_phones, seed=args.seed, verbose=True)
    make_arctic_tree(arctic_root, n_utts=args.arctic_utts, n_phones=args.n_phones,
                     seed=args.seed + 1, verbose=True)
    print(f" wrote {timit_root} and {arctic_root}")
    print(f" train with: python -m speech_cloner_tpu_torch.apps.train_full "
          f"--timit-path {timit_root} --target-path {arctic_root} "
          f"--spk-id slt --demo --target-timit-spk SLT0")


if __name__ == "__main__":
    main()
