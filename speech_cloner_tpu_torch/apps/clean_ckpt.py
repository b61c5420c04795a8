"""Checkpoint pruning: of a directory's ``<name>-<step>.npz`` checkpoints,
delete those below ``--step-min`` and keep ``--n-keep`` evenly spaced ones
of the rest, the first and the last always.

Counterpart of ``speech_cloner_tpu/apps/clean_ckpt.py``, over
``Checkpointer.prune``:

  python -m speech_cloner_tpu_torch.apps.clean_ckpt --dir ./dec_ckpt --name decoder \
      --n-keep 100 --step-min 10000
"""

from __future__ import annotations

import argparse

from ..runtime.checkpoint import Checkpointer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--name", default="decoder")
    ap.add_argument("--n-keep", type=int, default=100)
    ap.add_argument("--step-min", type=int, default=10000)
    args = ap.parse_args(argv)

    ck = Checkpointer(args.dir, args.name)
    before = len(ck.steps())
    deleted = ck.prune(n_keep=args.n_keep, step_min=args.step_min)
    print(f" {before} checkpoints -> deleted {deleted}, left {len(ck.steps())}")


if __name__ == "__main__":
    main()
