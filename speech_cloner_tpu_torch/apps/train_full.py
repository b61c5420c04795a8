"""Joint training runner: encoder (TIMIT) -> decoder (target corpus) ->
speaker-ID verifier -> clone demo and verification, in one command.

Counterpart of ``speech_cloner_tpu/apps/train_full.py``, with its flags and
defaults plus ``--device``, which every stage gets:

  python -m speech_cloner_tpu_torch.apps.train_full \
      --timit-path /data/TIMIT \
      --target-path /data/ARCTIC/cmu_arctic --target-kind arctic --spk-id slt \
      --work-dir ./run1 [--enc-steps N --dec-steps N --spk-steps N] [--demo] \
      [--device cuda|cpu]

Each stage is ``python -m speech_cloner_tpu_torch.apps.<stage>`` in a
subprocess, or a call of its ``main`` in this process with
``--in-process``. Each checkpoints under ``--work-dir`` and resumes from
there, so the command can be run again at any point. Stage 4 (``--demo``,
arctic targets only) runs ``apps.clone_demo`` with the trained weights and
the speaker-ID verdict, writing its artifacts under ``<work-dir>/demo``.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--timit-path", required=True)
    ap.add_argument("--target-path", required=True)
    ap.add_argument("--target-kind", choices=("arctic", "target"), default="arctic")
    ap.add_argument("--spk-id", default="slt")
    ap.add_argument("--work-dir", default="./train_full")
    ap.add_argument("--ds-cfg")
    ap.add_argument("--enc-cfg")
    ap.add_argument("--dec-cfg")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--enc-steps", type=int, default=None)
    ap.add_argument("--dec-steps", type=int, default=None)
    ap.add_argument("--spk-steps", type=int, default=None)
    ap.add_argument("--spk-vocoded-augment", type=float, default=0.5,
                    help="stage 3's vocoded-augmentation share (train_speaker_id "
                         "--vocoded-augment)")
    ap.add_argument("--bf16", action="store_true",
                    help="mixed-precision training for stages 1-3")
    ap.add_argument("--enc-epochs", type=int, default=50)
    ap.add_argument("--dec-epochs", type=int, default=300)
    ap.add_argument("--dec-prop-val", type=float, default=0.02)
    ap.add_argument("--dec-save-epochs", type=int, default=10,
                    help="decoder save/validate cadence")
    ap.add_argument("--demo", action="store_true",
                    help="stage 4: the clone demo's TESTS 1-3 and the speaker-ID verdict")
    ap.add_argument("--demo-source-spk", default="bdl")
    ap.add_argument("--target-timit-spk",
                    help="target voice's class name in the speaker-ID model (TIMIT spk_id, "
                         "e.g. SLT0)")
    ap.add_argument("--n-iter", type=int, default=200)
    ap.add_argument("--in-process", action="store_true",
                    help="run the stages in this process instead of one subprocess each")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    def run_stage(module: str, stage_args: list[str]):
        stage_args = stage_args + ["--device", args.device]
        name = f"speech_cloner_tpu_torch.apps.{module}"
        if args.in_process:
            importlib.import_module(name).main(stage_args)
        else:
            subprocess.run([sys.executable, "-m", name] + stage_args, check=True)

    os.makedirs(args.work_dir, exist_ok=True)
    enc_path = os.path.join(args.work_dir, "enc_ckpt")
    dec_path = os.path.join(args.work_dir, "dec_ckpt")
    spk_path = os.path.join(args.work_dir, "spk_ckpt")
    common_ds = ["--ds-cfg", args.ds_cfg] if args.ds_cfg else []
    enc_cfg = ["--enc-cfg", args.enc_cfg] if args.enc_cfg else []
    dec_cfg = ["--dec-cfg", args.dec_cfg] if args.dec_cfg else []
    bf16 = ["--bf16"] if args.bf16 else []
    n_stages = 4 if args.demo else 3

    def steps(n):
        return [] if n is None else ["--max-steps", str(n)]

    print(f"=== stage 1/{n_stages}: encoder on TIMIT ===", flush=True)
    run_stage("train_encoder", ["--ds-path", args.timit_path, "--model-path", enc_path,
                                "--log-dir", os.path.join(args.work_dir, "enc_logs"),
                                "--batch-size", str(args.batch_size),
                                "--n-epochs", str(args.enc_epochs)]
              + common_ds + enc_cfg + steps(args.enc_steps) + bf16)

    print(f"=== stage 2/{n_stages}: decoder on target corpus ===", flush=True)
    run_stage("train_decoder", ["--ds-path", args.target_path, "--ds-kind", args.target_kind,
                                "--spk-id", args.spk_id, "--enc-ckpt", enc_path,
                                "--model-path", dec_path,
                                "--log-dir", os.path.join(args.work_dir, "dec_logs"),
                                "--batch-size", str(args.batch_size),
                                "--prop-val", str(args.dec_prop_val),
                                "--save-each-n-epochs", str(args.dec_save_epochs),
                                "--n-epochs", str(args.dec_epochs)]
              + common_ds + enc_cfg + dec_cfg + steps(args.dec_steps) + bf16)

    print(f"=== stage 3/{n_stages}: speaker-ID verifier on TIMIT ===", flush=True)
    # the value always goes on: an explicit 0 must reach the stage to mean "off"
    run_stage("train_speaker_id", ["--ds-path", args.timit_path, "--model-path", spk_path,
                                   "--batch-size", str(args.batch_size)]
              + common_ds + steps(args.spk_steps)
              + ["--vocoded-augment", str(args.spk_vocoded_augment)] + bf16)

    if args.demo:
        if args.target_kind != "arctic":
            raise SystemExit("--demo requires --target-kind arctic (needs a multi-speaker "
                             "labelled target corpus)")
        print(f"=== stage 4/{n_stages}: clone demo + verification ===", flush=True)
        run_stage("clone_demo", ["--target-path", args.target_path, "--spk-id", args.spk_id,
                                 "--source-spk", args.demo_source_spk, "--enc-ckpt", enc_path,
                                 "--dec-ckpt", dec_path, "--spk-ckpt", spk_path,
                                 "--out-dir", os.path.join(args.work_dir, "demo"),
                                 "--n-iter", str(args.n_iter)]
                  + common_ds + enc_cfg + dec_cfg
                  + (["--target-timit-spk", args.target_timit_spk]
                     if args.target_timit_spk else []))

    print(f"=== done: checkpoints under {args.work_dir} ===")
    print(f"convert with: python -m speech_cloner_tpu_torch.apps.convert --enc-ckpt {enc_path} "
          f"--dec-ckpt {dec_path} --input <audio> [--verify-ckpt {spk_path}]")


if __name__ == "__main__":
    main()
