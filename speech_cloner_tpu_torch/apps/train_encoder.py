"""Encoder training app: TIMIT -> phoneme-posterior encoder.

Counterpart of ``speech_cloner_tpu/apps/train_encoder.py``, with its flags
and defaults plus ``--device``:

  python -m speech_cloner_tpu_torch.apps.train_encoder \
      --ds-path /data/TIMIT --model-path ./enc_ckpt \
      [--enc-cfg hp/encoder_cfg_d.json --ds-cfg hp/ds_enc_cfg_d.json] \
      [--bf16] [--fused-gru] [--device cuda|cpu] \
      [--n-data N [--n-model M] [--rank-devices cuda:0,cuda:1,...] [--dist-backend nccl|gloo]]

Checkpoints are ``encoder-<step>.npz`` train states that the JAX package's
trainers resume from, and the other way round. ``--loader`` picks how a
batch is assembled, by the JAX rules (`choose_loader`): ``device`` keeps
the whole feature cache on the training device and cuts the windows there
(a step receives two int32 vectors); ``native`` gathers them from a
``.sclpack`` mirror of the cache with the host library
(``csrc/scl_data.cc``, built at first use); ``h5py`` (the JAX name of the
per-step host reader) reads the ``.npz`` cache; ``auto`` takes ``device``
when the padded store is under 4e9 bytes, else ``native``, else ``h5py``.
The dataset's window draws are seeded with ``--seed``; every loader draws
them as the JAX one of its name does. ``--bf16`` trains in mixed precision
(bf16 forward and backward, float32 master weights, Adam state, BN
statistics and loss; the GRU scans through the bf16 training forward and
backward kernels).

``--n-data N`` trains data-parallel over N ranks, and ``--n-model M`` (only
with ``--n-data``, as in JAX) splits each CBHG's conv banks over M of them
(``parallel/sharding.py``): N*M processes, one per rank, in a
``torch.distributed`` world. The command starts them itself (``spawn``),
unless ``torchrun`` started it. Rank r runs on ``--rank-devices``' r-th
entry, or on cuda:r under ``--device cuda`` (fewer cards raises) and on the
CPU under ``--device cpu``; ``--dist-backend`` is nccl under ``--device
cuda`` and gloo under ``--device cpu`` unless given (NCCL refuses two ranks
on one card; gloo reduces CUDA tensors through the host). Every rank draws
the global batch from the same seeded sampler and keeps its rows, so the
run trains what the single-process run trains; rank 0 prints, logs and
writes the one full checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..data.device_dataset import from_npz
from ..data.packed_cache import PackedReader, load_native, packed_window_sampler
from ..data.timit import TIMIT
from ..models import encoder as enc_m
from ..parallel.distributed import initialize, spawn_world
from ..parallel.mesh import ProcessMesh, check_devices, make_mesh
from ..parallel.sharding import shard_module
from ..runtime.checkpoint import Checkpointer
from ..runtime.config import (
    DEFAULT_DS_CFG,
    feature_config_from_cfg_d,
    float32_products,
    load_cfg_d,
)
from ..train import OptimizerConfig, encoder_eval_step, encoder_train_step, make_train_state
from ..train.bn_recal import collect_bn_state, load_state_tree, make_bn_stat_fn
from ..train.loop import LoopConfig, local_batches, run_training

CACHE = "phn_mfcc_cache.npz"
# padded device-store bytes under which --loader auto keeps the corpus on the device
DEVICE_STORE_LIMIT = 4e9


def choose_loader(loader: str, store_bytes: int) -> str:
    """The loader that runs, by the JAX rules: "device" when asked, or under
    "auto" when the padded store takes under DEVICE_STORE_LIMIT bytes;
    "native" when asked (a failed build of the host library raises) or under
    "auto" above that when the library builds, else "h5py" (said in a
    print); "h5py" when asked."""
    if loader == "device" or (loader == "auto" and store_bytes < DEVICE_STORE_LIMIT):
        return "device"
    if loader == "h5py":
        return loader
    try:
        load_native()
    except RuntimeError as e:
        if loader == "native":
            raise
        print(f" --loader auto: the host library did not build; per-step .npz reads ({e})")
        return "h5py"
    return "native"


def add_common_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--n-epochs", type=int, default=99999)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bn-recal", type=int, default=8,
                    help="recalibrate BN moving stats over k train batches before each "
                         "validation/save; 0 = moving averages only (decay 0.999)")
    ap.add_argument("--steps-per-call", type=int, default=0,
                    help="group k steps between the loop's checks (0 = auto, 1 = off); "
                         "eager steps, kept for the JAX CLI's schedule")
    ap.add_argument("--loader", choices=("auto", "h5py", "native", "device"), default="auto",
                    help="batch assembly: device = the corpus on the training device, windows "
                         "cut there (auto's choice when it fits), native = the host "
                         "library's gather from a .sclpack, h5py = per-step .npz reads")
    ap.add_argument("--bf16", action="store_true",
                    help="mixed-precision training: bf16 forward and backward, float32 "
                         "master weights, Adam state, BN statistics and loss")
    ap.add_argument("--fused-gru", action="store_true",
                    help="both GRU directions in one scan (one kernel launch each way)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ds-path", required=True)
    ap.add_argument("--model-path", default="./enc_ckpt")
    ap.add_argument("--log-dir", default="./enc_stats_dir")
    ap.add_argument("--enc-cfg", help="reference-format encoder cfg json")
    ap.add_argument("--ds-cfg", help="reference-format ds cfg json")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--save-each-n-epochs", type=int, default=3)
    ap.add_argument("--n-data", type=int, default=0,
                    help="data-parallel ranks (0 = one process)")
    ap.add_argument("--n-model", type=int, default=1,
                    help="tensor-parallel ranks of the conv banks (with --n-data)")
    ap.add_argument("--rank-devices",
                    help="comma-separated device of each rank (default: cuda:r under "
                         "--device cuda, the CPU under --device cpu)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    help="default: nccl under --device cuda, gloo under --device cpu")
    add_common_flags(ap)
    return ap


def encoder_config(args, ds_cfg_d: dict, feat_cfg):
    """(EncoderConfig, OptimizerConfig) from ``--enc-cfg`` or the ds config."""
    if args.enc_cfg:
        enc_cfg_d = load_cfg_d(args.enc_cfg)
        cfg = enc_m.config_from_cfg_d(enc_cfg_d)
        opt_cfg = OptimizerConfig(
            learning_rate=enc_cfg_d.get("learning_rate", 1e-3),
            decay=enc_cfg_d.get("decay", 1e-3),
            beta1=enc_cfg_d.get("beta1", 0.9), beta2=enc_cfg_d.get("beta2", 0.999),
            epsilon=enc_cfg_d.get("epsilon", 1e-8))
    else:
        cfg = enc_m.EncoderConfig(n_timesteps=ds_cfg_d["n_timesteps"],
                                  input_dim=feat_cfg.input_dim)
        opt_cfg = OptimizerConfig()
    if args.fused_gru:
        cfg = dataclasses.replace(cfg, fused_gru=True)
    return cfg, opt_cfg


def rank_devices(args, world: int) -> list[str]:
    """Each rank's device: ``--rank-devices``, else cuda:r under --device
    cuda or the CPU; a CUDA device that is not there raises."""
    if args.rank_devices:
        devices = args.rank_devices.split(",")
        if len(devices) != world:
            raise SystemExit(f"error: --rank-devices names {len(devices)} devices for "
                             f"{world} ranks")
    else:
        devices = [f"cuda:{r}" if args.device == "cuda" else "cpu" for r in range(world)]
    check_devices(devices)
    return devices


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; pass --device cpu to train on the CPU")
    if not args.n_data:   # --n-model acts only with --n-data
        return train(args)
    world = args.n_data * args.n_model
    devices = rank_devices(args, world)
    backend = args.dist_backend or ("nccl" if args.device == "cuda" else "gloo")
    argv = list(sys.argv[1:] if argv is None else argv)
    if dist.is_initialized() or "RANK" in os.environ:   # a rank torchrun started
        initialize(backend=backend)
        if dist.get_world_size() != world:
            raise SystemExit(f"error: the world has {dist.get_world_size()} processes; "
                             f"--n-data x --n-model is {world}")
        return _rank_main(dist.get_rank(), argv, devices)
    spawn_world(_spawned_rank, world, argv, devices, backend=backend)
    return None


def _rank_main(rank: int, argv: list[str], devices: list[str]):
    """One rank of a --n-data run: its device, its place in the mesh, then
    `train`; returns its part of the model. Ranks past 0 print nothing."""
    args = _parser().parse_args(argv)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null if rank else sys.stdout):
        mesh = make_mesh(args.n_data, args.n_model, device=device)
        print(f" mesh: data={args.n_data} model={args.n_model}")
        return train(args, mesh)


def _spawned_rank(rank: int, world: int, argv: list[str], devices: list[str]) -> None:
    """`_rank_main` in a process `spawn_world` started (its model stays there)."""
    _rank_main(rank, argv, devices)


@contextlib.contextmanager
def rank0_first(mesh: ProcessMesh | None):
    """Rank 0 runs the block before the other ranks (the caches it writes
    are then there for them to read)."""
    if mesh is None or mesh.size == 1:
        yield
        return
    if mesh.rank:
        dist.barrier()
    yield
    if not mesh.rank:
        dist.barrier()


def train(args, mesh: ProcessMesh | None = None):
    """The training run of one process: all of it, or one rank's part under ``mesh``."""
    device = str(mesh.device) if mesh is not None else args.device
    float32_products(device)
    rank0 = mesh is None or mesh.rank == 0
    ds_cfg_d = load_cfg_d(args.ds_cfg) if args.ds_cfg else dict(DEFAULT_DS_CFG)
    feat_cfg = feature_config_from_cfg_d(ds_cfg_d)
    cfg, opt_cfg = encoder_config(args, ds_cfg_d, feat_cfg)

    ds = TIMIT(args.ds_path, feat_cfg, n_timesteps=cfg.n_timesteps,
               ds_norm=tuple(ds_cfg_d.get("ds_norm", (0.0, 10.0))), seed=args.seed,
               verbose=True)
    # the padded store holds every utterance at the longest one's length
    frames_v = [len(w) // feat_cfg.hop_length + 1 for w in ds.ds["wav"]]
    with rank0_first(mesh):
        ds.build_spec_cache(CACHE)
        loader = choose_loader(args.loader, 4 * (feat_cfg.input_dim + 61) * len(frames_v)
                               * max(frames_v, default=0))
        if loader == "native":
            pack_path = ds.build_packed_cache(CACHE)
    print(f" loader: {loader}")
    T = cfg.n_timesteps
    dw = None
    if loader == "device":
        dw = from_npz(ds.spec_cache_path(CACHE), ("mfcc", "phn"), np.arange(len(frames_v)), T,
                      device=device)
        print(f" device-resident dataset: {dw.nbytes / 1e6:.0f} MB")
    elif loader == "native":
        print(f" native loader: {pack_path}")

    def window_batches(ds_filter_d):
        """(mfcc, phn) window batches, or (utt, start) index batches when
        the corpus is on the device; the packed cache's streams 0 = mfcc,
        3 = phn. Under a mesh, this rank's rows of each."""
        if loader == "h5py":
            return local_batches(lambda: ds.window_sampler(
                batch_size=args.batch_size, n_epochs=1, ds_filter_d=ds_filter_d,
                base_name=CACHE), mesh)

        def gen():
            # the window sampler skips utterances no longer than a window
            samples = np.flatnonzero(ds.get_ds_filter(ds_filter_d))
            if dw is not None:
                yield from dw.index_sampler(samples[dw.n_frames[samples] > T], args.batch_size,
                                            n_epochs=1, rng=ds.rng)
                return
            with PackedReader(pack_path, n_threads=8) as reader:
                yield from packed_window_sampler(
                    reader, batch_size=args.batch_size, n_timesteps=T, streams=(0, 3),
                    samples=samples[reader.n_frames[samples] > T], n_epochs=1, rng=ds.rng)
        return local_batches(gen, mesh)

    def windows(batch):
        """A batch's (mfcc, phn) windows: gathered on the device from index
        batches, as they are otherwise."""
        return dw.gather(*batch) if dw is not None else batch

    n_trn = int(ds.get_ds_filter({"ds_type": "TRAIN"}).sum())
    steps_per_epoch = max(n_trn // args.batch_size, 1)
    print(f" n_samples_trn={n_trn}  steps/epoch={steps_per_epoch}")

    model = enc_m.init(torch.Generator().manual_seed(args.seed), cfg, device=device)
    if mesh is not None:
        shard_module(model, mesh)
    ts = make_train_state(model, opt_cfg, args.seed + 1)
    opt = opt_cfg.make()

    compute_dtype = torch.bfloat16 if args.bf16 else None

    def train_step(t, *batch):
        return encoder_train_step(t, *windows(batch), model=model, opt_cfg=opt_cfg, opt=opt,
                                  compute_dtype=compute_dtype)

    def eval_step(t, *batch):
        return encoder_eval_step(model, *windows(batch))

    bn_gen = torch.Generator(device)
    bn_stat_fn = make_bn_stat_fn(lambda *batch, bn_momentum: enc_m.apply(
        model, torch.as_tensor(windows(batch)[0], device=device), train=True,
        generator=bn_gen.manual_seed(0), bn_momentum=bn_momentum)[1])

    def bn_recalibrate(ts_now):
        load_state_tree(model, collect_bn_state(
            bn_stat_fn, window_batches({"ds_type": "TRAIN"})(), max_batches=args.bn_recal))
        return ts_now

    def confusion_artifact(ts_now, step_now):
        """Validation confusion counts at save cadence as an .npy, and the
        top confused pairs (the global batch's, written by rank 0)."""
        from ..train.evaluate import eval_confusion, top_confusions

        cm = eval_confusion(model, map(windows, window_batches({"ds_type": "TEST"})()),
                            max_batches=8)
        if mesh is not None and mesh.n_data > 1:
            t = torch.tensor(cm, device=device)
            dist.all_reduce(t, group=mesh.group("data"))
            cm = t.cpu().numpy()
        if not rank0:
            return
        np.save(os.path.join(args.log_dir, f"confusion_{int(step_now)}.npy"), cm)
        pairs = top_confusions(cm, ds.idx2phn, k=5)
        if pairs:
            print("   top confusions: " + ", ".join(
                f"{t}->{p} ({n}, {r:.0%})" for t, p, n, r in pairs))

    run_training(
        ts,
        train_batches=window_batches({"ds_type": "TRAIN"}),
        val_batches=window_batches({"ds_type": "TEST"}),
        train_step=train_step,
        eval_step=eval_step,
        loop_cfg=LoopConfig(n_epochs=args.n_epochs, steps_per_epoch=steps_per_epoch,
                            save_each_n_epochs=args.save_each_n_epochs,
                            steps_per_call=args.steps_per_call, max_steps=args.max_steps,
                            device=device),
        ckpt=Checkpointer(args.model_path, "encoder", mesh=mesh),
        log_dir=args.log_dir if rank0 else None,
        config_snapshot={"ds": ds_cfg_d, "model": json.loads(json.dumps(
            cfg, default=lambda o: o.__dict__))},
        artifact_fn=confusion_artifact,
        pre_eval_fn=bn_recalibrate if args.bn_recal else None,
    )
    return model


if __name__ == "__main__":
    main()
