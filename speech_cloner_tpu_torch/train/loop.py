"""Training loop orchestration: epochs, save/val cadence, resume, logging.

Counterpart of ``speech_cloner_tpu/train/loop.py`` with the same rules:
auto-resume from the latest checkpoint, the epoch counter moving when the
step crosses a multiple of ``steps_per_epoch`` (driving the lr decay and the
f_mel schedule), save + validation every ``save_each_n_epochs``, a final
save unless the last step was saved already or the run resumed complete,
``max_steps`` as a hard stop. ``steps_per_call`` k groups k batches and runs
them as k eager steps with the JAX loop's bookkeeping (log when
``step % log_every < k``, epochs checked after each group, an exact-stop
tail at ``max_steps``); there is no lax.scan to fuse them into. Batches are
staged by a background thread: pinned host memory and a non-blocking copy
to ``LoopConfig.device`` (``prefetch`` deep; 0 hands the sampler's batches
to the step as they are). Under a data-parallel mesh every rank draws the
same global batches from the same seeded sampler and keeps its rows
(`local_batches`), so the run draws what the single-process run draws.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from ..runtime.checkpoint import Checkpointer
from ..runtime.logging import MetricsWriter, StepTimer
from ..runtime.tree import tree_map
from .optimizer import next_epoch


@dataclasses.dataclass
class LoopConfig:
    n_epochs: int = 99999
    steps_per_epoch: int = 100
    save_each_n_epochs: int = 3
    log_every_steps: int = 20
    max_steps: int | None = None   # hard stop (tests / smoke runs)
    prefetch: int = 2
    device: str = "cuda"           # where the prefetch stages batches
    val_batches_per_eval: int = 4  # mean/std over k batches, not 1 noisy one
    steps_per_call: int = 1        # k steps per group; clamped to a divisor of
                                   # steps_per_epoch (0 = auto: the largest <= 16)


def device_prefetch(iterator: Iterator, size: int = 2, device="cuda") -> Iterator:
    """Yield the batches of ``iterator`` (trees of numpy arrays) as tensors on
    ``device``, ``size`` ahead, from a background thread: pinned host memory
    and a non-blocking copy on CUDA. Closing the generator stops the thread."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    stop, end = threading.Event(), object()

    def place(a):
        t = torch.as_tensor(a)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterator:
                if not put(tree_map(place, batch)):
                    return
        except BaseException as e:  # noqa: BLE001  (surfaced in the consumer)
            put(e)
        finally:
            put(end)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()


def local_batches(batches: Callable[[], Iterator], mesh) -> Callable[[], Iterator]:
    """``batches`` with every array of a batch cut to this rank's rows
    [r*B/n, (r+1)*B/n) of 'data' (r its data index, n the data ranks);
    ``batches`` itself without a mesh or with one data rank."""
    if mesh is None or mesh.n_data == 1:
        return batches
    from ..parallel.mesh import batch_sharding

    rows = batch_sharding(mesh)

    def gen():
        for batch in batches():
            if len(batch[0]) % mesh.n_data:
                raise ValueError(f"batch of {len(batch[0])} does not split over "
                                 f"{mesh.n_data} data ranks")
            yield tuple(rows.shard(a) for a in batch)
    return gen


def _group(batches: Iterator, k: int, pending: list, seen: dict) -> Iterator:
    """Groups of k consecutive batches. ``pending`` persists across calls so a
    sampler pass shorter than k carries its batches into the next pass."""
    for b in batches:
        seen["n"] += 1
        pending.append(b)
        if len(pending) == k:
            yield list(pending)
            pending.clear()


def run_training(
    ts: dict,
    train_batches: Callable[[], Iterator],
    val_batches: Callable[[], Iterator] | None,
    train_step: Callable,            # (ts, *batch) -> (ts, metrics)
    eval_step: Callable | None,      # (ts, *batch) -> metrics
    loop_cfg: LoopConfig,
    ckpt: Checkpointer | None = None,
    log_dir: str | None = None,
    config_snapshot: dict | None = None,
    on_epoch: Callable[[dict, int], None] | None = None,
    artifact_fn: Callable[[dict, int], None] | None = None,
    pre_eval_fn: Callable[[dict], dict] | None = None,
) -> dict:
    """Run the training loop; returns the final train state. Resumes from
    ``ckpt``'s latest checkpoint when there is one."""
    resumed_at = None
    if ckpt is not None:
        ts, step = ckpt.restore_into(ts)
        if step is not None:
            print(f" resumed from step {step}")
            resumed_at = int(step)
    step = int(ts["step"])
    epoch = int(ts["epoch"])

    trn_writer = MetricsWriter(log_dir, "trn") if log_dir else None
    val_writer = MetricsWriter(log_dir, "val") if log_dir else None
    timer = StepTimer()

    val_iter = None
    if val_batches is not None:
        def fresh_val():
            while True:
                got = False
                for b in val_batches():
                    got = True
                    yield b
                if not got:
                    raise RuntimeError(
                        "validation stream yielded no batches — val split smaller than one "
                        "batch? (lower batch size or raise prop_val)")
        val_iter = fresh_val()

    k = loop_cfg.steps_per_call if loop_cfg.steps_per_call else min(loop_cfg.steps_per_epoch, 16)
    k = max(1, min(k, loop_cfg.steps_per_epoch))
    while k > 1 and loop_cfg.steps_per_epoch % k:
        k -= 1

    # a run resumed at (or past) max_steps or n_epochs is complete already
    stop = ((loop_cfg.max_steps is not None and step >= loop_cfg.max_steps)
            or epoch >= loop_cfg.n_epochs)
    pending: list = []
    saved_at: int | None = None
    metrics: dict = {}
    while not stop:
        seen = {"n": 0}
        batches = _group(train_batches(), k, pending, seen)
        if loop_cfg.prefetch:
            batches = device_prefetch(batches, size=loop_cfg.prefetch, device=loop_cfg.device)
        got_batch = False
        for group in batches:
            got_batch = True
            if loop_cfg.max_steps is not None and step + k > loop_cfg.max_steps:
                # exact-stop tail: the remaining < k steps
                for b in group[:loop_cfg.max_steps - step]:
                    ts, metrics = train_step(ts, *b)
                step = loop_cfg.max_steps
                timer.tick()
                stop = True
                break
            for b in group:
                ts, metrics = train_step(ts, *b)
            timer.tick()
            step += k

            if trn_writer and (step % loop_cfg.log_every_steps < k or step == k):
                trn_writer.write(step, {**metrics, "steps_per_sec": timer.steps_per_sec * k,
                                        "epoch": epoch})

            # boundary crossing, not step % steps_per_epoch == 0: a run resumed
            # off the k-grid still moves its epochs
            if step // loop_cfg.steps_per_epoch > epoch:
                ts = next_epoch(ts)
                epoch += 1
                if on_epoch is not None:
                    on_epoch(ts, epoch)

                if epoch % loop_cfg.save_each_n_epochs == 0:
                    if pre_eval_fn is not None:
                        ts = pre_eval_fn(ts)
                    if ckpt is not None:
                        ckpt.save(ts, step=step, config=config_snapshot)
                        saved_at = step
                    if val_iter is not None and eval_step is not None:
                        vms = [eval_step(ts, *next(val_iter))
                               for _ in range(max(loop_cfg.val_batches_per_eval, 1))]
                        vm = {n: float(np.mean([float(m[n]) for m in vms])) for n in vms[0]}
                        if len(vms) > 1:
                            vm.update({f"{n}_std": float(np.std([float(m[n]) for m in vms]))
                                       for n in vms[0]})
                        if val_writer:
                            val_writer.write(step, vm)
                    if artifact_fn is not None:
                        artifact_fn(ts, step)

                if epoch >= loop_cfg.n_epochs:
                    stop = True
                    break

            if loop_cfg.max_steps is not None and step >= loop_cfg.max_steps:
                stop = True
                break
        else:
            if not got_batch and not seen["n"]:
                raise RuntimeError(
                    "train_batches yielded no batches — dataset/filter/split produced fewer "
                    "samples than one batch")
            continue
        break

    # the last step was saved in the loop, or the run resumed complete: the
    # checkpoint on disk is final already
    if saved_at != step and resumed_at != step:
        if pre_eval_fn is not None:
            ts = pre_eval_fn(ts)
        if ckpt is not None:
            ckpt.save(ts, step=step, config=config_snapshot)
    for w in (trn_writer, val_writer):
        if w:
            w.close()
    return ts
