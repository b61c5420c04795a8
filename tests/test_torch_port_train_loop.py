"""The port's training loop, checkpointer and logging on the CPU: the resume
and epoch rules of tests/test_train.py's loop tests, run on the port's
``train.loop.run_training`` with steps of numpy and tensor states, plus
pruning, the JSONL records and the prefetch thread."""

import json
import os

import numpy as np
import pytest
import torch

from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer
from speech_cloner_tpu_torch.runtime.logging import MetricsWriter, StepTimer
from speech_cloner_tpu_torch.train.loop import LoopConfig, device_prefetch, run_training


def state():
    return {"step": np.int32(0), "epoch": np.int32(0), "w": torch.zeros(3)}


def train_step(ts, x):
    with torch.no_grad():
        ts["w"].add_(torch.as_tensor(x).mean())
    return {**ts, "step": np.int32(ts["step"] + 1)}, {"loss": torch.as_tensor(x).mean()}


def batches(n=100):
    def gen():
        for _ in range(n):
            yield (np.ones(4, np.float32),)
    return gen


def mtime(path):
    return max(os.path.getmtime(os.path.join(path, f)) for f in os.listdir(path))


def test_grouped_loop_resumes_from_misaligned_step(tmp_path):
    """Resume from a step off the k-grid: epoch boundaries still fire
    (boundary crossing, not step % steps_per_epoch), cadence saves happen."""
    ck = Checkpointer(str(tmp_path), "m")
    ck.save({"step": np.int64(5), "epoch": np.int64(0), "w": np.zeros(3, np.float32)}, step=5)
    cfg = LoopConfig(n_epochs=99, steps_per_epoch=6, save_each_n_epochs=1, steps_per_call=3,
                     max_steps=17, prefetch=0)
    ts = run_training(state(), batches(), None, train_step, None, cfg, ckpt=ck)
    # resumed 5 -> groups end at 8, 11, 14; the exact-stop tail runs 15..17
    assert int(ts["epoch"]) == 2, int(ts["epoch"])
    assert 8 in ck.steps() and 14 in ck.steps(), ck.steps()
    assert ck.latest_step() == 17 and int(ts["step"]) == 17
    np.testing.assert_allclose(ts["w"].numpy(), 12.0)     # 12 steps ran, in place


@pytest.mark.parametrize("stop", ["max_steps", "n_epochs"])
def test_resume_of_finished_run_is_a_noop(tmp_path, stop):
    """A restart of a run that stopped at max_steps or n_epochs trains
    nothing, runs no pre_eval_fn and rewrites no checkpoint."""
    ck = Checkpointer(str(tmp_path), "m")
    calls = {"pre_eval": 0, "steps": 0}

    def pre_eval(ts):
        calls["pre_eval"] += 1
        return ts

    def step(ts, x):
        calls["steps"] += 1
        return train_step(ts, x)

    cfg = (LoopConfig(n_epochs=99, steps_per_epoch=4, save_each_n_epochs=10, max_steps=8,
                      prefetch=0) if stop == "max_steps" else
           LoopConfig(n_epochs=2, steps_per_epoch=4, save_each_n_epochs=1, prefetch=0))
    run_training(state(), batches(50), None, step, None, cfg, ckpt=ck, pre_eval_fn=pre_eval)
    assert ck.latest_step() == 8 and calls["steps"] == 8 and calls["pre_eval"] >= 1
    n_pre, t0 = calls["pre_eval"], mtime(str(tmp_path))
    run_training(state(), batches(50), None, step, None, cfg, ckpt=ck, pre_eval_fn=pre_eval)
    assert calls == {"pre_eval": n_pre, "steps": 8}
    assert mtime(str(tmp_path)) == t0


def test_validation_logging_and_artifacts(tmp_path):
    seen = []
    cfg = LoopConfig(n_epochs=2, steps_per_epoch=3, save_each_n_epochs=1, log_every_steps=2,
                     val_batches_per_eval=2, prefetch=2, device="cpu")

    def eval_step(ts, x):
        return {"loss": torch.as_tensor(x).sum()}

    ck = Checkpointer(str(tmp_path / "ck"), "m")
    run_training(state(), batches(9), batches(1), train_step, eval_step, cfg, ckpt=ck,
                 log_dir=str(tmp_path / "logs"), artifact_fn=lambda ts, s: seen.append(s))
    assert seen == [3, 6] and ck.steps() == [3, 6]
    trn = [json.loads(line) for line in open(tmp_path / "logs" / "trn.jsonl")]
    val = [json.loads(line) for line in open(tmp_path / "logs" / "val.jsonl")]
    assert [r["step"] for r in trn] == [1, 2, 4, 6] and trn[0]["loss"] == 1.0
    assert [r["step"] for r in val] == [3, 6] and val[0]["loss"] == 4.0
    assert val[0]["loss_std"] == 0.0 and "steps_per_sec" in trn[-1]


def test_empty_sampler_raises():
    with pytest.raises(RuntimeError, match="no batches"):
        run_training(state(), batches(0), None, train_step, None,
                     LoopConfig(steps_per_epoch=2, prefetch=0))


def test_device_prefetch_stages_tensors_and_stops():
    got = list(device_prefetch(iter([(np.ones(3), np.zeros(2))] * 5), size=2, device="cpu"))
    assert len(got) == 5 and all(isinstance(t, torch.Tensor) for b in got for t in b)

    def failing():
        yield (np.ones(2),)
        raise ValueError("sampler broke")
    with pytest.raises(ValueError, match="sampler broke"):
        list(device_prefetch(failing(), device="cpu"))
    gen = device_prefetch(iter([(np.ones(1),)] * 100), size=2, device="cpu")
    next(gen)
    gen.close()                                   # stops its thread, does not hang


@pytest.mark.parametrize("n_keep,step_min", [(3, 20), (100, 0), (1, 0), (4, 95)])
def test_prune_matches_jax(tmp_path, n_keep, step_min):
    """The same files kept as the JAX Checkpointer.prune keeps."""
    from speech_cloner_tpu.runtime.checkpoint import Checkpointer as JCheckpointer

    kept = []
    for pkg, cls in (("port", Checkpointer), ("jax", JCheckpointer)):
        ck = cls(str(tmp_path / pkg), "decoder")
        for s in range(0, 100, 10):
            Checkpointer(str(tmp_path / pkg), "decoder").save({"w": np.zeros(1)}, step=s)
        n = ck.prune(n_keep=n_keep, step_min=step_min)
        kept.append((n, ck.steps()))
    assert kept[0] == kept[1]


def test_metrics_writer_and_timer(tmp_path):
    w = MetricsWriter(str(tmp_path), "trn")
    w.write(3, {"loss": torch.tensor(2.5), "lr": np.float32(1e-3), "vec": np.zeros(2)})
    w.write_array(3, "cm", np.eye(2))
    w.close()
    rec = json.loads(open(tmp_path / "trn.jsonl").readline())
    assert rec["step"] == 3 and rec["loss"] == 2.5 and "vec" not in rec
    assert np.load(tmp_path / "cm_3.npy").shape == (2, 2)
    t = StepTimer(window=2)
    assert t.tick() is None and t.steps_per_sec == 0.0
    t.tick(), t.tick(), t.tick()
    assert len(t.times) == 2 and t.steps_per_sec > 0
