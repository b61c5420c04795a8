"""Data- and tensor-parallel training of the PyTorch port on the CPU: gloo
worlds of processes against the JAX package's sharded step and against the
port's own single-process step.

One 2 x 2 world (data=2, model=2) runs every API case
(``tests/torch_port_dist_workers.py``: the workers import only the port):
the bootstrap helpers against JAX's formulas, then encoder and decoder
train steps on a global batch of 8 (4 rows a data rank, the bank channels
split over 2 model ranks). Held to:

- the JAX (data=4, model=2) step of tests/test_train.py (jitted over 8
  virtual devices, dropout 0): the loss within rtol 1e-4, as that test
  holds JAX's own sharded step to its single-device one;
- the port's single-process step on the whole batch: the loss within rtol
  1e-5 and the BN state within 1e-6, with dropout on (the global batch's
  masks) and with the "log" loss; every gradient leaf within the larger of
  GRAD_REL of its peak (the float32 limit of tests/test_torch_port_train.py)
  and twice the case's float32 noise floor: how far the single-process
  gradient moves when the same batch comes in reversed row order (measured
  on the case with dropout 0; a decoder step at epoch 300 moves up to 2e-3
  of a leaf's peak that way, through max-pool near-ties and train-mode BN
  sums that cancel);
- the bank leaves really split: each rank holds 64 of a bank's 128 channels,
  the slices `shard_params` / `shard_state` cut, and a resumed train state
  takes them back from the gathered checkpoint; `replicate_tree` gives
  every rank rank 0's values;
- the gathered checkpoint: the tree the single-process save writes after
  the same step (Adam's moments within GRAD_REL of their peak; parameters
  within 2 lr, since Adam's first step is lr * sign(g) and a gradient at the
  float32 noise level may flip).

Then ``apps.train_encoder.main`` with --n-data 2 --n-model 2 --device cpu
--dist-backend gloo runs 2 steps and is held to the single-process run of
the same command: the logged loss, the final checkpoint's BN state and its
parameters as above. Each world is started once (a 4-process spawn costs
seconds).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train_apps import work  # noqa: F401
from torch_port_dist_workers import step, world_cases

from speech_cloner_tpu.models import decoder as jdec
from speech_cloner_tpu.models import encoder as jenc
from speech_cloner_tpu.parallel import batch_sharding, make_mesh, shard_params, shard_state
from speech_cloner_tpu.parallel import distributed as jdist
from speech_cloner_tpu.train import steps as jsteps
from speech_cloner_tpu.train.optimizer import OptimizerConfig as JOptimizerConfig
from speech_cloner_tpu.train.optimizer import make_train_state as j_make_train_state
from speech_cloner_tpu_torch.models import decoder as tdec
from speech_cloner_tpu_torch.parallel import distributed as tdist
from speech_cloner_tpu_torch.parallel.distributed import spawn_world
from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer

torch.set_num_threads(2)
B = 8
LR = 1e-3
GRAD_REL = 2e-5
ENC = jenc.EncoderConfig(n_timesteps=32, input_dim=16, n_output=61, num_conv_banks=3,
                         num_highwaynet_blocks=1, dropout_rate=0.0)
DEC = jdec.DecoderConfig(n_timesteps=32, input_dim=61,
                         step1=jdec.DecoderStepConfig(32, 3, 1, 20),
                         step2=jdec.DecoderStepConfig(48, 3, 1, 51),
                         dropout_rate=0.0, use_target_mel_step2=True)


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def t_dec(cfg: jdec.DecoderConfig) -> tdec.DecoderConfig:
    d = dataclasses.asdict(cfg)
    return tdec.DecoderConfig(**{**d, "step1": tdec.DecoderStepConfig(**d["step1"]),
                                 "step2": tdec.DecoderStepConfig(**d["step2"])})


def leaves_close(got, ref, rel, what, floor=None):
    """Every leaf within ``rel`` of its reference's peak, or within the
    matching leaf of ``floor`` when that is larger."""
    g, r = jax.tree.leaves(got), jax.tree.leaves(ref)
    f = jax.tree.leaves(floor) if floor is not None else [0.0] * len(r)
    assert len(g) == len(r), what
    for i, (a, b, lim) in enumerate(zip(g, r, f)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        err = np.abs(a - b).max() if b.size else 0.0
        tol = max(rel * max(np.abs(b).max(), 1e-30), float(lim))
        assert err <= tol, (what, i, err, np.abs(b).max(), float(lim))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """name -> (kind, case) with JAX-initialized trees and a global batch."""
    enc_tree = np_tree(jenc.init(jax.random.PRNGKey(0), ENC))
    dec_tree = np_tree(jdec.init(jax.random.PRNGKey(7), DEC))
    rng = np.random.default_rng(2)
    x = randn((B, 32, 16), 3)
    y = np.eye(61, dtype=np.float32)[rng.integers(0, 61, (B, 32))]
    dec_batch = [x, randn((B, 32, 20), 10, 0.1), randn((B, 32, 51), 11, 0.1)]
    enc = dict(tree=enc_tree, cfg=dataclasses.asdict(ENC), batch=[x, y])
    dec = dict(tree=dec_tree, cfg=t_dec(DEC), batch=dec_batch, enc_tree=enc_tree,
               enc_cfg=dataclasses.asdict(ENC), epoch=300, loss={})
    root = tmp_path_factory.mktemp("dist_ckpt")
    return {
        "enc": ("encoder", {**enc, "ckpt": str(root / "world")}),
        "enc_dropout": ("encoder", {**enc, "cfg": {**enc["cfg"], "dropout_rate": 0.4}}),
        "dec": ("decoder", dec),
        "dec_log": ("decoder", {**dec, "cfg": dataclasses.replace(t_dec(DEC), dropout_rate=0.1),
                                "loss": {"loss_type": "log"}}),
    }


@pytest.fixture(scope="module")
def world(cases):
    return spawn_world(world_cases, 4, cases)


def _without_dropout(case: dict) -> dict:
    cfg = case["cfg"]
    cfg = {**cfg, "dropout_rate": 0.0} if isinstance(cfg, dict) else \
        dataclasses.replace(cfg, dropout_rate=0.0)
    return {**case, "cfg": cfg, "ckpt": None}


@pytest.fixture(scope="module")
def single(cases, tmp_path_factory):
    """The single-process step of each case, and its noise floor: twice the
    per-leaf max gap between the step on the batch and on the batch in
    reversed row order (dropout 0)."""
    root = tmp_path_factory.mktemp("single_ckpt")
    out = {}
    for name, (kind, case) in cases.items():
        out[name] = step(kind, {**case, "ckpt": str(root)} if "ckpt" in case else case)
        base = step(kind, _without_dropout(case))
        rev = step(kind, {**_without_dropout(case), "batch": [a[::-1].copy()
                                                              for a in case["batch"]]})
        out[name]["noise"] = jax.tree.map(lambda a, b: 2 * np.abs(a - b).max(),
                                          rev["grads"], base["grads"])
    out["ckpt"] = str(root)
    return out


def test_bootstrap_helpers_match_jax(world):
    """initialize / host_shard / per_host_batch: a single process as JAX's
    single process; each rank of the 4-process world by JAX's formulas."""
    assert tdist.initialize() is False and jdist.initialize() is False
    np.testing.assert_array_equal(tdist.host_shard(np.arange(10)), jdist.host_shard(np.arange(10)))
    assert tdist.per_host_batch(8) == jdist.per_host_batch(8) == 8
    for r, out in enumerate(world):
        assert out["rank"] == r and out["initialize"] is True
        assert out["host_shard"] == list(range(10))[r::4]
        assert out["per_host_batch"] == 8 // 4
        assert out["per_host_batch_6"] == "AssertionError"
        assert tuple(out["coords"]) == (r // 2, r % 2)
        assert out["replicated"] == [0.0, 1.0, 2.0]      # rank 0's values everywhere


def _jax_sharded_loss(kind: str) -> float:
    """The JAX step over a (data=4, model=2) mesh of the 8 virtual devices
    (tests/test_train.py test_distributed_matches_single_device)."""
    opt_cfg = JOptimizerConfig()
    opt = opt_cfg.make()
    mesh = make_mesh(n_data=4, n_model=2)
    rng = np.random.default_rng(2)
    x = randn((B, 32, 16), 3)
    if kind == "encoder":
        params, state = jenc.init(jax.random.PRNGKey(0), ENC)
        args = (x, np.eye(61, dtype=np.float32)[rng.integers(0, 61, (B, 32))])

        def run(t, *a):
            return jsteps.encoder_train_step(t, *a, cfg=ENC, opt_cfg=opt_cfg, opt=opt)
    else:
        params, state = jdec.init(jax.random.PRNGKey(7), DEC)
        e_params, e_state = jenc.init(jax.random.PRNGKey(0), ENC)
        args = (x, randn((B, 32, 20), 10, 0.1), randn((B, 32, 51), 11, 0.1))

        def run(t, *a):
            return jsteps.decoder_train_step(
                t, *a, enc_params=e_params, enc_state=e_state, enc_cfg=ENC, cfg=DEC,
                loss_cfg=jsteps.DecoderLossConfig(), opt_cfg=opt_cfg, opt=opt)
    ts = j_make_train_state(params, state, opt_cfg, jax.random.PRNGKey(1))
    if kind == "decoder":
        ts = {**ts, "epoch": jnp.asarray(300, jnp.int32)}
    with mesh:
        ts = {**ts, "params": shard_params(ts["params"], mesh),
              "model_state": shard_state(ts["model_state"], mesh)}
        sharded = [jax.device_put(jnp.asarray(a), batch_sharding(mesh)) for a in args]
        _, m = jax.jit(run)(ts, *sharded)
    return float(m["loss"])


@pytest.mark.parametrize("name,kind", [("enc", "encoder"), ("dec", "decoder")])
def test_world_step_matches_jax_sharded_step(world, name, kind):
    for out in world:
        np.testing.assert_allclose(out[name]["loss"], _jax_sharded_loss(kind), rtol=1e-4)


@pytest.mark.parametrize("name", ["enc", "enc_dropout", "dec", "dec_log"])
def test_world_step_matches_single_process(world, single, name):
    ref = single[name]
    for out in world:
        got = out[name]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        for k in ref["metrics"]:
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-5, atol=1e-7)
        leaves_close(got["grads"], ref["grads"], GRAD_REL, f"{name} grads", ref["noise"])
        leaves_close(got["state"], ref["state"], 1e-6, f"{name} bn state")


def test_bank_leaves_really_sharded(world):
    """Each model rank holds half of every bank's 128 channels: the slices
    shard_params / shard_state cut from the full trees; a checkpoint read
    back into a fresh sharded train state gives each rank its slices."""
    for out in world:
        assert out["enc"]["slices_match"] and out["dec"]["slices_match"]
        assert out["enc"]["restored_gap"] == 0.0
        assert out["enc"]["local_shapes"] == [(k, 8, 64) for k in (1, 2, 3)]
        assert out["dec"]["local_shapes"] == [(k, 24, 64) for k in (1, 2, 3)]


def _ckpt_close(got_tree, ref_tree):
    """Train states after one Adam step: scalars exact, moments within
    GRAD_REL of their peak, parameters within 2 lr, BN state 1e-6."""
    for key in ("step", "epoch", "rng"):
        np.testing.assert_array_equal(got_tree[key], ref_tree[key])
    count, mu, nu = got_tree["opt_state"]
    r_count, r_mu, r_nu = ref_tree["opt_state"]
    assert int(count) == int(r_count)
    leaves_close(mu, r_mu, GRAD_REL, "mu")
    leaves_close(nu, r_nu, 2 * GRAD_REL, "nu")
    leaves_close(got_tree["model_state"], ref_tree["model_state"], 1e-6, "bn state")
    for a, b in zip(jax.tree.leaves(got_tree["params"]), jax.tree.leaves(ref_tree["params"])):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 2 * LR * 1.001


def test_gathered_checkpoint_matches_single_save(world, single, cases):
    got, step_got = Checkpointer(cases["enc"][1]["ckpt"], "encoder").restore()
    ref, step_ref = Checkpointer(single["ckpt"], "encoder").restore()
    assert step_got == step_ref == 1
    _ckpt_close(got, ref)


# ------------------------------------------------------------------ the app ---

def _app_run(work, out, extra):  # noqa: F811
    from speech_cloner_tpu_torch.apps import train_encoder as pte

    pte.main(["--ds-path", str(work / "timit"), "--enc-cfg", str(work / "enc.json"),
              "--ds-cfg", str(work / "ds.json"), "--batch-size", "4", "--max-steps", "2",
              "--steps-per-call", "1", "--model-path", str(out / "m"),
              "--log-dir", str(out / "l"), "--device", "cpu", "--loader", "h5py", *extra])
    tree, step_n = Checkpointer(str(out / "m"), "encoder").restore()
    log = [json.loads(line) for line in (out / "l" / "trn.jsonl").read_text().splitlines()]
    return tree, step_n, log


def test_train_encoder_app_2x2_matches_single_process(work, tmp_path):  # noqa: F811
    ref, ref_step, ref_log = _app_run(work, tmp_path / "single", [])
    got, got_step, got_log = _app_run(work, tmp_path / "world", [
        "--n-data", "2", "--n-model", "2", "--dist-backend", "gloo"])
    assert got_step == ref_step == 2
    assert [r["step"] for r in got_log] == [r["step"] for r in ref_log]
    for a, b in zip(got_log, ref_log):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    leaves_close(got["model_state"], ref["model_state"], 1e-5, "bn state")
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(ref["params"])):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 2 * 2 * LR * 1.001
        assert np.median(np.abs(a - b)) <= 1e-5


def test_train_encoder_rank_flags_checked(work, tmp_path):  # noqa: F811
    """--rank-devices must name one device per rank; a card that is not
    there raises before any rank starts."""
    from speech_cloner_tpu_torch.apps import train_encoder as pte

    base = ["--ds-path", str(work / "timit"), "--model-path", str(tmp_path / "m"),
            "--device", "cpu", "--n-data", "2"]
    with pytest.raises(SystemExit):
        pte.main(base + ["--rank-devices", "cpu"])
    with pytest.raises(ValueError):
        pte.main(base + ["--rank-devices", "cpu,cuda:0"])
