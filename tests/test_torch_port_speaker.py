"""The speaker-ID verifier of the PyTorch port against the JAX package, on the CPU.

The CNN (`models/speaker_id.py`) on the JAX package's own ``init`` trees:
the eval forward, train-mode BN (the new running statistics) and every
gradient, for ``time_fold`` 1 and 2; weights carried both ways; the train
step in float32 and bf16; the vocoded augmentation with the phases and the
mask JAX draws handed to the port; the TIMIT speaker sampler's windows and
classes; ``verify_conversion`` on checkpoints written by each package; the
trainer app's checkpoints read across the packages; ``apps.convert
--verify-ckpt``.

Limits: float32 sums in another order, 1e-5 of each output's or leaf's peak
(1e-6 for BN statistics). bf16: each gradient leaf's relative L2 distance
from JAX's float32 gradient within twice JAX's own bf16 distance plus 1e-5
(as tests/test_torch_port_train_bf16.py). Griffin-Lim resynthesis with
momentum 0.99 amplifies float32 differences, and the far bins of the
resynthesis sit at float32's FFT noise floor, where log10 magnifies them
(as tests/test_torch_port_data.py finds for power_dB): the vocoded windows
within 2e-3 of their peak, 99.9% of the values within 1e-4 (measured
1.08e-3 at one floor bin of an edge frame, 99.995% within 1e-4).
Posteriors within 1e-5.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_data import _make_timit_tree
from test_torch_port_data import FEAT, FEAT_TOL
from test_torch_port_train import assert_tree_close, np_tree, random_state
from test_torch_port_train_bf16 import assert_within_jax_gap

from speech_cloner_tpu.data.timit import TIMIT as JTIMIT
from speech_cloner_tpu.models import speaker_id as JS
from speech_cloner_tpu.ops.features import FeatureConfig as JFeatureConfig
from speech_cloner_tpu.pipeline import verify as jverify
from speech_cloner_tpu.runtime.checkpoint import Checkpointer as JCheckpointer
from speech_cloner_tpu.train import augment as jaugment
from speech_cloner_tpu.train import metrics as jmetrics
from speech_cloner_tpu.train import steps as jsteps
from speech_cloner_tpu.train.optimizer import OptimizerConfig as JOptimizerConfig
from speech_cloner_tpu.train.optimizer import make_train_state as j_make_train_state
from speech_cloner_tpu_torch.data.audio_io import write_riff_wav
from speech_cloner_tpu_torch.data.timit import TIMIT
from speech_cloner_tpu_torch.models import speaker_id as TS
from speech_cloner_tpu_torch.ops.features import FeatureConfig
from speech_cloner_tpu_torch.pipeline import verify as tverify
from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer
from speech_cloner_tpu_torch.runtime.jax_params import speaker_id_from_jax, speaker_id_to_jax
from speech_cloner_tpu_torch.train import augment as taugment
from speech_cloner_tpu_torch.train import steps as tsteps
from speech_cloner_tpu_torch.train.metrics import softmax_xent
from speech_cloner_tpu_torch.train.optimizer import OptimizerConfig, make_train_state

torch.set_num_threads(2)
SMALL = dict(n_timesteps=24, n_features=21, n_output=5)
REPORT_KEYS = {"true_top", "pred_top", "identity_changed", "n_windows_true", "n_windows_pred",
               "control_top", "control_match", "cos_pred_control", "cos_pred_true",
               "target_spk_id", "target_p_true", "target_p_pred", "target_hit"}


def cfgs(fold=1, **kw):
    d = {**SMALL, "time_fold": fold, **kw}
    return JS.SpeakerIdConfig(**d), TS.SpeakerIdConfig(**d)


def jax_model(fold=1, seed=0, **kw):
    jcfg, tcfg = cfgs(fold, **kw)
    params, state = np_tree(JS.init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, params, random_state(state, seed + 1)


def windows(n, cfg, seed):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, cfg.n_timesteps, cfg.n_features)).astype(np.float32)


def one_hot(n, k, seed):
    return np.eye(k, dtype=np.float32)[np.random.default_rng(seed).integers(0, k, n)]


# ------------------------------------------------------------------ model ---

@pytest.mark.parametrize("fold", [1, 2])
def test_forward_bn_and_gradients_match_jax(fold):
    jcfg, tcfg, params, state = jax_model(fold, seed=fold)
    assert tcfg.flat_dim == jcfg.flat_dim > 0
    x, y = windows(4, jcfg, 3), one_hot(4, jcfg.n_output, 4)
    ref, _ = JS.apply(params, state, jnp.asarray(x), cfg=jcfg, train=False)
    model = speaker_id_from_jax(params, state, tcfg)
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert_tree_close(got.numpy(), np.asarray(ref), 1e-5, "eval logits")

    def loss_fn(p):
        logits, new_state = JS.apply(p, state, jnp.asarray(x), cfg=jcfg, train=True)
        return jmetrics.softmax_xent(logits, y), new_state
    (loss_ref, state_ref), grads_ref = jax.value_and_grad(loss_fn, has_aux=True)(params)
    loss = softmax_xent(model(torch.tensor(x), train=True), torch.tensor(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    assert_tree_close(speaker_id_to_jax(model, grads=True), np_tree(grads_ref), 1e-5, "grads")
    assert_tree_close(speaker_id_to_jax(model)[1], np_tree(state_ref), 1e-6, "bn state")


def test_weights_both_ways_and_init_layout():
    jcfg, tcfg, params, state = jax_model(2)
    back = speaker_id_to_jax(speaker_id_from_jax(params, state, tcfg))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves((params, state))):
        np.testing.assert_array_equal(a, b)
    # the port's own init has the JAX layout (the JAX apply runs on it)
    tp, tst = TS.init_tree(torch.Generator().manual_seed(0), tcfg)
    tree = jax.tree.map(lambda t: t.numpy(), (tp, tst))
    assert jax.tree.structure(tree) == jax.tree.structure((params, state))
    assert [a.shape for a in jax.tree.leaves(tree)] == [a.shape for a in jax.tree.leaves(params)
                                                        + jax.tree.leaves(state)]
    lim = np.sqrt(6.0 / (5 * 5 * 2 + 5 * 5 * 32))           # glorot bound of conv1
    assert 0 < np.abs(tree[0]["conv1"]["kernel"]).max() <= lim
    JS.apply(*tree, jnp.asarray(windows(2, jcfg, 0)), cfg=jcfg)
    with pytest.raises(ValueError, match="mismatch"):
        speaker_id_from_jax(params, state, cfgs(1)[1])       # conv1 is [5, 5, 2, 32] here
    with pytest.raises(ValueError, match="divide"):
        TS.init_tree(torch.Generator(), TS.SpeakerIdConfig(n_timesteps=25, time_fold=2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_speaker_train_step_matches_jax(dtype):
    jcfg, tcfg, params, state = jax_model(1, seed=5)
    x, y = windows(6, jcfg, 6), one_hot(6, jcfg.n_output, 7)
    jdt = None if dtype == "float32" else jnp.bfloat16

    def grads(dt):
        def loss_fn(p):
            logits, _ = JS.apply(jsteps._cast_floats(p, dt), state,
                                 jsteps._cast_floats(jnp.asarray(x), dt), cfg=jcfg, train=True)
            return jmetrics.softmax_xent(logits.astype(jnp.float32), y)
        return np_tree(jax.grad(loss_fn)(params))

    jopt_cfg = JOptimizerConfig(learning_rate=1e-4)
    _, jm = jsteps.speaker_train_step(
        j_make_train_state(params, state, jopt_cfg, jax.random.PRNGKey(1)), jnp.asarray(x),
        jnp.asarray(y), cfg=jcfg, opt_cfg=jopt_cfg, opt=jopt_cfg.make(), compute_dtype=jdt)
    model = speaker_id_from_jax(params, state, tcfg)
    opt_cfg = OptimizerConfig(learning_rate=1e-4)
    ts2, m = tsteps.speaker_train_step(make_train_state(model, opt_cfg, 1), x, y, model=model,
                                       opt_cfg=opt_cfg, opt=opt_cfg.make(),
                                       compute_dtype=getattr(torch, dtype))
    assert int(ts2["step"]) == 1 and float(m["lr"]) == pytest.approx(1e-4)
    grads_port = speaker_id_to_jax(model, grads=True)
    if jdt is None:
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        assert float(m["acc"]) == float(jm["acc"])
        assert_tree_close(grads_port, grads(None), 1e-5, "grads")
    else:
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-2)
        assert_within_jax_gap(grads_port, grads(jnp.bfloat16), grads(None), "speaker")
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(b.dtype == torch.float32 for b in model.buffers())
    ev = tsteps.speaker_eval_step(model, x, y)
    assert set(ev) == {"loss", "acc"} and 0.0 <= float(ev["acc"]) <= 1.0


# ------------------------------------------------------------ augmentation ---

def test_mix_vocoded_matches_jax_with_shared_phases_and_mask():
    """The phases and the Bernoulli mask JAX's mix_vocoded draws from its key,
    computed here from the same key and handed to the port."""
    B, T, n_iter = 4, 24, 6
    F = FeatureConfig().n_stft
    x = np.random.default_rng(0).uniform(0, 1, (B, T, F)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    ref = np.asarray(jaugment.mix_vocoded(jnp.asarray(x), JFeatureConfig(), key=key, frac=0.5,
                                          n_iter=n_iter))
    k_gl, k_sel = jax.random.split(key)
    phases = np.stack([np.asarray(jnp.pi * jax.random.uniform(k, (T, F), dtype=jnp.float32))
                       for k in jax.random.split(k_gl, B)])
    mask = np.asarray(jax.random.bernoulli(k_sel, 0.5, (B,)))
    assert 0 < mask.sum() < B                   # both branches of the mix
    got = taugment.mix_vocoded(torch.tensor(x), FeatureConfig(), frac=0.5, n_iter=n_iter,
                               init_phase=torch.tensor(phases), mask=torch.tensor(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got[~mask], x[~mask])
    err = np.abs(got - ref) / np.abs(ref).max()
    assert err.max() <= 2e-3 and (err <= 1e-4).mean() >= 0.999, (err.max(), (err <= 1e-4).mean())
    assert np.abs(got[mask] - x[mask]).max() > 0.1          # the windows were resynthesized
    # frac 0 is the identity; the generator path is reproducible
    tx = torch.tensor(x)
    assert taugment.mix_vocoded(tx, FeatureConfig(), frac=0.0) is tx
    a, b = (taugment.mix_vocoded(torch.tensor(x), FeatureConfig(), frac=1.0, n_iter=2,
                                 generator=torch.Generator().manual_seed(3)) for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------- data ---

@pytest.fixture(scope="module")
def timit_pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spk_timit"))
    _make_timit_tree(root)
    caches = tmp_path_factory.mktemp("spk_caches")
    j = JTIMIT(root, JFeatureConfig(**FEAT), n_timesteps=40, seed=0, cache_dir=str(caches / "j"))
    t = TIMIT(root, FeatureConfig(**FEAT), n_timesteps=40, seed=0, cache_dir=str(caches / "t"))
    j.build_spec_cache()
    t.build_spec_cache()
    return root, j, t


def test_speaker_sampler_same_windows_and_classes(timit_pair):
    _, j, t = timit_pair
    filt = {"split_d": {"split_key": "spk_id", "split_props_v": (0.8, 0.9), "split_type": "trn"}}
    assert t.prepare_speaker_dicts(filt) == j.prepare_speaker_dicts(filt) == 2
    assert t.all_spk_id_v == j.all_spk_id_v and t.spk_id2class == j.spk_id2class
    got = list(t.speaker_spec_sampler(3, n_epochs=2, ds_filter_d=filt))
    ref = list(j.speaker_spec_sampler(3, n_epochs=2, ds_filter_d=filt))
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        for name, a, b in zip(("mfcc", "mel_dB", "power_dB"), g[:3], r[:3]):
            np.testing.assert_allclose(a, b, atol=FEAT_TOL[name], err_msg=name)
        np.testing.assert_array_equal(g[3], r[3])


# ----------------------------------------------------------- verification ---

def save_speaker_ckpt(path, package, params, state, cfg, spk_id_v):
    config = {"n_timesteps": cfg.n_timesteps, "n_features": cfg.n_features,
              "n_output": cfg.n_output, "time_fold": cfg.time_fold, "spk_id_v": spk_id_v}
    tree = {"params": params, "model_state": state, "step": np.int32(3)}
    if package == "jax":
        JCheckpointer(path, "speaker_id").save(tree, step=3, config=config, sync=True)
    else:
        Checkpointer(path, "speaker_id").save(tree, step=3, config=config)


def tone(seconds, f0, seed):
    t = np.arange(int(16000 * seconds)) / 16000
    noise = 0.01 * np.random.default_rng(seed).standard_normal(t.size)
    return (0.3 * np.sin(2 * np.pi * f0 * t) + noise).astype(np.float32)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_verify_conversion_matches_jax(writer, tmp_path):
    jcfg, tcfg, params, state = jax_model(1, seed=9, n_timesteps=40, n_features=201,
                                          n_output=4)
    spk = ["ABC0", "DEF0", "GHI0", "JKL0"]
    path = str(tmp_path / "spk")
    save_speaker_ckpt(path, writer, params, state, jcfg, spk)
    wav_true, wav_pred = tone(0.9, 180, 1), [tone(0.5, 260, 2), tone(0.3, 320, 3)]
    control = tone(0.6, 240, 4)
    kw = dict(target_spk_id="DEF0", wav_control=control)
    ref = jverify.verify_conversion(wav_true, wav_pred, path, JFeatureConfig(), **kw)
    got = tverify.verify_conversion(wav_true, wav_pred, path, FeatureConfig(), device="cpu", **kw)
    assert set(got) == set(ref) == REPORT_KEYS
    for k in REPORT_KEYS:
        if k.endswith("_top"):
            assert [s for s, _ in got[k]] == [s for s, _ in ref[k]], k
            np.testing.assert_allclose([p for _, p in got[k]], [p for _, p in ref[k]], atol=1e-5)
        elif isinstance(ref[k], float):
            assert got[k] == pytest.approx(ref[k], abs=1e-5), k
        else:
            assert got[k] == ref[k], k
    miss = tverify.verify_conversion(wav_true, wav_true, path, FeatureConfig(), device="cpu",
                                     target_spk_id="nobody")
    assert miss["target_warning"] == jverify.verify_conversion(
        wav_true, wav_true, path, JFeatureConfig(), target_spk_id="nobody")["target_warning"]
    assert "speaker-ID verification" in tverify.format_report(got)
    assert tverify.format_report(got) == jverify.format_report(
        {**got, **{k: [(s, p) for s, p in got[k]] for k in got if k.endswith("_top")}})


def test_load_speaker_model_keeps_the_newest_step(tmp_path):
    jcfg, tcfg, params, state = jax_model(1, seed=2, n_timesteps=40, n_features=201)
    path = str(tmp_path / "spk")
    save_speaker_ckpt(path, "port", params, state, jcfg, list("abcde"))
    first = tverify.load_speaker_model(path, "cpu")
    assert tverify.load_speaker_model(path, "cpu") is first          # cached
    Checkpointer(path, "speaker_id").save({"params": params, "model_state": state}, step=9)
    second = tverify.load_speaker_model(path, "cpu")
    assert second is not first and second[1] == tcfg and second[2] == list("abcde")
    with pytest.raises(FileNotFoundError):
        tverify.load_speaker_model(str(tmp_path / "none"), "cpu")


# -------------------------------------------------------------------- apps ---

DS_CFG = {"sample_rate": 16000, "pre_emphasis": 0.97, "hop_length_ms": 5.0,
          "win_length_ms": 25.0, "n_timesteps": 40, "n_mels": 20, "n_mfcc": 10, "n_fft": None,
          "window": "hann", "mfcc_normaleze_first_mfcc": True, "mfcc_norm_factor": 0.01,
          "calc_mfcc_derivate": True, "M_dB_norm_factor": 0.01, "P_dB_norm_factor": 0.01,
          "mean_abs_amp_norm": 0.003, "clip_output": True, "ds_norm": [0.0, 10.0]}


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_trainer_checkpoints_cross_packages(timit_pair, tmp_path, monkeypatch, bf16):
    """The port's trainer (vocoded augment on, BN recalibration on) writes a
    checkpoint the JAX package's load_speaker_model reads, with the same
    function; the port reads one the JAX trainer wrote."""
    from speech_cloner_tpu.apps import train_speaker_id as japp
    from speech_cloner_tpu_torch.apps import train_speaker_id as tapp

    root = timit_pair[0]
    (tmp_path / "ds.json").write_text(json.dumps(DS_CFG))
    common = ["--ds-path", root, "--ds-cfg", str(tmp_path / "ds.json"), "--batch-size", "4",
              "--max-steps", "2", "--bn-recal", "1"]
    model = tapp.main(common + ["--model-path", str(tmp_path / "port"), "--device", "cpu"]
                      + (["--bf16"] if bf16 else []))
    params, state, cfg, spk = jverify.load_speaker_model(str(tmp_path / "port"))
    assert spk == ["ABC0", "DEF0"] and cfg.n_timesteps == 40 and cfg.n_features == 201
    # the checkpoint holds the trained weights and recalibrated BN statistics;
    # the trainer's model goes on with its moving averages
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(speaker_id_to_jax(model)[0])):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(state), jax.tree.leaves(speaker_id_to_jax(model)[1])))
    x = windows(3, cfg, 1)
    ref, _ = JS.apply(params, state, jnp.asarray(x), cfg=cfg)
    tmodel = tverify.load_speaker_model(str(tmp_path / "port"), "cpu")[0]
    with torch.no_grad():
        assert_tree_close(tmodel(torch.tensor(x)).numpy(), np.asarray(ref), 1e-5, "port ckpt")
    if bf16:
        return
    monkeypatch.setattr(sys, "argv", ["train_speaker_id"])
    with jax.disable_jit():
        japp.main(common + ["--model-path", str(tmp_path / "jax"), "--vocoded-augment", "0"])
    jparams, jstate, jcfg, jspk = jverify.load_speaker_model(str(tmp_path / "jax"))
    tmodel, tcfg, tspk = tverify.load_speaker_model(str(tmp_path / "jax"), "cpu")
    assert tspk == jspk and tcfg.n_output == jcfg.n_output
    ref, _ = JS.apply(jparams, jstate, jnp.asarray(x), cfg=jcfg)
    with torch.no_grad():
        assert_tree_close(tmodel(torch.tensor(x)).numpy(), np.asarray(ref), 1e-5, "jax ckpt")


def test_convert_verify_ckpt_writes_the_report(tmp_path, capsys):
    from test_torch_port_weights import DEC_CFG_D, ENC_CFG_D

    from speech_cloner_tpu_torch.apps import convert as tconvert
    from speech_cloner_tpu_torch.models import decoder as tdec
    from speech_cloner_tpu_torch.models import encoder as tenc
    from speech_cloner_tpu_torch.pipeline.clone import init_trees

    enc_cfg, dec_cfg = tenc.config_from_cfg_d(ENC_CFG_D), tdec.config_from_cfg_d(DEC_CFG_D)
    for name, (p, s) in zip(("encoder", "decoder"), init_trees(enc_cfg, dec_cfg, 0)):
        Checkpointer(str(tmp_path / name), name).save({"params": p, "model_state": s}, step=1)
    for name, d in (("enc.json", ENC_CFG_D), ("dec.json", DEC_CFG_D)):
        (tmp_path / name).write_text(json.dumps(d))
    jcfg, _, params, state = jax_model(1, seed=4, n_timesteps=48, n_features=201, n_output=3)
    save_speaker_ckpt(str(tmp_path / "spk"), "port", params, state, jcfg, ["a", "b", "c"])
    src = str(tmp_path / "in.wav")
    write_riff_wav(src, tone(1.0, 200, 0), 16000)
    tconvert.main(["--input", src, "--output-dir", str(tmp_path / "out"),
                   "--enc-ckpt", str(tmp_path / "encoder"), "--dec-ckpt", str(tmp_path / "decoder"),
                   "--enc-cfg", str(tmp_path / "enc.json"), "--dec-cfg", str(tmp_path / "dec.json"),
                   "--n-iter", "2", "--device", "cpu", "--verify-ckpt", str(tmp_path / "spk"),
                   "--target-spk", "b"])
    report = json.loads((tmp_path / "out" / "in_verify.json").read_text())
    assert set(report) == REPORT_KEYS - {"control_top", "control_match", "cos_pred_control",
                                         "cos_pred_true"}
    assert report["target_spk_id"] == "b" and report["n_windows_pred"] >= 1
    assert os.path.exists(tmp_path / "out" / "in_pred.wav")
    assert "speaker-ID verification" in capsys.readouterr().out
