"""Encoder/decoder parity of the PyTorch port against the JAX package, on the CPU.

JAX ``init`` trees (with random BN running statistics) are converted
through ``runtime/jax_params.py`` and both models run the same numpy input.
Small geometry is tests/test_pipeline.py's; one case runs the production
geometry on one 400-frame window.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_cloner_tpu.models import decoder as jdec
from speech_cloner_tpu.models import encoder as jenc
from speech_cloner_tpu_torch.models import decoder as tdec
from speech_cloner_tpu_torch.models import encoder as tenc
from speech_cloner_tpu_torch.runtime.jax_params import decoder_from_jax, encoder_from_jax

torch.set_num_threads(2)
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")

SMALL_ENC = jenc.EncoderConfig(n_timesteps=48, input_dim=80, n_output=61,
                               num_conv_banks=2, num_highwaynet_blocks=1)
SMALL_DEC = jdec.DecoderConfig(n_timesteps=48, input_dim=61,
                               step1=jdec.DecoderStepConfig(32, 2, 1, 80),
                               step2=jdec.DecoderStepConfig(48, 2, 1, 201))


def enc_cfg(j):
    return tenc.EncoderConfig(**dataclasses.asdict(j))


def dec_cfg(j):
    d = dataclasses.asdict(j)
    return tdec.DecoderConfig(**{**d, "step1": tdec.DecoderStepConfig(**d["step1"]),
                                 "step2": tdec.DecoderStepConfig(**d["step2"])})


def random_bn_states(tree, rng):
    """Replace every {mean, var} leaf pair with random running statistics."""
    if isinstance(tree, dict):
        if set(tree) == {"mean", "var"}:
            n = tree["mean"].shape
            return {"mean": (0.2 * rng.standard_normal(n)).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
        return {k: random_bn_states(v, rng) for k, v in tree.items()}
    return tree


def jax_weights(init, cfg, seed):
    params, state = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))
    return params, random_bn_states(state, np.random.default_rng(seed))


def close(got, ref, rel):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=rel * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("geometry", ["small", "production"])
def test_encoder_matches(geometry):
    cfg = SMALL_ENC if geometry == "small" else jenc.EncoderConfig()
    params, state = jax_weights(jenc.init, cfg, 0)
    x = np.random.default_rng(1).uniform(-1, 1, (1 if geometry == "production" else 2,
                                                 cfg.n_timesteps, cfg.input_dim))
    x = x.astype(np.float32)
    logits, _ = jenc.apply(params, state, jnp.asarray(x), cfg=cfg, train=False)
    model = encoder_from_jax(params, state, enc_cfg(cfg))
    with torch.inference_mode():
        got, _ = tenc.apply(model, torch.tensor(x))
        post = tenc.posteriors(got)
    # float32 both sides, sums in another order: 1e-5 of the output scale
    close(got, logits, 1e-5)
    close(post, jenc.posteriors(logits), 1e-5)
    np.testing.assert_array_equal(tenc.predict_classes(got).numpy(),
                                  np.asarray(jenc.predict_classes(logits)))


@pytest.mark.parametrize("geometry", ["small", "production"])
def test_decoder_matches(geometry):
    cfg = SMALL_DEC if geometry == "small" else jdec.DecoderConfig()
    params, state = jax_weights(jdec.init, cfg, 2)
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((1 if geometry == "production" else 2, cfg.n_timesteps, 61))
    ppg = np.asarray(jax.nn.softmax(logits, -1), np.float32)
    y_mel, y_stft, _ = jdec.apply(params, state, jnp.asarray(ppg), cfg=cfg, train=False)
    model = decoder_from_jax(params, state, dec_cfg(cfg))
    with torch.inference_mode():
        mel, stft, _ = tdec.apply(model, torch.tensor(ppg))
    # two CBHG stacks deep; 1e-5 (small) / 2e-5 (4096-channel production
    # banks, longer float32 sums) of the output scale
    rel = 1e-5 if geometry == "small" else 2e-5
    close(mel, y_mel, rel)
    close(stft, y_stft, rel)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_config_from_cfg_d(kind):
    with open(os.path.join(CONFIGS, f"{kind}_cfg_d.json")) as f:
        cfg_d = json.load(f)
    jmod, tmod = (jenc, tenc) if kind == "encoder" else (jdec, tdec)
    assert dataclasses.asdict(tmod.config_from_cfg_d(cfg_d)) == \
        dataclasses.asdict(jmod.config_from_cfg_d(cfg_d))
    # the shipped configs are the production geometry
    default = tmod.EncoderConfig() if kind == "encoder" else tmod.DecoderConfig()
    assert tmod.config_from_cfg_d(cfg_d) == default


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


def test_init_tree_layout_matches_jax():
    """The port's fresh init has the JAX tree's structure and shapes, and its
    constants: GRU gate bias 1, highway transform bias -1, BN 1/0/0/1."""
    g = torch.Generator().manual_seed(0)
    for jmod, tmod, cfg in ((jenc, tenc, SMALL_ENC), (jdec, tdec, SMALL_DEC)):
        jtree = jmod.init(jax.random.PRNGKey(0), cfg)
        ttree = tmod.init_tree(g, enc_cfg(cfg) if tmod is tenc else dec_cfg(cfg))
        ttree = jax.tree.map(lambda t: t.numpy(), ttree)
        assert _shapes(ttree) == _shapes(jtree)
    params, state = tenc.init_tree(g, enc_cfg(SMALL_ENC))
    cb = params["CBHG"]
    assert torch.all(cb["gru"]["fw"]["gates_bias"] == 1.0)
    assert torch.all(cb["gru"]["bw"]["candidate_bias"] == 0.0)
    assert torch.all(cb["highway"][0]["dense2"]["bias"] == -1.0)
    assert torch.all(cb["bn1"]["gamma"] == 1.0) and torch.all(state["CBHG"]["bn1"]["var"] == 1.0)
    k = cb["conv1d_1"]["kernel"]                       # glorot-uniform bound
    assert k.abs().max() <= np.sqrt(6.0 / (3 * k.shape[1] + 3 * k.shape[2]))


def test_from_jax_rejects_wrong_shapes():
    params, state = jax_weights(jenc.init, SMALL_ENC, 0)
    with pytest.raises(ValueError, match="mismatch"):
        encoder_from_jax(params, state, enc_cfg(dataclasses.replace(SMALL_ENC, n_output=40)))
