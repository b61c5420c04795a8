"""Float32 accuracy of the LSTM decoder's train-step gradient, both packages.

    JAX_PLATFORMS=cpu python tests/lstm_grad_gap.py

Runs the decoder train step of ``test_torch_port_lstm.py``
(`test_lstm_decoder_train_step_matches_jax`: the same weights, batch and
epoch) as a plain gradient in float32 and in float64, in the JAX package
(``jax_enable_x64``) and in the port, and prints for each pair the largest
per-leaf max-abs gap over the reference leaf's peak (over max(peak, 1)),
with the leaf. The test's limits come from these gaps: JAX float32 against
JAX float64 and the port's float32 against its float64. Not collected by
pytest (its name does not start with ``test_``).
"""

import os
import sys

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import test_torch_port_lstm as L  # noqa: E402
from test_torch_port_train import np_tree, randn, random_state  # noqa: E402

from speech_cloner_tpu.models import decoder as jdec  # noqa: E402
from speech_cloner_tpu.models import encoder as jenc  # noqa: E402
from speech_cloner_tpu.train import metrics as jmetrics  # noqa: E402
from speech_cloner_tpu.train import steps as jsteps  # noqa: E402
from speech_cloner_tpu_torch.runtime.jax_params import (  # noqa: E402
    decoder_from_jax,
    decoder_to_jax,
    encoder_from_jax,
)
from speech_cloner_tpu_torch.train import steps as tsteps  # noqa: E402
from speech_cloner_tpu_torch.train.optimizer import OptimizerConfig, make_train_state  # noqa: E402

EPOCH = 300


def setup():
    jcfg, tcfg = L.dec_cfgs()
    je_cfg, te_cfg = L.enc_cfgs()
    e_params, e_state = np_tree(jenc.init(jax.random.PRNGKey(5), je_cfg))
    e_state = random_state(e_state, 6)
    params, state = np_tree(jdec.init(jax.random.PRNGKey(7), jcfg))
    state = random_state(state, 8)
    batch = (randn((4, 32, 16), 9), randn((4, 32, 20), 10, 0.1), randn((4, 32, 51), 11, 0.1))
    return jcfg, tcfg, je_cfg, te_cfg, (e_params, e_state, params, state), batch


def jax_grads(dt, jcfg, je_cfg, trees, batch):
    ep, es, p, s = (jax.tree.map(lambda a: np.asarray(a, dt), t) for t in trees)
    mfcc, mel, stft = (jnp.asarray(a, dt) for a in batch)
    logits, _ = jenc.apply(ep, es, mfcc, cfg=je_cfg, train=False)
    ppg = jax.nn.softmax(logits)
    f_mel = jsteps.f_mel_schedule(jnp.asarray(EPOCH, jnp.int32), jcfg.target_mel_step2_val)

    def loss_fn(pp):
        y_mel, y_stft, _ = jdec.apply(pp, s, ppg, cfg=jcfg, train=True, rng=jax.random.PRNGKey(0),
                                      target_mel=mel, f_mel_pred=f_mel)
        return jmetrics.weighted_mse(y_mel, mel, 400.0) + jmetrics.weighted_mse(y_stft, stft, 400.0)
    return np_tree(jax.grad(loss_fn)(p))


def port_grads(dtype, tcfg, te_cfg, trees, batch):
    ep, es, p, s = trees
    encoder = encoder_from_jax(ep, es, te_cfg).to(dtype)
    model = decoder_from_jax(p, s, tcfg).to(dtype)
    opt_cfg = OptimizerConfig()
    ts = {**make_train_state(model, opt_cfg, 1), "epoch": np.int32(EPOCH)}
    tsteps.decoder_train_step(ts, *batch, encoder=encoder, model=model,
                              loss_cfg=tsteps.DecoderLossConfig(), opt_cfg=opt_cfg,
                              opt=opt_cfg.make())
    return decoder_to_jax(model, grads=True)


def worst(got, ref):
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    gaps = [(float(np.abs(np.asarray(g, np.float64) - np.asarray(r, np.float64)).max()
                   / max(np.abs(np.asarray(r)).max(), 1.0)), path)
            for path, g, r in zip(paths, jax.tree.leaves(got), jax.tree.leaves(ref))]
    return max(gaps)


def main():
    torch.set_num_threads(2)
    jcfg, tcfg, je_cfg, te_cfg, trees, batch = setup()
    j32, j64 = (jax_grads(dt, jcfg, je_cfg, trees, batch) for dt in (np.float32, np.float64))
    p32, p64 = (port_grads(dt, tcfg, te_cfg, trees, batch)
                for dt in (torch.float32, torch.float64))
    for name, got, ref in (("jax float32 vs jax float64", j32, j64),
                           ("port float32 vs port float64", p32, p64),
                           ("port float32 vs jax float32", p32, j32)):
        gap, path = worst(got, ref)
        print(f"{name}: {gap:.3e} of the peak at {path}")


if __name__ == "__main__":
    main()
