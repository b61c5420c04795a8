"""Training of the PyTorch port against the JAX package, on the CPU.

The GRU scan's gradient (`GruScan` with `gru_scan_backward_plain`, the
backward kernel's plain version) and the both-directions scan against
``jax.vjp`` of the JAX modules; one encoder and one decoder train step with
dropout 0 against the JAX steps (loss, gradients as JAX trees, new BN
state); Adam against optax on JAX's own gradients; BN train mode, dropout,
recalibration, the metrics and the schedules; train-state checkpoints
across the two packages. Inputs and weights come from numpy and JAX
``init`` trees. float32 on both sides: the limits are float32 sums in
another order (1e-5 of each output's or leaf's peak, 1e-6 for BN state).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_cloner_tpu.models import decoder as jdec
from speech_cloner_tpu.models import encoder as jenc
from speech_cloner_tpu.nn import modules as JM
from speech_cloner_tpu.runtime.checkpoint import Checkpointer as JCheckpointer
from speech_cloner_tpu.train import metrics as jmetrics
from speech_cloner_tpu.train import steps as jsteps
from speech_cloner_tpu.train.optimizer import OptimizerConfig as JOptimizerConfig
from speech_cloner_tpu.train.optimizer import make_train_state as j_make_train_state
from speech_cloner_tpu_torch.models import decoder as tdec
from speech_cloner_tpu_torch.models import encoder as tenc
from speech_cloner_tpu_torch.nn import modules as TM
from speech_cloner_tpu_torch.ops import cuda_kernels as ck
from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer
from speech_cloner_tpu_torch.runtime.jax_params import (
    decoder_from_jax,
    decoder_to_jax,
    encoder_from_jax,
    encoder_to_jax,
)
from speech_cloner_tpu_torch.train import metrics as tmetrics
from speech_cloner_tpu_torch.train import steps as tsteps
from speech_cloner_tpu_torch.train.bn_recal import collect_bn_state, load_state_tree, make_bn_stat_fn
from speech_cloner_tpu_torch.train.optimizer import OptimizerConfig, make_train_state

torch.set_num_threads(2)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def assert_tree_close(got, ref, rel, what=""):
    """Every leaf within ``rel`` of its reference's peak (absolute when the
    peak is below 1)."""
    g_leaves, r_leaves = jax.tree.leaves(got), jax.tree.leaves(ref)
    assert jax.tree.structure(got) == jax.tree.structure(ref), what
    for i, (g, r) in enumerate(zip(g_leaves, r_leaves)):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape, (what, i)
        err = np.abs(g - r).max() if r.size else 0.0
        assert err <= rel * max(np.abs(r).max(), 1e-30), (what, i, err, np.abs(r).max())


def enc_cfgs(fused=False, dropout=0.0):
    j = jenc.EncoderConfig(n_timesteps=32, input_dim=16, n_output=61, num_conv_banks=3,
                           num_highwaynet_blocks=1, dropout_rate=dropout, fused_gru=fused)
    return j, tenc.EncoderConfig(**dataclasses.asdict(j))


def dec_cfgs(fused=False, dropout=0.0):
    j = jdec.DecoderConfig(n_timesteps=32, input_dim=61,
                           step1=jdec.DecoderStepConfig(32, 3, 1, 20, fused_gru=fused),
                           step2=jdec.DecoderStepConfig(48, 3, 1, 51, fused_gru=fused),
                           dropout_rate=dropout, use_target_mel_step2=True,
                           target_mel_step2_val=500.0)
    d = dataclasses.asdict(j)
    t = tdec.DecoderConfig(**{**d, "step1": tdec.DecoderStepConfig(**d["step1"]),
                              "step2": tdec.DecoderStepConfig(**d["step2"])})
    return j, t


def random_state(tree, seed):
    """Random BN running statistics so eval and the moving averages do work."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if set(t) == {"mean", "var"}:
            n = t["mean"].shape
            return {"mean": (0.2 * rng.standard_normal(n)).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
        return {k: walk(v) for k, v in t.items()}
    return walk(tree)


# ------------------------------------------------------- the scan gradient ---

def _identity_input_gru(H, dirs, seed):
    """A JAX GRU tree whose input projections copy slices of x (x = [gx, cx]
    per direction, biases 0), so d x is exactly (dgx, dcx)."""
    C = 3 * H * len(dirs)
    tree = {}
    for n, d in enumerate(dirs):
        p = np_tree(JM.gru_dir_init(jax.random.PRNGKey(seed + n), C, H))
        gk, cknl = np.zeros((C + H, 2 * H), np.float32), np.zeros((C + H, H), np.float32)
        o = 3 * H * n
        gk[o:o + 2 * H] = np.eye(2 * H)
        cknl[o + 2 * H:o + 3 * H] = np.eye(H)
        gk[C:], cknl[C:] = p["gates_kernel"][C:], p["candidate_kernel"][C:]
        tree[d] = {"gates_kernel": gk, "gates_bias": np.zeros(2 * H, np.float32),
                   "candidate_kernel": cknl, "candidate_bias": np.zeros(H, np.float32)}
    return tree, C


@pytest.mark.parametrize("fused", [False, True], ids=["one_direction", "fused"])
@pytest.mark.parametrize("H", [8, 40])
def test_scan_backward_matches_jax_vjp(fused, H):
    """dgx, dcx (through x), dWg_h and dWc_h of the port's scan against
    jax.vjp of `_gru_dir_apply` / `gru_apply_fused`: GruScan's plain forward
    and `gru_scan_backward_plain` on the CPU, and the plain function alone."""
    B, T = 3, 17
    dirs = ("fw", "bw") if fused else ("fw",)
    params, C = _identity_input_gru(H, dirs, seed=H)
    x = randn((B, T, C), H, 0.7)
    w = randn((B, T, H * len(dirs)), H + 1)
    jfn = (lambda p, xx: JM.gru_apply_fused(p, xx)) if fused else \
        (lambda p, xx: JM._gru_dir_apply(p["fw"], xx))
    y_ref, vjp = jax.vjp(jfn, params, jnp.asarray(x))
    dparams, dx = (np_tree(g) for g in vjp(jnp.asarray(w)))

    tparams = {d: {k: torch.tensor(v, requires_grad=True) for k, v in params[d].items()}
               for d in dirs}
    tx = torch.tensor(x, requires_grad=True)
    y = TM.gru_apply_fused(tparams, tx) if fused else ck.gru_dir_apply(tparams["fw"], tx)
    (y * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=1e-5)
    assert_tree_close(tx.grad.numpy(), dx, 1e-5, "dx = (dgx, dcx)")
    for d in dirs:
        for k in ("gates_kernel", "candidate_kernel"):    # rows C: are dWg_h, dWc_h
            assert_tree_close(tparams[d][k].grad.numpy()[C:], dparams[d][k][C:], 1e-5, (d, k))

    # the plain backward alone: direction-stacked, bw in its time order
    def split(a, n):       # x-layout [B, T, .] of direction n -> [T, B, .]
        o = 3 * H * n
        return a[:, :, o:o + 2 * H].transpose(1, 0, 2), a[:, :, o + 2 * H:o + 3 * H].transpose(1, 0, 2)
    gx, cx = zip(*(split(x, n) for n in range(len(dirs))))
    Wg = torch.tensor(np.stack([params[d]["gates_kernel"][C:] for d in dirs]))
    Wc = torch.tensor(np.stack([params[d]["candidate_kernel"][C:] for d in dirs]))
    ys, gates = ck.gru_scan_fused_plain(torch.tensor(np.stack(gx)), torch.tensor(np.stack(cx)),
                                        Wg, Wc, with_gates=True)
    dys = torch.tensor(np.stack([w[:, :, n * H:(n + 1) * H].transpose(1, 0, 2)
                                 for n in range(len(dirs))]))
    dgx, dcx = ck.gru_scan_backward_plain(dys, ys, gates, Wg, Wc)
    for n in range(len(dirs)):
        ref_dgx, ref_dcx = split(dx, n)
        assert_tree_close(dgx[n].numpy(), ref_dgx, 1e-5, "dgx")
        assert_tree_close(dcx[n].numpy(), ref_dcx, 1e-5, "dcx")


def test_fused_plain_is_two_directions():
    T, B, H = 11, 2, 6
    ops = [torch.tensor(randn(s, i, 0.5)) for i, s in enumerate(
        [(2, T, B, 2 * H), (2, T, B, H), (2, H, 2 * H), (2, H, H)])]
    got = ck.gru_scan_fused_plain(*ops)
    fw = ck.gru_scan_plain(ops[0][0], ops[1][0], ops[2][0], ops[3][0])
    bw = ck.gru_scan_plain(ops[0][1].flip(0), ops[1][1].flip(0), ops[2][1], ops[3][1]).flip(0)
    torch.testing.assert_close(got, torch.stack([fw, bw]), rtol=0, atol=1e-6)
    before = dict(ck.launch_counts)
    torch.testing.assert_close(ck.gru_scan_fused(*ops), got, rtol=0, atol=0)
    assert ck.launch_counts == before             # the CPU path launches no kernel


# ------------------------------------------------------ models, eval, fused ---

@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_fused_gru_models_match_jax_eval(kind):
    if kind == "encoder":
        jcfg, tcfg = enc_cfgs(fused=True)
        params, state = np_tree(jenc.init(jax.random.PRNGKey(0), jcfg))
        state = random_state(state, 1)
        x = randn((2, 32, 16), 2)
        ref, _ = jenc.apply(params, state, jnp.asarray(x), cfg=jcfg, train=False)
        with torch.inference_mode():
            got, _ = tenc.apply(encoder_from_jax(params, state, tcfg), torch.tensor(x))
        assert_tree_close(got.numpy(), ref, 1e-5)
    else:
        jcfg, tcfg = dec_cfgs(fused=True)
        params, state = np_tree(jdec.init(jax.random.PRNGKey(3), jcfg))
        state = random_state(state, 4)
        ppg = np.asarray(jax.nn.softmax(randn((2, 32, 61), 5), -1))
        ref = jdec.apply(params, state, jnp.asarray(ppg), cfg=jcfg, train=False)
        with torch.inference_mode():
            got = tdec.apply(decoder_from_jax(params, state, tcfg), torch.tensor(ppg))
        for g, r in zip(got[:2], ref[:2]):
            assert_tree_close(g.numpy(), r, 1e-5)


# -------------------------------------------------------------- BN, dropout ---

@pytest.mark.parametrize("momentum", [None, 0.0])
def test_bn_train_mode_matches_jax(momentum):
    params = {"gamma": randn(8, 1) + 1.0, "beta": randn(8, 2)}
    state = random_state({"s": {"mean": np.zeros(8), "var": np.ones(8)}}, 3)["s"]
    x = randn((3, 10, 8), 4, 2.0) + 1.0
    ref, ref_state = JM.bn_apply(params, state, jnp.asarray(x), train=True, momentum=momentum)
    bn = TM.BatchNorm(params, state)
    got = bn(torch.tensor(x), train=True, momentum=momentum)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)
    assert_tree_close(jax.tree.map(lambda t: t.numpy(), bn.state_tree()), np_tree(ref_state), 1e-6)
    mean, var = TM.bn_batch_moments(torch.tensor(x))     # population variance
    np.testing.assert_allclose(var.numpy(), x.reshape(-1, 8).var(axis=0), rtol=1e-5)


def test_dropout_keep_share_and_scale():
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(0)
    y = TM.dropout(x, 0.4, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.6) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.6))
    assert TM.dropout(x, 0.0, g) is x
    # the same generator state draws the same mask; the prenet applies it in train mode only
    p = np_tree(JM.prenet_init(jax.random.PRNGKey(1), 10, 16))
    pre = TM.Prenet(p)
    h = torch.tensor(randn((4, 7, 10), 6))
    a = pre(h, 0.5, True, torch.Generator().manual_seed(3))
    b = pre(h, 0.5, True, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(pre(h, 0.5, False), pre(h))
    assert (a == 0).any() and not (pre(h) == 0).all()


# -------------------------------------------------------------- train steps ---

def _jax_enc_grads(params, state, x, y, cfg):
    def loss_fn(p):
        logits, new_state = jenc.apply(p, state, x, cfg=cfg, train=True,
                                       rng=jax.random.PRNGKey(0))
        return jmetrics.softmax_xent(logits.astype(jnp.float32), y), new_state
    (loss, new_state), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return float(loss), np_tree(grads), np_tree(new_state)


@pytest.mark.parametrize("fused", [False, True], ids=["two_scans", "fused"])
def test_encoder_train_step_matches_jax(fused):
    jcfg, tcfg = enc_cfgs(fused=fused)
    params, state = np_tree(jenc.init(jax.random.PRNGKey(0), jcfg))
    state = random_state(state, 1)
    rng = np.random.default_rng(2)
    x = randn((4, 32, 16), 3)
    y = np.eye(61, dtype=np.float32)[rng.integers(0, 61, (4, 32))]
    loss_ref, grads_ref, state_ref = _jax_enc_grads(params, state, jnp.asarray(x),
                                                   jnp.asarray(y), jcfg)

    model = encoder_from_jax(params, state, tcfg)
    opt_cfg = OptimizerConfig()
    ts = make_train_state(model, opt_cfg, 1)
    ts2, m = tsteps.encoder_train_step(ts, x, y, model=model, opt_cfg=opt_cfg,
                                       opt=opt_cfg.make())
    np.testing.assert_allclose(float(m["loss"]), loss_ref, rtol=1e-5)
    assert_tree_close(encoder_to_jax(model, grads=True), grads_ref, 1e-5, "grads")
    assert_tree_close(encoder_to_jax(model)[1], state_ref, 1e-6, "bn state")
    assert int(ts2["step"]) == 1 and not np.array_equal(ts2["rng"], ts["rng"])
    for name in ("acc", "mse"):
        assert np.isfinite(float(m[name]))


@pytest.mark.parametrize("fused", [False, True], ids=["two_scans", "fused"])
def test_decoder_train_step_matches_jax(fused):
    """Epoch 300: the f_mel mix of y_mel and target_mel is live (f ~ 0.55)."""
    jcfg, tcfg = dec_cfgs(fused=fused)
    je_cfg, te_cfg = enc_cfgs(fused=fused)
    e_params, e_state = np_tree(jenc.init(jax.random.PRNGKey(5), je_cfg))
    e_state = random_state(e_state, 6)
    params, state = np_tree(jdec.init(jax.random.PRNGKey(7), jcfg))
    state = random_state(state, 8)
    mfcc, mel, stft = randn((4, 32, 16), 9), randn((4, 32, 20), 10, 0.1), randn((4, 32, 51), 11, 0.1)
    epoch = 300
    loss_cfg = jsteps.DecoderLossConfig()

    enc_logits, _ = jenc.apply(e_params, e_state, jnp.asarray(mfcc), cfg=je_cfg, train=False)
    ppg = jax.nn.softmax(enc_logits.astype(jnp.float32))
    f_mel = jsteps.f_mel_schedule(jnp.asarray(epoch, jnp.int32), jcfg.target_mel_step2_val)

    def loss_fn(p):
        y_mel, y_stft, new_state = jdec.apply(p, state, ppg, cfg=jcfg, train=True,
                                              rng=jax.random.PRNGKey(0),
                                              target_mel=jnp.asarray(mel), f_mel_pred=f_mel)
        loss = (jmetrics.weighted_mse(y_mel, mel, loss_cfg.mel_loss_weight)
                + jmetrics.weighted_mse(y_stft, stft, loss_cfg.stft_loss_weight))
        return loss, new_state
    (loss_ref, state_ref), grads_ref = jax.value_and_grad(loss_fn, has_aux=True)(params)

    def port_step(dtype):
        encoder = encoder_from_jax(e_params, e_state, te_cfg).to(dtype)
        model = decoder_from_jax(params, state, tcfg).to(dtype)
        opt_cfg = OptimizerConfig()
        ts = {**make_train_state(model, opt_cfg, 1), "epoch": np.int32(epoch)}
        _, m = tsteps.decoder_train_step(ts, mfcc, mel, stft, encoder=encoder, model=model,
                                         loss_cfg=tsteps.DecoderLossConfig(), opt_cfg=opt_cfg,
                                         opt=opt_cfg.make())
        return encoder, model, m

    encoder, model, m = port_step(torch.float32)
    assert 0.5 < m["f_mel_pred"] < 0.6
    np.testing.assert_allclose(m["f_mel_pred"], float(f_mel), rtol=1e-6)
    np.testing.assert_allclose(float(m["loss"]), float(loss_ref), rtol=1e-5)
    assert_tree_close(decoder_to_jax(model)[1], np_tree(state_ref), 1e-6, "bn state")
    # Two CBHG stacks under a loss weight of 400: JAX's own float32 gradient
    # is up to 1.2e-5 of a leaf's peak from the float64 one at this geometry,
    # the port's float32 one 0.9e-5. So the port is held to its float64
    # gradient at 1e-5 and to JAX's float32 one at 2e-5 (their two errors).
    grads = decoder_to_jax(model, grads=True)
    assert_tree_close(grads, np_tree(grads_ref), 2e-5, "grads against JAX")
    assert_tree_close(grads, decoder_to_jax(port_step(torch.float64)[1], grads=True), 1e-5,
                      "grads against float64")
    assert all(not p.requires_grad for p in encoder.parameters()) or all(
        p.grad is None for p in encoder.parameters())          # the encoder stays frozen


def test_every_parameter_trains_and_bank_zero_taps_stay_zero():
    jcfg, tcfg = enc_cfgs()
    model = tenc.init(torch.Generator().manual_seed(0), tcfg)
    opt_cfg = OptimizerConfig(learning_rate=1e-2)
    ts = make_train_state(model, opt_cfg, 1)
    x, y = randn((4, 32, 16), 1), np.eye(61, dtype=np.float32)[np.arange(128).reshape(4, 32) % 61]
    before = jax.tree.map(lambda t: t.detach().clone(), model.params_tree())
    ts, _ = tsteps.encoder_train_step(ts, x, y, model=model, opt_cfg=opt_cfg, opt=opt_cfg.make())
    grads = jax.tree.leaves(encoder_to_jax(model, grads=True))
    assert grads and all(np.abs(g).max() > 0 for g in grads)
    assert all(not torch.equal(a, b) for a, b in zip(jax.tree.leaves(before),
                                                    jax.tree.leaves(model.params_tree())))
    K = tcfg.num_conv_banks
    packed = model.cbhg.banks.packed()                        # [K*c, in, K] after the step
    for k in range(1, K + 1):
        off = (K - 1) // 2 - (k - 1) // 2
        taps = packed[(k - 1) * 128:k * 128]
        assert not taps[..., :off].any() and not taps[..., off + k:].any()
    # the eval path sees the updated weights: packs and views follow the parameters
    assert torch.equal(model.cbhg.gru.packed_fw, ck.pack_gru_weights(
        model.cbhg.gru.dirs["fw"]["gates_kernel"].detach()[-tcfg.embed // 2:],
        model.cbhg.gru.dirs["fw"]["candidate_kernel"].detach()[-tcfg.embed // 2:]))


def test_derived_weights_follow_parameter_changes():
    """A pack made for the eval path is remade after any in-place change of
    its parameter (an optimizer step, a load) and after .to()."""
    _, tcfg = enc_cfgs()
    model = tenc.init(torch.Generator().manual_seed(1), tcfg)
    banks, conv = model.cbhg.banks, model.cbhg.conv1d_1
    with torch.no_grad():                          # the eval path: nothing records
        w0, c0 = banks.packed(), conv.weight()
        assert banks.packed() is w0 and conv.weight() is c0     # cached while unchanged
        banks.kernels[0].add_(1.0)
        conv.kernel.mul_(2.0)
        assert not torch.equal(banks.packed(), w0)
        torch.testing.assert_close(conv.weight(), 2 * c0)
        assert model.to(torch.float64).cbhg.conv1d_1.weight().dtype == torch.float64
    assert banks.packed().requires_grad            # while autograd records: made fresh


# ------------------------------------------------------------------- Adam ---

def test_adam_matches_optax_on_jax_grads():
    jcfg, tcfg = enc_cfgs()
    params, state = np_tree(jenc.init(jax.random.PRNGKey(0), jcfg))
    x = jnp.asarray(randn((4, 32, 16), 3))
    y = jnp.asarray(np.eye(61, dtype=np.float32)[np.arange(128).reshape(4, 32) % 61])
    _, grads, _ = _jax_enc_grads(params, state, x, y, jcfg)
    jopt_cfg = JOptimizerConfig()
    jopt = jopt_cfg.make()
    opt_state = jopt.init(params)
    model = encoder_from_jax(params, state, tcfg)
    opt_cfg = OptimizerConfig()
    opt = opt_cfg.make()
    ts = make_train_state(model, opt_cfg, 0)
    ts["opt_state"] = opt.init(ts["params"])
    tgrads = jax.tree.map(torch.tensor, grads)
    for i in range(3):                                  # bias correction over three counts
        ups, opt_state = jopt.update(jax.tree.map(lambda g: g * (i + 1), grads), opt_state)
        tups, ts["opt_state"] = opt.update(jax.tree.map(lambda g: g * (i + 1), tgrads),
                                           ts["opt_state"])
        assert_tree_close(jax.tree.map(lambda t: t.numpy(), tups), np_tree(ups), 1e-5, i)
    assert int(ts["opt_state"][0]) == int(opt_state.count) == 3
    assert_tree_close(jax.tree.map(lambda t: t.numpy(), ts["opt_state"][1]),
                      np_tree(opt_state.mu), 1e-6)
    np.testing.assert_allclose(opt_cfg.lr_at(7), float(jopt_cfg.lr_at(jnp.float32(7))), rtol=1e-7)


def test_schedules_and_metrics_match_jax():
    for epoch in (0, 100, 500, 5000):
        np.testing.assert_allclose(
            tsteps.f_mel_schedule(epoch, 500.0),
            float(jsteps.f_mel_schedule(jnp.asarray(epoch, jnp.int32), 500.0)), rtol=1e-6)
    logits, probs = randn((3, 9, 7), 1), np.asarray(jax.nn.softmax(randn((3, 9, 7), 2)))
    tl, tp = torch.tensor(logits), torch.tensor(probs)
    for name in ("softmax_xent", "frame_accuracy", "probs_mse"):
        np.testing.assert_allclose(float(getattr(tmetrics, name)(tl, tp)),
                                   float(getattr(jmetrics, name)(logits, probs)), rtol=1e-5)
    np.testing.assert_array_equal(tmetrics.confusion_matrix(tl, tp, 7).numpy(),
                                  np.asarray(jmetrics.confusion_matrix(logits, probs, 7)))
    np.testing.assert_allclose(float(tmetrics.weighted_mse(tl, tp, 400.0)),
                               float(jmetrics.weighted_mse(logits, probs, 400.0)), rtol=1e-5)
    a, b = np.abs(randn((2, 20, 80), 3)), np.abs(randn((2, 20, 80), 4))
    np.testing.assert_allclose(float(tmetrics.mel_cepstral_distortion(torch.tensor(a), torch.tensor(b))),
                               float(jmetrics.mel_cepstral_distortion(a, b)), rtol=1e-5)


def test_bn_recalibration_collects_true_batch_stats():
    _, tcfg = enc_cfgs()
    model = tenc.init(torch.Generator().manual_seed(2), tcfg)
    batches = [(randn((4, 32, 16), 10 + i, i + 1.0),) for i in range(3)]
    stat_fn = make_bn_stat_fn(lambda x, bn_momentum: tenc.apply(
        model, torch.tensor(x), train=True, bn_momentum=bn_momentum)[1])
    per_batch = [jax.tree.map(lambda t: t.numpy(), stat_fn(*b)) for b in batches]
    avg = collect_bn_state(stat_fn, iter(batches), max_batches=3)
    load_state_tree(model, avg)
    want = jax.tree.map(lambda *a: np.mean(a, axis=0), *per_batch)
    assert_tree_close(encoder_to_jax(model)[1], want, 1e-6)
    # momentum 0: the first BN's statistics are the batch's own
    bn1 = per_batch[0]["CBHG"]["banks"]["bn"]
    assert bn1["var"].min() > 0 and not np.allclose(bn1["mean"], 0)


# ------------------------------------------------------------ checkpoints ---

def test_train_state_checkpoints_cross_packages(tmp_path):
    """A train state the port saves restores with JAX Checkpointer.restore_into
    into a JAX train state, and a JAX one into the port's (tensors in place)."""
    jcfg, tcfg = enc_cfgs()
    params, state = np_tree(jenc.init(jax.random.PRNGKey(0), jcfg))
    model = encoder_from_jax(params, state, tcfg)
    opt_cfg = OptimizerConfig()
    ts = make_train_state(model, opt_cfg, 5)
    x, y = randn((4, 32, 16), 1), np.eye(61, dtype=np.float32)[np.arange(128).reshape(4, 32) % 61]
    ts, _ = tsteps.encoder_train_step(ts, x, y, model=model, opt_cfg=opt_cfg, opt=opt_cfg.make())
    Checkpointer(str(tmp_path / "port"), "encoder").save(ts, step=1)

    jts = j_make_train_state(*jenc.init(jax.random.PRNGKey(9), jcfg), JOptimizerConfig(),
                             jax.random.PRNGKey(1))
    restored, step = JCheckpointer(str(tmp_path / "port"), "encoder").restore_into(jts)
    assert step == 1 and int(restored["step"]) == 1
    assert_tree_close(np_tree(restored["params"]), encoder_to_jax(model)[0], 0.0)
    assert int(restored["opt_state"].count) == 1
    np.testing.assert_array_equal(np.asarray(restored["rng"]), ts["rng"])

    # the JAX state (other weights, step 7) into the port's template, in place
    jts = {**jts, "step": jnp.asarray(7, jnp.int32), "epoch": jnp.asarray(2, jnp.int32)}
    JCheckpointer(str(tmp_path / "jax"), "encoder").save(jts, step=7, sync=True)
    got, step = Checkpointer(str(tmp_path / "jax"), "encoder").restore_into(ts)
    assert step == 7 and int(got["step"]) == 7 and int(got["epoch"]) == 2
    assert got["params"]["y_logits"]["kernel"] is model.y_logits.kernel
    assert_tree_close(encoder_to_jax(model)[0], np_tree(jts["params"]), 0.0)
    assert_tree_close(jax.tree.map(lambda t: t.numpy(), got["opt_state"][2]),
                      np_tree(jts["opt_state"].nu), 0.0)


# ------------------------------------------------------- the CPU bf16 conv ---

def test_cpu_bf16_conv_of_the_step2_projection():
    """The decoder's step-2 projection at full width ([3, 4096, 402] by
    [256, 4096, 3]) in bf16 on the CPU with 2 threads, where oneDNN's bf16
    convolution came out wrong: within bf16 rounding of the float32 result."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        g = torch.Generator().manual_seed(0)
        x = torch.rand((3, 402, 4096), generator=g)
        w = (torch.rand((256, 4096, 3), generator=g) - 0.5) * 0.05
        ref = TM.conv1d(x, w)
        got = TM.conv1d(x.bfloat16(), w.bfloat16())
    finally:
        torch.set_num_threads(threads)
    assert got.dtype == torch.bfloat16
    peak = ref.abs().max().item()
    # bf16 operands (2^-9 relative each) summed over 12288 terms, then rounded
    assert (got.float() - ref).abs().max().item() <= 2e-2 * peak
