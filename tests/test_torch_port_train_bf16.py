"""bf16 training of the PyTorch port against the JAX package, on the CPU.

The port's ``compute_dtype=torch.bfloat16`` train steps against the JAX
steps' ``compute_dtype=jnp.bfloat16`` (``_cast_floats`` inside the
differentiated function), from the same weights and batch, dropout 0. The
two packages round to bf16 at different places (JAX's ``lax.scan`` carries
the GRU state in bf16, the port's scan in float32, as the Pallas kernel
does), so port-bf16 is not held to JAX-bf16. Both are held to JAX-float32:
per gradient leaf, the port's relative L2 distance from JAX's float32
gradient is at most BF16_GAP_FACTOR times JAX's own bf16 distance, plus
1e-5 (float32 sums in another order). At this geometry the measured ratio
was at most 1.17 (encoder) and 1.45 (decoder), fused or not. Master
weights, Adam's state and the BN statistics stay float32.

The bf16 plain backward (`gru_scan_backward_plain`, the bf16 backward
kernel's plain version) is held to ``jax.vjp`` of the JAX ``lax.scan`` GRU
in float32 on bf16-rounded inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train import (
    _identity_input_gru,
    dec_cfgs,
    enc_cfgs,
    np_tree,
    randn,
    random_state,
)

from speech_cloner_tpu.models import decoder as jdec
from speech_cloner_tpu.models import encoder as jenc
from speech_cloner_tpu.nn import modules as JM
from speech_cloner_tpu.train import metrics as jmetrics
from speech_cloner_tpu.train import steps as jsteps
from speech_cloner_tpu_torch.nn import modules as TM
from speech_cloner_tpu_torch.ops import cuda_kernels as ck
from speech_cloner_tpu_torch.runtime.jax_params import (
    decoder_from_jax,
    decoder_to_jax,
    encoder_from_jax,
    encoder_to_jax,
)
from speech_cloner_tpu_torch.runtime.tree import tree_leaves
from speech_cloner_tpu_torch.train import steps as tsteps
from speech_cloner_tpu_torch.train.optimizer import OptimizerConfig, make_train_state

torch.set_num_threads(2)
BF16 = torch.bfloat16
BF16_GAP_FACTOR = 2.0
F32_SLACK = 1e-5


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_within_jax_gap(port_bf16, jax_bf16, jax_f32, what):
    leaves = list(zip(jax.tree.leaves(port_bf16), jax.tree.leaves(jax_bf16),
                      jax.tree.leaves(jax_f32)))
    assert jax.tree.structure(port_bf16) == jax.tree.structure(jax_f32), what
    gaps = [(rel_l2(p, f), rel_l2(b, f)) for p, b, f in leaves]
    assert max(j for _, j in gaps) > 1e-4, what         # bf16 rounding happened
    for i, (port, jx) in enumerate(gaps):
        assert port <= BF16_GAP_FACTOR * jx + F32_SLACK, (what, i, port, jx)


def assert_float32_state(model, ts):
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert all(t.dtype == torch.float32 for t in tree_leaves(ts["opt_state"])
               if isinstance(t, torch.Tensor) and t.is_floating_point())


# ----------------------------------------------------- the bf16 backward ---

@pytest.mark.parametrize("fused", [False, True], ids=["one_direction", "fused"])
def test_plain_bf16_backward_matches_jax_vjp(fused):
    """bf16 operands: the plain backward widens dys, ys (its h[t-1]) and the
    weights, keeps float32 inside and rounds dgx, dcx once. JAX: the float32
    vjp of the lax.scan GRU on the same bf16-rounded inputs (its ys not
    rounded). Each element within half a bf16 ulp of the reference (the
    rounding of the output, 2^-8 of |ref|) plus 2^-7 of the peak (h[t-1]
    read from the bf16 ys: half an ulp of every h, carried through the
    steps)."""
    H, B, T = 16, 3, 17
    dirs = ("fw", "bw") if fused else ("fw",)
    params, C = _identity_input_gru(H, dirs, seed=H)
    rb = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    params = jax.tree.map(rb, params)
    x, w = rb(randn((B, T, C), H, 0.7)), rb(randn((B, T, H * len(dirs)), H + 1))
    jfn = (lambda p, xx: JM.gru_apply_fused(p, xx)) if fused else \
        (lambda p, xx: JM._gru_dir_apply(p["fw"], xx))
    _, vjp = jax.vjp(jfn, params, jnp.asarray(x))
    dx = np.asarray(vjp(jnp.asarray(w))[1])

    def split(a, n):
        o = 3 * H * n
        return a[:, :, o:o + 2 * H].transpose(1, 0, 2), a[:, :, o + 2 * H:o + 3 * H].transpose(1, 0, 2)
    gx, cx = (torch.tensor(np.stack(v)).to(BF16) for v in zip(*(split(x, n)
                                                                 for n in range(len(dirs)))))
    Wg = torch.tensor(np.stack([params[d]["gates_kernel"][C:] for d in dirs])).to(BF16)
    Wc = torch.tensor(np.stack([params[d]["candidate_kernel"][C:] for d in dirs])).to(BF16)
    ys, gates = ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)
    assert ys.dtype == BF16 and gates.dtype == torch.float32
    dys = torch.tensor(np.stack([w[:, :, n * H:(n + 1) * H].transpose(1, 0, 2)
                                 for n in range(len(dirs))])).to(BF16)
    dgx, dcx = ck.gru_scan_backward_plain(dys, ys, gates, Wg, Wc)
    assert dgx.dtype == dcx.dtype == BF16
    for n in range(len(dirs)):
        for got, ref in zip((dgx[n], dcx[n]), split(dx, n)):
            err = np.abs(got.float().numpy() - ref)
            assert (err <= 2.0**-8 * np.abs(ref) + 2.0**-7 * np.abs(ref).max()).all(), err.max()


def test_gru_scan_autograd_bf16_gradients_in_operand_dtype():
    """GruScan with bf16 operands on the CPU: every gradient bf16, each the
    float32 GruScan's on the same bf16 values within the bf16 rounding
    (2^-7 of the peak)."""
    g = torch.Generator().manual_seed(0)
    T, B, H = 9, 3, 8
    shapes = [(2, T, B, 2 * H), (2, T, B, H), (2, H, 2 * H), (2, H, H)]
    base = [(0.5 * torch.randn(s, generator=g)).to(BF16) for s in shapes]
    w = torch.randn(2, T, B, H, generator=g)
    grads = {}
    for dt in (BF16, torch.float32):
        args = [t.detach().to(dt).requires_grad_() for t in base]
        (ck.gru_scan_fused(*args).float() * w).sum().backward()
        grads[dt] = [a.grad for a in args]
    for got, ref in zip(grads[BF16], grads[torch.float32]):
        assert got.dtype == BF16
        err = (got.float() - ref).abs().max().item()
        assert err <= 2.0**-7 * ref.abs().max().item(), err


# ---------------------------------------------------------- bf16 steps ---

def _jax_enc_grads(params, state, x, y, cfg, dtype):
    def loss_fn(p):
        logits, _ = jenc.apply(jsteps._cast_floats(p, dtype), state,
                               jsteps._cast_floats(jnp.asarray(x), dtype), cfg=cfg, train=True,
                               rng=jax.random.PRNGKey(0))
        return jmetrics.softmax_xent(logits.astype(jnp.float32), y)
    return np_tree(jax.grad(loss_fn)(params))


@pytest.mark.parametrize("fused", [False, True], ids=["two_scans", "fused"])
def test_encoder_bf16_step_within_jax_gap(fused):
    jcfg, tcfg = enc_cfgs(fused=fused)
    params, state = np_tree(jenc.init(jax.random.PRNGKey(0), jcfg))
    state = random_state(state, 1)
    rng = np.random.default_rng(2)
    x = randn((4, 32, 16), 3)
    y = np.eye(61, dtype=np.float32)[rng.integers(0, 61, (4, 32))]
    ref = _jax_enc_grads(params, state, x, y, jcfg, None)
    jax_bf16 = _jax_enc_grads(params, state, x, y, jcfg, jnp.bfloat16)

    model = encoder_from_jax(params, state, tcfg)
    opt_cfg = OptimizerConfig()
    ts = make_train_state(model, opt_cfg, 1)
    ts2, m = tsteps.encoder_train_step(ts, x, y, model=model, opt_cfg=opt_cfg,
                                       opt=opt_cfg.make(), compute_dtype=BF16)
    assert np.isfinite(float(m["loss"])) and m["loss"].dtype == torch.float32
    assert_within_jax_gap(encoder_to_jax(model, grads=True), jax_bf16, ref, "encoder")
    assert_float32_state(model, ts2)
    # no bf16 pack is left in the modules' caches
    assert all(v[1].dtype == torch.float32 for mod in model.modules()
               if isinstance(mod, TM.Derived) for v in mod._derived.values())


@pytest.mark.parametrize("fused", [False, True], ids=["two_scans", "fused"])
def test_decoder_bf16_step_within_jax_gap(fused):
    """The frozen encoder, the PPG, target_mel and the f_mel scalar cast as
    the JAX step casts them; epoch 300 (the f_mel mix live)."""
    jcfg, tcfg = dec_cfgs(fused=fused)
    je_cfg, te_cfg = enc_cfgs(fused=fused)
    e_params, e_state = np_tree(jenc.init(jax.random.PRNGKey(5), je_cfg))
    e_state = random_state(e_state, 6)
    params, state = np_tree(jdec.init(jax.random.PRNGKey(7), jcfg))
    state = random_state(state, 8)
    mfcc, mel, stft = randn((4, 32, 16), 9), randn((4, 32, 20), 10, 0.1), randn((4, 32, 51), 11, 0.1)
    f_mel = jsteps.f_mel_schedule(jnp.asarray(300, jnp.int32), jcfg.target_mel_step2_val)
    cast = jsteps._cast_floats

    def jax_grads(dt):
        logits, _ = jenc.apply(cast(e_params, dt), e_state, cast(jnp.asarray(mfcc), dt),
                               cfg=je_cfg, train=False)
        ppg = jax.nn.softmax(logits.astype(jnp.float32))

        def loss_fn(p):
            y_mel, y_stft, _ = jdec.apply(cast(p, dt), state, cast(ppg, dt), cfg=jcfg,
                                          train=True, rng=jax.random.PRNGKey(0),
                                          target_mel=cast(jnp.asarray(mel), dt),
                                          f_mel_pred=cast(f_mel, dt))
            return (jmetrics.weighted_mse(y_mel.astype(jnp.float32), mel, 400.0)
                    + jmetrics.weighted_mse(y_stft.astype(jnp.float32), stft, 400.0))
        return np_tree(jax.grad(loss_fn)(params))

    ref, jax_bf16 = jax_grads(None), jax_grads(jnp.bfloat16)
    encoder = encoder_from_jax(e_params, e_state, te_cfg).requires_grad_(False)
    model = decoder_from_jax(params, state, tcfg)
    opt_cfg = OptimizerConfig()
    ts = {**make_train_state(model, opt_cfg, 1), "epoch": np.int32(300)}
    ts2, m = tsteps.decoder_train_step(ts, mfcc, mel, stft, encoder=encoder, model=model,
                                       loss_cfg=tsteps.DecoderLossConfig(), opt_cfg=opt_cfg,
                                       opt=opt_cfg.make(), compute_dtype=BF16)
    np.testing.assert_allclose(m["f_mel_pred"], float(f_mel), rtol=1e-6)    # reported in f32
    assert_within_jax_gap(decoder_to_jax(model, grads=True), jax_bf16, ref, "decoder")
    assert_float32_state(model, ts2)
    assert all(p.grad is None for p in encoder.parameters())


def test_forward_in_casts_inside_the_graph():
    """`forward_in` runs the model on bf16 copies of its parameters: the
    parameters stay float32 leaves and receive float32 gradients, and a
    later float32 forward still sees their (updated) values, not a cached
    bf16 pack."""
    _, tcfg = enc_cfgs(fused=True)
    model = encoder_from_jax(*np_tree(jenc.init(jax.random.PRNGKey(0), enc_cfgs()[0])),
                             dataclasses.replace(tcfg, fused_gru=False))
    x = torch.tensor(randn((2, 32, 16), 1))
    out = tsteps.forward_in(model, BF16, x.to(BF16))
    assert out.dtype == BF16
    out.float().sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        before = model(x)
        for p in model.parameters():
            p.add_(0.01)
        after = model(x)
        assert not torch.equal(before, after)
        assert tsteps.forward_in(model, None, x).equal(after)
