"""Clone-pipeline parity of the PyTorch port against the JAX package, on the CPU.

The JAX pipeline is built from a seed (tests/test_pipeline.py's tiny
geometry); the port gets the same trees through ``runtime/jax_params.py``.
The waveform is compared with the same initial Griffin-Lim phase: the JAX
draw pi*uniform(PRNGKey(seed)) handed to the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_cloner_tpu.models import decoder as jdec
from speech_cloner_tpu.models import encoder as jenc
from speech_cloner_tpu.ops.features import FeatureConfig as JFeatureConfig
from speech_cloner_tpu.pipeline import clone as jclone
from speech_cloner_tpu.pipeline import stitch as jstitch
from speech_cloner_tpu_torch.models import decoder as tdec
from speech_cloner_tpu_torch.models import encoder as tenc
from speech_cloner_tpu_torch.ops.features import FeatureConfig
from speech_cloner_tpu_torch.pipeline import clone as tclone
from speech_cloner_tpu_torch.pipeline import stitch as tstitch
from speech_cloner_tpu_torch.runtime.jax_params import decoder_from_jax, encoder_from_jax

torch.set_num_threads(2)
N_ITER = 4
ENC = jenc.EncoderConfig(n_timesteps=48, input_dim=80, n_output=61,
                         num_conv_banks=2, num_highwaynet_blocks=1)
DEC = jdec.DecoderConfig(n_timesteps=48, input_dim=61,
                         step1=jdec.DecoderStepConfig(32, 2, 1, 80),
                         step2=jdec.DecoderStepConfig(48, 2, 1, 201))
T_ENC = tenc.EncoderConfig(**dataclasses.asdict(ENC))
T_DEC = tdec.DecoderConfig(n_timesteps=48, input_dim=61,
                           step1=tdec.DecoderStepConfig(32, 2, 1, 80),
                           step2=tdec.DecoderStepConfig(48, 2, 1, 201))


@pytest.fixture(scope="module")
def pipes():
    jp = jclone.make_pipeline(ENC, DEC, JFeatureConfig(calc_mfcc_derivate=True), seed=0,
                              n_iter=N_ITER)
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    tp = tclone.ClonePipeline(
        T_ENC, T_DEC, FeatureConfig(calc_mfcc_derivate=True),
        encoder_from_jax(tree(jp.enc_params), tree(jp.enc_state), T_ENC),
        decoder_from_jax(tree(jp.dec_params), tree(jp.dec_state), T_DEC),
        torch.device("cpu"), n_iter=N_ITER)
    return jp, tp


def clip(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    y = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 880 * t)
    return (y + 0.02 * rng.standard_normal(n)).astype(np.float32)


def jax_phase(shape, seed):
    return np.asarray(jnp.pi * jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                                  dtype=jnp.float32))


@pytest.mark.parametrize("K,T", [(1, 8), (2, 8), (3, 8), (5, 12)])
def test_stitch_functions_match(K, T):
    rng = np.random.default_rng(K)
    y0 = rng.standard_normal((K, T, 3)).astype(np.float32)
    y1 = rng.standard_normal((max(K - 1, 0), T, 3)).astype(np.float32)
    if K > 1:
        np.testing.assert_array_equal(tstitch.compound(torch.tensor(y0), torch.tensor(y1)).numpy(),
                                      np.asarray(jstitch.compound(jnp.asarray(y0), jnp.asarray(y1))))
    np.testing.assert_array_equal(tstitch.stitch_single(torch.tensor(y0)).numpy(),
                                  np.asarray(jstitch.stitch_single(jnp.asarray(y0))))
    x = rng.standard_normal((K * T, 2)).astype(np.float32)
    np.testing.assert_array_equal(tstitch.window_stack(torch.tensor(x), T).numpy(),
                                  np.asarray(jstitch.window_stack(jnp.asarray(x), T)))
    np.testing.assert_array_equal(tstitch.shifted_window_stack(torch.tensor(x), T).numpy(),
                                  np.asarray(jstitch.shifted_window_stack(jnp.asarray(x), T)))
    xs = x[: K * T - 3]
    np.testing.assert_array_equal(tstitch.pad_to_multiple(torch.tensor(xs), T).numpy(),
                                  np.asarray(jstitch.pad_to_multiple(jnp.asarray(xs), T)))


@pytest.mark.parametrize("n_samples", [3 * 3840 + 1234, 2000], ids=["4windows", "1window"])
def test_device_predict_matches(pipes, n_samples):
    jp, tp = pipes
    wav = tp.pad_wav(clip(n_samples))
    ref = [np.asarray(a) for a in jp.device_predict(jnp.asarray(wav.numpy()))]
    with torch.inference_mode():
        got = tp.device_predict(wav)
    # float32 both sides through features, 2 models and the stitch; measured
    # gaps are ~1e-8, so 1e-5 leaves room for other BLAS builds
    for name, g, r in zip(("mel", "stft", "ppg"), got, ref):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5, err_msg=name)


def test_convert_waveform_matches_jax(pipes):
    jp, tp = pipes
    wav = clip(3 * 3840 + 500, seed=1)
    ref_wav, ref_mel, ref_stft, ref_ppg = jp.convert(wav, seed=0)
    with torch.inference_mode():
        mel, stft, ppg = tp.device_predict(tp.pad_wav(wav))
        got = tp.device_vocode(stft, init_phase=torch.tensor(jax_phase(tuple(stft.shape), 0)))
    np.testing.assert_allclose(stft.numpy(), ref_stft, atol=1e-5)
    assert got.shape == ref_wav.shape
    # 4 float32 Griffin-Lim rounds from the same phase; peak ~0.2, gap ~2e-7
    np.testing.assert_allclose(got.numpy(), ref_wav, atol=2e-6)


def test_convert_pcm16(pipes):
    jp, tp = pipes
    wav = clip(2 * 3840 + 77, seed=2)
    ref = jp.convert_pcm16(wav, seed=0)
    with torch.inference_mode():
        _, stft, _ = tp.device_predict(tp.pad_wav(wav))
        got = tp.device_vocode_pcm16(stft, init_phase=torch.tensor(jax_phase(tuple(stft.shape), 0)))
    assert got.dtype == torch.int16 and got.shape == ref.shape
    # float32 gaps of ~1e-6 of the peak can move a sample across an integer
    assert np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32)).max() <= 1
    # the host API draws its phase from a seeded generator: same seed, same PCM,
    # and the PCM is the peak-normalized float waveform of convert
    pcm = tp.convert_pcm16(wav, seed=5)
    w = tp.convert(wav, seed=5)[0]
    np.testing.assert_array_equal(pcm, np.clip(w / np.abs(w).max() * 32767.0, -32768.0,
                                               32767.0).astype(np.int16))


@pytest.mark.parametrize("n", [0, 1, 3839, 3840, 3841, 7681])
def test_padding_rule(pipes, n):
    """Whole windows, at least one (the JAX convert's rule)."""
    _, tp = pipes
    spw = 3840
    pad = (-n) % spw
    if n + pad < spw:
        pad = spw - n
    wav = clip(n) if n else np.zeros(0, np.float32)
    padded = tp.pad_wav(wav)
    assert padded.shape == (n + pad,)
    np.testing.assert_array_equal(padded[:n].numpy(), wav)
    assert not padded[n:].any()


def test_make_pipeline_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tclone.make_pipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tclone.make_pipeline(T_ENC, T_DEC, device="cuda")


def test_make_pipeline_seeds_weights():
    a = tclone.make_pipeline(T_ENC, T_DEC, seed=3, device="cpu")
    b = tclone.make_pipeline(T_ENC, T_DEC, seed=3, device="cpu")
    c = tclone.make_pipeline(T_ENC, T_DEC, seed=4, device="cpu")
    sa, sb, sc = (p.decoder.state_dict() for p in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["step1.y_logits.kernel"], sc["step1.y_logits.kernel"])
    assert a.encoder.y_logits.kernel.device.type == "cpu"
