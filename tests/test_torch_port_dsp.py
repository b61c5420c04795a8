"""DSP parity of the PyTorch port against the JAX package, on the CPU.

Same inputs (numpy, from a seed) go through the JAX function (``xp=np`` and
``xp=jnp`` where it takes one) and its port counterpart. Both sides are
float32; tolerances are stated per test with their reason.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_cloner_tpu import ops as J
from speech_cloner_tpu.ops import mel as Jmel
from speech_cloner_tpu.ops import windows as Jwin
from speech_cloner_tpu.ops.features import FeatureConfig as JFeatureConfig
from speech_cloner_tpu_torch import ops as T
from speech_cloner_tpu_torch.ops import mel as Tmel
from speech_cloner_tpu_torch.ops import windows as Twin
from speech_cloner_tpu_torch.ops.features import FeatureConfig

torch.set_num_threads(2)
TP = sys.modules["speech_cloner_tpu_torch.ops.preemphasis"]
TGL = sys.modules["speech_cloner_tpu_torch.ops.griffin_lim"]


def _signal(n=8000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    y = np.sin(2 * np.pi * 313 * t) + 0.3 * np.sin(2 * np.pi * 1777 * t)
    return (y + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_windows_match():
    for n in (1, 7, 400, 401):
        np.testing.assert_array_equal(Twin.hann_periodic(n), Jwin.hann_periodic(n, xp=np))
        np.testing.assert_array_equal(Twin.get_window("hamming", n),
                                      Jwin.get_window("hamming", n, xp=np))
    w = Jwin.hann_periodic(300, xp=np)
    np.testing.assert_array_equal(Twin.pad_center(w, 400), Jwin.pad_center(w, 400, xp=np))
    with pytest.raises(ValueError):
        Twin.get_window("kaiser", 10)


def test_mel_and_dct_match():
    # the same float64 numpy arithmetic on both sides: exact
    np.testing.assert_array_equal(Tmel.mel_filterbank(16000, 400, 80),
                                  Jmel.mel_filterbank(16000, 400, 80))
    np.testing.assert_array_equal(Tmel.mel_filterbank(22050, 512, 40, fmin=50.0, htk=True),
                                  Jmel.mel_filterbank(22050, 512, 40, fmin=50.0, htk=True))
    np.testing.assert_array_equal(Tmel.dct_basis(40, 80), Jmel.dct_basis(40, 80))


def test_db_conversions_match():
    rng = np.random.default_rng(1)
    P = (rng.random((50, 201)) ** 8 * 10.0).astype(np.float32)
    P[0, :5] = 0.0                          # exercise amin
    # float32 log10 on both sides. torch's CPU log10 has come out up to
    # 10 ulp (7.6e-5 dB at 70 dB) off numpy's in one full parallel test run,
    # so 2e-6 relative; a wrong amin, ref or top_db is off by far more
    np.testing.assert_allclose(T.power_to_db(torch.tensor(P)).numpy(),
                               J.power_to_db(P, xp=np), rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(T.amplitude_to_db(torch.tensor(P)).numpy(),
                               J.amplitude_to_db(P, xp=np), rtol=2e-6, atol=1e-5)
    # the top_db floor sits 80 dB under the global max
    got = T.power_to_db(torch.tensor(P)).numpy()
    assert abs(got.min() - (got.max() - 80.0)) < 1e-4
    dB = (rng.random((20, 7)) * 100 - 80).astype(np.float32)
    np.testing.assert_allclose(T.db_to_power(torch.tensor(dB)).numpy(),
                               J.db_to_power(dB, xp=np), rtol=1e-6)


@pytest.mark.parametrize("n", [1, 7, 1024, 1025, 5000])
def test_preemphasis_and_inverse(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    fwd = T.preemphasis(torch.tensor(x), 0.97).numpy()
    np.testing.assert_allclose(fwd, J.preemphasis(x, 0.97, xp=np), atol=1e-7)
    inv = T.inv_preemphasis(torch.tensor(x), 0.97).numpy()
    # against scipy lfilter in float64 and the JAX associative scan (float32);
    # outputs reach ~15, float32 rounding of the block sums stays below 1e-5
    np.testing.assert_allclose(inv, J.inv_preemphasis_np(x.astype(np.float64), 0.97),
                               atol=1e-5)
    np.testing.assert_allclose(inv, np.asarray(J.inv_preemphasis(jnp.asarray(x), 0.97)),
                               atol=2e-5)
    # the inverse undoes the forward filter
    np.testing.assert_allclose(T.inv_preemphasis(torch.tensor(fwd), 0.97).numpy(), x,
                               atol=1e-5)


def test_inv_preemphasis_multilevel_blocks():
    # a small block forces three levels of the block recursion; c near 1
    # keeps the carry across blocks large, so a wrong carry would show
    x = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    got = TP.inv_preemphasis(torch.tensor(x), 0.999, block=16).numpy()
    ref = J.inv_preemphasis_np(x.astype(np.float64), 0.999)
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())
    xt = torch.tensor(x)
    assert torch.equal(T.inv_preemphasis(xt, 0.0), xt)


@pytest.mark.parametrize("dft", ["fft", "matmul"])
@pytest.mark.parametrize("xp", [np, jnp], ids=["np", "jnp"])
def test_stft_istft_match(dft, xp):
    y = _signal()
    ref = np.asarray(J.stft(xp.asarray(y), n_fft=400, hop_length=80, xp=xp, dft=dft))
    got = T.stft(torch.tensor(y), n_fft=400, hop_length=80, dft=dft).numpy()
    assert got.shape == ref.shape
    # float32 DFTs summed in other orders: 2e-6 of the peak bin (the
    # torch.stft cross-check in test_torch_crosscheck.py only reaches 2e-3)
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max())
    S = ref
    ri = np.asarray(J.istft(xp.asarray(S), hop_length=80, xp=xp, dft=dft))
    gi = T.istft(torch.tensor(S), hop_length=80, dft=dft).numpy()
    assert gi.shape == ri.shape
    np.testing.assert_allclose(gi, ri, atol=2e-6)


def test_stft_hop_not_dividing_nfft():
    y = _signal(4096, seed=2)
    ref = J.stft(y, n_fft=512, hop_length=96, win_length=400, xp=np)
    got = T.stft(torch.tensor(y), n_fft=512, hop_length=96, win_length=400).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max())
    ri = J.istft(ref, hop_length=96, win_length=400, xp=np, length=3000)
    gi = T.istft(torch.tensor(ref), hop_length=96, win_length=400, length=3000).numpy()
    np.testing.assert_allclose(gi, ri, atol=2e-6)
    np.testing.assert_allclose(T.window_sumsquare("hann", 20, 96, 400, 512).numpy(),
                               J.window_sumsquare("hann", 20, 96, 400, 512), atol=1e-6)


@pytest.mark.parametrize("deriv", [False, True])
@pytest.mark.parametrize("xp", [np, jnp], ids=["np", "jnp"])
def test_mfcc_input_match(deriv, xp):
    y = _signal(12000, seed=4)
    ref = J.mfcc_input(y, JFeatureConfig(calc_mfcc_derivate=deriv), xp=xp)
    got = T.mfcc_input(torch.tensor(y), FeatureConfig(calc_mfcc_derivate=deriv))
    # MFCC and mel_dB: 1e-5 (float32 log of float32 mel sums); power_dB
    # carries the float32 log10 of the smallest powers: 5e-5
    for name, r, g, tol in zip(("mfcc", "mel_dB", "power_dB"), ref, got, (1e-5, 1e-5, 5e-5)):
        assert g.shape == np.asarray(r).shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol, err_msg=name)


@pytest.mark.parametrize("dft", ["fft", "matmul"])
@pytest.mark.parametrize("momentum", [0.0, 0.99])
@pytest.mark.parametrize("realse", [1.0, 1.2])
def test_from_power_to_wav_match(dft, momentum, realse):
    P = np.random.default_rng(5).random((60, 201)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(J.from_power_to_wav(jnp.asarray(P), n_iter=8, realse=realse,
                                         momentum=momentum, key=key, dft=dft))
    # the port draws its phase with torch; hand it the JAX draw instead
    phase = np.asarray(jnp.pi * jax.random.uniform(key, P.shape, dtype=jnp.float32))
    got = T.from_power_to_wav(torch.tensor(P), n_iter=8, realse=realse, momentum=momentum,
                              init_phase=torch.tensor(phase), dft=dft).numpy()
    assert got.shape == ref.shape
    # 8 float32 Griffin-Lim rounds; peak ~0.06, measured gap ~3e-7
    np.testing.assert_allclose(got, ref, atol=2e-6)


@pytest.mark.parametrize("shape,ndim", [((3, 40, 201), 2), ((40, 201), 2), ((2, 3, 40, 7), 2),
                                         ((3, 1000), 1), ((1000,), 1)])
def test_clip_means_one_reduction_a_clip(shape, ndim):
    """The vocoder's per-clip means: the mean of each clip alone, the
    reduced axes kept as 1s, whatever clips sit beside it."""
    x = torch.tensor(np.random.default_rng(8).random(shape).astype(np.float32))
    got = TGL.clip_means(x, ndim)
    assert got.shape == shape[:len(shape) - ndim] + (1,) * ndim
    flat = x.reshape(-1, *shape[len(shape) - ndim:])
    want = torch.stack([flat[i].mean() for i in range(flat.shape[0])])
    assert torch.equal(got.reshape(-1), want)
    torch.testing.assert_close(got, x.mean(dim=tuple(range(-ndim, 0)), keepdim=True))


def test_griffin_lim_match_and_return_stft():
    rng = np.random.default_rng(6)
    amp = rng.random((40, 201)).astype(np.float32)
    phase = (np.pi * rng.random(amp.shape)).astype(np.float32)
    ref_wav, ref_S = J.griffin_lim(jnp.asarray(amp), 400, 80, num_iters=5,
                                   init_phase=jnp.asarray(phase), return_stft=True)
    wav, S = T.griffin_lim(torch.tensor(amp), 400, 80, num_iters=5,
                           init_phase=torch.tensor(phase), return_stft=True)
    np.testing.assert_allclose(wav.numpy(), np.asarray(ref_wav), atol=2e-6)
    # |S| is the given amplitude on both sides; the phase of bins whose
    # projection is nearly zero is ill-conditioned, so 1e-4 on |S| <= 1
    np.testing.assert_allclose(np.abs(S.numpy()), amp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(S.numpy(), np.asarray(ref_S), atol=1e-4)
    # a torch.Generator makes the random phase reproducible
    g1 = T.griffin_lim(torch.tensor(amp), 400, 80, num_iters=2,
                       generator=torch.Generator().manual_seed(7))
    g2 = T.griffin_lim(torch.tensor(amp), 400, 80, num_iters=2,
                       generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(g1.numpy(), g2.numpy())
