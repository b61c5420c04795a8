"""Batched conversion of the PyTorch port against the JAX package, on the CPU.

`convert_batch` / `convert_batch_pcm16` against the JAX package's, on clips of
different lengths and loudness at tests/test_pipeline.py's tiny geometry.
JAX draws each clip's initial Griffin-Lim phase from
``jax.random.split(PRNGKey(seed), B)``; those phases are handed to the port.
Each batched clip must also equal the port's own single conversion of it, so
every reduction (amplitude norm, dB floors, c0, realse means, output norm,
PCM peak) is shown to stay per clip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_pipeline import clip, pipes  # noqa: F401  (pipes: a fixture)

torch.set_num_threads(2)
SPW = 3840          # samples per 48-frame window at hop 80


def split_phases(seed, B, shape):
    """The JAX batch APIs' initial phases: pi*uniform of each split key."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return np.stack([np.asarray(jnp.pi * jax.random.uniform(k, shape, dtype=jnp.float32))
                     for k in keys])


def frames(n):
    return max(-(-n // SPW), 1) * 48


@pytest.mark.parametrize("n", [2000, 2 * SPW + 500], ids=["1window", "3windows"])
def test_convert_batch_matches_jax(pipes, n):  # noqa: F811
    jp, tp = pipes
    wavs = [clip(n, seed=1), 0.05 * clip(n, seed=2)]           # 26 dB apart
    ref_wav, ref_mel, ref_stft = jp.convert_batch(wavs, seed=3)
    phase = torch.tensor(split_phases(3, 2, (frames(n), 201)))
    wav, mel, stft = tp.convert_batch(wavs, init_phase=phase)
    assert wav.shape == ref_wav.shape and mel.shape == ref_mel.shape
    # float32 both sides, as the single-clip tests (test_torch_port_pipeline.py)
    np.testing.assert_allclose(mel, ref_mel, atol=1e-5)
    np.testing.assert_allclose(stft, ref_stft, atol=1e-5)
    np.testing.assert_allclose(wav, ref_wav, atol=2e-6)
    # the output norm is per clip: each has mean |y| = mean_abs_amp_norm
    np.testing.assert_allclose(np.abs(wav).mean(axis=1), [0.045, 0.045], rtol=1e-5)
    # each clip equals its own single conversion with the same phase, up to
    # float32 sums over other GEMM shapes (B*T rows against T)
    with torch.inference_mode():
        for i, w in enumerate(wavs):
            m1, s1, _ = tp.device_predict(tp.pad_wav(w))
            w1 = tp.device_vocode(s1, init_phase=phase[i])
            np.testing.assert_allclose(mel[i], m1.numpy(), atol=1e-6)
            np.testing.assert_allclose(wav[i], w1.numpy(), atol=2e-6)


def test_convert_batch_pcm16_matches_jax(pipes):  # noqa: F811
    """Three lengths, three loudnesses: every clip pads to the longest
    clip's bucket (4 windows), as the JAX package pads them."""
    jp, tp = pipes
    wavs = [clip(SPW + 77, seed=4), 3.0 * clip(3 * SPW + 1000, seed=5),
            0.02 * clip(2 * SPW, seed=6)]
    ref = jp.convert_batch_pcm16(wavs, seed=1)
    phase = torch.tensor(split_phases(1, 3, (4 * 48, 201)))
    got = tp.convert_batch_pcm16(wavs, init_phase=phase)
    assert len(got) == 3
    for g, r in zip(got, ref):
        assert g.dtype == np.int16 and g.shape == r.shape == ((4 * 48 - 1) * 80,)
        # float32 gaps of ~1e-6 of the peak can move a sample across an integer
        assert np.abs(g.astype(np.int32) - r.astype(np.int32)).max() <= 1
    # each clip: its single conversion padded to the same bucket, same phase
    with torch.inference_mode():
        for i, w in enumerate(wavs):
            _, s1, _ = tp.device_predict(tp.pad_wav(w, 4 * SPW))
            p1 = tp.device_vocode_pcm16(s1, init_phase=phase[i]).numpy()
            assert np.abs(got[i].astype(np.int32) - p1.astype(np.int32)).max() <= 1
            assert np.abs(got[i]).max() == 32767                 # per-clip peak


def test_batch_seeded_phase_and_lengths(pipes):  # noqa: F811
    _, tp = pipes
    wavs = [clip(SPW + 10, seed=7), clip(SPW + 10, seed=8)]
    with pytest.raises(ValueError, match="several lengths"):
        tp.convert_batch([wavs[0], wavs[1][:-5]])
    # the host API draws one [B, T, F] phase from a generator seeded with seed
    phase = torch.pi * torch.rand((2, 2 * 48, 201), generator=torch.Generator().manual_seed(9))
    got = tp.convert_batch_pcm16(wavs, seed=9)
    want = tp.convert_batch_pcm16(wavs, init_phase=phase)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert tp.padded_length(0) == tp.padded_length(SPW) == SPW
    assert tp.padded_length(SPW + 1) == 2 * SPW
