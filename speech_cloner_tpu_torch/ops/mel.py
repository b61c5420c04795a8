"""Mel filterbank and DCT basis, matching the librosa calls of the reference.

Counterpart of ``speech_cloner_tpu/ops/mel.py``:
  librosa.filters.mel(sr, n_fft, n_mels, fmin=0.0, fmax=None, htk=False, norm=1)
  librosa.filters.dct(n_mfcc, n_mels)

Both are small constant matrices built once on the host in float64; the
feature code stores them as float32 tensors.
"""

from __future__ import annotations

import numpy as np


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney formulation: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    safe_f = np.maximum(f, np.finfo(np.float64).tiny)  # both where-branches evaluate
    return np.where(f >= min_log_hz, min_log_mel + np.log(safe_f / min_log_hz) / logstep, mels)


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False):
    return mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels), htk)


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: int | None = 1,
) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] triangular filterbank (librosa.filters.mel), float64.

    norm=1 is Slaney area normalization: each triangle divided by half its
    mel-band width.
    """
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == 1:
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported mel norm {norm!r}")
    return weights


def dct_basis(n_filters: int, n_input: int) -> np.ndarray:
    """[n_filters, n_input] orthonormal DCT-II basis (librosa.filters.dct), float64.

    Row 0 is 1/sqrt(N); row i>0 is sqrt(2/N)*cos(i * pi*(2j+1)/(2N)).
    """
    basis = np.empty((n_filters, n_input), dtype=np.float64)
    samples = np.arange(1, 2 * n_input, 2) * np.pi / (2.0 * n_input)
    basis[0, :] = 1.0 / np.sqrt(n_input)
    for i in range(1, n_filters):
        basis[i, :] = np.cos(i * samples) * np.sqrt(2.0 / n_input)
    return basis
