"""Window functions with librosa/scipy-compatible semantics (host numpy).

Counterpart of ``speech_cloner_tpu/ops/windows.py``: the periodic Hann (and
Hamming) window zero-padded centered to ``n_fft``, built in float64 on the
host. The STFT code casts them to float32 tensors on the working device.
"""

from __future__ import annotations

import numpy as np


def hann_periodic(win_length: int) -> np.ndarray:
    """Periodic Hann window: 0.5 - 0.5*cos(2*pi*n/N), n = 0..N-1
    (scipy.signal.get_window('hann', N, fftbins=True))."""
    n = np.arange(win_length)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def hamming_periodic(win_length: int) -> np.ndarray:
    """Periodic Hamming window (scipy get_window('hamming', fftbins=True))."""
    n = np.arange(win_length)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)


_WINDOW_FNS = {
    "hann": hann_periodic,
    "hamm": hamming_periodic,
    "hamming": hamming_periodic,
}


def get_window(name: str, win_length: int) -> np.ndarray:
    try:
        fn = _WINDOW_FNS[name]
    except KeyError:
        raise ValueError(f"unsupported window {name!r}; supported: {sorted(_WINDOW_FNS)}")
    return fn(win_length)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window symmetrically to ``size`` (librosa util.pad_center)."""
    n = window.shape[0]
    if n > size:
        raise ValueError(f"window length {n} > target size {size}")
    lpad = (size - n) // 2
    return np.pad(window, (lpad, size - n - lpad))
