"""Spectrogram pictures and audio playback.

Counterpart of ``speech_cloner_tpu/data/viz.py``: `spec_show` (a [T, F]
spectrogram, optionally with phone-change marks) and `spec_comparison`
(true against predicted mel and linear spectrograms), shown or saved as a
PNG; `play` / `stop` through sounddevice. matplotlib and sounddevice are
imported inside the functions, so a machine without them raises only when
one is called (the card's has no matplotlib: apps.clone_demo then skips its
spec.png).
"""

from __future__ import annotations

import numpy as np


def spec_show(spec, phn_v=None, idx2phn=None, aspect_ratio=3, cmap=None,
              save_path: str | None = None):
    """Render a [T, F] spectrogram, optionally with phone-change marks from
    a [T, n_phones] one-hot ``phn_v``. Shows it, or saves it to ``save_path``."""
    import matplotlib

    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = np.asarray(spec)
    n_repeat = m.shape[0] // m.shape[1] // int(aspect_ratio)
    m_show = np.repeat(m, n_repeat, axis=1).T if n_repeat > 1 else m.T

    f, ax = plt.subplots(1, 1, figsize=(aspect_ratio * 5, 5))
    im = ax.imshow(m_show, cmap=cmap, origin="lower", aspect="auto")
    f.colorbar(im)

    if phn_v is not None:
        phn_v = np.asarray(phn_v)
        last_i, up = 0, True
        for i in range(phn_v.shape[0] - 1):
            if (phn_v[i] != phn_v[i + 1]).any() or i == phn_v.shape[0] - 2:
                if i != phn_v.shape[0] - 2:
                    ax.axvline(i + 1, color="y")
                h = (0.85 if up else 0.95) * m_show.shape[0]
                label = (idx2phn[int(np.argmax(phn_v[i]))]
                         if idx2phn is not None else str(int(np.argmax(phn_v[i]))))
                ax.text(0.5 * (i + last_i), h, label, ha="center", color="r")
                last_i, up = i, not up
    plt.tight_layout()
    if save_path:
        plt.savefig(save_path)
        plt.close(f)
    else:
        plt.show()


def spec_comparison(mel_true, mel_pred, stft_true, stft_pred, vert=True,
                    save_path: str | None = None):
    """True against predicted mel and linear spectrograms, one panel each."""
    import matplotlib

    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 1) if vert else plt.subplots(1, 2)
    axes[0].imshow(np.repeat(np.concatenate([np.asarray(mel_pred).T,
                                             np.asarray(mel_true).T], axis=0), 2, axis=0))
    axes[0].set_title("mel spectrogram (pred | true)")
    axes[1].imshow(np.concatenate([np.asarray(stft_pred).T, np.asarray(stft_true).T], axis=0))
    axes[1].set_title("stft spectrogram (pred | true)")
    plt.tight_layout()
    if save_path:
        plt.savefig(save_path)
        plt.close(fig)
    else:
        plt.show()


def play(wave, sample_rate: int = 16000, blocking: bool = False):
    """Play a waveform after 1000 samples of silence; RuntimeError without
    sounddevice."""
    try:
        import sounddevice as sd
    except ImportError as e:
        raise RuntimeError("sounddevice not installed; playback unavailable") from e
    sd.play(np.concatenate([np.zeros(1000), np.asarray(wave)]), sample_rate,
            blocking=blocking, loop=False)


def stop():
    import sounddevice as sd

    sd.stop()
