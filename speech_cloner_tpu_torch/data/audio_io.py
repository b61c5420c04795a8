"""Host-side audio I/O: RIFF WAV in and out, float32 mono at a target rate.

Counterpart of the WAV part of ``speech_cloner_tpu/data/audio_io.py``
(`read_riff_wav`, `load_audio`, `write_riff_wav`, `_resample`), with the
librosa.load conventions: integer PCM scaled to [-1, 1), mono by channel
mean, polyphase resampling. NIST SPHERE, mp3 and ffmpeg decoding and the
native decoder are not ported yet.
"""

from __future__ import annotations

import struct
import wave
from math import gcd

import numpy as np
from scipy.signal import resample_poly


def _resample(y: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return y
    g = gcd(sr, target_sr)
    return resample_poly(y, target_sr // g, sr // g).astype(np.float32)


def _pcm_to_float(data: bytes, sampwidth: int, n_channels: int) -> np.ndarray:
    if sampwidth == 2:
        y = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 1:
        y = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 4:
        y = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {sampwidth}")
    if n_channels > 1:
        y = y.reshape(-1, n_channels).mean(axis=1)
    return y


def read_riff_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        data = w.readframes(w.getnframes())
        y = _pcm_to_float(data, w.getsampwidth(), w.getnchannels())
    return y, sr


def load_audio(path: str, sample_rate: int = 16000) -> np.ndarray:
    """RIFF WAV file -> float32 mono at ``sample_rate``."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic != b"RIFF":
        raise NotImplementedError(
            f"{path}: only RIFF WAV input is ported yet (NIST SPHERE, mp3 and "
            f"ffmpeg decoding wait: ROADMAP queue 1, \"Data runtime\")")
    try:
        y, sr = read_riff_wav(path)
    except (wave.Error, struct.error) as e:
        raise ValueError(f"failed to decode {path}: {e}") from e
    return _resample(y, sr, sample_rate)


def write_riff_wav(path: str, y: np.ndarray, sample_rate: int, norm: bool = True):
    """Float waveform -> 16-bit mono RIFF, peak-normalized when ``norm``;
    int16 input is written as it is."""
    y = np.asarray(y)
    if y.dtype != np.int16:
        y = np.asarray(y, np.float32)
        if norm and np.abs(y).max() > 0:
            y = y / np.abs(y).max()
        y = np.clip(y * 32767.0, -32768, 32767)
    pcm = y.astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
