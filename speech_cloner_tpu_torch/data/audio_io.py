"""Host-side audio I/O: RIFF WAV and NIST SPHERE in, RIFF WAV out, float32
mono at a target rate.

Counterpart of the PCM part of ``speech_cloner_tpu/data/audio_io.py``
(`read_riff_wav`, `read_nist_sphere`, `load_audio`, `write_riff_wav`,
`_resample`), with the librosa.load conventions: integer PCM scaled to
[-1, 1), mono by channel mean, polyphase resampling. mp3 and ffmpeg
decoding and the native decoder are not ported yet.
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


def _pcm_to_float(data: bytes, sampwidth: int, n_channels: int,
                  big_endian: bool = False) -> np.ndarray:
    end = ">" if big_endian else "<"
    if sampwidth == 2:
        y = np.frombuffer(data, dtype=end + "i2").astype(np.float32) / 32768.0
    elif sampwidth == 1:
        y = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 4:
        y = np.frombuffer(data, dtype=end + "i4").astype(np.float32) / 2147483648.0
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


def read_nist_sphere(path: str) -> tuple[np.ndarray, int]:
    """TIMIT's .WAV files are NIST SPHERE: a 1024-byte (or as the header
    says) ASCII header of ``name -type value`` fields, then PCM. Uncompressed
    PCM only, as TIMIT is."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"NIST_1A"):
            raise ValueError(f"{path}: not a NIST SPHERE file")
        header_size = int(f.readline().strip())
        f.seek(0)
        header = f.read(header_size).decode("ascii", errors="replace")
        fields: dict[str, str] = {}
        for line in header.splitlines()[2:]:
            parts = line.split(maxsplit=2)
            if len(parts) == 3 and parts[1].startswith("-"):
                fields[parts[0]] = parts[2]
            if line.strip() == "end_head":
                break
        coding = fields.get("sample_coding", "pcm")
        if "shorten" in coding or "embedded" in coding:
            raise ValueError(f"{path}: shorten-compressed SPHERE unsupported")
        f.seek(header_size)
        y = _pcm_to_float(f.read(), int(fields.get("sample_n_bytes", 2)),
                          int(fields.get("channel_count", 1)),
                          fields.get("sample_byte_format", "01") == "10")
    return y, int(fields.get("sample_rate", 16000))


def load_audio(path: str, sample_rate: int = 16000) -> np.ndarray:
    """RIFF WAV or NIST SPHERE file -> float32 mono at ``sample_rate``."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if not magic.startswith((b"RIFF", b"NIST_1A")):
        raise NotImplementedError(
            f"{path}: only RIFF WAV and NIST SPHERE input are ported yet (mp3 and ffmpeg "
            f"decoding wait: ROADMAP queue 1, \"Data runtime\")")
    try:
        y, sr = read_riff_wav(path) if magic.startswith(b"RIFF") else read_nist_sphere(path)
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
