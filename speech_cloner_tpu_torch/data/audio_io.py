"""Host-side audio I/O: RIFF WAV, NIST SPHERE, mp3 and other compressed
audio in, RIFF WAV out, float32 mono at a target rate.

Counterpart of ``speech_cloner_tpu/data/audio_io.py``, with the
librosa.load conventions: integer PCM scaled to [-1, 1), mono by channel
mean, polyphase resampling. `load_audio` dispatches as the JAX package's
does: RIFF and SPHERE through the port's host library
(``csrc/scl_data.cc``, `packed_cache.native_decode_pcm`) with
``use_native``, else the Python readers; mp3 through the system libmpg123
(ctypes, in process) where it loads; everything else, and mp3 without
libmpg123, through an ``ffmpeg`` binary. Where neither exists, an mp3
raises the JAX package's error.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import os
import shutil
import struct
import subprocess
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


def read_via_ffmpeg(path: str, target_sr: int) -> tuple[np.ndarray, int]:
    """Decode mp3/ogg/anything with an ffmpeg binary to float32 mono at ``target_sr``."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError("ffmpeg not available for compressed-audio decode")
    cmd = [ffmpeg, "-v", "quiet", "-i", path, "-f", "f32le", "-acodec", "pcm_f32le",
           "-ac", "1", "-ar", str(target_sr), "-"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(raw, dtype="<f4").astype(np.float32), target_sr


_MPG123_ENC_SIGNED_16 = 0xD0   # mpg123.h MPG123_ENC_SIGNED_16
_MPG123_OK, _MPG123_DONE, _MPG123_NEW_FORMAT = 0, -12, -11


@functools.lru_cache(maxsize=None)
def _load_mpg123():
    """The system libmpg123 with its signatures declared, or None."""
    c = ctypes
    try:
        lib = c.CDLL(c.util.find_library("mpg123") or "libmpg123.so.0")
    except OSError:
        return None
    lib.mpg123_init()
    lib.mpg123_new.restype = c.c_void_p
    lib.mpg123_new.argtypes = [c.c_char_p, c.POINTER(c.c_int)]
    lib.mpg123_open.argtypes = [c.c_void_p, c.c_char_p]
    lib.mpg123_getformat.argtypes = [c.c_void_p, c.POINTER(c.c_long), c.POINTER(c.c_int),
                                     c.POINTER(c.c_int)]
    lib.mpg123_format_none.argtypes = [c.c_void_p]
    lib.mpg123_format.argtypes = [c.c_void_p, c.c_long, c.c_int, c.c_int]
    lib.mpg123_read.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t, c.POINTER(c.c_size_t)]
    lib.mpg123_close.argtypes = [c.c_void_p]
    lib.mpg123_delete.argtypes = [c.c_void_p]
    lib.mpg123_strerror.restype = c.c_char_p
    lib.mpg123_strerror.argtypes = [c.c_void_p]
    return lib


def can_decode_mp3() -> bool:
    """True when libmpg123 loads or an ffmpeg binary is on the PATH."""
    return _load_mpg123() is not None or shutil.which("ffmpeg") is not None


def read_via_mpg123(path: str) -> tuple[np.ndarray, int]:
    """Decode an mp3 with the system libmpg123 -> (float32 mono, its own rate)."""
    lib = _load_mpg123()
    if lib is None:
        raise RuntimeError("libmpg123 not available")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed (err {err.value})")
    try:
        if lib.mpg123_open(h, os.fsencode(path)) != _MPG123_OK:
            raise ValueError(f"mpg123 cannot open {path}: {lib.mpg123_strerror(h).decode()}")
        rate, channels, enc = ctypes.c_long(0), ctypes.c_int(0), ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                                ctypes.byref(enc)) != _MPG123_OK:
            raise ValueError(f"mpg123 cannot read format of {path}")
        # pin the output format so it cannot change mid-stream
        lib.mpg123_format_none(h)
        lib.mpg123_format(h, rate.value, channels.value, _MPG123_ENC_SIGNED_16)
        buf = (ctypes.c_char * (1 << 20))()
        got = ctypes.c_size_t(0)
        chunks = []
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(got))
            if got.value:
                chunks.append(bytes(buf[:got.value]))
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                raise ValueError(f"mpg123 decode error on {path}: "
                                 f"{lib.mpg123_strerror(h).decode()}")
        y = np.frombuffer(b"".join(chunks), dtype="<i2").astype(np.float32) / 32768.0
        if channels.value > 1:
            y = y.reshape(-1, channels.value).mean(axis=1)
        return y, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def load_audio(path: str, sample_rate: int = 16000, use_native: bool = True) -> np.ndarray:
    """Any supported audio file -> float32 mono at ``sample_rate``.

    RIFF WAV and NIST SPHERE (by their magic, for the extensions .wav,
    .wv1, .wv2 or none) decode in the port's host library with
    ``use_native`` (16-bit PCM; it builds at first use and raises if it
    cannot) and otherwise, or for other sample widths, in Python; .mp3 in
    libmpg123 where it loads; the rest through ffmpeg."""
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext in (".wav", ".wv1", ".wv2", ""):
            with open(path, "rb") as f:
                magic = f.read(8)
            if magic.startswith((b"RIFF", b"NIST_1A")):
                if use_native:
                    from .packed_cache import native_decode_pcm

                    out = native_decode_pcm(path)
                    if out is not None:
                        return _resample(out[0], out[1], sample_rate)
                y, sr = read_riff_wav(path) if magic.startswith(b"RIFF") else read_nist_sphere(path)
            else:
                y, sr = read_via_ffmpeg(path, sample_rate)
        elif ext == ".mp3" and _load_mpg123() is not None:
            y, sr = read_via_mpg123(path)
        else:
            y, sr = read_via_ffmpeg(path, sample_rate)
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
