"""Signal processing of the reference: the MFCC front end, STFT and its
inverse, Griffin-Lim and the power-dB vocoder, in plain torch and numpy.

Semantics (librosa's, as the reference repository calls it): periodic Hann
window, centered STFT with reflect padding of n_fft/2, Slaney mel
filterbank with norm 1, orthonormal DCT-II, dB with amin and an 80 dB
floor under the whole tensor's maximum, inverse STFT divided by the summed
squared window. Time-major [..., T, F]; leading axes are clips or streams,
each on its own.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal

TINY = float(np.finfo(np.float32).tiny)


def dims(features: dict) -> dict:
    """Samples of hop, window and FFT from the configuration's ms fields."""
    sr = features["sample_rate"]
    hop = int(features["hop_length_ms"] * sr / 1000.0)
    win = int(features["win_length_ms"] * sr / 1000.0)
    n_fft = features["n_fft"] or win
    return {"hop": hop, "win": win, "n_fft": n_fft, "n_stft": n_fft // 2 + 1}


# ------------------------------------------------------------ constants ---

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_hz / f_sp
                    + np.log(np.maximum(f, 1e-300) / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@functools.lru_cache(maxsize=None)
def mel_weights(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney mel filterbank [n_mels, n_fft/2 + 1], area-normalized, float64."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    w = np.zeros((n_mels, freqs.size))
    for i in range(n_mels):
        lo, mid, hi = edges[i], edges[i + 1], edges[i + 2]
        w[i] = np.maximum(0.0, np.minimum((freqs - lo) / (mid - lo), (hi - freqs) / (hi - mid)))
        w[i] *= 2.0 / (hi - lo)
    return w


@functools.lru_cache(maxsize=None)
def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II rows [n_mfcc, n_mels], float64."""
    j = np.arange(n_mels)
    m = np.cos(np.pi * np.arange(n_mfcc)[:, None] * (2 * j[None, :] + 1) / (2.0 * n_mels))
    m *= math.sqrt(2.0 / n_mels)
    m[0] = 1.0 / math.sqrt(n_mels)
    return m


@functools.lru_cache(maxsize=None)
def hann(n_fft: int, win: int) -> np.ndarray:
    """Periodic Hann of ``win`` samples, zero-padded to n_fft in the middle."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)
    left = (n_fft - win) // 2
    return np.pad(w, (left, n_fft - win - left))


@functools.lru_cache(maxsize=None)
def _dft_np(n_fft: int):
    """Real DFT bases built in float64: forward cos and -sin [F, N], inverse
    with the Hermitian weights and 1/N [F, N]."""
    k = np.arange(n_fft // 2 + 1)[:, None]
    ang = 2.0 * np.pi * k * np.arange(n_fft)[None, :] / n_fft
    c = np.full((n_fft // 2 + 1, 1), 2.0)
    c[0] = 1.0
    if n_fft % 2 == 0:
        c[-1] = 1.0
    return np.cos(ang), -np.sin(ang), c * np.cos(ang) / n_fft, -c * np.sin(ang) / n_fft


def const(a: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)


# ------------------------------------------------------------ transforms ---

def rfft(frames: torch.Tensor, n_fft: int, dft: str) -> torch.Tensor:
    if dft == "fft":
        return torch.fft.rfft(frames, n=n_fft, dim=-1)
    fr, fi, _, _ = _dft_np(n_fft)
    return torch.complex(frames @ const(fr.T, frames.device), frames @ const(fi.T, frames.device))


def irfft(S: torch.Tensor, n_fft: int, dft: str) -> torch.Tensor:
    if dft == "fft":
        return torch.fft.irfft(S, n=n_fft, dim=-1)
    _, _, ir, ii = _dft_np(n_fft)
    return S.real @ const(ir, S.device) + S.imag @ const(ii, S.device)


def stft(y: torch.Tensor, n_fft: int, hop: int, win: int, center: bool = True,
         dft: str = "fft") -> torch.Tensor:
    """[..., L] -> complex [..., T, n_fft/2 + 1]."""
    if center:
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect")
        y = y.reshape(*lead, -1)
    n_frames = 1 + (y.shape[-1] - n_fft) // hop
    idx = torch.arange(n_frames, device=y.device)[:, None] * hop + torch.arange(n_fft, device=y.device)
    frames = y[..., idx] * const(hann(n_fft, win), y.device)
    return rfft(frames, n_fft, dft)


@functools.lru_cache(maxsize=64)
def _wss(n_frames: int, n_fft: int, hop: int, win: int) -> np.ndarray:
    w2 = hann(n_fft, win) ** 2
    out = np.zeros((n_frames - 1) * hop + n_fft)
    for t in range(n_frames):
        out[t * hop:t * hop + n_fft] += w2
    return out


def istft(S: torch.Tensor, n_fft: int, hop: int, win: int, dft: str = "fft") -> torch.Tensor:
    """complex [..., T, F] -> [..., (T-1)*hop] (centered, trimmed)."""
    *lead, n_frames, _ = S.shape
    frames = irfft(S, n_fft, dft) * const(hann(n_fft, win), S.device)
    length = (n_frames - 1) * hop + n_fft
    cols = frames.reshape(-1, n_frames, n_fft).transpose(1, 2)           # [N, n_fft, T]
    y = F.fold(cols, output_size=(1, length), kernel_size=(1, n_fft), stride=(1, hop))
    y = y.reshape(*lead, length)
    wss = const(_wss(n_frames, n_fft, hop, win), S.device)
    nz = wss > TINY
    y = torch.where(nz, y / torch.where(nz, wss, torch.ones_like(wss)), y)
    return y[..., n_fft // 2:length - n_fft // 2]


def preemphasis(x: torch.Tensor, c: float) -> torch.Tensor:
    return x - c * F.pad(x[..., :-1], (1, 0)) if c else x


def inv_preemphasis(x: torch.Tensor, c: float) -> torch.Tensor:
    """The IIR y[n] = x[n] + c*y[n-1], in float64 on the host."""
    if not c:
        return x
    y = signal.lfilter([1.0], [1.0, -c], x.detach().cpu().double().numpy(), axis=-1)
    return torch.tensor(y, dtype=torch.float32, device=x.device)


def to_db(power: torch.Tensor, amin: float = 1e-10, top_db: float = 80.0) -> torch.Tensor:
    """10 log10(max(power, amin)), floored top_db under the tensor's maximum."""
    d = 10.0 * torch.log10(torch.clamp(power, min=amin))
    return torch.maximum(d, d.max() - top_db)


# ------------------------------------------------------------- front end ---

def mfcc(wav: torch.Tensor, features: dict) -> torch.Tensor:
    """One clip's waveform [L] -> model input [frames, n_mfcc (x2 with deltas)]."""
    f, d = features, dims(features)
    y = wav.to(torch.float32)
    if f["mean_abs_amp_norm"] != 1.0:
        y = y * (f["mean_abs_amp_norm"] / y.abs().mean())
    y = preemphasis(y, f["pre_emphasis"])
    mag = stft(y, d["n_fft"], d["hop"], d["win"]).abs()
    mel = (mag * mag) @ const(mel_weights(f["sample_rate"], d["n_fft"], f["n_mels"]).T, y.device)
    m = to_db(mel.abs() ** 2) @ const(dct_matrix(f["n_mfcc"], f["n_mels"]).T, y.device)
    return finish_mfcc(m, m[0, 0], f)


def finish_mfcc(m: torch.Tensor, c0, f: dict) -> torch.Tensor:
    """c0 subtraction, scale, central-difference deltas and clip of MFCC
    [..., T, n_mfcc] (``c0`` broadcast over frames)."""
    if f["mfcc_normaleze_first_mfcc"]:
        m = torch.cat([m[..., :1] - c0, m[..., 1:]], dim=-1)
    m = f["mfcc_norm_factor"] * m
    if f["calc_mfcc_derivate"]:
        d = 2.0 * (m[..., 2:, :] - m[..., :-2, :])
        d = F.pad(d, (0, 0, 1, 1))
        m = torch.cat([m, d], dim=-1)
    return torch.clamp(m, -1.0, 1.0) if f["clip_output"] else m


# --------------------------------------------------------------- vocoder ---

def phase_draw(shape, seed: int, device) -> torch.Tensor:
    """pi * U[0, 1) of ``shape`` from a generator on ``device`` seeded with
    ``seed``: the benchmark's initial Griffin-Lim phase, handed to both sides."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return math.pi * torch.rand(tuple(shape), generator=gen, device=device, dtype=torch.float32)


def griffin_lim(amp: torch.Tensor, phase0: torch.Tensor, n_iter: int, momentum: float,
                n_fft: int, hop: int, win: int, dft: str):
    """(waveform, the last spectrogram) from magnitudes [..., T, F]."""
    S = torch.polar(amp, phase0)
    prev = torch.zeros_like(S)
    for _ in range(max(n_iter - 1, 0)):
        P = stft(istft(S, n_fft, hop, win, dft), n_fft, hop, win, dft=dft)
        if momentum:
            P, prev = P + momentum * (P - prev), P
        S = amp * (P / torch.clamp(P.abs(), min=TINY))
    return istft(S, n_fft, hop, win, dft), S


def magnitudes(P_db: torch.Tensor, realse: float, dB_norm: float) -> torch.Tensor:
    """Predicted normalized power dB [..., T, F] -> magnitudes, with the
    ``realse`` sharpening renormalized to the mean power of each clip."""
    P = torch.clamp(P_db, min=0.0)
    if realse != 1.0:
        mean = P.mean(dim=(-2, -1), keepdim=True)
        P = P ** realse
        P = (mean / P.mean(dim=(-2, -1), keepdim=True)) * P
    return torch.sqrt(torch.pow(10.0, 0.1 * (P / dB_norm - 80.0)))


def vocode(P_db: torch.Tensor, phase0: torch.Tensor, features: dict, vocoder: dict) -> torch.Tensor:
    """Power dB [..., T, F] -> waveform at the output level (float32)."""
    d = dims(features)
    amp = magnitudes(P_db, vocoder["realse"], features["P_dB_norm_factor"])
    y, _ = griffin_lim(amp, phase0, vocoder["n_iter"], vocoder["gl_momentum"], d["n_fft"],
                       d["hop"], d["win"], vocoder["gl_dft"])
    y = inv_preemphasis(y, features["pre_emphasis"])
    return y * (vocoder["mean_abs_amp_norm"] / y.abs().mean(dim=-1, keepdim=True))


def pcm16_float(y: torch.Tensor) -> torch.Tensor:
    """Peak-normalized PCM scale (before rounding to int16), per clip."""
    peak = torch.clamp(y.abs().amax(dim=-1, keepdim=True), min=1e-9)
    return torch.clamp(y / peak * 32767.0, -32768.0, 32767.0)
