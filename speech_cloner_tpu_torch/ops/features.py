"""Feature front-end: waveform -> (MFCC, mel_dB, power_dB), on tensors, and
the phone targets on the frame grid (host numpy).

Counterpart of ``speech_cloner_tpu/ops/features.py`` (`FeatureConfig`,
`feature_matrices`, `mfcc_input`), keeping every pinned constant: mean-abs
amplitude norm over the whole clip, pre-emphasis, center/reflect STFT,
Slaney mel norm=1, frame-0 c0 subtraction, the 0.01 scale factors, the
central-difference delta, min-subtraction of the dB maps over the whole
clip, and the final clip to [-1, 1]. `phn_frame_targets` / `one_hot` are the
JAX module's host functions of the same names.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .db import amplitude_to_db, power_to_db
from .mel import dct_basis, mel_filterbank
from .preemphasis import preemphasis
from .stft import stft


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Front-end hyperparameters (reference hp/ds_enc_cfg_d.json)."""

    sample_rate: int = 16000
    pre_emphasis: float = 0.97
    hop_length: int = 80          # 5 ms @ 16 kHz
    win_length: int = 400         # 25 ms @ 16 kHz
    n_fft: int | None = None      # None -> win_length
    n_mels: int = 80
    n_mfcc: int = 40
    window: str = "hann"
    mfcc_normaleze_first_mfcc: bool = True
    mfcc_norm_factor: float = 0.01
    calc_mfcc_derivate: bool = False
    M_dB_norm_factor: float = 0.01
    P_dB_norm_factor: float = 0.01
    mean_abs_amp_norm: float = 0.003
    clip_output: bool = True

    @property
    def n_fft_(self) -> int:
        return self.n_fft if self.n_fft is not None else self.win_length

    @property
    def n_stft(self) -> int:
        return self.n_fft_ // 2 + 1

    @property
    def input_dim(self) -> int:
        return (2 if self.calc_mfcc_derivate else 1) * self.n_mfcc


def feature_matrices(cfg: FeatureConfig) -> tuple[np.ndarray, np.ndarray]:
    """(mel_weights [n_mels, n_stft], dct [n_mfcc, n_mels]) as float32 host arrays."""
    mel_w = mel_filterbank(cfg.sample_rate, cfg.n_fft_, cfg.n_mels, fmin=0.0, fmax=None,
                           htk=False, norm=1).astype(np.float32)
    dct = dct_basis(cfg.n_mfcc, cfg.n_mels).astype(np.float32)
    return mel_w, dct


def mfcc_input(y: torch.Tensor, cfg: FeatureConfig, mel_w: torch.Tensor | None = None,
               dct: torch.Tensor | None = None):
    """wave [L] -> (MFCC [T, n_mfcc(*2)], mel_dB [T, n_mels], power_dB [T, n_stft]).

    ``mel_w``/``dct`` default to `feature_matrices(cfg)` on ``y``'s device.
    """
    if mel_w is None or dct is None:
        mel_np, dct_np = feature_matrices(cfg)
        mel_w = torch.tensor(mel_np, device=y.device) if mel_w is None else mel_w
        dct = torch.tensor(dct_np, device=y.device) if dct is None else dct

    y = y.to(torch.float32)
    if cfg.mean_abs_amp_norm != 1.0:
        y = (cfg.mean_abs_amp_norm / torch.mean(torch.abs(y))) * y

    y = preemphasis(y, cfg.pre_emphasis)

    Fm = torch.abs(stft(y, n_fft=cfg.n_fft_, hop_length=cfg.hop_length,
                        win_length=cfg.win_length, window=cfg.window, center=True))
    P = Fm * Fm
    P_dB = power_to_db(P)

    M_spec = P @ mel_w.T
    M_dB = amplitude_to_db(M_spec)

    MFCC = M_dB @ dct.T
    if cfg.mfcc_normaleze_first_mfcc:               # remove frame 0's c0 offset
        MFCC = torch.cat([MFCC[:, :1] - MFCC[:1, :1], MFCC[:, 1:]], dim=1)
    if cfg.mfcc_norm_factor != 1.0:
        MFCC = cfg.mfcc_norm_factor * MFCC

    if cfg.calc_mfcc_derivate:
        zeros = MFCC.new_zeros((1, MFCC.shape[1]))
        d = 2.0 * torch.cat([zeros, MFCC[2:] - MFCC[:-2], zeros], dim=0)
        MFCC = torch.cat([MFCC, d], dim=1)

    if cfg.P_dB_norm_factor != 1.0:
        P_dB = cfg.P_dB_norm_factor * (P_dB - P_dB.min())
    if cfg.M_dB_norm_factor != 1.0:
        M_dB = cfg.M_dB_norm_factor * (M_dB - M_dB.min())

    if cfg.clip_output:
        MFCC = torch.clamp(MFCC, -1.0, 1.0)
        P_dB = torch.clamp(P_dB, -1.0, 1.0)
        M_dB = torch.clamp(M_dB, -1.0, 1.0)
    return MFCC, M_dB, P_dB


def phn_frame_targets(n_wav_samples: int, phn_v, phn_to_idx, hop_length: int = 80,
                      win_length: int = 400) -> np.ndarray:
    """Phone segments on the STFT frame grid -> int32 [T] class indices: per
    window, the majority overlap of the current and the next phone, with the
    center=True shift of win_length // 2. ``phn_v``: (start, end, phone)."""
    n_frames = n_wav_samples // hop_length + 1
    half = win_length // 2
    out = np.empty(n_frames, dtype=np.int32)
    i_phn = 0
    for i_s in range(n_frames):
        w_s = i_s * hop_length - half
        w_e = i_s * hop_length + win_length - half
        while phn_v[i_phn][1] <= w_s and i_phn + 1 < len(phn_v):
            i_phn += 1
        ov_a = min(phn_v[i_phn][1], w_e) - max(phn_v[i_phn][0], w_s)
        pick = i_phn
        if i_phn + 1 < len(phn_v):
            ov_b = min(phn_v[i_phn + 1][1], w_e) - max(phn_v[i_phn + 1][0], w_s)
            pick = i_phn if ov_a >= ov_b else i_phn + 1
        out[i_s] = phn_to_idx[phn_v[pick][2]]
    return out


def one_hot(idx: np.ndarray, n_classes: int) -> np.ndarray:
    oh = np.zeros((idx.shape[0], n_classes), dtype=np.float32)
    oh[np.arange(idx.shape[0]), idx] = 1.0
    return oh
