"""Griffin-Lim phase reconstruction and the power-dB -> waveform vocoder.

Counterpart of ``speech_cloner_tpu/ops/griffin_lim.py`` (`griffin_lim`,
`from_power_to_wav`): ``num_iters - 1`` rounds of istft -> stft -> keep
phase/replace magnitude (S/max(|S|, tiny)), optional Fast Griffin-Lim
momentum, then a final istft; dB denorm, ``realse`` sharpening with
mean-power renorm, inverse pre-emphasis and output amplitude norm.

The random initial phase comes from an explicit ``torch.Generator``;
``init_phase`` overrides it, which is how tests hand both packages the same
phase (jax.random and torch draw different numbers from one seed).

Leading axes are a batch of clips (the JAX package vmaps `from_power_to_wav`
over clips): [B, T, F] in, [B, L] out, every round's transforms over all
clips at once, and every reduction (the ``realse`` power means, the output
mean-|y| norm) per clip, one clip at a time (`clip_means`), so a clip of a
batch gets the same renorm factors as its single conversion.
``unroll`` is a lax loop knob of the JAX package: accepted, no effect here.

`griffin_lim_dyn` / `from_power_to_wav_dyn` are the JAX package's forms with
the round count and momentum as traced run-time values (one executable for
every quality setting). Eager PyTorch takes both at run time anyway, so here
they are the static functions, taking a Python number or a 0-d tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .db import db_to_power
from .preemphasis import inv_preemphasis
from .stft import istft, stft

_TINY = float(np.finfo(np.float32).tiny)


def griffin_lim(stft_amp: torch.Tensor, win_length: int, hop_length: int,
                num_iters: int = 200, n_fft: int | None = None, window: str = "hann",
                generator: torch.Generator | None = None,
                init_phase: torch.Tensor | None = None, momentum: float = 0.0,
                unroll: int = 1, return_stft: bool = False, dft: str = "fft"):
    """Phase reconstruction from time-major magnitude spectrograms [..., T, F]."""
    del unroll
    if n_fft is None:
        n_fft = win_length
    stft_amp = stft_amp.to(torch.float32)
    if init_phase is not None:
        phase0 = torch.as_tensor(init_phase, dtype=torch.float32, device=stft_amp.device)
    else:
        phase0 = math.pi * torch.rand(stft_amp.shape, generator=generator,
                                      device=stft_amp.device, dtype=torch.float32)
    S = torch.polar(stft_amp, phase0)

    def project(S):
        wav = istft(S, hop_length=hop_length, win_length=win_length, n_fft=n_fft,
                    window=window, dft=dft)
        return stft(wav, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                    window=window, dft=dft)

    def replace_magnitude(S):
        return stft_amp * (S / torch.clamp(torch.abs(S), min=_TINY))

    P_prev = torch.zeros_like(S) if momentum != 0.0 else None
    for _ in range(max(num_iters - 1, 0)):
        P = project(S)
        if momentum != 0.0:
            P, P_prev = P + momentum * (P - P_prev), P
        S = replace_magnitude(P)
    wav = istft(S, hop_length=hop_length, win_length=win_length, n_fft=n_fft,
                window=window, dft=dft)
    return (wav, S) if return_stft else wav


def griffin_lim_dyn(stft_amp: torch.Tensor, win_length: int, hop_length: int, num_iters,
                    n_fft: int | None = None, window: str = "hann",
                    generator: torch.Generator | None = None,
                    init_phase: torch.Tensor | None = None, momentum=0.0,
                    return_stft: bool = False, dft: str = "fft"):
    """`griffin_lim` with ``num_iters`` and ``momentum`` as numbers or 0-d tensors."""
    return griffin_lim(stft_amp, win_length, hop_length, num_iters=int(num_iters), n_fft=n_fft,
                       window=window, generator=generator, init_phase=init_phase,
                       momentum=float(momentum), return_stft=return_stft, dft=dft)


def from_power_to_wav(P: torch.Tensor, P_dB_norm_factor: float = 0.01,
                      pre_emphasis: float = 0.97, hop_length: int = 80,
                      win_length: int = 400, mean_abs_amp_norm: float = 0.01,
                      n_iter: int = 200, n_fft: int | None = None, realse: float = 1.0,
                      generator: torch.Generator | None = None,
                      init_phase: torch.Tensor | None = None, momentum: float = 0.0,
                      unroll: int = 1, dft: str = "fft") -> torch.Tensor:
    """Normalized power_dB maps [..., T, n_stft] -> waveforms [..., L]."""
    P = torch.clamp(P, min=0.0)
    if realse != 1.0:  # spectral sharpening with mean-power renorm, per clip
        p_mean = clip_means(P, 2)
        P = P**realse
        P = (p_mean / clip_means(P, 2)) * P

    Fm = torch.sqrt(db_to_power(P / P_dB_norm_factor - 80.0))
    y = griffin_lim(Fm, win_length, hop_length, num_iters=n_iter, n_fft=n_fft,
                    generator=generator, init_phase=init_phase, momentum=momentum,
                    unroll=unroll, dft=dft)
    if pre_emphasis != 0.0:
        y = inv_preemphasis(y, pre_emphasis)
    return y * (mean_abs_amp_norm / clip_means(torch.abs(y), 1))


def clip_means(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Mean over the last ``ndim`` axes of each clip, keeping them as 1s: one
    reduction a clip, as a single clip's conversion makes it. A reduction
    over several clips at once splits its sums by the clip count on a CUDA
    device, and Griffin-Lim's 200 rounds carry such a last-bit difference
    in a renorm factor up to tens of PCM steps."""
    lead, tail = x.shape[:x.dim() - ndim], x.shape[x.dim() - ndim:]
    means = [clip.mean() for clip in x.reshape(-1, *tail).unbind(0)]
    return torch.stack(means).reshape(*lead, *(1,) * ndim)


def from_power_to_wav_dyn(P: torch.Tensor, n_iter, momentum=0.0, P_dB_norm_factor: float = 0.01,
                          pre_emphasis: float = 0.97, hop_length: int = 80,
                          win_length: int = 400, mean_abs_amp_norm: float = 0.01,
                          n_fft: int | None = None, realse: float = 1.0,
                          generator: torch.Generator | None = None,
                          init_phase: torch.Tensor | None = None,
                          dft: str = "fft") -> torch.Tensor:
    """`from_power_to_wav` with ``n_iter`` and ``momentum`` as numbers or 0-d tensors."""
    return from_power_to_wav(P, P_dB_norm_factor=P_dB_norm_factor, pre_emphasis=pre_emphasis,
                             hop_length=hop_length, win_length=win_length,
                             mean_abs_amp_norm=mean_abs_amp_norm, n_iter=int(n_iter),
                             n_fft=n_fft, realse=realse, generator=generator,
                             init_phase=init_phase, momentum=float(momentum), dft=dft)
