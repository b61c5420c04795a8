"""Vocoded data augmentation for the speaker-ID verifier.

Counterpart of ``speech_cloner_tpu/train/augment.py``. The verifier scores
converted audio, which has been through Griffin-Lim; a classifier trained on
clean windows alone sees another domain. So each training window may be
replaced by the power_dB of its own Griffin-Lim resynthesis: the port's
batched `from_power_to_wav` (Fast Griffin-Lim, momentum 0.99, 25 rounds),
then the power path of the front end (amplitude norm, pre-emphasis, STFT,
|.|^2, dB with its 80 dB floor, min-subtraction, scale, clip), each reduction
per window. All windows of a batch go through every round at once, on the
batch's device.

The random initial phases and the per-window Bernoulli choice come from a
``torch.Generator`` (jax.random draws other numbers from a seed), or are
passed in (``init_phase``, ``mask``), which is how tests give both packages
the same ones.
"""

from __future__ import annotations

import math

import torch

from ..ops.db import power_to_db
from ..ops.features import FeatureConfig
from ..ops.griffin_lim import from_power_to_wav
from ..ops.preemphasis import preemphasis
from ..ops.stft import stft


def vocoded_power_window(p_dB: torch.Tensor, cfg: FeatureConfig, *,
                         generator: torch.Generator | None = None,
                         init_phase: torch.Tensor | None = None, n_iter: int = 25,
                         momentum: float = 0.99, realse: float = 1.2) -> torch.Tensor:
    """Normalized power_dB windows [..., T, n_stft] -> the power_dB of their
    Griffin-Lim resynthesis, float32, same shape. ``init_phase`` (the shape
    of ``p_dB``) overrides the phases drawn from ``generator``."""
    T = p_dB.shape[-2]
    p_dB = p_dB.to(torch.float32)
    wav = from_power_to_wav(p_dB, P_dB_norm_factor=cfg.P_dB_norm_factor,
                            pre_emphasis=cfg.pre_emphasis, hop_length=cfg.hop_length,
                            win_length=cfg.win_length, mean_abs_amp_norm=cfg.mean_abs_amp_norm,
                            n_iter=n_iter, n_fft=cfg.n_fft, realse=realse, generator=generator,
                            init_phase=init_phase, momentum=momentum)
    y = (cfg.mean_abs_amp_norm / torch.mean(torch.abs(wav), dim=-1, keepdim=True)) * wav
    y = preemphasis(y, cfg.pre_emphasis)
    S = torch.abs(stft(y, n_fft=cfg.n_fft_, hop_length=cfg.hop_length,
                       win_length=cfg.win_length, window=cfg.window, center=True))
    P_dB = power_to_db(S * S, top_db=None)        # the 80 dB floor per window, below
    P_dB = torch.maximum(P_dB, P_dB.amax(dim=(-2, -1), keepdim=True) - 80.0)
    P_dB = cfg.P_dB_norm_factor * (P_dB - P_dB.amin(dim=(-2, -1), keepdim=True))
    if cfg.clip_output:
        P_dB = torch.clamp(P_dB, -1.0, 1.0)
    return P_dB[..., :T, :]


def mix_vocoded(p_batch: torch.Tensor, cfg: FeatureConfig, *,
                generator: torch.Generator | None = None, frac: float = 0.5,
                init_phase: torch.Tensor | None = None, mask: torch.Tensor | None = None,
                n_iter: int = 25, momentum: float = 0.99, realse: float = 1.2) -> torch.Tensor:
    """Replace each window of [B, T, n_stft] by its vocoded version with
    probability ``frac`` (a Bernoulli draw per window, or ``mask`` [B]
    bool). frac 0 is the identity (the reference's clean-only training),
    frac 1 replaces every window. ``generator`` draws the initial phases
    (unless ``init_phase`` is given), then the mask (unless ``mask`` is
    given), on the batch's device."""
    if frac <= 0.0:
        return p_batch
    if init_phase is None:
        init_phase = math.pi * torch.rand(p_batch.shape, generator=generator,
                                          device=p_batch.device, dtype=torch.float32)
    voc = vocoded_power_window(p_batch, cfg, init_phase=init_phase, n_iter=n_iter,
                               momentum=momentum, realse=realse)
    if frac >= 1.0:
        return voc
    if mask is None:
        mask = torch.rand(p_batch.shape[0], generator=generator, device=p_batch.device) < frac
    return torch.where(mask.to(p_batch.device)[:, None, None], voc, p_batch.to(torch.float32))
