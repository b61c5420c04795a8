"""Windowing and two-pass overlap stitching for long-form inference.

Counterpart of ``speech_cloner_tpu/pipeline/stitch.py``: fixed
n_timesteps windows, a second pass offset by half a window, stitched by
keeping each window's center half (the reference's ``compound``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to_multiple(x: torch.Tensor, n_timesteps: int) -> torch.Tensor:
    """Zero-pad [T, C] on the time axis to a multiple of n_timesteps."""
    pad = (-x.shape[0]) % n_timesteps
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def window_stack(x: torch.Tensor, n_timesteps: int) -> torch.Tensor:
    """[K*n_timesteps, C] -> [K, n_timesteps, C] non-overlapping windows."""
    T, C = x.shape
    return x.reshape(T // n_timesteps, n_timesteps, C)


def shifted_window_stack(x: torch.Tensor, n_timesteps: int) -> torch.Tensor:
    """Second pass offset by n_timesteps//2: [K*T, C] -> [K-1, T, C]."""
    half = n_timesteps // 2
    K = x.shape[0] // n_timesteps
    return window_stack(x[half : half + (K - 1) * n_timesteps], n_timesteps)


def compound(y0: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    """Stitch two offset passes keeping center halves.

    y0: [K, T, C] aligned windows; y1: [K-1, T, C] windows offset by T/2.
    Output [K*T, C]: y0[0][:3T/4], then alternating center halves
    y1[i][T/4:3T/4], y0[i+1][T/4:3T/4], ..., closing with y0[-1][T/4:].
    """
    K, T, C = y0.shape
    q = T // 4
    parts = [y0[0, : T - q, :]]
    for i in range(K - 1):
        parts.append(y1[i, q : T - q, :])
        if i + 1 < K - 1:
            parts.append(y0[i + 1, q : T - q, :])
    parts.append(y0[K - 1, q:, :])
    return torch.cat(parts, dim=0)


def stitch_single(y0: torch.Tensor) -> torch.Tensor:
    """Single-pass stitch when only one window exists."""
    K, T, C = y0.shape
    return y0.reshape(K * T, C)
