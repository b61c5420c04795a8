"""Seeded voiced-like audio, made in bulk on the device.

Each clip: eleven harmonics on a pitch that wanders around 140 Hz (a slow
sine plus a random walk), an amplitude envelope of 2.5 Hz bursts with a
random phase, and a little white noise; each clip from its own seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def clip_seeds(seed: int, n: int, salt: int) -> list[int]:
    """``n`` seeds below 2**62 derived from the run's ``seed`` and a ``salt``
    that tells the uses apart."""
    ss = np.random.SeedSequence([seed, salt])
    return [int(s) for s in ss.generate_state(n, dtype=np.uint64) >> np.uint64(2)]


def voiced_clips(seeds: list[int], seconds: float, sr: int, device) -> np.ndarray:
    """[len(seeds), seconds * sr] float32 host array."""
    n = int(round(seconds * sr))
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    out = []
    for s in seeds:
        gen = torch.Generator(device=device).manual_seed(s)
        walk = torch.randn(n, generator=gen, device=device, dtype=torch.float64).cumsum(0)
        f0 = 140.0 + 40.0 * torch.sin(2 * math.pi * 0.3 * t) + 10.0 * walk / sr
        phase = 2 * math.pi * torch.cumsum(f0, 0) / sr
        voiced = sum(torch.sin(k * phase) / k for k in range(1, 12))
        shift = torch.rand((), generator=gen, device=device, dtype=torch.float64) * 2 * math.pi
        env = 0.5 + 0.5 * torch.sin(2 * math.pi * 2.5 * t + shift) ** 2
        noise = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
        out.append((0.2 * env * voiced + 0.01 * noise).to(torch.float32))
    return torch.stack(out).cpu().numpy()
