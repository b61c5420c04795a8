"""Whole conversions of the reference: a clip in 400-frame windows of two
half-offset passes stitched back together (the offline path), and a clip
as one sequence (the long-form path)."""

from __future__ import annotations

import torch

from . import dsp, models
from .precision import Precision


def pad_to_windows(wav: torch.Tensor, T: int, hop: int) -> torch.Tensor:
    """Zeros after a clip [L] up to whole windows of T frames, at least one."""
    spw = T * hop
    n = max(-(-wav.shape[-1] // spw), 1) * spw
    return torch.nn.functional.pad(wav, (0, n - wav.shape[-1]))


def windows(m: torch.Tensor, T: int) -> torch.Tensor:
    """MFCC [frames, E] -> [2K-1, T, E]: K aligned windows of the first K*T
    frames, then K-1 windows offset by T/2 (K windows alone when K = 1)."""
    K = m.shape[0] // T
    y0 = m[:K * T].reshape(K, T, -1)
    if K == 1:
        return y0
    y1 = m[T // 2:T // 2 + (K - 1) * T].reshape(K - 1, T, -1)
    return torch.cat([y0, y1])


def stitch(y: torch.Tensor, K: int) -> torch.Tensor:
    """[2K-1, T, C] windows -> [K*T, C]: the first window up to 3T/4, the
    centre halves of the passes in turn, the last window from T/4."""
    T = y.shape[1]
    if K == 1:
        return y[0]
    q = T // 4
    y0, y1 = y[:K], y[K:]
    parts = [y0[0, :T - q]]
    for i in range(K - 1):
        parts.append(y1[i, q:T - q])
        if i + 1 < K - 1:
            parts.append(y0[i + 1, q:T - q])
    parts.append(y0[K - 1, q:])
    return torch.cat(parts)


def convert_windows(wav: torch.Tensor, trees, config: dict, phase_seed: int, prec: Precision,
                    rows: int = 0) -> dict:
    """The offline conversion of one clip [L], padded to whole windows:
    every stage's output."""
    T = config["encoder"]["input_shape"][0]
    with prec.active():
        m = dsp.mfcc(pad_to_windows(wav, T, dsp.dims(config["features"])["hop"]),
                     config["features"])
        K = m.shape[0] // T
        x = windows(m, T)
        ppg, mel, spec = models.forward(trees, x, prec, rows)
        stitched = stitch(spec, K)
        phase0 = dsp.phase_draw(stitched.shape, phase_seed, wav.device)
        y = dsp.vocode(stitched, phase0, config["features"], config["vocoder"])
    return {"mfcc": x, "ppg": ppg, "mel": mel, "stft": spec, "stitched": stitched,
            "pcm": dsp.pcm16_float(y)}


def convert_sequence(wav: torch.Tensor, trees, config: dict, phase_seed: int,
                     prec: Precision) -> dict:
    """The long-form conversion of one clip [L] as one sequence."""
    with prec.active():
        m = dsp.mfcc(wav, config["features"])
        ppg, mel, spec = models.forward(trees, m[None], prec)
        phase0 = dsp.phase_draw(spec.shape[1:], phase_seed, wav.device)
        y = dsp.vocode(spec[0], phase0, config["features"], config["vocoder"])
    frames = m.shape[0]
    hop = dsp.dims(config["features"])["hop"]
    return {"mfcc": m[None], "ppg": ppg, "mel": mel, "stft": spec,
            "wav": y[:frames * hop]}
