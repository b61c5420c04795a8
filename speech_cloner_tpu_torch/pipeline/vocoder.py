"""The float32 vocoder both pipelines call: normalized power dB -> waveform
or int16 PCM, under the span ``vocode``.

`device_vocode` runs ``ops.from_power_to_wav`` (Griffin-Lim, inverse
pre-emphasis, the output's mean-|y| norm) on clips of one frame count
[..., T, n_stft], the voice-conversion path's, or with ``frames`` on a
ragged batch, each row at its own frame count, the text-to-speech path's.
Row b's initial phase is then its own draw of [frames[b], n_stft] from the
generator, the rows in order (`row_phases`). The counter
``vocode.gl_rounds_fused`` (`runtime.profiler.count`, under the span) adds
the rounds a call on clips of one frame count ran in csrc/griffin_lim.cu,
n_iter - 1 a call where the kernel engages and 0 elsewhere.
`pcm16` peak-normalizes each clip, as ``write_riff_wav(norm=True)`` does.
"""

from __future__ import annotations

import math

import torch

from ..ops import cuda_kernels as ck
from ..ops import from_power_to_wav
from ..ops.features import FeatureConfig
from ..runtime.profiler import count, span


def row_phases(frames, n_stft: int, generator: torch.Generator | None, device) -> torch.Tensor:
    """[B, max frames, n_stft]: row b's pi * U[0, 1) draw of [frames[b],
    n_stft] from ``generator``, the rows in turn, zeros after."""
    T = max(int(n) for n in frames)
    out = torch.zeros(len(frames), T, n_stft, device=device)
    for b, n in enumerate(frames):
        out[b, :int(n)] = math.pi * torch.rand(int(n), n_stft, generator=generator,
                                               device=device, dtype=torch.float32)
    return out


def device_vocode(P: torch.Tensor, feat: FeatureConfig, *, n_iter: int, realse: float,
                  momentum: float, dft: str, mean_abs_amp_norm: float,
                  generator: torch.Generator | None = None,
                  init_phase: torch.Tensor | None = None, frames=None) -> torch.Tensor:
    """Power dB [..., T, n_stft] -> waveform [..., L] (leading axes are clips,
    each vocoded on its own); with ``frames``, P is [B, T, n_stft] and row
    b's first ``frames[b]`` frames its own: waveform [B, (T-1)*hop], row b's
    first (frames[b]-1)*hop samples its own."""
    with span("vocode", P.device):
        if frames is not None and init_phase is None:
            init_phase = row_phases(frames, P.shape[-1], generator, P.device)
        fused = ck.launch_counts["gl_round", torch.float32]
        y = from_power_to_wav(
            P, P_dB_norm_factor=feat.P_dB_norm_factor, pre_emphasis=feat.pre_emphasis,
            hop_length=feat.hop_length, win_length=feat.win_length,
            mean_abs_amp_norm=mean_abs_amp_norm, n_iter=n_iter, n_fft=feat.n_fft_,
            realse=realse, generator=generator, init_phase=init_phase, momentum=momentum,
            dft=dft, frames=frames)
        if frames is None:      # ragged rows never reach the kernel
            count("vocode.gl_rounds_fused", ck.launch_counts["gl_round", torch.float32] - fused)
        return y


def pcm16(wav: torch.Tensor) -> torch.Tensor:
    """Peak-normalize each clip to int16 PCM (write_riff_wav's norm=True)."""
    peak = torch.clamp(wav.abs().amax(dim=-1, keepdim=True), min=1e-9)
    return torch.clamp(wav / peak * 32767.0, -32768.0, 32767.0).to(torch.int16)


def device_vocode_pcm16(P: torch.Tensor, feat: FeatureConfig, **kw) -> torch.Tensor:
    """`device_vocode`, then `pcm16` (a ragged row's zeros after its own
    samples stay zero)."""
    return pcm16(device_vocode(P, feat, **kw))
