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

With ``frames`` (`from_power_to_wav`) the batch is ragged, each row at its
own frame count (the text-to-speech path's sentences): its frames past a
row's count hold no magnitude, the transforms treat each row at its own
length (`istft` with `row_envelopes`, `stft` with `reflect_index`), every
reduction is over the row's own frames or samples, the samples past a
row's end are zeroed, and the initial spectrum's first and last bins are
made real, as a real signal's are (the random phase makes them complex;
at 2048 points cuFFT's inverse read their imaginary parts over 8 rows of
780 frames and ignored them over 2, as the CPU does), so a row gives what
it gives alone, in one batch of launches for all rows. Either way one
body runs: `magnitudes`, the rounds, the final inverse and `finish`.

On a CUDA card, the rounds of rows of one length with the matmul DFT and no
momentum run in a hand-written kernel, one launch a round
(``csrc/griffin_lim.cu``, `cuda_kernels.gl_rounds`): inverse DFT,
overlap-add, envelope, reflect padding, forward DFT and projection, float32
FFMA sums on the same bases, each a chain in k order as cuBLAS's (the DC
and Nyquist bins keep only X's sign, so their order shows). It engages only
where `fused_round_plan` gives a plan: a float32 CUDA tensor autograd does
not record, ``dft="matmul"``, ``momentum == 0``, n_fft == win_length, a hop
that divides n_fft, and a shape the kernel takes (n_fft 400, hop 80,
T >= 4). Everything else keeps `rounds` with ``istft`` / ``stft``: the CPU
(which also runs the kernel's plain version, `cuda_kernels.gl_round_plain`,
in the tests), ``dft="fft"`` (the stream, Tacotron, the long-form loop),
Fast Griffin-Lim momentum (the stream, training's vocoded augmentation),
ragged rows and `parallel.gl_sp`. Where a CUDA tensor meets the rule the
kernel runs or raises; nothing falls back. The initial `torch.polar` and
the final ``istft`` stay as they are.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import cuda_kernels as ck
from .db import db_to_power
from .preemphasis import inv_preemphasis
from .stft import _window, istft, reflect_index, row_envelopes, stft, window_sumsquare

_TINY = float(np.finfo(np.float32).tiny)


def _griffin_lim(amp: torch.Tensor, win_length: int, hop_length: int, num_iters: int,
                 n_fft: int, window: str, generator: torch.Generator | None,
                 init_phase: torch.Tensor | None, momentum: float, dft: str,
                 counts: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(waveform, last spectrogram) of `griffin_lim`; ``counts``: the ragged
    rows' frame and (frames - 1) * hop sample counts, a [2, B] tensor on
    their device."""
    amp = amp.to(torch.float32)
    if init_phase is not None:
        phase0 = torch.as_tensor(init_phase, dtype=torch.float32, device=amp.device)
    else:
        phase0 = math.pi * torch.rand(amp.shape, generator=generator, device=amp.device,
                                      dtype=torch.float32)
    envelope = index = None
    if counts is not None:
        T = amp.shape[-2]
        envelope = row_envelopes(counts[0], T, hop_length, win_length, n_fft, window)
        index = reflect_index(counts[1], (T - 1) * hop_length, n_fft)

    def inverse(S):
        return istft(S, hop_length=hop_length, win_length=win_length, n_fft=n_fft,
                     window=window, dft=dft, envelope=envelope)

    def project(S):
        return stft(inverse(S), n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                    window=window, dft=dft, reflect_index=index)

    S = torch.polar(amp, phase0)
    if counts is not None:
        S.imag[..., ::S.shape[-1] - 1] = 0.0        # the first and last bins real
    plan = None if counts is not None else fused_round_plan(amp, dft, momentum, n_fft,
                                                            win_length, hop_length)
    if plan is None:
        S = rounds(S, amp, project, num_iters, momentum)
    else:
        T, F = S.shape[-2:]
        S = ck.gl_rounds(S.reshape(-1, T, F), amp.reshape(-1, T, F).contiguous(),
                         max(num_iters - 1, 0), _window(window, win_length, n_fft, S.device),
                         window_sumsquare(window, T, hop_length, win_length, n_fft, S.device),
                         plan).reshape(S.shape)
    return inverse(S), S


def griffin_lim(stft_amp: torch.Tensor, win_length: int, hop_length: int,
                num_iters: int = 200, n_fft: int | None = None, window: str = "hann",
                generator: torch.Generator | None = None,
                init_phase: torch.Tensor | None = None, momentum: float = 0.0,
                return_stft: bool = False, dft: str = "fft"):
    """Phase reconstruction from time-major magnitude spectrograms [..., T, F]
    -> waveforms [..., (T-1)*hop]."""
    n_fft = win_length if n_fft is None else n_fft
    wav, S = _griffin_lim(stft_amp, win_length, hop_length, num_iters, n_fft, window, generator,
                          init_phase, momentum, dft, None)
    return (wav, S) if return_stft else wav


def gl_kernel_takes(amp, dft: str, momentum: float, n_fft: int, win_length: int,
                    hop_length: int) -> bool:
    """Whether Griffin-Lim's rounds on magnitudes ``amp`` may run in
    csrc/griffin_lim.cu: a float32 CUDA tensor that autograd does not
    record, the matmul DFT, no momentum, n_fft == win_length and a hop that
    divides n_fft. `fused_round_plan` adds the kernel's own shape rule."""
    return (amp.is_cuda and amp.dtype == torch.float32 and dft == "matmul" and momentum == 0.0
            and n_fft == win_length and n_fft % hop_length == 0
            and not (torch.is_grad_enabled() and amp.requires_grad))


def fused_round_plan(amp, dft: str, momentum: float, n_fft: int, win_length: int,
                     hop_length: int) -> ck.GlRoundPlan | None:
    """The kernel's plan for Griffin-Lim on ``amp`` [..., T, n_fft/2 + 1]
    (leading axes the clips), or None where `rounds` runs: what
    `gl_kernel_takes` refuses, and shapes `cuda_kernels.gl_round_plan`
    refuses (another STFT than 400 / 80, T < 4)."""
    if (not gl_kernel_takes(amp, dft, momentum, n_fft, win_length, hop_length)
            or amp.dim() < 2 or amp.shape[-1] != n_fft // 2 + 1 or amp.numel() == 0):
        return None
    T = amp.shape[-2]
    n_sms, smem_optin = ck.device_limits(amp.device.index if amp.device.index is not None
                                         else torch.cuda.current_device())
    return ck.gl_round_plan(amp.numel() // (T * amp.shape[-1]), T, n_fft, hop_length,
                            smem_optin, n_sms)


def rounds(S: torch.Tensor, amp: torch.Tensor, project, n_iter: int,
           momentum: float) -> torch.Tensor:
    """The ``n_iter - 1`` rounds of Griffin-Lim from the complex spectrogram
    S: ``project`` (istft -> stft), Fast Griffin-Lim momentum when nonzero,
    keep the phase and put back the magnitudes ``amp``."""
    P_prev = torch.zeros_like(S) if momentum != 0.0 else None
    for _ in range(max(n_iter - 1, 0)):
        P = project(S)
        if momentum != 0.0:
            P, P_prev = P + momentum * (P - P_prev), P
        S = amp * (P / torch.clamp(torch.abs(P), min=_TINY))
    return S


def from_power_to_wav(P: torch.Tensor, P_dB_norm_factor: float = 0.01,
                      pre_emphasis: float = 0.97, hop_length: int = 80,
                      win_length: int = 400, mean_abs_amp_norm: float = 0.01,
                      n_iter: int = 200, n_fft: int | None = None, realse: float = 1.0,
                      generator: torch.Generator | None = None,
                      init_phase: torch.Tensor | None = None, momentum: float = 0.0,
                      dft: str = "fft", frames=None) -> torch.Tensor:
    """Normalized power_dB maps [..., T, n_stft] -> waveforms [..., (T-1)*hop].

    With ``frames``, P is [B, T, n_stft] with row b's first ``frames[b]``
    frames its own: row b's first (frames[b]-1)*hop samples are
    `from_power_to_wav` of the row alone, zeros after (``init_phase``
    [B, T, n_stft] then holds each row's draw in its own frames).
    """
    n_fft = win_length if n_fft is None else n_fft
    row_frames = row_samples = counts = valid = None
    if frames is not None:
        row_frames = [int(n) for n in frames]
        row_samples = [(n - 1) * hop_length for n in row_frames]
        counts = torch.tensor([row_frames, row_samples], device=P.device)  # one copy to the device
        valid = (torch.arange(P.shape[-2], device=P.device) < counts[0][:, None])[..., None]
    amp = magnitudes(P, P_dB_norm_factor, realse,
                     functools.partial(clip_means, counts=row_frames), valid)
    y, _ = _griffin_lim(amp, win_length, hop_length, n_iter, n_fft, "hann", generator,
                        init_phase, momentum, dft, counts)
    y = finish(y, pre_emphasis, mean_abs_amp_norm,
               functools.partial(clip_means, counts=row_samples))
    if counts is None:
        return y
    return torch.where(torch.arange(y.shape[-1], device=P.device) < counts[1][:, None], y, 0.0)


def magnitudes(P: torch.Tensor, P_dB_norm_factor: float, realse: float, means,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Power dB -> Griffin-Lim's magnitudes: the dB floor at 0, the
    ``realse`` sharpening renormed to each clip's mean power (``means``),
    dB denorm; zero where ``valid`` is false."""
    P = torch.clamp(P, min=0.0)
    if valid is not None:
        P = torch.where(valid, P, 0.0)
    if realse != 1.0:
        p_mean = means(P, 2)
        P = P**realse
        P = (p_mean / means(P, 2)) * P
    amp = torch.sqrt(db_to_power(P / P_dB_norm_factor - 80.0))
    return amp if valid is None else torch.where(valid, amp, 0.0)


def finish(y: torch.Tensor, pre_emphasis: float, mean_abs_amp_norm: float,
           means) -> torch.Tensor:
    """Inverse pre-emphasis, then each clip to mean |y| ``mean_abs_amp_norm``."""
    if pre_emphasis != 0.0:
        y = inv_preemphasis(y, pre_emphasis)
    return y * (mean_abs_amp_norm / means(torch.abs(y), 1))


def clip_means(x: torch.Tensor, ndim: int, counts=None) -> torch.Tensor:
    """Mean over the last ``ndim`` axes of each clip, keeping them as 1s: one
    reduction a clip, as a single clip's conversion makes it (with
    ``counts``, over the clip's first ``counts[i]`` entries of axis -ndim,
    its own part of a ragged batch). A reduction over several clips at once
    splits its sums by the clip count on a CUDA device, and Griffin-Lim's
    200 rounds carry such a last-bit difference in a renorm factor up to
    tens of PCM steps."""
    lead, tail = x.shape[:x.dim() - ndim], x.shape[x.dim() - ndim:]
    clips = x.reshape(-1, *tail).unbind(0)
    means = [c.mean() if counts is None else c[:int(n)].mean() for c, n in
             zip(clips, counts if counts is not None else clips)]
    return torch.stack(means).reshape(*lead, *(1,) * ndim)
