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

`from_power_to_wav_rows` vocodes a ragged batch, each row at its own frame
count (the text-to-speech path's sentences): its frames past a row's count
hold no magnitude, each round's transforms treat each row at its own
length (`ops.stft` `istft_rows`, `stft_rows`), and every reduction is over
the row's own frames or samples, so a row gives what `from_power_to_wav`
gives it alone, in one batch of launches for all rows. The two share the
rounds (`rounds`), the magnitudes (`magnitudes`), the output norm
(`finish`) and the per-clip means (`clip_means`); only the transforms
differ. The voice-conversion path keeps `istft` / `stft`, whose
overlap-add sums in the JAX package's order over a float64-summed window
envelope, because its bits and launches are the ones its benchmark cells
were measured with: on rows of one length the ragged transforms agree with
them to about 2e-6 of the peak, not to the bit (the port's CPU tests pass
either way).

On a CUDA card, the rounds of `griffin_lim` with the matmul DFT and no
momentum run in a hand-written kernel, one launch a round
(``csrc/griffin_lim.cu``, `cuda_kernels.gl_rounds`): inverse DFT,
overlap-add, envelope, reflect padding, forward DFT and projection, float32
FFMA sums on the same bases, each a chain in k order as cuBLAS's (the
DC and Nyquist bins keep only X's sign, so their order shows). It engages only where `fused_round_plan` gives
a plan: a float32 CUDA tensor autograd does not record, ``dft="matmul"``,
``momentum == 0``, n_fft == win_length, a hop that divides n_fft, and a
shape the kernel takes (n_fft 400, hop 80, T >= 4). Everything else keeps
`rounds` with ``istft`` / ``stft``: the CPU (which also runs the kernel's
plain version, `cuda_kernels.gl_round_plain`, in the tests), ``dft="fft"``
(the stream, Tacotron, the long-form loop), Fast Griffin-Lim momentum (the
stream, training's vocoded augmentation), `from_power_to_wav_rows`'
ragged rows and `parallel.gl_sp`. Where a CUDA tensor meets the rule the
kernel runs or raises; nothing falls back. The initial `torch.polar` and
the final ``istft`` stay as they are.

`griffin_lim_dyn` / `from_power_to_wav_dyn` are the JAX package's forms with
the round count and momentum as traced run-time values (one executable for
every quality setting). Eager PyTorch takes both at run time anyway, so here
they are the static functions, taking a Python number or a 0-d tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cuda_kernels as ck
from .db import db_to_power
from .preemphasis import inv_preemphasis
from .stft import (_window, istft, istft_rows, reflect_index, row_envelopes, stft, stft_rows,
                   window_sumsquare)

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

    def inverse(S):
        return istft(S, hop_length=hop_length, win_length=win_length, n_fft=n_fft,
                     window=window, dft=dft)

    def project(S):
        return stft(inverse(S), n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                    window=window, dft=dft)

    S = torch.polar(stft_amp, phase0)
    plan = fused_round_plan(stft_amp, dft, momentum, n_fft, win_length, hop_length)
    if plan is None:
        S = rounds(S, stft_amp, project, num_iters, momentum)
    else:
        T, F = S.shape[-2:]
        S = ck.gl_rounds(S.reshape(-1, T, F), stft_amp.reshape(-1, T, F).contiguous(),
                         max(num_iters - 1, 0), _window(window, win_length, n_fft, S.device),
                         window_sumsquare(window, T, hop_length, win_length, n_fft, S.device),
                         plan).reshape(S.shape)
    wav = inverse(S)
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
    Fm = magnitudes(P, P_dB_norm_factor, realse, clip_means)
    y = griffin_lim(Fm, win_length, hop_length, num_iters=n_iter, n_fft=n_fft,
                    generator=generator, init_phase=init_phase, momentum=momentum,
                    unroll=unroll, dft=dft)
    return finish(y, pre_emphasis, mean_abs_amp_norm, clip_means)


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


def from_power_to_wav_rows(P: torch.Tensor, frames, P_dB_norm_factor: float = 0.01,
                           pre_emphasis: float = 0.97, hop_length: int = 80,
                           win_length: int = 400, mean_abs_amp_norm: float = 0.01,
                           n_iter: int = 200, n_fft: int | None = None, realse: float = 1.0,
                           init_phase: torch.Tensor | None = None, momentum: float = 0.0,
                           dft: str = "fft") -> torch.Tensor:
    """Ragged power_dB maps [B, T, n_stft], row b's first ``frames[b]``
    frames its own -> waveforms [B, (T-1)*hop], row b's first
    (frames[b]-1)*hop samples its own and zeros after: `from_power_to_wav`
    of each row alone, from ``init_phase`` [B, T, n_stft] (each row's draw
    in its own frames)."""
    n_fft = win_length if n_fft is None else n_fft
    T = P.shape[1]
    dev = P.device
    frames = [int(n) for n in frames]
    samples = [(n - 1) * hop_length for n in frames]
    counts = torch.tensor([frames, samples], device=dev)            # one copy to the device
    valid = (torch.arange(T, device=dev) < counts[0][:, None])[..., None]
    amp = magnitudes(P, P_dB_norm_factor, realse,
                     lambda x, ndim: clip_means(x, ndim, frames), valid)
    env = row_envelopes(counts[0], T, hop_length, win_length, n_fft)
    index = reflect_index(counts[1], (T - 1) * hop_length, n_fft)

    def inverse(S):
        return istft_rows(S, env, hop_length, win_length, n_fft, dft=dft)

    def project(S):
        return stft_rows(inverse(S), index, hop_length, win_length, n_fft, dft=dft)

    S = torch.polar(amp, torch.as_tensor(init_phase, dtype=torch.float32, device=dev))
    y = finish(inverse(rounds(S, amp, project, n_iter, momentum)), pre_emphasis,
               mean_abs_amp_norm, lambda x, ndim: clip_means(x, ndim, samples))
    kept = torch.arange(y.shape[-1], device=dev) < counts[1][:, None]
    return torch.where(kept, y, 0.0)
