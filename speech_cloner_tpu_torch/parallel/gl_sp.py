"""Sequence-parallel Griffin-Lim: the vocoder loop with the time axis sharded
over a 1-D `Mesh`.

Counterpart of ``speech_cloner_tpu/parallel/gl_sp.py``. Each shard holds
T_loc frames and runs its own inverse and forward STFTs, on the single-device
vocoder's pieces (``ops.stft``'s `frame`, `overlap_add` and
`window_envelope`, ``ops.griffin_lim``'s `finish`); per round, the
overlap-add crosses a shard boundary as one (n_fft - hop)-sample tail sent
to the right neighbor, and the re-framing borrows as many samples back from
it (a copy to the neighbor's device; nothing when they share one). The
reflect padding of the centered STFT touches only the first and last
ceil(n_fft / 2 / hop) frames: the edge shards recompute those, so every
frame of every round equals the single-device loop's up to float addition
order. Only the last shard's overlap tail is real; the waveform is joined on
the first shard's device at the end.

Requires hop | n_fft, n_fft == win_length and T_loc * hop > 2 * (n_fft // 2)
(true for every shipped config: 400 / 80).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.db import db_to_power
from ..ops.griffin_lim import clip_means, finish
from ..ops.stft import frame, overlap_add, window_envelope
from ..ops.windows import get_window, pad_center
from .mesh import Mesh

_TINY = float(np.finfo(np.float32).tiny)


def _shards(x, mesh: Mesh) -> list[torch.Tensor]:
    """[T, ...] -> one float32 block of T / n rows per mesh device (a list of
    shards passes through)."""
    if isinstance(x, (list, tuple)):
        return [torch.as_tensor(s, dtype=torch.float32) for s in x]
    x = x.to(torch.float32) if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.float32)
    n = mesh.size
    per = x.shape[0] // n
    return [x[i * per:(i + 1) * per].to(d, non_blocking=True)
            for i, d in enumerate(mesh.device_list())]


def griffin_lim_seq_parallel(stft_amp, mesh: Mesh, *, win_length: int = 400,
                             hop_length: int = 80, num_iters: int = 200,
                             n_fft: int | None = None, window: str = "hann",
                             generator: torch.Generator | None = None, init_phase=None,
                             momentum: float = 0.0) -> torch.Tensor:
    """Sharded Griffin-Lim: time-major magnitude [T, F] (a tensor, or its
    shards on the mesh's devices) -> waveform [T*hop - hop] on the first
    device. T must divide by the mesh size. The initial phase is
    ``init_phase`` [T, F], or pi * uniform from ``generator`` on the first
    device; results match ``ops.griffin_lim`` given the same phase."""
    n_fft = n_fft or win_length
    if n_fft % hop_length or n_fft != win_length:
        raise ValueError("hop | n_fft and n_fft == win_length required")
    devs = mesh.device_list()
    n = len(devs)
    if not isinstance(stft_amp, (list, tuple)) and stft_amp.shape[0] % n:
        raise ValueError(f"frame count {stft_amp.shape[0]} must divide by mesh size {n}")
    amp = _shards(stft_amp, mesh)
    T_loc, F = amp[0].shape
    T = n * T_loc
    hop, half = hop_length, n_fft // 2
    if T_loc * hop <= 2 * half:
        raise ValueError(f"shard too short for edge reflection: T_loc={T_loc}")
    if init_phase is None:
        init_phase = math.pi * torch.rand((T, F), generator=generator, device=devs[0],
                                          dtype=torch.float32)
    phase0 = _shards(init_phase, mesh)

    win_np = pad_center(get_window(window, n_fft), n_fft)
    win = [torch.tensor(win_np, dtype=torch.float32, device=d) for d in devs]
    env = window_envelope(window, T, hop, win_length, n_fft, devs[0])
    body_len, tail_len = T_loc * hop, n_fft - hop
    env_body = [env[i * body_len:(i + 1) * body_len].to(d) for i, d in enumerate(devs)]
    env_tail = env[T * hop:].to(devs[-1])
    n_fix = -(-half // hop)  # frames touching the reflected region

    def istft_sp(S: list[torch.Tensor]):
        """(divided bodies [T_loc*hop] per shard, the last shard's divided tail)."""
        ola = [overlap_add(torch.fft.irfft(s, n=n_fft, dim=1) * w, hop) for s, w in zip(S, win)]
        bodies = []
        for i, o in enumerate(ola):
            body = o[:body_len]
            if i > 0:   # the left neighbor's tail flows rightward
                body = torch.cat([body[:tail_len] + ola[i - 1][body_len:].to(body.device,
                                                                                non_blocking=True),
                                  body[tail_len:]])
            bodies.append(body / env_body[i])
        return bodies, ola[-1][body_len:] / env_tail

    def reframe_sp(bodies: list[torch.Tensor], tail_div: torch.Tensor):
        frames_all = []
        for i, body in enumerate(bodies):
            # extension: the right neighbor's first tail_len samples, or
            # (last shard) its own divided tail
            ext = tail_div if i == n - 1 else bodies[i + 1][:tail_len].to(body.device,
                                                                           non_blocking=True)
            frames = frame(torch.cat([body, ext]), n_fft, hop)
            # global frame t reads y_trim[t*hop - half : t*hop - half + n_fft],
            # y_trim = y_untrim[half : -half]; interior frames are the rows above
            if i == 0:
                # y_pad = [reflect pad | y_untrim[half:]]: pad = y_trim[1 : half+1]
                # reversed = y_untrim[half+1 : 2*half+1] reversed
                y_start = torch.cat([body[half + 1:2 * half + 1].flip(0), body[half:], ext])
                frames = torch.cat([torch.stack([y_start[t * hop:t * hop + n_fft]
                                                 for t in range(n_fix)]), frames[n_fix:]])
            if i == n - 1:
                # y_trim ends at local untrimmed L - half; suffix pad =
                # y_trim[-half-1 : -1] reversed
                y_end = torch.cat([body, tail_div])
                trim_end = body_len + tail_len - half
                y_endp = torch.cat([y_end[:trim_end],
                                    y_end[trim_end - half - 1:trim_end - 1].flip(0)])
                rows = [y_endp[t * hop:t * hop + n_fft] for t in range(T_loc - n_fix, T_loc)]
                frames = torch.cat([frames[:T_loc - n_fix], torch.stack(rows)])
            frames_all.append(frames)
        return frames_all

    def project(S):
        frames = reframe_sp(*istft_sp(S))
        return [torch.fft.rfft(f * w, n=n_fft, dim=1) for f, w in zip(frames, win)]

    def replace_mag(S2, a):
        return a * (S2 / torch.clamp(torch.abs(S2), min=_TINY))

    S = [torch.polar(a, p) for a, p in zip(amp, phase0)]
    P_prev = [torch.zeros_like(s) for s in S] if momentum != 0.0 else None
    for _ in range(max(num_iters - 1, 0)):
        P = project(S)
        if momentum != 0.0:
            P, P_prev = [p + momentum * (p - q) for p, q in zip(P, P_prev)], P
        S = [replace_mag(p, a) for p, a in zip(P, amp)]
    bodies, tail = istft_sp(S)
    y_untrim = torch.cat([b.to(devs[0]) for b in bodies] + [tail.to(devs[0])])
    return y_untrim[half:y_untrim.shape[0] - half]


def from_power_to_wav_seq_parallel(P_dB, mesh: Mesh, *, P_dB_norm_factor: float = 0.01,
                                   pre_emphasis: float = 0.97, hop_length: int = 80,
                                   win_length: int = 400, mean_abs_amp_norm: float = 0.045,
                                   n_iter: int = 200, n_fft: int | None = None,
                                   realse: float = 1.0, generator: torch.Generator | None = None,
                                   init_phase=None, momentum: float = 0.0) -> torch.Tensor:
    """Sharded ``ops.from_power_to_wav``: power_dB [T, F] (a tensor, or its
    shards) -> waveform on the first device; the ``realse`` means are over
    the whole spectrogram."""
    Pc = [torch.clamp(s, min=0.0) for s in _shards(P_dB, mesh)]
    first = mesh.device_list()[0]

    def global_mean(parts):
        return sum(p.sum().to(first) for p in parts) / sum(p.numel() for p in parts)
    if realse != 1.0:
        p_mean = global_mean(Pc)
        Pc = [p**realse for p in Pc]
        scale = p_mean / global_mean(Pc)
        Pc = [scale.to(p.device) * p for p in Pc]
    F = [torch.sqrt(db_to_power(p / P_dB_norm_factor - 80.0)) for p in Pc]
    y = griffin_lim_seq_parallel(F, mesh, win_length=win_length, hop_length=hop_length,
                                 num_iters=n_iter, n_fft=n_fft, generator=generator,
                                 init_phase=init_phase, momentum=momentum)
    return finish(y, pre_emphasis, mean_abs_amp_norm, clip_means)
