"""STFT / ISTFT with librosa-compatible semantics, on tensors.

Counterpart of ``speech_cloner_tpu/ops/stft.py``: center=True reflect
padding of n_fft//2, periodic window zero-padded to n_fft, real DFT per
frame; istft with squared-window overlap-add normalization and n_fft//2
trim. Layout is time-major [T, F], as in the JAX package, with any leading
axes (a batch of clips, [B, T, F]) carried through: each clip is transformed
on its own, and the DFT matmuls run over all clips' frames at once.

Two DFT forms, as there: ``dft="fft"`` uses ``torch.fft``; ``dft="matmul"``
multiplies by the same float64-built, float32-stored cos/sin bases the JAX
package uses (`_dft_mats`). The transform is written out here rather than
taken from ``torch.stft``, which agrees with the JAX transform only to about
2e-3. Constant tensors (window, bases, window envelope) are built once per
shape and device.

One overlap-add (`overlap_add`) serves every inverse: shifted slices in the
JAX package's order where hop | n_fft, one ``F.fold`` elsewhere. The pair
also transforms a ragged batch, rows of their own frame counts padded to
the longest, each as it is alone: `istft` divides by each row's own
envelope (`row_envelopes`) and `stft` pads each row at its own end
(`reflect_index`); the padding's frames are the caller's to zero.
`frame`, `overlap_add` and `window_envelope` are also the pieces of the
sequence-parallel loop (``parallel/gl_sp.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .windows import get_window, pad_center

_TINY = float(np.finfo(np.float32).tiny)


def frame(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[..., L] -> [..., 1 + (L - n_fft)//hop, n_fft] frames at stride ``hop`` (a view)."""
    return y.unfold(-1, n_fft, hop)


@functools.lru_cache(maxsize=None)
def _dft_mats_np(n_fft: int):
    """Real rfft/irfft as four [F, N] bases, built in float64, stored float32
    (the JAX package's `_dft_mats`, value for value)."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    fwd_re = np.cos(ang).astype(np.float32)
    fwd_im = (-np.sin(ang)).astype(np.float32)
    c = np.full(n_fft // 2 + 1, 2.0)                  # hermitian fold-back weights
    c[0] = 1.0
    if n_fft % 2 == 0:
        c[-1] = 1.0
    inv_re = ((c[:, None] * np.cos(ang)) / n_fft).astype(np.float32)
    inv_im = ((-(c[:, None] * np.sin(ang))) / n_fft).astype(np.float32)
    return fwd_re, fwd_im, inv_re, inv_im


@functools.lru_cache(maxsize=32)
def _dft_mats(n_fft: int, device: torch.device):
    """(fwd_re.T [N, F], fwd_im.T [N, F], inv_re [F, N], inv_im [F, N]) on ``device``."""
    fwd_re, fwd_im, inv_re, inv_im = _dft_mats_np(n_fft)
    t = functools.partial(torch.tensor, device=device)
    return (t(np.ascontiguousarray(fwd_re.T)), t(np.ascontiguousarray(fwd_im.T)),
            t(inv_re), t(inv_im))


@functools.lru_cache(maxsize=32)
def _window(window: str, win_length: int, n_fft: int, device: torch.device) -> torch.Tensor:
    win = pad_center(get_window(window, win_length), n_fft)
    return torch.tensor(win, dtype=torch.float32, device=device)


def _rfft(frames: torch.Tensor, n_fft: int, dft: str) -> torch.Tensor:
    if dft == "fft":
        return torch.fft.rfft(frames, n=n_fft, dim=-1)
    if dft != "matmul":
        raise ValueError(f"unknown dft {dft!r}; expected 'fft' or 'matmul'")
    fwd_re_t, fwd_im_t, _, _ = _dft_mats(n_fft, frames.device)
    return torch.complex(frames @ fwd_re_t, frames @ fwd_im_t)


def _irfft(S: torch.Tensor, n_fft: int, dft: str) -> torch.Tensor:
    if dft == "fft":
        return torch.fft.irfft(S, n=n_fft, dim=-1)
    if dft != "matmul":
        raise ValueError(f"unknown dft {dft!r}; expected 'fft' or 'matmul'")
    _, _, inv_re, inv_im = _dft_mats(n_fft, S.device)
    return S.real @ inv_re + S.imag @ inv_im


def stft(y: torch.Tensor, n_fft: int = 400, hop_length: int = 80,
         win_length: int | None = None, window: str = "hann", center: bool = True,
         dft: str = "fft", reflect_index: torch.Tensor | None = None) -> torch.Tensor:
    """Complex STFT of float32 signals [..., L] -> [..., T, 1 + n_fft//2] (time-major).

    With ``reflect_index`` (`reflect_index` of each row's length) the
    centered padding is gathered at each row's own end.
    """
    if win_length is None:
        win_length = n_fft
    win = _window(window, win_length, n_fft, y.device)
    if reflect_index is not None:
        y = y.gather(-1, reflect_index)
    elif center:
        padded = F.pad(y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect")
        y = padded.reshape(*y.shape[:-1], -1)
    frames = frame(y, n_fft, hop_length) * win[None, :]
    return _rfft(frames, n_fft, dft)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add [..., T, n_fft] frames at stride ``hop`` -> [..., (T-1)*hop + n_fft].

    When hop | n_fft the frames are viewed as [..., T, k, hop] and the k
    diagonals are summed as shifted slices, in the JAX package's order (the
    order csrc/griffin_lim.cu keeps); otherwise one col2im (``F.fold``)
    sums each output sample's frames.
    """
    *lead, n_frames, n_fft = frames.shape
    if n_fft % hop:
        out_len = (n_frames - 1) * hop + n_fft
        cols = frames.reshape(-1, n_frames, n_fft).transpose(1, 2)
        return F.fold(cols, output_size=(1, out_len), kernel_size=(1, n_fft),
                      stride=(1, hop)).reshape(*lead, out_len)
    k = n_fft // hop
    f = F.pad(frames, (0, 0, k - 1, k - 1)).reshape(*lead, n_frames + 2 * (k - 1), k, hop)
    n_out_chunks = n_frames + k - 1
    acc = f[..., k - 1 : k - 1 + n_out_chunks, 0, :]
    for j in range(1, k):
        acc = acc + f[..., k - 1 - j : k - 1 - j + n_out_chunks, j, :]
    return acc.reshape(*lead, n_out_chunks * hop)


@functools.lru_cache(maxsize=32)
def _window_sumsquare(window: str, n_frames: int, hop_length: int, win_length: int,
                      n_fft: int, device: torch.device) -> torch.Tensor:
    win = pad_center(get_window(window, win_length), n_fft)
    sq = torch.tensor(np.broadcast_to(win * win, (n_frames, n_fft)).copy())
    return overlap_add(sq, hop_length).to(torch.float32).to(device)


def window_sumsquare(window: str, n_frames: int, hop_length: int, win_length: int,
                     n_fft: int, device="cpu") -> torch.Tensor:
    """Sum of squared windows across frames (librosa filters.window_sumsquare),
    summed in float64 and stored float32."""
    return _window_sumsquare(window, n_frames, hop_length, win_length, n_fft,
                             torch.device(device))


@functools.lru_cache(maxsize=32)
def window_envelope(window: str, n_frames: int, hop_length: int, win_length: int,
                    n_fft: int, device: torch.device) -> torch.Tensor:
    """`istft`'s divisor: `window_sumsquare`, 1 where it is not above
    float32 ``tiny`` (a division there leaves the sample as it is)."""
    wss = _window_sumsquare(window, n_frames, hop_length, win_length, n_fft, device)
    return torch.where(wss > _TINY, wss, 1.0)


def istft(S: torch.Tensor, hop_length: int = 80, win_length: int | None = None,
          n_fft: int | None = None, window: str = "hann", center: bool = True,
          length: int | None = None, dft: str = "fft",
          envelope: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse STFT of time-major complex spectrograms [..., T, 1 + n_fft//2] -> [..., L].

    Windowed inverse real DFT per frame, `overlap_add`, division by the
    envelope (`window_envelope`, or ``envelope``: `row_envelopes` of ragged
    rows), and an n_fft//2 trim at both ends when center=True.
    """
    if n_fft is None:
        n_fft = 2 * (S.shape[-1] - 1)
    if win_length is None:
        win_length = n_fft
    win = _window(window, win_length, n_fft, S.device)
    if envelope is None:
        envelope = window_envelope(window, S.shape[-2], hop_length, win_length, n_fft, S.device)
    y = overlap_add(_irfft(S, n_fft, dft) * win[None, :], hop_length) / envelope
    if center:
        y = y[..., n_fft // 2 : y.shape[-1] - n_fft // 2]
    if length is not None:
        y = y[..., :length]
    return y


def row_envelopes(frames: torch.Tensor, T: int, hop_length: int, win_length: int, n_fft: int,
                  window: str = "hann") -> torch.Tensor:
    """[B, (T-1)*hop + n_fft] `istft` envelopes of rows of ``frames[b]``
    frames (a tensor on the rows' device), T the most: each row's own
    squared-window envelope (`window_sumsquare`'s, summed in float32 here),
    1 where it is not above float32 ``tiny`` and past the row's end."""
    win = _window(window, win_length, n_fft, frames.device)
    live = (torch.arange(T, device=frames.device) < frames[:, None]).to(win.dtype)   # [B, T]
    env = overlap_add(live[:, :, None] * (win * win)[None, None, :], hop_length)
    return torch.where(env > _TINY, env, 1.0)


def reflect_index(samples: torch.Tensor, L: int, n_fft: int) -> torch.Tensor:
    """[B, L + n_fft] gather indices of each row's centered, reflect-padded
    signal (`stft`'s ``F.pad(..., mode="reflect")`` at the row's own end,
    ``samples[b]`` long, a tensor on the rows' device), L the longest;
    positions past a row's padded end repeat its last sample."""
    p = torch.arange(L + n_fft, device=samples.device) - n_fft // 2
    n = samples[:, None]
    idx = torch.where(p < 0, -p, torch.where(p >= n, 2 * (n - 1) - p, p))
    return idx.clamp(min=0).minimum(n - 1)
