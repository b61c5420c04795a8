"""Device-resident feature store and the window gather on the device.

Counterpart of ``speech_cloner_tpu/data/device_dataset.py``. The host
samplers send whole feature windows to the card every step (32 x 400 x 361
float32, 18 MB a decoder step); this store puts the (filtered) feature
cache on the device once, as padded [N, F_max, C] float32 tensors, and cuts
the training windows there, so a step sends two int32 vectors.

The gather is one indexed read per stream,
``stream[utt[:, None], start[:, None] + arange(T)]``, plain PyTorch: the
JAX package computes it with ``vmap(dynamic_slice)`` outside any Pallas
kernel. As ``dynamic_slice`` does, it clamps each start to
``[0, F_max - T]``; short utterances start at 0 and read the store's zero
padding, as the host samplers pad them.

The samplers draw from the caller's rng as the JAX ones do (one
permutation per pass, then the starts), so the same seed cuts the same
windows as the JAX loader.
"""

from __future__ import annotations

import numpy as np
import torch

from .dataset import FeatureCache, window_index_batches


def gather_windows(streams, utt_idx, start, T: int) -> tuple[torch.Tensor, ...]:
    """[B] utterance ids + [B] start frames -> one [B, T, C] window tensor
    per padded [N, F_max, C] stream, on the streams' device."""
    dev = streams[0].device
    utt = torch.as_tensor(utt_idx, device=dev).long()
    s0 = torch.as_tensor(start, device=dev).long().clamp(0, streams[0].shape[1] - T)
    rows = s0[:, None] + torch.arange(T, device=dev)
    return tuple(s[utt[:, None], rows] for s in streams)


class DeviceWindows:
    """Padded per-stream tensors on ``device`` and their window gather."""

    def __init__(self, utts_per_stream: list[list[np.ndarray]], T: int, device="cuda"):
        """``utts_per_stream``: for each stream, a list of [frames_i, C]
        arrays (the same frames_i in every stream for one utterance)."""
        lens = np.asarray([a.shape[0] for a in utts_per_stream[0]], np.int32)
        F_max = max(int(lens.max()), T)
        self.T = T
        self.n_frames = lens
        self.streams = []
        for utts in utts_per_stream:
            buf = np.zeros((len(utts), F_max, utts[0].shape[1]), np.float32)
            for i, a in enumerate(utts):
                buf[i, :a.shape[0]] = a
            self.streams.append(torch.from_numpy(buf).to(device))

    @property
    def nbytes(self) -> int:
        return sum(s.numel() * s.element_size() for s in self.streams)

    def gather(self, utt_idx, start) -> tuple[torch.Tensor, ...]:
        """[B] utterance ids + [B] start frames -> tuple of [B, T, C] windows."""
        return gather_windows(self.streams, utt_idx, start, self.T)

    def index_sampler(self, samples: np.ndarray, batch_size: int, n_epochs: int = 1,
                      rng=None, randomize: bool = True):
        """(utt_idx [B], start [B]) int32 batches: one random crop per
        utterance of ``samples`` (positions on the store's utterance axis)
        per pass."""
        return window_index_batches(self.n_frames, samples, batch_size, self.T, n_epochs, rng,
                                    randomize)

    def file_batch_sampler(self, samples: np.ndarray, batch_size: int, n_epochs: int = 1,
                           rng=None, randomize: bool = True):
        """The target-speaker sampling: each batch is ``batch_size`` random
        crops of ONE utterance, files in (permuted) order, files no longer
        than a window skipped; an audiobook has few long files, which
        per-utterance batches would starve on."""
        rng = rng or np.random.default_rng(0)
        samples = np.asarray(samples)
        for _ in range(n_epochs):
            order = rng.permutation(samples) if randomize else samples
            for i in order:
                n = int(self.n_frames[int(i)])
                if n <= self.T:
                    continue
                yield (np.full(batch_size, int(i), np.int32),
                       rng.integers(0, n - self.T, size=batch_size).astype(np.int32))


def from_npz(npz_path: str, streams, utt_ids: np.ndarray, T: int, device="cuda") -> DeviceWindows:
    """The given utterances of an ``.npz`` feature cache, on ``device``."""
    with FeatureCache(npz_path) as cache:
        cols = [[cache[s, int(i)] for i in utt_ids] for s in streams]
    return DeviceWindows(cols, T, device=device)
