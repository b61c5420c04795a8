"""Training and evaluation metrics (counterpart of
``speech_cloner_tpu/train/metrics.py``), on tensors."""

from __future__ import annotations

import math

import torch

from ..ops.mel import dct_basis


def softmax_xent(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with (possibly soft) label distributions."""
    return -torch.mean(torch.sum(target_probs * torch.log_softmax(logits, dim=-1), dim=-1))


def frame_accuracy(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    pred, lbl = torch.argmax(logits, dim=-1), torch.argmax(target_probs, dim=-1)
    return torch.mean((pred == lbl).to(torch.float32))


def probs_mse(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(torch.softmax(logits, dim=-1) - target_probs))


def confusion_matrix(logits: torch.Tensor, target_probs: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """[n_classes, n_classes] float counts, rows true, columns predicted."""
    pred = torch.argmax(logits, dim=-1).reshape(-1)
    lbl = torch.argmax(target_probs, dim=-1).reshape(-1)
    flat = torch.zeros(n_classes * n_classes, dtype=torch.float32, device=logits.device)
    flat.index_add_(0, lbl * n_classes + pred, torch.ones_like(pred, dtype=torch.float32))
    return flat.reshape(n_classes, n_classes)


def weighted_mse(pred: torch.Tensor, target: torch.Tensor, weight: float) -> torch.Tensor:
    return weight * torch.mean(torch.square(pred - target))


def mel_cepstral_distortion(mel_db_true: torch.Tensor, mel_db_pred: torch.Tensor, *,
                            n_coeffs: int = 13, db_norm_factor: float = 0.01) -> torch.Tensor:
    """Mean mel-cepstral distortion (dB) between two normalized mel_dB maps
    [..., T, n_mels]: (10/ln10) sqrt(2 sum_{k=1..K} (c_k - c'_k)^2) per
    frame, c the orthonormal DCT-II of the log-mel spectrum without c_0
    (the JAX function's definition and scale caveat)."""
    n_mels = mel_db_true.shape[-1]
    D = torch.tensor(dct_basis(n_coeffs + 1, n_mels)[1:], dtype=torch.float32,
                     device=mel_db_true.device)                           # [K, n_mels]
    a = (mel_db_true / (10.0 * db_norm_factor)) @ D.T
    b = (mel_db_pred / (10.0 * db_norm_factor)) @ D.T
    per_frame = (10.0 / math.log(10.0)) * torch.sqrt(2.0 * torch.sum(torch.square(a - b), -1))
    return torch.mean(per_frame)
