"""Streaming evaluators (counterpart of ``speech_cloner_tpu/train/evaluate.py``):
batched prediction, frame accuracy, decoder losses with mel-cepstral
distortion, confusion counts. Models run in eval mode without gradient;
batches are numpy arrays and go to the model's device."""

from __future__ import annotations

import numpy as np
import torch

from .metrics import confusion_matrix, mel_cepstral_distortion
from .steps import DecoderLossConfig, _decoder_loss, _on, _wide, encoder_ppg


@torch.no_grad()
def encoder_predict(model, x: np.ndarray, batch_size: int = 32) -> np.ndarray:
    """Posteriors over [N, T, E] host windows -> [N, T, n_out]."""
    outs = [torch.softmax(_wide(model(_on(x[i:i + batch_size], model))), -1).cpu().numpy()
            for i in range(0, x.shape[0], batch_size)]
    return np.concatenate(outs, axis=0)


@torch.no_grad()
def decoder_predict(model, x: np.ndarray, *, encoder, batch_size: int = 32):
    """(y_mel, y_stft, y_phn) over [N, T, E] MFCC windows; y_phn is the PPG
    fed to step1."""
    mels, stfts, phns = [], [], []
    for i in range(0, x.shape[0], batch_size):
        ppg = encoder_ppg(encoder, x[i:i + batch_size])
        y_mel, y_stft = model(_on(ppg, model))
        mels.append(y_mel.cpu().numpy())
        stfts.append(y_stft.cpu().numpy())
        phns.append(ppg.cpu().numpy())
    return np.concatenate(mels), np.concatenate(stfts), np.concatenate(phns)


@torch.no_grad()
def eval_acc(model, sampler, verbose: bool = False):
    """Streaming frame accuracy over (mfcc, phn_onehot) batches: (acc, frames)."""
    n_c = n_t = 0
    for mfcc, phn, *_ in sampler:
        pred = torch.argmax(model(_on(mfcc, model)), dim=-1).cpu().numpy()
        true = np.argmax(phn, axis=-1)
        n_c += int((pred == true).sum())
        n_t += pred.size
        if verbose:
            print(f"acc[{n_t}] = {n_c / n_t:5.03f}")
    return (n_c / n_t if n_t else 0.0), n_t


@torch.no_grad()
def eval_loss(model, sampler, *, encoder, loss_cfg: DecoderLossConfig = DecoderLossConfig(),
              verbose: bool = False):
    """Streaming decoder losses over (mfcc, mel, stft) batches: (mean loss,
    mean mel_loss, mean stft_loss, mean mcd_db)."""
    acc = []
    for mfcc, mel, stft, *_ in sampler:
        mel, stft = _on(mel, model), _on(stft, model)
        y_mel, y_stft = model(_on(encoder_ppg(encoder, mfcc), model))
        loss, mel_l, stft_l = _decoder_loss(y_mel, y_stft, mel, stft, loss_cfg)
        acc.append([float(v) for v in (loss, mel_l, stft_l,
                                        mel_cepstral_distortion(mel, y_mel))])
        if verbose:
            m = np.mean(acc, axis=0)
            print(f" - loss={m[0]:.3f} mel={m[1]:.3f} stft={m[2]:.3f} mcd={m[3]:.2f}dB")
    m = np.mean(acc, axis=0) if acc else np.zeros(4)
    return float(m[0]), float(m[1]), float(m[2]), float(m[3])


@torch.no_grad()
def eval_confusion(model, sampler, *, max_batches: int | None = None) -> np.ndarray:
    """Streaming [n_out, n_out] confusion counts (rows true, columns
    predicted) over (mfcc, phn_onehot) batches."""
    n = model.cfg.n_output
    cm = np.zeros((n, n), np.float64)
    for b, (mfcc, phn, *_) in enumerate(sampler):
        cm += confusion_matrix(model(_on(mfcc, model)), _on(phn, model), n).cpu().numpy()
        if max_batches is not None and b + 1 >= max_batches:
            break
    return cm


def top_confusions(cm: np.ndarray, idx2name: dict[int, str] | None = None, k: int = 10):
    """Most-confused off-diagonal (true, pred) pairs with rates, from a
    confusion-count matrix: [(true, pred, count, rate_of_true), ...]."""
    cm = np.asarray(cm, np.float64)
    off = cm.copy()
    np.fill_diagonal(off, 0.0)
    row_tot = cm.sum(axis=1)
    out = []
    for f in np.argsort(off, axis=None)[::-1][:k]:
        i, j = divmod(int(f), cm.shape[1])
        if off[i, j] <= 0:
            break
        name_i = idx2name[i] if idx2name else str(i)
        name_j = idx2name[j] if idx2name else str(j)
        out.append((name_i, name_j, int(off[i, j]), float(off[i, j] / max(row_tot[i], 1.0))))
    return out
