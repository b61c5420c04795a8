"""Config loading: reference-format cfg dicts -> the port's configs.

Counterpart of ``load_cfg_d``, ``derive_audio_fields`` and
``feature_config_from_cfg_d`` in ``speech_cloner_tpu/runtime/config.py``,
plus the default dataset cfg ``DEFAULT_DS_CFG`` of
``speech_cloner_tpu/apps/train_encoder.py``, and `float32_products`, the
card's numerics that every entry point sets.
"""

from __future__ import annotations

import json
from typing import Any

import torch

from ..ops.features import FeatureConfig


def float32_products(device) -> None:
    """On a CUDA ``device``, process-wide: TF32 off for cuDNN convolutions
    and matmuls, and no reduced-precision split-K sums in bf16 GEMMs -- the
    JAX package's float32 ("highest") products with float32 sums, which the
    parity limits assume (torch's default runs cuDNN convolutions in TF32).
    Nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

DEFAULT_DS_CFG = {
    "sample_rate": 16000, "pre_emphasis": 0.97, "hop_length_ms": 5.0,
    "win_length_ms": 25.0, "n_timesteps": 400, "n_mels": 80, "n_mfcc": 40,
    "n_fft": None, "window": "hann", "mfcc_normaleze_first_mfcc": True,
    "mfcc_norm_factor": 0.01, "calc_mfcc_derivate": True,
    "M_dB_norm_factor": 0.01, "P_dB_norm_factor": 0.01,
    "mean_abs_amp_norm": 0.003, "clip_output": True, "ds_norm": (0.0, 10.0),
}


def load_cfg_d(cfg_path: str) -> dict[str, Any]:
    with open(cfg_path) as f:
        return json.load(f)


def derive_audio_fields(cfg_d: dict[str, Any]) -> dict[str, Any]:
    """hop_length/win_length (samples) and n_stft from the ms-based fields.
    Returns a new dict."""
    d = dict(cfg_d)
    if "hop_length" not in d and "hop_length_ms" in d:
        d["hop_length"] = int(d["hop_length_ms"] * d["sample_rate"] / 1000.0)
    if "win_length" not in d and "win_length_ms" in d:
        d["win_length"] = int(d["win_length_ms"] * d["sample_rate"] / 1000.0)
    if "n_stft" not in d and "win_length" in d:
        n_fft = d.get("n_fft") or d["win_length"]
        d["n_stft"] = n_fft // 2 + 1
    return d


def feature_config_from_cfg_d(cfg_d: dict[str, Any]) -> FeatureConfig:
    """Reference-format ds cfg dict -> ops.FeatureConfig."""
    d = derive_audio_fields(cfg_d)
    return FeatureConfig(
        sample_rate=d["sample_rate"],
        pre_emphasis=d["pre_emphasis"],
        hop_length=d["hop_length"],
        win_length=d["win_length"],
        n_fft=d.get("n_fft"),
        n_mels=d["n_mels"],
        n_mfcc=d["n_mfcc"],
        window=d["window"],
        mfcc_normaleze_first_mfcc=d["mfcc_normaleze_first_mfcc"],
        mfcc_norm_factor=d["mfcc_norm_factor"],
        calc_mfcc_derivate=d["calc_mfcc_derivate"],
        M_dB_norm_factor=d["M_dB_norm_factor"],
        P_dB_norm_factor=d["P_dB_norm_factor"],
        mean_abs_amp_norm=d["mean_abs_amp_norm"],
        clip_output=d["clip_output"],
    )
