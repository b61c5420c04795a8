"""Config files: reference-format cfg dicts -> the port's configs.

Counterpart of ``speech_cloner_tpu/runtime/config.py`` (``make_dir_path``,
``show_diff``, ``load_cfg_d``, ``save_cfg_d``, ``derive_audio_fields``,
``feature_config_from_cfg_d``; the reference's aux_func.py without its
interactive prompt: callers pass ``on_conflict``), plus the default dataset
cfg ``DEFAULT_DS_CFG`` of ``speech_cloner_tpu/apps/train_encoder.py``, and
`float32_products`, the card's numerics that every entry point sets.

The port's own: `tacotron_config_from_cfg_d` reads a text-to-speech
configuration ({"model", "features", "vocoder"}, the benchmark's
``perfbench/configs/tacotron_f32.json`` layout); `TACOTRON_AUDIO` is the
paper's audio (24 kHz, 50 ms windows, 12.5 ms hop, 2048-point FFT, 80 mel
bands, pre-emphasis 0.97) with the port's dB norm.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

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


TACOTRON_AUDIO = {
    "sample_rate": 24000, "pre_emphasis": 0.97, "hop_length_ms": 12.5, "win_length_ms": 50.0,
    "n_fft": 2048, "n_mels": 80, "window": "hann", "P_dB_norm_factor": 0.01,
}
TACOTRON_VOCODER = {"n_iter": 50, "realse": 1.2, "gl_momentum": 0.0, "gl_dft": "fft",
                    "mean_abs_amp_norm": 0.045}


def make_dir_path(path: str) -> None:
    if path:
        os.makedirs(path, exist_ok=True)


def show_diff(cfg_d: dict, old_cfg_d: dict, i_level: int = 0, out=print) -> int:
    """Print the differences of two cfg dicts, nested dicts indented, through
    ``out``; returns the number of changed leaves."""
    n_changes = 0
    pad = i_level * "    "
    for k in sorted(set(cfg_d) | set(old_cfg_d)):
        if k in cfg_d and k in old_cfg_d:
            if cfg_d[k] != old_cfg_d[k]:
                if isinstance(cfg_d[k], dict) and isinstance(old_cfg_d[k], dict):
                    out(f"{pad} |-> {k}")
                    n_changes += show_diff(cfg_d[k], old_cfg_d[k], i_level + 1, out)
                else:
                    out(f"{pad} |-> {k}: {old_cfg_d[k]!r} >>> {cfg_d[k]!r}")
                    n_changes += 1
        elif k not in cfg_d:
            out(f"{pad} |-> {k}: {old_cfg_d[k]!r} >>> ERASED")
            n_changes += 1
        else:
            out(f"{pad} |-> {k}: EMPTY >>> {cfg_d[k]!r}")
            n_changes += 1
    return n_changes


def load_cfg_d(cfg_path: str) -> dict[str, Any]:
    with open(cfg_path) as f:
        return json.load(f)


def save_cfg_d(cfg_d: dict, cfg_path: str,
               on_conflict: Callable[[dict, dict], bool] | str = "overwrite") -> bool:
    """Write ``cfg_d`` as JSON (indent 1, sorted keys). Where the file exists
    and holds another dict, ``on_conflict`` decides: "overwrite", "keep", or
    callable(new, old) -> write or not. Returns whether it wrote."""
    cfg_path = cfg_path.replace("\\", "/")
    make_dir_path(os.path.dirname(cfg_path))
    if os.path.exists(cfg_path):
        old = load_cfg_d(cfg_path)
        normalized = json.loads(json.dumps(cfg_d))
        if old == normalized or on_conflict == "keep":
            return False
        if callable(on_conflict) and not on_conflict(normalized, old):
            return False
    with open(cfg_path, "w") as f:
        json.dump(cfg_d, f, indent=1, sort_keys=True)
    return True


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


def tacotron_config_from_cfg_d(cfg_d: dict[str, Any]):
    """{"model", "features", "vocoder"} -> (models.tacotron.TacotronConfig,
    FeatureConfig of the audio, the `pipeline.tts.SynthesisPipeline` vocoder
    fields). A missing block or key takes the paper's value
    (`TACOTRON_AUDIO`, `TACOTRON_VOCODER`)."""
    from ..models.tacotron import config_from_cfg_d

    f = derive_audio_fields({**TACOTRON_AUDIO, **cfg_d.get("features", {})})
    feat = FeatureConfig(sample_rate=f["sample_rate"], pre_emphasis=f["pre_emphasis"],
                         hop_length=f["hop_length"], win_length=f["win_length"],
                         n_fft=f.get("n_fft"), n_mels=f["n_mels"], window=f["window"],
                         P_dB_norm_factor=f["P_dB_norm_factor"])
    v = {**TACOTRON_VOCODER, **cfg_d.get("vocoder", {})}
    vocoder = {"n_iter": int(v["n_iter"]), "realse": float(v["realse"]),
               "gl_momentum": float(v["gl_momentum"]), "gl_dft": v["gl_dft"],
               "mean_abs_amp_norm": float(v["mean_abs_amp_norm"])}
    model = config_from_cfg_d(cfg_d.get("model", {}))
    if model.n_stft != feat.n_stft or model.n_mels != feat.n_mels:
        raise ValueError(f"tacotron config: n_stft {model.n_stft} / n_mels {model.n_mels} "
                         f"against the audio's {feat.n_stft} / {feat.n_mels}")
    return model, feat, vocoder
