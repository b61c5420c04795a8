"""Conversion verification: did the clone change the speaker's identity?

Counterpart of ``speech_cloner_tpu/pipeline/verify.py``: the true and the
converted audio go through a trained speaker-ID checkpoint as power_dB
windows, and the report gives the posterior shift, with the JAX report's
keys, so ``apps.convert --verify-ckpt`` and ``apps.serve --verify-ckpt``
emit an objective verdict.

The checkpoint is a directory of ``speaker_id-<step>.npz`` with the
``speaker_id_cfg_d.json`` sidecar the trainers of either package write
(geometry and the speaker-class mapping ``spk_id_v``). The model runs on the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models import speaker_id as spk_m
from ..ops import mfcc_input
from ..runtime.checkpoint import Checkpointer
from ..runtime.jax_params import speaker_id_from_jax

# (abspath, device) -> (step, (model, cfg, spk_id_v)): only the newest step
# of each directory is kept, so a server verifying while a trainer keeps
# saving holds one model, not one per checkpoint
_MODEL_CACHE: dict = {}


def load_speaker_model(model_path: str, device="cuda"):
    """(model, cfg, spk_id_v) from a speaker-ID checkpoint directory, the
    model in eval use on ``device``. Cached by path and device; a newer
    step on disk replaces the cached one."""
    ck = Checkpointer(model_path, "speaker_id")
    key = (os.path.abspath(model_path), str(torch.device(device)))
    step_now = ck.latest_step()
    hit = _MODEL_CACHE.get(key)
    if hit is not None and hit[0] == step_now:
        return hit[1]
    tree, _ = ck.restore()
    if tree is None:
        raise FileNotFoundError(f"no speaker_id checkpoint under {model_path}")
    with open(os.path.join(model_path, "speaker_id_cfg_d.json")) as f:
        cfg_d = json.load(f)
    cfg = spk_m.SpeakerIdConfig(n_timesteps=int(cfg_d["n_timesteps"]),
                                n_features=int(cfg_d["n_features"]),
                                n_output=int(cfg_d["n_output"]),
                                time_fold=int(cfg_d.get("time_fold", 1)))
    model = speaker_id_from_jax(tree["params"], tree["model_state"], cfg, device)
    out = (model.requires_grad_(False), cfg, list(cfg_d["spk_id_v"]))
    _MODEL_CACHE[key] = (step_now, out)
    return out


def power_windows(wav, feat_cfg, n_timesteps: int, device="cpu") -> torch.Tensor:
    """Waveform -> [K, T, n_stft] power_dB windows (the CNN's input), zero
    padded to one window when shorter, the tail past whole windows dropped."""
    with torch.no_grad():
        _, _, power = mfcc_input(torch.as_tensor(np.asarray(wav, np.float32), device=device),
                                 feat_cfg)
    T = n_timesteps
    if power.shape[0] < T:
        power = torch.nn.functional.pad(power, (0, 0, 0, T - power.shape[0]))
    K = max(power.shape[0] // T, 1)
    return power[: K * T].reshape(K, T, power.shape[1])


@torch.no_grad()
def mean_posterior(model, windows: torch.Tensor) -> np.ndarray:
    """Mean softmax posterior over all windows -> [n_spk] (float32 softmax)."""
    p = next(model.parameters())
    logits = model(windows.to(p.device, p.dtype))
    return torch.softmax(logits.float(), dim=-1).mean(dim=0).cpu().numpy()


def verify_conversion(wav_true, wav_pred, spk_model_path: str, feat_cfg,
                      target_spk_id: str | None = None, top_k: int = 3,
                      wav_control=None, device="cuda") -> dict:
    """Classify source against converted audio; report the posterior shift.

    ``wav_true`` / ``wav_pred`` (and ``wav_control``, a reconstruction of
    the target speaker through the same decoder and vocoder) are waveforms
    or lists of waveforms: with a list, the posterior is the mean over the
    windows of all of them. The report (the JAX keys): true_top / pred_top
    [(spk_id, p), ...], identity_changed, n_windows_true / n_windows_pred;
    with a control: control_top, control_match, cos_pred_control,
    cos_pred_true; with ``target_spk_id``: target_spk_id and target_p_true,
    target_p_pred, target_hit, or target_warning when the classifier has no
    such class."""
    model, cfg, spk_id_v = load_speaker_model(spk_model_path, device)
    dev = next(model.parameters()).device

    def windows_multi(wavs):
        if isinstance(wavs, np.ndarray) and wavs.ndim == 1:
            wavs = [wavs]
        return torch.cat([power_windows(w, feat_cfg, cfg.n_timesteps, dev) for w in wavs])

    win_true, win_pred = windows_multi(wav_true), windows_multi(wav_pred)
    post_true = mean_posterior(model, win_true)
    post_pred = mean_posterior(model, win_pred)

    def top(post):
        idx = np.argsort(post)[::-1][:top_k]
        return [(spk_id_v[i], float(post[i])) for i in idx]

    report = {
        "true_top": top(post_true),
        "pred_top": top(post_pred),
        "identity_changed": bool(int(post_true.argmax()) != int(post_pred.argmax())),
        "n_windows_true": int(win_true.shape[0]),
        "n_windows_pred": int(win_pred.shape[0]),
    }
    if wav_control is not None:
        post_ctl = mean_posterior(model, windows_multi(wav_control))

        def cos(a, b):
            return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))

        report["control_top"] = top(post_ctl)
        report["control_match"] = bool(int(post_pred.argmax()) == int(post_ctl.argmax()))
        report["cos_pred_control"] = cos(post_pred, post_ctl)
        report["cos_pred_true"] = cos(post_pred, post_true)
    if target_spk_id is not None:
        report["target_spk_id"] = target_spk_id
        if target_spk_id in spk_id_v:
            ti = spk_id_v.index(target_spk_id)
            report["target_p_true"] = float(post_true[ti])
            report["target_p_pred"] = float(post_pred[ti])
            report["target_hit"] = bool(int(post_pred.argmax()) == ti)
        else:
            report["target_warning"] = "target speaker not in classifier classes"
    return report


def format_report(report: dict) -> str:
    lines = [" speaker-ID verification:",
             "   source audio classifies as: "
             + ", ".join(f"{s}={p:.3f}" for s, p in report["true_top"]),
             "   converted audio classifies as: "
             + ", ".join(f"{s}={p:.3f}" for s, p in report["pred_top"]),
             f"   identity changed: {report['identity_changed']}"]
    if "control_top" in report:
        lines.append("   reconstruction control classifies as: "
                     + ", ".join(f"{s}={p:.3f}" for s, p in report["control_top"]))
        lines.append(f"   converted matches control: {report['control_match']} "
                     f"(cos to control {report['cos_pred_control']:.3f} vs "
                     f"cos to source {report['cos_pred_true']:.3f})")
    if "target_p_pred" in report:
        lines.append(f"   posterior on target '{report['target_spk_id']}': "
                     f"{report['target_p_true']:.3f} -> {report['target_p_pred']:.3f}"
                     f" (target_hit={report['target_hit']})")
    return "\n".join(lines)
