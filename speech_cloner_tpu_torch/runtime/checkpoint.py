"""Checkpoints: the JAX package's ``.npz`` pytree format, and TF bundles.

Counterpart of ``speech_cloner_tpu/runtime/checkpoint.py`` (save and
restore; pruning waits with training): one
``<model_path>/<model_name>-<step>.npz`` per checkpoint, holding the
flattened tree with ``//``-joined keys and ``__len__`` entries for lists,
so either package reads what the other writes. `load_encoder_weights` /
`load_decoder_weights` are the JAX apps' loaders of the same names: a TF
checkpoint prefix (``<path>.index`` exists) through ``runtime/tf_import.py``,
else the latest ``.npz`` under the directory ``path``.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from .tf_import import load_tf_decoder, load_tf_encoder

_SEP = "//"


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}__len__"] = np.asarray(len(tree))
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    else:
        out[prefix.removesuffix(_SEP)] = _host(tree)
    return out


def _unflatten(flat: dict):
    if list(flat.keys()) == [""]:
        return flat[""]
    groups: dict[str, dict] = {}
    scalars = {}
    for k, v in flat.items():
        if _SEP in k:
            head, rest = k.split(_SEP, 1)
            groups.setdefault(head, {})[rest] = v
        else:
            scalars[k] = v
    if "__len__" in scalars:
        n = int(scalars["__len__"])
        return [_unflatten(groups[str(i)]) if str(i) in groups else scalars[str(i)]
                for i in range(n)]
    out = dict(scalars)
    for k, g in groups.items():
        out[k] = _unflatten(g)
    return out


class Checkpointer:
    """Save and restore the checkpoints of a named model directory."""

    def __init__(self, model_path: str, model_name: str):
        self.model_path = model_path
        self.model_name = model_name
        self._pattern = re.compile(re.escape(model_name) + r"-(\d+)\.npz$")

    def _path(self, step: int) -> str:
        return os.path.join(self.model_path, f"{self.model_name}-{int(step)}.npz")

    def steps(self) -> list[int]:
        if not os.path.isdir(self.model_path):
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.model_path)
                      if (m := self._pattern.match(f)))

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, tree, step: int, config: dict | None = None) -> str:
        """Write ``tree`` (nested dicts/lists of tensors, arrays or scalars) as
        ``<model_name>-<step>.npz``, and ``config`` as ``<model_name>_cfg_d.json``,
        before returning the path. (The JAX package writes on a background
        thread for its training loop; that comes with training.)"""
        path = self._path(step)
        os.makedirs(self.model_path, exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez(tmp, **_flatten(tree))
        os.replace(tmp, path)
        if config is not None:
            with open(os.path.join(self.model_path, f"{self.model_name}_cfg_d.json"), "w") as f:
                json.dump(config, f, indent=1, sort_keys=True, default=str)
        return path

    def restore(self, step: int | None = None):
        """Load a checkpoint pytree (latest when step is None) as numpy
        leaves. Returns (tree, step), or (None, None) when none exists."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None, None
        with np.load(self._path(step), allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten(flat), step


def restore_params(path: str, model_name: str, cfg=None):
    """(params, model_state) trees of ``model_name`` ("encoder" or "decoder")
    from a TF checkpoint prefix when ``<path>.index`` exists (its layer counts
    come from the model's config ``cfg``), else from the latest
    ``<model_name>-<step>.npz`` under ``path``."""
    if os.path.exists(path + ".index"):
        if cfg is None:
            raise ValueError(f"{path} is a TF checkpoint bundle: reading it needs the "
                             f"{model_name}'s config")
        load = {"encoder": load_tf_encoder, "decoder": load_tf_decoder}[model_name]
        return load(path, cfg)
    tree, _ = Checkpointer(path, model_name).restore()
    if tree is None:
        raise FileNotFoundError(f"no {model_name} checkpoint under {path} "
                                f"(expected {model_name}-<step>.npz or a TF <prefix>.index)")
    return tree["params"], tree["model_state"]


def load_encoder_weights(path: str, cfg):
    """Encoder (params, state) from a TF prefix or an ``.npz`` directory."""
    return restore_params(path, "encoder", cfg)


def load_decoder_weights(path: str, cfg):
    """Decoder (params, state) from a TF prefix or an ``.npz`` directory."""
    return restore_params(path, "decoder", cfg)
