"""Checkpoints: the JAX package's ``.npz`` pytree format, and TF bundles.

Counterpart of ``speech_cloner_tpu/runtime/checkpoint.py``: one
``<model_path>/<model_name>-<step>.npz`` per checkpoint, holding the
flattened tree with ``//``-joined keys and ``__len__`` entries for lists and
tuples (optax's ``ScaleByAdamState`` flattens as a tuple of three), so either
package reads what the other writes, train states included. `save` writes
before it returns (the JAX package writes on a background thread);
`restore_into` fills a template tree, in place where its leaves are tensors;
`prune` keeps evenly spaced checkpoints. `load_encoder_weights` /
`load_decoder_weights` are the JAX apps' loaders of the same names: a TF
checkpoint prefix (``<path>.index`` exists) through ``runtime/tf_import.py``,
else the latest ``.npz`` under the directory ``path``.

Under a data- and tensor-parallel ``mesh`` (``parallel.mesh.ProcessMesh``)
a `Checkpointer` writes the one full tree the JAX package reads: every rank
calls `save`, each model group gathers its ranks' bank slices
(``parallel.sharding.gather_tree``), rank 0 writes, and the others wait at a
barrier; `restore_into` reads the full tree on every rank and keeps the
rank's slices.
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


def _restore_like(tpl, ck, path: str = ""):
    """``tpl``'s structure filled from checkpoint tree ``ck``, walked by key
    and index, failing with the path on any mismatch (the JAX
    ``_restore_like``). A tensor leaf is overwritten in place (cast to its
    dtype, on its device) and returned; any other leaf becomes a numpy array
    of the template's dtype."""
    where = path or "<root>"
    if isinstance(tpl, dict):
        if not isinstance(ck, dict):
            raise ValueError(f"checkpoint mismatch at {where}: "
                             f"expected a dict, found {type(ck).__name__}")
        missing, extra = sorted(set(tpl) - set(ck)), sorted(set(ck) - set(tpl))
        if missing or extra:
            raise ValueError(f"checkpoint mismatch at {where}: "
                             f"missing keys {missing}, unexpected keys {extra}")
        return {k: _restore_like(tpl[k], ck[k], f"{path}{k}{_SEP}") for k in tpl}
    if isinstance(tpl, (list, tuple)):
        if not isinstance(ck, (list, tuple)) or len(tpl) != len(ck):
            raise ValueError(f"checkpoint mismatch at {where}: expected a sequence of "
                             f"{len(tpl)}, found {type(ck).__name__}"
                             + (f" of {len(ck)}" if isinstance(ck, (list, tuple)) else ""))
        vals = [_restore_like(t, c, f"{path}{i}{_SEP}") for i, (t, c) in enumerate(zip(tpl, ck))]
        return type(tpl)(vals)
    arr = np.asarray(ck)
    want_shape = tuple(tpl.shape) if hasattr(tpl, "shape") else np.shape(tpl)
    if tuple(arr.shape) != tuple(want_shape):
        raise ValueError(f"checkpoint mismatch at {where}: shape "
                         f"{tuple(arr.shape)} != template {tuple(want_shape)}")
    if isinstance(tpl, torch.Tensor):
        with torch.no_grad():
            tpl.copy_(torch.tensor(arr))      # a 0-d leaf stays 0-d
        return tpl
    return arr.astype(np.asarray(tpl).dtype)


class Checkpointer:
    """Save, restore and prune the checkpoints of a named model directory
    (train states of a sharded model under ``mesh``)."""

    def __init__(self, model_path: str, model_name: str, mesh=None):
        self.model_path = model_path
        self.model_name = model_name
        self.mesh = mesh
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
        """Write ``tree`` (nested dicts/lists/tuples of tensors, arrays or
        scalars) as ``<model_name>-<step>.npz``, and ``config`` as
        ``<model_name>_cfg_d.json``, before returning the path."""
        path = self._path(step)
        if self.mesh is not None and self.mesh.size > 1:
            import torch.distributed as dist

            from ..parallel.sharding import gather_tree

            tree = gather_tree(tree, self.mesh)
            if self.mesh.rank == 0:
                self._write(path, tree, config)
            dist.barrier()
            return path
        self._write(path, tree, config)
        return path

    def _write(self, path: str, tree, config: dict | None) -> None:
        os.makedirs(self.model_path, exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez(tmp, **_flatten(tree))
        os.replace(tmp, path)
        if config is not None:
            with open(os.path.join(self.model_path, f"{self.model_name}_cfg_d.json"), "w") as f:
                json.dump(config, f, indent=1, sort_keys=True, default=str)

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

    def restore_into(self, template, step: int | None = None):
        """Restore into the structure of ``template`` (its tensors in place),
        matching leaves by their flattened paths; a mismatch raises with the
        path. Returns (tree, step), or (template, None) when none exists."""
        tree, step = self.restore(step)
        if tree is None:
            return template, None
        if self.mesh is not None and self.mesh.size > 1:
            from ..parallel.sharding import shard_tree

            tree = shard_tree(tree, self.mesh)
        return _restore_like(template, tree), step

    def prune(self, n_keep: int = 100, step_min: int = 0) -> int:
        """Keep ``n_keep`` evenly spaced checkpoints with step >= step_min,
        always the first and last of them; delete the rest and those below
        step_min. Returns the number deleted."""
        steps = self.steps()
        survivors = [s for s in steps if s >= step_min]
        doomed = [s for s in steps if s < step_min]
        if survivors:
            keep = set(range(0, len(survivors), max(len(survivors) // n_keep, 1)))
            keep.add(len(survivors) - 1)
            doomed += [s for i, s in enumerate(survivors) if i not in keep]
        for s in doomed:
            os.remove(self._path(s))
        return len(doomed)


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
