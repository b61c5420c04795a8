"""Checkpoint reading: the JAX package's ``.npz`` pytree format.

Counterpart of the read side of ``speech_cloner_tpu/runtime/checkpoint.py``:
one ``<model_path>/<model_name>-<step>.npz`` per checkpoint, holding the
flattened pytree with ``//``-joined keys and ``__len__`` entries for lists.
Read-only in this port; saving and pruning wait with training.
"""

from __future__ import annotations

import os
import re

import numpy as np

_SEP = "//"


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
    """Read the checkpoints of a named model directory."""

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


def restore_params(path: str, model_name: str):
    """(params, model_state) of the latest ``<model_name>-<step>.npz`` under
    ``path``. A TF checkpoint prefix (``<path>.index``) is not read yet."""
    if os.path.exists(path + ".index"):
        raise NotImplementedError(
            f"{path} is a TF checkpoint bundle; reading those is not ported yet "
            f"(ROADMAP queue 1, \"TF checkpoint bundles\"). Pass a directory of "
            f"{model_name}-<step>.npz")
    tree, _ = Checkpointer(path, model_name).restore()
    if tree is None:
        raise FileNotFoundError(f"no {model_name} checkpoint under {path} "
                                f"(expected {model_name}-<step>.npz)")
    return tree["params"], tree["model_state"]
