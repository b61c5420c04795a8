"""Metrics logging: JSONL scalar writer and a step timer.

Counterpart of ``speech_cloner_tpu/runtime/logging.py``, writing the same
records: one ``{"step", "wall", <scalars>}`` line per call to
``<log_dir>/<split>.jsonl``. Scalars may be tensors on the card; they are
read when written, at the log cadence, not per step.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch


class MetricsWriter:
    """Append-only JSONL scalar log, one file per run split (trn/val/tst)."""

    def __init__(self, log_dir: str, split: str = "trn"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{split}.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def write(self, step: int, metrics: dict):
        rec = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            v = np.asarray(v)
            if v.ndim == 0:
                rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")

    def write_array(self, step: int, name: str, arr):
        """Dump a small array artifact (confusion matrix, spectrogram pair)."""
        out_dir = os.path.dirname(self.path)
        np.save(os.path.join(out_dir, f"{name}_{int(step)}.npy"), np.asarray(arr))

    def close(self):
        self._f.close()


class StepTimer:
    """Rolling steps/sec over the last ``window`` ticks (the first tick only
    starts the clock)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None if self._last is None else now - self._last
        self._last = now
        if dt is not None:
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        return dt

    @property
    def steps_per_sec(self) -> float:
        if not self.times:
            return 0.0
        return 1.0 / (sum(self.times) / len(self.times))
