"""dB conversions with librosa's clipping semantics, on tensors.

Counterpart of ``speech_cloner_tpu/ops/db.py``:
  power_to_db      ref=1, amin=1e-10, top_db=80
  amplitude_to_db  amin=1e-5, top_db=80
  db_to_power

``top_db`` clips relative to the *global* max of the whole tensor.
"""

from __future__ import annotations

import numpy as np
import torch


def power_to_db(P: torch.Tensor, ref: float = 1.0, amin: float = 1e-10,
                top_db: float | None = 80.0) -> torch.Tensor:
    log_spec = 10.0 * torch.log10(torch.clamp(P, min=amin))
    log_spec = log_spec - 10.0 * np.log10(max(amin, ref))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def amplitude_to_db(S: torch.Tensor, ref: float = 1.0, amin: float = 1e-5,
                    top_db: float | None = 80.0) -> torch.Tensor:
    magnitude = torch.abs(S)
    return power_to_db(magnitude**2, ref=ref**2, amin=amin**2, top_db=top_db)


def db_to_power(dB: torch.Tensor, ref: float = 1.0) -> torch.Tensor:
    return ref * torch.pow(10.0, 0.1 * dB)


def db_to_amplitude(dB: torch.Tensor, ref: float = 1.0) -> torch.Tensor:
    return db_to_power(dB, ref=ref**2) ** 0.5
