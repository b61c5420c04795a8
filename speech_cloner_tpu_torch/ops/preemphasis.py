"""Pre-emphasis filter and its inverse, on tensors.

Counterpart of ``speech_cloner_tpu/ops/preemphasis.py``:
  forward : y[n] = x[n] - c*x[n-1]   (2-tap FIR)
  inverse : y[n] = x[n] + c*y[n-1]   (first-order IIR)

The JAX package runs the inverse as an associative scan. Here it is a
blocked form with no loop over samples: the signal is cut into blocks of
``block`` samples, each block's zero-state response is one matmul against
the [block, block] lower-triangular decay matrix M[i, m] = c^(i-m), and the
block-end values obey the same recurrence with coefficient c^block, which is
solved by the same function on the (block-times shorter) sequence of block
ends. The recursion is exact; for c = 0.97 and block = 1024 it stops after
one level because a 60 s clip has under 1024 blocks. Both filters run along
the last axis; leading axes (a batch of clips) are independent signals.
`inv_preemphasis_np` is the JAX package's host form of the inverse (scipy's
``lfilter`` on a numpy array).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_BLOCK = 1024


def preemphasis(x: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """y[n] = x[n] - coeff*x[n-1], y[0] = x[0], along the last axis."""
    if coeff == 0.0:
        return x
    return x - coeff * F.pad(x[..., :-1], (1, 0))


def _decay_matrix(coeff: float, n: int, like: torch.Tensor) -> torch.Tensor:
    """[n, n] with M[i, m] = coeff^(i-m) for i >= m, else 0; built in float64."""
    idx = torch.arange(n, device=like.device, dtype=torch.float64)
    d = idx[:, None] - idx[None, :]
    m = torch.where(d >= 0, torch.tensor(coeff, dtype=torch.float64,
                                         device=like.device) ** d.clamp(min=0), 0.0)
    return m.to(like.dtype)


def inv_preemphasis(x: torch.Tensor, coeff: float = 0.97, block: int = _BLOCK) -> torch.Tensor:
    """Inverse pre-emphasis y[n] = x[n] + coeff*y[n-1] along the last axis."""
    if coeff == 0.0:
        return x
    *lead, n = x.shape
    if n <= block:
        return x @ _decay_matrix(coeff, n, x).T
    nb = -(-n // block)
    blocks = F.pad(x, (0, nb * block - n)).reshape(*lead, nb, block)
    local = blocks @ _decay_matrix(coeff, block, x).T          # zero-state response
    ends = inv_preemphasis(local[..., -1].contiguous(), coeff**block, block)
    carry = F.pad(ends[..., :-1], (1, 0))                      # y at previous block end
    powers = (torch.tensor(coeff, dtype=torch.float64, device=x.device)
              ** torch.arange(1, block + 1, device=x.device, dtype=torch.float64)).to(x.dtype)
    y = local + carry[..., None] * powers
    return y.reshape(*lead, nb * block)[..., :n]


def inv_preemphasis_np(x, coeff: float = 0.97):
    """The IIR inverse on a numpy array, in its dtype (scipy ``lfilter``)."""
    if coeff == 0.0:
        return x
    from scipy import signal

    return signal.lfilter([1.0], [1.0, -coeff], x).astype(x.dtype)
