"""Optimizer: Adam in TF form with the reference's epoch-indexed LR decay.

Counterpart of ``speech_cloner_tpu/train/optimizer.py``:
  lr(epoch) = lr0 / (1 + decay * epoch), set once per epoch, in float32;
  Adam(beta1=0.9, beta2=0.999, eps=1e-8) as optax.scale_by_adam with
  eps_root=0: u = m_hat / (sqrt(v_hat) + eps), p <- p - lr * u.

The train state is the JAX package's pytree, so a checkpoint of either
package restores into the other: {"params", "model_state", "opt_state",
"step", "epoch", "rng"}. Here "params" and "model_state" hold the model's
live parameters and BN buffers (`params_tree` / `state_tree`), "opt_state"
is (count, mu, nu) as optax's ``ScaleByAdamState`` flattens (count an int32
scalar, mu and nu trees of tensors shaped like the params), "step" and
"epoch" int32 scalars, and "rng" a uint32[2] key. Tensors are updated in
place; the scalars and the key are replaced in the returned state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..runtime.tree import tree_map

_INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-3
    decay: float = 1e-3           # epoch-indexed decay factor
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def make(self) -> "Adam":
        return Adam(self.beta1, self.beta2, self.epsilon)

    def lr_at(self, epoch) -> np.float32:
        f = np.float32
        return f(self.learning_rate) / (f(1.0) + f(self.decay) * f(epoch))


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.scale_by_adam(b1, b2, eps, eps_root=0) on trees of tensors."""
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format)  # noqa: E731
        return (np.int32(0), tree_map(zeros, params), tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state):
        """Moments moved in place by ``grads``; returns (updates, new state)."""
        count, mu, nu = state
        count = np.int32(min(int(count) + 1, _INT32_MAX))
        f = np.float32
        c1 = float(f(1.0) - f(self.b1) ** f(count))
        c2 = float(f(1.0) - f(self.b2) ** f(count))

        def step(m, v, g):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            return (m / c1) / (torch.sqrt(v / c2) + self.eps)
        return tree_map(step, mu, nu, grads), (count, mu, nu)


def make_train_state(model, opt_cfg: OptimizerConfig, seed: int) -> dict:
    """The train state of ``model`` (an `Encoder` or `Decoder`): its live
    parameters and BN buffers, zero Adam moments, step and epoch 0, and the
    key [0, seed] (the layout of jax.random.PRNGKey(seed))."""
    params = model.params_tree()
    return {"params": params, "model_state": model.state_tree(),
            "opt_state": opt_cfg.make().init(params), "step": np.int32(0),
            "epoch": np.int32(0), "rng": np.array([0, seed], np.uint32)}


@torch.no_grad()
def apply_updates(ts: dict, grads, opt_cfg: OptimizerConfig, opt: Adam):
    """One optimizer step: Adam-scaled updates times the epoch-indexed LR,
    into the parameters in place. Returns (new ts, lr)."""
    lr = opt_cfg.lr_at(ts["epoch"])
    updates, opt_state = opt.update(grads, ts["opt_state"])
    tree_map(lambda p, u: p.sub_(float(lr) * u), ts["params"], updates)
    return {**ts, "opt_state": opt_state, "step": np.int32(ts["step"] + 1)}, lr


def next_epoch(ts: dict) -> dict:
    return {**ts, "epoch": np.int32(ts["epoch"] + 1)}


def split_key(key: np.ndarray) -> tuple[np.ndarray, int]:
    """(next key, a 63-bit seed for this step's generator) from a uint32[2]
    key: both drawn from numpy's default generator seeded with the key, so a
    run resumed from a checkpoint's key draws the same dropout masks."""
    draw = np.random.default_rng(np.asarray(key, np.uint32)).integers(
        0, 2**32, size=4, dtype=np.uint64)
    seed = int(draw[2]) << 31 ^ int(draw[3])
    return draw[:2].astype(np.uint32), seed & (2**63 - 1)
