"""Speaker-identification CNN (the conversion sanity-checker).

Counterpart of ``speech_cloner_tpu/models/speaker_id.py`` (the reference's
Keras Sequential): [B, 400, 201] power_dB windows -> Conv2D(32, 5, valid,
relu) -> MaxPool(2) -> Conv2D(64, 3, valid, relu) -> MaxPool(2) -> Flatten
-> BatchNorm -> Dense(128, relu) -> Dense(512, relu) -> Dense(n_spk)
logits. Keras defaults kept: valid padding, glorot-uniform kernels, BN eps
1e-3.

Layouts: the JAX package convolves NHWC with HWIO kernels; the port keeps
the kernels in that layout (the parameter trees are the JAX ones) and
convolves NCHW with the OIHW view of them (`Conv2d.weight`). The flatten
before ``dense1`` is taken in NHWC order (h, w, c), so ``dense1``'s rows
mean what they mean in JAX. Pooling is floor max-pool 2 (VALID). bf16
convolutions of CPU tensors are computed in float32 and rounded back, as
``nn.modules.conv1d`` does (oneDNN's bf16 convolutions are not trusted on
this CPU path); CUDA tensors convolve in their own dtype.

The convolutions stay cuDNN's: the JAX package leaves them to XLA and has
no Pallas kernel for this model.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.modules import BatchNorm, Dense, Derived, _param, bn_init, dense_init, glorot_uniform


@dataclasses.dataclass(frozen=True)
class SpeakerIdConfig:
    n_timesteps: int = 400
    n_features: int = 201  # power_dB windows
    n_output: int = 630
    # fold k consecutive time frames into the input channels ([B, 400, 201]
    # -> [B, 400/k, 201, k]): a different model, behind a flag; 1 is the
    # reference architecture
    time_fold: int = 1

    @property
    def flat_dim(self) -> int:
        h = (self.n_timesteps // self.time_fold - 4) // 2  # conv5 valid, pool2
        w = (self.n_features - 4) // 2
        h = (h - 2) // 2                  # conv3 valid, pool2
        w = (w - 2) // 2
        return h * w * 64


def conv2d_init(generator: torch.Generator, k: int, cin: int, cout: int) -> dict:
    """{kernel [k, k, cin, cout] (HWIO, glorot), bias zeros}."""
    return {"kernel": glorot_uniform(generator, (k, k, cin, cout), k * k * cin, k * k * cout),
            "bias": torch.zeros(cout)}


def conv2d_valid(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """VALID 2-D convolution, NCHW x OIHW, plus bias."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return F.conv2d(x.float(), weight.float(), bias.float()).to(x.dtype)
    return F.conv2d(x, weight, bias)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, VALID (floor) on NCHW."""
    return F.max_pool2d(x, 2)


class Conv2d(Derived):
    """VALID conv with bias; ``kernel`` in the JAX layout HWIO."""

    def __init__(self, p):
        super().__init__()
        self.kernel = _param(p["kernel"])
        self.bias = _param(p["bias"])

    def weight(self) -> torch.Tensor:
        """The torch layout OIHW."""
        return self.derived("weight", (self.kernel,),
                            lambda: self.kernel.permute(3, 2, 0, 1).contiguous())

    def forward(self, x):
        return conv2d_valid(x, self.weight(), self.bias)

    def params_tree(self):
        return {"kernel": self.kernel, "bias": self.bias}


class SpeakerId(nn.Module):
    """Built from (params, state) trees in the JAX package's layout."""

    def __init__(self, params, state, cfg: SpeakerIdConfig):
        super().__init__()
        self.cfg = cfg
        self.conv1, self.conv2 = Conv2d(params["conv1"]), Conv2d(params["conv2"])
        self.bn = BatchNorm(params["bn"], state["bn"])
        self.dense1, self.dense2 = Dense(params["dense1"]), Dense(params["dense2"])
        self.dense3 = Dense(params["dense3"])

    def forward(self, x: torch.Tensor, train: bool = False,
                bn_momentum: float | None = None) -> torch.Tensor:
        """[B, T, F] power_dB windows -> logits [B, n_output]; train mode
        normalizes with the batch's statistics and moves the running ones."""
        B, T, Fd = x.shape
        k = self.cfg.time_fold
        if k > 1:     # NHWC [B, T/k, F, k] is NCHW [B, k, T/k, F]
            h = x.reshape(B, T // k, k, Fd).permute(0, 2, 1, 3)
        else:
            h = x[:, None]
        h = maxpool2(torch.relu(self.conv1(h)))
        h = maxpool2(torch.relu(self.conv2(h)))
        h = h.permute(0, 2, 3, 1).reshape(B, -1)          # flatten as NHWC: (h, w, c)
        h = self.bn(h, train, bn_momentum)
        h = torch.relu(self.dense1(h))
        h = torch.relu(self.dense2(h))
        return self.dense3(h)

    def params_tree(self):
        """The parameters (live tensors) in the JAX ``params`` layout."""
        return {"conv1": self.conv1.params_tree(), "conv2": self.conv2.params_tree(),
                "bn": self.bn.params_tree(), "dense1": self.dense1.params_tree(),
                "dense2": self.dense2.params_tree(), "dense3": self.dense3.params_tree()}

    def state_tree(self):
        """The BN running statistics (live buffers) in the JAX ``state`` layout."""
        return {"bn": self.bn.state_tree()}


def check_config(cfg: SpeakerIdConfig) -> None:
    if cfg.time_fold > 1 and cfg.n_timesteps % cfg.time_fold:
        raise ValueError(f"n_timesteps={cfg.n_timesteps} must divide by "
                         f"time_fold={cfg.time_fold}")
    if cfg.flat_dim <= 0:
        raise ValueError(f"degenerate geometry: conv/pool stack reduces "
                         f"[{cfg.n_timesteps}/{cfg.time_fold}, {cfg.n_features}] to zero "
                         f"rows/cols")


def init_tree(generator: torch.Generator, cfg: SpeakerIdConfig):
    """Fresh (params, state) trees in the JAX layout, drawn from ``generator``
    (Keras glorot kernels, zero biases, BN gamma 1 / beta 0)."""
    check_config(cfg)
    bn_params, bn_state = bn_init(cfg.flat_dim)
    params = {"conv1": conv2d_init(generator, 5, cfg.time_fold, 32),
              "conv2": conv2d_init(generator, 3, 32, 64),
              "bn": bn_params,
              "dense1": dense_init(generator, cfg.flat_dim, 128),
              "dense2": dense_init(generator, 128, 512),
              "dense3": dense_init(generator, 512, cfg.n_output)}
    return params, {"bn": bn_state}


def init(generator: torch.Generator, cfg: SpeakerIdConfig, device="cpu") -> SpeakerId:
    return SpeakerId(*init_tree(generator, cfg), cfg).to(device)


def apply(model: SpeakerId, x: torch.Tensor, *, train: bool = False,
          bn_momentum: float | None = None):
    """[B, T, F] power_dB windows -> (logits [B, n_spk], new_state), as the
    JAX ``apply``: ``train`` updates the BN statistics in place
    (``bn_momentum`` overrides the 0.999 decay; 0 gives the batch's
    statistics); new_state is `state_tree` after the call."""
    return model(x, train, bn_momentum), model.state_tree()
