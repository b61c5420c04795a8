"""Phoneme-posterior encoder: MFCC frames -> 61 TIMIT phone posteriors (PPG).

Counterpart of ``speech_cloner_tpu/models/encoder.py``: prenet -> CBHG ->
dense(n_output) logits; softmax posteriors in float32. `apply` takes the
JAX signature's ``train``, a ``torch.Generator`` for dropout in place of the
key, and ``bn_momentum``, and returns the new BN state; `params_tree` /
`state_tree` give the model's live tensors in the JAX layout. `cast` makes
the copy that runs in another dtype (the pipeline's ``compute_dtype``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
from torch import nn

from ..nn import CBHG, CBHGConfig, Dense, Prenet
from ..nn.modules import cbhg_init, dense_init, prenet_init


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Mirrors hp/encoder_cfg_d.json fields that shape the graph."""

    n_timesteps: int = 400
    input_dim: int = 80            # n_mfcc * (2 if deltas else 1)
    n_output: int = 61
    embed_size: int | None = None  # None -> input_dim
    num_conv_banks: int = 6
    num_highwaynet_blocks: int = 1
    dropout_rate: float = 0.4
    use_lstm: bool = False
    fused_gru: bool = False
    scan_unroll: int = 1

    @property
    def embed(self) -> int:
        return self.embed_size if self.embed_size is not None else self.input_dim

    @property
    def cbhg(self) -> CBHGConfig:
        return CBHGConfig(embed_size=self.embed, num_banks=self.num_conv_banks,
                          num_highway=self.num_highwaynet_blocks, use_lstm=self.use_lstm,
                          fused_gru=self.fused_gru, scan_unroll=self.scan_unroll)


class Encoder(nn.Module):
    """Built from (params, state) trees in the JAX package's layout."""

    def __init__(self, params, state, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.prenet = Prenet(params["prenet"])
        self.cbhg = CBHG(params["CBHG"], state["CBHG"], cfg.cbhg)
        self.y_logits = Dense(params["y_logits"])

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                bn_momentum: float | None = None) -> torch.Tensor:
        """[B, T, input_dim] -> logits [B, T, n_output]; train mode draws
        dropout from ``generator`` and moves the BN statistics."""
        h = self.prenet(x, self.cfg.dropout_rate, train, generator)
        return self.y_logits(self.cbhg(h, train, bn_momentum))

    def params_tree(self):
        """The parameters (live tensors) in the JAX ``params`` layout."""
        return {"prenet": self.prenet.params_tree(), "CBHG": self.cbhg.params_tree(),
                "y_logits": self.y_logits.params_tree()}

    def state_tree(self):
        """The BN running statistics (live buffers) in the JAX ``state`` layout."""
        return {"CBHG": self.cbhg.state_tree()}


def init_tree(generator: torch.Generator, cfg: EncoderConfig):
    """Fresh (params, state) trees in the JAX layout, drawn from ``generator``."""
    cbhg_params, cbhg_state = cbhg_init(generator, cfg.cbhg)
    params = {"prenet": prenet_init(generator, cfg.input_dim, cfg.embed),
              "CBHG": cbhg_params,
              "y_logits": dense_init(generator, cfg.embed, cfg.n_output)}
    return params, {"CBHG": cbhg_state}


def init(generator: torch.Generator, cfg: EncoderConfig, device="cpu") -> Encoder:
    return Encoder(*init_tree(generator, cfg), cfg).to(device)


def cast(model: Encoder, dtype: torch.dtype | None) -> Encoder:
    """``model`` itself for None, else a copy whose parameters, BN statistics
    and packed GRU weights are ``dtype`` (the JAX pipeline's ``_cast``)."""
    return model if dtype is None else copy.deepcopy(model).to(dtype)


def apply(model: Encoder, x: torch.Tensor, *, train: bool = False,
          generator: torch.Generator | None = None, bn_momentum: float | None = None):
    """[B, T, input_dim] -> (logits [B, T, n_output], new_state), as the JAX
    ``apply``: ``train`` draws dropout from ``generator`` and updates the BN
    statistics in place (``bn_momentum`` overrides the 0.999 decay; 0 gives
    the batch's statistics); new_state is `state_tree` after the call."""
    return model(x, train, generator, bn_momentum), model.state_tree()


def posteriors(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.to(torch.float32), dim=-1)


def predict_classes(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def config_from_cfg_d(cfg_d: dict[str, Any]) -> EncoderConfig:
    """Build from a reference-format cfg dict (hp/encoder_cfg_d.json)."""
    t, e = cfg_d["input_shape"]
    return EncoderConfig(
        n_timesteps=t,
        input_dim=e,
        n_output=cfg_d["n_output"],
        embed_size=cfg_d.get("embed_size"),
        num_conv_banks=cfg_d["num_conv_banks"],
        num_highwaynet_blocks=cfg_d["num_highwaynet_blocks"],
        dropout_rate=cfg_d.get("dropout_rate", 0.4),
        use_lstm=cfg_d.get("use_lstm", False),
    )
