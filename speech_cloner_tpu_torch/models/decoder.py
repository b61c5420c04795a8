"""Two-step spectrogram decoder: PPG -> target-speaker mel -> linear spectrogram.

Counterpart of ``speech_cloner_tpu/models/decoder.py``:

  step1: prenet(E=256) -> CBHG(K=32, hwy=4) -> dense(80)  = y_mel
  step2: prenet(E=512) -> CBHG(K=32, hwy=6) -> dense(201) = y_stft

Step2 consumes y_mel, or in training with ``use_target_mel_step2`` the
scheduled mix f*y_mel + (1-f)*target_mel (the schedule is
``train.steps.f_mel_schedule``; `apply` takes f). `apply` has the JAX
signature, a ``torch.Generator`` in place of the key, and returns the new BN
state; `params_tree` / `state_tree` give the live tensors in the JAX layout.
`cast` makes the copy that runs in another dtype (the pipeline's
``compute_dtype``).
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
class DecoderStepConfig:
    embed_size: int
    num_conv_banks: int
    num_highwaynet_blocks: int
    n_output: int
    fused_gru: bool = False
    use_lstm: bool = False
    scan_unroll: int = 1

    @property
    def cbhg(self) -> CBHGConfig:
        return CBHGConfig(self.embed_size, self.num_conv_banks, self.num_highwaynet_blocks,
                          use_lstm=self.use_lstm, fused_gru=self.fused_gru,
                          scan_unroll=self.scan_unroll)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Mirrors hp/decoder_cfg_d.json fields that shape the graph."""

    n_timesteps: int = 400
    input_dim: int = 61  # PPG width == encoder n_output
    step1: DecoderStepConfig = DecoderStepConfig(256, 32, 4, 80)
    step2: DecoderStepConfig = DecoderStepConfig(512, 32, 6, 201)
    dropout_rate: float = 0.1
    use_target_mel_step2: bool = False
    target_mel_step2_val: float = 500.0
    use_lstm: bool = False


class DecoderStep(nn.Module):
    def __init__(self, params, state, step: DecoderStepConfig):
        super().__init__()
        self.prenet = Prenet(params["prenet"])
        self.cbhg = CBHG(params["CBHG"], state["CBHG"], step.cbhg)
        self.y_logits = Dense(params["y_logits"])

    def forward(self, x, dropout_rate: float = 0.0, train: bool = False,
                generator: torch.Generator | None = None, bn_momentum: float | None = None):
        h = self.prenet(x, dropout_rate, train, generator)
        return self.y_logits(self.cbhg(h, train, bn_momentum))

    def params_tree(self):
        return {"prenet": self.prenet.params_tree(), "CBHG": self.cbhg.params_tree(),
                "y_logits": self.y_logits.params_tree()}

    def state_tree(self):
        return {"CBHG": self.cbhg.state_tree()}


class Decoder(nn.Module):
    """Built from (params, state) trees in the JAX package's layout."""

    def __init__(self, params, state, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.step1 = DecoderStep(params["step1"], state["step1"], cfg.step1)
        self.step2 = DecoderStep(params["step2"], state["step2"], cfg.step2)

    def forward(self, ppg: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                target_mel: torch.Tensor | None = None, f_mel_pred: float = 0.0,
                bn_momentum: float | None = None):
        """[B, T, 61] PPG -> (y_mel [B, T, 80], y_stft [B, T, 201]). With
        ``cfg.use_target_mel_step2`` and ``target_mel`` given, step2 consumes
        f_mel_pred*y_mel + (1-f_mel_pred)*target_mel."""
        rate = self.cfg.dropout_rate
        y_mel = self.step1(ppg, rate, train, generator, bn_momentum)
        step2_in = y_mel
        if self.cfg.use_target_mel_step2 and target_mel is not None:
            step2_in = f_mel_pred * y_mel + (1.0 - f_mel_pred) * target_mel
        return y_mel, self.step2(step2_in, rate, train, generator, bn_momentum)

    def params_tree(self):
        """The parameters (live tensors) in the JAX ``params`` layout."""
        return {"step1": self.step1.params_tree(), "step2": self.step2.params_tree()}

    def state_tree(self):
        """The BN running statistics (live buffers) in the JAX ``state`` layout."""
        return {"step1": self.step1.state_tree(), "step2": self.step2.state_tree()}


def _step_init_tree(generator, in_dim, step: DecoderStepConfig):
    cbhg_params, cbhg_state = cbhg_init(generator, step.cbhg)
    params = {"prenet": prenet_init(generator, in_dim, step.embed_size),
              "CBHG": cbhg_params,
              "y_logits": dense_init(generator, step.embed_size, step.n_output)}
    return params, {"CBHG": cbhg_state}


def init_tree(generator: torch.Generator, cfg: DecoderConfig):
    """Fresh (params, state) trees in the JAX layout, drawn from ``generator``."""
    s1_params, s1_state = _step_init_tree(generator, cfg.input_dim, cfg.step1)
    s2_params, s2_state = _step_init_tree(generator, cfg.step1.n_output, cfg.step2)
    return ({"step1": s1_params, "step2": s2_params},
            {"step1": s1_state, "step2": s2_state})


def init(generator: torch.Generator, cfg: DecoderConfig, device="cpu") -> Decoder:
    return Decoder(*init_tree(generator, cfg), cfg).to(device)


def cast(model: Decoder, dtype: torch.dtype | None) -> Decoder:
    """``model`` itself for None, else a copy whose parameters, BN statistics
    and packed GRU weights are ``dtype`` (the JAX pipeline's ``_cast``)."""
    return model if dtype is None else copy.deepcopy(model).to(dtype)


def apply(model: Decoder, ppg: torch.Tensor, *, train: bool = False,
          generator: torch.Generator | None = None, target_mel: torch.Tensor | None = None,
          f_mel_pred: float = 0.0, bn_momentum: float | None = None):
    """PPG [B, T, 61] -> (y_mel [B,T,80], y_stft [B,T,201], new_state), as the
    JAX ``apply``: ``train`` draws dropout from ``generator`` and updates the
    BN statistics in place; with ``cfg.use_target_mel_step2`` and
    ``target_mel`` given, step2 consumes the f_mel_pred mix."""
    y_mel, y_stft = model(ppg, train, generator, target_mel, f_mel_pred, bn_momentum)
    return y_mel, y_stft, model.state_tree()


def config_from_cfg_d(cfg_d: dict[str, Any]) -> DecoderConfig:
    """Build from a reference-format cfg dict (hp/decoder_cfg_d.json)."""
    t, e = cfg_d["input_shape"]
    s1, s2 = cfg_d["steps_v"]
    use_lstm = bool(cfg_d.get("use_lstm", False))

    def step(d, default_embed):
        return DecoderStepConfig(
            embed_size=d["embed_size"] if d["embed_size"] is not None else default_embed,
            num_conv_banks=d["num_conv_banks"],
            num_highwaynet_blocks=d["num_highwaynet_blocks"],
            n_output=d["n_output"],
            use_lstm=use_lstm,
        )

    return DecoderConfig(
        n_timesteps=t,
        input_dim=e,
        step1=step(s1, e),
        step2=step(s2, s1["n_output"]),
        dropout_rate=cfg_d.get("dropout_rate", 0.1),
        use_target_mel_step2=cfg_d.get("use_target_mel_step2", False),
        target_mel_step2_val=cfg_d.get("target_mel_step2_val", 500.0),
        use_lstm=cfg_d.get("use_lstm", False),
    )
