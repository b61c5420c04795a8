"""Two-step spectrogram decoder: PPG -> target-speaker mel -> linear spectrogram.

Counterpart of ``speech_cloner_tpu/models/decoder.py``:

  step1: prenet(E=256) -> CBHG(K=32, hwy=4) -> dense(80)  = y_mel
  step2: prenet(E=512) -> CBHG(K=32, hwy=6) -> dense(201) = y_stft

Eval forward only: step2 consumes y_mel. The scheduled target-mel mix is a
training input and waits with training. `cast` makes the copy that runs in
another dtype (the pipeline's ``compute_dtype``).
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

    def forward(self, x):
        return self.y_logits(self.cbhg(self.prenet(x)))


class Decoder(nn.Module):
    """Built from (params, state) trees in the JAX package's layout."""

    def __init__(self, params, state, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.step1 = DecoderStep(params["step1"], state["step1"], cfg.step1)
        self.step2 = DecoderStep(params["step2"], state["step2"], cfg.step2)

    def forward(self, ppg: torch.Tensor):
        """[B, T, 61] PPG -> (y_mel [B, T, 80], y_stft [B, T, 201])."""
        y_mel = self.step1(ppg)
        return y_mel, self.step2(y_mel)


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


def apply(model: Decoder, ppg: torch.Tensor):
    """Eval forward: PPG [B, T, 61] -> (y_mel, y_stft)."""
    return model(ppg)


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
