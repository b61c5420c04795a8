"""Training (counterpart of speech_cloner_tpu/train): metrics, Adam with the
epoch-indexed LR, the encoder and decoder steps, BN recalibration, the loop
and the evaluators."""

from .optimizer import (
    Adam,
    OptimizerConfig,
    apply_updates,
    make_train_state,
    next_epoch,
)
from .steps import (
    DecoderLossConfig,
    decoder_eval_step,
    decoder_train_step,
    encoder_eval_step,
    encoder_train_step,
    f_mel_schedule,
)

__all__ = ["Adam", "DecoderLossConfig", "OptimizerConfig", "apply_updates",
           "decoder_eval_step", "decoder_train_step", "encoder_eval_step",
           "encoder_train_step", "f_mel_schedule", "make_train_state", "next_epoch"]
