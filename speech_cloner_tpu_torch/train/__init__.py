"""Training (counterpart of speech_cloner_tpu/train): metrics, Adam with the
epoch-indexed LR, the encoder, decoder and speaker-ID steps, BN
recalibration, the loop, the evaluators and the vocoded augmentation."""

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
    speaker_eval_step,
    speaker_train_step,
)

__all__ = ["Adam", "DecoderLossConfig", "OptimizerConfig", "apply_updates",
           "decoder_eval_step", "decoder_train_step", "encoder_eval_step",
           "encoder_train_step", "f_mel_schedule", "make_train_state", "next_epoch",
           "speaker_eval_step", "speaker_train_step"]
