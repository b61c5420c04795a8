"""Runtime: configs, checkpoints (.npz and TF bundles), JAX weight transfer
both ways, metrics logging, profiling (``runtime.profiler``)."""

from .checkpoint import Checkpointer, load_decoder_weights, load_encoder_weights, restore_params
from .config import (DEFAULT_DS_CFG, derive_audio_fields, feature_config_from_cfg_d, load_cfg_d,
                     make_dir_path, save_cfg_d, show_diff)
from .jax_params import decoder_from_jax, decoder_to_jax, encoder_from_jax, encoder_to_jax
from .logging import MetricsWriter, StepTimer
from .tf_import import load_tf_decoder, load_tf_encoder, load_tf_scalars

__all__ = ["Checkpointer", "DEFAULT_DS_CFG", "MetricsWriter", "StepTimer", "decoder_from_jax",
           "decoder_to_jax", "derive_audio_fields", "encoder_from_jax", "encoder_to_jax",
           "feature_config_from_cfg_d", "load_cfg_d",
           "load_decoder_weights", "load_encoder_weights", "load_tf_decoder",
           "load_tf_encoder", "load_tf_scalars", "make_dir_path", "restore_params",
           "save_cfg_d", "show_diff"]
