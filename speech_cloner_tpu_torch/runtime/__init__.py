"""Runtime: configs, checkpoint reading, JAX weight transfer."""

from .checkpoint import Checkpointer
from .config import DEFAULT_DS_CFG, derive_audio_fields, feature_config_from_cfg_d, load_cfg_d
from .jax_params import decoder_from_jax, encoder_from_jax

__all__ = ["Checkpointer", "DEFAULT_DS_CFG", "decoder_from_jax", "derive_audio_fields",
           "encoder_from_jax", "feature_config_from_cfg_d", "load_cfg_d"]
