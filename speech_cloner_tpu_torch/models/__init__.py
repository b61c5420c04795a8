"""Model families (counterpart of speech_cloner_tpu/models): encoder, decoder."""

from . import decoder, encoder
from .decoder import Decoder, DecoderConfig, DecoderStepConfig
from .encoder import Encoder, EncoderConfig

__all__ = ["Decoder", "DecoderConfig", "DecoderStepConfig", "Encoder",
           "EncoderConfig", "decoder", "encoder"]
