"""Model families (counterpart of speech_cloner_tpu/models): encoder,
decoder, speaker-ID CNN."""

from . import decoder, encoder, speaker_id
from .decoder import Decoder, DecoderConfig, DecoderStepConfig
from .encoder import Encoder, EncoderConfig
from .speaker_id import SpeakerId, SpeakerIdConfig

__all__ = ["Decoder", "DecoderConfig", "DecoderStepConfig", "Encoder",
           "EncoderConfig", "SpeakerId", "SpeakerIdConfig", "decoder", "encoder",
           "speaker_id"]
