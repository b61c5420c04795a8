"""Audio I/O (counterpart of the WAV part of speech_cloner_tpu/data)."""

from .audio_io import load_audio, read_riff_wav, write_riff_wav

__all__ = ["load_audio", "read_riff_wav", "write_riff_wav"]
