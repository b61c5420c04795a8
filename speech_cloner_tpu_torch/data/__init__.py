"""Data (counterpart of speech_cloner_tpu/data): audio I/O (RIFF WAV, NIST
SPHERE), the dataset base with its feature cache and window samplers, and
the TIMIT and ARCTIC readers."""

from .audio_io import load_audio, read_nist_sphere, read_riff_wav, write_riff_wav

__all__ = ["load_audio", "read_nist_sphere", "read_riff_wav", "write_riff_wav"]
