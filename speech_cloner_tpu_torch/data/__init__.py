"""Data (counterpart of speech_cloner_tpu/data): audio I/O (RIFF WAV, NIST
SPHERE, mp3 and ffmpeg-decoded audio), the dataset base with its feature
cache and window samplers, the TIMIT, ARCTIC and target-speaker readers, the
packed cache with its host library, the device-resident store, the
synthetic corpus and the spectrogram pictures."""

from .audio_io import can_decode_mp3, load_audio, read_nist_sphere, read_riff_wav, write_riff_wav

__all__ = ["can_decode_mp3", "load_audio", "read_nist_sphere", "read_riff_wav",
           "write_riff_wav"]
