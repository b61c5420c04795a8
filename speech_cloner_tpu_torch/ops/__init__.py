"""DSP ops and the CUDA kernels (counterpart of speech_cloner_tpu/ops)."""

from .cuda_kernels import gru_dir_apply, gru_scan, gru_scan_plain
from .db import amplitude_to_db, db_to_amplitude, db_to_power, power_to_db
from .features import FeatureConfig, feature_matrices, mfcc_input
from .griffin_lim import from_power_to_wav, griffin_lim
from .mel import dct_basis, mel_filterbank
from .preemphasis import inv_preemphasis, inv_preemphasis_np, preemphasis
from .stft import istft, stft, window_sumsquare
from .windows import get_window, hann_periodic, pad_center

__all__ = [
    "FeatureConfig", "amplitude_to_db", "db_to_amplitude", "db_to_power",
    "dct_basis", "feature_matrices", "from_power_to_wav", "get_window", "griffin_lim",
    "gru_dir_apply", "gru_scan", "gru_scan_plain", "hann_periodic",
    "inv_preemphasis", "inv_preemphasis_np", "istft", "mel_filterbank", "mfcc_input", "pad_center",
    "power_to_db", "preemphasis", "stft", "window_sumsquare",
]
