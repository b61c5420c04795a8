"""NN blocks (counterpart of speech_cloner_tpu/nn), eval and train forward."""

from .modules import (
    BANK_EMBED,
    BN_EPS,
    BN_MOMENTUM,
    CBHG,
    GRU,
    LSTM,
    BatchNorm,
    CBHGConfig,
    Conv1d,
    Conv1dBanks,
    Dense,
    Highway,
    Prenet,
    bn_apply,
    cbhg_init,
    conv1d,
    dense,
    dropout,
    gru_apply,
    gru_apply_fused,
    lstm_apply,
    lstm_dir_apply,
    maxpool1d_same,
    pack_bank_kernels,
)

__all__ = [
    "BANK_EMBED", "BN_EPS", "BN_MOMENTUM", "CBHG", "GRU", "LSTM", "BatchNorm",
    "CBHGConfig", "Conv1d", "Conv1dBanks", "Dense", "Highway", "Prenet", "bn_apply",
    "cbhg_init", "conv1d", "dense", "dropout", "gru_apply", "gru_apply_fused", "lstm_apply",
    "lstm_dir_apply", "maxpool1d_same", "pack_bank_kernels",
]
