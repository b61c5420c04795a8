"""NN blocks (counterpart of speech_cloner_tpu/nn), eval forward."""

from .modules import (
    BANK_EMBED,
    BN_EPS,
    CBHG,
    GRU,
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
    gru_apply,
    maxpool1d_same,
    pack_bank_kernels,
)

__all__ = [
    "BANK_EMBED", "BN_EPS", "CBHG", "GRU", "BatchNorm", "CBHGConfig", "Conv1d",
    "Conv1dBanks", "Dense", "Highway", "Prenet", "bn_apply", "cbhg_init",
    "conv1d", "dense", "gru_apply", "maxpool1d_same", "pack_bank_kernels",
]
