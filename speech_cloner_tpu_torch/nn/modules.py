"""NN blocks: prenet / conv banks / highway / GRU / CBHG, eval forward.

Counterpart of ``speech_cloner_tpu/nn/modules.py`` with the same TF
semantics, so the same weights compute the same function:

- conv1d: TF 'same' padding, left (k-1)//2 and right k//2, applied with an
  explicit ``F.pad`` (``padding='same'`` pads the other side for even k);
  no bias. JAX kernels [W, I, O] are stored as torch weights [O, I, W].
- bn: tf.contrib batch_norm in eval mode: eps 1e-3, running statistics,
  ``rsqrt(var + eps)``. ``nn.BatchNorm1d`` is not used (other eps).
- conv banks: the K bank kernels (widths 1..K, 128 filters each) packed once,
  at construction, into one width-K conv.
- maxpool1d_same: pool 2, stride 1, one -inf pad on the right only.
- GRU: tf.contrib.rnn.GRUCell, gates [r, u], c = tanh(cx + (r*h) @ Wc_h).
  ``nn.GRU`` computes r * (W_hn h) and cannot stand in. The time scan is
  ``ops.cuda_kernels.gru_scan`` (the CUDA kernel for CUDA tensors); the GRU
  module packs each direction's recurrent weights for it once, at
  construction.

Parameters come in as the JAX package's pytree layout (``*_init`` below
builds one with a ``torch.Generator``; ``runtime.jax_params`` converts the
JAX package's own), and each module's constructor takes its piece of the
tree. Modules are built in float32 and run in the dtype of their parameters
and buffers: ``.to(torch.bfloat16)`` gives the JAX package's bf16
``compute_dtype`` forward (BN statistics cast too, as its ``_cast`` does), and
casts the GRU's packed weights with the rest. The JAX functions map to:
``dense``/``conv1d``/``bn_apply``/
``maxpool1d_same``/``pack_bank_kernels``/``gru_apply`` (same names),
``prenet_apply`` -> `Prenet`, ``highway_apply`` -> `Highway`,
``conv1d_banks_apply`` -> `Conv1dBanks`, ``cbhg_apply`` -> `CBHG`. Only the
eval forward is ported: training, dropout and the LSTM branch wait.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda_kernels import gru_dir_apply, pack_gru_weights

BN_EPS = 1e-3
BANK_EMBED = 256  # the reference's un-forwarded conv1d_banks default


def _tensor(a) -> torch.Tensor:
    """A float32 copy of a tree leaf (numpy array or tensor)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).clone()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _param(a) -> nn.Parameter:
    return nn.Parameter(_tensor(a), requires_grad=False)


# ------------------------------------------------------------ initializers ---

def glorot_uniform(generator: torch.Generator, shape, fan_in, fan_out) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


def dense_init(generator, in_dim, out_dim, bias_init: float = 0.0):
    return {"kernel": glorot_uniform(generator, (in_dim, out_dim), in_dim, out_dim),
            "bias": torch.full((out_dim,), bias_init)}


def conv1d_init(generator, width, in_dim, out_dim):
    return {"kernel": glorot_uniform(generator, (width, in_dim, out_dim),
                                     width * in_dim, width * out_dim)}


def bn_init(dim):
    return ({"gamma": torch.ones(dim), "beta": torch.zeros(dim)},
            {"mean": torch.zeros(dim), "var": torch.ones(dim)})


def prenet_init(generator, in_dim, embed_size):
    return {"dense1": dense_init(generator, in_dim, embed_size),
            "dense2": dense_init(generator, embed_size, embed_size // 2)}


def highway_init(generator, dim):
    return {"dense1": dense_init(generator, dim, dim),
            "dense2": dense_init(generator, dim, dim, bias_init=-1.0)}


def conv1d_banks_init(generator, K, in_dim, bank_channels: int = BANK_EMBED // 2):
    kernels = [conv1d_init(generator, k, in_dim, bank_channels)["kernel"]
               for k in range(1, K + 1)]
    bn_params, bn_state = bn_init(K * bank_channels)
    return {"kernels": kernels, "bn": bn_params}, {"bn": bn_state}


def gru_dir_init(generator, in_dim, units):
    n = in_dim + units
    return {"gates_kernel": glorot_uniform(generator, (n, 2 * units), n, 2 * units),
            "gates_bias": torch.ones(2 * units),      # TF GRUCell gate bias init 1.0
            "candidate_kernel": glorot_uniform(generator, (n, units), n, units),
            "candidate_bias": torch.zeros(units)}


def gru_init(generator, in_dim, units, bidirectional: bool = True):
    tree = {"fw": gru_dir_init(generator, in_dim, units)}
    if bidirectional:
        tree["bw"] = gru_dir_init(generator, in_dim, units)
    return tree


# --------------------------------------------------------------- functions ---

def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, kernel) + bias


def conv1d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """[B, T, C_in] x weight [C_out, C_in, W] -> [B, T, C_out], TF 'same' padding."""
    k = weight.shape[-1]
    return F.conv1d(F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2)), weight).transpose(1, 2)


def bn_apply(x, mean, var, gamma, beta) -> torch.Tensor:
    """Eval-mode batch norm over the last axis with running statistics."""
    inv = torch.rsqrt(var + BN_EPS)
    return (x - mean) * (inv * gamma) + beta


def maxpool1d_same(x: torch.Tensor) -> torch.Tensor:
    """pool_size=2, stride=1, 'same' on [B, T, C]: TF pads one -inf at the end."""
    shifted = torch.cat([x[:, 1:, :], torch.full_like(x[:, :1, :], -math.inf)], dim=1)
    return torch.maximum(x, shifted)


def pack_bank_kernels(kernels, K: int) -> torch.Tensor:
    """Pack bank kernels [k, in, c] (k = 1..K) into one [K, in, K*c] kernel.

    A width-k 'same' conv sits at offset (K-1)//2 - (k-1)//2 inside the
    width-K one, so both index x[t + i - (k-1)//2] alike; other taps are zero.
    """
    parts = []
    for kern in kernels:
        kern = _tensor(kern)
        k = kern.shape[0]
        off = (K - 1) // 2 - (k - 1) // 2
        parts.append(F.pad(kern, (0, 0, 0, 0, off, K - k - off)))
    return torch.cat(parts, dim=2)


def gru_apply(params, x: torch.Tensor, packed=None) -> torch.Tensor:
    """Uni/bidirectional GRU [B, T, C] -> [B, T, H or 2H]; [fw, bw] on channels.
    ``packed``: {direction: `pack_gru_weights` of its recurrent weights}, or None."""
    packed = packed or {}
    fw = gru_dir_apply(params["fw"], x, packed.get("fw"))
    if "bw" not in params:
        return fw
    bw = gru_dir_apply(params["bw"], x.flip(1), packed.get("bw")).flip(1)
    return torch.cat([fw, bw], dim=2)


# ----------------------------------------------------------------- modules ---

class Dense(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.kernel = _param(p["kernel"])
        self.bias = _param(p["bias"])

    def forward(self, x):
        return dense(x, self.kernel, self.bias)


class BatchNorm(nn.Module):
    """Eval-mode batch norm; ``p`` = {gamma, beta}, ``s`` = {mean, var}."""

    def __init__(self, p, s):
        super().__init__()
        self.gamma, self.beta = _param(p["gamma"]), _param(p["beta"])
        self.mean, self.var = _param(s["mean"]), _param(s["var"])

    def forward(self, x):
        return bn_apply(x, self.mean, self.var, self.gamma, self.beta)


class Conv1d(nn.Module):
    """TF-'same' conv without bias from a JAX kernel [W, I, O]."""

    def __init__(self, p):
        super().__init__()
        self.weight = _param(_tensor(p["kernel"]).permute(2, 1, 0).contiguous())

    def forward(self, x):
        return conv1d(x, self.weight)


class Prenet(nn.Module):
    """dense -> relu -> dense -> relu (dropout is a training op)."""

    def __init__(self, p):
        super().__init__()
        self.dense1, self.dense2 = Dense(p["dense1"]), Dense(p["dense2"])

    def forward(self, x):
        return torch.relu(self.dense2(torch.relu(self.dense1(x))))


class Highway(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.dense1, self.dense2 = Dense(p["dense1"]), Dense(p["dense2"])

    def forward(self, x):
        H = torch.relu(self.dense1(x))
        T = torch.sigmoid(self.dense2(x))
        return H * T + x * (1.0 - T)


class Conv1dBanks(nn.Module):
    """K bank convs packed into one width-K conv, then BN and relu."""

    def __init__(self, p, s):
        super().__init__()
        K = len(p["kernels"])
        packed = pack_bank_kernels(p["kernels"], K)               # [K, in, K*c]
        self.weight = _param(packed.permute(2, 1, 0).contiguous())  # [K*c, in, K]
        self.bn = BatchNorm(p["bn"], s["bn"])

    def forward(self, x):
        return torch.relu(self.bn(conv1d(x, self.weight)))


class GRU(nn.Module):
    """Uni/bidirectional GRU from the JAX tree {fw: {...}, bw: {...}}. Each
    direction's recurrent weights are also kept packed by CTA for the scan
    kernel (buffer ``packed_<dir>``, derived, not in the state dict), in
    the parameters' dtype: packing only moves values, so ``.to(dtype)``
    casting the buffer equals repacking the cast weights."""

    def __init__(self, p):
        super().__init__()
        self.dirs = nn.ModuleDict({
            d: nn.ParameterDict({k: _param(v) for k, v in p[d].items()})
            for d in ("fw", "bw") if d in p})
        for d, pd in self.dirs.items():
            H = pd["candidate_bias"].shape[0]
            self.register_buffer(f"packed_{d}", pack_gru_weights(
                pd["gates_kernel"][-H:], pd["candidate_kernel"][-H:]), persistent=False)

    def forward(self, x):
        return gru_apply(self.dirs, x, {d: getattr(self, f"packed_{d}") for d in self.dirs})


@dataclasses.dataclass(frozen=True)
class CBHGConfig:
    embed_size: int
    num_banks: int
    num_highway: int
    use_lstm: bool = False
    fused_gru: bool = False
    scan_unroll: int = 1     # a lax.scan knob in the JAX package; no effect here


def cbhg_init(generator, cfg: CBHGConfig, in_dim=None):
    """(params, state) trees in the JAX layout; in_dim defaults to embed_size//2."""
    if in_dim is None:
        in_dim = cfg.embed_size // 2
    E2 = cfg.embed_size // 2
    banks_params, banks_state = conv1d_banks_init(generator, cfg.num_banks, in_dim)
    bn1_p, bn1_s = bn_init(E2)
    bn2_p, bn2_s = bn_init(E2)
    params = {
        "banks": banks_params,
        "conv1d_1": conv1d_init(generator, 3, cfg.num_banks * (BANK_EMBED // 2), E2),
        "bn1": bn1_p,
        "conv1d_2": conv1d_init(generator, 3, E2, E2),
        "bn2": bn2_p,
        "highway": [highway_init(generator, E2) for _ in range(cfg.num_highway)],
        "gru": gru_init(generator, E2, E2, bidirectional=True),
    }
    state = {"banks": banks_state, "bn1": bn1_s, "bn2": bn2_s}
    return params, state


class CBHG(nn.Module):
    """[B, T, E/2] -> [B, T, E]: banks -> maxpool -> 2 conv projections with
    BN -> residual -> highway stack -> bidirectional GRU."""

    def __init__(self, p, s, cfg: CBHGConfig):
        super().__init__()
        if cfg.use_lstm:
            raise NotImplementedError("CBHG use_lstm=True is not ported yet "
                                      "(ROADMAP queue 1, \"The rest\": the LSTM branch)")
        if cfg.fused_gru:
            raise NotImplementedError("CBHG fused_gru=True is not ported yet (ROADMAP "
                                      "queue 2, \"Follow-ons\": the both-directions "
                                      "kernel)")
        self.cfg = cfg
        self.banks = Conv1dBanks(p["banks"], s["banks"])
        self.conv1d_1, self.bn1 = Conv1d(p["conv1d_1"]), BatchNorm(p["bn1"], s["bn1"])
        self.conv1d_2, self.bn2 = Conv1d(p["conv1d_2"]), BatchNorm(p["bn2"], s["bn2"])
        self.highway = nn.ModuleList(Highway(hw) for hw in p["highway"])
        self.gru = GRU(p["gru"])

    def forward(self, x):
        h = maxpool1d_same(self.banks(x))
        h = torch.relu(self.bn1(self.conv1d_1(h)))
        h = self.bn2(self.conv1d_2(h)) + x
        for hw in self.highway:
            h = hw(h)
        return self.gru(h)
