"""NN blocks: prenet / conv banks / highway / GRU / CBHG, eval and train.

Counterpart of ``speech_cloner_tpu/nn/modules.py`` with the same TF
semantics, so the same weights compute the same function:

- conv1d: TF 'same' padding, left (k-1)//2 and right k//2, applied with an
  explicit ``F.pad`` (``padding='same'`` pads the other side for even k);
  no bias. Kernels keep the JAX layout [W, I, O] and are viewed as torch
  weights [O, I, W] in the forward.
- bn: tf.contrib batch_norm: eps 1e-3, ``rsqrt(var + eps)``. Eval mode uses
  the running statistics; train mode the batch's, in float32 over every
  axis but the last, with the population variance, and moves the running
  statistics to ``m*old + (1-m)*batch`` (m = 0.999, or ``bn_momentum``;
  0 gives the batch statistics) in place, without gradient.
  ``nn.BatchNorm1d`` is not used (other eps).
- dropout: a mask drawn from the caller's ``torch.Generator``, kept values
  scaled by 1/keep (the JAX ``dropout``); train mode only.
- conv banks: the K bank kernels (widths 1..K, 128 filters each) stay one
  parameter per width. float32 conversion on the card (under
  ``torch.inference_mode``) runs them as they are, over their nonzero taps
  only (the CUDA kernel ``ops.cuda_kernels.conv_banks``); training, bf16
  and the CPU pack them into one width-K conv (the JAX package's form), so
  gradients reach only their live taps.
- maxpool1d_same: pool 2, stride 1, one -inf pad on the right only.
- GRU: tf.contrib.rnn.GRUCell, gates [r, u], c = tanh(cx + (r*h) @ Wc_h).
  ``nn.GRU`` computes r * (W_hn h) and cannot stand in. The time scan is
  ``ops.cuda_kernels.gru_scan`` (the CUDA kernels for CUDA tensors, with a
  backward kernel when autograd records); ``fused_gru`` runs both
  directions in one scan (`gru_apply_fused`).
- LSTM (CBHG ``use_lstm``): tf.contrib.rnn.LSTMCell, one kernel
  [(C+H), 4H], gates i, j, f, o, c' = sigmoid(f + forget_bias) * c +
  sigmoid(i) * tanh(j), h' = sigmoid(o) * tanh(c'). ``forget_bias`` is a
  0-d parameter that Adam moves, as the JAX package trains its leaf (TF1's
  cell holds it constant). ``nn.LSTM`` orders its gates i, f, g, o and has
  no forget bias of its own. The JAX package runs a ``lax.scan`` with no
  kernel here, so the port runs a plain loop over T on either device. In
  the tree the LSTM sits under CBHG's key "gru", as in the JAX package.

Per-row lengths (`CBHG` ``lengths``, a batch of sequences of different
lengths, frames at and past a row's length padding): the padded frames
read as the convolutions' zero padding and the max-pool's -inf, and the
backward recurrence starts at each row's own last frame (`reverse_rows`
around the scan), so each row gives what it gives alone. Without lengths
nothing of this runs.

Derived tensors (the banks packed for the width-K conv, the torch-layout
conv weights, the GRU's recurrent weights packed by CTA for the scan's
forward and backward) are taken from a cache keyed by each source
parameter's version counter, storage, dtype and device: an optimizer step,
a ``load``, a ``.to()`` or
any in-place change invalidates it, so a stale copy cannot be used. Those
that autograd differentiates (the banks, the conv weights) are made afresh
in every forward it records; the GRU's packs hold no graph and are cached
then too, one pack per weight version. Only the module's own parameters are
cached from: a tensor standing in for one (the bf16 casts a
``torch.func.functional_call`` of a bf16 train step passes) is used once,
so no cache holds a cast of an old step.

Parameters come in as the JAX package's pytree layout (``*_init`` below
builds one with a ``torch.Generator``; ``runtime.jax_params`` converts the
JAX package's own) and go out the same way (``params_tree()`` /
``state_tree()`` of each module return its parameters and BN buffers, the
live tensors, in that layout). Modules are built in float32 and run in the
dtype of their parameters and buffers: ``.to(torch.bfloat16)`` gives the
JAX package's bf16 ``compute_dtype`` forward (BN statistics cast too, as
its ``_cast`` does). The JAX functions map to: ``dense``/``conv1d``/
``bn_apply``/``dropout``/``maxpool1d_same``/``pack_bank_kernels``/
``gru_apply``/``gru_apply_fused`` (same names), ``prenet_apply`` ->
`Prenet`, ``highway_apply`` -> `Highway`, ``conv1d_banks_apply`` ->
`Conv1dBanks`, ``cbhg_apply`` -> `CBHG`, ``lstm_apply`` -> `LSTM`
(``_lstm_dir_apply`` -> `lstm_dir_apply`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda_kernels import (conv_banks, gru_dir_apply, gru_scan_fused, pack_gru_weights,
                                pack_gru_weights_bwd)
from ..parallel.collectives import all_reduce_sum, copy_to_model, reduce_from_model

BN_EPS = 1e-3
BN_MOMENTUM = 0.999
BANK_EMBED = 256  # the reference's un-forwarded conv1d_banks default


def _tensor(a) -> torch.Tensor:
    """A float32 copy of a tree leaf (numpy array or tensor)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).clone()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _param(a) -> nn.Parameter:
    return nn.Parameter(_tensor(a))


def _recording(*sources: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(s.requires_grad for s in sources)


class Derived(nn.Module):
    """Base of the modules that compute a tensor from their parameters
    (`derived`): cached until a source changes, and fresh while autograd
    records unless ``make`` reads only detached values (``detached``).
    ``.to()`` and friends drop the cache."""

    def __init__(self):
        super().__init__()
        self._derived: dict[str, tuple] = {}

    def derived(self, name: str, sources, make, detached: bool = False):
        # inference tensors (parameters made under inference_mode) keep no
        # version counter, and a tensor in a parameter's place (a cast of it)
        # may be freed and its storage reused at version 0: no cache for them
        if (not detached and _recording(*sources)) or any(
                s.is_inference() or not isinstance(s, nn.Parameter) for s in sources):
            return make()
        key = tuple((s._version, s.data_ptr(), s.dtype, s.device) for s in sources)
        hit = self._derived.get(name)
        if hit is None or hit[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                hit = (key, make())
            self._derived[name] = hit
        return hit[1]

    def _apply(self, fn, *args, **kwargs):
        self._derived.clear()
        return super()._apply(fn, *args, **kwargs)


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


def lstm_dir_init(generator, in_dim, units, forget_bias: float = 1.0):
    """tf.contrib.rnn.LSTMCell layout: one kernel [(in+H), 4H], gates i, j
    (the cell candidate), f, o; ``forget_bias`` a 0-d leaf."""
    n = in_dim + units
    return {"kernel": glorot_uniform(generator, (n, 4 * units), n, 4 * units),
            "bias": torch.zeros(4 * units),
            "forget_bias": torch.tensor(float(forget_bias))}


def lstm_init(generator, in_dim, units, bidirectional: bool = True):
    tree = {"fw": lstm_dir_init(generator, in_dim, units)}
    if bidirectional:
        tree["bw"] = lstm_dir_init(generator, in_dim, units)
    return tree


# --------------------------------------------------------------- functions ---

def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, kernel) + bias


def conv1d(x: torch.Tensor, weight: torch.Tensor, pad=None) -> torch.Tensor:
    """[B, T, C_in] x weight [C_out, C_in, W] -> [B, T', C_out]: TF 'same'
    padding, or ``pad`` = (left, right) zero rows.

    bf16 on the CPU is computed in float32 and rounded back: oneDNN's bf16
    convolution returns wrong values for some shapes at 1-4 threads (the
    decoder's step-2 projection, [3, 4096, 402] by [256, 4096, 3]); the sums
    are float32 either way. CUDA tensors convolve in their own dtype."""
    k = weight.shape[-1]
    xp = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2) if pad is None else pad)
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return F.conv1d(xp.float(), weight.float()).to(x.dtype).transpose(1, 2)
    return F.conv1d(xp, weight).transpose(1, 2)


def bn_apply(x, mean, var, gamma, beta) -> torch.Tensor:
    """Batch norm over the last axis with the given statistics."""
    inv = torch.rsqrt(var.to(x.dtype) + BN_EPS)
    return (x - mean.to(x.dtype)) * (inv * gamma) + beta


def bn_batch_moments(x: torch.Tensor, group=None):
    """(mean, population variance) of x over every axis but the last, in
    float32 (the JAX ``bn_apply``'s train-mode moments). With a 'data'
    process ``group`` the moments are the global batch's (each rank holds an
    equal share of the rows), in two passes as ``jnp.var`` takes them: the
    sums for the mean, then the squared deviations from it."""
    axes = tuple(range(x.dim() - 1))
    xf = x.to(torch.float32)
    if group is None:
        return xf.mean(dim=axes), xf.var(dim=axes, correction=0)
    n = xf.numel() // xf.shape[-1] * torch.distributed.get_world_size(group)
    mean = all_reduce_sum(xf.sum(dim=axes), group) / n
    return mean, all_reduce_sum(torch.square(xf - mean).sum(dim=axes), group) / n


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Keep each value with probability 1 - rate (a mask from ``generator``)
    and scale kept values by 1 / (1 - rate); the identity at rate 0. With
    ``rows`` = (i, n), x is block i of n equal row blocks of a batch: the
    whole batch's mask is drawn and block i kept, so the draws do not depend
    on how the batch is split."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape if rows is None else (x.shape[0] * rows[1], *x.shape[1:])
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if rows is not None:
        mask = mask[rows[0] * x.shape[0]:(rows[0] + 1) * x.shape[0]]
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


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
        kern = kern if isinstance(kern, torch.Tensor) else _tensor(kern)
        k = kern.shape[0]
        off = (K - 1) // 2 - (k - 1) // 2
        parts.append(F.pad(kern, (0, 0, 0, 0, off, K - k - off)))
    return torch.cat(parts, dim=2)


def length_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T, 1] bool: frame t of row b lies before ``lengths[b]``."""
    return (torch.arange(T, device=lengths.device) < lengths[:, None])[..., None]


def reverse_rows(x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, T, C] with each row's first ``lengths[b]`` frames in reverse
    order and its padding left where it is (``x.flip(1)`` without lengths);
    its own inverse."""
    if lengths is None:
        return x.flip(1)
    t = torch.arange(x.shape[1], device=x.device)
    idx = torch.where(t < lengths[:, None], lengths[:, None] - 1 - t, t)
    return x.gather(1, idx[..., None].expand_as(x))


def gru_apply(params, x: torch.Tensor, packed=None, packed_bwd=None,
              lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Uni/bidirectional GRU [B, T, C] -> [B, T, H or 2H]; [fw, bw] on channels.
    ``packed`` / ``packed_bwd``: {direction: `pack_gru_weights` /
    `pack_gru_weights_bwd` of its recurrent weights}, or None. ``lengths``
    [B]: the backward direction starts at each row's last frame."""
    packed, packed_bwd = packed or {}, packed_bwd or {}
    fw = gru_dir_apply(params["fw"], x, packed.get("fw"), packed_bwd.get("fw"))
    if "bw" not in params:
        return fw
    bw = reverse_rows(gru_dir_apply(params["bw"], reverse_rows(x, lengths), packed.get("bw"),
                                    packed_bwd.get("bw")), lengths)
    return torch.cat([fw, bw], dim=2)


def gru_apply_fused(params, x: torch.Tensor, packed: torch.Tensor | None = None,
                    packed_bwd: torch.Tensor | None = None) -> torch.Tensor:
    """Bidirectional GRU with both directions in ONE scan (`gru_scan_fused`:
    one kernel launch, T dependent steps instead of 2T): [B, T, C] ->
    [B, T, 2H], [fw, bw] on channels, the same function as `gru_apply`.
    Both directions' input projections are one matmul over all steps; the
    backward direction reads its inputs in time order and the kernel runs
    it backwards, so nothing is flipped. ``packed``: [2, C, 3*Hc, H], each
    direction's `pack_gru_weights`, or None; ``packed_bwd`` the same of
    `pack_gru_weights_bwd`. Unidirectional trees take `gru_apply`."""
    if "bw" not in params:
        first = lambda t: None if t is None else {"fw": t[0]}  # noqa: E731
        return gru_apply(params, x, first(packed), first(packed_bwd))
    fw, bw = params["fw"], params["bw"]
    B, T, C = x.shape
    H = fw["candidate_bias"].shape[0]
    W = torch.cat([fw["gates_kernel"][:C], fw["candidate_kernel"][:C],
                   bw["gates_kernel"][:C], bw["candidate_kernel"][:C]], dim=1)
    b = torch.cat([fw["gates_bias"], fw["candidate_bias"], bw["gates_bias"], bw["candidate_bias"]])
    proj = (torch.matmul(x, W) + b).reshape(B, T, 2, 3 * H).permute(2, 1, 0, 3)  # [2, T, B, 3H]
    gx, cx = proj[..., :2 * H].contiguous(), proj[..., 2 * H:].contiguous()
    Wg = torch.stack([fw["gates_kernel"][C:], bw["gates_kernel"][C:]])
    Wc = torch.stack([fw["candidate_kernel"][C:], bw["candidate_kernel"][C:]])
    ys = gru_scan_fused(gx, cx, Wg, Wc, packed, packed_bwd)         # [2, T, B, H]
    return torch.cat([ys[0], ys[1]], dim=2).transpose(0, 1)


def lstm_dir_apply(params, x: torch.Tensor) -> torch.Tensor:
    """One LSTM direction [B, T, C] -> [B, T, H]: the input projection of
    every step in one matmul, then a loop over T from c = h = 0."""
    B, T, C = x.shape
    kernel, fb = params["kernel"], params["forget_bias"]
    H = kernel.shape[1] // 4
    Wh = kernel[C:]
    xb = (torch.matmul(x, kernel[:C]) + params["bias"]).unbind(1)
    c = h = x.new_zeros(B, H)
    ys = []
    for t in range(T):
        i, j, f, o = torch.addmm(xb[t], h, Wh).chunk(4, dim=1)
        c = torch.sigmoid(f + fb) * c + torch.sigmoid(i) * torch.tanh(j)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1)


def lstm_apply(params, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Uni/bidirectional LSTM [B, T, C] -> [B, T, H or 2H]; [fw, bw] on
    channels, the backward direction run on the time-reversed input (each
    row's first ``lengths[b]`` frames reversed, with lengths)."""
    fw = lstm_dir_apply(params["fw"], x)
    if "bw" not in params:
        return fw
    bw = reverse_rows(lstm_dir_apply(params["bw"], reverse_rows(x, lengths)), lengths)
    return torch.cat([fw, bw], dim=2)


# ----------------------------------------------------------------- modules ---

class Dense(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.kernel = _param(p["kernel"])
        self.bias = _param(p["bias"])

    def forward(self, x):
        return dense(x, self.kernel, self.bias)

    def params_tree(self):
        return {"kernel": self.kernel, "bias": self.bias}


class BatchNorm(nn.Module):
    """Batch norm; ``p`` = {gamma, beta} (parameters), ``s`` = {mean, var}
    (buffers: the running statistics)."""

    def __init__(self, p, s):
        super().__init__()
        self.gamma, self.beta = _param(p["gamma"]), _param(p["beta"])
        self.register_buffer("mean", _tensor(s["mean"]))
        self.register_buffer("var", _tensor(s["var"]))
        self.data_group = None    # a 'data' process group: moments over the global batch

    def forward(self, x, train: bool = False, momentum: float | None = None):
        """Eval: the running statistics. Train: the batch's (float32, every
        axis but the last; the global batch's under ``data_group``), and the
        running ones move to m*old + (1-m)*batch (m = BN_MOMENTUM unless
        ``momentum`` is given)."""
        if not train:
            return bn_apply(x, self.mean, self.var, self.gamma, self.beta)
        mean, var = bn_batch_moments(x, self.data_group)
        m = BN_MOMENTUM if momentum is None else momentum
        with torch.no_grad():
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        return bn_apply(x, mean, var, self.gamma, self.beta)

    def params_tree(self):
        return {"gamma": self.gamma, "beta": self.beta}

    def state_tree(self):
        return {"mean": self.mean, "var": self.var}


class Conv1d(Derived):
    """TF-'same' conv without bias; ``kernel`` in the JAX layout [W, I, O]."""

    def __init__(self, p):
        super().__init__()
        self.kernel = _param(p["kernel"])

    def weight(self) -> torch.Tensor:
        """The torch layout [O, I, W]."""
        return self.derived("weight", (self.kernel,),
                            lambda: self.kernel.permute(2, 1, 0).contiguous())

    def forward(self, x):
        return conv1d(x, self.weight())

    def params_tree(self):
        return {"kernel": self.kernel}


class Prenet(nn.Module):
    """dense -> relu -> dropout -> dense -> relu -> dropout (dropout in train
    mode only, its masks drawn from ``generator``; ``rows`` = (i, n) when the
    batch is row block i of n, see `dropout`)."""

    def __init__(self, p):
        super().__init__()
        self.dense1, self.dense2 = Dense(p["dense1"]), Dense(p["dense2"])
        self.rows = None

    def forward(self, x, dropout_rate: float = 0.0, train: bool = False,
                generator: torch.Generator | None = None):
        h = torch.relu(self.dense1(x))
        if train:
            h = dropout(h, dropout_rate, generator, self.rows)
        h = torch.relu(self.dense2(h))
        if train:
            h = dropout(h, dropout_rate, generator, self.rows)
        return h

    def params_tree(self):
        return {"dense1": self.dense1.params_tree(), "dense2": self.dense2.params_tree()}


class Highway(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.dense1, self.dense2 = Dense(p["dense1"]), Dense(p["dense2"])

    def forward(self, x):
        H = torch.relu(self.dense1(x))
        T = torch.sigmoid(self.dense2(x))
        return H * T + x * (1.0 - T)

    def params_tree(self):
        return {"dense1": self.dense1.params_tree(), "dense2": self.dense2.params_tree()}


def bank_kernel_takes(x, kernels) -> bool:
    """Whether `Conv1dBanks.conv` runs the bank kernel: x on a CUDA device,
    float32, an inference tensor (made under ``torch.inference_mode``, as
    every conversion path runs: convert, the streams, the sequence-parallel
    shards), and autograd not recording through x or the kernels. A
    training step keeps the packed conv throughout: its own forward, which
    autograd records, and its frozen encoder's, which runs under no_grad."""
    return (x.is_cuda and x.dtype == torch.float32 and x.is_inference()
            and not _recording(x, *kernels))


class Conv1dBanks(Derived):
    """K bank convs (one kernel [k, in, c] per width k), then BN and relu.
    Callers take `weight()` and hand it to `conv`, then the batch norm."""

    def __init__(self, p, s):
        super().__init__()
        self.kernels = nn.ParameterList(_param(k) for k in p["kernels"])
        self.bn = BatchNorm(p["bn"], s["bn"])

    def weight(self) -> list[torch.Tensor]:
        """The bank kernels [k, in, c], k = 1..K, as the bank kernel reads them."""
        return list(self.kernels)

    def packed(self) -> torch.Tensor:
        """The bank kernels packed into the width-K conv's torch-layout
        weight [K*c, in, K], once per version of the parameters."""
        return self.derived("packed", tuple(self.kernels), lambda: pack_bank_kernels(
            list(self.kernels), len(self.kernels)).permute(2, 1, 0).contiguous())

    def conv(self, x, kernels, pad=None) -> torch.Tensor:
        """The bank convolutions of x [B, T, in] with ``kernels`` (`weight()`):
        [B, T + left + right - K + 1, K*c], bank k in channels [(k-1)c, kc);
        ``pad`` (left, right) zero rows, TF 'same' by default. By what x
        shows (`bank_kernel_takes`): a CUDA float32 inference tensor runs
        the bank kernel (`conv_banks`); training (whose gradient the packed
        conv gives, and whose frozen encoder runs under no_grad), bf16 and
        the CPU run the packed width-K conv."""
        if bank_kernel_takes(x, kernels):
            return conv_banks(x, kernels, pad)
        return conv1d(x, self.packed(), pad)

    def forward(self, x, train: bool = False, bn_momentum: float | None = None):
        return torch.relu(self.bn(self.conv(x, self.weight()), train, bn_momentum))

    def params_tree(self):
        return {"kernels": list(self.kernels), "bn": self.bn.params_tree()}

    def state_tree(self):
        return {"bn": self.bn.state_tree()}


class GRU(Derived):
    """Uni/bidirectional GRU from the JAX tree {fw: {...}, bw: {...}};
    ``fused`` runs both directions in one scan (`gru_apply_fused`). Each
    direction's recurrent weights packed by CTA for the scan kernel's
    forward (``packed_<dir>``) and, when autograd records, its backward
    (`packed_bwd`), derived and not in the state dict, are packed once per
    version of the weights (see `Derived`), in the parameters' dtype."""

    def __init__(self, p, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.dirs = nn.ModuleDict({
            d: nn.ParameterDict({k: _param(v) for k, v in p[d].items()})
            for d in ("fw", "bw") if d in p})

    def _pack(self, name: str, d: str, pack) -> torch.Tensor:
        pd = self.dirs[d]
        H = pd["candidate_bias"].shape[0]
        src = (pd["gates_kernel"], pd["candidate_kernel"])
        return self.derived(f"{name}_{d}", src, lambda: pack(
            src[0].detach()[-H:], src[1].detach()[-H:]), detached=True)

    def packed(self, d: str) -> torch.Tensor:
        """`pack_gru_weights` of direction ``d``'s recurrent weights."""
        return self._pack("packed", d, pack_gru_weights)

    def packed_bwd(self, d: str) -> torch.Tensor:
        """`pack_gru_weights_bwd` of direction ``d``'s recurrent weights."""
        return self._pack("packed_bwd", d, pack_gru_weights_bwd)

    @property
    def packed_fw(self) -> torch.Tensor:
        return self.packed("fw")

    @property
    def packed_bw(self) -> torch.Tensor:
        return self.packed("bw")

    def forward(self, x, lengths: torch.Tensor | None = None):
        """``lengths`` [B]: each row's backward direction starts at its own
        last frame (one scan a direction, around `reverse_rows`)."""
        on_card = x.device.type == "cuda"
        # the backward's packs, where autograd records a launch
        bwd = on_card and _recording(x, *self.parameters())
        if self.fused and "bw" in self.dirs and lengths is None:
            stack = lambda pack: (torch.stack([pack("fw"), pack("bw")])  # noqa: E731
                                  if on_card else None)
            return gru_apply_fused(self.dirs, x, stack(self.packed),
                                   stack(self.packed_bwd) if bwd else None)
        return gru_apply(self.dirs, x, {d: self.packed(d) for d in self.dirs} if on_card else None,
                         {d: self.packed_bwd(d) for d in self.dirs} if bwd else None, lengths)

    def params_tree(self):
        return {d: dict(pd.items()) for d, pd in self.dirs.items()}


class LSTM(nn.Module):
    """Uni/bidirectional LSTM from the JAX tree {fw: {kernel, bias,
    forget_bias}, bw: {...}} (`lstm_apply`)."""

    def __init__(self, p):
        super().__init__()
        self.dirs = nn.ModuleDict({
            d: nn.ParameterDict({k: _param(v) for k, v in p[d].items()})
            for d in ("fw", "bw") if d in p})

    def forward(self, x, lengths: torch.Tensor | None = None):
        return lstm_apply(self.dirs, x, lengths)

    def params_tree(self):
        return {d: dict(pd.items()) for d, pd in self.dirs.items()}


@dataclasses.dataclass(frozen=True)
class CBHGConfig:
    embed_size: int
    num_banks: int
    num_highway: int
    use_lstm: bool = False
    fused_gru: bool = False  # no effect under use_lstm, as in the JAX package
    scan_unroll: int = 1     # a lax.scan knob in the JAX package; no effect here
    # widths of the two projections (conv1d_1, conv1d_2); None: both E/2. The
    # second is the residual's, so the input's width too; where it is not
    # E/2, a dense ("pre_highway") takes the sum to the highways' E/2
    projections: tuple[int, int] | None = None

    @property
    def proj(self) -> tuple[int, int]:
        return self.projections or (self.embed_size // 2, self.embed_size // 2)

    @property
    def pre_highway(self) -> bool:
        return self.proj[1] != self.embed_size // 2


def cbhg_init(generator, cfg: CBHGConfig, in_dim=None):
    """(params, state) trees in the JAX layout; in_dim (the banks' input
    width) defaults to the residual's, the second projection's width."""
    P1, P2 = cfg.proj
    if in_dim is None:
        in_dim = P2
    E2 = cfg.embed_size // 2
    banks_params, banks_state = conv1d_banks_init(generator, cfg.num_banks, in_dim)
    bn1_p, bn1_s = bn_init(P1)
    bn2_p, bn2_s = bn_init(P2)
    params = {
        "banks": banks_params,
        "conv1d_1": conv1d_init(generator, 3, cfg.num_banks * (BANK_EMBED // 2), P1),
        "bn1": bn1_p,
        "conv1d_2": conv1d_init(generator, 3, P1, P2),
        "bn2": bn2_p,
    }
    if cfg.pre_highway:
        params["pre_highway"] = dense_init(generator, P2, E2)
    params.update(
        highway=[highway_init(generator, E2) for _ in range(cfg.num_highway)],
        gru=(lstm_init if cfg.use_lstm else gru_init)(generator, E2, E2, bidirectional=True))
    state = {"banks": banks_state, "bn1": bn1_s, "bn2": bn2_s}
    return params, state


class CBHG(nn.Module):
    """[B, T, P2] -> [B, T, E]: banks -> maxpool -> 2 conv projections with
    BN (widths P1, P2; E/2 both unless ``cfg.projections``) -> residual ->
    a dense to E/2 where P2 is not E/2 (``pre_highway``) -> highway stack ->
    bidirectional GRU (an `LSTM` under ``use_lstm``; either is the ``gru``
    attribute, as its tree key).

    ``lengths`` [B] (optional): row b holds ``lengths[b]`` frames and
    padding after them; each row then gives, on its own frames, what it
    gives alone (see the module's docstring), and the padding's outputs are
    left undefined.

    Tensor parallel under ``tp_group`` (a 'model' process group;
    ``parallel.sharding.shard_module`` sets it and cuts the slices): the
    banks hold and compute this rank's share of their channels, and
    ``conv1d_1`` contracts that share into a partial sum. Megatron's two
    operators join the ranks: the banks' input gradient is all-reduced
    (`copy_to_model`), and the partial sum is all-reduced in the forward
    (`reduce_from_model`)."""

    def __init__(self, p, s, cfg: CBHGConfig):
        super().__init__()
        self.cfg = cfg
        self.banks = Conv1dBanks(p["banks"], s["banks"])
        self.conv1d_1, self.bn1 = Conv1d(p["conv1d_1"]), BatchNorm(p["bn1"], s["bn1"])
        self.conv1d_2, self.bn2 = Conv1d(p["conv1d_2"]), BatchNorm(p["bn2"], s["bn2"])
        self.pre_highway = Dense(p["pre_highway"]) if cfg.pre_highway else None
        self.highway = nn.ModuleList(Highway(hw) for hw in p["highway"])
        self.gru = LSTM(p["gru"]) if cfg.use_lstm else GRU(p["gru"], fused=cfg.fused_gru)
        self.tp_group = None

    def forward(self, x, train: bool = False, bn_momentum: float | None = None,
                lengths: torch.Tensor | None = None):
        if lengths is None:
            h = maxpool1d_same(self.banks(copy_to_model(x, self.tp_group), train, bn_momentum))
            h = reduce_from_model(self.conv1d_1(h), self.tp_group)
            h = torch.relu(self.bn1(h, train, bn_momentum))
            h = self.bn2(self.conv1d_2(h), train, bn_momentum) + x
        else:
            # padding reads as the convolutions' zeros and the pool's -inf
            valid = length_mask(lengths, x.shape[1])
            x = torch.where(valid, x, 0.0)
            h = self.banks(copy_to_model(x, self.tp_group), train, bn_momentum)
            h = maxpool1d_same(torch.where(valid, h, -math.inf))
            h = reduce_from_model(self.conv1d_1(torch.where(valid, h, 0.0)), self.tp_group)
            h = torch.where(valid, torch.relu(self.bn1(h, train, bn_momentum)), 0.0)
            h = self.bn2(self.conv1d_2(h), train, bn_momentum) + x
        if self.pre_highway is not None:
            h = self.pre_highway(h)
        for hw in self.highway:
            h = hw(h)
        return self.gru(h) if lengths is None else self.gru(h, lengths)

    def params_tree(self):
        tree = {"banks": self.banks.params_tree(),
                "conv1d_1": self.conv1d_1.params_tree(), "bn1": self.bn1.params_tree(),
                "conv1d_2": self.conv1d_2.params_tree(), "bn2": self.bn2.params_tree()}
        if self.pre_highway is not None:
            tree["pre_highway"] = self.pre_highway.params_tree()
        return {**tree, "highway": [hw.params_tree() for hw in self.highway],
                "gru": self.gru.params_tree()}

    def state_tree(self):
        return {"banks": self.banks.state_tree(), "bn1": self.bn1.state_tree(),
                "bn2": self.bn2.state_tree()}
