"""Embedding lookup and the Bahdanau attention GRU decoder.

Counterpart of ``speech_cloner_tpu/nn/attention.py`` (the reference's
``embed`` and ``attention_decoder``, which its models never call): the same
trees, the same function.

- `Embed`: a lookup table [vocab, units] whose row 0 reads as zeros when
  ``zero_pad`` (applied at lookup time, so the stored row keeps its values
  and gets no gradient through a lookup).
- `AttentionDecoder`: per step, the additive score v . tanh(keys + h W_q)
  over the memory (keys = memory W_m, once), a softmax over memory time,
  the context, [x_t, context] into a GRU cell (gates [r, u], r applied
  before the product, as ``nn.modules``' GRU), and the output projection
  [h', context] W_out + b. The cell's input depends on h through the
  context, so no input product can be taken out of the loop and the scan
  kernel does not apply: a plain loop over T' with ``torch.matmul``, on
  either device.

The text-to-speech decoder (``models/tacotron.py``) steps these pieces
itself, one step at a time, because its input at a step is its own output
at the step before:

- `gru_cell`: one step of the GRU cell above from its tree {gates_kernel
  [in+H, 2H], gates_bias, candidate_kernel [in+H, H], candidate_bias}.
- `additive_attention`: one step of content-based tanh attention, the
  score v . tanh(W_m m_j + W_q q) with W_m m_j worked out once for the
  memory (`attention_keys`), over the memory's valid positions alone: a
  ``mask_bias`` of 0 or -inf ahead of the softmax gives a padded position
  zero weight.

Trees come in and go out in the JAX layout (``*_init`` draws one from a
``torch.Generator``; ``runtime.jax_params`` converts the JAX package's);
``zero_pad`` stays a bool leaf.
"""

from __future__ import annotations

import torch
from torch import nn

from .modules import _param, glorot_uniform, gru_dir_init


def embed_init(generator: torch.Generator, vocab_size: int, num_units: int,
               zero_pad: bool = True):
    table = torch.empty(vocab_size, num_units)
    torch.nn.init.trunc_normal_(table, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return {"lookup_table": 0.01 * table, "zero_pad": zero_pad}


def embed_apply(params, ids: torch.Tensor) -> torch.Tensor:
    """ids [...] -> [..., units]; row 0 zeros when ``zero_pad``."""
    table = params["lookup_table"]
    if params.get("zero_pad", True):
        table = torch.cat([torch.zeros_like(table[:1]), table[1:]], dim=0)
    return table[ids]


def attention_decoder_init(generator: torch.Generator, in_dim: int, memory_dim: int,
                           num_units: int):
    H, M = num_units, memory_dim
    return {"query_kernel": glorot_uniform(generator, (H, H), H, H),
            "memory_kernel": glorot_uniform(generator, (M, H), M, H),
            "attention_v": glorot_uniform(generator, (H,), H, 1),
            "gru": gru_dir_init(generator, in_dim + M, H),
            "out_kernel": glorot_uniform(generator, (H + M, H), H + M, H),
            "out_bias": torch.zeros(H)}


def attention_decoder_apply(params, inputs: torch.Tensor, memory: torch.Tensor):
    """inputs [B, T', C'], memory [B, T, M] -> (outputs [B, T', H],
    alignments [B, T', T])."""
    B, _, M = memory.shape
    H = params["query_kernel"].shape[0]
    keys = torch.matmul(memory, params["memory_kernel"])            # [B, T, H]
    p = params["gru"]
    C = inputs.shape[2] + M
    Wg_x, Wg_h = p["gates_kernel"][:C], p["gates_kernel"][C:]
    Wc_x, Wc_h = p["candidate_kernel"][:C], p["candidate_kernel"][C:]
    h = inputs.new_zeros(B, H)
    outs, aligns = [], []
    for x_t in inputs.unbind(1):
        q = torch.matmul(h, params["query_kernel"])
        e = torch.matmul(torch.tanh(keys + q[:, None, :]), params["attention_v"])  # [B, T]
        a = torch.softmax(e, dim=1)
        ctx = torch.matmul(a[:, None, :], memory)[:, 0]              # [B, M]
        xi = torch.cat([x_t, ctx], dim=1)
        ru = torch.sigmoid(torch.matmul(xi, Wg_x) + torch.matmul(h, Wg_h) + p["gates_bias"])
        r, u = ru[:, :H], ru[:, H:]
        c = torch.tanh(torch.matmul(xi, Wc_x) + torch.matmul(r * h, Wc_h)
                       + p["candidate_bias"])
        h = u * h + (1.0 - u) * c
        outs.append(torch.matmul(torch.cat([h, ctx], dim=1), params["out_kernel"])
                    + params["out_bias"])
        aligns.append(a)
    return torch.stack(outs, dim=1), torch.stack(aligns, dim=1)


def gru_cell(params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step: x [B, C], h [B, H] -> h' [B, H] (gates [r, u], r
    applied to h before its product, as `attention_decoder_apply`'s cell)."""
    H = h.shape[-1]
    ru = torch.sigmoid(torch.addmm(params["gates_bias"], torch.cat([x, h], dim=1),
                                   params["gates_kernel"]))
    r, u = ru[:, :H], ru[:, H:]
    c = torch.tanh(torch.addmm(params["candidate_bias"], torch.cat([x, r * h], dim=1),
                               params["candidate_kernel"]))
    return u * h + (1.0 - u) * c


def attention_init(generator: torch.Generator, query_dim: int, memory_dim: int, depth: int):
    return {"query_kernel": glorot_uniform(generator, (query_dim, depth), query_dim, depth),
            "memory_kernel": glorot_uniform(generator, (memory_dim, depth), memory_dim, depth),
            "attention_v": glorot_uniform(generator, (depth,), depth, 1)}


def attention_keys(params, memory: torch.Tensor) -> torch.Tensor:
    """memory [B, N, M] -> W_m m_j [B, N, depth], once for every step."""
    return torch.matmul(memory, params["memory_kernel"])


def mask_bias(lengths: torch.Tensor, N: int) -> torch.Tensor:
    """[B, N]: 0 at a row's first ``lengths[b]`` positions, -inf after."""
    valid = torch.arange(N, device=lengths.device) < lengths[:, None]
    return torch.zeros(valid.shape, device=lengths.device).masked_fill(~valid, -torch.inf)


def additive_attention(params, query: torch.Tensor, keys: torch.Tensor, memory: torch.Tensor,
                       bias: torch.Tensor | None = None):
    """query [B, Q], keys [B, N, D] (`attention_keys`), memory [B, N, M],
    ``bias`` [B, N] (`mask_bias`) -> (context [B, M], alignment [B, N])."""
    q = torch.matmul(query, params["query_kernel"])
    e = torch.matmul(torch.tanh(keys + q[:, None, :]), params["attention_v"])       # [B, N]
    a = torch.softmax(e if bias is None else e + bias.to(e.dtype), dim=1)
    return torch.bmm(a[:, None, :], memory)[:, 0], a


class Embed(nn.Module):
    """`embed_apply` over a trainable table; ``zero_pad`` a plain bool."""

    def __init__(self, p):
        super().__init__()
        self.lookup_table = _param(p["lookup_table"])
        self.zero_pad = bool(p.get("zero_pad", True))

    def forward(self, ids):
        return embed_apply(self.params_tree(), ids)

    def params_tree(self):
        return {"lookup_table": self.lookup_table, "zero_pad": self.zero_pad}


class GRUCell(nn.Module):
    """`gru_cell` over the tree's parameters."""

    def __init__(self, p):
        super().__init__()
        self.p = nn.ParameterDict({k: _param(v) for k, v in p.items()})

    def forward(self, x, h):
        return gru_cell(self.p, x, h)

    def params_tree(self):
        return dict(self.p.items())


class AdditiveAttention(nn.Module):
    """`additive_attention` over the tree {query_kernel, memory_kernel,
    attention_v}; `keys` once for a memory, then a step per call."""

    def __init__(self, p):
        super().__init__()
        self.p = nn.ParameterDict({k: _param(v) for k, v in p.items()})

    def keys(self, memory):
        return attention_keys(self.p, memory)

    def forward(self, query, keys, memory, bias=None):
        return additive_attention(self.p, query, keys, memory, bias)

    def params_tree(self):
        return dict(self.p.items())


class AttentionDecoder(nn.Module):
    """`attention_decoder_apply` over the tree's parameters."""

    def __init__(self, p):
        super().__init__()
        self.weights = nn.ParameterDict({k: _param(v) for k, v in p.items() if k != "gru"})
        self.gru = nn.ParameterDict({k: _param(v) for k, v in p["gru"].items()})

    def forward(self, inputs, memory):
        return attention_decoder_apply(self.params_tree(), inputs, memory)

    def params_tree(self):
        return {**dict(self.weights.items()), "gru": dict(self.gru.items())}
