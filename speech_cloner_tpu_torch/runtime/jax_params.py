"""Turn the JAX package's parameter trees into the port's modules, and back.

Input: the JAX ``params`` and ``state`` pytrees as numpy leaves, as
``jax.tree.map(np.asarray, ...)`` or a ``runtime/checkpoint`` ``.npz`` gives
them (nested dicts; lists for the bank kernels and highway stack). Output:
the port's `Encoder` / `Decoder` / `SpeakerId` modules, which compute the
same function as the JAX ``apply`` on the same tree, and the `Embed` /
`AttentionDecoder` of ``nn/attention.py``. The tree's structure and every
leaf's shape are checked against the configuration (for the attention
modules, the widths the tree's first kernels give) before loading.
`encoder_to_jax` / `decoder_to_jax` / `speaker_id_to_jax` / `module_to_jax`
are the inverse: a module's (params, state), or its parameters' gradients,
as numpy trees in the JAX layout (a bool leaf, the embedding's
``zero_pad``, as it is).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import decoder as dec_m
from ..models import encoder as enc_m
from ..models import speaker_id as spk_m
from ..nn import attention as att_m
from .tree import tree_map


def _check_like(tree, template, path: str = "") -> None:
    where = path or "<root>"
    if isinstance(template, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"parameter tree mismatch at {where}: expected a dict, "
                             f"found {type(tree).__name__}")
        if set(tree) != set(template):
            raise ValueError(f"parameter tree mismatch at {where}: missing keys "
                             f"{sorted(set(template) - set(tree))}, unexpected keys "
                             f"{sorted(set(tree) - set(template))}")
        for k in template:
            _check_like(tree[k], template[k], f"{path}{k}/")
    elif isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise ValueError(f"parameter tree mismatch at {where}: expected a sequence "
                             f"of {len(template)}")
        for i, (a, b) in enumerate(zip(tree, template)):
            _check_like(a, b, f"{path}{i}/")
    elif isinstance(template, bool):
        if np.asarray(tree).dtype != np.bool_ or np.shape(tree) != ():
            raise ValueError(f"parameter tree mismatch at {where}: expected a bool, "
                             f"found {tree!r}")
    elif tuple(np.shape(tree)) != tuple(template.shape):
        raise ValueError(f"parameter tree mismatch at {where}: shape "
                         f"{tuple(np.shape(tree))} != expected {tuple(template.shape)}")


def _template(init_tree, cfg):
    with torch.device("meta"):   # shapes only, no data
        return init_tree(torch.Generator(), cfg)


def encoder_from_jax(params, state, cfg: enc_m.EncoderConfig, device="cpu") -> enc_m.Encoder:
    _check_like((params, state), _template(enc_m.init_tree, cfg))
    return enc_m.Encoder(params, state, cfg).to(device)


def decoder_from_jax(params, state, cfg: dec_m.DecoderConfig, device="cpu") -> dec_m.Decoder:
    _check_like((params, state), _template(dec_m.init_tree, cfg))
    return dec_m.Decoder(params, state, cfg).to(device)


def speaker_id_from_jax(params, state, cfg: spk_m.SpeakerIdConfig,
                        device="cpu") -> spk_m.SpeakerId:
    _check_like((params, state), _template(spk_m.init_tree, cfg))
    return spk_m.SpeakerId(params, state, cfg).to(device)


def embed_from_jax(params, device="cpu") -> att_m.Embed:
    shape = np.shape(params["lookup_table"])
    _check_like(params, _template(lambda g, c: att_m.embed_init(g, *c), shape))
    return att_m.Embed(params).to(device)


def attention_decoder_from_jax(params, device="cpu") -> att_m.AttentionDecoder:
    M, H = np.shape(params["memory_kernel"])
    dims = (np.shape(params["gru"]["gates_kernel"])[0] - M - H, M, H)
    _check_like(params, _template(lambda g, c: att_m.attention_decoder_init(g, *c), dims))
    return att_m.AttentionDecoder(params).to(device)


def _host(t: torch.Tensor | None, like) -> np.ndarray:
    if not isinstance(like, torch.Tensor):
        return like
    t = torch.zeros_like(like) if t is None else t
    return t.detach().to("cpu", torch.float32).numpy().copy()


def module_to_jax(model, grads: bool = False):
    """(params, state) of an `Encoder`, `Decoder` or `SpeakerId` as numpy
    trees in the JAX layout (of an `Embed` or `AttentionDecoder`, its params
    tree alone); with ``grads``, the parameters' ``.grad`` (zeros where None)
    in the params layout alone."""
    params = model.params_tree()
    if grads:
        return tree_map(lambda p: _host(getattr(p, "grad", None), p), params)
    host = tree_map(lambda p: _host(p, p), params)
    if not hasattr(model, "state_tree"):
        return host
    return host, tree_map(lambda b: _host(b, b), model.state_tree())


def encoder_to_jax(model: enc_m.Encoder, grads: bool = False):
    return module_to_jax(model, grads)


def decoder_to_jax(model: dec_m.Decoder, grads: bool = False):
    return module_to_jax(model, grads)


def speaker_id_to_jax(model: spk_m.SpeakerId, grads: bool = False):
    return module_to_jax(model, grads)
