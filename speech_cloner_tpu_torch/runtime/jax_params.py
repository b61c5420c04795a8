"""Turn the JAX package's parameter trees into the port's modules.

Input: the JAX ``params`` and ``state`` pytrees as numpy leaves, as
``jax.tree.map(np.asarray, ...)`` or a ``runtime/checkpoint`` ``.npz`` gives
them (nested dicts; lists for the bank kernels and highway stack). Output:
the port's `Encoder` / `Decoder` modules, which compute the same function
as the JAX ``apply`` on the same tree. The tree's structure and every
leaf's shape are checked against the configuration before loading.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import decoder as dec_m
from ..models import encoder as enc_m


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
