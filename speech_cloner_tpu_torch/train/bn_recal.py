"""BatchNorm moving-statistic recalibration.

Counterpart of ``speech_cloner_tpu/train/bn_recal.py``: the 0.999 decay
leaves the inference-mode statistics thousands of steps behind training, so
before a validation or save the moving statistics are replaced by the mean
of the true batch statistics over k batches. A train-mode forward with BN
momentum 0 makes the returned state the batch's statistics.

    stat_fn = make_bn_stat_fn(lambda x, y, bn_momentum: encoder.apply(
        model, x, train=True, generator=g, bn_momentum=bn_momentum)[1])
    load_state_tree(model, collect_bn_state(stat_fn, batches))

The forward writes each batch's statistics into the model's buffers as it
goes; `load_state_tree` then sets them to the mean.
"""

from __future__ import annotations

import functools

import torch

from ..runtime.tree import tree_map


def make_bn_stat_fn(train_state_fn):
    """``train_state_fn(*batch, bn_momentum=...) -> state tree`` with
    bn_momentum pinned to 0.0 and no gradient: each call returns the batch's
    true statistics (copies)."""
    fn = functools.partial(train_state_fn, bn_momentum=0.0)

    @torch.no_grad()
    def stat_fn(*batch):
        return tree_map(lambda t: t.detach().clone(), fn(*batch))
    return stat_fn


def collect_bn_state(stat_fn, batches, max_batches: int = 16):
    """Mean of ``stat_fn(*batch)`` over up to ``max_batches`` batches."""
    acc, n = None, 0
    for batch in batches:
        st = stat_fn(*batch)
        acc = st if acc is None else tree_map(torch.add, acc, st)
        n += 1
        if n >= max_batches:
            break
    if n == 0:
        raise ValueError("no batches supplied for BN recalibration")
    return tree_map(lambda a: a / n, acc)


@torch.no_grad()
def load_state_tree(model, state) -> None:
    """Copy a state tree (the JAX layout) into the model's BN buffers."""
    tree_map(lambda buf, v: buf.copy_(torch.as_tensor(v, dtype=buf.dtype, device=buf.device)),
             model.state_tree(), state)
