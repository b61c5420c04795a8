"""Weights, audio and the sampled units repeat from the seed and differ
across seeds."""

from __future__ import annotations

import json

import numpy as np
import torch
from tiny import PERFBENCH

from benchlib.audio import clip_seeds, voiced_clips
from benchlib.driving import sample, unit_seed
from benchlib.weights import make_trees

CFG = json.loads((PERFBENCH / "configs" / "ppg_vc_f32.json").read_text())
BIG = 2**33 + 12345          # seeds past 32 bits, as the driver's are


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_weights_repeat_and_differ():
    a, b, c = (_leaves(make_trees(CFG, s, "cpu")) for s in (BIG, BIG, BIG + 1))
    assert len(a) == len(b) == len(c) > 100
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c) if x.numel() > 8)


def test_weights_at_shipped_widths():
    (enc, _), (dec, _) = make_trees(CFG, 1, "cpu")
    assert enc["CBHG"]["gru"]["fw"]["candidate_bias"].shape == (40,)
    assert dec["step1"]["CBHG"]["gru"]["bw"]["gates_kernel"].shape == (256, 256)
    assert dec["step2"]["CBHG"]["banks"]["kernels"][31].shape == (32, 256, 128)
    assert dec["step2"]["y_logits"]["kernel"].shape == (512, 201)


def test_audio_repeats_and_differs():
    a = voiced_clips(clip_seeds(BIG, 2, 1), 0.5, 16000, "cpu")
    b = voiced_clips(clip_seeds(BIG, 2, 1), 0.5, 16000, "cpu")
    c = voiced_clips(clip_seeds(BIG + 1, 2, 1), 0.5, 16000, "cpu")
    assert a.shape == (2, 8000) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.allclose(a, c)
    assert not np.allclose(a[0], a[1])


def test_units_and_samples_repeat():
    assert unit_seed(BIG, 2, 7) == unit_seed(BIG, 2, 7) != unit_seed(BIG + 1, 2, 7)
    assert unit_seed(BIG, 2, 7) < 2**62
    assert sample(BIG, 3, 8, 3, always=(0,)) == sample(BIG, 3, 8, 3, always=(0,))
    assert 0 in sample(BIG, 3, 8, 3, always=(0,))
    draws = {frozenset(sample(s, 3, 8, 3)) for s in range(BIG, BIG + 20)}
    assert len(draws) > 1
