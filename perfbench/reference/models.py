"""The encoder and the two-step decoder of the reference, on weight trees.

A tree is nested dicts of float32 tensors in the layout the benchmark
draws (``benchlib/weights.py``): dense {kernel [in, out], bias}; conv
{kernel [W, in, out]}, no bias; batch norm {gamma, beta} with running
{mean, var}; a bank {kernels: [k x [k, in, 128] for k = 1..K], bn}; GRU
{fw, bw: {gates_kernel [in+H, 2H], gates_bias, candidate_kernel [in+H, H],
candidate_bias}}. Each bank convolution runs at its own width, and the
GRU is a loop over time, both directions stepped together.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import Precision

BN_EPS = 1e-3


def dense(p, x, prec: Precision):
    return prec.mm(x, p["kernel"]) + p["bias"]


def conv_same(x, kernel, prec: Precision):
    """TF 'same' convolution of [B, T, C] by kernel [W, C, O]: (W-1)//2 zeros
    on the left, W//2 on the right."""
    w = kernel.shape[0]
    xp = F.pad(x.transpose(1, 2), ((w - 1) // 2, w // 2))
    return prec.conv(xp, kernel.permute(2, 1, 0)).transpose(1, 2)


def batch_norm(p, s, x):
    return (x - s["mean"]) / torch.sqrt(s["var"] + BN_EPS) * p["gamma"] + p["beta"]


def gru(p, x, prec: Precision):
    """Bidirectional GRU [B, T, C] -> [B, T, 2H], forward then backward
    direction on the channels."""
    B, T, C = x.shape
    dirs = (p["fw"], p["bw"])
    H = dirs[0]["candidate_bias"].shape[0]
    xs = torch.stack([x, x.flip(1)])                                     # [2, B, T, C]
    gx = torch.stack([prec.mm(xs[i], d["gates_kernel"][:C]) + d["gates_bias"]
                      for i, d in enumerate(dirs)])                      # [2, B, T, 2H]
    cx = torch.stack([prec.mm(xs[i], d["candidate_kernel"][:C]) + d["candidate_bias"]
                      for i, d in enumerate(dirs)])                      # [2, B, T, H]
    wg = torch.stack([d["gates_kernel"][C:] for d in dirs])             # [2, H, 2H]
    wc = torch.stack([d["candidate_kernel"][C:] for d in dirs])         # [2, H, H]
    h = x.new_zeros(2, B, H)
    ys = []
    for t in range(T):
        g = torch.sigmoid(gx[:, :, t] + prec.mm(h, wg))
        r, u = g[..., :H], g[..., H:]
        c = torch.tanh(cx[:, :, t] + prec.mm(r * h, wc))
        h = u * h + (1.0 - u) * c
        ys.append(h)
    y = torch.stack(ys, dim=2)                                           # [2, B, T, H]
    return torch.cat([y[0], y[1].flip(1)], dim=-1)


def cbhg(p, s, x, prec: Precision):
    """[B, T, E/2] -> [B, T, E]."""
    banks = torch.cat([conv_same(x, k, prec) for k in p["banks"]["kernels"]], dim=-1)
    h = torch.relu(batch_norm(p["banks"]["bn"], s["banks"]["bn"], banks))
    h = torch.maximum(h, F.pad(h[:, 1:], (0, 0, 0, 1), value=-math.inf))
    h = torch.relu(batch_norm(p["bn1"], s["bn1"], conv_same(h, p["conv1d_1"]["kernel"], prec)))
    h = batch_norm(p["bn2"], s["bn2"], conv_same(h, p["conv1d_2"]["kernel"], prec)) + x
    for hw in p["highway"]:
        gate = torch.sigmoid(dense(hw["dense2"], h, prec))
        h = torch.relu(dense(hw["dense1"], h, prec)) * gate + h * (1.0 - gate)
    return gru(p["gru"], h, prec)


def _step(p, s, x, prec: Precision):
    h = torch.relu(dense(p["prenet"]["dense1"], x, prec))
    h = torch.relu(dense(p["prenet"]["dense2"], h, prec))
    return dense(p["y_logits"], cbhg(p["CBHG"], s["CBHG"], h, prec), prec)


def encoder(tree, x, prec: Precision):
    """MFCC [B, T, 80] -> phone posteriors [B, T, 61] (softmax in float32)."""
    params, state = tree
    return torch.softmax(_step(params, state, x, prec), dim=-1)


def decoder(tree, ppg, prec: Precision):
    """Posteriors [B, T, 61] -> (mel [B, T, 80], power dB [B, T, 201])."""
    params, state = tree
    mel = _step(params["step1"], state["step1"], ppg, prec)
    return mel, _step(params["step2"], state["step2"], mel, prec)


def forward(trees, x, prec: Precision, rows: int = 0):
    """(ppg, mel, stft) of MFCC windows [B, T, E], ``rows`` windows at a time
    (0: all), so that a long batch fits beside the program's state."""
    step = rows or x.shape[0]
    outs = []
    for i in range(0, x.shape[0], step):
        ppg = encoder(trees[0], x[i:i + step], prec)
        outs.append((ppg, *decoder(trees[1], ppg, prec)))
    return tuple(torch.cat(o) for o in zip(*outs))
