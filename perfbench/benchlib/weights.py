"""Weight trees of a configuration, drawn from the seed on the device.

One uniform draw from a ``torch.Generator`` on the device covers every
leaf; each leaf is a slice of it, scaled: kernels Glorot-uniform (the
initializer the reference repository's TF layers use), biases at their
usual initial value (GRU gates 1, highway gates -1, else 0) plus
U(-0.05, 0.05), batch-norm gamma and running variance U(0.9, 1.1), beta and
running mean U(-0.05, 0.05), so that every term of every layer counts.

Glorot assumes inputs of unit scale, and the stacks' inputs are far
smaller (MFCC rms ~0.01, posteriors, mel); a model drawn so would give
nearly the same output for every window, as no trained model does. The
configuration's ``weights`` block therefore scales the first prenet layer
of each stack (``first_layer_scale``: encoder, step1, step2) and the
encoder's output layer (``encoder_output_scale``, peaked posteriors), so
the output depends on the input as a trained model's does.

The trees use the layout the program's modules are built from (nested
dicts; lists for the bank kernels and the highway stack) and that the
reference reads: (params, state) for the encoder and for the decoder.
"""

from __future__ import annotations

import math

import torch

BANK_CHANNELS = 128   # the reference's conv1d_banks default, never forwarded


def dims(config: dict) -> dict:
    """The widths of the three CBHG stacks and their surroundings."""
    enc, dec = config["encoder"], config["decoder"]
    T, e_in = enc["input_shape"]
    e_embed = enc["embed_size"] or e_in
    s1, s2 = dec["steps_v"]
    return {"T": T,
            "encoder": {"in": e_in, "embed": e_embed, "K": enc["num_conv_banks"],
                        "highway": enc["num_highwaynet_blocks"], "out": enc["n_output"]},
            "step1": {"in": dec["input_shape"][1], "embed": s1["embed_size"],
                      "K": s1["num_conv_banks"], "highway": s1["num_highwaynet_blocks"],
                      "out": s1["n_output"]},
            "step2": {"in": s1["n_output"], "embed": s2["embed_size"], "K": s2["num_conv_banks"],
                      "highway": s2["num_highwaynet_blocks"], "out": s2["n_output"]}}


class _Leaves:
    """Leaf specifications first, values after one draw."""

    def __init__(self):
        self.specs = []   # (holder, key, shape, kind, arg)

    def add(self, holder, key, shape, kind, arg=0.0):
        self.specs.append((holder, key, tuple(shape), kind, arg))

    def fill(self, generator: torch.Generator, device) -> None:
        n = sum(math.prod(s[2]) for s in self.specs)
        u = torch.rand(n, generator=generator, device=device, dtype=torch.float32)
        at = 0
        for holder, key, shape, kind, arg in self.specs:
            size = math.prod(shape)
            x = u[at:at + size].reshape(shape)
            at += size
            if kind == "glorot":       # arg: (fan_in, fan_out, scale)
                v = (x * 2.0 - 1.0) * (math.sqrt(6.0 / (arg[0] + arg[1])) * arg[2])
            elif kind == "bias":       # arg: initial value
                v = arg + (x - 0.5) * 0.1
            else:                      # "scale": around arg with +-0.1 (gamma, var) or +-0.05
                v = arg + (x - 0.5) * (0.2 if arg else 0.1)
            holder[key] = v


def _dense(L, holder, key, i, o, bias=0.0, scale=1.0):
    d = holder[key] = {}
    L.add(d, "kernel", (i, o), "glorot", (i, o, scale))
    L.add(d, "bias", (o,), "bias", bias)


def _conv(L, holder, key, w, i, o):
    d = holder[key] = {}
    L.add(d, "kernel", (w, i, o), "glorot", (w * i, w * o, 1.0))


def _bn(L, p, s, key, n):
    p[key], s[key] = {}, {}
    L.add(p[key], "gamma", (n,), "scale", 1.0)
    L.add(p[key], "beta", (n,), "scale", 0.0)
    L.add(s[key], "mean", (n,), "scale", 0.0)
    L.add(s[key], "var", (n,), "scale", 1.0)


def _cbhg(L, d: dict):
    E2, K = d["embed"] // 2, d["K"]
    p, s = {}, {}
    p["banks"], s["banks"] = {"kernels": [None] * K}, {}
    for k in range(1, K + 1):
        L.add(p["banks"]["kernels"], k - 1, (k, E2, BANK_CHANNELS), "glorot",
              (k * E2, k * BANK_CHANNELS, 1.0))
    _bn(L, p["banks"], s["banks"], "bn", K * BANK_CHANNELS)
    _conv(L, p, "conv1d_1", 3, K * BANK_CHANNELS, E2)
    _bn(L, p, s, "bn1", E2)
    _conv(L, p, "conv1d_2", 3, E2, E2)
    _bn(L, p, s, "bn2", E2)
    p["highway"] = [{} for _ in range(d["highway"])]
    for hw in p["highway"]:
        _dense(L, hw, "dense1", E2, E2)
        _dense(L, hw, "dense2", E2, E2, bias=-1.0)
    p["gru"] = {"fw": {}, "bw": {}}
    n = 2 * E2
    for g in p["gru"].values():
        L.add(g, "gates_kernel", (n, 2 * E2), "glorot", (n, 2 * E2, 1.0))
        L.add(g, "gates_bias", (2 * E2,), "bias", 1.0)
        L.add(g, "candidate_kernel", (n, E2), "glorot", (n, E2, 1.0))
        L.add(g, "candidate_bias", (E2,), "bias", 0.0)
    return p, s


def _net(L, d: dict, first: float, out: float = 1.0):
    p = {"prenet": {}}
    _dense(L, p["prenet"], "dense1", d["in"], d["embed"], scale=first)
    _dense(L, p["prenet"], "dense2", d["embed"], d["embed"] // 2)
    p["CBHG"], cbhg_state = _cbhg(L, d)
    _dense(L, p, "y_logits", d["embed"], d["out"], scale=out)
    return p, {"CBHG": cbhg_state}


def make_trees(config: dict, seed: int, device):
    """((encoder params, state), (decoder params, state)) from ``seed``."""
    dm, w = dims(config), config["weights"]
    first = w["first_layer_scale"]
    L = _Leaves()
    enc = _net(L, dm["encoder"], first["encoder"], w["encoder_output_scale"])
    s1, s2 = _net(L, dm["step1"], first["step1"]), _net(L, dm["step2"], first["step2"])
    dec = ({"step1": s1[0], "step2": s2[0]}, {"step1": s1[1], "step2": s2[1]})
    L.fill(torch.Generator(device=device).manual_seed(seed), device)
    return enc, dec
