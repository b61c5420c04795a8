"""Tacotron of the reference, one sentence at a time, on weight trees.

Wang et al., "Tacotron: Towards End-to-End Speech Synthesis" (Interspeech
2017, arXiv:1703.10135), Table 1 and sections 3-4: character embedding,
encoder pre-net and CBHG, a decoder of an attention GRU, content-based tanh
attention and two residual GRUs emitting r frames of 80 mel bands a step,
a post-net CBHG to the linear spectrogram, Griffin-Lim. Plain PyTorch,
float32 with TF32 off unless a `Precision` asks for less; each bank
convolution at its own width (``models.conv_same``), every GRU a loop over
time (``models.gru``), each sentence run alone with no padding and so no
mask; the vocoder is ``dsp.vocode``. It imports nothing of the program.

Where the paper is silent it takes keithito/tacotron's forms, as the
configuration's ``assumed`` block lists: the attention GRU reads [pre-net
output, previous context]; the score is v . tanh(W_m m_j + W_q q) with the
attention GRU's new output as q; [GRU output, context] goes through a dense
to the decoder's width ahead of the residual GRUs; the frame layer's output
is read as r frames. Departures from the paper: dropout is off (inference);
the decoder has no stop rule and runs ceil(frames / r) steps, and frames
past the sentence's own count are dropped; the post-net's output is the
program's normalized power dB (``P_dB_norm_factor``), which ``dsp.vocode``
takes.

Trees (``benchlib/tacotron.py`` draws them; the program's
``models/tacotron.py`` reads the same layout): embedding {lookup_table};
encoder {prenet, CBHG}; decoder {prenet, attention_rnn (a GRU direction),
attention {query_kernel, memory_kernel, attention_v}, project, rnn [two GRU
directions], frames}; postnet {CBHG (with pre_highway where the residual is
not the highways' width), linear}; state {encoder, postnet: {CBHG: bn
statistics}}.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import dsp
from .models import batch_norm, conv_same, dense, gru
from .precision import Precision


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    """ids [N] -> [N, E]; id 0 (the padding id) reads as zeros."""
    table = p["lookup_table"].clone()
    table[0] = 0.0
    return table[ids]


def prenet(p, x, prec: Precision):
    h = torch.relu(dense(p["dense1"], x, prec))
    return torch.relu(dense(p["dense2"], h, prec))


def cbhg(p, s, x, prec: Precision):
    """[1, T, C] -> [1, T, 2H]: banks, max-pool 2 (stride 1, -inf past the
    end), two projections (ReLU, then linear) with batch norm, the residual,
    a dense to the highways' width where given, highways, bidirectional GRU."""
    banks = torch.cat([conv_same(x, k, prec) for k in p["banks"]["kernels"]], dim=-1)
    h = torch.relu(batch_norm(p["banks"]["bn"], s["banks"]["bn"], banks))
    h = torch.maximum(h, F.pad(h[:, 1:], (0, 0, 0, 1), value=-math.inf))
    h = torch.relu(batch_norm(p["bn1"], s["bn1"], conv_same(h, p["conv1d_1"]["kernel"], prec)))
    h = batch_norm(p["bn2"], s["bn2"], conv_same(h, p["conv1d_2"]["kernel"], prec)) + x
    if "pre_highway" in p:
        h = dense(p["pre_highway"], h, prec)
    for hw in p["highway"]:
        gate = torch.sigmoid(dense(hw["dense2"], h, prec))
        h = torch.relu(dense(hw["dense1"], h, prec)) * gate + h * (1.0 - gate)
    return gru(p["gru"], h, prec)


def encoder(tree, ids: torch.Tensor, prec: Precision) -> torch.Tensor:
    """One sentence's ids [N] -> memory [N, 2H]."""
    params, state = tree
    x = prenet(params["encoder"]["prenet"], embed(params["embedding"], ids), prec)
    return cbhg(params["encoder"]["CBHG"], state["encoder"]["CBHG"], x[None], prec)[0]


def gru_step(p, x, h, prec: Precision):
    """One GRU cell step: x [C], h [H] -> h' (gates [r, u], r before its product)."""
    C, H = x.shape[-1], h.shape[-1]
    g = torch.sigmoid(prec.mm(x, p["gates_kernel"][:C]) + prec.mm(h, p["gates_kernel"][C:])
                      + p["gates_bias"])
    r, u = g[..., :H], g[..., H:]
    c = torch.tanh(prec.mm(x, p["candidate_kernel"][:C]) + prec.mm(r * h, p["candidate_kernel"][C:])
                   + p["candidate_bias"])
    return u * h + (1.0 - u) * c


def attend(p, query, memory, keys, prec: Precision):
    """Content-based tanh attention: (context [M], alignment [N])."""
    e = prec.mm(torch.tanh(keys + prec.mm(query, p["query_kernel"])), p["attention_v"])
    a = torch.softmax(e, dim=-1)
    return prec.mm(a, memory), a


def decode(tree, memory: torch.Tensor, steps: int, n_mels: int, prec: Precision,
           fed: torch.Tensor | None = None) -> torch.Tensor:
    """``steps`` decoder steps over one sentence's memory [N, M] -> [steps,
    r * n_mels]. Free-running from the all-zero GO frame (each step fed the
    last frame of its own step before), or, with ``fed`` [steps, n_mels],
    step k fed ``fed[k]``."""
    d = tree[0]["decoder"]
    keys = prec.mm(memory, d["attention"]["memory_kernel"])
    h_att = memory.new_zeros(d["attention_rnn"]["candidate_bias"].shape[0])
    context = memory.new_zeros(memory.shape[-1])
    hs = [memory.new_zeros(q["candidate_bias"].shape[0]) for q in d["rnn"]]
    frame = memory.new_zeros(n_mels)
    out = []
    for k in range(steps):
        if fed is not None:
            frame = fed[k]
        x = prenet(d["prenet"], frame, prec)
        h_att = gru_step(d["attention_rnn"], torch.cat([x, context]), h_att, prec)
        context, _ = attend(d["attention"], h_att, memory, keys, prec)
        y = dense(d["project"], torch.cat([h_att, context]), prec)
        for i, q in enumerate(d["rnn"]):
            hs[i] = gru_step(q, y, hs[i], prec)
            y = y + hs[i]
        y = dense(d["frames"], y, prec)
        out.append(y)
        frame = y[-n_mels:]
    return torch.stack(out)


def postnet(tree, mel: torch.Tensor, prec: Precision) -> torch.Tensor:
    """One sentence's mel frames [T, n_mels] -> linear spectrogram [T, n_stft]."""
    params, state = tree
    h = cbhg(params["postnet"]["CBHG"], state["postnet"]["CBHG"], mel[None], prec)[0]
    return dense(params["postnet"]["linear"], h, prec)


def phase_draws(frames, n_stft: int, seed: int, device) -> list[torch.Tensor]:
    """Each sentence's initial Griffin-Lim phase, pi * U[0, 1) of [frames,
    n_stft], drawn in turn from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [math.pi * torch.rand(int(n), n_stft, generator=gen, device=device,
                                 dtype=torch.float32) for n in frames]


def steps_for(frames: int, r: int) -> int:
    return -(-int(frames) // r)


def synthesize(tree, ids: torch.Tensor, frames: int, phase0: torch.Tensor, config: dict,
               prec: Precision) -> dict:
    """One sentence, free-running: {"mel" [frames, n_mels], "linear"
    [frames, n_stft], "pcm" (peak-normalized PCM scale, before rounding)}."""
    m = config["model"]
    n_mels, r = m["n_mels"], m["reduction"]
    with prec.active():
        memory = encoder(tree, ids, prec)
        mel = decode(tree, memory, steps_for(frames, r), n_mels, prec).reshape(-1, n_mels)[:frames]
        linear = postnet(tree, mel, prec)
        y = dsp.vocode(linear, phase0, config["features"], config["vocoder"])
    return {"mel": mel, "linear": linear, "pcm": dsp.pcm16_float(y)}


def decode_fed(tree, ids: torch.Tensor, mel: torch.Tensor, config: dict,
               prec: Precision) -> torch.Tensor:
    """The decoder's frames [frames, n_mels] for one sentence, each step fed
    the last frame of the step before from ``mel`` [frames, n_mels] (a
    program's own output), so each step is compared on its own and a gap
    cannot pile up through the feedback."""
    m = config["model"]
    n_mels, r = m["n_mels"], m["reduction"]
    frames = mel.shape[0]
    steps = steps_for(frames, r)
    fed = torch.zeros(steps, n_mels, dtype=mel.dtype, device=mel.device)
    fed[1:] = mel[r - 1:r * (steps - 1):r]
    with prec.active():
        memory = encoder(tree, ids, prec)
        return decode(tree, memory, steps, n_mels, prec, fed=fed).reshape(-1, n_mels)[:frames]
