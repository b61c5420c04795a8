"""Tacotron's side of the benchmark: its weight trees drawn from the seed,
the work of a batch of sentences (the yardstick of its roofline and
utilization metrics), and the layer context its traced runs fill from the
program's own records.

Weights: the leaves of ``weights.py`` (one uniform draw on the device,
kernels Glorot-uniform, biases at their usual initial value plus
U(-0.05, 0.05), batch norms jittered), the character table uniform with
deviation 0.5 (keithito/tacotron's truncated normal of deviation 0.5, in
the uniform draw's form) and the post-net's last dense scaled by the
configuration's ``linear_output_scale``. The trees use the layout of the
program's ``models/tacotron.py`` and of ``reference/tacotron.py``.

Work of a batch, counted over what its sentences need (each row at its own
characters, frames and decoder steps; the padding the batch computes is not
counted), at 2 FLOP a multiply-add: the encoder (pre-net, banks at their
nonzero taps, projections, highways, both GRU directions' input and
recurrent products), the decoder's steps (pre-net, attention GRU, the
attention's query, scores and context, the dense, two residual GRUs, the
frame layer; the memory's keys once a sentence), the post-net and its
output layer, and the vocoder's transforms as FFTs (5 n log2 n, 2 r - 1 a
frame for r Griffin-Lim rounds). Peaks and byte counts as ``work.py``.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import torch

from . import work
from .layers import LayerContext
from .weights import BANK_CHANNELS, _bn, _conv, _dense, _Leaves

EMBED_DEVIATION = 0.5


def _gru_dir(L, holder, key, in_dim, H):
    g = holder[key] = {}
    n = in_dim + H
    L.add(g, "gates_kernel", (n, 2 * H), "glorot", (n, 2 * H, 1.0))
    L.add(g, "gates_bias", (2 * H,), "bias", 1.0)
    L.add(g, "candidate_kernel", (n, H), "glorot", (n, H, 1.0))
    L.add(g, "candidate_bias", (H,), "bias", 0.0)


def _cbhg(L, in_dim: int, K: int, proj, units: int, highway: int):
    p, s = {}, {}
    p["banks"], s["banks"] = {"kernels": [None] * K}, {}
    for k in range(1, K + 1):
        L.add(p["banks"]["kernels"], k - 1, (k, in_dim, BANK_CHANNELS), "glorot",
              (k * in_dim, k * BANK_CHANNELS, 1.0))
    _bn(L, p["banks"], s["banks"], "bn", K * BANK_CHANNELS)
    _conv(L, p, "conv1d_1", 3, K * BANK_CHANNELS, proj[0])
    _bn(L, p, s, "bn1", proj[0])
    _conv(L, p, "conv1d_2", 3, proj[0], proj[1])
    _bn(L, p, s, "bn2", proj[1])
    if proj[1] != units:
        _dense(L, p, "pre_highway", proj[1], units)
    p["highway"] = [{} for _ in range(highway)]
    for hw in p["highway"]:
        _dense(L, hw, "dense1", units, units)
        _dense(L, hw, "dense2", units, units, bias=-1.0)
    p["gru"] = {}
    for d in ("fw", "bw"):
        _gru_dir(L, p["gru"], d, units, units)
    return p, s


def _prenet(L, holder, in_dim, size):
    pre = holder["prenet"] = {}
    _dense(L, pre, "dense1", in_dim, size)
    _dense(L, pre, "dense2", size, size // 2)


def make_trees(config: dict, seed: int, device):
    """(params, state) of the configuration's model from ``seed``."""
    m, w = config["model"], config["weights"]
    U, A, D = m["encoder_units"], m["attention_rnn_units"], m["decoder_units"]
    inner, M = m["prenet_size"] // 2, 2 * U
    L = _Leaves()
    emb = {}
    limit = EMBED_DEVIATION * math.sqrt(3.0)      # uniform of that deviation
    L.add(emb, "lookup_table", (m["vocab_size"], m["embed_size"]), "glorot", (3, 3, limit))
    enc = {}
    _prenet(L, enc, m["embed_size"], m["prenet_size"])
    enc_proj = (U, U) if inner == U else (U, inner)
    enc["CBHG"], enc_state = _cbhg(L, inner, m["encoder_banks"], enc_proj, U,
                                   m["encoder_highway"])
    dec = {}
    _prenet(L, dec, m["n_mels"], m["prenet_size"])
    _gru_dir(L, dec, "attention_rnn", inner + M, A)
    att = dec["attention"] = {}
    L.add(att, "query_kernel", (A, m["attention_depth"]), "glorot", (A, m["attention_depth"], 1.0))
    L.add(att, "memory_kernel", (M, m["attention_depth"]), "glorot",
          (M, m["attention_depth"], 1.0))
    L.add(att, "attention_v", (m["attention_depth"],), "glorot", (m["attention_depth"], 1, 1.0))
    _dense(L, dec, "project", A + M, D)
    dec["rnn"] = [None] * m["decoder_layers"]
    for i in range(m["decoder_layers"]):
        _gru_dir(L, dec["rnn"], i, D, D)
    _dense(L, dec, "frames", D, m["reduction"] * m["n_mels"])
    post = {}
    post["CBHG"], post_state = _cbhg(L, m["n_mels"], m["postnet_banks"],
                                     tuple(m["postnet_projections"]), m["postnet_units"],
                                     m["postnet_highway"])
    _dense(L, post, "linear", 2 * m["postnet_units"], m["n_stft"],
           scale=w["linear_output_scale"])
    L.fill(torch.Generator(device=device).manual_seed(seed), device)
    return ({"embedding": emb, "encoder": enc, "decoder": dec, "postnet": post},
            {"encoder": {"CBHG": enc_state}, "postnet": {"CBHG": post_state}})


# ----------------------------------------------------------------- work ---

def steps_for(frames: int, r: int) -> int:
    return -(-int(frames) // r)


def _cbhg_flops(in_dim: int, K: int, proj, units: int, highway: int) -> int:
    """FLOP a frame of one CBHG."""
    f = 2 * in_dim * BANK_CHANNELS * work.bank_taps(K)             # banks, nonzero taps
    f += 2 * 3 * K * BANK_CHANNELS * proj[0] + 2 * 3 * proj[0] * proj[1]
    if proj[1] != units:
        f += 2 * proj[1] * units
    f += highway * 2 * 2 * units * units
    f += 2 * (2 * units * 3 * units + 6 * units * units)            # GRU, both directions
    return f


def _gru_step_flops(in_dim: int, H: int) -> int:
    return 2 * (in_dim + H) * 3 * H


def flops(config: dict, chars: list[int], frames: list[int]) -> dict:
    """FLOP of a batch by stage: encoder, decoder, post-net."""
    m = config["model"]
    U, A, D, Z = (m["encoder_units"], m["attention_rnn_units"], m["decoder_units"],
                  m["attention_depth"])
    P, inner, M, n_mels = m["prenet_size"], m["prenet_size"] // 2, 2 * U, m["n_mels"]
    enc_proj = (U, U) if inner == U else (U, inner)
    enc_frame = 2 * (m["embed_size"] * P + P * inner) + _cbhg_flops(
        inner, m["encoder_banks"], enc_proj, U, m["encoder_highway"])
    step = (2 * (n_mels * P + P * inner) + _gru_step_flops(inner + M, A) + 2 * A * Z
            + 2 * (A + M) * D + m["decoder_layers"] * _gru_step_flops(D, D)
            + 2 * D * m["reduction"] * n_mels)
    per_char_step = 2 * Z + 2 * M                      # a score and the context, a character
    decoder = sum(2 * n * M * Z + steps_for(f, m["reduction"]) * (step + n * per_char_step)
                  for n, f in zip(chars, frames))
    post_frame = _cbhg_flops(n_mels, m["postnet_banks"], tuple(m["postnet_projections"]),
                             m["postnet_units"], m["postnet_highway"])
    post_frame += 2 * 2 * m["postnet_units"] * m["n_stft"]
    return {"encoder": enc_frame * sum(chars), "decoder": decoder,
            "postnet": post_frame * sum(frames)}


def _banks_bound_s(frames: int, C: int, K: int) -> float:
    e = work.ELEM_BYTES["float32"]
    taps = work.bank_taps(K)
    return work._bound_s(2 * frames * C * BANK_CHANNELS * taps,
                         e * (frames * C + frames * K * BANK_CHANNELS + BANK_CHANNELS * C * taps),
                         "float32")


def batch_work(config: dict, chars: list[int], frames: list[int]) -> dict:
    """scan_bound_s, banks_bound_s and peak_s of one batch."""
    m, v = config["model"], config["vocoder"]
    U, Up = m["encoder_units"], m["postnet_units"]
    scans = 2 * (work.scan_bound_s(sum(chars), 1, U, "float32")
                 + work.scan_bound_s(sum(frames), 1, Up, "float32"))
    banks = (_banks_bound_s(sum(chars), m["prenet_size"] // 2, m["encoder_banks"])
             + _banks_bound_s(sum(frames), m["n_mels"], m["postnet_banks"]))
    n_fft = config["features"]["n_fft"]
    transforms = (2 * v["n_iter"] - 1) * sum(frames) * work.fft_flops(n_fft)
    peak = (sum(flops(config, chars, frames).values()) + transforms) / work.PEAK_FLOPS["float32"]
    return {"scan_bound_s": scans, "banks_bound_s": banks, "peak_s": peak}


def audio_rate(value: float) -> dict:
    """The window's audio seconds over its wall seconds under both names of
    the audio-rate metric: ``audio_s_per_s`` (bound 0.035) and
    ``longform_audio_s_per_s`` (bound 0.25, the host-bound cells', whose runs
    spread 5-15% between processes); BENCHMARK.json says which a cell
    reports."""
    return {"audio_s_per_s": value, "longform_audio_s_per_s": value}


# -------------------------------------------------------- layer context ---

@dataclasses.dataclass
class TtsLayerContext(LayerContext):
    records: list = dataclasses.field(default_factory=list)   # profiler.take() of the window
    counts: list = dataclasses.field(default_factory=list)    # profiler.take_counts()


def program_device_ms(ctx, name: str) -> list[float] | None:
    """Device ms of every program span ``name`` the window recorded; None
    where the run has no such records (no CUDA device, or a program that
    opens no such span)."""
    recs = getattr(ctx, "records", None) or []
    ms = [r.device_ms for r in recs if r.name == name and r.device_ms is not None]
    return ms or None


def program_span_median(ctx, name: str) -> float | None:
    ms = program_device_ms(ctx, name)
    return statistics.median(ms) if ms else None


def per_count_us(ctx, name: str, counter: str) -> float | None:
    """Device us of span ``name`` over the window's total of ``counter``."""
    ms = program_device_ms(ctx, name)
    total = sum(c.total for c in (getattr(ctx, "counts", None) or []) if c.name == counter)
    if not ms or total <= 0:
        return None
    return 1e3 * sum(ms) / total
