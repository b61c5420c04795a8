"""Batched text-to-speech through ``SynthesisPipeline.synthesize_batch_pcm16``:
one caller, batch after batch, as fast as they complete (a closed loop).

Mix parameters: ``batch`` (sentences a call), ``pool`` (distinct batches
made in set-up, each from its own seed, taken in turn), ``warmup`` (calls
in set-up), ``seconds_range`` and ``seconds_beta`` (each sentence's seconds:
lo + (hi - lo) x Beta(a, b), drawn stratified: a batch of B holds one
sentence from each of B equal-probability strata of the distribution, at a
place in it drawn from the seed, so every batch has the distribution's
spread and the rate does not swing with the draw), ``chars_per_second`` (its characters,
rounded; ids uniform over 1-255), ``frames_per_second`` (its frames,
rounded; the decoder runs ceil(frames / r) steps), ``sample`` and
``sample_range`` (batches compared: ``sample`` indices below
``sample_range`` drawn from the seed, and batch 0), ``sample_rows``
(rows compared in each: that many drawn from the seed, and the first and
the last row), ``start_steps`` and ``profiled`` (calls under the profiler
in a traced run). Each call draws its Griffin-Lim phases from its own
seed. The rate is the window's summed sentence seconds over its wall
seconds (`benchlib.tacotron.audio_rate`).

Compared for each sampled row, against ``reference/tacotron.py`` run on
that sentence alone: ``mel``, every decoder step, the reference fed the
program's own frame of the step before (as the stream cell follows the
program's state), so a gap cannot pile up through the feedback; ``start``,
the reference's own free-running chain over the first ``start_steps``
steps; ``linear``, the post-net from the program's mel; ``pcm_q90_med``
(the median row's 90th-percentile 0.1 s block gap), the vocoder from the
program's spectrogram with the same phase draw, each int16 sample given
one step of slack (`step_gaps`).

The traced window runs under the program's recorder
(``runtime.profiler.recording``): its spans and counters fill the layer
context (`benchlib.tacotron.TtsLayerContext`).
"""

from __future__ import annotations

import types

import numpy as np
import torch
from scipy.special import betaincinv

from benchlib import program
from benchlib import tacotron as bt
from benchlib.check import Numbers, block_l2, gap_peak
from benchlib.driving import Capture, DriverResult, free, sample, timed_window, unit_seed
from benchlib.trace import profile_window
from reference import dsp
from reference import tacotron as ref
from reference.precision import REFERENCE, control_for

SALT_WEIGHTS, SALT_BATCHES, SALT_PHASE, SALT_SAMPLE, SALT_ROWS = 0, 1, 2, 3, 4


def make_batch(tr: dict, seed: int, vocab: int) -> dict:
    """One batch of sentences from ``seed``: ids [B, N] (0 after each row),
    lengths, frames and seconds."""
    rng = np.random.default_rng(seed)
    lo, hi = tr["seconds_range"]
    B = tr["batch"]
    strata = (np.arange(B) + rng.random(B)) / B            # a draw in each of B equal strata
    seconds = lo + (hi - lo) * betaincinv(*tr["seconds_beta"], strata)
    rng.shuffle(seconds)
    chars = np.maximum(np.round(tr["chars_per_second"] * seconds), 1).astype(np.int64)
    frames = np.round(tr["frames_per_second"] * seconds).astype(np.int64)
    ids = rng.integers(1, vocab, size=(tr["batch"], int(chars.max())))
    ids[np.arange(ids.shape[1])[None, :] >= chars[:, None]] = 0
    return {"ids": ids, "lengths": chars, "frames": [int(f) for f in frames],
            "seconds": float(seconds.sum())}


def pipeline(config: dict, trees, device):
    """The port's `SynthesisPipeline` on ``device`` with the trees' weights."""
    from speech_cloner_tpu_torch.models import tacotron as taco
    from speech_cloner_tpu_torch.pipeline.tts import SynthesisPipeline
    from speech_cloner_tpu_torch.runtime.config import tacotron_config_from_cfg_d

    cfg, feat, voc = tacotron_config_from_cfg_d(config)
    model = taco.Tacotron(*trees, cfg).to(device).eval()
    return SynthesisPipeline(cfg=cfg, model=model, feat_cfg=feat, device=torch.device(device),
                             **voc)


def instrument(pipe, cap: Capture, spans) -> None:
    """Capture the mel frames and the linear spectrogram; span the banks."""
    inner = pipe.device_synthesize

    def device_synthesize(*args, **kwargs):
        mel, linear = inner(*args, **kwargs)
        if cap.armed:
            cap.got.update(mel=mel.clone(), linear=linear.clone())
        return mel, linear

    object.__setattr__(pipe, "device_synthesize", device_synthesize)
    m = pipe.model
    program.instrument_banks(types.SimpleNamespace(_models=(m,), encoder=m, decoder=m), spans)


class Control:
    """The reference, one precision below the configuration's, in the
    program's place: each row compared is synthesized alone; the rows not
    compared, and every call not compared, give silence."""

    def __init__(self, trees, config: dict, device, cap: Capture, rows: dict):
        self.trees, self.config, self.device, self.cap = trees, config, device, cap
        self.rows, self.prec, self.calls = rows, control_for(config), 0

    def synthesize_batch_pcm16(self, ids, lengths, frames, seed: int = 0):
        call, self.calls = self.calls, self.calls + 1
        hop = dsp.dims(self.config["features"])["hop"]
        pcm = [np.zeros((n - 1) * hop, np.int16) for n in frames]
        if not self.cap.armed:
            return pcm
        m = self.config["model"]
        T, steps = max(frames), max(bt.steps_for(n, m["reduction"]) for n in frames)
        mel = torch.zeros(len(frames), steps * m["reduction"], m["n_mels"], device=self.device)
        linear = torch.zeros(len(frames), T, m["n_stft"], device=self.device)
        phases = ref.phase_draws(frames, m["n_stft"], seed, self.device)
        for b in self.rows[call]:
            row = torch.as_tensor(ids[b, :lengths[b]], device=self.device)
            out = ref.synthesize(self.trees, row, frames[b], phases[b], self.config, self.prec)
            mel[b, :frames[b]], linear[b, :frames[b]] = out["mel"], out["linear"]
            pcm[b] = out["pcm"].to(torch.int16).cpu().numpy()
        self.cap.got.update(mel=mel, linear=linear)
        return pcm


def step_gaps(pcm, ref, block: int) -> np.ndarray:
    """`block_l2` of int16 PCM against the reference's float PCM, each
    sample's gap less one step: the int16 cast truncates (under a step
    from the float), so the cast alone reads 0, also in quiet blocks of a
    few steps, where it would read up to ~0.2; a gap of more than a step
    counts all it exceeds."""
    g, r = np.asarray(pcm, np.float64), np.asarray(ref, np.float64)
    over = np.maximum(np.abs(g - r) - 1.0, 0.0)
    return block_l2(r + np.sign(g - r) * over, r, block)


def compare_row(config, trees, ids: torch.Tensor, n: int, start_steps: int, phase0, pcm,
                mel, linear) -> dict:
    """The readings of one sentence: ``mel`` [n, n_mels] and ``linear``
    [n, n_stft] the program's, ``pcm`` its int16 samples."""
    m = config["model"]
    with REFERENCE.active():
        fed = ref.decode_fed(trees, ids, mel, config, REFERENCE)
        memory = ref.encoder(trees, ids, REFERENCE)
        first = min(start_steps, bt.steps_for(n, m["reduction"]))
        own = ref.decode(trees, memory, first, m["n_mels"], REFERENCE).reshape(-1, m["n_mels"])
        k = min(own.shape[0], n)
        post = ref.postnet(trees, mel, REFERENCE)
        voc = dsp.pcm16_float(dsp.vocode(linear, phase0, config["features"], config["vocoder"]))
    block = int(round(0.1 * config["features"]["sample_rate"]))
    return {"mel": gap_peak(mel, fed), "start": gap_peak(mel[:k], own[:k]),
            "linear": gap_peak(linear, post),
            "pcm_q90_med": float(np.quantile(step_gaps(pcm, voc.cpu().numpy(), block), 0.9))}


def run(cell, ctx):
    # the program's text-to-speech path, or an exit at once where it has none
    from speech_cloner_tpu_torch.pipeline import tts  # noqa: F401
    from speech_cloner_tpu_torch.runtime import profiler

    cfg, tr = cell.config, cell.traffic
    trees = bt.make_trees(cfg, unit_seed(ctx.seed, SALT_WEIGHTS, 0), ctx.device)
    pool = [make_batch(tr, unit_seed(ctx.seed, SALT_BATCHES, j), cfg["model"]["vocab_size"])
            for j in range(tr["pool"])]
    picks = sample(ctx.seed, SALT_SAMPLE, tr["sample_range"], tr["sample"], always=(0,))
    rows = {i: sorted(sample(unit_seed(ctx.seed, SALT_ROWS, i), SALT_ROWS, tr["batch"],
                             tr["sample_rows"], always=(0, tr["batch"] - 1))) for i in picks}
    cap = Capture()
    if ctx.control:
        system = Control(trees, cfg, ctx.device, cap,
                         {tr["warmup"] + i: r for i, r in rows.items()})
    else:
        system = pipeline(cfg, trees, ctx.device)
        instrument(system, cap, ctx.spans)
    if ctx.on_system:
        ctx.on_system(system)

    def call(i: int):
        b = pool[i % len(pool)]
        return system.synthesize_batch_pcm16(b["ids"], b["lengths"], b["frames"],
                                             seed=unit_seed(ctx.seed, SALT_PHASE, i))

    for i in range(tr["warmup"]):
        call(10**9 + i)
    ctx.sync()
    setup_s = ctx.clock()

    kept: dict[int, tuple] = {}

    def unit(i: int) -> None:
        cap.armed = i in picks
        out = call(i)
        if cap.armed:
            kept[i] = (out, dict(cap.got))
            cap.got.clear()
            cap.armed = False

    ctx.reset_peak()
    ctx.spans.on = ctx.trace
    profiler.take(), profiler.take_counts()
    if ctx.trace:
        with profiler.recording():
            n_done, wall = timed_window(ctx.seconds, unit)
        records, counts = profiler.take(), profiler.take_counts()
    else:
        n_done, wall = timed_window(ctx.seconds, unit)
    ctx.spans.on = False
    peak = ctx.peak_bytes()
    seconds = sum(pool[i % len(pool)]["seconds"] for i in range(n_done))

    layer = prof = None
    if ctx.trace:
        spans_ms = ctx.spans.ms()
        prof = profile_window(lambda: [call(10**6 + j) for j in range(tr["profiled"])],
                              lambda: call(10**6 + tr["profiled"]))

        def mean_work(indices) -> dict:
            ws = [bt.batch_work(cfg, list(pool[i % len(pool)]["lengths"]),
                                pool[i % len(pool)]["frames"]) for i in indices]
            return {k: sum(w[k] for w in ws) / len(ws) for k in ws[0]}
        window = mean_work(range(n_done))
        profiled = mean_work(range(10**6, 10**6 + tr["profiled"]))
        layer = bt.TtsLayerContext(units=n_done, window_s=wall, spans_ms=spans_ms,
                                   scan_bound_s=profiled["scan_bound_s"],
                                   banks_bound_s=window["banks_bound_s"],
                                   peak_s=window["peak_s"], banks_per_unit=2, profile=prof,
                                   profiled_units=tr["profiled"], records=records,
                                   counts=counts)

    del system
    free(ctx)
    numbers = Numbers(("pcm_q90_med",))
    m = cfg["model"]
    for i, (pcm, got) in sorted(kept.items()):
        b = pool[i % len(pool)]
        phases = ref.phase_draws(b["frames"], m["n_stft"], unit_seed(ctx.seed, SALT_PHASE, i),
                                 ctx.device)
        for r in rows[i]:
            n = b["frames"][r]
            ids = torch.as_tensor(b["ids"][r, :b["lengths"][r]], device=ctx.device)
            numbers.unit(compare_row(cfg, trees, ids, n, tr["start_steps"], phases[r],
                                     np.asarray(pcm[r], np.float64), got["mel"][r, :n],
                                     got["linear"][r, :n]))
    return DriverResult(attempted=n_done,
                        end_to_end={**bt.audio_rate(seconds / wall), "setup_s": setup_s},
                        numbers=numbers, memory_peak_bytes=peak, layer=layer, profile=prof)
