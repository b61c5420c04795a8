"""Offline conversion of short clips of many lengths through
``ClonePipeline.convert_pcm16``: the offline path of ``traffic/offline.py``
(its `Windows` clip path, instruments and comparison, unchanged) with each
clip's length drawn from the seed.

Mix parameters: ``seconds_range`` (each clip's seconds, uniform over it,
one clip in each of ``pool`` equal strata, so each seed's pool spans the
range alike and the rate does not swing with the draw),
``pool`` (distinct clips made in set-up, each from its own seed and length,
taken in turn), ``warmup`` (calls in set-up: every window count the pool
holds, once, then ``warmup`` more), ``sample`` and ``sample_range`` (clips
compared: ``sample`` indices below ``sample_range`` drawn from the seed,
and clip 0), ``profiled`` (calls under the profiler in a traced run).
The rate is the window's summed clip seconds over its wall seconds
(`benchlib.tacotron.audio_rate`). The work counts behind the roofline and
utilization metrics are each clip's own, averaged over the clips each
metric reads.

Compared for each sampled clip: ``offline.py``'s numbers, and
``pcm_r8_q90``: the system's own vocoder (the pipeline's ``device_vocode``
at ``EARLY_ROUNDS`` = 8 rounds, or the control's) from the clip's stitched
spectrogram and the timed call's phase draw, against the reference's
vocoder at 8 rounds from the same two, as the 90th-percentile
0.1 s block gap of the PCM, both in float. It reads the vocoder at the
clip's own length (window envelope, reflect padding, trim, the per-clip
norms). ``offline.py``'s PCM numbers set the timed call's int16 output
against the reference's float PCM: where a clip's quiet 0.1 s blocks hold
a few steps of int16 (a peak 11-14x the clip's RMS), the cast alone reads
up to 0.22 there, while float against float the two vocoders agree to
6e-5 at any round count up to 200; so those numbers have no limit here.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from benchlib import cells
from benchlib.audio import voiced_clips
from benchlib.check import Numbers, block_l2
from benchlib.driving import Capture, DriverResult, free, sample, timed_window, unit_seed
from benchlib.layers import LayerContext
from benchlib.tacotron import audio_rate
from benchlib.trace import profile_window
from benchlib.weights import make_trees
from reference import dsp
from reference.precision import REFERENCE, control_for

SALT_WEIGHTS, SALT_CLIPS, SALT_PHASE, SALT_SAMPLE, SALT_LENGTHS = 0, 1, 2, 3, 4

EARLY_ROUNDS = 8    # the vocoder number's rounds: 8 of 200 part the program from the control 47x

offline = cells.load_driver("offline")


def clip_seconds(tr: dict, seed: int) -> list[float]:
    """Each pool clip's seconds, uniform over ``seconds_range``, drawn
    stratified: one clip in each of ``pool`` equal strata, at a place in it
    drawn from the seed, in an order drawn from the seed (whole samples are
    the callers' to round)."""
    lo, hi = tr["seconds_range"]
    rng = np.random.default_rng([seed, SALT_LENGTHS])
    n = tr["pool"]
    seconds = lo + (hi - lo) * (np.arange(n) + rng.random(n)) / n
    rng.shuffle(seconds)
    return [float(s) for s in seconds]


def early_pcm(system, cfg: dict, stitched, phase, rounds: int, control: bool):
    """The system's vocoder at ``rounds`` rounds from ``stitched`` and
    ``phase``, at the PCM scale (float): the program pipeline's own
    ``device_vocode``, or the control's reference in its precision."""
    if control:
        with control_for(cfg).active():
            y = dsp.vocode(stitched, phase, cfg["features"], dict(cfg["vocoder"], n_iter=rounds))
    else:
        y = dataclasses.replace(system, n_iter=rounds).device_vocode(stitched, init_phase=phase)
    return dsp.pcm16_float(y)


def early_gap(cfg: dict, stitched, phase, got) -> dict:
    """``pcm_r8_q90``: the system's PCM ``got`` at `EARLY_ROUNDS` rounds
    against the reference's vocoder at as many rounds from the same input."""
    with REFERENCE.active():
        ref = dsp.pcm16_float(dsp.vocode(stitched, phase, cfg["features"],
                                         dict(cfg["vocoder"], n_iter=EARLY_ROUNDS)))
    return {f"pcm_r{EARLY_ROUNDS}_q90": float(np.quantile(block_l2(got, ref, offline.BLOCK), 0.9))}


def run(cell, ctx):
    path = offline.Windows()
    cfg, tr = cell.config, cell.traffic
    sr = cfg["features"]["sample_rate"]
    trees = make_trees(cfg, unit_seed(ctx.seed, SALT_WEIGHTS, 0), ctx.device)
    seconds = clip_seconds(tr, ctx.seed)
    pool = [voiced_clips([unit_seed(ctx.seed, SALT_CLIPS, i)], s, sr, ctx.device)[0]
            for i, s in enumerate(seconds)]
    cap = Capture()
    system = (path.control if ctx.control else path.program)(cell, trees, ctx, cap)
    if ctx.on_system:
        ctx.on_system(system)

    def call(i: int):
        return path.call(system, pool[i % len(pool)], unit_seed(ctx.seed, SALT_PHASE, i))

    def clip_work(i: int) -> dict:
        one = copy.copy(cell)
        one.traffic = dict(tr, clip_seconds=len(pool[i % len(pool)]) / sr)
        return path.work(one)

    # every window count of the pool once (a shape not warmed would build
    # its plans inside the window), then the mix's own warm-up calls
    firsts = {}
    for i, wav in enumerate(pool):
        firsts.setdefault(clip_work(i)["banks_bound_s"], i)
    for k, i in enumerate(list(firsts.values()) + list(range(tr["warmup"]))):
        path.call(system, pool[i], unit_seed(ctx.seed, SALT_PHASE, 10**9 + k))
    ctx.sync()
    setup_s = ctx.clock()

    picks = sample(ctx.seed, SALT_SAMPLE, tr["sample_range"], tr["sample"], always=(0,))
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
    n_done, wall = timed_window(ctx.seconds, unit)
    ctx.spans.on = False
    peak = ctx.peak_bytes()
    audio_s = sum(len(pool[i % len(pool)]) / sr for i in range(n_done))

    layer = prof = None
    if ctx.trace:
        spans_ms = ctx.spans.ms()
        prof = profile_window(lambda: [call(10**6 + j) for j in range(tr["profiled"])],
                              lambda: call(10**6 + tr["profiled"]))

        def mean_work(indices) -> dict:
            ws = [clip_work(i) for i in indices]
            return {k: sum(w[k] for w in ws) / len(ws) for k in ("scan_bound_s", "banks_bound_s",
                                                                   "peak_s")}
        window = mean_work(range(n_done))
        layer = LayerContext(units=n_done, window_s=wall, spans_ms=spans_ms,
                             scan_bound_s=mean_work(range(10**6, 10**6 + tr["profiled"]))[
                                 "scan_bound_s"],
                             banks_bound_s=window["banks_bound_s"], peak_s=window["peak_s"],
                             banks_per_unit=3, profile=prof, profiled_units=tr["profiled"])

    early = {}      # the system's vocoder at a few rounds, each compared clip
    for i, (out, got) in kept.items():
        phase = dsp.phase_draw(got["stitched"].shape, unit_seed(ctx.seed, SALT_PHASE, i),
                               ctx.device)
        early[i] = (phase, early_pcm(system, cfg, got["stitched"], phase, EARLY_ROUNDS,
                                     ctx.control))
    del system
    free(ctx)
    numbers = Numbers(path.median_of)
    for i, (out, got) in sorted(kept.items()):
        wav = torch.tensor(pool[i % len(pool)], device=ctx.device)
        readings = path.compare(cell, trees, wav, unit_seed(ctx.seed, SALT_PHASE, i), out, got)
        numbers.unit({**readings, **early_gap(cfg, got["stitched"], *early[i])})
    return DriverResult(attempted=n_done,
                        end_to_end={**audio_rate(audio_s / wall), "setup_s": setup_s},
                        numbers=numbers, memory_peak_bytes=peak, layer=layer, profile=prof)
