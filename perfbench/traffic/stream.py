"""Live streams in lockstep through ``StreamingCloner(batch=B).push``: every
stream pushes one chunk a step, as fast as steps complete (a closed loop:
a server whose B slots are all busy), and no stream is reset.

Mix parameters: ``streams`` (B), ``clip_seconds`` (each stream's audio,
its own seed, pushed chunk after chunk and round again), ``geometry`` and
``vocoder`` (the cloner's and its pipeline's settings), ``warmup_steady``
(steady steps in set-up, after the ramp), ``start_steps`` (the first steps,
run in set-up, compared with the reference's steps from the initial
state), ``sample`` and ``sample_range`` (window steps compared: ``sample``
indices below ``sample_range`` drawn from the seed, and step 0),
``profiled`` (steps under the profiler in a traced run).

A sampled step is compared from the program's own carried state: the
reference takes the state before the step and works the step out again
(features at the carried statistics, models, Griffin-Lim from the carried
phase, crossfade, IIR, output gain); compared are the vocode region's
spectrogram, the emitted audio, the carried crossfade tail and the carried
statistics. The start, which that skips, is compared by itself: the first
``start_steps`` steps against the reference's own chain from the initial
state.
"""

from __future__ import annotations

import math
import time

import numpy as np

from benchlib import program, work
from benchlib.audio import voiced_clips
from benchlib.check import Numbers, block_l2, gap_l2, gap_peak
from benchlib.driving import (Capture, DriverResult, RunContext, free, sample, timed_window,
                              unit_seed)
from benchlib.layers import LayerContext
from benchlib.trace import profile_window
from benchlib.weights import make_trees
from reference import dsp
from reference.precision import REFERENCE, control_for
from reference.stream import Stream, draws_before, geometry, initial_state

SALT_WEIGHTS, SALT_CLIPS, SALT_STREAM, SALT_SAMPLE = 0, 1, 2, 3
STATS_KEYS = ("m0", "mel_max", "gain")   # the carried feature statistics
BLOCK = 1600    # 0.1 s at 16 kHz: the blocks of the emitted audio's comparison


class Program:
    """The port's cloner, its state in the reference's layout, and the
    vocode region's spectrogram of armed steps."""

    def __init__(self, cell, trees, ctx: RunContext, cap: Capture, seed: int):
        from speech_cloner_tpu_torch.pipeline.stream import StreamingCloner

        tr = cell.traffic
        voc = {k: v for k, v in tr["vocoder"].items() if k != "out_gain_ema"}
        self.pipe = program.pipeline(cell.config, trees, ctx.device, **voc)
        self.cloner = StreamingCloner(self.pipe, batch=tr["streams"], seed=seed,
                                      out_gain_ema=tr["vocoder"]["out_gain_ema"], **tr["geometry"])
        self.seed, self.geo = seed, geometry(tr)
        self.n_stft = dsp.dims(cell.config["features"])["n_stft"]
        fwd = self.cloner._forward

        def forward(*args, **kwargs):
            out = fwd(*args, **kwargs)
            if cap.armed:
                cap.got["stft"] = out[0].clone()
            return out
        self.cloner._forward = forward
        ctx.spans.wrap(self.cloner, "_forward", "forward")
        ctx.spans.wrap(self.cloner, "_vocode", "vocode")
        program.instrument_banks(self.pipe, ctx.spans)

    def push(self, chunk: np.ndarray) -> np.ndarray:
        return self.cloner.push(chunk)

    def state(self) -> dict:
        s = self.cloner
        copy = lambda x: None if x is None else np.array(x)  # noqa: E731
        return {"buf": s._buf.copy(), "buf_start": s._buf_start, "n_samples": s._n_samples,
                "f0": s._f0, "gain": copy(s._gain), "pending": copy(s._pending),
                "audio_from": copy(s._audio_from), "g_sum": copy(s._g_sum),
                "g_cnt": copy(s._g_cnt), "g_upto": copy(s._g_upto), "m0": copy(s._m0),
                "mel_max": copy(s._mel_max), "tail": copy(s._tail),
                "phase_tail": copy(s._phase_tail), "inv_state": copy(s._inv_state),
                "out_ema": copy(s._out_ema), "out_gain_prev": copy(s._out_gain_prev),
                "out_pending": copy(s._out_pending), "seed": self.seed,
                "draws": draws_before(s._f0, self.geo, self.n_stft)}


class Control:
    """The reference's stream, one precision below the configuration's."""

    def __init__(self, cell, trees, ctx: RunContext, cap: Capture, seed: int):
        self.ref = Stream(trees, cell.config, cell.traffic, control_for(cell.config), ctx.device)
        self.st = initial_state(cell.traffic["streams"], cell.config["features"]["n_mels"], seed)
        self.cap = cap

    def push(self, chunk: np.ndarray) -> np.ndarray:
        emit, self.st = self.ref.push(self.st, chunk)
        if self.cap.armed and "stft" in self.st:
            self.cap.got["stft"] = self.st["stft"]
        return emit

    def state(self) -> dict:
        return {k: v for k, v in self.st.items() if k != "stft"}


def readings(emit, st_after: dict, stft, ref_emit, ref_st: dict) -> dict:
    """One step's numbers over its B streams."""
    B = ref_emit.shape[0]
    return {"stft": gap_peak(stft, ref_st["stft"]),
            "pcm_med": max(float(np.median(block_l2(emit[i], ref_emit[i], BLOCK)))
                           for i in range(B)),
            "tail_med": (float(np.median([gap_l2(st_after["tail"][i], ref_st["tail"][i])
                                          for i in range(B)]))
                         if st_after["tail"] is not None else math.inf),
            "stats": max(gap_peak(st_after[k], ref_st[k]) for k in STATS_KEYS)}


def run(cell, ctx: RunContext) -> DriverResult:
    cfg, tr = cell.config, cell.traffic
    B, geo = tr["streams"], geometry(tr)
    hop = dsp.dims(cfg["features"])["hop"]
    chunk = geo["C"] * hop
    trees = make_trees(cfg, unit_seed(ctx.seed, SALT_WEIGHTS, 0), ctx.device)
    clips = voiced_clips([unit_seed(ctx.seed, SALT_CLIPS, i) for i in range(B)],
                         tr["clip_seconds"], cfg["features"]["sample_rate"], ctx.device)
    n_chunks = clips.shape[1] // chunk

    def audio(k: int) -> np.ndarray:
        j = k % n_chunks
        return clips[:, j * chunk:(j + 1) * chunk]

    seed = unit_seed(ctx.seed, SALT_STREAM, 0)
    cap = Capture()
    system = (Control if ctx.control else Program)(cell, trees, ctx, cap, seed)
    if ctx.on_system:
        ctx.on_system(system)

    # set-up: the ramp (its first steps kept for the start's check), then
    # steady steps, each shape once before the window
    start, k = [], 0
    steady_from = geo["Lc"] + geo["EB"] + tr["warmup_steady"] * geo["C"]
    while system.state()["f0"] < steady_from:
        cap.armed = len(start) < tr["start_steps"]
        emit = system.push(audio(k))
        if cap.armed and emit.shape[1]:
            start.append((k, emit, system.state(), cap.got.pop("stft")))
        cap.got.clear()
        k += 1
    cap.armed = False
    ctx.sync()
    setup_s = ctx.clock()

    picks = sample(ctx.seed, SALT_SAMPLE, tr["sample_range"], tr["sample"], always=(0,))
    kept, step_ms = [], []
    first = k

    def unit(i: int) -> None:
        before = system.state() if i in picks else None
        cap.armed = before is not None
        t = time.perf_counter()
        emit = system.push(audio(first + i))
        step_ms.append((time.perf_counter() - t) * 1e3)
        if cap.armed:
            kept.append((i, before, emit, system.state(), cap.got.pop("stft")))
            cap.armed = False

    ctx.reset_peak()
    ctx.spans.on = ctx.trace
    n_done, wall = timed_window(ctx.seconds, unit)
    ctx.spans.on = False
    peak = ctx.peak_bytes()

    layer = prof = None
    if ctx.trace:
        spans_ms = ctx.spans.ms()
        spans_ms["host"] = [s - f - v for s, f, v in
                            zip(step_ms, spans_ms.get("forward", []), spans_ms.get("vocode", []))]
        nxt = first + n_done
        prof = profile_window(lambda: [system.push(audio(nxt + j)) for j in range(tr["profiled"])],
                              lambda: system.push(audio(nxt + tr["profiled"])))
        T = geo["Lc"] + geo["C"] + geo["Rc"] + 2 * geo["EB"]
        layer = LayerContext(
            units=n_done, window_s=wall, spans_ms=spans_ms,
            scan_bound_s=work.scans_bound_s(cfg, T, B),
            banks_bound_s=work.banks_bound_s(cfg, B * T),
            peak_s=work.step_seconds_at_peak(cfg, B * T, B * (T + 1),
                                             B * (geo["C"] + 2 * geo["M"]),
                                             tr["vocoder"]["n_iter"]),
            banks_per_unit=3, profile=prof, profiled_units=tr["profiled"])

    del system
    free(ctx)
    ref = Stream(trees, cfg, tr, REFERENCE, ctx.device)
    numbers = Numbers()
    st = initial_state(B, cfg["features"]["n_mels"], seed)
    at = 0
    for k_push, emit, st_after, stft in start:      # the reference's own chain
        while at <= k_push:
            ref_emit, st = ref.push(st, audio(at))
            at += 1
        numbers.unit(readings(emit, st_after, stft, ref_emit, st))
    for i, before, emit, st_after, stft in kept:    # from the program's state
        ref_emit, ref_st = ref.push(before, audio(first + i))
        numbers.unit(readings(emit, st_after, stft, ref_emit, ref_st))
    return DriverResult(
        attempted=n_done,
        end_to_end={"stream_step_ms_p95": float(np.percentile(step_ms, 95)),
                    "streams_per_card": B * chunk / cfg["features"]["sample_rate"] * n_done / wall,
                    "setup_s": setup_s},
        numbers=numbers, memory_peak_bytes=peak, layer=layer, profile=prof)
