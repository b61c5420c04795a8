"""One caller converting clips of one length back to back (a closed loop):
the loop the offline and long-form drivers share.

A driver gives a `ClipPath`: how to build and instrument the system, how
to call it on a clip, its control, its work counts, and how to compare a
sampled clip with the reference. The mix gives ``clip_seconds``, ``pool``
(distinct clips made in set-up, each from its own seed, taken in turn),
``warmup`` (calls in set-up), ``sample`` and ``sample_range`` (clips
compared: ``sample`` indices below ``sample_range`` drawn from the seed,
and clip 0) and ``profiled`` (calls under the profiler in a traced run).
Each call draws its Griffin-Lim phase from its own seed.
"""

from __future__ import annotations

import numpy as np
import torch

from .audio import voiced_clips
from .check import Numbers
from .driving import Capture, DriverResult, RunContext, free, sample, timed_window, unit_seed
from .layers import LayerContext
from .trace import profile_window
from .weights import make_trees

SALT_WEIGHTS, SALT_CLIPS, SALT_PHASE, SALT_SAMPLE = 0, 1, 2, 3


class ClipPath:
    median_of: tuple[str, ...] = ()     # numbers taken by the median clip

    def program(self, cell, trees, ctx: RunContext, cap: Capture):
        """The program's system, instrumented."""
        raise NotImplementedError

    def control(self, cell, trees, ctx: RunContext, cap: Capture):
        """The reference one precision below, in the program's place."""
        raise NotImplementedError

    def call(self, system, wav: np.ndarray, seed: int):
        raise NotImplementedError

    def work(self, cell) -> dict:
        """scan_bound_s, banks_bound_s, peak_s of one clip; banks_per_unit."""
        raise NotImplementedError

    def compare(self, cell, trees, wav: torch.Tensor, seed: int, out, got: dict) -> dict:
        """The readings of one clip: ``out`` the call's result, ``got`` its captures."""
        raise NotImplementedError


def run_clips(cell, ctx: RunContext, path: ClipPath) -> DriverResult:
    cfg, tr = cell.config, cell.traffic
    trees = make_trees(cfg, unit_seed(ctx.seed, SALT_WEIGHTS, 0), ctx.device)
    pool = voiced_clips([unit_seed(ctx.seed, SALT_CLIPS, i) for i in range(tr["pool"])],
                        tr["clip_seconds"], cfg["features"]["sample_rate"], ctx.device)
    cap = Capture()
    system = (path.control if ctx.control else path.program)(cell, trees, ctx, cap)
    if ctx.on_system:
        ctx.on_system(system)

    def call(i: int):
        return path.call(system, pool[i % len(pool)], unit_seed(ctx.seed, SALT_PHASE, i))

    for i in range(tr["warmup"]):
        call(10**9 + i)
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

    layer = prof = None
    if ctx.trace:
        spans_ms = ctx.spans.ms()
        prof = profile_window(lambda: [call(10**6 + j) for j in range(tr["profiled"])],
                              lambda: call(10**6 + tr["profiled"]))
        layer = LayerContext(units=n_done, window_s=wall, spans_ms=spans_ms,
                             profile=prof, profiled_units=tr["profiled"], **path.work(cell))

    del system
    free(ctx)
    numbers = Numbers(path.median_of)
    for i, (out, got) in sorted(kept.items()):
        wav = torch.tensor(pool[i % len(pool)], device=ctx.device)
        numbers.unit(path.compare(cell, trees, wav, unit_seed(ctx.seed, SALT_PHASE, i), out, got))
    return DriverResult(attempted=n_done,
                        end_to_end={"audio_s_per_s": n_done * tr["clip_seconds"] / wall,
                                    "setup_s": setup_s},
                        numbers=numbers, memory_peak_bytes=peak, layer=layer, profile=prof)
