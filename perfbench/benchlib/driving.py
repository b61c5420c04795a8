"""What every traffic driver shares: the run's context, the result it hands
back, seeds of the units, and the sampled units' choice."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable

import numpy as np
import torch

from .check import Numbers
from .trace import Clock, Spans


@dataclasses.dataclass
class RunContext:
    seed: int
    seconds: float
    trace: bool
    control: bool
    device: torch.device
    clock: Clock                                  # seconds since the process started
    on_system: Callable | None = None             # tests: alter the built system
    spans: Spans = None

    def __post_init__(self):
        self.spans = Spans(on_card=self.on_card)

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        return int(torch.cuda.max_memory_allocated()) if self.on_card else 0


@dataclasses.dataclass
class DriverResult:
    attempted: int                     # units the window completed
    end_to_end: dict[str, float]       # the cell's end-to-end metrics, by name
    numbers: Numbers                   # the comparison with the reference
    memory_peak_bytes: int
    layer: object = None               # `layer_metrics` context of a traced run
    profile: dict | None = None        # `trace.profile_window` of a traced run


class Capture:
    """Stage outputs of the calls it is armed for."""

    def __init__(self):
        self.armed = False
        self.got: dict = {}


def free(ctx: RunContext) -> None:
    """Give back the device memory of the program's freed state."""
    gc.collect()
    if ctx.on_card:
        torch.cuda.empty_cache()


def unit_seed(seed: int, salt: int, i: int) -> int:
    """Seed of unit ``i`` of the run (below 2**62)."""
    return int(np.random.SeedSequence([seed, salt, i]).generate_state(1, dtype=np.uint64)[0] >> 2)


def sample(seed: int, salt: int, n_range: int, k: int, always: tuple[int, ...] = ()) -> set[int]:
    """``k`` unit indices below ``n_range`` drawn from the seed, with ``always``."""
    rng = np.random.default_rng([seed, salt])
    picks = rng.choice(n_range, size=min(k, n_range), replace=False)
    return set(int(i) for i in picks) | set(always)


def timed_window(seconds: float, unit: Callable[[int], None]) -> tuple[int, float]:
    """Run ``unit(i)`` for i = 0, 1, ... until ``seconds`` have passed;
    (units completed, seconds from the first start to the last end)."""
    t0 = time.perf_counter()
    i = 0
    while True:
        unit(i)
        i += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return i, elapsed
