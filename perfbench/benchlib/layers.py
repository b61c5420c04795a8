"""What a per-layer metric reads, and the readers the metric files share.

A reader returns a number, or None where its cell gave it nothing to read
(the harness then leaves the metric out). Shares of a roofline or a peak
are percentages and never stand in for a missing reading.
"""

from __future__ import annotations

import dataclasses
import statistics


@dataclasses.dataclass
class LayerContext:
    units: int                      # units (clips, steps) the traced window completed
    window_s: float                 # that window's host seconds
    spans_ms: dict[str, list[float]]   # CUDA-event spans by name over the window
    scan_bound_s: float             # least seconds of one unit's scans
    banks_bound_s: float            # least seconds of one unit's bank convolutions
    peak_s: float                   # least seconds of one unit's work at the card's peaks
    banks_per_unit: int             # bank convolutions a unit runs
    profile: dict | None            # `trace.profile_window` over `profiled_units`
    profiled_units: int


def span_median(ctx: LayerContext, name: str) -> float | None:
    v = ctx.spans_ms.get(name)
    return statistics.median(v) if v else None


def scan_roofline(ctx: LayerContext) -> float | None:
    """Least time of the profiled units' scans over their kernels' device time, %."""
    p = ctx.profile
    if not p or p["scan_s"] <= 0 or ctx.profiled_units <= 0:
        return None
    return 100.0 * ctx.scan_bound_s * ctx.profiled_units / p["scan_s"]


def banks_roofline(ctx: LayerContext) -> float | None:
    """Least time of the bank convolutions over their spans' time, %."""
    v = ctx.spans_ms.get("banks")
    if not v or len(v) < ctx.banks_per_unit:
        return None
    units = len(v) / ctx.banks_per_unit
    return 100.0 * ctx.banks_bound_s * units / (sum(v) / 1e3)


def mfu(ctx: LayerContext) -> float | None:
    """Least time of the window's work at the card's peaks over its wall time, %."""
    if ctx.units <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.peak_s * ctx.units / ctx.window_s


def idle_share(ctx: LayerContext) -> float | None:
    """Share of the profiled window in which no operation ran on the device, %."""
    p = ctx.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
