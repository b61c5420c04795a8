"""The numbers that decide ``correct``, and their judgement against the
cell's limits.

Every number is a gap between what the program's timed path produced and
what the reference works out from the same inputs, the worst over the
sampled units (clips, or streams of the sampled steps):

- ``*_peak``: the widest absolute gap over the reference's peak magnitude;
- ``*_l2``: the norm of the difference over the reference's norm.

A number that is not finite reads as failed.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float64)


def gap_peak(got, ref) -> float:
    g, r = _np(got), _np(ref)
    if g.shape != r.shape:
        return math.inf
    return float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-30))


def gap_l2(got, ref) -> float:
    g, r = _np(got), _np(ref)
    if g.shape != r.shape:
        return math.inf
    return float(np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30))


def block_l2(got, ref, block: int) -> np.ndarray:
    """Relative L2 gap of each block of ``block`` samples along the last axis
    (each block's reference norm floored at a thousandth of the whole's RMS
    block norm, so a near-silent block does not divide by ~0)."""
    g, r = _np(got), _np(ref)
    n = (r.shape[-1] // block) * block
    g = g[..., :n].reshape(*g.shape[:-1], -1, block)
    r = r[..., :n].reshape(*r.shape[:-1], -1, block)
    rn = np.linalg.norm(r, axis=-1)
    floor = 1e-3 * np.sqrt(np.mean(rn ** 2))
    return np.linalg.norm(g - r, axis=-1) / np.maximum(rn, floor)


class Numbers:
    """Each number over the units compared: the worst unit's reading, or for
    the names in ``median_of`` the median unit's (a number whose units swing
    by nature, as Griffin-Lim's output does, read steadily)."""

    def __init__(self, median_of: tuple[str, ...] = ()):
        self.median_of = set(median_of)
        self.readings: list[dict[str, float]] = []

    def unit(self, readings: dict[str, float]) -> None:
        """One compared unit's readings."""
        self.readings.append({k: float(v) if np.isfinite(v) else math.inf
                              for k, v in readings.items()})

    @property
    def units(self) -> int:
        return len(self.readings)

    @property
    def values(self) -> dict[str, float]:
        out = {}
        for k in (self.readings[0] if self.readings else {}):
            v = [r[k] for r in self.readings]
            out[k] = float(np.median(v)) if k in self.median_of else max(v)
        return out


def judge(numbers: Numbers, limits: dict[str, float]) -> tuple[bool, dict, int]:
    """(correct, {name: {"value", "limit"}}, units failed) over the cell's
    limits; a limit with no reading fails. A unit failed when it reads over
    a limit on a number taken by the worst unit, or on any number when the
    run is not correct."""
    values = numbers.values
    checks = {}
    ok = numbers.units > 0
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        checks[name] = {"value": v if math.isfinite(v) else None, "limit": limit}
        ok &= math.isfinite(v) and v <= limit
    worst = [k for k in limits if k not in numbers.median_of]
    failed = sum(any(not (r.get(k, math.inf) <= limits[k])
                     for k in (worst if ok else limits)) for r in numbers.readings)
    return ok, checks, failed if ok else max(failed, 1)


def print_checks(checks: dict, correct: bool) -> None:
    """The compared numbers beside their limits, as the last lines of stderr."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct {correct}", file=sys.stderr, flush=True)
