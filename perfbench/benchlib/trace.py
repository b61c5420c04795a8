"""The benchmark's own instruments: spans timed by CUDA events around calls
into the program's layers and modules, and a bounded torch.profiler window
read for device busy time, kernel time by name and idle gaps.

Spans go around the program's methods and modules from outside (an
instance attribute in place of a method, forward hooks on modules); the
program is not edited. Everything is kept in memory and read after the
window.
"""

from __future__ import annotations

import contextlib
import functools
import time

import numpy as np
import torch


class _HostMark(float):
    """A host-clock mark with the CUDA event's `elapsed_time` (CPU runs)."""

    def elapsed_time(self, end: float) -> float:
        return (end - self) * 1e3


class Spans:
    """CUDA-event spans by name (host-clock marks on a CPU device, where
    every call is synchronous); off until `on` is set."""

    def __init__(self, on_card: bool = True):
        self.on = False
        self.on_card = on_card
        self._pairs: dict[str, list] = {}
        self._open: dict[int, object] = {}

    def _event(self):
        if not self.on_card:
            return _HostMark(time.perf_counter())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        start = self._event()
        try:
            yield
        finally:
            self._pairs.setdefault(name, []).append((start, self._event()))

    def start(self, key) -> None:
        """Open a span under ``key`` (closed by `stop`), when on."""
        if self.on:
            self._open[key] = self._event()

    def stop(self, key, name: str) -> None:
        """Close the span opened under ``key`` as span ``name``."""
        start = self._open.pop(key, None)
        if start is not None:
            self._pairs.setdefault(name, []).append((start, self._event()))

    def wrap(self, obj, method: str, name: str) -> None:
        """Time every call of ``obj.method`` as span ``name``."""
        inner = getattr(obj, method)

        @functools.wraps(inner)
        def timed(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)
        object.__setattr__(obj, method, timed)

    def ms(self) -> dict[str, list[float]]:
        """Milliseconds of every span, by name (synchronizes)."""
        if self.on_card:
            torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self._pairs.items()}


def _union(intervals: np.ndarray) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in intervals[np.argsort(intervals[:, 0])]:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _record(fn, label: str, host: bool):
    """Events of ``fn()`` run under torch.profiler, and its window [w0, w1] (us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.cuda.is_available()
    acts = ([ProfilerActivity.CPU] if host or not on_card else []) + \
        ([ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(label):
            fn()
            if on_card:
                torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name != label]
    win = [e for e in events if e.name == label]
    if win:
        w0, w1 = win[0].time_range.start, win[0].time_range.end
    else:       # no host activity recorded: the device's first start and the host's wall
        w0 = min((e.time_range.start for e in dev), default=0.0)
        w1 = w0 + wall_us
    host_ops = [e for e in events if e.device_type == DeviceType.CPU and e.name != label]
    return dev, host_ops, w0, w1


def _busy(dev, w0: float, w1: float):
    by_name: dict[str, float] = {}
    iv = []
    for e in dev:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t > s:
            iv.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e6
    return (_union(np.array(iv)) if iv else []), by_name


def profile_window(fn, label_fn=None, label: str = "bench.window", top: int = 10) -> dict:
    """Run ``fn()`` under torch.profiler with device activity alone (the
    host's operations are not recorded, so the profiler adds little to the
    host's time) and read: seconds of the window, seconds in which some
    operation ran on the device (the union of their intervals), device
    seconds by name and of the kernels named ``gru_scan*``. Then run
    ``label_fn()`` (default ``fn``) with the host's operations recorded too,
    and name each of its longest idle gaps by the innermost host operation
    running at the time."""
    dev, _, w0, w1 = _record(fn, label, host=False)
    busy, by_name = _busy(dev, w0, w1)
    dev2, host, v0, v1 = _record(label_fn or fn, label, host=True)
    busy2, _ = _busy(dev2, v0, v1)
    gaps = [(a[1], b[0]) for a, b in zip([(v0, v0)] + busy2, busy2 + [(v1, v1)]) if b[0] > a[1]]
    hs = np.array([e.time_range.start for e in host])
    he = np.array([e.time_range.end for e in host])
    names = [e.name for e in host]
    idle: dict[str, float] = {}
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        mid = 0.5 * (s + t)
        cover = np.flatnonzero((hs <= mid) & (he >= mid)) if len(hs) else np.array([], int)
        what = names[cover[np.argmin(he[cover] - hs[cover])]] if cover.size else "(no host op)"
        idle[what] = idle.get(what, 0.0) + (t - s) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(t - s for s, t in busy) / 1e6,
            "scan_s": sum(v for k, v in by_name.items() if "gru_scan" in k),
            "device_ops": [[k[:120], v] for k, v in ranked[:top]],
            "idle_gaps": [[k[:120], v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}


class Clock:
    """Host seconds since an origin (the process's start for set-up)."""

    def __init__(self, origin: float | None = None):
        self.origin = time.perf_counter() if origin is None else origin

    def __call__(self) -> float:
        return time.perf_counter() - self.origin
