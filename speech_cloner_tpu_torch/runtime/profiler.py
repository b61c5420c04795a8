"""Profiling hooks: a span recorder, torch.profiler traces, device memory.

Counterpart of ``speech_cloner_tpu/runtime/profiler.py`` (``jax.profiler``
there).

`span` names a region of the program: the clip, stream-step and long-form
paths open one at each layer boundary (``pipeline/clone.py``,
``pipeline/stream.py``). The recorder is off by default, and a span is then
one check of a module-level flag that hands back a shared null context: no
CUDA event, no ``record_function``, no allocation. Under `recording` each
span keeps its name, its unit (drawn by the outermost span of a call and
shared by every span nested in it), its parent, its host interval
(``time.perf_counter_ns``) and, when its ``device`` is a CUDA device, a pair
of timing events on that device's current stream; it also enters
``torch.profiler.record_function(name)``, so under a torch.profiler window
the spans lie on the same timeline as the kernels they launch. `take`
synchronizes once, resolves the events and hands back the records.

`count` adds to a named counter of the current unit (the unit of the
innermost open span, or one of its own outside any span): under `recording`
the totals are kept per unit and `take_counts` hands them back; while the
recorder is off it is the same one check of the flag and nothing else. The
text-to-speech path counts its decoder steps and the frames it emits
(``pipeline/tts.py``).

`trace` records the enclosed region, with the recorder on (its records are
dropped at its end unless a `recording` encloses it), and writes one
Chrome/Perfetto trace file (``<host>_<pid>.<time>.pt.trace.json``) under
``log_dir``, with the card's kernels and copies when ``device`` is a CUDA
device; `device_memory_stats` reads the caching allocator and the CUDA
runtime. The ``device`` argument decides CUDA or CPU, never what happens to
be available.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity

_ON = False                      # the recorder's switch (`recording`)
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()         # guards _records: spans may close on several threads
_records: list["_Span"] = []
_counts: dict[tuple[int, str], int] = {}     # (unit, name) -> total, under _LOCK
_units = itertools.count()
_open = threading.local()        # .stack: the spans open on this thread, innermost last


class SpanRecord(NamedTuple):
    name: str
    unit: int                     # shared by every span of one outermost call
    parent: int | None            # index of the enclosing span in the same `take`
    start_ns: int                 # host interval, time.perf_counter_ns
    end_ns: int
    host_ms: float
    device_ms: float | None       # between the span's CUDA events; None off a CUDA device
    self_ms: float                # host ms less the part covered by its children


class CountRecord(NamedTuple):
    name: str
    unit: int                     # the unit of the span the counts fell in (see `count`)
    total: int


class _Span:
    __slots__ = ("name", "device", "unit", "parent", "index", "t0", "t1", "ev0", "ev1", "rf")

    def __init__(self, name: str, device):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.ev0 = self.ev1 = self.t1 = None

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        stack = _open.__dict__.setdefault("stack", [])
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.index
        self.unit = next(_units) if outer is None else outer.unit
        with _LOCK:
            self.index = len(_records)
            _records.append(self)
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.ev0 = self._event()
        return self

    def __exit__(self, *exc):
        if self.ev0 is not None:
            self.ev1 = self._event()
        self.rf.__exit__(*exc)
        _open.stack.pop()
        self.t1 = time.perf_counter_ns()
        return False


def span(name: str, device=None):
    """A named region: a record of it while the recorder is on, with device
    time when ``device`` is a CUDA device; a shared null context when off."""
    if not _ON:
        return _NULL
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the current unit: that of the
    innermost open span on this thread, or a unit of its own outside any
    span. Nothing while the recorder is off."""
    if not _ON:
        return
    stack = getattr(_open, "stack", None)
    unit = stack[-1].unit if stack else next(_units)
    with _LOCK:
        _counts[unit, name] = _counts.get((unit, name), 0) + int(n)


def take_counts() -> list[CountRecord]:
    """Every counter total kept since the last `take_counts`, by unit and
    name in the order first counted, and clear them."""
    global _counts
    with _LOCK:
        counts, _counts = _counts, {}
    return [CountRecord(name, unit, total) for (unit, name), total in counts.items()]


@contextlib.contextmanager
def recording():
    """Turn the recorder on for the enclosed region, then back as it was."""
    global _ON
    was, _ON = _ON, True
    try:
        yield
    finally:
        _ON = was


def take() -> list[SpanRecord]:
    """Every span recorded since the last `take`, in the order they opened,
    and clear them. Synchronizes each device that holds a span's events
    once. Call it outside any span."""
    global _records
    with _LOCK:
        if any(s.t1 is None for s in _records):
            raise RuntimeError("profiler.take: a span is still open")
        spans, _records = _records, []
    for dev in {s.device for s in spans if s.ev0 is not None}:
        torch.cuda.synchronize(dev)
    host = [(s.t1 - s.t0) / 1e6 for s in spans]
    covered = [0.0] * len(spans)
    for s, ms in zip(spans, host):
        if s.parent is not None:
            covered[s.parent] += ms
    return [SpanRecord(s.name, s.unit, s.parent, s.t0, s.t1, ms,
                       None if s.ev0 is None else s.ev0.elapsed_time(s.ev1), ms - c)
            for s, ms, c in zip(spans, host, covered)]


@contextlib.contextmanager
def trace(log_dir: str | None = None, enabled: bool = True, device="cuda"):
    """Record the enclosed region into a trace file under ``log_dir``
    (default: ``scl_trace`` in the temporary directory), with the span
    recorder on, so the program's spans show in the timeline. The records
    the trace made are dropped at its end, unless it runs inside
    `recording`, whose caller then takes them."""
    if not enabled:
        yield
        return
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "scl_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    keep = _ON
    with _LOCK:
        first = len(_records)
    try:
        with recording(), torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
            yield
    finally:
        if not keep:
            with _LOCK:
                del _records[first:]


def device_memory_stats(device="cuda") -> dict:
    """{device name: {bytes_in_use, peak_bytes_in_use, bytes_limit}} for each
    CUDA device (``device`` "cuda") or the one named ("cuda:1"); a CPU
    ``device`` gives its name with an empty dict, as the JAX package reports
    its CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {str(device): {}}
    out = {}
    indices = [device.index] if device.index is not None else range(torch.cuda.device_count())
    for i in indices:
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                            "bytes_limit": torch.cuda.mem_get_info(i)[1]}
    return out
