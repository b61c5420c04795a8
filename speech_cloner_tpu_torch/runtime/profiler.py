"""Profiling hooks: torch.profiler traces, named regions, device memory.

Counterpart of ``speech_cloner_tpu/runtime/profiler.py`` (``jax.profiler``
there): `trace` records the enclosed region and writes one Chrome/Perfetto
trace file (``<host>_<pid>.<time>.pt.trace.json``) under ``log_dir``, with
the card's kernels and copies when ``device`` is a CUDA device; `annotate`
names a region in that timeline; `device_memory_stats` reads the caching
allocator and the CUDA runtime. The ``device`` argument decides CUDA or CPU,
never what happens to be available.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(log_dir: str | None = None, enabled: bool = True, device="cuda"):
    """Record the enclosed region into a trace file under ``log_dir``
    (default: ``scl_trace`` in the temporary directory)."""
    if not enabled:
        yield
        return
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "scl_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """A named region that shows in the trace's timeline."""
    return torch.profiler.record_function(name)


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
