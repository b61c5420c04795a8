"""Process bootstrap and per-process data sharding.

Counterpart of ``speech_cloner_tpu/parallel/distributed.py``:

- `initialize()` starts ``torch.distributed`` from its arguments (the
  coordinator's address, the process count and this process's id) or from
  the environment ``torchrun`` sets; it does nothing for a single process
  or a group already running, and returns True when more than one process
  runs. The backend is the caller's (``gloo`` on the CPU, ``nccl`` or
  ``gloo`` on cards); nothing switches it.
- `host_shard()` splits a sample index set rank-strided; `per_host_batch()`
  is a global batch's share of one process (JAX's assert kept).
- `spawn_world()` runs a function in every rank of a new world of
  processes on this machine (the ``spawn`` start method; the group meets
  through a file store in a fresh temporary directory, so concurrent worlds
  never share a port), and returns what each rank returned.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def _under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str = "gloo") -> bool:
    """Start the default process group when running multi-process; returns
    True if more than one process runs afterwards. ``coordinator_address``
    is ``host:port`` or a URL (``tcp://...``, ``file://...``); without it the
    ``torchrun`` environment is used when present, else this is a
    single-process run."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None:
        if not _under_torchrun():
            return False  # single-process run
        dist.init_process_group(backend, init_method="env://")
    else:
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id)
    return dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_shard(samples) -> np.ndarray:
    """Deterministic per-process strided split of a sample index set."""
    return np.asarray(samples)[process_index()::process_count()]


def per_host_batch(global_batch_size: int) -> int:
    n = process_count()
    if global_batch_size % n:
        raise AssertionError((global_batch_size, n))
    return global_batch_size // n


def _rank_entry(rank: int, fn, world_size: int, init_method: str, backend: str,
                result_dir: str, args: tuple) -> None:
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    try:
        out = fn(rank, world_size, *args)
        torch.save(out, os.path.join(result_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_world(fn, world_size: int, *args, backend: str = "gloo") -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    joined in one process group, wait for them all, and return their
    results in rank order. ``fn`` and ``args`` must pickle (``fn`` importable
    by module and name); a rank that raises makes this raise."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="scl_world_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_rank_entry, nprocs=world_size, start_method="spawn", join=True,
                           args=(fn, world_size, init_method, backend, tmp, args))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
