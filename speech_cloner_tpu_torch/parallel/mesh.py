"""Meshes: named axes over torch devices, or over the ranks of a process group.

Counterpart of ``speech_cloner_tpu/parallel/mesh.py``. One JAX controller
drives every mesh; the port has two forms, chosen by the call site:

- `Mesh` (`make_seq_mesh`): a grid of ``torch.device``s in one process, for
  inference that is a function call (``convert_seq_parallel``,
  ``StreamingCloner(mesh=...)``). Each shard's work is launched on its own
  device, and what crosses shards is a ``tensor.to(neighbor, non_blocking=True)``
  (a peer copy between cards). A mesh may name one device several times:
  its shards then run one after another on that device with the same
  arithmetic, which is how one card runs 4 shards and the CPU tests run
  ``[cpu] * 4``.
- `ProcessMesh` (`make_mesh`): the 2-D ('data', 'model') layout of a
  ``torch.distributed`` world, one process per rank, for training: rank r
  sits at (r // n_model, r % n_model), as JAX's device grid is
  ``devices.reshape(n_data, n_model)``; each axis has its process group.

Axes: data (DP: the batch; gradients averaged over it), model (TP: the conv
banks' channels), seq (SP: time, for long-form inference). Asking for more
cards than exist raises (JAX's ``jax.devices()[:n]`` gives fewer quietly).

`Sharding` is the port's ``NamedSharding``: a mesh and a `Spec` that says
which tensor axis splits over which mesh axis. ``shard(x)`` gives a
`ProcessMesh` rank its own block, and a `Mesh` one block per device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over a grid of torch devices (``devices``: an object array)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device_list(self) -> list[torch.device]:
        """The devices in row-major order, one per shard."""
        return list(self.devices.flat)


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """The ('data', 'model') layout of a torch.distributed world: this rank's
    place in it, its device and the process group of each axis (None for a
    world of one)."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    groups: dict

    axis_names = ("data", "model")

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.rank // self.n_model if axis == "data" else self.rank % self.n_model

    def group(self, axis: str):
        return self.groups[axis]


def cuda_devices() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def canonical(device) -> torch.device:
    """One name per device: "cuda" is the current card's index, the CPU has none."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu") if d.type == "cpu" else d


def check_devices(devices) -> list[torch.device]:
    """The devices as torch.devices; a CUDA index past the cards there are raises."""
    out = [torch.device(d) for d in devices]
    n_cards = torch.cuda.device_count()
    for d in out:
        if d.type == "cuda" and (d.index or 0) >= n_cards:
            raise ValueError(f"device {d} asked for; this machine has {n_cards} CUDA device(s)")
    return [canonical(d) for d in out]


def make_seq_mesh(n_seq: int | None = None, devices=None, axis_name: str = "seq") -> Mesh:
    """1-D mesh of ``n_seq`` shards over ``devices`` (default: the CUDA
    devices there are; all of them when ``n_seq`` is None). More shards than
    devices raises; name a device several times to put several shards on it."""
    devices = cuda_devices() if devices is None else check_devices(devices)
    n_seq = n_seq or len(devices)
    if n_seq > len(devices):
        raise ValueError(f"a mesh of {n_seq} shards needs {n_seq} devices; "
                         f"{len(devices)} given or present")
    grid = np.empty(n_seq, dtype=object)
    grid[:] = devices[:n_seq]
    return Mesh(grid, (axis_name,))


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None) -> ProcessMesh:
    """The ('data', 'model') mesh of the running torch.distributed world
    (default n_data: world // n_model). Every rank calls it, in the same
    order as its other group creations. ``device``: this rank's device
    (default: the current CUDA device under NCCL, else the CPU). Without a
    process group only a mesh of one is possible."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh data={n_data} x model={n_model} needs {n_data * n_model} "
                         f"processes; the world has {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.is_initialized() and dist.get_backend() == "nccl"
                  else torch.device("cpu"))
    groups = {"data": None, "model": None}
    if dist.is_initialized():
        # every rank creates every group, in one order
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                groups["model"] = g
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                groups["data"] = g
    return ProcessMesh(n_data, n_model, rank, torch.device(device), groups)


# ------------------------------------------------------------------ shardings ---

@dataclasses.dataclass(frozen=True)
class Spec:
    """Tensor axis ``dim`` split over mesh axis ``axis`` (None: replicated).
    With ``block``, the axis is a run of blocks of that many entries and
    each block splits: the conv banks' channels, bank by bank."""

    axis: str | None = None
    dim: int = 0
    block: int | None = None

    def blocks(self, n: int, parts: int = 1) -> int:
        """Blocks in an axis of ``n`` entries, each holding 1/``parts`` of a block."""
        return 1 if self.block is None else n * parts // self.block


def shard_along(x, dim: int, index: int, parts: int, blocks: int = 1):
    """Block ``index`` of ``parts`` of ``x`` (a tensor or an array) along
    ``dim``, within each of ``blocks`` equal blocks of that axis."""
    n = x.shape[dim]
    if n % (blocks * parts):
        raise ValueError(f"axis {dim} of length {n} does not split into {blocks} x {parts}")
    step, part = n // blocks, n // (blocks * parts)
    if isinstance(x, torch.Tensor) and blocks == 1:
        return x.narrow(dim, index * part, part)
    idx = [b * step + index * part + j for b in range(blocks) for j in range(part)]
    if isinstance(x, torch.Tensor):
        return x.index_select(dim, torch.tensor(idx, device=x.device))
    return np.take(x, idx, axis=dim)


def unshard_along(pieces: list, dim: int, blocks: int = 1):
    """Inverse of `shard_along` over every index: the pieces in index order."""
    if blocks == 1:
        return torch.cat(pieces, dim)
    per_block = [p.chunk(blocks, dim) for p in pieces]
    return torch.cat([torch.cat([pb[b] for pb in per_block], dim) for b in range(blocks)], dim)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """``NamedSharding`` of the port: a mesh and a `Spec`."""

    mesh: Mesh | ProcessMesh
    spec: Spec = Spec()

    def shard(self, x):
        """A `ProcessMesh` rank's block of ``x`` (the whole of it when
        replicated); for a `Mesh`, one block per device, on that device."""
        s, mesh = self.spec, self.mesh
        if isinstance(mesh, ProcessMesh):
            if s.axis is None:
                return x
            return shard_along(x, s.dim, mesh.index(s.axis), mesh.axis_size(s.axis),
                               s.blocks(x.shape[s.dim]))
        devs = mesh.device_list()
        if s.axis is None:
            return [x.to(d, non_blocking=True) for d in devs]
        return [shard_along(x, s.dim, i, len(devs), s.blocks(x.shape[s.dim])).to(
            d, non_blocking=True) for i, d in enumerate(devs)]


def batch_sharding(mesh, ndim: int = 3) -> Sharding:
    """Axis 0 (the batch) split over 'data' (a `ProcessMesh`) or over the
    mesh's one axis (a `Mesh`: the stream rows); the rest replicated."""
    del ndim
    axis = "data" if isinstance(mesh, ProcessMesh) else mesh.axis_names[0]
    return Sharding(mesh, Spec(axis, 0))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, Spec())
