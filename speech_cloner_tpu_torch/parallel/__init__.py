"""Meshes, sharding and collectives (counterpart of speech_cloner_tpu/parallel).

Inference shards over a `Mesh` of devices in one process (``halo``,
``gl_sp``, the stream mesh); training runs one process per rank of a
`ProcessMesh` (``distributed``, ``sharding``, ``collectives``). The
sharding names load on first use: ``nn.modules`` imports the collectives,
and ``sharding`` reaches back to the models through ``runtime``.
"""

from .mesh import batch_sharding, make_mesh, make_seq_mesh, replicated

_SHARDING = ("param_shardings", "replicate_tree", "shard_params", "shard_state",
             "state_shardings")

__all__ = [
    "batch_sharding", "make_mesh", "make_seq_mesh", "param_shardings",
    "replicate_tree", "replicated", "shard_params", "shard_state",
    "state_shardings",
]


def __getattr__(name: str):
    if name in _SHARDING:
        from . import sharding
        return getattr(sharding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
