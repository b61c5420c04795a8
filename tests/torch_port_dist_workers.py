"""Rank workers for tests/test_torch_port_distributed.py.

They run in processes that ``parallel.distributed.spawn_world`` starts, so
they live in a module that imports only torch, numpy and the port (a test
module would bring jax in through tests/conftest.py). Each returns numpy
results for the test to hold against the JAX package and against the
port's single-process step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from speech_cloner_tpu_torch.models import encoder as tenc
from speech_cloner_tpu_torch.parallel.distributed import (
    host_shard,
    initialize,
    per_host_batch,
)
from speech_cloner_tpu_torch.parallel.mesh import make_mesh
from speech_cloner_tpu_torch.parallel.sharding import (
    gather_tree,
    replicate_tree,
    shard_module,
    shard_params,
    shard_state,
)
from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer
from speech_cloner_tpu_torch.runtime.jax_params import decoder_from_jax, encoder_from_jax
from speech_cloner_tpu_torch.runtime.tree import tree_leaves, tree_map
from speech_cloner_tpu_torch.train import steps as tsteps
from speech_cloner_tpu_torch.train.optimizer import OptimizerConfig, make_train_state


def host(tree):
    """Tensors -> float32 numpy (a tree of dicts and lists)."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [host(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy().copy()


def step(kind: str, case: dict, mesh=None) -> dict:
    """One encoder or decoder train step from the case's trees and global
    batch; under ``mesh`` on this rank's rows of a sharded model. Returns
    the loss, the full gradients and BN state, and the new train state
    (gathered under a mesh)."""
    rows = slice(None)
    if mesh is not None and mesh.n_data > 1:
        b = case["batch"][0].shape[0] // mesh.n_data
        rows = slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)
    batch = [a[rows] for a in case["batch"]]
    opt_cfg = OptimizerConfig()
    if kind == "encoder":
        model = encoder_from_jax(*case["tree"], tenc.EncoderConfig(**case["cfg"]))
    else:
        model = decoder_from_jax(*case["tree"], case["cfg"])
    local_shapes = None
    slices_match = None
    if mesh is not None:
        shard_module(model, mesh)
        # the module's slices are shard_params / shard_state of the full trees
        slices_match = all(tree_leaves(tree_map(
            lambda a, b: np.array_equal(a.detach().numpy(), np.asarray(b)),
            (model.params_tree(), model.state_tree()),
            (shard_params(case["tree"][0], mesh), shard_state(case["tree"][1], mesh)))))
        local_shapes = [tuple(k.shape) for k in model.params_tree()["CBHG"]["banks"]["kernels"]] \
            if kind == "encoder" else \
            [tuple(k.shape) for k in model.params_tree()["step2"]["CBHG"]["banks"]["kernels"]]
    ts = {**make_train_state(model, opt_cfg, 1), "epoch": np.int32(case.get("epoch", 0))}
    if kind == "encoder":
        ts2, m = tsteps.encoder_train_step(ts, *batch, model=model, opt_cfg=opt_cfg,
                                           opt=opt_cfg.make())
    else:
        encoder = encoder_from_jax(*case["enc_tree"], tenc.EncoderConfig(**case["enc_cfg"]))
        ts2, m = tsteps.decoder_train_step(ts, *batch, encoder=encoder, model=model,
                                           loss_cfg=tsteps.DecoderLossConfig(**case["loss"]),
                                           opt_cfg=opt_cfg, opt=opt_cfg.make())
    grad_tree = _grad_tree(model)
    state = model.state_tree()
    if mesh is not None:
        grad_tree = gather_tree(grad_tree, mesh, "params")
        state = gather_tree(state, mesh, "state")
        if case.get("ckpt"):
            ckpt = Checkpointer(case["ckpt"], kind, mesh=mesh)
            ckpt.save(ts2, step=1)
            # resume: a fresh sharded model's train state takes its slices back
            fresh = encoder_from_jax(*case["tree"], tenc.EncoderConfig(**case["cfg"]))
            shard_module(fresh, mesh)
            back, _ = ckpt.restore_into(make_train_state(fresh, opt_cfg, 1))
            restored_gap = max(float(np.abs(np.asarray(a.detach() if hasattr(a, "detach") else a,
                                                       np.float64)
                                            - np.asarray(b.detach() if hasattr(b, "detach") else b,
                                                         np.float64)).max())
                               for a, b in zip(tree_leaves(back), tree_leaves(ts2)))
    elif case.get("ckpt"):
        Checkpointer(case["ckpt"], kind).save(ts2, step=1)
    return {"loss": float(m["loss"]), "grads": host(grad_tree), "state": host(state),
            "local_shapes": local_shapes, "slices_match": slices_match,
            "restored_gap": restored_gap if mesh is not None and case.get("ckpt") else None,
            "metrics": {k: float(v) for k, v in m.items()}}


def _grad_tree(model):
    return tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
                    model.params_tree())


def world_cases(rank: int, world: int, cases: dict) -> dict:
    """Every case in one 2 x 2 world (data=2, model=2): the bootstrap
    helpers, then each train step."""
    out = {"initialize": initialize(), "host_shard": host_shard(np.arange(10)).tolist(),
           "per_host_batch": per_host_batch(8), "rank": dist.get_rank()}
    try:
        per_host_batch(6)
        out["per_host_batch_6"] = "no error"
    except AssertionError:
        out["per_host_batch_6"] = "AssertionError"
    mesh = make_mesh(2, 2)
    out["coords"] = (mesh.index("data"), mesh.index("model"))
    out["replicated"] = replicate_tree({"a": np.arange(3.0) * (rank + 1)}, mesh)["a"].tolist()
    for name, (kind, case) in cases.items():
        out[name] = step(kind, case, mesh)
    return out
