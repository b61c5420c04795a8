"""Parameter sharding rules: tensor parallelism of the conv banks over 'model'.

Counterpart of ``speech_cloner_tpu/parallel/sharding.py``, with its three
path rules over the JAX-layout trees (the encoder, both decoder steps, any
CBHG-shaped stack):

- the bank kernels' output channels are sharded over 'model';
- the banks' BN vectors (parameters and running statistics) are sharded
  over 'model';
- ``conv1d_1``'s input channels are sharded over 'model';

everything else is replicated. GSPMD may lay those three out as it likes
and reshards between them; here the three must hold the same channels, so a
model rank m of M keeps channels k*c + [m*c/M, (m+1)*c/M) of every bank k
(c = BANK_EMBED / 2 channels a bank): its slice of each bank kernel, and
the same channels of the BN vectors and of ``conv1d_1``'s input axis
(`Spec` with ``block`` = c). Its banks then compute their channels, and ``conv1d_1``
contracts them into a partial sum that an all-reduce over 'model' completes
(``nn.modules.CBHG``).

`param_shardings` / `state_shardings` give the `Sharding` of each leaf;
`shard_params` / `shard_state` cut a rank's slices out of full trees;
`gather_tree` puts full trees back together on every rank of a model group
(for a checkpoint); `replicate_tree` puts every leaf on the rank's device,
rank 0's values on every rank; `shard_module` turns a built model into its
rank's part of a DP + TP mesh, in place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..nn.modules import BANK_EMBED
from ..runtime.tree import tree_map
from .collectives import all_gather
from .mesh import ProcessMesh, Sharding, Spec, unshard_along


BANK = BANK_EMBED // 2   # channels a bank


def _spec_for_path(path: tuple[str, ...], leaf) -> Spec:
    shape = leaf.shape
    if "banks" in path and "kernels" in path and len(shape) == 3:
        return Spec("model", 2)                           # bank out-channels
    if "banks" in path and "bn" in path and len(shape) == 1:
        return Spec("model", 0, BANK)                     # per-channel BN, bank channels
    if "conv1d_1" in path and "kernel" in path and len(shape) == 3:
        return Spec("model", 1, BANK)                     # contraction over bank channels
    return Spec()


def _state_rule(path, leaf) -> Spec:
    return Spec("model", 0, BANK) if "banks" in path and len(leaf.shape) == 1 else Spec()


def _walk_specs(tree, rule, path=()):
    if isinstance(tree, dict):
        return {k: _walk_specs(v, rule, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk_specs(v, rule, path + (str(i),)) for i, v in enumerate(tree))
    return rule(path, tree)


def param_shardings(params, mesh: ProcessMesh):
    """Tree of `Sharding`s matching ``params``."""
    return tree_map(lambda s: Sharding(mesh, s), _walk_specs(params, _spec_for_path))


def state_shardings(state, mesh: ProcessMesh):
    """Model state (BN statistics): the banks' shard with their channels."""
    return tree_map(lambda s: Sharding(mesh, s), _walk_specs(state, _state_rule))


def shard_params(params, mesh: ProcessMesh):
    """This rank's slices of a full params tree (tensors or arrays)."""
    return tree_map(lambda x, sh: sh.shard(x), params, param_shardings(params, mesh))


def shard_state(state, mesh: ProcessMesh):
    return tree_map(lambda x, sh: sh.shard(x), state, state_shardings(state, mesh))


def replicate_tree(tree, mesh: ProcessMesh):
    """Every leaf as a tensor on the rank's device, holding rank 0's values."""
    def put(x):
        t = torch.as_tensor(x).to(mesh.device).contiguous()
        if dist.is_initialized() and mesh.size > 1:
            dist.broadcast(t, src=0)
        return t
    return tree_map(put, tree)


def _gather_leaf(x, sh: Sharding):
    s, mesh = sh.spec, sh.mesh
    if s.axis is None or mesh.axis_size(s.axis) == 1:
        return x
    parts = mesh.axis_size(s.axis)
    return unshard_along(all_gather(x.detach(), mesh.group(s.axis)), s.dim,
                         s.blocks(x.shape[s.dim], parts))


def gather_tree(tree, mesh: ProcessMesh, kind: str = "train_state"):
    """Full tensors from this model group's slices, on every rank of it.
    ``kind``: "params", "state", or "train_state" ({"params", "model_state",
    "opt_state": (count, mu, nu), ...}, the optimizer's moments sharded like
    the params)."""
    return tree_map(_gather_leaf, tree, tree_shardings(tree, mesh, kind))


def shard_tree(tree, mesh: ProcessMesh, kind: str = "train_state"):
    """This rank's slices of a full tree (the inverse of `gather_tree`)."""
    return tree_map(lambda x, sh: sh.shard(x), tree, tree_shardings(tree, mesh, kind))


def tree_shardings(tree, mesh: ProcessMesh, kind: str):
    if kind == "params":
        return param_shardings(tree, mesh)
    if kind == "state":
        return state_shardings(tree, mesh)
    out = tree_map(lambda _: Sharding(mesh), tree)
    if "params" in tree:
        out["params"] = param_shardings(tree["params"], mesh)
    if "model_state" in tree:
        out["model_state"] = state_shardings(tree["model_state"], mesh)
    if "opt_state" in tree:
        count, mu, nu = tree["opt_state"]
        out["opt_state"] = type(tree["opt_state"])(
            (Sharding(mesh), param_shardings(mu, mesh), param_shardings(nu, mesh)))
    return out


# ------------------------------------------------------------------- modules ---

def _set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    setattr(module, name, nn.Parameter(value.detach().clone()))


@torch.no_grad()
def shard_module(model: nn.Module, mesh: ProcessMesh) -> nn.Module:
    """Make ``model`` (an `Encoder` or `Decoder`, built from full trees, the
    same on every rank) this rank's part of ``mesh``, in place: every CBHG
    keeps its rank's bank channels and all-reduces over 'model' (when
    n_model > 1), every train-mode BN takes its moments over the global
    batch and every dropout draws the global batch's mask and keeps this
    rank's rows (when n_data > 1). The train steps find the mesh at
    ``model.mesh``. Returns ``model``."""
    from ..nn.modules import CBHG, BatchNorm, Prenet

    data = None if mesh.n_data == 1 else mesh.group("data")
    for mod in list(model.modules()):
        if isinstance(mod, CBHG) and mesh.axis_size("model") > 1:
            # the path rules above cut the slices
            p = shard_params(mod.params_tree(), mesh)
            st = shard_state(mod.state_tree(), mesh)["banks"]["bn"]
            banks = mod.banks
            banks.kernels = nn.ParameterList(nn.Parameter(k.detach().clone())
                                             for k in p["banks"]["kernels"])
            for name in ("gamma", "beta"):
                _set_param(banks.bn, name, p["banks"]["bn"][name])
            for name in ("mean", "var"):
                setattr(banks.bn, name, st[name].clone())
            _set_param(mod.conv1d_1, "kernel", p["conv1d_1"]["kernel"])
            mod.tp_group = mesh.group("model")
        elif isinstance(mod, BatchNorm):
            mod.data_group = data
        elif isinstance(mod, Prenet) and data is not None:
            mod.rows = (mesh.index("data"), mesh.n_data)
    model.mesh = mesh
    return model
