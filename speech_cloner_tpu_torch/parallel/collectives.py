"""The collectives of a data- and tensor-parallel train step.

GSPMD inserts these in the JAX package; here they are written out. Each
rank of a ('data', 'model') `ProcessMesh` holds the same loss: the model
ranks of one data row compute one copy of it between them, and the data
rows compute n_data copies whose gradients are averaged. So:

- `all_reduce_sum` (the global-batch BN moments, the loss over the global
  batch): the sum over a group in the forward; its adjoint, an all-reduce of
  the incoming gradients, in the backward.
- `copy_to_model` (Megatron's "f", the conv banks' input): the identity in
  the forward, an all-reduce over 'model' of the gradient in the backward
  (each model rank's banks see only their channels' share of it).
- `reduce_from_model` (Megatron's "g", after the projection that contracts
  the banks' channels): an all-reduce over 'model' in the forward, the
  identity in the backward.
- `average_gradients`: the parameters' gradients averaged over 'data', in
  one flat all-reduce.

A group of None (a mesh axis of size 1) makes each the identity, so an
unsharded model computes exactly what it did before.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def data_group(mesh):
    """The 'data' process group of ``mesh``, or None (no mesh, one data rank)."""
    return None if mesh is None or mesh.n_data == 1 else mesh.group("data")


def data_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """A per-rank mean over the global batch (equal rows on every data rank)."""
    g = data_group(mesh)
    return x if g is None else all_reduce_sum(x, g) / mesh.n_data


@torch.no_grad()
def average_gradients(grads: list[torch.Tensor], mesh) -> None:
    """Average ``grads`` over 'data', in place, as one flat all-reduce."""
    g = data_group(mesh)
    if g is None or not grads:
        return
    flat = torch.cat([t.reshape(-1) for t in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=g)
    flat /= mesh.n_data
    off = 0
    for t in grads:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` in the group's rank order (no gradient)."""
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return out
