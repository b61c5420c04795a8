"""Sequence-parallel (SP) long-form inference: the time axis sharded over a
1-D `Mesh` with halo exchange.

Counterpart of ``speech_cloner_tpu/parallel/halo.py``. A sharded tensor is a
list of shards [B, T_loc, C], shard i on the mesh's device i (what JAX's
``shard_map`` hands each device). Where JAX ``ppermute``s a slice to a mesh
neighbor, the port copies it to the neighbor's device
(``tensor.to(device, non_blocking=True)``; nothing when both shards share a
device). So:

- convolutions take (width-1) halo frames from their neighbors, zeros at the
  global edges, and every output equals the unsharded TF-'same' conv; the
  banks run on those padded rows with no padding of their own
  (`Conv1dBanks.conv`, the bank kernel in float32 on the card);
- the bidirectional GRU warms up over ``warmup`` frames received from each
  neighbor before its local chunk; the first shard's forward scan and the
  last shard's backward scan over their first / last ``warmup`` frames are
  recomputed from h = 0 and spliced in, as the unsharded scan starts there
  (without that the PPG is off by up to 0.77 in the first ~20 frames at any
  warmup). On a CUDA tensor each scan is the hand-written kernel
  (``ops.cuda_kernels.gru_scan``), at T = T_loc + warmup and B = the batch;
  the edge scans at T = warmup.

Weights: each function takes the module (or its per-shard replicas,
`replicate_module`); BN runs in inference mode. ``fused_gru`` configs scan
each direction apart here, as the JAX functions do. A CBHG with an LSTM
(``use_lstm``) is refused, where the JAX functions fail on its weights.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F

from ..nn.modules import GRU
from ..ops.cuda_kernels import gru_dir_apply
from .mesh import Mesh, Sharding, Spec, canonical


def _recv(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.device, non_blocking=True)


def halo_pad(xs: list[torch.Tensor], left: int, right: int,
             fill: float = 0.0) -> list[torch.Tensor]:
    """Shards [B, T_loc, C] -> [B, left + T_loc + right, C] with the
    neighbors' frames (``fill`` at the global edges: zeros, matching 'same'
    zero padding)."""
    n = len(xs)
    out = []
    for i, x in enumerate(xs):
        if max(left, right) > x.shape[1]:
            raise ValueError(f"halo of {max(left, right)} frames exceeds the shard's "
                             f"{x.shape[1]}")
        parts = [x]
        if left > 0:
            parts.insert(0, _recv(xs[i - 1][:, -left:], x) if i > 0
                         else x.new_full((x.shape[0], left, x.shape[2]), fill))
        if right > 0:
            parts.append(_recv(xs[i + 1][:, :right], x) if i < n - 1
                         else x.new_full((x.shape[0], right, x.shape[2]), fill))
        out.append(torch.cat(parts, dim=1))
    return out


def _per_shard(w, xs: list[torch.Tensor]) -> list:
    """One tensor per shard: ``w`` as given per shard, or one tensor placed
    on each shard's device."""
    return list(w) if isinstance(w, (list, tuple)) else [w.to(x.device) for x in xs]


def conv1d_halo(weight, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """TF-'same' conv over the sharded time axis, exact at shard seams.
    ``weight``: the torch layout [O, I, W] (one tensor, or one per shard)."""
    ws = _per_shard(weight, xs)
    k = ws[0].shape[-1]
    return [F.conv1d(xp.transpose(1, 2), w).transpose(1, 2)
            for xp, w in zip(halo_pad(xs, (k - 1) // 2, k // 2), ws)]


def maxpool1d_same_halo(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """pool 2 / stride 1 / 'same' with a 1-frame right halo (-inf past the
    global end, which the pool ignores)."""
    return [torch.maximum(xp[:, :-1], xp[:, 1:]) for xp in halo_pad(xs, 0, 1, -math.inf)]


def _scan(gru, d: str, x: torch.Tensor) -> torch.Tensor:
    return gru_dir_apply(gru.dirs[d], x, gru.packed(d) if x.device.type == "cuda" else None)


def bigru_warmup(gru, xs: list[torch.Tensor], warmup: int) -> list[torch.Tensor]:
    """Bidirectional GRU (an ``nn.modules.GRU``, or one per shard) over the
    sharded time axis with neighbor warmup: each shard scans [warmup from
    the left + local] forward and [local + warmup from the right] backward
    and keeps its local outputs; the global edges are exact."""
    grus = _per_module(gru, xs)
    if not all(isinstance(g, GRU) for g in grus):
        # the JAX bigru_warmup scans GRU weights only, and fails on an LSTM's
        raise ValueError("sequence-parallel conversion scans a CBHG's GRU; this model's "
                         "CBHG holds an LSTM (use_lstm), which the JAX package's "
                         "bigru_warmup does not run either")
    T_loc = xs[0].shape[1]
    if warmup > T_loc:
        raise ValueError(f"warmup {warmup} exceeds local shard length {T_loc}; "
                         "use fewer 'seq' shards or a shorter warmup")
    n = len(xs)
    out = []
    for i, (g, x, xw) in enumerate(zip(grus, xs, halo_pad(xs, warmup, warmup))):
        fw = _scan(g, "fw", xw[:, :warmup + T_loc])[:, warmup:]
        bw = _scan(g, "bw", xw[:, warmup:].flip(1)).flip(1)[:, :T_loc]
        if warmup > 0 and i == 0:        # the exact h = 0 head
            fw = torch.cat([_scan(g, "fw", x[:, :warmup]), fw[:, warmup:]], dim=1)
        if warmup > 0 and i == n - 1:    # the exact h = 0 tail
            bw = torch.cat([bw[:, :T_loc - warmup],
                            _scan(g, "bw", x[:, -warmup:].flip(1)).flip(1)], dim=1)
        out.append(torch.cat([fw, bw], dim=2))
    return out


def _per_module(module, xs) -> list:
    return list(module) if isinstance(module, (list, tuple)) else [module] * len(xs)


def cbhg_seq_parallel(cbhg, xs: list[torch.Tensor], *, warmup: int) -> list[torch.Tensor]:
    """Inference-mode CBHG (``nn.modules.CBHG``, or one per shard) with the
    time axis sharded."""
    cs = _per_module(cbhg, xs)
    ws = [c.banks.weight() for c in cs]
    K = len(ws[0])
    h = [c.banks.conv(xp, w, pad=(0, 0))
         for c, w, xp in zip(cs, ws, halo_pad(xs, (K - 1) // 2, K // 2))]
    h = [torch.relu(c.banks.bn(t)) for c, t in zip(cs, h)]
    h = maxpool1d_same_halo(h)
    h = conv1d_halo([c.conv1d_1.weight() for c in cs], h)
    h = [torch.relu(c.bn1(t)) for c, t in zip(cs, h)]
    h = conv1d_halo([c.conv1d_2.weight() for c in cs], h)
    h = [c.bn2(t) + x for c, t, x in zip(cs, h, xs)]
    for j in range(len(cs[0].highway)):
        h = [c.highway[j](t) for c, t in zip(cs, h)]
    return bigru_warmup([c.gru for c in cs], h, warmup)


def _stack_local(stacks: list, xs: list[torch.Tensor], warmup: int) -> list[torch.Tensor]:
    """prenet + CBHG + output dense (an `Encoder` or a decoder step, one per
    shard), time axis sharded, inference mode."""
    h = [s.prenet(x) for s, x in zip(stacks, xs)]
    h = cbhg_seq_parallel([s.cbhg for s in stacks], h, warmup=warmup)
    return [s.y_logits(t) for s, t in zip(stacks, h)]


def replicate_module(module: torch.nn.Module, mesh: Mesh) -> list:
    """The module once per shard: itself on its own device, one copy on each
    other device of the mesh (shards on one device share it)."""
    copies = {canonical(next(module.parameters()).device): module}
    out = []
    for d in map(canonical, mesh.device_list()):
        if d not in copies:
            copies[d] = copy.deepcopy(module).to(d)
        out.append(copies[d])
    return out


def shard_time(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """[B, T, C] -> one [B, T / n, C] shard per mesh device; T must divide."""
    if x.shape[1] % mesh.size:
        raise ValueError(f"frame count {x.shape[1]} must divide by the mesh size {mesh.size}")
    return Sharding(mesh, Spec(mesh.axis_names[0], 1)).shard(x)


def gather(shards: list[torch.Tensor], dim: int = 1, device=None) -> torch.Tensor:
    """The shards joined along ``dim`` on ``device`` (default: the first shard's)."""
    device = shards[0].device if device is None else device
    return torch.cat([s.to(device) for s in shards], dim=dim)


def encoder_seq_parallel(encoder, mesh: Mesh, *, warmup: int = 400, replicas=None):
    """fn(mfcc [B, T, E]) -> logits shards [B, T / n, n_out] for the `Encoder`,
    T sharded over the mesh (T must divide by its size). ``replicas``: the
    encoder once per shard (default `replicate_module`)."""
    encs = replicas or replicate_module(encoder, mesh)

    @torch.inference_mode()
    def fn(x: torch.Tensor) -> list[torch.Tensor]:
        return _stack_local(encs, shard_time(x, mesh), warmup)
    return fn


def clone_forward_seq_parallel(encoder, decoder, mesh: Mesh, *, warmup: int = 400,
                               replicas=None):
    """Sequence-parallel clone forward: fn(MFCC [B, T, E]) -> (y_mel, y_stft,
    ppg), each a list of shards with time sharded across the mesh: one pass
    over the whole recording, no 400-frame windows and no stitching, exact
    conv halos and warmup-converged GRU states at the seams. ``replicas``:
    ([encoder per shard], [decoder per shard]), default `replicate_module`."""
    encs, decs = replicas or (replicate_module(encoder, mesh), replicate_module(decoder, mesh))

    @torch.inference_mode()
    def fn(x: torch.Tensor):
        logits = _stack_local(encs, shard_time(x, mesh), warmup)
        ppg = [torch.softmax(t.to(torch.float32), dim=-1) for t in logits]
        y_mel = _stack_local([d.step1 for d in decs], ppg, warmup)
        y_stft = _stack_local([d.step2 for d in decs], y_mel, warmup)
        return y_mel, y_stft, ppg
    return fn
