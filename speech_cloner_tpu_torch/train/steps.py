"""Train and eval steps of the encoder, the decoder and the speaker-ID CNN.

Counterpart of ``speech_cloner_tpu/train/steps.py``: the same losses,
metrics and optimizer step on the train state of ``train/optimizer.py``. A
step runs eagerly: forward in train mode (dropout masks from a generator
seeded by the state's key, BN statistics moved in place), ``loss.backward()``
(through the GRU scan's backward kernel on the card), Adam. Gradients stay
in the parameters' ``.grad`` after the step. Batches are numpy arrays or
tensors; they go to the model's device. Metrics are 0-d tensors (read at the
log cadence).

``compute_dtype=torch.bfloat16`` is the JAX ``_cast_floats`` mixed
precision: the cast happens inside the differentiated function
(`forward_in`: ``torch.func.functional_call`` over each parameter's bf16
copy), so the forward and backward run in bf16 (the GRU scans through the
bf16 training forward and the bf16 backward kernel) while autograd's
cast-back delivers float32 gradients to the float32 master parameters.
Adam's state, the BN running statistics (moved in float32 from float32
batch moments), the losses and the softmax stay float32. Not
``torch.autocast``: it keeps other ops in float32 than JAX does.

Data and tensor parallel (a model made a rank's part of a ('data', 'model')
mesh by ``parallel.sharding.shard_module``; the step finds the mesh at
``model.mesh``): each rank gets its rows of the global batch. The losses
and metrics are the global batch's means (an all-reduce over 'data' whose
backward is its adjoint), the BN moments are the global batch's and the
dropout masks the global batch's (``nn.modules``), and the gradients are
averaged over 'data' before Adam, so a step computes what the
single-process step computes on the whole batch, as GSPMD gives JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel.collectives import average_gradients, data_mean
from ..runtime.tree import tree_leaves, tree_map
from .metrics import frame_accuracy, probs_mse, softmax_xent, weighted_mse
from .optimizer import Adam, OptimizerConfig, apply_updates, split_key

_GENERATORS: dict[torch.device, torch.Generator] = {}


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _on(x, model) -> torch.Tensor:
    """A batch array on the model's device, in its parameters' dtype."""
    p = next(model.parameters())
    return torch.as_tensor(x, dtype=p.dtype, device=p.device)


def _cast(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


def forward_in(model, compute_dtype: torch.dtype | None, *args, **kwargs):
    """``model(*args, **kwargs)`` with every floating parameter cast to
    ``compute_dtype`` inside the call (None: as it is). The casts are part of
    the autograd graph, so gradients reach the parameters in their own
    dtype; buffers (the BN running statistics) are the module's own."""
    if compute_dtype is None:
        return model(*args, **kwargs)
    params = {n: p.to(compute_dtype) if p.is_floating_point() else p
              for n, p in model.named_parameters()}
    return torch.func.functional_call(model, params, args, kwargs)


def _round_to(x: float, dtype: torch.dtype | None) -> float:
    """A Python scalar as ``dtype`` holds it (JAX casts the f_mel mix)."""
    return x if dtype is None else float(torch.tensor(x, dtype=dtype))


def step_generator(ts: dict, device) -> tuple[np.ndarray, torch.Generator]:
    """(next key, this step's dropout generator on ``device``), from ts["rng"]."""
    key, seed = split_key(ts["rng"])
    device = torch.device(device)
    gen = _GENERATORS.get(device)
    if gen is None:
        gen = _GENERATORS[device] = torch.Generator(device)
    return key, gen.manual_seed(seed)


def _zero_grads(ts: dict) -> None:
    for p in tree_leaves(ts["params"]):
        p.grad = None


def _grads(ts: dict, mesh=None):
    """The parameters' gradients (zeros where None), averaged over 'data'
    under a mesh."""
    grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, ts["params"])
    average_gradients(tree_leaves(grads), mesh)
    return grads


def _mesh(model):
    return getattr(model, "mesh", None)


# ---------------------------------------------------------------- encoder ---

def encoder_train_step(ts: dict, mfcc, phn, *, model, opt_cfg: OptimizerConfig, opt: Adam,
                       compute_dtype: torch.dtype | None = None):
    """One step: xent loss on [B,T,61] soft targets + Adam + BN update;
    ``compute_dtype`` (bf16) runs the model's forward and backward in it.
    Returns (new ts, metrics)."""
    x, y = _on(mfcc, model), _on(phn, model)
    mesh = _mesh(model)
    key, gen = step_generator(ts, _device(model))
    _zero_grads(ts)
    logits = _wide(forward_in(model, compute_dtype, _cast(x, compute_dtype), train=True,
                              generator=gen))
    loss = data_mean(softmax_xent(logits, y), mesh)
    loss.backward()
    new_ts, lr = apply_updates({**ts, "rng": key}, _grads(ts, mesh), opt_cfg, opt)
    logits = logits.detach()
    return new_ts, {"loss": loss.detach(), "acc": data_mean(frame_accuracy(logits, y), mesh),
                    "mse": data_mean(probs_mse(logits, y), mesh), "lr": float(lr)}


@torch.no_grad()
def encoder_eval_step(model, mfcc, phn) -> dict:
    x, y = _on(mfcc, model), _on(phn, model)
    mesh = _mesh(model)
    logits = _wide(model(x))
    return {"loss": data_mean(softmax_xent(logits, y), mesh),
            "acc": data_mean(frame_accuracy(logits, y), mesh),
            "mse": data_mean(probs_mse(logits, y), mesh)}


# ---------------------------------------------------------------- decoder ---

@dataclasses.dataclass(frozen=True)
class DecoderLossConfig:
    mel_loss_weight: float = 400.0
    stft_loss_weight: float = 400.0
    loss_type: str = "sum"  # 'sum' | 'log'


def f_mel_schedule(epoch, target_mel_step2_val: float) -> np.float32:
    """f = min(1, 1.02*tanh(epoch / val)), in float32."""
    f = np.float32
    return np.minimum(f(1.0), f(1.02) * np.tanh(f(epoch) / f(target_mel_step2_val)))


def _decoder_loss(y_mel, y_stft, target_mel, target_stft, loss_cfg: DecoderLossConfig,
                  mesh=None):
    mel_loss = data_mean(weighted_mse(y_mel, target_mel, loss_cfg.mel_loss_weight), mesh)
    stft_loss = data_mean(weighted_mse(y_stft, target_stft, loss_cfg.stft_loss_weight), mesh)
    if loss_cfg.loss_type == "log":
        return torch.log(mel_loss) + torch.log(stft_loss), mel_loss, stft_loss
    return mel_loss + stft_loss, mel_loss, stft_loss


def _wide(t: torch.Tensor) -> torch.Tensor:
    """At least float32 (losses and softmax are never taken in bf16)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


@torch.no_grad()
def encoder_ppg(encoder, mfcc, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The frozen encoder's posteriors in eval mode (run in ``compute_dtype``
    when given), softmax in at least float32, no gradient."""
    x = _cast(_on(mfcc, encoder), compute_dtype)
    return torch.softmax(_wide(forward_in(encoder, compute_dtype, x)), dim=-1)


def decoder_train_step(ts: dict, mfcc, target_mel, target_stft, *, encoder, model,
                       loss_cfg: DecoderLossConfig, opt_cfg: OptimizerConfig, opt: Adam,
                       compute_dtype: torch.dtype | None = None):
    """One decoder step with the frozen ``encoder`` (eval mode, no gradient)
    producing the PPG inputs; step2's input mixes in ``target_mel`` by the
    f_mel schedule of the state's epoch. ``compute_dtype`` (bf16) runs the
    frozen encoder and the decoder's forward and backward in it, with the
    PPG, ``target_mel`` and the f_mel scalar cast as JAX casts them; the
    losses take the float32 targets. Returns (new ts, metrics)."""
    ppg = _on(encoder_ppg(encoder, mfcc, compute_dtype), model)
    mel, stft = _on(target_mel, model), _on(target_stft, model)
    mesh = _mesh(model)
    key, gen = step_generator(ts, _device(model))
    f_mel = f_mel_schedule(ts["epoch"], model.cfg.target_mel_step2_val)
    _zero_grads(ts)
    y_mel, y_stft = forward_in(model, compute_dtype, _cast(ppg, compute_dtype), train=True,
                               generator=gen, target_mel=_cast(mel, compute_dtype),
                               f_mel_pred=_round_to(float(f_mel), compute_dtype))
    loss, mel_loss, stft_loss = _decoder_loss(_wide(y_mel), _wide(y_stft), mel, stft, loss_cfg,
                                              mesh)
    loss.backward()
    new_ts, lr = apply_updates({**ts, "rng": key}, _grads(ts, mesh), opt_cfg, opt)
    return new_ts, {"loss": loss.detach(), "mel_loss": mel_loss.detach(),
                    "stft_loss": stft_loss.detach(), "lr": float(lr), "f_mel_pred": float(f_mel)}


@torch.no_grad()
def decoder_eval_step(model, mfcc, target_mel, target_stft, *, encoder,
                      loss_cfg: DecoderLossConfig) -> dict:
    y_mel, y_stft = model(_on(encoder_ppg(encoder, mfcc), model))
    loss, mel_loss, stft_loss = _decoder_loss(_wide(y_mel), _wide(y_stft), _on(target_mel, model),
                                              _on(target_stft, model), loss_cfg, _mesh(model))
    return {"loss": loss, "mel_loss": mel_loss, "stft_loss": stft_loss}


# ------------------------------------------------------------- speaker-id ---

def _class_accuracy(logits: torch.Tensor, class_oh: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == class_oh.argmax(-1)).to(torch.float32).mean()


def speaker_train_step(ts: dict, power_dB, class_oh, *, model, opt_cfg: OptimizerConfig,
                       opt: Adam, compute_dtype: torch.dtype | None = None):
    """One verifier CNN step: xent on [B, n_spk] one-hot classes + Adam + BN
    update; ``compute_dtype`` (bf16) runs the convolutions and dense layers
    in it. Returns (new ts, metrics)."""
    x, y = _on(power_dB, model), _on(class_oh, model)
    key, _ = split_key(ts["rng"])
    _zero_grads(ts)
    logits = _wide(forward_in(model, compute_dtype, _cast(x, compute_dtype), train=True))
    loss = softmax_xent(logits, y)
    loss.backward()
    new_ts, lr = apply_updates({**ts, "rng": key}, _grads(ts), opt_cfg, opt)
    return new_ts, {"loss": loss.detach(), "acc": _class_accuracy(logits.detach(), y),
                    "lr": float(lr)}


@torch.no_grad()
def speaker_eval_step(model, power_dB, class_oh) -> dict:
    y = _on(class_oh, model)
    logits = _wide(model(_on(power_dB, model)))
    return {"loss": softmax_xent(logits, y), "acc": _class_accuracy(logits, y)}
