"""A run with the timed path broken underneath reads ``correct`` false: for
each fault a cell can have, at a CPU size (the harness's look for a card
skipped), and the control on the card at the cells' widths."""

from __future__ import annotations

import copy

import pytest
import torch
from tiny import card, run_cell  # noqa: F401  (the fixture)

STATE = ("_gain", "_pending", "_mel_max", "_m0", "_tail", "_phase_tail", "_inv_state",
         "_out_ema", "_out_gain_prev", "_out_pending", "_g_sum", "_g_cnt", "_g_upto")


def half_batch(pipe) -> None:
    """The decoder computes the first half of its batch and gives the
    mean of those rows for the rest."""
    decoder = pipe._models[1]
    forward = decoder.forward

    def half(ppg, *args, **kwargs):
        n = max(ppg.shape[0] // 2, 1)
        outs = forward(ppg[:n], *args, **kwargs)
        return tuple(torch.cat([t, t.mean(0, keepdim=True).expand(ppg.shape[0] - n, *t.shape[1:])])
                     for t in outs)
    decoder.forward = half


def negate_quarter(x):
    x = x.copy()
    x[..., :x.shape[-1] // 4] *= -1
    return x


def offline_answer(pipe) -> None:
    convert = pipe.convert_pcm16
    object.__setattr__(pipe, "convert_pcm16", lambda wav, seed=0: negate_quarter(convert(wav, seed)))


def longform_answer(pipe) -> None:
    convert = pipe.convert_seq_parallel

    def altered(wav, **kwargs):
        y, mel, spec = convert(wav, **kwargs)
        return negate_quarter(y), mel, spec
    object.__setattr__(pipe, "convert_seq_parallel", altered)


def stream_state_unchanged(system) -> None:
    """Each step emits but hands on the carried state it found."""
    s = system.cloner
    step = s._step

    def frozen():
        saved = {k: copy.deepcopy(getattr(s, k)) for k in STATE}
        out = step()
        for k, v in saved.items():
            setattr(s, k, v)
        return out
    s._step = frozen


def stream_answer(system) -> None:
    push = system.push

    def altered(chunk):
        emit = push(chunk).copy()
        emit[0] *= -1
        return emit
    system.push = altered


FAULTS = [("offline60_f32", half_batch), ("offline60_f32", offline_answer),
          ("offline60_bf16", half_batch), ("offline60_bf16", offline_answer),
          ("longform_f32", longform_answer),
          ("stream16_f32", lambda s: half_batch(s.pipe)), ("stream16_f32", stream_answer),
          ("stream16_f32", stream_state_unchanged)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{getattr(f, '__name__', 'half_batch')}" for n, f in FAULTS])
def test_fault_reads_not_correct(name, fault):
    rc, res, err = run_cell(name, seconds=0.3, on_system=fault)
    assert rc == 0, err[-2000:]
    assert not res["correct"] and res["failed"] >= 1


def at_width(cell) -> None:
    """The configurations as shipped; shorter clips and fewer streams."""
    t = cell.traffic
    t.update(clip_seconds=6.0, pool=2, warmup=1, sample=1, sample_range=2)
    if t["driver"] == "stream":
        t.update(streams=4, clip_seconds=10.0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("offline60_f32", "offline60_bf16", "longform_f32",
                                  "stream16_f32"))
def test_control_fails_on_the_card(card, name):  # noqa: F811
    for seed in (2**33 + 11, 2**33 + 12, 2**33 + 13):
        rc, res, err = run_cell(name, seed=seed, seconds=1, control=1, alter=at_width,
                                device="cuda")
        assert rc == 0, err[-2000:]
        assert not res["correct"], res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{getattr(f, '__name__', 'half_batch')}" for n, f in FAULTS])
def test_fault_reads_not_correct_on_the_card(card, name, fault):  # noqa: F811
    rc, res, err = run_cell(name, seed=2**33 + 21, seconds=1, on_system=fault, alter=at_width,
                            device="cuda")
    assert rc == 0, err[-2000:]
    assert not res["correct"], [ln for ln in err.splitlines() if "readings" in ln]
