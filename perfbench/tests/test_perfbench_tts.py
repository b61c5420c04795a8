"""The two cells of the text-to-speech and short-clip paths: ``tts32_f32``
at a CPU size (a tiny Tacotron, three short sentences a batch) reads
``correct`` true, and false with each fault planted under its timed path
(the decoder, the attention's mask, the post-net, the vocoder's phase and
its round count);
on the card (marked ``gpu``) at the published widths the faults and the
control (TF32, which the CPU lacks) read false; ``offline_short_f32``'s
rate counts each clip's own seconds; the Tacotron work counts against
hand-worked values."""

from __future__ import annotations

import json
import math

import pytest
import torch
from tiny import PERFBENCH, card, run_cell, shrink  # noqa: F401  (the fixture)

from benchlib import cells
from benchlib import tacotron as bt

TACO = json.loads((PERFBENCH / "configs" / "tacotron_f32.json").read_text())


def shrink_tts(cell) -> None:
    """Small widths, three sentences of 0.3-0.6 s, a few Griffin-Lim rounds."""
    c, t = cell.config, cell.traffic
    c["model"].update(embed_size=16, prenet_size=16, encoder_banks=3, encoder_highway=1,
                      encoder_units=8, attention_rnn_units=16, attention_depth=8,
                      decoder_units=16, postnet_banks=2, postnet_units=8, postnet_highway=1,
                      postnet_projections=[16, 80])
    c["vocoder"]["n_iter"] = 3
    t.update(batch=3, pool=2, warmup=1, seconds_range=[0.3, 0.6], sample=1, sample_range=2,
             sample_rows=1, start_steps=4, profiled=1)


def shrink_short(cell) -> None:
    shrink(cell)
    cell.traffic.update(seconds_range=[0.5, 1.5])


def test_tts_line_is_correct():
    rc, res, err = run_cell("tts32_f32", alter=shrink_tts)
    assert rc == 0, err[-2000:]
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"mel", "start", "linear", "pcm_q90_med"}
    assert set(res["metrics"]) == {"longform_audio_s_per_s", "setup_s"}


def test_tts_traced_line_reads_the_program():
    rc, res, err = run_cell("tts32_f32", alter=shrink_tts, trace=1)
    assert rc == 0, err[-2000:]
    # on the CPU the program's spans have no device time: those metrics are left out
    assert {"banks_roofline.tts", "mfu.tts"} <= set(res["metrics"])
    assert not {"decode_ms.tts", "decode_step_us.tts", "vocode_ms.tts"} & set(res["metrics"])


def repeat_step(pipe) -> None:
    """Every fifth decoder step hands on the output of the step before."""
    frames = pipe.model.decoder.frames
    inner, seen = frames.forward, {"n": 0, "prev": None}

    def forward(x):
        y = inner(x)
        seen["n"] += 1
        if seen["n"] % 5 == 0 and seen["prev"] is not None and seen["prev"].shape == y.shape:
            y = seen["prev"]
        seen["prev"] = y
        return y
    frames.forward = forward


def unmasked(pipe) -> None:
    """The attention attends to the padded characters too."""
    att = pipe.model.decoder.attention
    inner = att.forward
    att.forward = lambda query, keys, memory, bias=None: inner(query, keys, memory, None)


def half_linear(pipe) -> None:
    """The second half of the batch's linear spectrogram is the first half's mean."""
    inner = pipe.model.postnet

    def postnet(mel, frame_lengths):
        y = inner(mel, frame_lengths)
        n = max(y.shape[0] // 2, 1)
        return torch.cat([y[:n], y[:n].mean(0, keepdim=True).expand(y.shape[0] - n,
                                                                     *y.shape[1:])])
    pipe.model.postnet = postnet


def rolled_phase(pipe) -> None:
    """Each sentence's Griffin-Lim starts from the next sentence's phase
    draw (cut to its own frames, zero past the other's)."""
    from speech_cloner_tpu_torch.pipeline.vocoder import row_phases

    inner = pipe.device_vocode_pcm16

    def device_vocode_pcm16(linear, frames, generator=None, init_phase=None):
        drawn = row_phases(frames, linear.shape[-1], generator, linear.device)
        moved = torch.zeros_like(drawn)
        for b, n in enumerate(frames):
            other = (b + 1) % len(frames)
            k = min(n, frames[other])
            moved[b, :k] = drawn[other, :k]
        return inner(linear, frames, init_phase=moved)
    object.__setattr__(pipe, "device_vocode_pcm16", device_vocode_pcm16)


def round_short(pipe) -> None:
    """Griffin-Lim runs one round fewer than the configuration's."""
    object.__setattr__(pipe, "n_iter", pipe.n_iter - 1)


FAULTS = [repeat_step, unmasked, half_linear, rolled_phase, round_short]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_tts_fault_reads_not_correct(fault):
    rc, res, err = run_cell("tts32_f32", alter=shrink_tts, on_system=fault)
    assert rc == 0, err[-2000:]
    assert not res["correct"] and res["failed"] >= 1, res["checks"]


def test_tts_control_runs_in_the_programs_place():
    """The control is the reference with TF32 products, which the CPU does
    not have: here it reads the reference's own numbers (its failing is the
    card test's below), and runs in the program's place end to end."""
    rc, res, err = run_cell("tts32_f32", alter=shrink_tts, control=1)
    assert rc == 0, err[-2000:]
    assert res["checks"]["mel"]["value"] == 0.0 and res["checks"]["linear"]["value"] == 0.0


def test_offline_short_counts_each_clips_seconds(monkeypatch):
    """The rate is the summed seconds of the clips the window converted (each
    its own length) over the window's seconds."""
    short = cells.load_driver("offline_short")
    cell = cells.load_cell("offline_short_f32")
    shrink_short(cell)
    done = 5
    monkeypatch.setattr(short, "timed_window",
                        lambda seconds, unit: ([unit(i) for i in range(done)], (done, 2.0))[1])
    from benchlib.driving import RunContext
    from benchlib.trace import Clock

    ctx = RunContext(seed=2**33 + 5, seconds=1.0, trace=False, control=False,
                     device=torch.device("cpu"), clock=Clock())
    res = short.run(cell, ctx)
    seconds = short.clip_seconds(cell.traffic, ctx.seed)
    n = len(seconds)
    # one clip in each of the pool's equal strata of the range
    assert sorted(int((s - 0.5) / 1.0 * n) for s in seconds) == list(range(n))
    want = sum(round(seconds[i % len(seconds)] * 16000) / 16000 for i in range(done)) / 2.0
    assert math.isclose(res.end_to_end["longform_audio_s_per_s"], want, rel_tol=1e-12)
    assert res.numbers.units >= 1


def test_offline_short_line_is_correct():
    rc, res, err = run_cell("offline_short_f32", alter=shrink_short)
    assert rc == 0, err[-2000:]
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"longform_audio_s_per_s", "setup_s"}


def test_offline_short_vocoder_fault_reads_not_correct(monkeypatch):
    """A vocoder that undoes a pre-emphasis of 0.96, not the configuration's
    0.97, fails the early-round PCM number (the model's numbers hold)."""
    import dataclasses

    from speech_cloner_tpu_torch.pipeline import vocoder

    inner = vocoder.device_vocode

    def device_vocode(P, feat, **kw):
        return inner(P, dataclasses.replace(feat, pre_emphasis=0.96), **kw)
    monkeypatch.setattr(vocoder, "device_vocode", device_vocode)
    rc, res, err = run_cell("offline_short_f32", alter=shrink_short)
    assert rc == 0, err[-2000:]
    checks = res["checks"]
    assert not res["correct"] and checks["pcm_r8_q90"]["value"] > checks["pcm_r8_q90"]["limit"]
    assert checks["stft"]["value"] <= checks["stft"]["limit"]


def test_tts_batches_hold_one_sentence_a_stratum():
    from scipy.special import betainc

    tts = cells.load_driver("tts")
    tr = cells.load_cell("tts32_f32").traffic
    lo, hi = tr["seconds_range"]
    for seed in (2**33 + 1, 2**33 + 2):
        b = tts.make_batch(tr, seed, 256)
        # each sentence's stratum, from its frames (rounding may move one across an edge)
        strata = [int(betainc(*tr["seconds_beta"], (f / tr["frames_per_second"] - lo) / (hi - lo))
                      * tr["batch"]) for f in b["frames"]]
        assert len(b["frames"]) == 32 and len(set(strata)) >= 30 and max(strata) <= 31
        assert 6.3 < b["seconds"] / 32 < 6.85
        assert (b["ids"] == 0).sum() == b["ids"].size - int(b["lengths"].sum())


def test_decoder_step_flops_by_hand():
    m = TACO["model"]
    f = bt.flops(TACO, [10], [4])
    step = (2 * (80 * 256 + 256 * 128) + 2 * (384 + 256) * 3 * 256 + 2 * 256 * 256
            + 2 * 512 * 256 + 2 * 2 * 512 * 3 * 256 + 2 * 256 * 160)
    assert f["decoder"] == 2 * 10 * 256 * 256 + 2 * (step + 10 * (2 * 256 + 2 * 256))
    enc = 2 * (256 * 256 + 256 * 128) + 2 * 128 * 128 * 136 + 2 * 3 * 2048 * 128 \
        + 2 * 3 * 128 * 128 + 4 * 4 * 128 * 128 + 24 * 128 * 128
    assert f["encoder"] == 10 * enc
    post = 2 * 80 * 128 * 36 + 2 * 3 * 1024 * 256 + 2 * 3 * 256 * 80 + 2 * 80 * 128 \
        + 4 * 4 * 128 * 128 + 24 * 128 * 128 + 4 * 128 * 1025
    assert f["postnet"] == 4 * post
    assert m["reduction"] == 2


def test_tacotron_trees_at_published_widths():
    params, state = bt.make_trees(TACO, 2**33 + 1, "cpu")
    assert params["embedding"]["lookup_table"].shape == (256, 256)
    assert len(params["encoder"]["CBHG"]["banks"]["kernels"]) == 16
    assert params["decoder"]["attention_rnn"]["gates_kernel"].shape == (640, 512)
    assert params["postnet"]["CBHG"]["pre_highway"]["kernel"].shape == (80, 128)
    assert params["postnet"]["CBHG"]["conv1d_1"]["kernel"].shape == (3, 1024, 256)
    assert params["postnet"]["linear"]["kernel"].shape == (256, 1025)
    assert state["postnet"]["CBHG"]["bn2"]["var"].shape == (80,)
    std = float(params["embedding"]["lookup_table"].std())
    assert abs(std - 0.5) < 0.01


def at_width(cell) -> None:
    """Tacotron as shipped; a small pool of batches of 8 sentences."""
    cell.traffic.update(batch=8, pool=2, warmup=1, sample=1, sample_range=2, sample_rows=1)


@pytest.mark.gpu
def test_tts_control_and_faults_fail_on_the_card(card):  # noqa: F811
    for seed in (2**33 + 31, 2**33 + 32):
        rc, res, err = run_cell("tts32_f32", seed=seed, seconds=1, control=1, alter=at_width,
                                device="cuda")
        assert rc == 0, err[-2000:]
        assert not res["correct"], res["checks"]
    # one round fewer reads 7.8e-3 to 2.1e-2 at these widths, inside the
    # program's own range at 50 rounds (up to 7.4e-3): it fails only at the
    # CPU size above, where it is one round of three
    for fault in [f for f in FAULTS if f is not round_short]:
        rc, res, err = run_cell("tts32_f32", seed=2**33 + 33, seconds=1, on_system=fault,
                                alter=at_width, device="cuda")
        assert rc == 0, err[-2000:]
        assert not res["correct"], (fault.__name__, res["checks"])
