"""Tacotron on the port (``models/tacotron.py``, ``pipeline/tts.py``) against
the benchmark's plain reference (``perfbench/reference/tacotron.py``, the
file the benchmark's check runs), on the CPU at small widths with seeded
weights and batch-norm statistics drawn at random.

Tolerances, as a share of the reference's peak magnitude: 1e-5 where both
sides run the same function in float32 and differ only in the order of
their sums (the encoder, the post-net, the vocoder from one spectrogram);
1e-4 for the free-running decoder, whose few steps feed each step's output
back through the pre-net, so a sum's last bit at one step reaches the
next. A bf16 decoder (1e-2 and more) and a pad the attention does not mask
(a row's context mixed with padded memory) each fail one of them, as two
tests show. Rows of a ragged batch against the same row alone: 1e-6, and
so is the decoder on its memory padded with zeros to the captured step's
positions (`models.tacotron.graph_positions`), against the memory as it was.

Tests marked ``gpu`` run the bank kernel at Tacotron's widths (C = 128,
K = 16 in the encoder, C = 80, K = 8 in the post-net) and the CBHG's
per-row lengths around the scan kernel at H = 128, against the CPU, and
the decoder's captured step replayed (`TacotronDecoder.replay`) against its
plain loop on the card: the same bits where the memory needs no padding,
1e-6 of the peak where it does, and the ragged vocoder's rows of a batch
of 32 against each row alone (1e-4: cuFFT rounds differently at the two
batch sizes). They import no JAX, so the card runs them with
``--noconftest``.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech_cloner_tpu_torch.models import tacotron as taco
from speech_cloner_tpu_torch.nn import attention as TA
from speech_cloner_tpu_torch.nn import modules as TM
from speech_cloner_tpu_torch.ops import cuda_kernels as TK
from speech_cloner_tpu_torch.ops.griffin_lim import from_power_to_wav
from speech_cloner_tpu_torch.pipeline import vocoder
from speech_cloner_tpu_torch.pipeline.tts import (SynthesisPipeline, make_synthesis_pipeline,
                                                  min_frames, pad_ids, text_ids)
from speech_cloner_tpu_torch.runtime import profiler
from speech_cloner_tpu_torch.runtime.config import float32_products, tacotron_config_from_cfg_d

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "perfbench") not in sys.path:
    sys.path.insert(0, str(ROOT / "perfbench"))
ref = importlib.import_module("reference.tacotron")
REF = importlib.import_module("reference.precision").REFERENCE

torch.set_num_threads(2)
TINY = taco.TacotronConfig(embed_size=16, prenet_size=16, encoder_banks=3, encoder_highway=1,
                           encoder_units=8, attention_rnn_units=16, attention_depth=12,
                           decoder_units=16, n_mels=20, postnet_banks=2,
                           postnet_projections=(16, 20), postnet_highway=2, postnet_units=8,
                           n_stft=1025)
AUDIO = {"sample_rate": 24000, "pre_emphasis": 0.97, "hop_length_ms": 12.5,
         "win_length_ms": 50.0, "n_fft": 2048, "n_mels": 20, "P_dB_norm_factor": 0.01}
VOC = {"n_iter": 4, "realse": 1.2, "gl_momentum": 0.0, "gl_dft": "fft",
       "mean_abs_amp_norm": 0.045}
CONFIG = {"model": {"n_mels": TINY.n_mels, "reduction": TINY.reduction},
          "features": AUDIO, "vocoder": VOC}
CHARS, FRAMES = (7, 11, 4), (9, 14, 6)


def _jitter(tree, g):
    """Batch-norm statistics drawn at random, so eval-mode BN does real work."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _jitter(v, g)
        elif k in ("mean", "var"):
            tree[k] = (torch.rand(v.shape, generator=g) * 1.5 + 0.5 if k == "var"
                       else 0.3 * torch.randn(v.shape, generator=g))


def trees(cfg=TINY, seed=0):
    params, state = taco.init_tree(torch.Generator().manual_seed(seed), cfg)
    _jitter(state, torch.Generator().manual_seed(seed + 1))
    return params, state


def batch(seed=0):
    rng = np.random.default_rng(seed)
    ids, lengths = pad_ids([rng.integers(1, 256, n) for n in CHARS])
    return torch.tensor(ids), torch.tensor(lengths)


@pytest.fixture(scope="module")
def model():
    return taco.Tacotron(*trees(), TINY).eval()


def gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def row_ids(ids, lengths, b):
    return ids[b, :int(lengths[b])]


@torch.no_grad()
def test_encoder_matches_reference(model):
    ids, lengths = batch()
    memory = model.encode(ids, lengths)
    for b in range(len(CHARS)):
        want = ref.encoder(trees(), row_ids(ids, lengths, b), REF)
        assert gap(memory[b, :CHARS[b]], want) < 1e-5


@torch.no_grad()
def test_free_running_decoder_matches_reference(model):
    ids, lengths = batch()
    steps = taco.steps_for(max(FRAMES), TINY.reduction)
    mel = model.decoder(model.encode(ids, lengths), lengths, steps)
    assert mel.shape == (3, 2 * steps, TINY.n_mels)
    for b in range(len(CHARS)):
        memory = ref.encoder(trees(), row_ids(ids, lengths, b), REF)
        want = ref.decode(trees(), memory, steps, TINY.n_mels, REF).reshape(-1, TINY.n_mels)
        assert gap(mel[b], want) < 1e-4


@torch.no_grad()
def test_postnet_matches_reference(model):
    mel = torch.randn(3, max(FRAMES), TINY.n_mels, generator=torch.Generator().manual_seed(4))
    linear = model.postnet(mel, torch.tensor(FRAMES))
    for b, n in enumerate(FRAMES):
        assert gap(linear[b, :n], ref.postnet(trees(), mel[b, :n], REF)) < 1e-5


@torch.no_grad()
def test_fed_decoder_follows_the_programs_frames(model):
    """The benchmark's ``mel`` check: each step of the reference fed the
    program's frame of the step before gives the program's own frames."""
    ids, lengths = batch()
    steps = taco.steps_for(max(FRAMES), TINY.reduction)
    mel = model.decoder(model.encode(ids, lengths), lengths, steps)
    for b, n in enumerate(FRAMES):
        want = ref.decode_fed(trees(), row_ids(ids, lengths, b), mel[b, :n], CONFIG, REF)
        assert want.shape == (n, TINY.n_mels) and gap(mel[b, :n], want) < 1e-5


@torch.no_grad()
def test_rows_of_a_ragged_batch_equal_rows_alone(model):
    ids, lengths = batch()
    mel, linear = model(ids, lengths, torch.tensor(FRAMES), taco.steps_for(max(FRAMES), 2))
    for b, n in enumerate(FRAMES):
        one_mel, one_linear = model(row_ids(ids, lengths, b)[None], lengths[b:b + 1],
                                    torch.tensor([n]), taco.steps_for(n, 2))
        torch.testing.assert_close(mel[b, :n], one_mel[0, :n], rtol=0, atol=1e-6)
        torch.testing.assert_close(linear[b, :n], one_linear[0], rtol=0, atol=1e-6)


@torch.no_grad()
def test_padded_characters_get_zero_attention(model):
    ids, lengths = batch()
    memory = model.encode(ids, lengths)
    att = model.decoder.attention
    query = torch.randn(3, TINY.attention_rnn_units, generator=torch.Generator().manual_seed(2))
    _, a = att(query, att.keys(memory), memory, TA.mask_bias(lengths, memory.shape[1]))
    for b, n in enumerate(CHARS):
        assert torch.all(a[b, n:] == 0) and torch.all(a[b, :n] > 0)
        torch.testing.assert_close(a[b].sum(), torch.tensor(1.0))
    # other ids in the padding change nothing
    noisy = ids.clone()
    for b, n in enumerate(CHARS):
        noisy[b, n:] = 7
    steps = taco.steps_for(max(FRAMES), 2)
    assert torch.equal(model.decoder(model.encode(noisy, lengths), lengths, steps),
                       model.decoder(memory, lengths, steps))


@torch.no_grad()
def test_unmasked_pad_fails_the_comparison(model, monkeypatch):
    ids, lengths = batch()
    monkeypatch.setattr(taco, "mask_bias", lambda lengths, N: torch.zeros(len(lengths), N))
    mel = model.decoder(model.encode(ids, lengths), lengths, 4)
    b = int(torch.argmin(lengths))
    memory = ref.encoder(trees(), row_ids(ids, lengths, b), REF)
    want = ref.decode(trees(), memory, 4, TINY.n_mels, REF).reshape(-1, TINY.n_mels)
    assert gap(mel[b], want) > 1e-4


@torch.no_grad()
def test_bf16_decoder_fails_the_comparison():
    ids, lengths = batch()
    m = taco.Tacotron(*trees(), TINY).eval()
    memory = m.encode(ids, lengths)
    mel = m.decoder.to(torch.bfloat16)(memory.to(torch.bfloat16), lengths, 4).float()
    want = ref.decode(trees(), ref.encoder(trees(), row_ids(ids, lengths, 0), REF), 4,
                      TINY.n_mels, REF).reshape(-1, TINY.n_mels)
    assert gap(mel[0], want) > 1e-4


def pad_memory(memory, positions):
    return F.pad(memory, (0, 0, 0, positions - memory.shape[1]))


@torch.no_grad()
@pytest.mark.parametrize("buckets", [1, 2])
def test_memory_padded_to_the_graph_bucket_gives_the_unpadded_frames(model, buckets):
    """The captured step's memory: zeros past the longest row, to
    `graph_positions` (and a bucket further), with the lengths as they were."""
    ids, lengths = batch()
    memory = model.encode(ids, lengths)
    positions = taco.graph_positions(memory.shape[1]) + (buckets - 1) * taco.GRAPH_BUCKET
    assert positions % taco.GRAPH_BUCKET == 0 and positions - memory.shape[1] >= 21
    steps = taco.steps_for(max(FRAMES), TINY.reduction)
    want = model.decoder(memory, lengths, steps)
    assert gap(model.decoder(pad_memory(memory, positions), lengths, steps), want) <= 1e-6


def graph_counts() -> dict:
    counts = {}
    for c in profiler.take_counts():
        counts[c.name] = counts.get(c.name, 0) + c.total
    return {k: counts.get(f"tts.decode_graph_{k}", 0) for k in ("steps", "captures")}


@pytest.mark.parametrize("grad", [False, True])
def test_the_cpu_and_autograd_run_the_plain_loop(grad):
    """No capture on the CPU, with autograd or without; under autograd the
    loop's frames keep their graph back to the weights."""
    m = taco.Tacotron(*trees(), TINY).eval()
    ids, lengths = batch()
    with torch.no_grad():
        memory = m.encode(ids, lengths)
    profiler.take_counts()
    with torch.set_grad_enabled(grad), profiler.recording():
        mel = m.decoder(memory, lengths, 3)
    assert graph_counts() == {"steps": 0, "captures": 0} and not m.decoder.captured
    assert mel.requires_grad == grad
    if grad:
        mel.square().sum().backward()
        assert float(m.decoder.frames.kernel.grad.abs().max()) > 0


@pytest.mark.parametrize("option", [{}, {"fused_gru": True}, {"use_lstm": True}])
def test_cbhg_rows_with_lengths_equal_rows_alone(option):
    cfg = TM.CBHGConfig(embed_size=16, num_banks=4, num_highway=1, projections=(12, 6), **option)
    params, state = TM.cbhg_init(torch.Generator().manual_seed(3), cfg)
    _jitter(state, torch.Generator().manual_seed(4))
    assert cfg.pre_highway and list(params)[5] == "pre_highway"
    cbhg = TM.CBHG(params, state, cfg)
    lengths = torch.tensor([9, 17, 3])
    x = torch.randn(3, 17, 6, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        out = cbhg(x, lengths=lengths)
        assert out.shape == (3, 17, 16)
        for b, n in enumerate(lengths.tolist()):
            torch.testing.assert_close(out[b, :n], cbhg(x[b:b + 1, :n])[0], rtol=0, atol=1e-6)


def test_reverse_rows_is_its_own_inverse():
    x = torch.arange(12.0).reshape(2, 6, 1)
    got = TM.reverse_rows(x, torch.tensor([4, 6]))
    assert got[0, :, 0].tolist() == [3, 2, 1, 0, 4, 5]
    assert got[1, :, 0].tolist() == [11, 10, 9, 8, 7, 6]
    assert torch.equal(TM.reverse_rows(got, torch.tensor([4, 6])), x)
    assert torch.equal(TM.reverse_rows(x), x.flip(1))


def voc_fields(**kw) -> dict:
    """The pipeline's vocoder fields at the paper's settings, ``kw`` over them."""
    return {**tacotron_config_from_cfg_d({})[2], **kw}


def feat():
    return tacotron_config_from_cfg_d({"model": {"n_mels": 20, "postnet_projections": [16, 20]},
                                       "features": AUDIO})[1]


def test_vocoder_rows_equal_rows_alone_and_the_reference():
    frames = [min_frames(feat()), 13, 9]
    g = torch.Generator().manual_seed(6)
    P = 0.5 * torch.rand(3, max(frames), 1025, generator=g)
    phase = vocoder.row_phases(frames, 1025, torch.Generator().manual_seed(8), "cpu")
    kw = dict(P_dB_norm_factor=0.01, pre_emphasis=0.97, hop_length=300, win_length=1200,
              mean_abs_amp_norm=0.045, n_iter=4, n_fft=2048, realse=1.2)
    y = from_power_to_wav(P, init_phase=phase, frames=frames, **kw)
    draws = ref.phase_draws(frames, 1025, 8, "cpu")
    for b, n in enumerate(frames):
        L = (n - 1) * 300
        assert torch.equal(phase[b, :n], draws[b])
        alone = from_power_to_wav(P[b, :n], init_phase=phase[b, :n], **kw)
        assert alone.shape == (L,) and gap(y[b, :L], alone) < 1e-5
        assert torch.all(y[b, L:] == 0)
        want = ref.dsp.vocode(P[b, :n], draws[b], AUDIO, VOC)
        assert gap(y[b, :L], want) < 1e-5


def test_synthesis_matches_reference_end_to_end():
    params, state = trees()
    f = feat()
    pipe = SynthesisPipeline(cfg=TINY, model=taco.Tacotron(params, state, TINY).eval(),
                             feat_cfg=f, device=torch.device("cpu"), **voc_fields(n_iter=4))
    ids, lengths = batch()
    pcm = pipe.synthesize_batch_pcm16(ids.numpy(), lengths.numpy(), FRAMES, seed=11)
    draws = ref.phase_draws(FRAMES, 1025, 11, "cpu")
    for b, n in enumerate(FRAMES):
        want = ref.synthesize((params, state), row_ids(ids, lengths, b), n, draws[b],
                              CONFIG, REF)
        assert pcm[b].dtype == np.int16 and pcm[b].shape == ((n - 1) * 300,)
        # PCM rounds to whole steps: a gap of 2 steps of 32767 at most
        assert np.abs(pcm[b] - want["pcm"].numpy()).max() <= 2.0


def test_frame_counts_below_the_reflect_padding_raise():
    pipe = make_synthesis_pipeline(TINY, feat(), device="cpu", n_iter=2)
    with pytest.raises(ValueError, match="reflect padding"):
        pipe.synthesize_batch_pcm16(np.ones((1, 3)), [3], [min_frames(feat()) - 1])


def test_text_ids_keep_zero_for_padding():
    ids = text_ids("Ab \x00\xff", 256)
    assert ids.min() >= 1 and ids.max() <= 255
    assert text_ids("Ab").tolist() == [65, 98]


def test_published_configuration_reads_and_counts():
    """The benchmark's configuration file gives the paper's widths: about
    7 M parameters (keithito/tacotron's count at these widths is 6.9 M)."""
    cfg_d = json.loads((ROOT / "perfbench" / "configs" / "tacotron_f32.json").read_text())
    cfg, f, voc = tacotron_config_from_cfg_d(cfg_d)
    assert cfg == taco.TacotronConfig()
    assert (f.sample_rate, f.hop_length, f.win_length, f.n_fft_, f.n_stft) == \
        (24000, 300, 1200, 2048, 1025)
    assert voc == {"n_iter": 50, "realse": 1.2, "gl_momentum": 0.0, "gl_dft": "fft",
                   "mean_abs_amp_norm": 0.045}
    n = sum(p.numel() for p in taco.Tacotron(*taco.init_tree(torch.Generator(), cfg),
                                             cfg).parameters())
    assert 6.5e6 < n < 7.5e6


def test_app_writes_a_wav_a_sentence(tmp_path):
    from speech_cloner_tpu_torch.apps import tts as app

    cfg = tmp_path / "tiny.json"
    model = {k: getattr(TINY, k) for k in ("embed_size", "prenet_size", "encoder_banks",
                                           "encoder_units", "attention_rnn_units", "n_mels",
                                           "decoder_units", "postnet_banks", "postnet_units")}
    cfg.write_text(json.dumps({"model": dict(model, postnet_projections=[16, 20]),
                               "features": AUDIO, "vocoder": dict(VOC, n_iter=2)}))
    app.main(["--text", "Hi.", "--text", "A little longer.", "--cfg", str(cfg), "--device",
              "cpu", "--output-dir", str(tmp_path / "out")])
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["tts_0.wav", "tts_1.wav"]


# ----------------------------------------------------------------- card ---

@pytest.fixture
def cuda():
    """The card, with the float32 products every entry point sets (no TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    float32_products("cuda")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C,K,B,T", [(128, 16, 32, 151), (80, 8, 32, 808)])
def test_bank_kernel_at_tacotron_widths(cuda, C, K, B, T):
    g = torch.Generator().manual_seed(C + K)
    x = torch.randn(B, T, C, generator=g)
    kernels = [torch.randn(k, C, 128, generator=g) / np.sqrt(k * C) for k in range(1, K + 1)]
    want = TK.conv_banks_plain(x.double(), [k.double() for k in kernels]).float()
    with torch.inference_mode():
        got = TK.conv_banks(x.to(cuda), [k.to(cuda) for k in kernels]).cpu()
    assert gap(got, want) < 1e-5


@pytest.mark.gpu
def test_cbhg_lengths_around_the_scan_at_published_widths(cuda):
    """The post-net's CBHG (C = 80, K = 8, H = 128) with ragged lengths on
    the card: the bank kernel and the scan kernel at H = 128, both
    directions, against the CPU."""
    cfg = taco.TacotronConfig().postnet_cbhg
    params, state = TM.cbhg_init(torch.Generator().manual_seed(1), cfg)
    _jitter(state, torch.Generator().manual_seed(2))
    cpu = TM.CBHG(params, state, cfg).eval()
    card = TM.CBHG(params, state, cfg).to(cuda).eval()
    lengths = torch.tensor([808, 97, 431, 5])
    x = torch.randn(4, 808, 80, generator=torch.Generator().manual_seed(3))
    before = dict(TK.launch_counts)
    with torch.inference_mode():
        want = cpu(x, lengths=lengths)
        got = card(x.to(cuda), lengths=lengths.to(cuda)).cpu()
    assert TK.launch_counts["conv_banks", torch.float32] > before.get(("conv_banks",
                                                                       torch.float32), 0)
    for b, n in enumerate(lengths.tolist()):
        assert gap(got[b, :n], want[b, :n]) < 1e-4


@pytest.mark.gpu
def test_synthesis_on_the_card_matches_the_cpu(cuda):
    params, state = trees()
    f = feat()
    ids, lengths = batch()
    pcm = {}
    for dev in ("cpu", cuda):
        pipe = SynthesisPipeline(cfg=TINY, model=taco.Tacotron(params, state, TINY).to(dev).eval(),
                                 feat_cfg=f, device=torch.device(dev), **voc_fields(n_iter=4))
        with torch.inference_mode():
            pcm[str(dev)] = pipe.device_synthesize(ids.to(dev), lengths.to(dev), list(FRAMES))
    for a, b in zip(pcm["cpu"], pcm[str(cuda)]):
        assert gap(b.cpu(), a) < 1e-4


@pytest.mark.gpu
def test_vocoder_rows_of_a_large_batch_equal_rows_alone_on_the_card(cuda):
    """32 ragged rows of 300-765 frames at 2048 / 300: over that many frames
    cuFFT's inverse reads the imaginary parts of the first and last bins,
    which the random initial phase sets, and over one row it does not, so
    with them left complex a row reads 0.32 of the peak off the row alone.
    Made real, what is left is cuFFT's rounding, which differs between its
    large- and small-batch kernels (5e-8 a frame) and which 4 rounds on a
    noise spectrum carry to 2.1e-5: a limit of 1e-4."""
    frames = [300 + 15 * b for b in range(32)]
    P = 0.5 * torch.rand(32, max(frames), 1025, generator=torch.Generator().manual_seed(6))
    phase = vocoder.row_phases(frames, 1025, torch.Generator().manual_seed(8), "cpu")
    kw = dict(P_dB_norm_factor=0.01, pre_emphasis=0.97, hop_length=300, win_length=1200,
              mean_abs_amp_norm=0.045, n_iter=4, n_fft=2048, realse=1.2)
    with torch.inference_mode():
        y = from_power_to_wav(P.to(cuda), init_phase=phase.to(cuda), frames=frames, **kw).cpu()
        for b in (0, 13, 31):
            n, L = frames[b], (frames[b] - 1) * 300
            alone = from_power_to_wav(P[b:b + 1, :n].to(cuda), init_phase=phase[b:b + 1, :n].to(cuda),
                                      frames=[n], **kw)[0].cpu()
            assert gap(y[b, :L], alone) < 1e-4, b


def published_decoder(cuda):
    cfg = taco.TacotronConfig()
    params, _ = taco.init_tree(torch.Generator().manual_seed(7), cfg)
    return taco.TacotronDecoder(params["decoder"], cfg).to(cuda).eval()


def decoder_inputs(cuda, B, n, seed):
    """A memory [B, n, 256] and lengths, the first row n characters long."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, n + 1, (B,), generator=g)
    lengths[0] = n
    return torch.randn(B, n, 256, generator=g).to(cuda), lengths.to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 32])
def test_replayed_decoder_step_equals_the_plain_loop(cuda, B):
    """At positions the bucket does not pad, the replays give the loop's
    bits, each step a replay and one capture in all."""
    dec = published_decoder(cuda)
    memory, lengths = decoder_inputs(cuda, B, 2 * taco.GRAPH_BUCKET, B)
    profiler.take_counts()
    with torch.inference_mode(), profiler.recording():
        got = dec(memory, lengths, 40)
    assert graph_counts() == {"steps": 40, "captures": 1}
    with torch.inference_mode():
        assert torch.equal(got, dec.loop(memory, lengths, 40))


@pytest.mark.gpu
def test_one_captured_step_serves_its_bucket_and_a_new_bucket_captures_again(cuda):
    """Calls of one decoder with other memories, lengths and step counts
    (1, 8, more than the capturing call's) reuse its capture, each equal to
    the loop on the padded memory and within 1e-6 of the loop on the memory
    as given; a batch of another size or a longer memory captures anew."""
    dec = published_decoder(cuda)
    calls = [(32, 60, 12), (32, 50, 1), (32, 64, 8), (32, 33, 30), (1, 40, 9),
             (32, 70, 5), (32, 96, 3)]
    profiler.take_counts()
    for seed, (B, n, steps) in enumerate(calls):
        memory, lengths = decoder_inputs(cuda, B, n, 100 + seed)
        with torch.inference_mode(), profiler.recording():
            got = dec(memory, lengths, steps)
        with torch.inference_mode():
            want = dec.loop(memory, lengths, steps)
            padded = dec.loop(pad_memory(memory, taco.graph_positions(n)), lengths, steps)
        assert got.shape == (B, 2 * steps, 80)
        assert torch.equal(got, padded), (B, n, steps)
        assert gap(got, want) <= 1e-6, (B, n, steps)
    # (32, 64) for the first four, (1, 64), then (32, 96) for the last two
    assert graph_counts() == {"steps": sum(c[2] for c in calls), "captures": 3}
    assert sorted(k[:2] for k in dec.captured) == [(1, 64), (32, 64), (32, 96)]
