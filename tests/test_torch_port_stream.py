"""Streaming conversion of the PyTorch port against the JAX package, on the CPU.

Both `StreamingCloner`s run over the same pipeline trees (the tiny geometry
of tests/test_stream.py, carried over with ``runtime/jax_params.py``), the
same numpy audio and the same arguments. Both draw their Griffin-Lim phases
from ``np.random.default_rng(seed + i)`` on the host, so the port is held to
the JAX output sample for sample: the emitted spectrogram of every chunk
(``debug_stft``) within STFT_ATOL and the emitted waveform within WAV_TOL of
its peak. Each JAX run is computed once per module (JAX compiles per window
shape). The stream mesh's parity is in tests/test_torch_port_parallel.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_stream import _speechy_wav
from test_torch_port_pipeline import pipes  # noqa: F401

from speech_cloner_tpu import ops as jops
from speech_cloner_tpu.pipeline.stream import StreamingCloner as JStream
from speech_cloner_tpu_torch import ops as tops
from speech_cloner_tpu_torch.pipeline.stream import StreamingCloner as TStream

torch.set_num_threads(2)
KW = dict(chunk_frames=64, context_frames=64, lookahead_frames=48, margin_frames=8)
# float32 both sides through features, 2 models and 4 Griffin-Lim rounds;
# the measured gaps over CASES are at most 7.5e-9 (spectrogram) and 2.4e-6
# of the peak (waveform)
STFT_ATOL = 1e-5
WAV_TOL = 2e-5


def _faded(seconds, seed):
    """A clip whose first second fades in from 15%: its first window is not
    representative of the whole, so the running gain moves."""
    wav = _speechy_wav(seconds, seed=seed)
    wav[:16000] *= 0.15 + 0.85 * np.arange(16000, dtype=np.float32) / 16000
    return wav


def _silent_start(seconds, seed):
    wav = _speechy_wav(seconds, seed=seed)
    wav[: wav.size // 2] = 0.0
    return wav


# name -> (audio, push block (None: the whole clip in one push), cloner kwargs)
CASES = {
    "steady_and_flush": (lambda: _speechy_wav(2.0, seed=3), 7919, {}),
    "running_gain": (lambda: _faded(2.5, 21), 4096, {}),
    "frozen_gain": (lambda: _faded(2.5, 21), 4096, {"gain_mode": "frozen"}),
    "input_gain": (lambda: _speechy_wav(1.5, seed=5), 16000, {"input_gain": 0.0123}),
    "first_gain_buffered": (lambda: _speechy_wav(2.0, seed=9), None,
                            {"gain_mode": "frozen", "first_gain": "buffered"}),
    "silent_start": (lambda: _silent_start(2.0, 7), None, {}),
    "flush_only": (lambda: _speechy_wav(0.2), 16000, {}),
}


@pytest.fixture(scope="module")
def jax_runs(pipes):  # noqa: F811
    """JAX run of a case (``bf16``: with bf16 models), once per module:
    (output, debug_stft, cloner)."""
    jp, _ = pipes
    jp_bf16 = dataclasses.replace(jp, compute_dtype=jnp.bfloat16)

    @functools.lru_cache(maxsize=None)
    def run(name, bf16=False):
        make, block, kw = CASES[name]
        s = JStream(jp_bf16 if bf16 else jp, collect_debug=True, **KW, **kw)
        wav = make()
        out = s.convert_all(wav, block=block or wav.size)
        return out, np.concatenate(s.debug_stft), s
    return run


def port_run(tp, name):
    make, block, kw = CASES[name]
    s = TStream(tp, collect_debug=True, **KW, **kw)
    wav = make()
    out = s.convert_all(wav, block=block or wav.size)
    return out, np.concatenate(s.debug_stft), s


def assert_wav_close(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= WAV_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("name", list(CASES))
def test_stream_matches_jax(pipes, jax_runs, name):  # noqa: F811
    """Emitted spectrogram, waveform and the carried per-stream statistics
    (gain, mel max, unit-gain mel0) against the JAX cloner's."""
    _, tp = pipes
    ref_out, ref_stft, js = jax_runs(name)
    out, stft, ts = port_run(tp, name)
    wav_len = CASES[name][0]().size
    assert out.size == (wav_len // 80 + 1) * 80
    assert stft.shape == ref_stft.shape
    np.testing.assert_allclose(stft, ref_stft, atol=STFT_ATOL)
    assert_wav_close(out, ref_out)
    np.testing.assert_allclose(ts._gain, js._gain, rtol=1e-6)
    np.testing.assert_allclose(ts._mel_max, js._mel_max, rtol=1e-6, atol=1e-5)
    # mel0: float32 sums in another order; its near-floor bins differ most
    np.testing.assert_allclose(ts._m0, js._m0, rtol=0, atol=1e-6 * np.abs(js._m0).max())
    assert ts._buf_start == js._buf_start and ts._f0 == js._f0


def test_stream_trims_buffer_and_ramps_up(pipes):  # noqa: F811
    """The steady case runs the ramp-up windows (start clamped at frame 0),
    the steady window and the flush over a trimmed buffer."""
    _, tp = pipes
    s = TStream(tp, **KW)
    shapes = []
    real = s._forward
    s._forward = lambda y, *a, **k: (shapes.append(y.shape[1]), real(y, *a, **k))[1]
    s.convert_all(_speechy_wav(2.0, seed=3), block=7919)
    assert s._buf_start > 0
    hop, steady = 80, 64 + 64 + 48 + 2 * 4
    assert shapes[:3] == [(64 + 48 + 4) * hop, (128 + 48 + 4) * hop, steady * hop]
    assert shapes[-1] == (steady - 1) * hop + 400       # the flush: center=False framing


def test_batched_streams_match_jax_and_single_streams(pipes):  # noqa: F811
    """batch=3 lockstep against the JAX batch, and each row against the
    port's own single stream of seed 5 + i."""
    jp, tp = pipes
    wavs = np.stack([_speechy_wav(2.0, seed=11), _speechy_wav(2.0, seed=12),
                     0.5 * _speechy_wav(2.0, seed=13)])
    ref = JStream(jp, batch=3, seed=5, **KW).convert_all(wavs, block=5000)
    got = TStream(tp, batch=3, seed=5, **KW).convert_all(wavs, block=5000)
    assert got.shape == (3, (wavs.shape[1] // 80 + 1) * 80)
    for i in range(3):
        assert_wav_close(got[i], ref[i])
        one = TStream(tp, seed=5 + i, **KW).convert_all(wavs[i], block=5000)
        # other GEMM shapes, so float32 sums in other orders (the JAX test's 1e-4)
        np.testing.assert_allclose(got[i], one, atol=1e-4, rtol=0)


def test_reset_stream_mid_run_matches_jax(pipes):  # noqa: F811
    """reset_stream(1) halfway, a new quieter occupant: the churned slot
    against the JAX run, and slot 0 byte-identical to the untouched run."""
    jp, tp = pipes
    block = 64 * 80
    wav0, wav1 = _speechy_wav(2.0, seed=21), _speechy_wav(2.0, seed=22)
    wav2 = 0.4 * _speechy_wav(2.0, seed=23)
    n_ticks = wav0.size // block

    def run(cls, pipe, churn):
        s = cls(pipe, batch=2, seed=7, **KW)
        outs, gains = [], []
        for i in range(n_ticks):
            if churn and i == n_ticks // 2:
                s.reset_stream(1)
            row1 = wav2 if churn and i >= n_ticks // 2 else wav1
            out = s.push(np.stack([wav0[i * block:(i + 1) * block],
                                   row1[i * block:(i + 1) * block]]))
            if out.shape[1]:
                outs.append(out)
                gains.append(s._gain.copy())
        return np.concatenate(outs, axis=1), gains

    base, _ = run(TStream, tp, False)
    churned, gains = run(TStream, tp, True)
    ref, ref_gains = run(JStream, jp, True)
    np.testing.assert_array_equal(base[0], churned[0])
    assert gains[-1][1] > 2.0 * gains[0][1]
    np.testing.assert_allclose(np.array(gains), np.array(ref_gains), rtol=1e-6)
    for i in range(2):
        assert_wav_close(churned[i], ref[i])


def test_stream_bf16_within_twice_jax_gap(pipes, jax_runs):  # noqa: F811
    """bf16 models: the port's emitted spectrogram against JAX float32 within
    twice JAX's own bf16 gap against JAX float32."""
    _, tp = pipes
    _, ref, _ = jax_runs("steady_and_flush")
    _, jax_bf16, _ = jax_runs("steady_and_flush", bf16=True)
    out, got, _ = port_run(dataclasses.replace(tp, compute_dtype=torch.bfloat16),
                           "steady_and_flush")
    jax_gap = np.abs(jax_bf16 - ref).max()
    assert 0 < jax_gap < 5e-2
    assert np.abs(got - ref).max() <= 2 * jax_gap
    assert np.isfinite(out).all()


def test_latency_accounting_and_properties(pipes):  # noqa: F811
    """First output exactly when min_input_frames are buffered; the latency
    properties equal the JAX cloner's."""
    jp, tp = pipes
    kw = dict(chunk_frames=64, context_frames=32, lookahead_frames=48, margin_frames=8)
    s, js = TStream(tp, **kw), JStream(jp, **kw)
    assert (s.min_input_frames, s.latency_seconds) == (js.min_input_frames, js.latency_seconds)
    need = s.min_input_frames * 80
    wav = _speechy_wav(3.0)
    assert s.push(wav[: need - 1]).size == 0
    assert s.push(wav[need - 1 : need]).size == 64 * 80


def test_flush_closes_the_stream(pipes):  # noqa: F811
    _, tp = pipes
    s = TStream(tp, **KW)
    wav = _speechy_wav(0.2)
    assert s.push(wav).size == 0
    assert s.flush().size == (wav.size // 80 + 1) * 80
    with pytest.raises(RuntimeError):
        s.push(wav)
    assert s.flush().size == 0


@pytest.mark.parametrize("kw", [
    dict(chunk_frames=0), dict(margin_frames=1), dict(margin_frames=60, lookahead_frames=48),
    dict(margin_frames=40, context_frames=32, lookahead_frames=48),
    dict(chunk_frames=4, margin_frames=8), dict(batch=0), dict(edge_frames=2),
    dict(gain_mode="sometimes"), dict(first_gain="all"),
], ids=lambda kw: ",".join(kw))
def test_argument_checks_match_jax(pipes, kw):  # noqa: F811
    jp, tp = pipes
    args = {**KW, **kw}
    with pytest.raises(ValueError):
        JStream(jp, **args)
    with pytest.raises(ValueError):
        TStream(tp, **args)


def test_mesh_waits_for_parallel(pipes):  # noqa: F811
    """The stream mesh is ported ("Parallel"): 4 streams over 2 shards put
    rows 0-1 and 2-3 on the two mesh positions; a batch that does not
    divide over the mesh, or a 2-D mesh, raises ValueError as in JAX
    (tests/test_torch_port_parallel.py holds the mesh run against JAX)."""
    import numpy as np

    from speech_cloner_tpu_torch.parallel.mesh import Mesh, make_seq_mesh

    _, tp = pipes
    s = TStream(tp, batch=4, mesh=make_seq_mesh(2, devices=["cpu", "cpu"]), **KW)
    assert [rows for rows, _ in s._shards] == [slice(0, 2), slice(2, 4)]
    with pytest.raises(ValueError):
        TStream(tp, batch=3, mesh=make_seq_mesh(2, devices=["cpu", "cpu"]), **KW)
    grid = np.empty((1, 2), dtype=object)
    grid[:] = [[torch.device("cpu")] * 2]
    with pytest.raises(ValueError):
        TStream(tp, batch=4, mesh=Mesh(grid, ("a", "b")), **KW)


def test_batched_push_wants_b_rows(pipes):  # noqa: F811
    _, tp = pipes
    with pytest.raises(ValueError):
        TStream(tp, batch=2, **KW).push(np.zeros(160, np.float32))


# Griffin-Lim from random amplitudes (no consistent spectrogram behind them)
# amplifies float32 sum-order differences over the rounds: measured up to
# 1.4e-4 of the peak against JAX (4-25 rounds, momentum 0 and 0.99)
GL_TOL = 5e-4


@pytest.mark.parametrize("n_iter,momentum", [(4, 0.0), (6, 0.99)])
def test_griffin_lim_dyn_matches_jax(n_iter, momentum):
    """The port's `griffin_lim` / `from_power_to_wav` against JAX's run-time
    round count and momentum forms (while loops), from the same initial
    phase, the round count and momentum cast to Python numbers on the
    port's side."""
    rng = np.random.default_rng(n_iter)
    amp = rng.random((40, 201)).astype(np.float32)
    phase = (np.pi * rng.random((40, 201))).astype(np.float32)
    ref, ref_S = jops.griffin_lim_dyn(jnp.asarray(amp), 400, 80, np.int32(n_iter),
                                      init_phase=jnp.asarray(phase),
                                      momentum=np.float32(momentum), return_stft=True)
    ref = np.asarray(ref)
    got, S = tops.griffin_lim(torch.tensor(amp), 400, 80, num_iters=int(np.int32(n_iter)),
                              init_phase=torch.tensor(phase),
                              momentum=float(np.float32(momentum)), return_stft=True)
    assert np.abs(got.numpy() - ref).max() <= GL_TOL * np.abs(ref).max()
    assert S.shape == ref_S.shape
    P = rng.uniform(0.0, 1.0, (40, 201)).astype(np.float32)
    kw = dict(hop_length=80, win_length=400, mean_abs_amp_norm=0.045, realse=1.2)
    ref = jops.from_power_to_wav_dyn(jnp.asarray(P), np.int32(n_iter), np.float32(momentum),
                                     key=jax.random.PRNGKey(0), **kw)
    # JAX draws its phase from the key: hand the port that draw
    phase = np.asarray(jnp.pi * jax.random.uniform(jax.random.PRNGKey(0), (40, 201),
                                                   dtype=jnp.float32))
    got = tops.from_power_to_wav(torch.tensor(P), n_iter=int(np.int32(n_iter)),
                                 momentum=float(np.float32(momentum)),
                                 init_phase=torch.tensor(phase), **kw).numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= GL_TOL * np.abs(ref).max()


def test_device_vocode_pcm16_dyn_matches_static(pipes):  # noqa: F811
    """The port's `device_vocode_pcm16` on a pipeline set to 4 rounds and no
    momentum gives the PCM of JAX's `device_vocode_pcm16_dyn`, whose round
    count and momentum are given per call, within 1 LSB."""
    jp, tp = pipes
    P = np.random.default_rng(0).uniform(0.0, 1.0, (96, 201)).astype(np.float32)
    phase = np.asarray(jnp.pi * jax.random.uniform(jax.random.PRNGKey(3), (96, 201),
                                                   dtype=jnp.float32))
    with torch.inference_mode():
        got = dataclasses.replace(tp, n_iter=4, gl_momentum=0.0).device_vocode_pcm16(
            torch.tensor(P), init_phase=torch.tensor(phase)).numpy()
    ref = np.asarray(jp.device_vocode_pcm16_dyn(jnp.asarray(P), jax.random.PRNGKey(3),
                                                np.int32(4), np.float32(0.0)))
    assert got.shape == ref.shape
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1
