"""Sequence-parallel inference and the stream mesh of the PyTorch port against
the JAX package, on the CPU.

The JAX functions run under ``shard_map`` over 4 of the 8 virtual CPU
devices of tests/conftest.py; the port's run over a mesh of 4 shards on the
CPU (``make_seq_mesh(4, devices=["cpu"] * 4)``: the same arithmetic as 4
cards, one shard after another). Inputs are seeded numpy arrays, weights the
JAX package's initial trees carried over with ``runtime/jax_params.py``,
and Griffin-Lim gets JAX's initial phase. Both sides are float32 and run
the same algorithm, so the limits are float32 sums in another order:
FWD_ATOL = 1e-5 for the forward pieces (convs, pool, warmed-up GRU,
encoder, clone forward, mel and stft of a conversion) and GL_ATOL = 5e-5
for Griffin-Lim and the waveforms. The stream mesh is held to the JAX
mesh run with the stream tests' limit (WAV_TOL of the peak), and to the
port's own unsharded batch at FWD_ATOL.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P
from test_stream import _speechy_wav
from test_torch_port_pipeline import jax_phase, pipes  # noqa: F401
from test_torch_port_stream import WAV_TOL

from speech_cloner_tpu import ops as jops
from speech_cloner_tpu.models import decoder as jdec
from speech_cloner_tpu.models import encoder as jenc
from speech_cloner_tpu.nn import modules as JM
from speech_cloner_tpu.parallel import gl_sp as jgl
from speech_cloner_tpu.parallel import halo as jhalo
from speech_cloner_tpu.parallel import make_seq_mesh as j_make_seq_mesh
from speech_cloner_tpu.pipeline.stream import StreamingCloner as JStream
from speech_cloner_tpu_torch import ops as tops
from speech_cloner_tpu_torch.models import decoder as tdec
from speech_cloner_tpu_torch.models import encoder as tenc
from speech_cloner_tpu_torch.nn import modules as TM
from speech_cloner_tpu_torch.parallel import gl_sp as tgl
from speech_cloner_tpu_torch.parallel import halo as thalo
from speech_cloner_tpu_torch.parallel.mesh import make_seq_mesh
from speech_cloner_tpu_torch.pipeline.stream import StreamingCloner as TStream
from speech_cloner_tpu_torch.runtime.jax_params import decoder_from_jax, encoder_from_jax

torch.set_num_threads(2)
NSEQ = 4
FWD_ATOL = 1e-5
GL_ATOL = 5e-5
STREAM_KW = dict(chunk_frames=64, context_frames=64, lookahead_frames=48, margin_frames=8)


@pytest.fixture(scope="module")
def jmesh():
    return j_make_seq_mesh(NSEQ)


@pytest.fixture(scope="module")
def tmesh():
    return make_seq_mesh(NSEQ, devices=["cpu"] * NSEQ)


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def smap(mesh, fn):
    return shard_map(fn, mesh=mesh, in_specs=(P(None, "seq", None),),
                     out_specs=P(None, "seq", None))


def randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def joined(shards) -> np.ndarray:
    return thalo.gather(shards).detach().numpy()


# ------------------------------------------------------------------ meshes ---

def test_seq_mesh_never_shrinks():
    """More shards than devices raises (JAX's devices()[:n] would give fewer);
    there is no card here, so a default (CUDA) mesh of one raises too."""
    with pytest.raises(ValueError):
        make_seq_mesh(3, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        make_seq_mesh(1)
    with pytest.raises(ValueError):
        make_seq_mesh(1, devices=["cuda:0"])
    m = make_seq_mesh(3, devices=["cpu"] * 3, axis_name="streams")
    assert m.size == 3 and m.axis_names == ("streams",) and m.shape == {"streams": 3}


# --------------------------------------------------------------- the halos ---

@pytest.mark.parametrize("k", [1, 2, 3, 6, 8])
def test_conv1d_halo_matches_jax(jmesh, tmesh, k):
    x = randn((2, 64, 8), k)
    params = np_tree(JM.conv1d_init(jax.random.PRNGKey(k), k, 8, 5))
    ref = np.asarray(smap(jmesh, lambda xx: jhalo.conv1d_halo(params, xx, "seq"))(jnp.asarray(x)))
    w = torch.tensor(params["kernel"]).permute(2, 1, 0).contiguous()
    got = joined(thalo.conv1d_halo(w, thalo.shard_time(torch.tensor(x), tmesh)))
    np.testing.assert_allclose(got, ref, atol=FWD_ATOL)
    np.testing.assert_allclose(got, TM.conv1d(torch.tensor(x), w).numpy(), atol=FWD_ATOL)


def test_maxpool1d_same_halo_matches_jax(jmesh, tmesh):
    x = randn((2, 64, 8), 11)
    ref = np.asarray(smap(jmesh, lambda xx: jhalo.maxpool1d_same_halo(xx, "seq"))(jnp.asarray(x)))
    got = joined(thalo.maxpool1d_same_halo(thalo.shard_time(torch.tensor(x), tmesh)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("warmup", [16, 24])
def test_bigru_warmup_matches_jax(jmesh, tmesh, warmup):
    params = np_tree(JM.gru_init(jax.random.PRNGKey(0), 6, 8))
    x = randn((1, 128, 6), 12, 0.5)
    ref = np.asarray(smap(jmesh, lambda xx: jhalo.bigru_warmup(params, xx, warmup=warmup,
                                                               axis_name="seq"))(jnp.asarray(x)))
    got = joined(thalo.bigru_warmup(TM.GRU(params), thalo.shard_time(torch.tensor(x), tmesh),
                                    warmup))
    np.testing.assert_allclose(got, ref, atol=FWD_ATOL)


def test_bigru_warmup_longer_than_shard_raises(tmesh):
    params = np_tree(JM.gru_init(jax.random.PRNGKey(0), 6, 8))
    xs = thalo.shard_time(torch.tensor(randn((1, 32, 6), 1)), tmesh)
    with pytest.raises(ValueError, match="warmup"):
        thalo.bigru_warmup(TM.GRU(params), xs, 9)


def test_encoder_seq_parallel_matches_jax(jmesh, tmesh):
    cfg = jenc.EncoderConfig(n_timesteps=128, input_dim=16, n_output=61, num_conv_banks=3,
                             num_highwaynet_blocks=1)
    params, state = np_tree(jenc.init(jax.random.PRNGKey(1), cfg))
    x = randn((1, 128, 16), 13)
    ref = np.asarray(jhalo.encoder_seq_parallel(params, state, cfg, jmesh, warmup=32)(
        jnp.asarray(x)))
    model = encoder_from_jax(params, state, tenc.EncoderConfig(**dataclasses.asdict(cfg)))
    got = joined(thalo.encoder_seq_parallel(model, tmesh, warmup=32)(torch.tensor(x)))
    np.testing.assert_allclose(got, ref, atol=FWD_ATOL)


def test_clone_forward_seq_parallel_matches_jax(jmesh, tmesh):
    enc_cfg = jenc.EncoderConfig(n_timesteps=128, input_dim=16, n_output=61,
                                 num_conv_banks=2, num_highwaynet_blocks=1)
    dec_cfg = jdec.DecoderConfig(n_timesteps=128, input_dim=61,
                                 step1=jdec.DecoderStepConfig(32, 2, 1, 20),
                                 step2=jdec.DecoderStepConfig(48, 2, 1, 51))
    ep, es = np_tree(jenc.init(jax.random.PRNGKey(2), enc_cfg))
    dp, ds_ = np_tree(jdec.init(jax.random.PRNGKey(3), dec_cfg))
    x = randn((1, 128, 16), 14)
    refs = jhalo.clone_forward_seq_parallel(ep, es, enc_cfg, dp, ds_, dec_cfg, jmesh,
                                            warmup=32)(jnp.asarray(x))
    t_dec = tdec.DecoderConfig(n_timesteps=128, input_dim=61,
                               step1=tdec.DecoderStepConfig(32, 2, 1, 20),
                               step2=tdec.DecoderStepConfig(48, 2, 1, 51))
    fn = thalo.clone_forward_seq_parallel(
        encoder_from_jax(ep, es, tenc.EncoderConfig(**dataclasses.asdict(enc_cfg))),
        decoder_from_jax(dp, ds_, t_dec), tmesh, warmup=32)
    for got, ref in zip(fn(torch.tensor(x)), refs):
        np.testing.assert_allclose(joined(got), np.asarray(ref), atol=FWD_ATOL)


# -------------------------------------------------------------- Griffin-Lim ---

def _amp(T=160):
    t = np.arange(T * 80 + 400) / 16000
    y = (np.sin(2 * np.pi * 330 * t) + 0.4 * np.sin(2 * np.pi * 1200 * t)).astype(np.float32)
    return np.abs(jops.stft(y, n_fft=400, hop_length=80, xp=np)).astype(np.float32)[:T]


@pytest.mark.parametrize("iters,momentum", [(1, 0.0), (3, 0.0), (12, 0.0), (8, 0.99)])
def test_griffin_lim_seq_parallel_matches_jax(jmesh, tmesh, iters, momentum):
    S_amp = _amp()
    phase0 = (np.pi * np.random.default_rng(iters).random(S_amp.shape)).astype(np.float32)
    ref = np.asarray(jgl.griffin_lim_seq_parallel(jnp.asarray(S_amp), jmesh, num_iters=iters,
                                                  init_phase=phase0, momentum=momentum))
    got = tgl.griffin_lim_seq_parallel(torch.tensor(S_amp), tmesh, num_iters=iters,
                                       init_phase=phase0, momentum=momentum).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=GL_ATOL)


def test_from_power_to_wav_seq_parallel_matches_jax(jmesh, tmesh):
    T = 160
    P_dB = np.random.default_rng(1).random((T, 201)).astype(np.float32)
    kw = dict(hop_length=80, win_length=400, mean_abs_amp_norm=0.045, n_iter=6, realse=1.2)
    ref = np.asarray(jgl.from_power_to_wav_seq_parallel(jnp.asarray(P_dB), jmesh,
                                                        key=jax.random.PRNGKey(3), **kw))
    got = tgl.from_power_to_wav_seq_parallel(torch.tensor(P_dB), tmesh,
                                             init_phase=jax_phase((T, 201), 3), **kw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=GL_ATOL)


@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_seq_parallel_on_one_device_is_the_single_device_vocoder(momentum):
    """On a one-device mesh the sharded loop is ``ops.griffin_lim`` /
    ``ops.from_power_to_wav`` with the FFT DFT, bit for bit: it runs the
    same overlap-add, framing, envelope division and output norm."""
    mesh = make_seq_mesh(1, devices=["cpu"])
    g = torch.Generator().manual_seed(11)
    amp = torch.tensor(_amp(240))
    phase = math.pi * torch.rand(amp.shape, generator=g)
    got = tgl.griffin_lim_seq_parallel(amp, mesh, num_iters=6, init_phase=phase,
                                       momentum=momentum)
    want = tops.griffin_lim(amp, 400, 80, num_iters=6, init_phase=phase, momentum=momentum,
                            dft="fft")
    assert torch.equal(got, want)
    P_dB = torch.rand((300, 201), generator=g)
    phase = math.pi * torch.rand(P_dB.shape, generator=g)
    kw = dict(hop_length=80, win_length=400, mean_abs_amp_norm=0.045, n_iter=8, realse=1.2,
              init_phase=phase, momentum=momentum)
    got = tgl.from_power_to_wav_seq_parallel(P_dB, mesh, **kw)
    assert torch.equal(got, tops.from_power_to_wav(P_dB, dft="fft", **kw))


# -------------------------------------------------- the pipeline and streams ---

def test_convert_seq_parallel_matches_jax(pipes):  # noqa: F811
    """A 2 s clip: 401 frames pad to 404 over 4 shards (101 frames each, the
    sharded vocoder) and trim back."""
    jp, tp = pipes
    wav = 0.5 * _speechy_wav(2.0, seed=41)
    ref = jp.convert_seq_parallel(wav, n_devices=NSEQ, warmup=48, seed=0)
    got = tp.convert_seq_parallel(wav, n_devices=NSEQ, warmup=48,
                                  init_phase=jax_phase((404, 201), 0))
    assert [g.shape for g in got] == [r.shape for r in ref] == [(401 * 80,), (401, 80), (401, 201)]
    np.testing.assert_allclose(got[1], ref[1], atol=FWD_ATOL)
    np.testing.assert_allclose(got[2], ref[2], atol=FWD_ATOL)
    np.testing.assert_allclose(got[0], ref[0], atol=GL_ATOL)


def test_convert_seq_parallel_mesh_argument(pipes):  # noqa: F811
    """An explicit mesh gives the n_devices result; a mismatched count raises."""
    _, tp = pipes
    wav = 0.5 * _speechy_wav(1.0, seed=42)
    mesh = make_seq_mesh(2, devices=["cpu", "cpu"])
    a = tp.convert_seq_parallel(wav, mesh=mesh, warmup=24, seed=3)
    b = tp.convert_seq_parallel(wav, n_devices=2, warmup=24, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        tp.convert_seq_parallel(wav, n_devices=3, mesh=mesh)


@pytest.fixture(scope="module")
def stream_wavs():
    return np.stack([_speechy_wav(1.5, seed=30 + i) * (0.5 + 0.25 * i) for i in range(4)])


def test_stream_mesh_matches_jax(pipes, stream_wavs):  # noqa: F811
    """JAX tests/test_stream.py test_mesh_sharded_streams_match_unsharded:
    4 streams over a 4-device mesh, against the JAX mesh run and against the
    port's unsharded batch."""
    jp, tp = pipes
    jm = JMesh(np.array(jax.devices()[:NSEQ]), ("streams",))
    ref = JStream(jp, batch=4, seed=2, mesh=jm, **STREAM_KW).convert_all(stream_wavs)
    mesh = make_seq_mesh(NSEQ, devices=["cpu"] * NSEQ, axis_name="streams")
    got = TStream(tp, batch=4, seed=2, mesh=mesh, **STREAM_KW).convert_all(stream_wavs)
    base = TStream(tp, batch=4, seed=2, **STREAM_KW).convert_all(stream_wavs)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=WAV_TOL * np.abs(ref).max(), rtol=0)
    np.testing.assert_allclose(got, base, atol=FWD_ATOL, rtol=0)


def test_stream_mesh_two_rows_a_shard(pipes, stream_wavs):  # noqa: F811
    """Two streams on each of 2 shards, with a mid-run slot reset, against
    the unsharded batch."""
    _, tp = pipes

    def run(mesh):
        s = TStream(tp, batch=4, seed=5, mesh=mesh, collect_debug=True, **STREAM_KW)
        out = [s.push(stream_wavs[:, :12000])]
        s.reset_stream(3)
        out += [s.push(stream_wavs[:, 12000:]), s.flush()]
        return np.concatenate(out, axis=1), np.concatenate(s.debug_stft, axis=1)
    got, got_stft = run(make_seq_mesh(2, devices=["cpu"] * 2, axis_name="streams"))
    ref, ref_stft = run(None)
    np.testing.assert_allclose(got_stft, ref_stft, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=FWD_ATOL, rtol=0)


def test_stream_mesh_checks_match_jax(pipes):  # noqa: F811
    """batch=3 over 4 devices raises ValueError in both packages."""
    jp, tp = pipes
    jm = JMesh(np.array(jax.devices()[:NSEQ]), ("streams",))
    with pytest.raises(ValueError):
        JStream(jp, batch=3, mesh=jm, **STREAM_KW)
    with pytest.raises(ValueError):
        TStream(tp, batch=3, mesh=make_seq_mesh(NSEQ, devices=["cpu"] * NSEQ), **STREAM_KW)
