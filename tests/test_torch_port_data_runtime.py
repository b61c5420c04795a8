"""The port's data runtime against the JAX package's: the synthetic corpus,
the packed cache and its host library, the device-resident store's gather
and samplers, the target-speaker reader, the TIMIT frame and phoneme
samplers, mp3 decoding and the spectrogram pictures.

Limits: what is computed alike is compared exactly (the synthesizer's
waves and files byte for byte, the .sclpack bytes, the gathered windows,
every sampler's indices and starts, the PCM decoders); features computed by
the two front-ends (the port's torch one against the JAX package's numpy
one) within test_torch_port_data.py's limits (1e-5; power_dB 5e-4 on pure
tones).
"""

import ast
import filecmp
import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from test_data import _make_timit_tree, _tone
from test_torch_port_data import FEAT, T, assert_feature_close

from speech_cloner_tpu.data import audio_io as jaudio
from speech_cloner_tpu.data import device_dataset as jdd
from speech_cloner_tpu.data import packed_cache as jpc
from speech_cloner_tpu.data import synth_corpus as jsc
from speech_cloner_tpu.data.target_spk import TargetSpeaker as JTargetSpeaker
from speech_cloner_tpu.data.timit import TIMIT as JTIMIT
from speech_cloner_tpu.ops.features import FeatureConfig as JFeatureConfig
from speech_cloner_tpu_torch.data import audio_io, device_dataset, packed_cache, synth_corpus, viz
from speech_cloner_tpu_torch.data.target_spk import TargetSpeaker
from speech_cloner_tpu_torch.data.timit import TIMIT
from speech_cloner_tpu_torch.ops.features import FeatureConfig

ROOT = Path(__file__).resolve().parent.parent


def test_synth_utterance_and_trees_match_jax(tmp_path):
    for prof in (jsc.TARGET_PROFILE, jsc.SOURCE_PROFILE):
        for seed in (0, 5):
            got_w, got_s = synth_corpus.synth_utterance(np.random.default_rng(seed), prof,
                                                        n_phones=8)
            ref_w, ref_s = jsc.synth_utterance(np.random.default_rng(seed), prof, n_phones=8)
            assert got_w.dtype == ref_w.dtype
            np.testing.assert_array_equal(got_w, ref_w)
            assert got_s == ref_s
    for pkg, name in ((synth_corpus, "port"), (jsc, "jax")):
        spk = pkg.make_timit_tree(str(tmp_path / name / "timit"), n_train_spk=2, n_test_spk=1,
                                  n_utts=2, n_phones=6, seed=3)
        assert "FSLT0" in spk and "MBDL0" in spk
        pkg.make_arctic_tree(str(tmp_path / name / "arctic"), n_utts=2, n_phones=6, seed=4)
    cmp = filecmp.dircmp(tmp_path / "port", tmp_path / "jax")

    def same(c):
        return (not c.left_only and not c.right_only and not c.diff_files and not c.funny_files
                and all(same(s) for s in c.subdirs.values()))
    files = [p for p in (tmp_path / "port").rglob("*") if p.is_file()]
    assert len(files) == 5 * 2 * 4 + 2 * 2 * 2
    assert all(filecmp.cmp(p, tmp_path / "jax" / p.relative_to(tmp_path / "port"),
                           shallow=False) for p in files)
    assert same(cmp)


def random_utts(seed=0, n=5, streams=(("a", 3), ("b", 7))):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        frames = int(rng.integers(5, 40))
        out.append({s: rng.standard_normal((frames, d)).astype(np.float32) for s, d in streams})
    return out


def test_write_pack_matches_jax(tmp_path):
    utts = random_utts()
    packed_cache.write_pack(str(tmp_path / "p.sclpack"), utts, ["a", "b"])
    jpc.write_pack(str(tmp_path / "j.sclpack"), utts, ["a", "b"])
    assert (tmp_path / "p.sclpack").read_bytes() == (tmp_path / "j.sclpack").read_bytes()
    with pytest.raises(ValueError, match="frame count"):
        packed_cache.write_pack(str(tmp_path / "x.sclpack"),
                                [{"a": np.zeros((3, 1)), "b": np.zeros((4, 1))}], ["a", "b"])


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_packed_reader_matches_jax(tmp_path, native):
    """gather (starts past the end zero-fill, as short utterances do) and
    packed_window_sampler, against the JAX reader of the same kind."""
    utts = random_utts(seed=1, n=9)
    path = str(tmp_path / "p.sclpack")
    packed_cache.write_pack(path, utts, ["a", "b"])
    with packed_cache.PackedReader(path, n_threads=3, use_native=native) as r:
        ref = jpc.PackedReader(path, n_threads=3, use_native=native)
        try:
            assert r.native == native and ref.native == native
            assert (r.n_utts, r.n_streams, list(r.dims)) == (ref.n_utts, ref.n_streams,
                                                             list(ref.dims))
            np.testing.assert_array_equal(r.n_frames, ref.n_frames)
            u = np.array([0, 3, 8, 8, 2], np.int32)
            s = np.array([0, 2, 1, 30, 0], np.int32)
            for stream in (0, 1):
                got = r.gather(u, s, 12, stream)
                np.testing.assert_array_equal(got, ref.gather(u, s, 12, stream))
                np.testing.assert_array_equal(got[0, :min(12, len(utts[0]["ab"[stream]]))],
                                              utts[0]["ab"[stream]][:12])
            kw = dict(batch_size=2, n_timesteps=10, streams=(1, 0), n_epochs=2)
            got_b = list(packed_cache.packed_window_sampler(r, rng=np.random.default_rng(4), **kw))
            ref_b = list(jpc.packed_window_sampler(ref, rng=np.random.default_rng(4), **kw))
            assert len(got_b) == len(ref_b) == 8
            for g, e in zip(got_b, ref_b):
                for a, b in zip(g, e):
                    np.testing.assert_array_equal(a, b)
        finally:
            ref.close()


def write_sphere(path, pcm: bytes, channels=1, big=False, width=2):
    header = ("NIST_1A\n   1024\nsample_rate -i 16000\n"
              f"channel_count -i {channels}\nsample_n_bytes -i {width}\n"
              f"sample_byte_format -s2 {'10' if big else '01'}\n"
              "sample_coding -s3 pcm\nend_head\n").encode("ascii")
    Path(path).write_bytes(header + b" " * (1024 - len(header)) + pcm)


def write_riff(path, pcm: bytes, channels=1, rate=16000, width=2):
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm)


def test_native_decode_pcm_matches_jax(tmp_path):
    """The host library's RIFF and SPHERE decoding (mono, stereo,
    big-endian) against the JAX package's, and load_audio through it
    against the JAX load_audio; a file the library does not decode (8-bit
    PCM) gives None and load_audio reads it in Python, as JAX does."""
    y = _tone(3000)
    mono = (y * 32767).astype("<i2")
    stereo = np.stack([mono, (mono // 3)], axis=1).astype("<i2")
    files = {"riff_mono.wav": lambda p: write_riff(p, mono.tobytes()),
             "riff_stereo.wav": lambda p: write_riff(p, stereo.tobytes(), channels=2,
                                                     rate=8000),
             "sph_le.WAV": lambda p: write_sphere(p, mono.tobytes()),
             "sph_be.WAV": lambda p: write_sphere(p, mono.astype(">i2").tobytes(), big=True),
             "sph_stereo.WAV": lambda p: write_sphere(p, stereo.tobytes(), channels=2)}
    for name, write in files.items():
        p = str(tmp_path / name)
        write(p)
        got, ref = packed_cache.native_decode_pcm(p), jpc.native_decode_pcm(p)
        assert got[1] == ref[1]
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(audio_io.load_audio(p, 16000), jaudio.load_audio(p, 16000))
    # 8-bit PCM: the port's library refuses it (it reads the RIFF bits per
    # sample) and load_audio reads it in Python; the JAX package's library
    # reads any RIFF as 16-bit, so its native load_audio is compared with
    # its Python readers here (ROADMAP queue 3)
    p8 = str(tmp_path / "u8.wav")
    write_riff(p8, (y * 127 + 128).astype(np.uint8).tobytes(), width=1)
    assert packed_cache.native_decode_pcm(p8) is None
    ref8 = jaudio.load_audio(p8, 16000, use_native=False)
    np.testing.assert_array_equal(audio_io.load_audio(p8, 16000), ref8)
    np.testing.assert_array_equal(audio_io.load_audio(p8, 16000, use_native=False), ref8)
    np.testing.assert_allclose(ref8, y, atol=2.0 / 127)


def test_host_library_is_the_ports_own():
    """The library is built from speech_cloner_tpu_torch/csrc/scl_data.cc into
    build/torch_kernels/ under the source's digest, and no module of the
    port names the JAX package's native/ directory or its library."""
    lib = packed_cache.load_native()
    so = Path(lib._name)
    assert so.parent == ROOT / "build" / "torch_kernels"
    assert so.name.startswith("libscl_data_") and so.exists()
    assert packed_cache._SRC == ROOT / "speech_cloner_tpu_torch" / "csrc" / "scl_data.cc"
    bad = []
    for path in sorted((ROOT / "speech_cloner_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and (
                    "native/" in node.value or "/native" in node.value
                    or node.value in ("libscl_data.so", "Makefile")):
                bad.append(f"{path.name}:{node.lineno} {node.value!r}")
    assert bad == []


@pytest.fixture
def store():
    rng = np.random.default_rng(2)
    lens = [7, 30, 12, 45, 3]
    cols = [[rng.standard_normal((n, c)).astype(np.float32) for n in lens] for c in (4, 9)]
    return cols


def test_gather_windows_matches_jax(store):
    """Starts near the end (JAX's dynamic_slice clamps them to F_max - T),
    short utterances read the zero padding; bit for bit."""
    got = device_dataset.DeviceWindows(store, T=10, device="cpu")
    ref = jdd.DeviceWindows(store, T=10)
    assert got.nbytes == ref.nbytes == 4 * 5 * 45 * (4 + 9)
    np.testing.assert_array_equal(got.n_frames, ref.n_frames)
    u = np.array([0, 1, 3, 3, 4, 2], np.int32)
    s = np.array([0, 25, 35, 44, 0, 5], np.int32)
    for g, r in zip(got.gather(u, s), ref.gather(u, s)):
        assert g.shape == (6, 10, r.shape[2]) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the clamp: a start past F_max - T reads the last T frames
    np.testing.assert_array_equal(got.gather(u[3:4], s[3:4])[0][0].numpy(), store[0][3][35:45])
    np.testing.assert_array_equal(got.gather(u[:1], s[:1])[1][0, 7:].numpy(), 0.0)
    st = [torch.as_tensor(np.array(a)) for a in ref.streams]
    for g, r in zip(device_dataset.gather_windows(st, torch.as_tensor(u), torch.as_tensor(s), 10),
                    jdd.gather_windows(ref.streams, u, s, 10)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_index_and_file_batch_samplers_match_jax(store):
    got = device_dataset.DeviceWindows(store, T=10, device="cpu")
    ref = jdd.DeviceWindows(store, T=10)
    samples = np.array([0, 1, 2, 3, 4])
    for method, kw in (("index_sampler", {}), ("file_batch_sampler", {}),
                       ("index_sampler", {"randomize": False})):
        a = list(getattr(got, method)(samples, 2, n_epochs=3, rng=np.random.default_rng(8), **kw))
        b = list(getattr(ref, method)(samples, 2, n_epochs=3, rng=np.random.default_rng(8), **kw))
        assert len(a) == len(b) > 0
        for (ua, sa), (ub, sb) in zip(a, b):
            assert ua.dtype == sa.dtype == np.int32
            np.testing.assert_array_equal(ua, ub)
            np.testing.assert_array_equal(sa, sb)


def test_from_npz_holds_the_cache(tmp_path):
    arrays = {f"{s}/{i}": np.full((3 + i, d), i, np.float32)
              for i in range(3) for s, d in (("mfcc", 2), ("phn", 5))}
    np.savez(tmp_path / "c.npz", **arrays)
    dw = device_dataset.from_npz(str(tmp_path / "c.npz"), ("mfcc", "phn"), np.array([2, 0]),
                                 T=4, device="cpu")
    assert [tuple(s.shape) for s in dw.streams] == [(2, 5, 2), (2, 5, 5)]
    np.testing.assert_array_equal(dw.n_frames, [5, 3])
    np.testing.assert_array_equal(dw.streams[1][1, :3].numpy(), 0.0)
    np.testing.assert_array_equal(dw.streams[0][0].numpy(), 2.0)


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    """An audiobook-style directory: 5 noise files of 0.5-1.3 s (one under a
    40-frame window), an excluded one and a text file."""
    root = tmp_path_factory.mktemp("book")
    rng = np.random.default_rng(1)
    for i, sec in enumerate((0.9, 1.3, 0.15, 0.5, 1.1)):
        y = (0.2 * rng.standard_normal(int(16000 * sec))).astype(np.float32)
        jaudio.write_riff_wav(str(root / f"c{i}.wav"), y, 16000)
    jaudio.write_riff_wav(str(root / "skip_me.wav"), np.ones(800, np.float32), 16000)
    (root / "notes.txt").write_text("not audio")
    return root


def test_target_speaker_matches_jax(book, tmp_path):
    """File list, lengths, features and the one-file-per-batch windows (from
    the sequential head/tail split) against the JAX reader."""
    kw = dict(n_timesteps=T, seed=3, exclude_files_with=("skip",))
    got = TargetSpeaker(str(book), FeatureConfig(**FEAT), cache_dir=str(tmp_path / "p"), **kw)
    ref = JTargetSpeaker(str(book), JFeatureConfig(**FEAT), cache_dir=str(tmp_path / "j"), **kw)
    assert list(got.ds["name"]) == list(ref.ds["name"]) == [f"c{i}.wav" for i in range(5)]
    np.testing.assert_array_equal(got.ds["len"], ref.ds["len"])
    for a, b in zip(got.ds["wav"], ref.ds["wav"]):
        np.testing.assert_array_equal(a, b)
    got.build_spec_cache()
    ref.build_spec_cache()
    for sample_trn in (True, False):
        a = list(got.spec_window_sampler(batch_size=3, n_epochs=2, sample_trn=sample_trn,
                                         prop_val=0.4, yield_idxs=True))
        b = list(ref.spec_window_sampler(batch_size=3, n_epochs=2, sample_trn=sample_trn,
                                         prop_val=0.4, yield_idxs=True))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[3], y[3])
            assert len(set(x[3][:, -1])) == 1            # one file per batch
            for name, g, r in zip(("mfcc", "mel_dB", "power_dB"), x[:3], y[:3]):
                assert_feature_close(g, r, name)


@pytest.fixture(scope="module")
def timit_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("timit_rt")
    _make_timit_tree(str(root))
    got = TIMIT(str(root), FeatureConfig(**FEAT), cache_dir=str(root / "p"), n_timesteps=T,
                seed=5)
    ref = JTIMIT(str(root), JFeatureConfig(**FEAT), cache_dir=str(root / "j"), n_timesteps=T,
                 seed=5)
    got.build_spec_cache()
    ref.build_spec_cache()
    return got, ref


def test_frame_and_phoneme_samplers_match_jax(timit_pair):
    got, ref = timit_pair
    got.make_phoneme_conversion_dicts()
    assert got.phn2idx == ref.phn2idx and got.n_phn == ref.n_phn == 61
    a = list(got.frame_sampler(batch_size=50, n_epochs=2))
    b = list(ref.frame_sampler(batch_size=50, n_epochs=2))
    assert len(a) == len(b) > 10
    for (x, y), (xr, yr) in zip(a, b):
        assert_feature_close(x, xr, "mfcc")
        np.testing.assert_array_equal(y, yr)
    for kw in ({}, {"ds_filter_d": {"ds_type": "TEST"}, "randomize": False, "n_padd": 500}):
        a = list(got.phoneme_sampler(batch_size=3, n_epochs=2, **kw))
        b = list(ref.phoneme_sampler(batch_size=3, n_epochs=2, **kw))
        assert len(a) == len(b) > 0
        for (x, y), (xr, yr) in zip(a, b):
            np.testing.assert_array_equal(x, xr)
            np.testing.assert_array_equal(y, yr)


def test_packed_spec_window_sampler_matches_jax(timit_pair):
    """The dataset's packed sampler (the .sclpack mirror of each package's
    own cache) cuts the JAX windows from the same seed."""
    got, ref = timit_pair
    got.rng, ref.rng = np.random.default_rng(9), np.random.default_rng(9)
    pack = got.build_packed_cache()
    assert pack.endswith(".sclpack") and os.path.exists(pack)
    with packed_cache.PackedReader(pack, use_native=False) as r:
        assert r.n_streams == 4 and r.dims[3] == 61
    kw = dict(batch_size=2, n_epochs=2, prop_val=0.25, ds_filter_d={"ds_type": "TRAIN"})
    a = list(got.packed_spec_window_sampler(**kw))
    b = list(ref.packed_spec_window_sampler(**kw))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for name, g, r in zip(("mfcc", "mel_dB", "power_dB"), x, y):
            assert_feature_close(g, r, name)


def test_can_decode_mp3_matches_jax(tmp_path):
    """Where libmpg123 or ffmpeg is present both packages say so; a file that
    is not mp3 raises the JAX package's error type in both."""
    assert audio_io.can_decode_mp3() == jaudio.can_decode_mp3()
    bad = tmp_path / "x.mp3"
    bad.write_bytes(b"ID3 not audio")
    with pytest.raises(Exception) as ref:
        jaudio.load_audio(str(bad))
    with pytest.raises(type(ref.value)):
        audio_io.load_audio(str(bad))


def test_mpg123_decode_matches_jax():
    """An mp3 through libmpg123 in both packages: the reference's narration
    clip, the JAX package's own mp3 test's file (skips where that test
    skips, without the clip)."""
    from speech_cloner_tpu.apps.make_narrator_corpus import DEFAULT_CLIP as mp3

    if not os.path.exists(mp3):
        pytest.skip("reference demo mp3 absent")
    if not audio_io.can_decode_mp3():
        pytest.skip("no libmpg123")
    np.testing.assert_array_equal(audio_io.read_via_mpg123(mp3)[0], jaudio.read_via_mpg123(mp3)[0])


def test_spec_comparison_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    mel, stft = rng.random((40, 20)), rng.random((40, 201))
    viz.spec_comparison(mel, mel * 0.5, stft, stft * 0.5, save_path=str(tmp_path / "s.png"))
    viz.spec_show(stft, phn_v=np.eye(3)[np.repeat([0, 1, 2], 14)[:40]],
                  idx2phn={0: "a", 1: "b", 2: "c"}, save_path=str(tmp_path / "t.png"))
    for name in ("s.png", "t.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_sclpack_header_layout(tmp_path):
    """The header fields the C++ library reads: magic, counts, dims, frames,
    offsets (the first block right after the header)."""
    utts = random_utts(seed=3, n=2)
    path = tmp_path / "h.sclpack"
    packed_cache.write_pack(str(path), utts, ["a", "b"])
    raw = path.read_bytes()
    assert raw[:8] == b"SCLPACK1" and struct.unpack("<II", raw[8:16]) == (2, 2)
    assert struct.unpack("<2I", raw[16:24]) == (3, 7)
    frames = struct.unpack("<2I", raw[24:32])
    offsets = struct.unpack("<2Q", raw[32:48])
    assert frames == tuple(len(u["a"]) for u in utts) and offsets[0] == 48
    assert len(raw) == 48 + 4 * 10 * sum(frames)
