"""The port's data layer against the JAX package's, on tests/test_data.py's
synthetic TIMIT and ARCTIC trees: the same corpus, filters and splits,
features within 1e-5 (float32 front-ends: the port's torch one against the
JAX package's numpy one), and the same windows from the same seed out of
every sampler the trainers use. Each package reads the trees into a cache
directory of its own. Feature limits: 1e-5 for MFCC and mel_dB
(test_torch_port_dsp.py's ``test_mfcc_input_match``); power_dB 5e-4 (0.05
dB), because the fixtures are pure tones whose far bins sit at float32's FFT
noise floor, where the port's float32 FFT and the numpy front-end's differ
in log10, with 99% of its values within that test's 5e-5 (99.5% measured); phone targets
and indices exact."""

import os

import numpy as np
import pytest
from test_data import _make_arctic_tree, _make_timit_tree, _tone

from speech_cloner_tpu.data import audio_io as jaudio
from speech_cloner_tpu.data.arctic import ARCTIC as JARCTIC
from speech_cloner_tpu.data.timit import TIMIT as JTIMIT
from speech_cloner_tpu.ops.features import FeatureConfig as JFeatureConfig
from speech_cloner_tpu.ops.features import phn_frame_targets as j_phn_frame_targets
from speech_cloner_tpu_torch.data import audio_io
from speech_cloner_tpu_torch.data.arctic import ARCTIC
from speech_cloner_tpu_torch.data.dataset import feature_cache_key
from speech_cloner_tpu_torch.data.timit import TIMIT
from speech_cloner_tpu_torch.ops.features import FeatureConfig, phn_frame_targets

FEAT = dict(hop_length=80, win_length=400, n_mels=20, n_mfcc=10, calc_mfcc_derivate=True)
T = 40
FEAT_TOL = {"mfcc": 1e-5, "mel_dB": 1e-5, "power_dB": 5e-4, "phn": 0.0, "idxs": 0.0}


def assert_feature_close(got, ref, name):
    np.testing.assert_allclose(got, ref, atol=FEAT_TOL[name], err_msg=name)
    if name == "power_dB":
        assert (np.abs(got - ref) <= 5e-5).mean() >= 0.99


def pair(kind, root, tmp_path):
    jcls, tcls = (JTIMIT, TIMIT) if kind == "timit" else (JARCTIC, ARCTIC)
    j = jcls(root, JFeatureConfig(**FEAT), n_timesteps=T, seed=0,
             cache_dir=str(tmp_path / "jax"))
    t = tcls(root, FeatureConfig(**FEAT), n_timesteps=T, seed=0,
             cache_dir=str(tmp_path / "port"))
    j.build_spec_cache()
    t.build_spec_cache()
    return j, t


@pytest.fixture(scope="module")
def timit(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("timit_tree"))
    _make_timit_tree(root)
    return pair("timit", root, tmp_path_factory.mktemp("timit_caches"))


@pytest.fixture(scope="module")
def arctic(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("arctic_tree"))
    _make_arctic_tree(root)
    return pair("arctic", root, tmp_path_factory.mktemp("arctic_caches"))


def assert_same_corpus(j, t):
    assert set(j.ds) == set(t.ds)
    for k in j.ds:
        for a, b in zip(j.ds[k], t.ds[k]):
            if k == "wav":
                np.testing.assert_allclose(b, a, atol=1e-6)
            else:
                assert a == b if not isinstance(a, np.ndarray) else np.array_equal(a, b), k
    assert (j.phn2idx, j.n_phn) == (t.phn2idx, t.n_phn)


def assert_same_batches(jit, tit, streams):
    n = 0
    for jb, tb in zip(jit, tit, strict=True):
        assert len(jb) == len(tb) == len(streams)
        for a, b, name in zip(jb, tb, streams):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert_feature_close(b, a, name)
        n += 1
    assert n > 0


@pytest.mark.parametrize("kind", ["timit", "arctic"])
def test_corpus_and_features_match(kind, timit, arctic):
    j, t = timit if kind == "timit" else arctic
    assert_same_corpus(j, t)
    assert os.path.basename(t.spec_cache_path()) == f"spec_cache_{feature_cache_key(t.feat_cfg)}.npz"
    for i in range(len(j.ds["wav"])):
        a, b = j.get_spec(i), t.get_spec(i)
        assert set(a) == set(b) == {"mfcc", "mel_dB", "power_dB", "phn"}
        for name in a:
            assert_feature_close(b[name], a[name], name)


def test_timit_filters_splits_and_windows(timit):
    j, t = timit
    for f in (None, {"ds_type": "TRAIN"}, {"spk_id": ["ABC0", "DEF0"], "ds_type": "TEST"},
              {"ds_type": "TRAIN", "split_d": {"split_key": "spk_d", "split_type": "val",
                                               "split_props_v": [0.5, 0.75]}}):
        np.testing.assert_array_equal(t.get_ds_filter(f), j.get_ds_filter(f))
    assert t.get_n_windows(0.3, {"ds_type": "TRAIN"}) == j.get_n_windows(0.3, {"ds_type": "TRAIN"})
    one_hot = np.eye(61, dtype=np.float32)[[0, 7, 7, 60, 7]]
    np.testing.assert_array_equal(t.conv_61phn_to_39phn(one_hot), j.conv_61phn_to_39phn(one_hot))


@pytest.mark.parametrize("skip_short", [True, False])
def test_timit_window_sampler_same_windows(timit, skip_short):
    """The encoder trainer's sampler: same permutation and crops, two passes."""
    j, t = timit
    kw = dict(batch_size=2, n_epochs=2, ds_filter_d={"ds_type": "TRAIN"}, yield_idxs=True,
              skip_short=skip_short, pad_phn=None if skip_short else "h#")
    j.rng, t.rng = np.random.default_rng(3), np.random.default_rng(3)
    assert_same_batches(j.window_sampler(**kw), t.window_sampler(**kw), ("mfcc", "phn", "idxs"))


@pytest.mark.parametrize("sample_trn", [True, False])
def test_arctic_spec_window_sampler_same_windows(arctic, sample_trn):
    """The decoder trainer's sampler (mfcc, mel_dB, power_dB windows) and the
    ARCTIC window sampler with its 'pau' padding."""
    j, t = arctic
    kw = dict(batch_size=2, n_epochs=2, sample_trn=sample_trn, prop_val=0.34,
              ds_filter_d={"spk_id": ["slt", "bdl"]}, yield_idxs=True)
    j.rng, t.rng = np.random.default_rng(4), np.random.default_rng(4)
    assert_same_batches(j.spec_window_sampler(**kw), t.spec_window_sampler(**kw),
                        ("mfcc", "mel_dB", "power_dB", "idxs"))
    assert_same_batches(j.window_sampler(**kw), t.window_sampler(**kw), ("mfcc", "phn", "idxs"))


def test_nist_sphere_and_riff_read_alike(tmp_path):
    y = _tone(2000)
    for big in (False, True):
        pcm = (y * 32767).astype(">i2" if big else "<i2").tobytes()
        header = ("NIST_1A\n   1024\nsample_rate -i 16000\nchannel_count -i 1\n"
                  f"sample_n_bytes -i 2\nsample_byte_format -s2 {'10' if big else '01'}\n"
                  "sample_coding -s3 pcm\nend_head\n").encode("ascii")
        p = str(tmp_path / f"s{int(big)}.WAV")
        with open(p, "wb") as f:
            f.write(header + b" " * (1024 - len(header)) + pcm)
        got, sr = audio_io.read_nist_sphere(p)
        ref, _ = jaudio.read_nist_sphere(p)
        assert sr == 16000
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(audio_io.load_audio(p, 8000), jaudio.load_audio(p, 8000))
    # mp3 is ported: a file that is not one raises the JAX package's error
    with open(tmp_path / "x.mp3", "wb") as f:
        f.write(b"ID3....")
    with pytest.raises(Exception) as ref:
        jaudio.load_audio(str(tmp_path / "x.mp3"))
    with pytest.raises(type(ref.value)):
        audio_io.load_audio(str(tmp_path / "x.mp3"))


def test_phn_frame_targets_match():
    phn = [(0, 900, "sh"), (900, 2400, "iy"), (2400, 2410, "q"), (2410, 4000, "h#")]
    idx = {"sh": 0, "iy": 1, "q": 2, "h#": 3}
    for n, hop, win in ((4000, 80, 400), (3999, 160, 400), (4100, 80, 200)):
        np.testing.assert_array_equal(phn_frame_targets(n, phn, idx, hop, win),
                                      j_phn_frame_targets(n, phn, idx, hop, win))
