"""TF checkpoint bundles in the PyTorch port, against the JAX package, on the CPU.

Bundles are written by TensorFlow's own TF1 ``Saver`` with the reference's
variable names (the recipe of tests/test_tf_parity.py). The port's
``runtime/tf_bundle.py`` + ``tf_import.py`` must give the JAX importer's trees
bit for bit, the models built from them the JAX outputs (within 1e-5 of each
output's peak: float32 in another summation order), and ``make_pipeline``, ``apps.convert`` and
``apps.serve`` must take a TF prefix wherever they take an ``.npz`` directory.
"""

import json
import wave

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_tf_parity import _save_tf1_ckpt, _stack_var_values  # noqa: E402
from test_torch_port_serve import run_server  # noqa: E402
from test_torch_port_weights import DEC_CFG_D, ENC_CFG_D, sine  # noqa: E402

from speech_cloner_tpu.models import decoder as jdec  # noqa: E402
from speech_cloner_tpu.models import encoder as jenc  # noqa: E402
from speech_cloner_tpu.ops.features import FeatureConfig as JFeatureConfig  # noqa: E402
from speech_cloner_tpu.pipeline import clone as jclone  # noqa: E402
from speech_cloner_tpu.runtime import tf_bundle as jbundle  # noqa: E402
from speech_cloner_tpu.runtime import tf_import as jimport  # noqa: E402
from speech_cloner_tpu_torch.apps import convert as tconvert  # noqa: E402
from speech_cloner_tpu_torch.data.audio_io import write_riff_wav  # noqa: E402
from speech_cloner_tpu_torch.models import decoder as tdec  # noqa: E402
from speech_cloner_tpu_torch.models import encoder as tenc  # noqa: E402
from speech_cloner_tpu_torch.pipeline.clone import make_pipeline  # noqa: E402
from speech_cloner_tpu_torch.runtime import tf_bundle as tbundle  # noqa: E402
from speech_cloner_tpu_torch.runtime import tf_import as timport  # noqa: E402
from speech_cloner_tpu_torch.runtime.jax_params import (  # noqa: E402
    decoder_from_jax,
    encoder_from_jax,
)

torch.set_num_threads(2)
J_ENC, J_DEC = jenc.config_from_cfg_d(ENC_CFG_D), jdec.config_from_cfg_d(DEC_CFG_D)
T_ENC, T_DEC = tenc.config_from_cfg_d(ENC_CFG_D), tdec.config_from_cfg_d(DEC_CFG_D)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """encoder-11 and decoder-22 TF1 bundles at the tiny geometry."""
    root = tmp_path_factory.mktemp("tf_bundles")
    rng = np.random.default_rng(7)
    enc = _stack_var_values(rng, "encoder", 80, 80, 2, 1, 61)
    enc["opt/global_step"] = np.asarray(11, np.int64)
    enc["opt/learning_rate"] = np.asarray(3e-4, np.float32)
    dec = {**_stack_var_values(rng, "decoder/step1", 61, 32, 2, 1, 80),
           **_stack_var_values(rng, "decoder/step2", 80, 48, 2, 1, 201)}
    # the recipe's weights (normal, scale 0.3) put the linear spectrogram near
    # 5, where its dB denorm overflows float32 in the vocoder: scale it down
    dec["decoder/step2/y_logits/kernel"] *= 0.1
    for name, values in (("encoder-11", enc), ("decoder-22", dec)):
        _save_tf1_ckpt(values, str(root / name))
    (root / "enc.json").write_text(json.dumps(ENC_CFG_D))
    (root / "dec.json").write_text(json.dumps(DEC_CFG_D))
    return {"root": root, "enc": str(root / "encoder-11"), "dec": str(root / "decoder-22")}


def leaves_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            leaves_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            leaves_equal(x, y, f"{path}/{i}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


def test_bundle_reader_matches_jax_and_tf(bundles):
    for prefix in (bundles["enc"], bundles["dec"]):
        mine, ref = tbundle.BundleReader(prefix), jbundle.BundleReader(prefix)
        tf_reader = tf.train.load_checkpoint(prefix)
        names = mine.get_variable_to_shape_map()
        assert names == ref.get_variable_to_shape_map()
        assert set(names) == set(tf_reader.get_variable_to_shape_map())
        for name in names:
            got = mine.get_tensor(name)
            np.testing.assert_array_equal(got, ref.get_tensor(name), err_msg=name)
            np.testing.assert_array_equal(got, tf_reader.get_tensor(name), err_msg=name)


def test_tf_import_trees_bit_for_bit(bundles):
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    leaves_equal(timport.load_tf_encoder(bundles["enc"], T_ENC),
                 tree(jimport.load_tf_encoder(bundles["enc"], J_ENC)))
    leaves_equal(timport.load_tf_decoder(bundles["dec"], T_DEC),
                 tree(jimport.load_tf_decoder(bundles["dec"], J_DEC)))
    got = timport.load_tf_scalars(bundles["enc"])
    assert set(got) == {"global_step", "learning_rate"}
    leaves_equal(got, jimport.load_tf_scalars(bundles["enc"]))


def test_tf_models_same_outputs(bundles):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 48, 80)).astype(np.float32)
    ppg = np.abs(rng.standard_normal((2, 48, 61))).astype(np.float32) * 0.2
    j_enc = jimport.load_tf_encoder(bundles["enc"], J_ENC)
    j_dec = jimport.load_tf_decoder(bundles["dec"], J_DEC)
    ref_logits, _ = jenc.apply(*j_enc, jnp.asarray(x), cfg=J_ENC, train=False)
    ref_mel, ref_stft, _ = jdec.apply(*j_dec, jnp.asarray(ppg), cfg=J_DEC, train=False)
    enc = encoder_from_jax(*timport.load_tf_encoder(bundles["enc"], T_ENC), T_ENC)
    dec = decoder_from_jax(*timport.load_tf_decoder(bundles["dec"], T_DEC), T_DEC)
    with torch.inference_mode():
        logits = enc(torch.tensor(x))
        mel, stft = dec(torch.tensor(ppg))
    # float32 in another summation order: 1e-5 of each output's peak (the
    # recipe's weights make outputs of up to ~5, where glorot's stay near 1)
    for g, r in ((logits, ref_logits), (mel, ref_mel), (stft, ref_stft)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * np.abs(r).max())


def test_make_pipeline_reads_tf_prefix(bundles):
    jp = jclone.make_pipeline(J_ENC, J_DEC, JFeatureConfig(calc_mfcc_derivate=True),
                              enc_ckpt=bundles["enc"], dec_ckpt=bundles["dec"])
    tp = make_pipeline(T_ENC, T_DEC, enc_ckpt=bundles["enc"], dec_ckpt=bundles["dec"],
                       device="cpu")
    wav = tp.pad_wav(sine(2 * 3840 + 100))
    ref = [np.asarray(a) for a in jp.device_predict(jnp.asarray(wav.numpy()))]
    with torch.inference_mode():
        got = tp.device_predict(wav)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * np.abs(r).max())


def test_apps_take_tf_prefix(bundles, tmp_path, monkeypatch, capsys):
    root = bundles["root"]
    src = str(tmp_path / "in.wav")
    write_riff_wav(src, sine(6000), 16000)
    ckpts = ["--enc-ckpt", bundles["enc"], "--dec-ckpt", bundles["dec"],
             "--enc-cfg", str(root / "enc.json"), "--dec-cfg", str(root / "dec.json"),
             "--n-iter", "3", "--device", "cpu"]
    tconvert.main(["--input", src, "--output-dir", str(tmp_path / "c"), *ckpts])
    with wave.open(str(tmp_path / "c" / "in_pred.wav"), "rb") as w:
        converted = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    recs = run_server([*ckpts, "--output-dir", str(tmp_path / "s"), "--max-requests", "1"],
                      monkeypatch, capsys, src + "\n")
    assert len(recs) == 1 and "error" not in recs[0], recs
    with wave.open(recs[0]["output"], "rb") as w:
        served = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    # the server's convert_pcm16 and the CLI's convert agree to 1 LSB
    assert served.shape == converted.shape and np.abs(served).max() == 32767
    assert np.abs(served.astype(np.int32) - converted.astype(np.int32)).max() <= 1
