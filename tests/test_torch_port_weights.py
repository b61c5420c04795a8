"""Weight loading and the CLI of the PyTorch port, on the CPU.

Checkpoints written by the JAX package's ``Checkpointer`` are read by the
port's ``runtime.checkpoint``; both packages then compute the same outputs.
The port's ``apps.convert`` runs with ``--device cpu`` on a tiny config.
"""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_cloner_tpu.models import decoder as jdec
from speech_cloner_tpu.models import encoder as jenc
from speech_cloner_tpu.ops.features import FeatureConfig as JFeatureConfig
from speech_cloner_tpu.pipeline import clone as jclone
from speech_cloner_tpu.runtime.checkpoint import Checkpointer as JCheckpointer
from speech_cloner_tpu_torch.apps import convert as tconvert
from speech_cloner_tpu_torch.data.audio_io import load_audio, write_riff_wav
from speech_cloner_tpu_torch.models import decoder as tdec
from speech_cloner_tpu_torch.models import encoder as tenc
from speech_cloner_tpu_torch.pipeline.clone import make_pipeline
from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer, restore_params
from speech_cloner_tpu_torch.runtime.config import DEFAULT_DS_CFG, feature_config_from_cfg_d
from speech_cloner_tpu_torch.runtime.jax_params import encoder_from_jax

torch.set_num_threads(2)

ENC_CFG_D = {"input_shape": [48, 80], "n_output": 61, "embed_size": None,
             "num_conv_banks": 2, "num_highwaynet_blocks": 1, "dropout_rate": 0.4,
             "use_lstm": False}
DEC_CFG_D = {"input_shape": [48, 61], "dropout_rate": 0.1, "use_lstm": False,
             "steps_v": [{"embed_size": 32, "num_conv_banks": 2,
                          "num_highwaynet_blocks": 1, "n_output": 80},
                         {"embed_size": 48, "num_conv_banks": 2,
                          "num_highwaynet_blocks": 1, "n_output": 201}]}


def save_jax_checkpoints(root):
    enc_cfg = jenc.config_from_cfg_d(ENC_CFG_D)
    dec_cfg = jdec.config_from_cfg_d(DEC_CFG_D)
    trees = {}
    for name, mod, cfg, seed in (("encoder", jenc, enc_cfg, 1), ("decoder", jdec, dec_cfg, 2)):
        params, state = mod.init(jax.random.PRNGKey(seed), cfg)
        JCheckpointer(os.path.join(root, name), name).save(
            {"params": params, "model_state": state, "step": 7}, step=7, sync=True)
        trees[name] = (params, state)
    return enc_cfg, dec_cfg, trees


def sine(n, f=200.0):
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(2 * np.pi * 3 * f * t)).astype(np.float32)


def test_npz_round_trip_same_outputs(tmp_path):
    enc_cfg, dec_cfg, trees = save_jax_checkpoints(str(tmp_path))
    assert Checkpointer(str(tmp_path / "encoder"), "encoder").steps() == [7]
    params, state = restore_params(str(tmp_path / "encoder"), "encoder")
    x = np.random.default_rng(0).uniform(-1, 1, (2, 48, 80)).astype(np.float32)
    ref, _ = jenc.apply(*trees["encoder"], jnp.asarray(x), cfg=enc_cfg, train=False)
    model = encoder_from_jax(params, state, tenc.config_from_cfg_d(ENC_CFG_D))
    with torch.inference_mode():
        got = model(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    # the whole pipeline from both checkpoints against the JAX pipeline
    feat = JFeatureConfig(calc_mfcc_derivate=True)
    jp = jclone.ClonePipeline(enc_cfg=enc_cfg, dec_cfg=dec_cfg, feat_cfg=feat,
                              enc_params=trees["encoder"][0], enc_state=trees["encoder"][1],
                              dec_params=trees["decoder"][0], dec_state=trees["decoder"][1])
    tp = make_pipeline(tenc.config_from_cfg_d(ENC_CFG_D), tdec.config_from_cfg_d(DEC_CFG_D),
                       enc_ckpt=str(tmp_path / "encoder"), dec_ckpt=str(tmp_path / "decoder"),
                       device="cpu")
    wav = tp.pad_wav(sine(5000))
    ref = [np.asarray(a) for a in jp.device_predict(jnp.asarray(wav.numpy()))]
    with torch.inference_mode():
        got = tp.device_predict(wav)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5)


def test_npz_written_by_either_package_reads_in_the_other(tmp_path):
    """The port's Checkpointer.save is read by the JAX Checkpointer.restore and
    the other way round, leaf for leaf (lists, nested dicts, scalars), and the
    config lands beside the weights as the JAX trainers write it."""
    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "layers": [{"k": np.ones(2, np.float32)}, {"k": np.zeros(3, np.float32)}]},
            "model_state": {"mean": torch.full((4,), 0.5)}, "step": 9}
    path = Checkpointer(str(tmp_path / "port"), "decoder").save(tree, step=9, config={"n": 1})
    assert path.endswith("decoder-9.npz")
    assert json.loads((tmp_path / "port" / "decoder_cfg_d.json").read_text()) == {"n": 1}
    back, step = JCheckpointer(str(tmp_path / "port"), "decoder").restore()
    assert step == 9 and int(back["step"]) == 9
    np.testing.assert_array_equal(back["params"]["w"], tree["params"]["w"])
    assert [lay["k"].tolist() for lay in back["params"]["layers"]] == [[1, 1], [0, 0, 0]]
    np.testing.assert_array_equal(back["model_state"]["mean"], np.full(4, 0.5, np.float32))

    ck = JCheckpointer(str(tmp_path / "jax"), "decoder")
    ck.save({k: tree[k] for k in ("params", "step")}, step=4, sync=True)
    again, step = Checkpointer(str(tmp_path / "jax"), "decoder").restore()
    assert step == 4 and again["params"]["layers"][1]["k"].shape == (3,)
    np.testing.assert_array_equal(again["params"]["w"], tree["params"]["w"])


def test_checkpoint_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_params(str(tmp_path / "none"), "encoder")
    # a TF prefix is read as a bundle: it needs the config, and a bad index raises
    prefix = tmp_path / "encoder-136512"
    (tmp_path / "encoder-136512.index").write_bytes(b"")
    with pytest.raises(ValueError, match="needs the encoder's config"):
        restore_params(str(prefix), "encoder")
    with pytest.raises(ValueError, match="table footer"):
        restore_params(str(prefix), "encoder", tenc.config_from_cfg_d(ENC_CFG_D))
    save_jax_checkpoints(str(tmp_path))
    wrong = tenc.config_from_cfg_d({**ENC_CFG_D, "num_conv_banks": 3})
    with pytest.raises(ValueError, match="mismatch"):
        encoder_from_jax(*restore_params(str(tmp_path / "encoder"), "encoder"), wrong)


def test_convert_cli_cpu(tmp_path):
    save_jax_checkpoints(str(tmp_path))
    for name, d in (("enc.json", ENC_CFG_D), ("dec.json", DEC_CFG_D)):
        (tmp_path / name).write_text(json.dumps(d))
    src = str(tmp_path / "in.wav")
    write_riff_wav(src, sine(20000), 16000)
    out_dir = tmp_path / "out"
    tconvert.main(["--input", src, "--output-dir", str(out_dir),
                   "--enc-ckpt", str(tmp_path / "encoder"),
                   "--dec-ckpt", str(tmp_path / "decoder"),
                   "--enc-cfg", str(tmp_path / "enc.json"),
                   "--dec-cfg", str(tmp_path / "dec.json"),
                   "--n-iter", "4", "--device", "cpu"])
    with wave.open(str(out_dir / "in_pred.wav"), "rb") as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 16000)
        got = np.frombuffer(w.readframes(w.getnframes()), "<i2")

    # the same conversion through the API, written as the CLI writes it
    pipe = make_pipeline(tenc.config_from_cfg_d(ENC_CFG_D), tdec.config_from_cfg_d(DEC_CFG_D),
                         feature_config_from_cfg_d(DEFAULT_DS_CFG),
                         enc_ckpt=str(tmp_path / "encoder"), dec_ckpt=str(tmp_path / "decoder"),
                         device="cpu", n_iter=4, realse=1.2, gl_dft="matmul")
    y = pipe.convert(load_audio(src, 16000))[0]
    want = np.clip(y / np.abs(y).max() * 32767.0, -32768, 32767).astype("<i2")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flag", [["--target-spk", "x"], ["--save-true"], ["--verify-ckpt", "x"]])
def test_convert_cli_rejects_unported(tmp_path, flag, capsys):
    """The speaker-ID flags are ported, and what is refused before any work
    is their misuse: --target-spk without --verify-ckpt, a --verify-ckpt
    directory without a speaker-ID checkpoint (tests/test_torch_port_speaker.py
    runs them). --save-true is ported too (tests/test_torch_port_workflow.py
    runs it): with it the CLI passes its checks and stops at the missing
    input."""
    with pytest.raises(SystemExit) as e:
        tconvert.main(["--input", "x.wav", "--enc-ckpt", "x", "--device", "cpu", *flag])
    if flag[0] == "--save-true":
        assert "input file not found: x.wav" in str(e.value.code)
        return
    assert e.value.code == 2
    want = {"--target-spk": "needs --verify-ckpt", "--verify-ckpt": "no speaker_id checkpoint"}
    assert want[flag[0]] in capsys.readouterr().err


def test_riff_wav_round_trip(tmp_path):
    y = sine(1000)
    path = str(tmp_path / "a.wav")
    write_riff_wav(path, y, 8000, norm=False)
    back = load_audio(path, 8000)
    # int16 truncation plus the 32767-in/32768-out scale: under 2 LSB
    np.testing.assert_allclose(back, y, atol=2.0 / 32767)
    up = load_audio(path, 16000)                       # polyphase resampling
    assert up.shape == (2000,) and up.dtype == np.float32
    # mp3 is ported: a file that is not one raises the JAX package's error
    from speech_cloner_tpu.data.audio_io import load_audio as j_load_audio

    (tmp_path / "b.mp3").write_bytes(b"ID3 not audio")
    with pytest.raises(Exception) as ref:
        j_load_audio(str(tmp_path / "b.mp3"))
    with pytest.raises(type(ref.value)):
        load_audio(str(tmp_path / "b.mp3"))
