"""The rest of the PyTorch port against the JAX package, on the CPU.

The attention module (``nn/attention.py``: the embedding and the Bahdanau
attention decoder, trees carried by ``runtime/jax_params.py``), the
profiler helpers on the CPU, the narrator-corpus and real-voice demo apps,
and the small API pieces (``runtime/config``'s ``make_dir_path``,
``show_diff``, ``save_cfg_d``; ``ops.inv_preemphasis_np``; playback in
``data/viz`` and the datasets). The same numpy inputs and trees go through
both packages; float32 limits 1e-5, files and JSON bytes equal.
"""

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_weights import DEC_CFG_D, ENC_CFG_D
from test_torch_port_workflow import jax_phases  # noqa: F401  (fixture)

from speech_cloner_tpu.data import dataset as jdataset
from speech_cloner_tpu.data import viz as jviz
from speech_cloner_tpu.models import decoder as jdec
from speech_cloner_tpu.models import encoder as jenc
from speech_cloner_tpu.models import speaker_id as jspk
from speech_cloner_tpu.nn import attention as JA
from speech_cloner_tpu.ops.preemphasis import inv_preemphasis_np as j_inv_preemphasis_np
from speech_cloner_tpu.runtime import config as jconfig
from speech_cloner_tpu.runtime.checkpoint import Checkpointer as JCheckpointer
from speech_cloner_tpu_torch.data import dataset as tdataset
from speech_cloner_tpu_torch.data import viz as tviz
from speech_cloner_tpu_torch.data.audio_io import write_riff_wav
from speech_cloner_tpu_torch.nn import attention as TA
from speech_cloner_tpu_torch.ops import inv_preemphasis_np
from speech_cloner_tpu_torch.runtime import config as tconfig
from speech_cloner_tpu_torch.runtime import profiler
from speech_cloner_tpu_torch.runtime.jax_params import (
    attention_decoder_from_jax,
    embed_from_jax,
    module_to_jax,
)

torch.set_num_threads(2)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# -------------------------------------------------------------- attention ---

@pytest.mark.parametrize("zero_pad", [True, False])
def test_embed_matches_jax_exactly(zero_pad):
    params = np_tree(JA.embed_init(jax.random.PRNGKey(0), 12, 6, zero_pad=zero_pad))
    ids = np.random.default_rng(1).integers(0, 12, (3, 7))
    ids[0, 0] = 0
    ref = np.asarray(JA.embed_apply(params, jnp.asarray(ids)))
    emb = embed_from_jax(params)
    got = emb(torch.tensor(ids)).detach().numpy()
    np.testing.assert_array_equal(got, ref)
    table = torch.tensor(params["lookup_table"])
    np.testing.assert_array_equal(TA.embed_apply({"lookup_table": table, "zero_pad": zero_pad},
                                                 torch.tensor(ids)).numpy(), ref)
    assert (got[0, 0] == 0).all() == zero_pad
    back = module_to_jax(emb)
    assert back["zero_pad"] is zero_pad
    np.testing.assert_array_equal(back["lookup_table"], params["lookup_table"])


def test_embed_init_draws_the_jax_distribution():
    """0.01 x a normal truncated at +-2: the port's draw has JAX's bounds and spread."""
    t = TA.embed_init(torch.Generator().manual_seed(0), 400, 50)
    j = np.asarray(JA.embed_init(jax.random.PRNGKey(0), 400, 50)["lookup_table"])
    table = t["lookup_table"].numpy()
    assert t["zero_pad"] is True and table.shape == j.shape
    assert np.abs(table).max() <= 0.02 and np.abs(j).max() <= 0.02
    np.testing.assert_allclose(table.std(), j.std(), rtol=0.05)


@pytest.mark.parametrize("B,Tq,Tm", [(2, 5, 9), (3, 12, 30)])
def test_attention_decoder_matches_jax(B, Tq, Tm):
    """Outputs and alignments of the Bahdanau decoder within 1e-5; each
    alignment row sums to 1."""
    params = np_tree(JA.attention_decoder_init(jax.random.PRNGKey(B), in_dim=6, memory_dim=10,
                                               num_units=16))
    x, memory = randn((B, Tq, 6), 1), randn((B, Tm, 10), 2)
    ref_out, ref_align = JA.attention_decoder_apply(params, jnp.asarray(x), jnp.asarray(memory))
    dec = attention_decoder_from_jax(params)
    out, align = dec(torch.tensor(x), torch.tensor(memory))
    assert tuple(out.shape) == (B, Tq, 16) and tuple(align.shape) == (B, Tq, Tm)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-5)
    np.testing.assert_allclose(align.detach().numpy(), np.asarray(ref_align), atol=1e-5)
    np.testing.assert_allclose(align.sum(-1).detach().numpy(), 1.0, atol=1e-5)
    back = module_to_jax(dec)
    for k in ("query_kernel", "memory_kernel", "attention_v", "out_kernel", "out_bias"):
        np.testing.assert_array_equal(back[k], params[k])
    for k, v in params["gru"].items():
        np.testing.assert_array_equal(back["gru"][k], v)


def test_attention_trees_checked():
    params = np_tree(JA.attention_decoder_init(jax.random.PRNGKey(0), 6, 10, 16))
    t = TA.attention_decoder_init(torch.Generator().manual_seed(0), 6, 10, 16)
    assert jax.tree.map(np.shape, params) == jax.tree.map(lambda a: tuple(a.shape), t)
    with pytest.raises(ValueError, match="out_kernel"):
        attention_decoder_from_jax({**params, "out_kernel": params["out_kernel"][:, :3]})
    emb = np_tree(JA.embed_init(jax.random.PRNGKey(1), 5, 4))
    with pytest.raises(ValueError, match="zero_pad"):
        embed_from_jax({**emb, "zero_pad": np.zeros(2)})


# --------------------------------------------------------------- profiler ---

def test_profiler_helpers_on_cpu(tmp_path):
    """trace writes a Chrome trace under log_dir that names a span of the
    region; device_memory_stats on the CPU gives one key and an empty dict,
    as the JAX package's does on its CPU."""
    with profiler.trace(str(tmp_path / "trace"), device="cpu"):
        with profiler.span("test_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "test_region" for e in events)
    with profiler.trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
    stats = profiler.device_memory_stats("cpu")
    assert stats == {"cpu": {}}
    from speech_cloner_tpu.runtime.profiler import device_memory_stats

    assert list(device_memory_stats().values())[0] == {}


# ------------------------------------------------------- narrator corpus ---

def speechy(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    env = (np.sin(2 * np.pi * 0.4 * t) > -0.3) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2)
    y = env * np.sin(2 * np.pi * (150 + 30 * np.sin(2 * np.pi * 0.5 * t)) * t)
    return (0.3 * y + 0.01 * rng.standard_normal(n)).astype(np.float32)


def test_make_narrator_corpus_matches_jax(tmp_path):
    """A 20 s clip: the same files under target/, heldout/ and the injected
    TIMIT speaker, byte for byte; the port's caches of that tree removed
    (JAX's removes its h5py ones)."""
    from speech_cloner_tpu.apps import make_narrator_corpus as jmnc
    from speech_cloner_tpu_torch.apps import make_narrator_corpus as tmnc

    clip = tmp_path / "narration.wav"
    write_riff_wav(str(clip), speechy(20.0, 0), 16000, norm=False)
    stale = ["timit_cache.pickle", "spec_cache_ab12.npz", "phn_mfcc_cache_ab12.npz",
             "spec_cache_ab12.sclpack", "phn_mfcc_cache_ab12.sclpack"]
    for who, main in (("jax", jmnc.main), ("port", tmnc.main)):
        timit = tmp_path / f"{who}_timit"
        timit.mkdir()
        for name in stale + ["keep.txt"]:
            (timit / name).write_text("x")
        main(["--clip", str(clip), "--out-dir", str(tmp_path / who), "--timit-dir", str(timit)])
    files = {}
    for who in ("jax", "port"):
        root = tmp_path / who
        files[who] = {p.relative_to(root).as_posix(): p.read_bytes()
                      for p in sorted(root.rglob("*")) if p.is_file()}
        timit = tmp_path / f"{who}_timit"
        files[who].update({"timit/" + p.relative_to(timit).as_posix(): p.read_bytes()
                           for p in sorted((timit / "TRAIN").rglob("*")) if p.is_file()})
    assert set(files["port"]) == set(files["jax"])
    assert {k.split("/")[0] for k in files["port"]} == {"target", "heldout", "timit"}
    assert any(k.startswith("heldout/held") for k in files["port"])
    for k, v in files["jax"].items():
        assert files["port"][k] == v, k
    left = sorted(p.name for p in (tmp_path / "port_timit").iterdir() if p.is_file())
    assert left == ["keep.txt"]
    assert (tmp_path / "jax_timit" / "spec_cache_ab12.npz").exists()


def test_make_narrator_corpus_default_clip_names_the_reference_narration():
    from speech_cloner_tpu.apps import make_narrator_corpus as jmnc
    from speech_cloner_tpu_torch.apps import make_narrator_corpus as tmnc

    assert tmnc.DEFAULT_CLIP.endswith("/reference/slt_test_chptr16/" + jmnc.DEFAULT_CLIP.split(
        "/slt_test_chptr16/")[1])
    bounds = tmnc.energy_snapped_bounds(speechy(13.0, 1), 16000, 6.0, 0.75)
    assert bounds == jmnc.energy_snapped_bounds(speechy(13.0, 1), 16000, 6.0, 0.75)
    y = speechy(3.0, 2)
    for f in (0.9, 1.0, 1.1):
        np.testing.assert_array_equal(tmnc.speed_perturb(y, f), jmnc.speed_perturb(y, f))


# ------------------------------------------------------------- real demo ---

@pytest.fixture(scope="module")
def real_demo_inputs(tmp_path_factory):
    """JAX-written .npz checkpoints of the tiny encoder, decoder and a
    speaker-ID model (3 classes, the narrator one of them), two held-out
    narrator chunks and three source files."""
    root = tmp_path_factory.mktemp("real_demo")
    enc_cfg, dec_cfg = jenc.config_from_cfg_d(ENC_CFG_D), jdec.config_from_cfg_d(DEC_CFG_D)
    for name, mod, cfg, seed in (("encoder", jenc, enc_cfg, 1), ("decoder", jdec, dec_cfg, 2)):
        params, state = mod.init(jax.random.PRNGKey(seed), cfg)
        JCheckpointer(str(root / name), name).save({"params": params, "model_state": state},
                                                   step=3, sync=True)
    spk_cfg = jspk.SpeakerIdConfig(n_timesteps=48, n_features=201, n_output=3)
    params, state = jspk.init(jax.random.PRNGKey(3), spk_cfg)
    JCheckpointer(str(root / "spk"), "speaker_id").save(
        {"params": params, "model_state": state}, step=1, sync=True,
        config={"n_timesteps": 48, "n_features": 201, "n_output": 3, "time_fold": 1,
                "spk_id_v": ["AKS0", "DAB0", "NARR0"]})
    for d, n, seed in (("held", 2, 10), ("src", 3, 20)):
        (root / d).mkdir()
        for i in range(n):
            write_riff_wav(str(root / d / f"{d}{i}.wav"), speechy(0.9 + 0.3 * i, seed + i),
                           16000, norm=False)
    (root / "enc.json").write_text(json.dumps(ENC_CFG_D))
    (root / "dec.json").write_text(json.dumps(DEC_CFG_D))
    return root


def test_real_demo_matches_jax(real_demo_inputs, tmp_path, jax_phases):  # noqa: F811
    """The report's keys, each test's source, duration and losses within
    1e-4 relative of the JAX app's, and the verification (the port's
    Griffin-Lim from the JAX package's phase) with the same classes."""
    from speech_cloner_tpu.apps import real_demo as jrd
    from speech_cloner_tpu_torch.apps import real_demo as trd

    r = real_demo_inputs
    args = ["--heldout-dir", str(r / "held"), "--source-dir", str(r / "src"), "--enc-ckpt",
            str(r / "encoder"), "--dec-ckpt", str(r / "decoder"), "--spk-ckpt", str(r / "spk"),
            "--target-timit-spk", "NARR0", "--enc-cfg", str(r / "enc.json"), "--dec-cfg",
            str(r / "dec.json"), "--n-iter", "8", "--verify-utts", "2"]
    got = trd.main(args + ["--out-dir", str(tmp_path / "p"), "--device", "cpu"])
    ref = jrd.main(args + ["--out-dir", str(tmp_path / "j")])
    assert set(got) == set(ref) == {"enc_ckpt", "dec_ckpt", "n_iter", "tests", "verification"}
    assert set(got["tests"]) == set(ref["tests"]) == {
        "test1_heldout_reconstruction", "test2_heldout_reconstruction", "test3_source_conversion"}
    for name, rt in ref["tests"].items():
        gt = got["tests"][name]
        assert set(gt) == set(rt)
        assert (gt["source"], gt["duration_s"]) == (rt["source"], rt["duration_s"])
        for k in ("mel_loss", "stft_loss", "loss", "mcd_db"):
            np.testing.assert_allclose(gt[k], rt[k], rtol=1e-4, err_msg=f"{name} {k}")
        for wav in ("true.wav", "pred.wav"):
            assert (tmp_path / "p" / name / wav).stat().st_size == \
                (tmp_path / "j" / name / wav).stat().st_size
    gv, rv = got["verification"], ref["verification"]
    assert set(gv) == set(rv) and gv["target_spk_id"] == "NARR0" and "target_p_pred" in gv
    assert [s for s, _ in gv["true_top"]] == [s for s, _ in rv["true_top"]]
    np.testing.assert_allclose([p for _, p in gv["pred_top"]], [p for _, p in rv["pred_top"]],
                               rtol=1e-4)
    assert json.loads((tmp_path / "p" / "demo_report.json").read_text()) == json.loads(
        json.dumps(got))


def test_real_demo_refuses_empty_dirs(real_demo_inputs, tmp_path):
    from speech_cloner_tpu_torch.apps import real_demo as trd

    r = real_demo_inputs
    (tmp_path / "none").mkdir()
    base = ["--enc-ckpt", str(r / "encoder"), "--dec-ckpt", str(r / "decoder"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="no held-out wavs"):
        trd.main(["--heldout-dir", str(tmp_path / "none"), "--source-dir", str(r / "src"), *base])
    with pytest.raises(SystemExit, match="no source wavs"):
        trd.main(["--heldout-dir", str(r / "held"), "--source-dir", str(tmp_path / "none"), *base])


# ------------------------------------------------------- small API pieces ---

def test_config_helpers_match_jax(tmp_path):
    """make_dir_path, show_diff's lines and count, and save_cfg_d's bytes
    and its on_conflict rules, against the JAX package's."""
    new = {"a": 1, "b": {"c": 2, "d": [1, 2]}, "e": "x", "n": None}
    old = {"a": 2, "b": {"c": 2, "d": [1]}, "f": 3.5, "n": None}
    lines = {}
    for who, mod in (("jax", jconfig), ("port", tconfig)):
        out = []
        n = mod.show_diff(new, old, out=out.append)
        lines[who] = (n, out)
        mod.make_dir_path(str(tmp_path / who / "deep"))
        mod.make_dir_path("")
        path = str(tmp_path / who / "deep" / "cfg.json")
        assert mod.save_cfg_d(new, path) is True
        assert mod.save_cfg_d(new, path) is False                 # unchanged
        assert mod.save_cfg_d(old, path, on_conflict="keep") is False
        assert mod.save_cfg_d(old, path, on_conflict=lambda a, b: False) is False
        assert mod.save_cfg_d({**new, "z": (1, 2)}, str(tmp_path / who / "t" / "c.json"))
    assert lines["port"] == lines["jax"] and lines["port"][0] == 4
    for rel in ("deep/cfg.json", "t/c.json"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    assert tconfig.save_cfg_d(old, str(tmp_path / "port" / "deep" / "cfg.json"))
    assert tconfig.load_cfg_d(str(tmp_path / "port" / "deep" / "cfg.json")) == old


@pytest.mark.parametrize("dtype,coeff", [(np.float32, 0.97), (np.float64, 0.999),
                                         (np.float32, 0.0)])
def test_inv_preemphasis_np_matches_jax(dtype, coeff):
    x = randn(5000, 3).astype(dtype)
    got = inv_preemphasis_np(x, coeff)
    ref = j_inv_preemphasis_np(x, coeff)
    assert got.dtype == ref.dtype == dtype
    np.testing.assert_array_equal(got, ref)


def test_playback_without_sounddevice_matches_jax(monkeypatch):
    """play raises the JAX package's RuntimeError where sounddevice cannot
    be imported, from viz and from a dataset; stop the import error."""
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    ds = types.SimpleNamespace(feat_cfg=types.SimpleNamespace(sample_rate=16000))
    wave = np.zeros(10, np.float32)
    for play in (jviz.play, tviz.play, lambda w: jdataset.SoundDataset.play(ds, w),
                 lambda w: tdataset.SoundDataset.play(ds, w)):
        with pytest.raises(RuntimeError, match="sounddevice not installed; playback unavailable"):
            play(wave)
    for stop in (jviz.stop, tviz.stop, lambda: jdataset.SoundDataset.stop(ds),
                 lambda: tdataset.SoundDataset.stop(ds)):
        with pytest.raises(ImportError):
            stop()
