"""The port's train-to-demo workflow on the CPU against the JAX package's:
the trainers' packed and device-resident loaders and the target-speaker
corpus, ``apps.train_full --demo``, ``apps.clone_demo``, ``apps.evaluate``,
``apps.convert --save-true`` and ``apps.clean_ckpt``.

The trainers are compared as tests/test_torch_port_train_apps.py compares
them (one step-0 checkpoint, 4 steps with dropout 0 and no BN
recalibration, the JAX apps op by op, the ``<name>-4.npz`` leaves and the
logged losses within that file's limits), here with the same ``--loader``
on both sides. The demo and the evaluations run on a corpus from
``make_synth_corpus`` at test width (a 50-utterance ARCTIC tree, so the
seed-0 2% validation split holds one utterance), over one ``.npz``
checkpoint pair, with the JAX Griffin-Lim phase handed to the port.
"""

import json
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train_apps import (  # noqa: F401  (fixtures)
    DEC_CFG,
    assert_checkpoints_close,
    seeded_jax_datasets,
    work,
)

from speech_cloner_tpu.data import audio_io as jaudio
from speech_cloner_tpu_torch.pipeline.clone import ClonePipeline
from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer


def run_pair(name, jax_main, port_main, args, tmp, loader, before_port=None):
    """Both apps from one step-0 checkpoint with ``--loader loader``, 4 steps;
    the checkpoints and the logged losses compared. ``before_port`` runs
    between the JAX and the port run."""
    jdir, pdir = tmp / f"jax_{name}_{loader}", tmp / f"port_{name}_{loader}"
    logs = tmp / f"jl_{name}_{loader}", tmp / f"pl_{name}_{loader}"
    jax_main(args + ["--model-path", str(jdir), "--log-dir", str(logs[0]), "--max-steps", "0",
                     "--loader", loader])
    pdir.mkdir()
    shutil.copy(jdir / f"{name}-0.npz", pdir / f"{name}-0.npz")
    with jax.disable_jit():
        jax_main(args + ["--model-path", str(jdir), "--log-dir", str(logs[0]), "--max-steps", "4",
                         "--loader", loader, "--steps-per-call", "1"])
    if before_port is not None:
        before_port()
    port_main(args + ["--model-path", str(pdir), "--log-dir", str(logs[1]), "--max-steps", "4",
                      "--loader", loader, "--device", "cpu", "--steps-per-call", "1"])
    assert Checkpointer(str(pdir), name).steps() == [0, 4]
    assert_checkpoints_close(pdir / f"{name}-4.npz", jdir / f"{name}-4.npz")
    jl = [json.loads(s) for s in open(logs[0] / "trn.jsonl")]
    pl = [json.loads(s) for s in open(logs[1] / "trn.jsonl")]
    assert [r["step"] for r in pl] == [r["step"] for r in jl]
    np.testing.assert_allclose([r["loss"] for r in pl], [r["loss"] for r in jl], rtol=1e-5)
    return jdir


COMMON = ["--batch-size", "2", "--bn-recal", "0", "--seed", "0"]


@pytest.mark.parametrize("loader", ["device", "native"])
def test_apps_with_loader_match_jax(work, tmp_path, seeded_jax_datasets, loader,  # noqa: F811
                                    capsys):
    from speech_cloner_tpu.apps import train_decoder as jtd
    from speech_cloner_tpu.apps import train_encoder as jte
    from speech_cloner_tpu_torch.apps import train_decoder as ptd
    from speech_cloner_tpu_torch.apps import train_encoder as pte

    common = ["--ds-cfg", str(work / "ds.json"), *COMMON]
    jenc = run_pair("encoder", jte.main, pte.main,
                    ["--ds-path", str(work / "timit"), "--enc-cfg", str(work / "enc.json"),
                     *common], tmp_path, loader)
    run_pair("decoder", jtd.main, ptd.main,
             ["--ds-path", str(work / "arctic"), "--spk-id", "slt", "--enc-ckpt", str(jenc),
              "--enc-cfg", str(work / "enc.json"), "--dec-cfg", str(work / "dec.json"),
              "--prop-val", "0.34", *common], tmp_path, loader)
    out = capsys.readouterr().out
    assert out.count(f" loader: {loader}") == 2           # the port's two apps
    assert ("device-resident dataset" if loader == "device" else " native loader:") in out


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    """The JAX app test's target corpus: 4 one-second noise files."""
    root = tmp_path_factory.mktemp("book")
    rng = np.random.default_rng(1)
    for i in range(4):
        jaudio.write_riff_wav(str(root / f"c{i}.wav"),
                              rng.standard_normal(16000).astype(np.float32), 16000)
    return root


@pytest.mark.parametrize("loader", ["h5py", "device"])
def test_target_kind_matches_jax(work, book, tmp_path, seeded_jax_datasets,  # noqa: F811
                                 loader):
    """--ds-kind target, the decoder on the JAX step-0 encoder: each batch is
    crops of one file (the sequential split and TargetSpeaker's sampler, or
    file_batch_sampler on the device). The port reads the JAX run's
    features (its h5py cache written out as the port's .npz cache under the
    same key), so the comparison holds the reader, the sampler and the
    steps: on these noise files the two front-ends' power_dB maps differ by
    a shift of ~1e-5 (their floors, where float32 FFTs differ; within
    test_torch_port_data.py's limit), which 4 steps carry past the median
    limit of one leaf (1.2e-5 against 1e-5, measured)."""
    from speech_cloner_tpu.apps import train_decoder as jtd
    from speech_cloner_tpu.apps import train_encoder as jte
    from speech_cloner_tpu_torch.apps import train_decoder as ptd

    enc = tmp_path / "enc"
    jte.main(["--ds-path", str(work / "timit"), "--enc-cfg", str(work / "enc.json"),
              "--ds-cfg", str(work / "ds.json"), "--model-path", str(enc), "--log-dir",
              str(tmp_path / "el"), "--max-steps", "0", "--loader", "h5py", *COMMON])
    run_pair("decoder", jtd.main, ptd.main,
             ["--ds-path", str(book), "--ds-kind", "target", "--enc-ckpt", str(enc),
              "--enc-cfg", str(work / "enc.json"), "--dec-cfg", str(work / "dec.json"),
              "--ds-cfg", str(work / "ds.json"), "--prop-val", "0.3", *COMMON], tmp_path, loader,
             before_port=lambda: jax_cache_as_npz(book))


def jax_cache_as_npz(root):
    """The JAX spec caches under ``root`` (h5py) rewritten as the port's
    .npz caches of the same key."""
    import h5py

    for h5 in root.glob("spec_cache_*.h5py"):
        with h5py.File(h5, "r") as f:
            arrays = {f"{s}/{i}": f[s][i][:] for s in f for i in f[s]}
        np.savez(h5.with_suffix(".npz"), **arrays)


DEMO_DEC_CFG = {**DEC_CFG, "dropout_rate": 0.1, "use_target_mel_step2": False}


@pytest.fixture(scope="module")
def demo(work, tmp_path_factory):  # noqa: F811
    """A make_synth_corpus corpus at test width (short utterances) and one
    port train_full --in-process --demo run over it."""
    from speech_cloner_tpu_torch.apps import make_synth_corpus, train_full

    root = tmp_path_factory.mktemp("demo")
    (root / "dec.json").write_text(json.dumps(DEMO_DEC_CFG))
    make_synth_corpus.main(["--out-dir", str(root / "synth"), "--train-spk", "2", "--test-spk",
                            "1", "--utts", "2", "--arctic-utts", "50", "--n-phones", "6"])
    cfgs = ["--ds-cfg", str(work / "ds.json"), "--enc-cfg", str(work / "enc.json"),
            "--dec-cfg", str(root / "dec.json")]
    train_full.main(["--timit-path", str(root / "synth" / "timit"), "--target-path",
                     str(root / "synth" / "arctic"), "--spk-id", "slt", "--work-dir",
                     str(root / "run"), *cfgs, "--batch-size", "2", "--enc-steps", "2",
                     "--dec-steps", "2", "--spk-steps", "2", "--demo", "--n-iter", "4",
                     "--target-timit-spk", "SLT0", "--in-process", "--device", "cpu"])
    return root, cfgs


def test_train_full_demo(demo):
    root, _ = demo
    run = root / "run"
    rep = json.loads((run / "demo" / "demo_report.json").read_text())
    assert set(rep) == {"enc_ckpt", "dec_ckpt", "n_iter", "tests", "verification"}
    assert set(rep["tests"]) == {"test1_self_reconstruction", "test2_target_speaker",
                                 "test3_other_speaker"}
    for t in rep["tests"].values():
        assert set(t) == {"utterance", "speaker", "duration_s", "mel_loss", "stft_loss", "loss",
                          "mcd_db"}
        assert all(np.isfinite(t[k]) for k in ("mel_loss", "stft_loss", "mcd_db"))
    assert "identity_changed" in rep["verification"]
    assert rep["verification"]["target_spk_id"] == "SLT0"
    for t in rep["tests"]:
        for wav in ("true", "pred"):
            y = jaudio.read_riff_wav(str(run / "demo" / t / f"{wav}.wav"))[0]
            assert np.isfinite(y).all() and y.size > 0
    for stage, name in (("enc_ckpt", "encoder"), ("dec_ckpt", "decoder"),
                        ("spk_ckpt", "speaker_id")):
        assert Checkpointer(str(run / stage), name).latest_step() == 2, stage


def jax_phase(shape, seed):
    return np.asarray(jnp.pi * jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                                  dtype=jnp.float32))


@pytest.fixture
def jax_phases(monkeypatch):
    """The port's convert draws the JAX package's PRNGKey(0) phase."""
    real = ClonePipeline.device_vocode

    def vocode(self, stft, generator=None, init_phase=None):
        if init_phase is None:
            init_phase = torch.tensor(jax_phase(tuple(stft.shape), 0))
        return real(self, stft, None, init_phase)
    monkeypatch.setattr(ClonePipeline, "device_vocode", vocode)


def test_clone_demo_matches_jax(demo, tmp_path, jax_phases):
    """The report's numbers within 1e-4 relative and each pred.wav within 2
    LSB of the JAX app's, from the same checkpoints and phase (measured: 0
    LSB at --n-iter 4)."""
    from speech_cloner_tpu.apps import clone_demo as jcd
    from speech_cloner_tpu_torch.apps import clone_demo as pcd

    root, cfgs = demo
    run = root / "run"
    args = ["--target-path", str(root / "synth" / "arctic"), "--enc-ckpt", str(run / "enc_ckpt"),
            "--dec-ckpt", str(run / "dec_ckpt"), "--spk-ckpt", str(run / "spk_ckpt"),
            "--target-timit-spk", "SLT0", "--n-iter", "4", "--verify-utts", "2", *cfgs]
    got = pcd.main(args + ["--out-dir", str(tmp_path / "p"), "--device", "cpu"])
    ref = jcd.main(args + ["--out-dir", str(tmp_path / "j")])
    assert set(got) == set(ref) and set(got["verification"]) == set(ref["verification"])
    for name, r in ref["tests"].items():
        g = got["tests"][name]
        assert (g["utterance"], g["speaker"], g["duration_s"]) == (
            r["utterance"], r["speaker"], r["duration_s"])
        for k in ("mel_loss", "stft_loss", "loss", "mcd_db"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4, err_msg=f"{name} {k}")
        for wav in ("true", "pred"):
            a = np.frombuffer(open(tmp_path / "p" / name / f"{wav}.wav", "rb").read()[44:], "<i2")
            b = np.frombuffer(open(tmp_path / "j" / name / f"{wav}.wav", "rb").read()[44:], "<i2")
            assert a.shape == b.shape
            assert np.abs(a.astype(int) - b).max() <= 2, (name, wav)
    gv, rv = got["verification"], ref["verification"]
    assert [s for s, _ in gv["true_top"]] == [s for s, _ in rv["true_top"]]
    np.testing.assert_allclose([p for _, p in gv["pred_top"]], [p for _, p in rv["pred_top"]],
                               rtol=1e-4)
    assert gv["identity_changed"] == rv["identity_changed"]


def final_line(text: str) -> str:
    return [s for s in text.strip().splitlines() if "final" in s or "accuracy over" in s][-1]


def numbers(line: str) -> tuple[list[float], list[str]]:
    """(the decimals, the counts after "over") of a final line."""
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)], re.findall(r"over (\d+)", line)


@pytest.fixture
def seeded_datasets(monkeypatch):
    """Both packages' evaluate apps build their datasets unseeded (fresh
    windows each run); seed both with 0."""
    from speech_cloner_tpu.data import dataset as jdataset
    from speech_cloner_tpu_torch.data import dataset as pdataset

    for mod in (jdataset, pdataset):
        init = mod.SoundDataset.__init__

        def seeded(self, *a, _init=init, seed=None, **kw):
            _init(self, *a, seed=0 if seed is None else seed, **kw)
        monkeypatch.setattr(mod.SoundDataset, "__init__", seeded)


@pytest.mark.parametrize("mode", ["encoder", "decoder", "speaker"])
def test_evaluate_matches_jax(demo, mode, capsys, seeded_datasets):
    """Each mode's final line against the JAX app's (numbers within 1e-4
    relative; counts exact)."""
    from speech_cloner_tpu.apps import evaluate as jev
    from speech_cloner_tpu_torch.apps import evaluate as pev

    root, cfgs = demo
    run, synth = root / "run", root / "synth"
    args = {"encoder": ["--ds-path", str(synth / "timit"), "--ckpt", str(run / "enc_ckpt"),
                        "--batch-size", "2"],
            "decoder": ["--ds-path", str(synth / "arctic"), "--ckpt", str(run / "dec_ckpt"),
                        "--enc-ckpt", str(run / "enc_ckpt"), "--batch-size", "1"],
            "speaker": ["--ds-path", str(synth / "timit"), "--ckpt", str(run / "spk_ckpt"),
                        "--split", "trn", "--batch-size", "2"]}[mode]
    pev.main([mode, *args, *cfgs, "--device", "cpu"])
    got = capsys.readouterr().out
    jev.main([mode, *args, *cfgs])
    ref = capsys.readouterr().out
    (g, g_n), (r, r_n) = numbers(final_line(got)), numbers(final_line(ref))
    assert len(g) == len(r) >= 1 and g_n == r_n
    np.testing.assert_allclose(g, r, rtol=1e-4)
    if mode == "decoder":
        assert g[0] > 0.0                                 # one validation window scored


def test_convert_save_true(tmp_path):
    """--save-true's resynthesis: its spectrogram is the JAX one within
    test_torch_port_data.py's power_dB limit (measured 1.7e-5: the map's
    floor, where float32 FFTs differ, shifts it), and from that spectrogram
    and the JAX phase its waveform is the JAX Griffin-Lim's within
    test_griffin_lim_match_and_return_stft's 2e-6; the CLI writes
    <stem>_true.wav."""
    from test_torch_port_data import assert_feature_close

    from speech_cloner_tpu.ops.features import FeatureConfig as JFeatureConfig
    from speech_cloner_tpu.ops.features import mfcc_input as j_mfcc_input
    from speech_cloner_tpu.ops.griffin_lim import from_power_to_wav as j_from_power_to_wav
    from speech_cloner_tpu_torch.apps import convert
    from speech_cloner_tpu_torch.ops import FeatureConfig, mfcc_input

    rng = np.random.default_rng(3)
    wav = (0.1 * rng.standard_normal(4000)).astype(np.float32)
    feat = dict(hop_length=80, win_length=400, n_mels=20, n_mfcc=10, calc_mfcc_derivate=True)
    fc, jfc = FeatureConfig(**feat), JFeatureConfig(**feat)
    _, _, stft = mfcc_input(torch.tensor(wav), fc)
    assert_feature_close(stft.numpy(), j_mfcc_input(wav, jfc, xp=np)[2], "power_dB")
    ref = np.asarray(j_from_power_to_wav(
        jnp.asarray(stft.numpy()), P_dB_norm_factor=jfc.P_dB_norm_factor,
        pre_emphasis=jfc.pre_emphasis, hop_length=jfc.hop_length, win_length=jfc.win_length,
        mean_abs_amp_norm=0.045, n_iter=4, n_fft=jfc.n_fft_, realse=1.0,
        key=jax.random.PRNGKey(0)))
    got = convert.true_resynthesis(wav, fc, 4, "cpu",
                                   init_phase=torch.tensor(jax_phase(tuple(stft.shape), 0)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6)
    np.testing.assert_array_equal(convert.true_resynthesis(wav, fc, 4, "cpu").numpy(),
                                  convert.true_resynthesis(wav, fc, 4, "cpu").numpy())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_convert_cli_save_true(demo, tmp_path, bf16):
    """apps.convert --save-true (formerly refused) on the demo's checkpoints
    writes <stem>_pred.wav and <stem>_true.wav, the latter the length of
    true_resynthesis's waveform, finite."""
    from speech_cloner_tpu_torch.apps import convert

    root, cfgs = demo
    src = root / "synth" / "arctic" / "cmu_us_bdl_arctic" / "wav" / "arctic_a0001.wav"
    convert.main(["--input", str(src), "--output-dir", str(tmp_path), "--enc-ckpt",
                  str(root / "run" / "enc_ckpt"), "--dec-ckpt", str(root / "run" / "dec_ckpt"),
                  *cfgs, "--n-iter", "4", "--save-true", "--device", "cpu"]
                 + (["--bf16"] if bf16 else []))
    true = jaudio.read_riff_wav(str(tmp_path / "arctic_a0001_true.wav"))[0]
    wav = jaudio.read_riff_wav(str(src))[0]
    assert (tmp_path / "arctic_a0001_pred.wav").exists()
    assert np.isfinite(true).all() and len(true) == (len(wav) // 80 + 1) * 80 - 80


def test_clean_ckpt_matches_jax(tmp_path):
    from speech_cloner_tpu.apps import clean_ckpt as jcc
    from speech_cloner_tpu_torch.apps import clean_ckpt as pcc

    for side in ("p", "j"):
        ck = Checkpointer(str(tmp_path / side), "decoder")
        for s in range(0, 100, 10):
            ck.save({"x": np.zeros(3, np.float32)}, step=s)
    pcc.main(["--dir", str(tmp_path / "p"), "--name", "decoder", "--n-keep", "3",
              "--step-min", "20"])
    jcc.main(["--dir", str(tmp_path / "j"), "--name", "decoder", "--n-keep", "3",
              "--step-min", "20"])
    left = Checkpointer(str(tmp_path / "p"), "decoder").steps()
    assert left == Checkpointer(str(tmp_path / "j"), "decoder").steps()
    assert 0 not in left and 10 not in left and 90 in left and len(left) <= 5
