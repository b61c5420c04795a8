"""The port's training apps on the CPU against the JAX package's, on
tests/test_data.py's synthetic TIMIT and ARCTIC trees.

Both packages start from one step-0 checkpoint (the JAX app run with
``--max-steps 0`` writes it; the port's copy resumes from it, as either
package resumes from the other's), read the same windows (the port app
seeds its dataset with ``--seed``; the JAX app's dataset is seeded the same
way here), run 4 steps with dropout 0 and BN recalibration off (``--loader
h5py`` for the JAX app's per-step reader), and their ``<name>-4.npz``
checkpoints are compared.

The JAX apps run op by op (``jax.disable_jit()``): on these fixtures XLA's
jitted gradient of the encoder differs from JAX's op-by-op gradient of the
same function by up to a quarter of a leaf's peak in the conv banks and the
prenet (measured), where the port's agrees with the op-by-op one within
2e-6 of the peak. Limits, by leaf: step, epoch and Adam's count exact; BN
statistics within 1e-5 of their peak (absolute below 1); parameters within
1e-5 at the median and within 4 * 2 * lr = 8e-3 everywhere (Adam moves a
parameter by about lr a step whatever its gradient's size, so a gradient at
the float32 noise level that flips its sign moves the two runs apart by up
to 2 lr; measured: medians <= 2.5e-6, the largest single gap 2.5e-3, in the
encoder prenet's kernel rows of near-constant MFCC inputs); the logged
losses within 1e-5.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch
from test_data import _make_arctic_tree, _make_timit_tree

from speech_cloner_tpu.data import dataset as jdataset
from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer

DS_CFG = {
    "sample_rate": 16000, "pre_emphasis": 0.97, "hop_length_ms": 5.0, "win_length_ms": 25.0,
    "n_timesteps": 40, "n_mels": 20, "n_mfcc": 10, "n_fft": None, "window": "hann",
    "mfcc_normaleze_first_mfcc": True, "mfcc_norm_factor": 0.01, "calc_mfcc_derivate": True,
    "M_dB_norm_factor": 0.01, "P_dB_norm_factor": 0.01, "mean_abs_amp_norm": 0.003,
    "clip_output": True, "ds_norm": [0.0, 10.0],
}
ENC_CFG = {
    "model_name": "encoder", "input_shape": [40, 20], "n_output": 61, "embed_size": None,
    "num_conv_banks": 2, "num_highwaynet_blocks": 1, "dropout_rate": 0.0, "use_lstm": False,
    "learning_rate": 1e-3, "decay": 1e-3, "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
}
DEC_CFG = {
    "model_name": "decoder", "input_shape": [40, 61],
    "steps_v": [{"embed_size": 32, "num_conv_banks": 2, "num_highwaynet_blocks": 1,
                 "n_output": 20},
                {"embed_size": 48, "num_conv_banks": 2, "num_highwaynet_blocks": 1,
                 "n_output": 201}],
    "dropout_rate": 0.0, "use_lstm": False, "learning_rate": 1e-3, "decay": 1e-3,
    "mel_loss_weight": 400, "stft_loss_weight": 400, "loss_type": "sum",
    "use_target_mel_step2": True, "target_mel_step2_val": 500,
}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_apps")
    (root / "timit").mkdir()
    (root / "arctic").mkdir()
    _make_timit_tree(str(root / "timit"))
    _make_arctic_tree(str(root / "arctic"))
    for name, cfg in (("ds", DS_CFG), ("enc", ENC_CFG), ("dec", DEC_CFG)):
        (root / f"{name}.json").write_text(json.dumps(cfg))
    return root


@pytest.fixture
def seeded_jax_datasets(monkeypatch):
    """The JAX apps build their datasets unseeded; seed them with 0 as the
    port's apps seed theirs with --seed 0."""
    init = jdataset.SoundDataset.__init__

    def seeded(self, *a, seed=None, **kw):
        init(self, *a, seed=0 if seed is None else seed, **kw)
    monkeypatch.setattr(jdataset.SoundDataset, "__init__", seeded)


def flat(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_checkpoints_close(port, jax_):
    a, b = flat(port), flat(jax_)
    assert set(a) == set(b)
    for k in b:
        got, ref = a[k], b[k]
        assert got.shape == ref.shape, k
        if k in ("step", "epoch", "opt_state//0") or k.endswith("__len__"):
            np.testing.assert_array_equal(got, ref, err_msg=k)
        elif k.startswith("model_state//"):
            np.testing.assert_allclose(got, ref, atol=1e-5 * max(np.abs(ref).max(), 1.0),
                                       err_msg=k)
        elif k.startswith("params//"):
            err = np.abs(got - ref)
            assert err.max() <= 8e-3 and np.median(err) <= 1e-5, (k, err.max(), np.median(err))


def run_both(work, name, jax_main, port_main, args, tmp):
    jdir, pdir = tmp / f"jax_{name}", tmp / f"port_{name}"
    jax_main(args + ["--model-path", str(jdir), "--log-dir", str(tmp / f"jl_{name}"),
                     "--max-steps", "0", "--loader", "h5py"])
    pdir.mkdir()
    shutil.copy(jdir / f"{name}-0.npz", pdir / f"{name}-0.npz")
    with jax.disable_jit():
        jax_main(args + ["--model-path", str(jdir), "--log-dir", str(tmp / f"jl_{name}"),
                         "--max-steps", "4", "--loader", "h5py", "--steps-per-call", "1"])
    port_main(args + ["--model-path", str(pdir), "--log-dir", str(tmp / f"pl_{name}"),
                      "--max-steps", "4", "--device", "cpu", "--steps-per-call", "1"])
    assert Checkpointer(str(pdir), name).steps() == [0, 4]
    assert_checkpoints_close(pdir / f"{name}-4.npz", jdir / f"{name}-4.npz")
    jl = [json.loads(s) for s in open(tmp / f"jl_{name}" / "trn.jsonl")]
    pl = [json.loads(s) for s in open(tmp / f"pl_{name}" / "trn.jsonl")]
    assert [r["step"] for r in pl] == [r["step"] for r in jl]
    np.testing.assert_allclose([r["loss"] for r in pl], [r["loss"] for r in jl], rtol=1e-5)
    return jdir, pdir


def test_encoder_and_decoder_apps_match_jax(work, tmp_path, seeded_jax_datasets):
    from speech_cloner_tpu.apps import train_decoder as jtd
    from speech_cloner_tpu.apps import train_encoder as jte
    from speech_cloner_tpu_torch.apps import train_decoder as ptd
    from speech_cloner_tpu_torch.apps import train_encoder as pte

    common = ["--ds-cfg", str(work / "ds.json"), "--batch-size", "2", "--bn-recal", "0",
              "--seed", "0"]
    jenc_dir, _ = run_both(work, "encoder", jte.main, pte.main,
                           ["--ds-path", str(work / "timit"), "--enc-cfg", str(work / "enc.json"),
                            *common], tmp_path)
    run_both(work, "decoder", jtd.main, ptd.main,
             ["--ds-path", str(work / "arctic"), "--spk-id", "slt", "--enc-ckpt", str(jenc_dir),
              "--enc-cfg", str(work / "enc.json"), "--dec-cfg", str(work / "dec.json"),
              "--prop-val", "0.34", *common], tmp_path)


def test_fused_gru_apps_train_and_resume(work, tmp_path):
    """--fused-gru in both apps (the decoder on the encoder it trained), with
    BN recalibration and a save at every epoch; a second call resumes."""
    from speech_cloner_tpu_torch.apps import train_decoder as ptd
    from speech_cloner_tpu_torch.apps import train_encoder as pte

    enc = pte.main(["--ds-path", str(work / "timit"), "--enc-cfg", str(work / "enc.json"),
                    "--ds-cfg", str(work / "ds.json"), "--batch-size", "2", "--bn-recal", "2",
                    "--max-steps", "3", "--save-each-n-epochs", "1", "--fused-gru",
                    "--model-path", str(tmp_path / "enc"), "--log-dir", str(tmp_path / "el"),
                    "--device", "cpu"])
    assert enc.cbhg.gru.fused and Checkpointer(str(tmp_path / "enc"), "encoder").latest_step() == 3
    args = ["--ds-path", str(work / "arctic"), "--spk-id", "slt", "--enc-ckpt",
            str(tmp_path / "enc"), "--enc-cfg", str(work / "enc.json"), "--dec-cfg",
            str(work / "dec.json"), "--ds-cfg", str(work / "ds.json"), "--batch-size", "2",
            "--prop-val", "0.34", "--bn-recal", "1", "--save-each-n-epochs", "1",
            "--fused-gru", "--model-path", str(tmp_path / "dec"), "--log-dir",
            str(tmp_path / "dl"), "--device", "cpu"]
    dec = ptd.main(args + ["--max-steps", "2"])
    assert dec.step1.cbhg.gru.fused
    ptd.main(args + ["--max-steps", "3"])
    assert Checkpointer(str(tmp_path / "dec"), "decoder").latest_step() == 3
    assert list((tmp_path / "dl").glob("spec_*.npz"))


def assert_lstm_checkpoint(path, scope="params//"):
    """The checkpoint's CBHG RNN leaves under ``scope`` are an LSTM's,
    forget_bias 0-d."""
    z = flat(path)
    rnn = scope + "CBHG//gru//"
    assert {k.removeprefix(rnn) for k in z if k.startswith(rnn)} == {
        f"{d}//{k}" for d in ("fw", "bw") for k in ("kernel", "bias", "forget_bias")}
    assert z[rnn + "fw//forget_bias"].shape == ()


@pytest.mark.parametrize("flags", [["--n-model", "2"], ["--loader", "native"],
                                   ["--loader", "device"], ["--n-data", "2", "--n-model", "2"]])
def test_unported_encoder_flags_raise(work, tmp_path, flags):
    """The loaders and --n-data/--n-model ("Parallel") are ported, and so is
    the CBHG LSTM branch ("The rest") that once stopped these runs: an
    encoder config with use_lstm trains one step through each loader, with
    --n-model alone (no effect without --n-data, as in JAX) and as a 2 x 2
    world of data and model ranks (gloo; the banks split, the LSTM's leaves
    replicated), and its checkpoint holds the LSTM's leaves. The parallel runs themselves are in
    tests/test_torch_port_distributed.py."""
    from speech_cloner_tpu_torch.apps import train_encoder as pte

    lstm = tmp_path / "lstm.json"
    lstm.write_text(json.dumps({**ENC_CFG, "use_lstm": True}))
    cfgs = ["--enc-cfg", str(lstm), "--ds-cfg", str(work / "ds.json")]
    pte.main(["--ds-path", str(work / "timit"), "--model-path", str(tmp_path / "m"),
              "--log-dir", str(tmp_path / "l"), "--device", "cpu", "--batch-size", "2",
              "--max-steps", "1", "--bn-recal", "0", *cfgs, *flags])
    assert Checkpointer(str(tmp_path / "m"), "encoder").latest_step() == 1
    assert_lstm_checkpoint(tmp_path / "m" / "encoder-1.npz")


@pytest.mark.parametrize("flags", [["--ds-kind", "target"], ["--loader", "native"]])
def test_unported_decoder_flags_raise(work, tmp_path, flags):
    """--ds-kind target and --loader native are ported, and so is the CBHG
    LSTM branch of a decoder config with use_lstm ("The rest") that once
    stopped these runs: each trains one step through the new path (a
    directory of one speaker's files; the packed cache) and writes the
    LSTM's leaves."""
    from speech_cloner_tpu_torch.apps import train_decoder as ptd
    from speech_cloner_tpu_torch.apps import train_encoder as pte

    pte.main(["--ds-path", str(work / "timit"), "--enc-cfg", str(work / "enc.json"), "--ds-cfg",
              str(work / "ds.json"), "--max-steps", "0", "--bn-recal", "0", "--model-path",
              str(tmp_path / "enc"), "--log-dir", str(tmp_path / "el"), "--device", "cpu"])
    lstm = tmp_path / "lstm.json"
    lstm.write_text(json.dumps({**DEC_CFG, "use_lstm": True}))
    ds = work / "arctic"
    if "target" in flags:
        ds = tmp_path / "book"
        ds.mkdir()
        for wav in sorted((work / "arctic" / "cmu_us_slt_arctic" / "wav").glob("*.wav")):
            shutil.copy(wav, ds / wav.name)
    ptd.main(["--ds-path", str(ds), "--enc-ckpt", str(tmp_path / "enc"), "--enc-cfg",
              str(work / "enc.json"), "--dec-cfg", str(lstm), "--ds-cfg",
              str(work / "ds.json"), "--model-path", str(tmp_path / "dec"), "--log-dir",
              str(tmp_path / "dl"), "--device", "cpu", "--batch-size", "2", "--max-steps", "1",
              "--bn-recal", "0", *flags])
    assert list(ds.glob("*.sclpack" if "--loader" in flags else "spec_cache_*.npz"))
    assert Checkpointer(str(tmp_path / "dec"), "decoder").latest_step() == 1
    for step in ("step1", "step2"):
        assert_lstm_checkpoint(tmp_path / "dec" / "decoder-1.npz", f"params//{step}//")


@pytest.mark.parametrize("fused", [False, True], ids=["two_scans", "fused"])
def test_bf16_flag_trains_both_apps(work, tmp_path, monkeypatch, fused):
    """--bf16 (formerly refused) in both apps, the decoder on the encoder it
    trained: each train step runs in bf16 (the steps get compute_dtype
    bfloat16), the checkpoints keep float32 weights and Adam state, and a
    second call resumes."""
    from speech_cloner_tpu_torch.apps import train_decoder as ptd
    from speech_cloner_tpu_torch.apps import train_encoder as pte

    dtypes = []
    for app, step in ((pte, "encoder_train_step"), (ptd, "decoder_train_step")):
        real = getattr(app, step)

        def spy(*a, _real=real, **k):
            dtypes.append(k["compute_dtype"])
            return _real(*a, **k)
        monkeypatch.setattr(app, step, spy)
    flags = ["--bf16", "--device", "cpu"] + (["--fused-gru"] if fused else [])
    pte.main(["--ds-path", str(work / "timit"), "--enc-cfg", str(work / "enc.json"),
              "--ds-cfg", str(work / "ds.json"), "--batch-size", "2", "--max-steps", "2",
              "--model-path", str(tmp_path / "enc"), "--log-dir", str(tmp_path / "el"), *flags])
    args = ["--ds-path", str(work / "arctic"), "--spk-id", "slt", "--enc-ckpt",
            str(tmp_path / "enc"), "--enc-cfg", str(work / "enc.json"), "--dec-cfg",
            str(work / "dec.json"), "--ds-cfg", str(work / "ds.json"), "--batch-size", "2",
            "--prop-val", "0.34", "--bn-recal", "1", "--model-path", str(tmp_path / "dec"),
            "--log-dir", str(tmp_path / "dl"), *flags]
    ptd.main(args + ["--max-steps", "1"])
    dec = ptd.main(args + ["--max-steps", "2"])
    assert dtypes == [torch.bfloat16] * 4
    assert dec.step1.cbhg.gru.fused == fused
    for name in ("encoder", "decoder"):
        ck = flat(tmp_path / name[:3] / f"{name}-2.npz")
        assert int(ck["step"]) == 2
        assert all(v.dtype == np.float32 for k, v in ck.items()
                   if k.startswith(("params//", "model_state//", "opt_state//1", "opt_state//2"))
                   and not k.endswith("__len__"))
        assert all(np.isfinite(v).all() for k, v in ck.items() if k.startswith("params//"))


def test_trainers_take_float32_products(work, tmp_path, monkeypatch):
    """torch runs cuDNN convolutions in TF32 unless told otherwise, and the
    trainers started in a fresh process did (the pipeline turns it off, so
    a trainer's gradients depended on what else ran before it in the
    process). `float32_products` turns TF32 and bf16 split-K sums off on a
    CUDA device and touches nothing on the CPU; each trainer calls it with
    its device before its first step."""
    from speech_cloner_tpu_torch.apps import train_decoder as ptd
    from speech_cloner_tpu_torch.apps import train_encoder as pte
    from speech_cloner_tpu_torch.apps import train_speaker_id as pts
    from speech_cloner_tpu_torch.runtime import config

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
        config.float32_products("cpu")
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        config.float32_products("cuda")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = flags

    calls = []
    for app in (pte, ptd, pts):
        monkeypatch.setattr(app, "float32_products", calls.append)
    common = ["--ds-cfg", str(work / "ds.json"), "--max-steps", "0", "--bn-recal", "0",
              "--device", "cpu"]
    pte.main(["--ds-path", str(work / "timit"), "--enc-cfg", str(work / "enc.json"),
              "--model-path", str(tmp_path / "enc"), "--log-dir", str(tmp_path / "el"), *common])
    ptd.main(["--ds-path", str(work / "arctic"), "--enc-ckpt", str(tmp_path / "enc"),
              "--enc-cfg", str(work / "enc.json"), "--dec-cfg", str(work / "dec.json"),
              "--model-path", str(tmp_path / "dec"), "--log-dir", str(tmp_path / "dl"), *common])
    pts.main(["--ds-path", str(work / "timit"), "--model-path", str(tmp_path / "spk"),
              "--batch-size", "4", *common])
    assert [str(d) for d in calls] == ["cpu"] * 3
