"""The port's conversion server (``apps/serve``), in process on the CPU.

Checkpoints are ``.npz`` directories that the port's ``Checkpointer.save``
writes from `init_trees` (seed 0) at a tiny geometry. Each server runs on a
thread joined with a time limit of its own, so a hang fails its test instead
of stalling the suite. The records are the JAX server's: one JSON line each.
"""

import io
import json
import os
import sys
import threading
import wave

import numpy as np
import pytest
import torch
from test_torch_port_weights import DEC_CFG_D, ENC_CFG_D

from speech_cloner_tpu_torch.apps import serve as tserve
from speech_cloner_tpu_torch.data.audio_io import load_audio, write_riff_wav
from speech_cloner_tpu_torch.models import decoder as tdec
from speech_cloner_tpu_torch.models import encoder as tenc
from speech_cloner_tpu_torch.pipeline.clone import init_trees, make_pipeline
from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer

torch.set_num_threads(2)
SERVER_TIMEOUT_S = 240
SPW = 3840           # samples per 48-frame window at hop 80


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_models")
    enc_cfg, dec_cfg = tenc.config_from_cfg_d(ENC_CFG_D), tdec.config_from_cfg_d(DEC_CFG_D)
    for name, (params, state) in zip(("encoder", "decoder"), init_trees(enc_cfg, dec_cfg, 0)):
        Checkpointer(str(root / name), name).save(
            {"params": params, "model_state": state, "step": 3}, step=3)
    for name, d in (("enc.json", ENC_CFG_D), ("dec.json", DEC_CFG_D)):
        (root / name).write_text(json.dumps(d))
    flags = ["--enc-ckpt", str(root / "encoder"), "--dec-ckpt", str(root / "decoder"),
             "--enc-cfg", str(root / "enc.json"), "--dec-cfg", str(root / "dec.json"),
             "--n-iter", "4", "--device", "cpu"]
    return {"root": root, "flags": flags, "enc_cfg": enc_cfg, "dec_cfg": dec_cfg}


def clip_file(path, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    y = 0.3 * np.sin(2 * np.pi * (180 + 40 * seed) * t) + 0.02 * rng.standard_normal(n)
    write_riff_wav(str(path), y.astype(np.float32), 16000)
    return str(path)


def run_server(argv, monkeypatch, capsys, stdin=""):
    """serve.main(argv) on a thread with a time limit; its records."""
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    errors = []

    def target():
        try:
            tserve.main(argv)
        except BaseException as e:          # noqa: BLE001  (re-raised below)
            errors.append(e)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(SERVER_TIMEOUT_S)
    assert not t.is_alive(), f"server still running after {SERVER_TIMEOUT_S} s"
    if errors:
        raise errors[0]
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def read_pcm(path):
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def test_serve_stdin_protocol(models, tmp_path, monkeypatch, capsys):
    """A bare path, a JSON request with an explicit output, and a malformed
    line (an error record; the server goes on)."""
    src = clip_file(tmp_path / "a.wav", SPW + 300, seed=1)
    explicit = str(tmp_path / "out" / "again.wav")
    stdin = (src + "\n" + '{"broken json\n' + "\n"
             + json.dumps({"input": src, "output": explicit}) + "\n")
    recs = run_server(models["flags"] + ["--output-dir", str(tmp_path / "out"),
                                         "--max-requests", "2"], monkeypatch, capsys, stdin)
    bad = [r for r in recs if "request" in r]
    assert len(bad) == 1 and "bad request" in bad[0]["error"]
    results = [r for r in recs if "input" in r]
    assert [r["output"] for r in results] == [str(tmp_path / "out" / "a_pred.wav"), explicit]
    for r in results:
        assert "error" not in r and r["rtf"] > 0 and r["duration_s"] == round(
            (SPW + 300) / 16000, 3)
        assert {"wall_s", "host_s", "ts"} <= set(r)
    # the server's PCM is the API's convert_pcm16 of the same clip and weights
    pipe = make_pipeline(models["enc_cfg"], models["dec_cfg"], seed=0, device="cpu",
                         n_iter=4, realse=1.2, gl_dft="matmul")
    want = pipe.convert_pcm16(load_audio(src, 16000))
    np.testing.assert_array_equal(read_pcm(explicit), want)


def test_serve_watch_mode(models, tmp_path, monkeypatch, capsys):
    """Files in the inbox convert once stable across two polls; an
    undecodable one gives an error record and is not retried."""
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    clip_file(inbox / "a.wav", 2 * SPW, seed=2)
    (inbox / "broken.wav").write_bytes(b"RIFFnotawav")
    recs = run_server(models["flags"] + ["--output-dir", str(tmp_path / "w"),
                                         "--watch", str(inbox), "--poll", "0.05",
                                         "--max-requests", "2"], monkeypatch, capsys)
    assert recs[0] == {"watching": str(inbox), "output_dir": str(tmp_path / "w"),
                       "ts": recs[0]["ts"]}
    ok = [r for r in recs if "input" in r and "error" not in r]
    err = [r for r in recs if "input" in r and "error" in r]
    assert len(ok) == 1 and ok[0]["input"].endswith("a.wav")
    assert os.path.exists(ok[0]["output"]) and ok[0]["output"].endswith("a_pred.wav")
    assert len(err) == 1 and err[0]["input"].endswith("broken.wav")


def test_serve_batched_drain_two_buckets(models, tmp_path, monkeypatch, capsys):
    """A burst alternating two window buckets drains at once and batches per
    bucket; each served file is, bit for bit, the API's conversion of its
    chunk: convert_batch_pcm16 (seed 0) of the same clips in the same order,
    or convert_pcm16 of a clip served alone."""
    paths = [clip_file(tmp_path / f"m{i}.wav", (1, 2)[i % 2] * SPW - 100, seed=i)
             for i in range(4)]
    recs = run_server(models["flags"] + ["--output-dir", str(tmp_path / "b"),
                                         "--max-requests", "4", "--batch-max", "2",
                                         "--batch-backlog", "0", "--warm", "0.2",
                                         "--queue-depth", "8"],
                      monkeypatch, capsys, "".join(p + "\n" for p in paths))
    warm = [r for r in recs if "warmed_s" in r]
    # --warm 0.2: the 1-window bucket and the next, each alone and as a batch of 2
    assert [(r["warmed_s"], r.get("batch")) for r in warm] == [
        (0.24, None), (0.24, 2), (0.48, None), (0.48, 2)]
    results = [r for r in recs if "rtf" in r]
    assert len(results) == 4 and all("error" not in r for r in results)
    by_bucket = {}
    for r in results:
        by_bucket.setdefault(r["duration_s"] > SPW / 16000, []).append(r["batch"])
        assert np.abs(read_pcm(r["output"])).max() == 32767
    assert max(by_bucket[False]) == 2 and max(by_bucket[True]) == 2
    # a chunk's records come out together, in the chunk's order
    pipe = make_pipeline(models["enc_cfg"], models["dec_cfg"], seed=0, device="cpu",
                         n_iter=4, realse=1.2, gl_dft="matmul")
    i = 0
    while i < len(results):
        chunk = results[i:i + results[i]["batch"]]
        assert {(r["batch"], r["wall_s"]) for r in chunk} == {(len(chunk), chunk[0]["wall_s"])}
        wavs = [load_audio(r["input"], 16000) for r in chunk]
        want = pipe.convert_batch_pcm16(wavs) if len(wavs) > 1 else [pipe.convert_pcm16(wavs[0])]
        for r, w in zip(chunk, want):
            np.testing.assert_array_equal(read_pcm(r["output"]), w)
        i += len(chunk)


def test_serve_timeout_reports_late(models, tmp_path, monkeypatch, capsys):
    """--timeout shorter than any conversion: an error record first, then
    the result marked late."""
    src = clip_file(tmp_path / "t.wav", SPW, seed=3)
    recs = run_server(models["flags"] + ["--output-dir", str(tmp_path / "t"),
                                         "--max-requests", "1", "--timeout", "0.001"],
                      monkeypatch, capsys, src + "\n")
    timeouts = [r for r in recs if "timeout" in r.get("error", "")]
    late = [r for r in recs if r.get("late")]
    assert len(timeouts) == 1 and timeouts[0]["input"] == src
    assert len(late) == 1 and "error" not in late[0] and os.path.exists(late[0]["output"])
    assert recs.index(timeouts[0]) < recs.index(late[0])


@pytest.mark.parametrize("flag", [["--verify-ckpt", "x"], ["--target-spk", "x"]])
def test_serve_rejects_unported(models, flag, capsys):
    """The speaker-ID flags are ported; what the server still refuses at
    start is their misuse: a --verify-ckpt directory without a speaker-ID
    checkpoint, and --target-spk without --verify-ckpt."""
    with pytest.raises(SystemExit) as e:
        tserve.main(models["flags"] + flag)
    assert e.value.code == 2
    want = {"--verify-ckpt": "no speaker_id checkpoint", "--target-spk": "needs --verify-ckpt"}
    assert want[flag[0]] in capsys.readouterr().err


@pytest.mark.parametrize("target", [None, "b"], ids=["no_target", "target"])
def test_serve_verify_ckpt(models, tmp_path, monkeypatch, capsys, target):
    """--verify-ckpt (and --target-spk): each record carries the speaker-ID
    report of the JAX server's keys; requests convert one by one even with
    --batch-max (as the JAX server does)."""
    from speech_cloner_tpu_torch.models import speaker_id as spk_m

    cfg = spk_m.SpeakerIdConfig(n_timesteps=48, n_output=3)
    params, state = spk_m.init_tree(torch.Generator().manual_seed(0), cfg)
    Checkpointer(str(tmp_path / "spk"), "speaker_id").save(
        {"params": params, "model_state": state}, step=1,
        config={"n_timesteps": 48, "n_features": cfg.n_features, "n_output": 3,
                "time_fold": 1, "spk_id_v": ["a", "b", "c"]})
    srcs = [clip_file(tmp_path / f"v{i}.wav", SPW + 100 * i, seed=i) for i in range(2)]
    flags = ["--verify-ckpt", str(tmp_path / "spk"), "--batch-max", "2", "--batch-backlog", "0",
             "--output-dir", str(tmp_path / "out"), "--max-requests", "2"]
    recs = run_server(models["flags"] + flags + (["--target-spk", target] if target else []),
                      monkeypatch, capsys, "".join(s + "\n" for s in srcs))
    results = [r for r in recs if "input" in r]
    assert [r["input"] for r in results] == srcs
    keys = {"true_top", "pred_top", "identity_changed", "n_windows_true", "n_windows_pred"}
    if target:
        keys |= {"target_spk_id", "target_p_true", "target_p_pred", "target_hit"}
    for r in results:
        assert "error" not in r and "batch" not in r and os.path.exists(r["output"])
        assert set(r["verification"]) == keys
        assert r["verification"]["n_windows_pred"] >= 1
