"""The port's streaming server and the two streaming apps against the JAX
package, on the CPU.

`StreamServer` of both packages runs over the same pipeline trees (the tiny
geometry of tests/test_serve_stream.py, carried over with
``runtime/jax_params.py``) and the same requests: every record is the JAX
one, its int16 PCM within PCM_LSB. ``apps.stream.main`` and
``apps.serve_stream.main`` of both packages run in process over the same
``.npz`` checkpoints (the port's `Checkpointer.save` of `init_trees`' seed-0
weights) with ``--device cpu`` on the port's side.
"""

import base64
import io
import json
import sys

import numpy as np
import pytest
import torch
from test_serve_stream import _speechy_wav
from test_torch_port_pipeline import pipes  # noqa: F401
from test_torch_port_weights import DEC_CFG_D, ENC_CFG_D

from speech_cloner_tpu.apps import serve_stream as jserve
from speech_cloner_tpu.apps import stream as jstream_app
from speech_cloner_tpu_torch.apps import serve_stream as tserve
from speech_cloner_tpu_torch.apps import stream as tstream_app
from speech_cloner_tpu_torch.data.audio_io import read_riff_wav, write_riff_wav
from speech_cloner_tpu_torch.models import decoder as tdec
from speech_cloner_tpu_torch.models import encoder as tenc
from speech_cloner_tpu_torch.pipeline.clone import init_trees
from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer

torch.set_num_threads(2)
KW = dict(chunk_frames=64, context_frames=64, lookahead_frames=48, margin_frames=8)
GEOMETRY = ["--chunk-frames", "64", "--context-frames", "64", "--lookahead-frames", "48",
            "--margin-frames", "8", "--n-iter", "4"]
# float32 both sides; the waveform gap (under 3e-6 of the peak, the stream
# tests) can still move a sample across an int16 rounding boundary
PCM_LSB = 1


def pcm(rec: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(rec["pcm16"]), "<i2").astype(np.int32)


def assert_records_match(got: list[dict], ref: list[dict]):
    """Same records in the same order; pcm16 within PCM_LSB, ``ts`` and
    ``compile_s`` (wall clock) not compared."""
    assert len(got) == len(ref), ([sorted(r) for r in got], [sorted(r) for r in ref])
    for g, r in zip(got, ref):
        assert set(g) == set(r), (g, r)
        for k in r:
            if k == "pcm16":
                a, b = pcm(g), pcm(r)
                assert a.shape == b.shape and np.abs(a - b).max() <= PCM_LSB, k
            elif k not in ("ts", "compile_s"):
                assert g[k] == r[k], (k, g, r)


def lifecycle(server_cls, pipe) -> list[dict]:
    """tests/test_serve_stream.py's session life cycle: two sessions, a
    double open, a full server, unknown sessions, alice drained while bob
    runs, carol reusing alice's slot, EOF, then dave fed exactly 2 blocks."""
    srv = server_cls(pipe, slots=2, **KW)
    recs = [srv.open("alice"), srv.open("alice"), srv.open("bob"), srv.open("carol"),
            srv.feed("nobody", np.zeros(10, np.float32)), srv.close("nobody")]
    srv.feed("alice", _speechy_wav(1.5, seed=31))
    srv.feed("bob", 0.5 * _speechy_wav(2.5, seed=32))
    while srv.ready():
        recs.extend(srv.tick())
    recs.append(srv.close("alice"))
    while srv.ready():
        recs.extend(srv.tick())
    recs.append(srv.feed("alice", _speechy_wav(0.1)))
    recs.append(srv.open("carol"))
    srv.feed("carol", _speechy_wav(1.0, seed=33))
    recs.extend(srv.drain())
    recs.append(srv.open("dave"))
    srv.feed("dave", np.tile(_speechy_wav(0.5, seed=34), 2)[: 2 * srv.block])
    srv.close("dave")
    recs.extend(srv.drain())
    assert not srv.sessions and sorted(srv.free) == [0, 1]
    return [r for r in recs if r is not None]


def test_server_records_match_jax(pipes):  # noqa: F811
    jp, tp = pipes
    got = lifecycle(tserve.StreamServer, tp)
    assert_records_match(got, lifecycle(jserve.StreamServer, jp))
    closed = {r["closed"]: r["seconds"] for r in got if "closed" in r}
    assert closed == {"alice": 1.5, "bob": 2.5, "carol": 1.0, "dave": 2 * 64 * 80 / 16000}
    out = {sid: sum(pcm(r).size for r in got if r.get("sid") == sid and "pcm16" in r)
           for sid in closed}
    assert out == {sid: round(s * 16000) for sid, s in closed.items()}


def test_neighbour_slot_isolated_under_churn(pipes):  # noqa: F811
    """alice's converted audio is byte-identical whether slot 1 holds one
    long session or three short ones that open and close around her."""
    _, tp = pipes
    alice = _speechy_wav(3.0, seed=41)

    def run(churn: bool) -> np.ndarray:
        srv = tserve.StreamServer(tp, slots=2, seed=3, **KW)
        srv.open("alice")
        srv.feed("alice", alice)
        recs = []
        neighbours = ([_speechy_wav(0.6, seed=s) * g for s, g in ((42, 1.0), (43, 0.2), (44, 3.0))]
                      if churn else [_speechy_wav(3.0, seed=45)])
        for k, wav in enumerate(neighbours):
            srv.open(f"n{k}")
            srv.feed(f"n{k}", wav)
            while srv.ready():
                recs.extend(srv.tick())
            srv.close(f"n{k}")
            while f"n{k}" in srv.sessions:
                recs.extend(srv.tick())
        recs.extend(srv.drain())
        return np.concatenate([pcm(r) for r in recs if r.get("sid") == "alice"])

    base, churned = run(False), run(True)
    # past her audio, alice is padded with silence for as long as slot 1 ticks
    assert min(base.size, churned.size) >= alice.size
    np.testing.assert_array_equal(base[:alice.size], churned[:alice.size])


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_models")
    enc_cfg, dec_cfg = tenc.config_from_cfg_d(ENC_CFG_D), tdec.config_from_cfg_d(DEC_CFG_D)
    for name, (params, state) in zip(("encoder", "decoder"), init_trees(enc_cfg, dec_cfg, 0)):
        Checkpointer(str(root / name), name).save(
            {"params": params, "model_state": state, "step": 5}, step=5)
    for name, d in (("enc.json", ENC_CFG_D), ("dec.json", DEC_CFG_D)):
        (root / name).write_text(json.dumps(d))
    return root, ["--enc-ckpt", str(root / "encoder"), "--dec-ckpt", str(root / "decoder"),
                  "--enc-cfg", str(root / "enc.json"), "--dec-cfg", str(root / "dec.json")]


def test_stream_app_matches_jax(ckpts, tmp_path, capsys):
    """Both apps over one clip: the written wavs within PCM_LSB, the same
    stats keys; --realtime adds the emission-lag keys."""
    root, flags = ckpts
    src = str(tmp_path / "in.wav")
    write_riff_wav(src, _speechy_wav(2.2, seed=51), 16000)
    common = flags + GEOMETRY + ["--input", src, "--block-ms", "50"]
    ref = jstream_app.main(common + ["--output", str(tmp_path / "jax.wav")])
    got = tstream_app.main(common + ["--output", str(tmp_path / "port.wav"), "--device", "cpu",
                                     "--stats-json", str(tmp_path / "stats.json")])
    capsys.readouterr()
    assert set(got) == set(ref)
    assert json.loads((tmp_path / "stats.json").read_text()) == got
    for k in ("audio_s", "chunks", "algorithmic_latency_s", "realtime"):
        assert got[k] == ref[k], k
    a, _ = read_riff_wav(str(tmp_path / "port.wav"))
    b, _ = read_riff_wav(str(tmp_path / "jax.wav"))
    assert a.shape == b.shape == ((35200 // 80 + 1) * 80,)
    assert np.abs(np.round(a * 32768) - np.round(b * 32768)).max() <= PCM_LSB
    live = tstream_app.main(common + ["--output", str(tmp_path / "live.wav"), "--device", "cpu",
                                      "--realtime", "--t-e", "1.2"])
    assert set(live) == set(ref) | {"emit_lag_s_p50", "emit_lag_s_max"} and live["realtime"]


def test_stream_app_without_decoder_uses_seed0_decoder(ckpts, tmp_path, capsys):
    """No --dec-ckpt: the JAX app's warning, and the decoder init_trees draws
    from seed 0 (the same output as its checkpoint)."""
    root, flags = ckpts
    src = str(tmp_path / "in.wav")
    write_riff_wav(src, _speechy_wav(1.2, seed=52), 16000)
    args = GEOMETRY + ["--input", src, "--device", "cpu", "--enc-cfg", str(root / "enc.json"),
                       "--dec-cfg", str(root / "dec.json"), "--enc-ckpt", str(root / "encoder")]
    tstream_app.main(args + ["--output", str(tmp_path / "a.wav")])
    assert "WARNING: no --dec-ckpt; using randomly initialized decoder" in capsys.readouterr().out
    tstream_app.main(args + ["--output", str(tmp_path / "b.wav"), "--dec-ckpt",
                             str(root / "decoder")])
    np.testing.assert_array_equal(read_riff_wav(str(tmp_path / "a.wav"))[0],
                                  read_riff_wav(str(tmp_path / "b.wav"))[0])


def run_server(main, argv, stdin: str, monkeypatch, capsys) -> list[dict]:
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    main(argv)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_serve_stream_app_matches_jax(ckpts, tmp_path, monkeypatch, capsys):
    """The JSONL protocol end to end: --warm, two sessions fed pcm16 records
    and a file, a bad line, an unknown request, a tick, closes and EOF;
    the records of both servers match."""
    _, flags = ckpts
    src = str(tmp_path / "b.wav")
    write_riff_wav(src, 0.5 * _speechy_wav(1.3, seed=62), 16000, norm=False)
    a = (_speechy_wav(2.0, seed=61) * 0.5 * 32767).astype("<i2")
    lines = [{"open": "a"}, {"open": "b"}, {"sid": "b", "input": src}]
    lines += [{"sid": "a", "pcm16": base64.b64encode(a[i:i + 4000].tobytes()).decode()}
              for i in range(0, a.size, 4000)]
    lines += [{"close": "b"}, {"tick": True}, {"hello": 1}, {"close": "a"}]
    stdin = "\n".join(json.dumps(x) for x in lines) + "\n{not json\n"
    argv = flags + GEOMETRY + ["--slots", "2", "--warm"]
    got = run_server(tserve.main, argv + ["--device", "cpu"], stdin, monkeypatch, capsys)
    ref = run_server(jserve.main, argv, stdin, monkeypatch, capsys)
    assert_records_match(got, ref)
    assert got[0]["warmed"] and {r["closed"] for r in got if "closed" in r} == {"a", "b"}
    assert sum("error" in r for r in got) == 2


def test_serve_stream_mesh_waits_for_parallel(ckpts, tmp_path, monkeypatch, capsys):
    """--mesh is ported ("Parallel"): --mesh 2 on the CPU (the 2 shards share
    it) serves the records of the JAX server's --mesh 2 over 2 of its
    virtual devices; 3 slots over 2 shards is an error in both."""
    _, flags = ckpts
    a = (_speechy_wav(1.6, seed=63) * 0.5 * 32767).astype("<i2")
    lines = [{"open": "a"}, {"open": "b"}]
    lines += [{"sid": sid, "pcm16": base64.b64encode(a[i:i + 4000].tobytes()).decode()}
              for i in range(0, a.size, 4000) for sid in ("a", "b")]
    lines += [{"close": "a"}, {"close": "b"}]
    stdin = "\n".join(json.dumps(x) for x in lines) + "\n"
    argv = flags + GEOMETRY + ["--slots", "2", "--mesh", "2"]
    got = run_server(tserve.main, argv + ["--device", "cpu"], stdin, monkeypatch, capsys)
    ref = run_server(jserve.main, argv, stdin, monkeypatch, capsys)
    assert_records_match(got, ref)
    assert {r["closed"] for r in got if "closed" in r} == {"a", "b"}
    with pytest.raises(ValueError):
        tserve.main(flags + GEOMETRY + ["--slots", "3", "--mesh", "2", "--device", "cpu"])


def test_decode_pcm16_matches_jax():
    raw = np.array([-32768, -1, 0, 1, 32767], "<i2").tobytes()
    b64 = base64.b64encode(raw).decode()
    np.testing.assert_array_equal(tserve._decode_pcm16(b64), jserve._decode_pcm16(b64))

