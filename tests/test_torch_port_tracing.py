"""The port's span recorder (``runtime/profiler.py``) on the clip, stream-step
and long-form paths: nothing recorded and no profiler event while it is
off; with it on, the span tree of each path, one unit per call, and the
spans as events of a torch.profiler window that nest the call's ``aten::``
operations. One test, marked ``gpu``, reads the spans' device time on the
card. Imports no JAX, so the card's machine runs it with ``--noconftest``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speech_cloner_tpu_torch.models import decoder as tdec
from speech_cloner_tpu_torch.models import encoder as tenc
from speech_cloner_tpu_torch.pipeline.clone import make_pipeline
from speech_cloner_tpu_torch.pipeline.stream import StreamingCloner
from speech_cloner_tpu_torch.runtime import profiler

torch.set_num_threads(2)
# the tiny geometry of tests/test_torch_port_pipeline.py
T_ENC = tenc.EncoderConfig(n_timesteps=48, input_dim=80, n_output=61,
                           num_conv_banks=2, num_highwaynet_blocks=1)
T_DEC = tdec.DecoderConfig(n_timesteps=48, input_dim=61,
                           step1=tdec.DecoderStepConfig(32, 2, 1, 80),
                           step2=tdec.DecoderStepConfig(48, 2, 1, 201))
STREAM_KW = dict(chunk_frames=64, context_frames=64, lookahead_frames=48, margin_frames=8)

STEP = ("stream.gains", "stream.phases", "stream.forward", "stream.vocode", "stream.to_host",
        "stream.emit")
# each path's spans: child -> parent, and how many times a call opens each
TREES = {
    "convert_pcm16": ({"convert": None, "predict": "convert", "predict.features": "predict",
                       "predict.models": "predict", "predict.stitch": "predict",
                       "vocode": "convert", "convert.to_host": "convert"}, {}),
    "convert_batch_pcm16": ({"convert": None, "predict": "convert",
                             "predict.features": "predict", "predict.models": "predict",
                             "predict.stitch": "predict", "vocode": "convert",
                             "convert.to_host": "convert"}, {}),
    "push": ({"stream.push": None, "stream.step": "stream.push",
              **{k: "stream.step" for k in STEP}, "stream.upload": ("stream.forward",
                                                                    "stream.vocode")},
             {"stream.upload": 3}),
    "flush": ({"stream.flush": None, "stream.step": "stream.flush",
               **{k: "stream.step" for k in STEP}, "stream.upload": ("stream.forward",
                                                                     "stream.vocode")},
              {"stream.upload": 3}),
    "convert_seq_parallel": ({"longform": None, "longform.features": "longform",
                              "longform.forward": "longform", "longform.vocode": "longform",
                              "longform.to_host": "longform"}, {}),
    # the pipeline's own Griffin-Lim under longform.vocode: device_vocode's span nests
    "convert_seq_parallel_one_vocoder": ({"longform": None, "longform.features": "longform",
                                          "longform.forward": "longform",
                                          "longform.vocode": "longform",
                                          "vocode": "longform.vocode",
                                          "longform.to_host": "longform"}, {}),
}
NAMES = {n for tree, _ in TREES.values() for n in tree}


def clip(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    y = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 880 * t)
    return (y + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def pipeline(device):
    return make_pipeline(T_ENC, T_DEC, seed=0, device=device, n_iter=4)


@pytest.fixture(scope="module")
def pipe():
    return pipeline("cpu")


def call(pipe, path: str):
    """The path as a function of no arguments; the stream's flush follows a
    push on its own cloner, made here so that push is not part of the call."""
    wav = clip(1.0)
    if path == "flush":
        pushed = StreamingCloner(pipe, **STREAM_KW)
        pushed.push(wav[:12000])
        return pushed.flush
    return {"convert_pcm16": lambda: pipe.convert_pcm16(wav, seed=1),
            "convert_batch_pcm16": lambda: pipe.convert_batch_pcm16([wav, wav[:9000]], seed=1),
            "push": lambda: StreamingCloner(pipe, **STREAM_KW).push(wav),
            "convert_seq_parallel": lambda: pipe.convert_seq_parallel(wav, n_devices=1,
                                                                      warmup=48, seed=1),
            "convert_seq_parallel_one_vocoder": lambda: pipe.convert_seq_parallel(
                wav, n_devices=1, warmup=48, seed=1, sp_vocoder=False)}[path]


def recorded(fn):
    profiler.take()
    with profiler.recording():
        fn()
    return profiler.take()


def check_tree(recs, path: str) -> None:
    tree, counts = TREES[path]
    assert recs, path
    assert {r.name for r in recs} == set(tree)
    assert len({r.unit for r in recs}) == 1                 # one call, one unit
    for r in recs:
        want = tree[r.name]
        if want is None:
            assert r.parent is None
            continue
        parent = recs[r.parent]
        assert parent.name in (want if isinstance(want, tuple) else (want,)), (r.name, parent)
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    for r in recs:
        assert r.host_ms >= 0 and 0 <= r.self_ms <= r.host_ms
        kids = sum(c.host_ms for c in recs if c.parent is not None and recs[c.parent] is r)
        assert r.self_ms == pytest.approx(r.host_ms - kids, abs=1e-9)
    steps = sum(r.name == "stream.step" for r in recs) or 1
    for name, n in counts.items():
        assert sum(r.name == name for r in recs) == n * steps, name


@pytest.mark.parametrize("path", list(TREES))
def test_off_leaves_no_record_and_no_profiler_event(pipe, path):
    fn = call(pipe, path)
    profiler.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    assert profiler.take() == []
    names = {e.name for e in prof.events()}
    assert not names & NAMES
    assert any(n.startswith("aten::") for n in names)


def test_off_span_is_one_shared_null_context(monkeypatch):
    """A span site creates no CUDA event and enters no record_function
    while the recorder is off."""
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(a) or None)
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: made.append(a))
    a, b = profiler.span("x", "cuda"), profiler.span("y")
    assert a is b
    with a:
        pass
    assert made == [] and profiler.take() == []


@pytest.mark.parametrize("path", list(TREES))
def test_on_gives_the_span_tree(pipe, path):
    recs = recorded(call(pipe, path))
    check_tree(recs, path)
    assert all(r.device_ms is None for r in recs)             # no CUDA device here


def test_units_count_calls_and_take_clears(pipe):
    wav = clip(0.5)
    profiler.take()
    with profiler.recording():
        pipe.convert_pcm16(wav)
        pipe.convert_pcm16(wav)
        with profiler.span("outer"):
            pipe.convert_pcm16(wav)
    recs = profiler.take()
    units = [r.unit for r in recs if r.parent is None]
    assert len(units) == 3 and len(set(units)) == 3
    assert {r.unit for r in recs} == set(units)
    outer = next(r for r in recs if r.name == "outer")
    assert recs[next(i for i, r in enumerate(recs) if r.name == "convert" and
                     r.unit == outer.unit)].parent == recs.index(outer)
    assert profiler.take() == []
    with profiler.recording():
        with profiler.span("open"):
            with pytest.raises(RuntimeError, match="still open"):
                profiler.take()
    assert [r.name for r in profiler.take()] == ["open"]


@pytest.mark.parametrize("path,span,op", [("convert_pcm16", "predict.models", "aten::"),
                                          ("push", "stream.forward", "aten::"),
                                          ("push", "stream.upload", "aten::to"),
                                          ("convert_seq_parallel", "longform.forward", "aten::")])
def test_spans_are_profiler_events_nesting_the_calls_ops(pipe, path, span, op):
    fn = call(pipe, path)
    profiler.take()
    with profiler.recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    recs = profiler.take()
    events = prof.events()
    spans = [e for e in events if e.name == span]
    assert len(spans) == sum(r.name == span for r in recs) > 0
    for s in spans:
        inside = [e for e in events if e.name.startswith(op)
                  and s.time_range.start <= e.time_range.start
                  and e.time_range.end <= s.time_range.end]
        assert inside, (span, op)
    assert {r.name for r in recs} <= {e.name for e in events}


def test_trace_turns_the_recorder_on(tmp_path):
    """The trace file names a span opened inside `trace`; the records the
    trace made are dropped at its end, unless a `recording` encloses it."""
    profiler.take()
    with profiler.trace(str(tmp_path / "alone"), device="cpu"):
        with profiler.span("in_trace"):
            torch.ones(4) + 1
    with profiler.span("after_trace"):
        pass
    assert profiler.take() == []
    (f,) = (tmp_path / "alone").glob("*.json")
    assert "in_trace" in f.read_text()
    with profiler.recording():
        with profiler.span("before"):
            pass
        with profiler.trace(str(tmp_path / "inside"), device="cpu"):
            with profiler.span("in_trace"):
                torch.ones(4) + 1
    assert [r.name for r in profiler.take()] == ["before", "in_trace"]


@pytest.mark.gpu
def test_spans_read_device_time_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pipe = pipeline("cuda")
    for path in TREES:
        call(pipe, path)()                                     # warm up
        recs = recorded(call(pipe, path))
        check_tree(recs, path)
        for r in recs:
            if r.name not in STEP or r.name in ("stream.forward", "stream.vocode",
                                                "stream.to_host"):
                assert r.device_ms is not None and r.device_ms > 0, (path, r)
            else:
                assert r.device_ms is None, (path, r)          # host work: no events
        by = {r.name: r.device_ms for r in recs}
        if "predict" in by:
            assert by["predict.models"] <= by["predict"]
