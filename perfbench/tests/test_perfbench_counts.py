"""The yardstick: roofline and utilization counts against hand-worked
values at the shipped widths, and the readers' silence without data."""

from __future__ import annotations

import json
import math

from tiny import PERFBENCH

from benchlib import layers, work

F32 = json.loads((PERFBENCH / "configs" / "ppg_vc_f32.json").read_text())
BF16 = json.loads((PERFBENCH / "configs" / "ppg_vc_bf16.json").read_text())


def test_convert_scan_bound():
    # 2 directions x 6 T B H^2 over H = 40, 128, 256 at T = 400, B = 59 rows, 67 TFLOP/s:
    # 0.353 ms of operations; the H = 40 scans are bound by their bytes instead
    # (gx, cx, ys and the weights, 15.1 MB a direction at 3.35 TB/s)
    ops = 2 * 6 * 400 * 59 * (40**2 + 128**2 + 256**2) / 67e12
    assert math.isclose(ops * 1e3, 0.3530, abs_tol=5e-5)
    h40_bytes = 2 * 4 * (4 * 400 * 59 * 40 + 3 * 40 * 40) / 3.35e12
    want = ops - 2 * 6 * 400 * 59 * 40**2 / 67e12 + h40_bytes
    assert math.isclose(work.scans_bound_s(F32, 400, 59), want, rel_tol=1e-12)
    assert math.isclose(want * 1e3, 0.3553, abs_tol=5e-5)


def test_bf16_scan_bound_is_bytes():
    # bf16 at 989 TFLOP/s: the bytes bound wins at H = 40
    T, B, H = 400, 59, 40
    assert math.isclose(work.scan_bound_s(T, B, H, "bfloat16"),
                        2 * (4 * T * B * H + 3 * H * H) / 3.35e12, rel_tol=1e-12)


def test_bank_count_takes_nonzero_taps():
    assert work.bank_taps(32) == 528 == sum(range(1, 33))
    frames = 59 * 400
    flops = 2 * frames * 128 * (40 * 21 + 128 * 528 + 256 * 528)
    assert math.isclose(work.banks_bound_s(F32, frames), flops / 67e12, rel_tol=1e-3)


def test_model_flops_per_frame():
    enc = 2 * (80 * 80 + 80 * 40) + 2 * 40 * 128 * 21 + 2 * 3 * 6 * 128 * 40 + 2 * 3 * 40 * 40 \
        + 2 * 2 * 40 * 40 + 24 * 40 * 40 + 2 * 80 * 61
    s1 = 2 * (61 * 256 + 256 * 128) + 2 * 128 * 128 * 528 + 2 * 3 * 4096 * 128 \
        + 2 * 3 * 128 * 128 + 4 * 4 * 128 * 128 + 24 * 128 * 128 + 2 * 256 * 80
    s2 = 2 * (80 * 512 + 512 * 256) + 2 * 256 * 128 * 528 + 2 * 3 * 4096 * 256 \
        + 2 * 3 * 256 * 256 + 6 * 4 * 256 * 256 + 24 * 256 * 256 + 2 * 512 * 201
    assert work.model_flops_per_frame(F32) == enc + s1 + s2
    assert 66e6 < enc + s1 + s2 < 68e6


def test_peak_seconds_by_dtype():
    f32 = work.step_seconds_at_peak(F32, 100, 0, 0, 1)
    bf16 = work.step_seconds_at_peak(BF16, 100, 0, 0, 1)
    assert math.isclose(f32 / bf16, 989 / 67, rel_tol=1e-9)
    fft = work.step_seconds_at_peak(F32, 0, 10, 0, 1) * 67e12
    assert math.isclose(fft, 10 * 5 * 400 * math.log2(400), rel_tol=1e-12)


def test_readers_silent_without_data():
    ctx = layers.LayerContext(units=0, window_s=0.0, spans_ms={}, scan_bound_s=1.0,
                              banks_bound_s=1.0, peak_s=1.0, banks_per_unit=3, profile=None,
                              profiled_units=0)
    for f in (layers.scan_roofline, layers.banks_roofline, layers.mfu, layers.idle_share):
        assert f(ctx) is None
    assert layers.span_median(ctx, "predict") is None


def test_readers_on_data():
    prof = {"window_s": 2.0, "busy_s": 1.5, "scan_s": 0.01}
    ctx = layers.LayerContext(units=10, window_s=5.0, spans_ms={"banks": [4.0] * 6},
                              scan_bound_s=0.001, banks_bound_s=0.002, peak_s=0.05,
                              banks_per_unit=3, profile=prof, profiled_units=2)
    assert math.isclose(layers.scan_roofline(ctx), 20.0)
    assert math.isclose(layers.banks_roofline(ctx), 100 * 0.002 * 2 / 0.024)
    assert math.isclose(layers.mfu(ctx), 10.0)
    assert math.isclose(layers.idle_share(ctx), 25.0)
