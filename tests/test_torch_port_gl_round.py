"""The Griffin-Lim round kernel's CPU side: its plain version
(`gl_round_plain`, the kernel's tiled arithmetic: halo, segment
overlap-add, envelope, reflect edges, projection) against today's rounds
through ``istft`` / ``stft`` with the matmul DFT, its launch plan
(`gl_round_plan`, csrc/griffin_lim.cu), and the rule that decides where
`griffin_lim` runs it.

Tolerances, relative to the magnitudes' peak, float32 on both sides: the
plain version's matmuls and `istft` / `stft`'s cut the same products into
other tiles, which moves S' by ~1e-6 of the peak in most bins; a bin whose
projection X is nearly 0 has an ill-conditioned phase, so the largest gap
over a few thousand bins reaches 1.8e-3 after one round and 2.2e-3 after
eight (measured here against the float64 FFT rounds, where the matmul path
itself reads 1.3e-3), hence MAX_TOL; over all bins the gap stays ~1e-5 of
the magnitudes' norm (L2_TOL). A wrong halo, overlap-add, envelope, reflect
edge or projection moves S' by O(1) of the peak.
"""

import dataclasses
import math
import sys

import numpy as np
import pytest
import torch

from speech_cloner_tpu_torch.ops import cuda_kernels as ck
from speech_cloner_tpu_torch.ops.stft import _window, istft, stft, window_sumsquare
from speech_cloner_tpu_torch.pipeline import vocoder as V

torch.set_num_threads(2)
TGL = sys.modules["speech_cloner_tpu_torch.ops.griffin_lim"]
H100 = (232448, 132)              # opt-in shared memory a block, SMs
MAX_TOL = 5e-3
L2_TOL = 1e-4


def operands(B, T, seed):
    """B clips of different content: magnitudes with a speech-like spread
    (uniform to the 4th power) and a uniform phase, as `griffin_lim` draws it."""
    g = torch.Generator().manual_seed(seed)
    amp = 10 * torch.rand((B, T, 201), generator=g) ** 4
    return torch.polar(amp, math.pi * torch.rand((B, T, 201), generator=g)), amp


def matmul_rounds(S, amp, n):
    project = lambda x: stft(istft(x, 80, 400, 400, dft="matmul"), 400, 80, 400,  # noqa: E731
                             dft="matmul")
    return TGL.rounds(S, amp, project, n + 1, 0.0)


def plan_with_rows(B, T, rows):
    """The planned launch of B x T moved onto the instance of ``rows``."""
    wr, rl, lanes, _ = next(i for i in ck.GL_INSTANCES if ck.gl_instance_rows(*i[:3]) == rows)
    return dataclasses.replace(ck.gl_round_plan(B, T, 400, 80, *H100), rows=rows,
                               tiles=-(-T // (rows - 4)), warp_rows=wr, lanes=lanes,
                               smem_bytes=ck.gl_round_smem_bytes(rows))


def assert_close_rounds(got, ref, amp):
    peak = amp.max()
    assert (got - ref).abs().max() <= MAX_TOL * peak
    assert torch.linalg.vector_norm(got - ref) <= L2_TOL * torch.linalg.vector_norm(amp)


# T below one tile of 12 frames, at its edge and one either side, over
# several tiles (16 and 32 chunk rows: 12 and 28 frames a tile), 3 clips
@pytest.mark.parametrize("T,rows", [(6, 16), (11, 16), (12, 16), (13, 16), (50, 16), (50, 32),
                                    (61, 32), (130, 64), (190, 96)])
@pytest.mark.parametrize("n", [1, 4])
def test_plain_round_matches_matmul_rounds(T, rows, n):
    S0, amp = operands(3, T, seed=T + rows)
    plan = plan_with_rows(3, T, rows)
    win = _window("hann", 400, 400, torch.device("cpu"))
    env = window_sumsquare("hann", T, 80, 400, 400)
    got = S0
    for _ in range(n):
        got = ck.gl_round_plain(got, amp, win, env, plan)
    ref = matmul_rounds(S0, amp, n)
    assert got.shape == ref.shape and got.dtype == torch.complex64
    assert_close_rounds(got, ref, amp)
    # the magnitudes are put back in every bin
    torch.testing.assert_close(got.abs(), amp, rtol=1e-5, atol=1e-6)


def test_plain_round_clip_by_clip():
    """A clip of a batch takes what it takes alone: tiles never cross clips."""
    S0, amp = operands(3, 40, seed=2)
    win = _window("hann", 400, 400, torch.device("cpu"))
    env = window_sumsquare("hann", 40, 80, 400, 400)
    got = ck.gl_round_plain(S0, amp, win, env, plan_with_rows(3, 40, 16))
    for b in range(3):
        alone = ck.gl_round_plain(S0[b:b + 1], amp[b:b + 1], win, env, plan_with_rows(1, 40, 16))
        torch.testing.assert_close(got[b:b + 1], alone, rtol=0, atol=1e-6 * amp.max().item())


@pytest.mark.parametrize("T", [400, 401, 1400, 2401, 6001, 12001])
@pytest.mark.parametrize("B", [1, 2, 4])
def test_plan_covers_every_frame(T, B):
    plan = ck.gl_round_plan(B, T, 400, 80, *H100)
    assert (plan.B, plan.T) == (B, T)
    assert plan.smem_bytes == ck.gl_round_smem_bytes(plan.rows) <= H100[0]
    assert (plan.rows, plan.warp_rows, plan.lanes) in {
        (ck.gl_instance_rows(wr, rl, lanes), wr, lanes) for wr, rl, lanes, _ in ck.GL_INSTANCES}
    assert plan.threads == 160 * plan.warp_rows
    tiles = [plan.tile(i) for i in range(plan.tiles)]
    assert tiles[0][0] == 0 and tiles[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    # every tile at least 2 frames (the reflect edges read 2 frames' chunks)
    # and at most rows - 4 (its chunks [t0, t1 + 4) within the CTA's rows)
    assert all(2 <= t1 - t0 <= plan.rows - 4 for t0, t1 in tiles)


@pytest.mark.parametrize("B,T,rows,tiles", [
    (1, 12001, 96, 131),        # a 60 s clip: one wave of 131 CTAs of 96 rows
    (1, 1400, 16, 117),         # a 7 s clip: 117 CTAs of 16 rows
    (1, 2401, 32, 86),          # a 12 s clip
    (4, 12001, 64, 201),        # four 60 s clips: 804 CTAs of 64 rows
])
def test_plan_main_path_shapes(B, T, rows, tiles):
    plan = ck.gl_round_plan(B, T, 400, 80, *H100)
    assert (plan.rows, plan.tiles, plan.ctas) == (rows, tiles, B * tiles)


def test_plan_within_the_shared_memory_limit():
    rows = [ck.gl_instance_rows(*i[:3]) for i in ck.GL_INSTANCES]
    assert rows == [16, 32, 64, 96]
    smem = [ck.gl_round_smem_bytes(r) for r in rows]
    assert smem == sorted(smem) and smem[-1] <= H100[0]
    # a 60 s clip takes the largest instance that fits
    for r, limit in zip(rows, smem):
        plan = ck.gl_round_plan(1, 12001, 400, 80, limit, 132)
        assert plan.smem_bytes <= limit and plan.rows == r
    assert ck.gl_round_plan(1, 12001, 400, 80, smem[0] - 1, 132) is None


@pytest.mark.parametrize("args", [(1, 3, 400, 80), (1, 400, 512, 128), (1, 400, 400, 100),
                                  (1, 400, 2048, 300), (0, 400, 400, 80)])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    assert ck.gl_round_plan(*args, *H100) is None


class _Like:
    """What `gl_kernel_takes` reads of a tensor."""

    def __init__(self, is_cuda=True, dtype=torch.float32, requires_grad=False):
        self.is_cuda, self.dtype, self.requires_grad = is_cuda, dtype, requires_grad


# (tensor, dft, momentum, n_fft, win_length, hop): only a float32 CUDA
# tensor autograd does not record, the matmul DFT, no momentum, n_fft ==
# win_length and a hop dividing n_fft take the kernel
@pytest.mark.parametrize("like,dft,momentum,n_fft,win,hop,takes", [
    (_Like(), "matmul", 0.0, 400, 400, 80, True),
    (_Like(is_cuda=False), "matmul", 0.0, 400, 400, 80, False),     # the CPU
    (_Like(), "fft", 0.0, 400, 400, 80, False),                     # the stream, Tacotron
    (_Like(), "matmul", 0.99, 400, 400, 80, False),                 # Fast Griffin-Lim
    (_Like(), "matmul", 0.0, 400, 400, 150, False),                 # hop not dividing n_fft
    (_Like(), "matmul", 0.0, 512, 400, 80, False),                  # n_fft != win_length
    (_Like(dtype=torch.bfloat16), "matmul", 0.0, 400, 400, 80, False),
    (_Like(requires_grad=True), "matmul", 0.0, 400, 400, 80, False),
])
def test_engagement_rule(like, dft, momentum, n_fft, win, hop, takes):
    with torch.set_grad_enabled(True):
        assert TGL.gl_kernel_takes(like, dft, momentum, n_fft, win, hop) == takes


@pytest.mark.parametrize("dft,momentum", [("matmul", 0.0), ("matmul", 0.99), ("fft", 0.0)])
def test_cpu_keeps_todays_rounds(monkeypatch, dft, momentum):
    """On the CPU no call reaches the kernel's entry point, and the
    vocoder's output is today's rounds' to the bit."""
    calls = []
    monkeypatch.setattr(ck, "gl_rounds", lambda *a, **k: calls.append(a))
    P = torch.rand((2, 30, 201), generator=torch.Generator().manual_seed(1))
    phase = math.pi * torch.rand((2, 30, 201), generator=torch.Generator().manual_seed(2))
    got = TGL.from_power_to_wav(P, n_iter=4, realse=1.2, init_phase=phase, momentum=momentum,
                               dft=dft)
    amp = TGL.magnitudes(P, 0.01, 1.2, TGL.clip_means)
    project = lambda x: stft(istft(x, 80, 400, 400, dft=dft), 400, 80, 400, dft=dft)  # noqa: E731
    S = TGL.rounds(torch.polar(amp, phase), amp, project, 4, momentum)
    want = TGL.finish(istft(S, 80, 400, 400, dft=dft), 0.97, 0.01, TGL.clip_means)
    assert not calls
    assert torch.equal(got, want)


def fused_on_the_cpu(monkeypatch):
    """`fused_round_plan` as on a card (the H100's limits), for CPU tensors:
    `griffin_lim` then runs `gl_rounds`, which on the CPU is the plain
    version round by round."""
    real = TGL.fused_round_plan

    def plan(amp, dft, momentum, n_fft, win_length, hop_length):
        if (dft, momentum, n_fft, win_length) != ("matmul", 0.0, 400, 400):
            return real(amp, dft, momentum, n_fft, win_length, hop_length)
        T = amp.shape[-2]
        return ck.gl_round_plan(amp.numel() // (T * 201), T, n_fft, hop_length, *H100)
    calls = []
    gl_rounds = ck.gl_rounds
    monkeypatch.setattr(TGL, "fused_round_plan", plan)
    monkeypatch.setattr(ck, "gl_rounds", lambda *a: calls.append(a[2]) or gl_rounds(*a))
    return calls


@pytest.mark.parametrize("shape", [(3, 45, 201), (45, 201)])
def test_griffin_lim_through_the_kernel_path(monkeypatch, shape):
    """Where the rule holds, `griffin_lim` hands its n_iter - 1 rounds to
    `gl_rounds` in one call, leading axes flattened to clips, and the final
    inverse gives today's waveform within the rounds' tolerance."""
    rng = np.random.default_rng(3)
    amp = torch.tensor((10 * rng.random(shape) ** 4).astype(np.float32))
    phase = torch.tensor((np.pi * rng.random(shape)).astype(np.float32))
    want, S_want = TGL.griffin_lim(amp, 400, 80, num_iters=5, init_phase=phase, dft="matmul",
                                  return_stft=True)
    calls = fused_on_the_cpu(monkeypatch)
    got, S_got = TGL.griffin_lim(amp, 400, 80, num_iters=5, init_phase=phase, dft="matmul",
                                return_stft=True)
    assert calls == [4]
    assert got.shape == want.shape and S_got.shape == S_want.shape
    assert_close_rounds(S_got, S_want, amp)
    assert (got - want).abs().max() <= MAX_TOL * want.abs().max()


def test_other_paths_keep_theirs_under_the_rule(monkeypatch):
    """Even where `fused_round_plan` would plan, the ragged rows, Fast
    Griffin-Lim and the FFT DFT keep today's rounds."""
    calls = fused_on_the_cpu(monkeypatch)
    P = torch.rand((2, 30, 201), generator=torch.Generator().manual_seed(4))
    phase = math.pi * torch.rand((2, 30, 201), generator=torch.Generator().manual_seed(5))
    TGL.from_power_to_wav(P, n_iter=3, init_phase=phase, dft="matmul", frames=[30, 22])
    TGL.from_power_to_wav(P, n_iter=3, init_phase=phase, momentum=0.99, dft="matmul")
    TGL.from_power_to_wav(P, n_iter=3, init_phase=phase, dft="fft")
    assert not calls
    TGL.from_power_to_wav(P, n_iter=3, init_phase=phase, dft="matmul")
    assert calls == [2]


def test_vocoder_counter_reads_the_kernels_rounds(monkeypatch):
    """``vocode.gl_rounds_fused`` under the vocode span: the gl_round
    launches the call added (n_iter - 1 where the kernel engages), 0 where
    it does not."""
    from speech_cloner_tpu_torch.ops.features import FeatureConfig
    from speech_cloner_tpu_torch.runtime import profiler

    def launching(*a):
        ck.launch_counts["gl_round", torch.float32] += a[2]
        return a[0]
    monkeypatch.setattr(TGL, "fused_round_plan", lambda amp, *a: (
        ck.gl_round_plan(1, amp.shape[-2], 400, 80, *H100) if a[0] == "matmul" else None))
    monkeypatch.setattr(ck, "gl_rounds", launching)
    P = torch.rand((1, 30, 201), generator=torch.Generator().manual_seed(6))
    feat = FeatureConfig()
    kw = dict(realse=1.0, momentum=0.0, mean_abs_amp_norm=0.01,
              generator=torch.Generator().manual_seed(0))
    with profiler.recording():
        V.device_vocode(P, feat, n_iter=7, dft="matmul", **kw)
        V.device_vocode(P, feat, n_iter=7, dft="fft", **kw)
        profiler.take()
        counts = [(c.name, c.total) for c in profiler.take_counts()]
    assert counts == [("vocode.gl_rounds_fused", 6), ("vocode.gl_rounds_fused", 0)]
