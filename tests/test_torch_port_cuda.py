"""The port's CUDA kernels against their plain versions, on a CUDA card:
the GRU scan's forward (one direction and both), its training forward's
gates, and its backward, with float32 and bf16 operands; the float32 bank
convolutions (csrc/conv_banks.cu) and the paths that launch them.

Marked ``gpu``; each test asks the ``cuda`` fixture, which skips where no
card is present. Run on the card with

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m gpu
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from speech_cloner_tpu_torch.models import DecoderConfig, DecoderStepConfig, EncoderConfig
from speech_cloner_tpu_torch.ops import cuda_kernels as ck
from speech_cloner_tpu_torch.pipeline import make_pipeline

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def operands(T, B, H, device, seed=0, dtype=torch.float32):
    g = torch.Generator(device).manual_seed(seed)
    lim = math.sqrt(6.0 / (3 * H))

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=device)).to(dtype)

    return rnd(T, B, 2 * H), rnd(T, B, H), rnd(H, 2 * H, scale=lim), rnd(H, H, scale=lim)


# bf16 operands: kernel and plain version both carry h in float32 and round
# ys to bf16, so a float32 sum-order difference can move an output by one
# bf16 ulp (2^-8 at |y| < 1) on top of the float32 limit (chip_smoke.py)
BF16_TOL = 2.0**-8 + 1e-4


def assert_bf16_close(got, ref):
    assert got.dtype == ref.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs()
    assert err.max().item() <= BF16_TOL
    assert (err == 0).float().mean().item() > 0.99     # most elements round alike


def shared_memory_kernel_bytes(H, C, R):
    """The shared-memory float32 kernel's layout (csrc/gru_scan.cu Layout),
    counted by hand: 4 mbarriers, h and r*h [2][H][R], the weights
    [3*Hc][stride(H)], float32, each region on 16 bytes. The plans ask for
    it only where no register column class serves."""
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    return 4 * (8 + 4 * r4(H * R) + r4(3 * -(-H // C) * ck.gru_weight_stride(H)))


@pytest.mark.parametrize("H", [1, 8, 40, 128, 256, 512])
@pytest.mark.parametrize("T,B", [(1, 1), (16, 3), (64, 9)])
def test_kernel_matches_plain(cuda, H, T, B):
    ops = operands(T, B, H, cuda, seed=H + T)
    before = ck.launch_counts["gru_scan", torch.float32]
    got = ck.gru_scan(*ops)
    torch.cuda.synchronize()
    assert ck.launch_counts["gru_scan", torch.float32] == before + 1
    assert (torch.float32, T, B, H) in ck.launch_shapes["gru_scan"]
    # float32 sums in another order than cuBLAS: 1e-5 over <= 64 steps
    torch.testing.assert_close(got, ck.gru_scan_plain(*ops), rtol=0, atol=1e-5)


@pytest.mark.parametrize("H", [40, 128, 256])
def test_kernel_main_path_shapes(cuda, H):
    """The scans of one convert: T = 400, B = 59; the limit of chip_smoke.py's
    kernel phase (float32 sums in another order over 400 steps)."""
    ops = operands(400, 59, H, cuda, seed=H)
    got = ck.gru_scan(*ops)
    torch.testing.assert_close(got, ck.gru_scan_plain(*ops), rtol=0, atol=1e-4)


@pytest.mark.parametrize("C", [None, 2, 16])
@pytest.mark.parametrize("H", [1, 8, 40])
def test_kernel_ragged(cuda, H, C):
    """B = 13 rows against the row tiles; H not a multiple of the cluster size
    (C = 16 at H = 8 leaves 8 CTAs without units)."""
    ops = operands(24, 13, H, cuda, seed=3 * H)
    packed = ck.pack_gru_weights(ops[2], ops[3], cluster=C)
    got = ck.gru_scan(*ops, packed=packed)
    torch.testing.assert_close(got, ck.gru_scan_plain(*ops), rtol=0, atol=1e-5)


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_kernel_row_tiles(cuda, R, C):
    """Every R instantiation, with B = 13 leaving the last tile ragged."""
    T, B, H = 20, 13, 40
    ops = operands(T, B, H, cuda, seed=R + C)
    packed = ck.pack_gru_weights(ops[2], ops[3], cluster=C)
    plan = ck.gru_scan_plan(H, B, *ck.device_limits(torch.cuda.current_device()), cluster=C)
    plan = dataclasses.replace(plan, rows=R, clusters=-(-B // R),
                               smem_bytes=ck.gru_scan_smem_bytes(H, C, R))
    got = ck.gru_scan_launch(ops[0], ops[1], packed, plan)
    torch.testing.assert_close(got, ck.gru_scan_plain(*ops), rtol=0, atol=1e-5)


@pytest.mark.parametrize("B", [59, 236])
@pytest.mark.parametrize("H", [40, 128, 256])
def test_kernel_bf16_main_path_shapes(cuda, H, B):
    """bf16 operands at the scans of one convert (B = 59) and of a batch of
    four 60 s clips (B = 236), T = 400."""
    ops = operands(400, B, H, cuda, seed=H + B, dtype=torch.bfloat16)
    before = ck.launch_counts["gru_scan", torch.bfloat16]
    got = ck.gru_scan(*ops)
    assert ck.launch_counts["gru_scan", torch.bfloat16] == before + 1
    assert_bf16_close(got, ck.gru_scan_plain(*ops))


@pytest.mark.parametrize("C", [None, 2, 16])
@pytest.mark.parametrize("H", [1, 8, 40])
def test_kernel_bf16_ragged(cuda, H, C):
    ops = operands(24, 13, H, cuda, seed=5 * H, dtype=torch.bfloat16)
    packed = ck.pack_gru_weights(ops[2], ops[3], cluster=C)
    assert packed.dtype == torch.bfloat16
    assert_bf16_close(ck.gru_scan(*ops, packed=packed), ck.gru_scan_plain(*ops))


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_kernel_bf16_row_tiles(cuda, R, C):
    """Every R instantiation of the unstaged bf16 form (the staged ones:
    `test_one_direction_row_tiles`)."""
    T, B, H = 20, 13, 40
    ops = operands(T, B, H, cuda, seed=R + C, dtype=torch.bfloat16)
    packed = ck.pack_gru_weights(ops[2], ops[3], cluster=C)
    plan = ck.gru_scan_plan(H, B, *ck.device_limits(torch.cuda.current_device()), cluster=C,
                            elem_bytes=2)
    plan = dataclasses.replace(plan, rows=R, clusters=-(-B // R), stage_steps=0,
                               smem_bytes=ck.gru_scan_smem_bytes(H, C, R, 2))
    assert_bf16_close(ck.gru_scan_launch(ops[0], ops[1], packed, plan),
                      ck.gru_scan_plain(*ops))
    with pytest.raises(RuntimeError, match="launch failed"):   # the float32 layout's size
        ck.gru_scan_launch(ops[0], ops[1], packed, dataclasses.replace(
            plan, smem_bytes=shared_memory_kernel_bytes(H, C, R)))


def test_h256_launch_spreads_over_the_card(cuda):
    """H = 256, B = 59: 15 clusters of 8 CTAs (4 rows each, one CTA an SM),
    on more SMs than the 59 rows."""
    ops = operands(8, 59, 256, cuda)
    packed = ck.pack_gru_weights(ops[2], ops[3])
    plan = ck.gru_scan_plan(256, 59, *ck.device_limits(torch.cuda.current_device()))
    sm_ids = torch.full((plan.ctas,), -1, dtype=torch.int32, device=cuda)
    ck.gru_scan_launch(ops[0], ops[1], packed, plan, sm_ids=sm_ids)
    assert (plan.cluster, plan.rows, plan.ctas) == (8, 4, 120)
    assert bool((sm_ids >= 0).all()) and len(set(sm_ids.tolist())) > 59


def test_kernel_rejects_what_it_does_not_take(cuda):
    gx, cx, Wg, Wc = operands(8, 2, 16, cuda)
    plan = ck.gru_scan_plan(16, 2, *ck.device_limits(torch.cuda.current_device()), elem_bytes=2)
    with pytest.raises(ValueError, match="gates="):     # an inference plan for a training launch
        ck.gru_scan_launch(gx.bfloat16(), cx.bfloat16(), ck.pack_gru_weights(Wg, Wc).bfloat16(),
                           plan, gates=torch.empty(1, 8, 2, 48, device=cuda))
    with pytest.raises(ValueError, match="gates must be"):
        ck.gru_scan_launch(gx.bfloat16(), cx.bfloat16(), ck.pack_gru_weights(Wg, Wc).bfloat16(),
                           dataclasses.replace(plan, gates=True),
                           gates=torch.empty(1, 8, 2, 48, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="float32"):
        ck.gru_scan(gx.double(), cx, Wg, Wc)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ck.gru_scan(gx.half(), cx.half(), Wg.half(), Wc.half())
    with pytest.raises(TypeError, match="one dtype"):
        ck.gru_scan(gx, cx.bfloat16(), Wg, Wc)
    with pytest.raises(ValueError, match="packed weights must be"):
        ck.gru_scan(gx, cx, Wg, Wc, packed=ck.pack_gru_weights(Wg, Wc).bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ck.gru_scan(gx, cx, Wg.t().contiguous().t(), Wc)
    with pytest.raises(ValueError, match="several devices"):
        ck.gru_scan(gx, cx.cpu(), Wg, Wc)
    big = operands(2, 1, ck.MAX_H + 8, cuda)
    with pytest.raises(ValueError, match="limit"):
        ck.gru_scan(*big)
    with pytest.raises(ValueError, match="packed weights must be"):
        ck.gru_scan(gx, cx, Wg, Wc, packed=ck.pack_gru_weights(Wg, Wc)[:, :, :8])
    with pytest.raises(ValueError, match="cluster size"):
        ck.gru_scan(gx, cx, Wg, Wc, packed=torch.zeros(3, 18, 16, device=cuda))


def test_gru_dir_apply_on_card(cuda):
    g = torch.Generator().manual_seed(1)
    C, H = 24, 40
    params = {"gates_kernel": torch.randn(C + H, 2 * H, generator=g) * 0.2,
              "gates_bias": torch.ones(2 * H),
              "candidate_kernel": torch.randn(C + H, H, generator=g) * 0.2,
              "candidate_bias": torch.zeros(H)}
    x = torch.randn(3, 50, C, generator=g)
    ref = ck.gru_dir_apply(params, x)
    got = ck.gru_dir_apply({k: v.to(cuda) for k, v in params.items()}, x.to(cuda))
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-5)


def test_pipeline_on_card_matches_cpu(cuda):
    enc = EncoderConfig(n_timesteps=48, num_conv_banks=2)
    dec = DecoderConfig(n_timesteps=48, step1=DecoderStepConfig(32, 2, 1, 80),
                        step2=DecoderStepConfig(48, 2, 1, 201))
    gpu = make_pipeline(enc, dec, seed=0, n_iter=4)
    cpu = make_pipeline(enc, dec, seed=0, n_iter=4, device="cpu")
    t = np.arange(3 * 3840 + 100) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    ck.reset_launch_counts()
    with torch.inference_mode():
        got = gpu.device_predict(gpu.pad_wav(wav))
    assert ck.launch_counts["gru_scan", torch.float32] == 6
    with torch.inference_mode():
        ref = cpu.device_predict(cpu.pad_wav(wav))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=0, atol=1e-4)


def test_bf16_batch_pipeline_on_card(cuda):
    """compute_dtype=bf16 and a batch of two clips of different lengths: 6
    launches of the bf16 kernel, float32 outputs, each clip's PCM peak-normalized."""
    enc = EncoderConfig(n_timesteps=48, num_conv_banks=2)
    dec = DecoderConfig(n_timesteps=48, step1=DecoderStepConfig(32, 2, 1, 80),
                        step2=DecoderStepConfig(48, 2, 1, 201))
    gpu = make_pipeline(enc, dec, seed=0, n_iter=4, compute_dtype=torch.bfloat16)
    t = np.arange(3 * 3840 + 100) / 16000
    wavs = [(0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
            (0.01 * np.sin(2 * np.pi * 330 * t[:5000])).astype(np.float32)]
    ck.reset_launch_counts()
    pcm = gpu.convert_batch_pcm16(wavs)
    assert ck.launch_counts["gru_scan", torch.bfloat16] == 6
    assert sum(ck.launch_counts.values()) == 6
    assert [p.shape for p in pcm] == [((4 * 48 - 1) * 80,)] * 2
    assert all(np.abs(p).max() == 32767 for p in pcm)


def stacked_operands(D, T, B, H, device, seed=0):
    ops = [operands(T, B, H, device, seed=seed + d) for d in range(D)]
    return [torch.stack(t) for t in zip(*ops)]


# The backward's sums: float32 in another order than the plain loop's bmm,
# over T steps of a carry; 1e-5 of the peak over <= 64 steps (the forward's
# limit), 1e-4 at T = 400 (chip_smoke.py's train_kernel rows).
def assert_peak_close(got, ref, rel):
    err = (got - ref).abs().max().item()
    assert err <= rel * max(ref.abs().max().item(), 1.0), err


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("H", [1, 8, 40, 128, 256, 512])
@pytest.mark.parametrize("T,B", [(1, 1), (16, 3), (64, 9)])
def test_train_forward_and_backward_match_plain(cuda, D, H, T, B):
    gx, cx, Wg, Wc = stacked_operands(D, T, B, H, cuda, seed=H + T)
    before = dict(ck.launch_counts)
    ys, gates = ck.gru_scan_train_forward(gx, cx, Wg, Wc)
    ref_ys, ref_gates = ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)
    torch.testing.assert_close(ys, ref_ys, rtol=0, atol=1e-5)
    torch.testing.assert_close(gates, ref_gates, rtol=0, atol=1e-5)
    dys = torch.randn(ys.shape, generator=torch.Generator(cuda).manual_seed(7), device=cuda)
    dgx, dcx = ck.gru_scan_train_backward(dys, ys, gates, Wg, Wc)
    ref_dgx, ref_dcx = ck.gru_scan_backward_plain(dys, ys, gates, Wg, Wc)
    torch.cuda.synchronize()
    assert_peak_close(dgx, ref_dgx, 1e-5)
    assert_peak_close(dcx, ref_dcx, 1e-5)
    fwd, bwd = (("gru_scan_train", "gru_scan_bwd") if D == 1
                else ("gru_scan_fused_train", "gru_scan_fused_bwd"))
    for k in (fwd, bwd):
        assert ck.launch_counts[k, torch.float32] == before[k, torch.float32] + 1


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("H", [40, 128, 256])
def test_f32_train_forward_at_train_shapes(cuda, D, H):
    """The float32 training forward at a train step's shapes (T = 400, B =
    32), one direction and both: the register forward with 5 / 16 / 32
    register columns at H = 40 / 128 / 256, ys and gates within chip_smoke's
    TRAIN_TOL (1e-4 of the peak: float32 sums in another order over 400
    steps) of `gru_scan_fused_plain(with_gates=True)`."""
    T, B = 400, 32
    gx, cx, Wg, Wc = stacked_operands(D, T, B, H, cuda, seed=H + D)
    plan = ck.gru_scan_plan(H, B, *ck.device_limits(torch.cuda.current_device()), dirs=D,
                            gates=True)
    assert ck.gru_reg_columns(H, plan.rows, plan.threads, gates=True) == {40: 5, 128: 16,
                                                                          256: 32}[H]
    assert plan.smem_bytes == ck.gru_scan_smem_bytes(H, plan.cluster, plan.rows, 2, gates=True)
    name = "gru_scan_train" if D == 1 else "gru_scan_fused_train"
    before = ck.launch_counts[name, torch.float32]
    ys, gates = ck.gru_scan_train_forward(gx, cx, Wg, Wc)
    ref_ys, ref_gates = ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)
    torch.cuda.synchronize()
    assert ck.launch_counts[name, torch.float32] == before + 1
    assert ys.dtype == torch.float32
    assert_peak_close(ys, ref_ys, 1e-4)
    assert_peak_close(gates, ref_gates, 1e-4)


@pytest.mark.parametrize("C,H", [(1, 40), (1, 64), (4, 128), (8, 256)])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_f32_training_row_tiles(cuda, R, C, H):
    """Every R instantiation of the float32 training forward in each column
    class (5, 8, 16, 32 at H = 40, 64, 128, 256), both directions, B = 13
    leaving the last tile ragged; (4, 16) keeps its candidate rows in shared
    memory, and at H = 256 R = 4 and 8 take the shared-memory forward (their
    register instances spill)."""
    T, B = 20, 13
    gx, cx, Wg, Wc = stacked_operands(2, T, B, H, cuda, seed=R + C + H)
    packed = torch.stack([ck.pack_gru_weights(a, b, cluster=C) for a, b in zip(Wg, Wc)])
    plan = ck.gru_scan_plan(H, B, *ck.device_limits(torch.cuda.current_device()), cluster=C,
                            dirs=2, gates=True)
    plan = dataclasses.replace(plan, rows=R, clusters=-(-B // R),
                               smem_bytes=ck.gru_scan_smem_bytes(H, C, R, gates=True))
    nk = ck.gru_reg_columns(H, R, plan.threads, gates=True)
    assert nk == (0 if H == 256 and R >= 4 else {40: 5, 64: 8, 128: 16, 256: 32}[H])
    gates = torch.empty((2, T, B, 3 * H), device=cuda)
    ys = ck.gru_scan_launch(gx, cx, packed, plan, gates=gates)
    ref_ys, ref_gates = ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)
    torch.testing.assert_close(ys, ref_ys, rtol=0, atol=1e-5)
    torch.testing.assert_close(gates, ref_gates, rtol=0, atol=1e-5)
    if nk:      # the shared-memory forward's layout size is refused
        with pytest.raises(RuntimeError, match="launch failed"):
            ck.gru_scan_launch(gx, cx, packed, dataclasses.replace(
                plan, smem_bytes=shared_memory_kernel_bytes(H, C, R)), gates=gates)


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_backward_row_tiles(cuda, R, C):
    """Every R instantiation of the backward, both directions, B = 13
    leaving the last tile ragged."""
    T, B, H = 20, 13, 40
    gx, cx, Wg, Wc = stacked_operands(2, T, B, H, cuda, seed=R + C)
    ys, gates = ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)
    dys = torch.randn(ys.shape, generator=torch.Generator(cuda).manual_seed(R), device=cuda)
    packed = torch.stack([ck.pack_gru_weights_bwd(a, b, cluster=C) for a, b in zip(Wg, Wc)])
    plan = ck.gru_scan_plan(H, B, *ck.device_limits(torch.cuda.current_device()), cluster=C,
                            dirs=2, backward=True)
    plan = dataclasses.replace(plan, rows=R, clusters=-(-B // R),
                               smem_bytes=ck.gru_scan_smem_bytes(H, C, R, backward=True))
    dgx, dcx = ck.gru_scan_bwd_launch(dys, ys, gates, packed, plan)
    ref_dgx, ref_dcx = ck.gru_scan_backward_plain(dys, ys, gates, Wg, Wc)
    assert_peak_close(dgx, ref_dgx, 1e-5)
    assert_peak_close(dcx, ref_dcx, 1e-5)
    with pytest.raises(RuntimeError, match="launch failed"):     # the forward's layout size
        ck.gru_scan_bwd_launch(dys, ys, gates, packed, dataclasses.replace(
            plan, smem_bytes=ck.gru_scan_smem_bytes(H, C, R)))


@pytest.mark.parametrize("H", [40, 128, 256])
def test_fused_inference_matches_two_directions(cuda, H):
    """gru_scan_fused (one launch) against the two single-direction scans,
    direction 1 on flipped inputs; T = 400, B = 32 (a train batch)."""
    gx, cx, Wg, Wc = stacked_operands(2, 400, 32, H, cuda, seed=H)
    before = ck.launch_counts["gru_scan_fused", torch.float32]
    got = ck.gru_scan_fused(gx, cx, Wg, Wc)
    assert ck.launch_counts["gru_scan_fused", torch.float32] == before + 1
    fw = ck.gru_scan_plain(gx[0], cx[0], Wg[0], Wc[0])
    bw = ck.gru_scan_plain(gx[1].flip(0), cx[1].flip(0), Wg[1], Wc[1]).flip(0)
    torch.testing.assert_close(got, torch.stack([fw, bw]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("H", [40, 128, 256])
def test_fused_bf16_matches_two_directions(cuda, H):
    """The bf16 forward's direction axis: both directions in one launch
    against the two single-direction plain scans, T = 64, B = 32."""
    gx, cx, Wg, Wc = (t.bfloat16() for t in stacked_operands(2, 64, 32, H, cuda, seed=H))
    got = ck.gru_scan_fused(gx, cx, Wg, Wc)
    fw = ck.gru_scan_plain(gx[0], cx[0], Wg[0], Wc[0])
    bw = ck.gru_scan_plain(gx[1].flip(0), cx[1].flip(0), Wg[1], Wc[1]).flip(0)
    assert_bf16_close(got, torch.stack([fw, bw]))


@pytest.mark.parametrize("H,C", [(128, 2), (300, None), (512, None)])
def test_weights_in_shared_memory(cuda, H, C):
    """Where a lane's weight columns have no register class (a CTA of more
    than 256 threads from 16 columns on, or H > 256) the bf16 forward keeps
    its weights in shared memory as bf16 pairs and the backward as float32
    rows: both against their plain versions, both directions."""
    T, B = 12, 5
    ops = operands(T, B, H, cuda, seed=H, dtype=torch.bfloat16)
    packed = ck.pack_gru_weights(ops[2], ops[3], cluster=C)
    Hc = -(-H // packed.shape[0])
    threads = -(-Hc * ck.TEAM_LANES // 32) * 32
    assert ck.gru_reg_columns(H, 1, threads) == ck.gru_reg_columns(H, 1, threads, True) == 0
    assert_bf16_close(ck.gru_scan(*ops, packed=packed), ck.gru_scan_plain(*ops))
    gx, cx, Wg, Wc = stacked_operands(2, T, B, H, cuda, seed=H)
    ys, gates = ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)
    dys = torch.randn(ys.shape, generator=torch.Generator(cuda).manual_seed(H), device=cuda)
    packed = torch.stack([ck.pack_gru_weights_bwd(a, b, cluster=C) for a, b in zip(Wg, Wc)])
    plan = ck.gru_scan_plan(H, B, *ck.device_limits(torch.cuda.current_device()),
                            cluster=packed.shape[1], dirs=2, backward=True)
    dgx, dcx = ck.gru_scan_bwd_launch(dys, ys, gates, packed, plan)
    ref_dgx, ref_dcx = ck.gru_scan_backward_plain(dys, ys, gates, Wg, Wc)
    assert_peak_close(dgx, ref_dgx, 1e-5)
    assert_peak_close(dcx, ref_dcx, 1e-5)


@pytest.mark.parametrize("H", [40, 128, 256])
def test_train_shapes_backward(cuda, H):
    """The backward at a train step's shapes (T = 400, B = 32), both forms."""
    for D in (1, 2):
        gx, cx, Wg, Wc = stacked_operands(D, 400, 32, H, cuda, seed=H + D)
        ys, gates = ck.gru_scan_train_forward(gx, cx, Wg, Wc)
        dys = torch.randn(ys.shape, generator=torch.Generator(cuda).manual_seed(H), device=cuda)
        dgx, dcx = ck.gru_scan_train_backward(dys, ys, gates, Wg, Wc)
        ref_dgx, ref_dcx = ck.gru_scan_backward_plain(dys, ys, gates, Wg, Wc)
        assert_peak_close(dgx, ref_dgx, 1e-4)
        assert_peak_close(dcx, ref_dcx, 1e-4)


def test_autograd_goes_through_the_kernels(cuda):
    """gru_scan with requires_grad on CUDA tensors: GruScan runs the forward
    and backward kernels; every gradient against the CPU's plain path."""
    T, B, H = 30, 5, 40
    ops = operands(T, B, H, torch.device("cpu"), seed=11)
    w = torch.randn(T, B, H, generator=torch.Generator().manual_seed(12))
    grads = {}
    for dev in ("cpu", "cuda"):
        args = [t.detach().to(dev).requires_grad_() for t in ops]
        ck.reset_launch_counts()
        (ck.gru_scan(*args) * w.to(dev)).sum().backward()
        grads[dev] = [a.grad.cpu() for a in args]
        if dev == "cuda":
            assert ck.launch_counts["gru_scan_train", torch.float32] == 1
            assert ck.launch_counts["gru_scan_bwd", torch.float32] == 1
            assert sum(ck.launch_counts.values()) == 2
    for g, r in zip(grads["cuda"], grads["cpu"]):
        assert_peak_close(g, r, 1e-5)


def test_backward_rejects_what_it_does_not_take(cuda):
    gx, cx, Wg, Wc = stacked_operands(1, 8, 2, 16, cuda)
    ys, gates = ck.gru_scan_train_forward(gx, cx, Wg, Wc)
    plan = ck.gru_scan_plan(16, 2, *ck.device_limits(torch.cuda.current_device()),
                            backward=True)
    packed = ck.pack_gru_weights_bwd(Wg[0], Wc[0])[None]
    with pytest.raises(TypeError, match="float32"):
        ck.gru_scan_bwd_launch(ys.double(), ys, gates, packed, plan)
    with pytest.raises(TypeError, match="one dtype"):     # bf16 dys with float32 ys
        ck.gru_scan_bwd_launch(ys.bfloat16(), ys, gates, packed, plan)
    with pytest.raises(TypeError, match="float32"):       # the gates stay float32
        ck.gru_scan_bwd_launch(ys.bfloat16(), ys.bfloat16(), gates.bfloat16(),
                               packed.bfloat16(), plan)
    with pytest.raises(ValueError, match="backward plan"):
        ck.gru_scan_bwd_launch(ys, ys, gates, packed, dataclasses.replace(plan, backward=False))


# ------------------------------------------------------------ bf16 training ---

# The bf16 training kernels against their plain versions: each rounds its
# bf16 outputs once from float32, so a float32 sum-order difference (1e-4 of
# the peak over 400 steps) can move an output by one bf16 ulp (2^-7 of its
# magnitude); the gates stay float32 (the float32 limit).
def assert_bf16_rounded_close(got, ref):
    assert got.dtype == ref.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    assert (err <= 2.0**-7 * ref.abs() + 1e-4 * ref.abs().max()).all(), err.max().item()


# the float32 test's shapes, and a train step's (T = 400, B = 32) at its widths
BF16_TRAIN_SHAPES = ([(H, T, B) for H in (1, 8, 40, 128, 256, 512)
                      for T, B in ((1, 1), (16, 3), (64, 9))]
                     + [(H, 400, 32) for H in (40, 128, 256)])


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("H,T,B", BF16_TRAIN_SHAPES)
def test_bf16_train_forward_and_backward_match_plain(cuda, D, H, T, B):
    gx, cx, Wg, Wc = (t.bfloat16() for t in stacked_operands(D, T, B, H, cuda, seed=H + T))
    ck.reset_launch_counts()
    ys, gates = ck.gru_scan_train_forward(gx, cx, Wg, Wc)
    ref_ys, ref_gates = ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)
    assert_bf16_close(ys, ref_ys)
    torch.testing.assert_close(gates, ref_gates, rtol=0, atol=1e-5)
    dys = torch.randn(ys.shape, generator=torch.Generator(cuda).manual_seed(7),
                      device=cuda).bfloat16()
    dgx, dcx = ck.gru_scan_train_backward(dys, ys, gates, Wg, Wc)
    ref_dgx, ref_dcx = ck.gru_scan_backward_plain(dys, ys, gates, Wg, Wc)
    torch.cuda.synchronize()
    assert_bf16_rounded_close(dgx, ref_dgx)
    assert_bf16_rounded_close(dcx, ref_dcx)
    fwd, bwd = (("gru_scan_train", "gru_scan_bwd") if D == 1
                else ("gru_scan_fused_train", "gru_scan_fused_bwd"))
    assert ck.launch_counts[fwd, torch.bfloat16] == ck.launch_counts[bwd, torch.bfloat16] == 1
    assert sum(ck.launch_counts.values()) == 2


@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_bf16_training_row_tiles(cuda, R, C):
    """Every R instantiation of the unstaged bf16 training forward (gates)
    and bf16 backward (the instances shapes that cannot be staged take),
    both directions, B = 13 leaving the last tile ragged; H = 256 at C = 8
    takes the register instances at small R and the shared-memory ones
    above (their (R, 32) spilled)."""
    T, B = 20, 13
    H = 40 if C == 1 else 256
    gx, cx, Wg, Wc = (t.bfloat16() for t in stacked_operands(2, T, B, H, cuda, seed=R + C))
    limits = ck.device_limits(torch.cuda.current_device())
    packed = torch.stack([ck.pack_gru_weights(a, b, cluster=C) for a, b in zip(Wg, Wc)])
    plan = ck.gru_scan_plan(H, B, *limits, cluster=C, elem_bytes=2, dirs=2, gates=True)
    plan = dataclasses.replace(plan, rows=R, clusters=-(-B // R), smem_bytes=ck.gru_scan_smem_bytes(
        H, C, R, 2, gates=True), stage_steps=0)
    gates = torch.empty((2, T, B, 3 * H), device=cuda)
    ys = ck.gru_scan_launch(gx, cx, packed, plan, gates=gates)
    ref_ys, ref_gates = ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)
    assert_bf16_close(ys, ref_ys)
    torch.testing.assert_close(gates, ref_gates, rtol=0, atol=1e-5)
    dys = torch.randn(ys.shape, generator=torch.Generator(cuda).manual_seed(R),
                      device=cuda).bfloat16()
    packed_bwd = torch.stack([ck.pack_gru_weights_bwd(a, b, cluster=C) for a, b in zip(Wg, Wc)])
    bplan = ck.gru_scan_plan(H, B, *limits, cluster=C, elem_bytes=2, dirs=2, backward=True)
    bplan = dataclasses.replace(bplan, rows=R, clusters=-(-B // R),
                                smem_bytes=ck.gru_scan_smem_bytes(H, C, R, 2, backward=True),
                                stage_steps=0)
    dgx, dcx = ck.gru_scan_bwd_launch(dys, ys, gates, packed_bwd, bplan)
    ref_dgx, ref_dcx = ck.gru_scan_backward_plain(dys, ys, gates, Wg, Wc)
    assert_bf16_rounded_close(dgx, ref_dgx)
    assert_bf16_rounded_close(dcx, ref_dcx)


def test_bf16_autograd_goes_through_the_kernels(cuda):
    """gru_scan_fused with bf16 operands that require grad: the bf16 training
    forward and the bf16 backward kernels; gradients bf16, against the CPU's
    plain path on the same values."""
    T, B, H = 30, 5, 40
    ops = [t.bfloat16() for t in stacked_operands(2, T, B, H, torch.device("cpu"), seed=11)]
    w = torch.randn(2, T, B, H, generator=torch.Generator().manual_seed(12))
    grads = {}
    for dev in ("cpu", "cuda"):
        args = [t.detach().to(dev).requires_grad_() for t in ops]
        ck.reset_launch_counts()
        (ck.gru_scan_fused(*args).float() * w.to(dev)).sum().backward()
        grads[dev] = [a.grad.cpu() for a in args]
        if dev == "cuda":
            assert ck.launch_counts["gru_scan_fused_train", torch.bfloat16] == 1
            assert ck.launch_counts["gru_scan_fused_bwd", torch.bfloat16] == 1
    for g, r in zip(grads["cuda"], grads["cpu"]):
        assert g.dtype == torch.bfloat16
        assert_bf16_rounded_close(g, r)


def test_bf16_train_step_launches_only_bf16_kernels(cuda):
    """One bf16 encoder train step on the card at a small width: every scan
    launch bf16 (training forward and backward), float32 gradients."""
    from speech_cloner_tpu_torch.models import encoder as enc_m
    from speech_cloner_tpu_torch.train import encoder_train_step, make_train_state
    from speech_cloner_tpu_torch.train.optimizer import OptimizerConfig

    cfg = EncoderConfig(n_timesteps=32, input_dim=16, num_conv_banks=3, num_highwaynet_blocks=1,
                        dropout_rate=0.0)
    model = enc_m.init(torch.Generator().manual_seed(0), cfg, device=cuda)
    opt_cfg = OptimizerConfig()
    x = np.random.default_rng(0).standard_normal((4, 32, 16)).astype(np.float32)
    y = np.eye(61, dtype=np.float32)[np.random.default_rng(1).integers(0, 61, (4, 32))]
    ck.reset_launch_counts()
    _, m = encoder_train_step(make_train_state(model, opt_cfg, 1), x, y, model=model,
                              opt_cfg=opt_cfg, opt=opt_cfg.make(), compute_dtype=torch.bfloat16)
    assert math.isfinite(float(m["loss"]))
    assert ck.launch_counts["gru_scan_train", torch.bfloat16] == 2
    assert ck.launch_counts["gru_scan_bwd", torch.bfloat16] == 2
    assert sum(ck.launch_counts.values()) == 4
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("sampler", ["index_sampler", "file_batch_sampler"])
def test_device_gather_matches_cpu(cuda, sampler):
    """The device-resident store's window gather on the card against the
    same store on the CPU, bit for bit: B = 32 windows of T = 400 frames
    over the decoder's three streams (MFCC 80, mel 80, power 201 columns),
    utterances of 150-900 frames (short ones read the zero padding), the
    starts from the sampler the decoder uses, and starts past the end (the
    clamp)."""
    from speech_cloner_tpu_torch.data.device_dataset import DeviceWindows

    rng = np.random.default_rng(0)
    lens = rng.integers(150, 900, 40)
    cols = [[rng.standard_normal((int(n), c)).astype(np.float32) for n in lens]
            for c in (80, 80, 201)]
    on_card = DeviceWindows(cols, 400, device=cuda)
    on_cpu = DeviceWindows(cols, 400, device="cpu")
    assert on_card.nbytes == on_cpu.nbytes == 4 * 40 * int(lens.max()) * 361
    batches = list(getattr(on_cpu, sampler)(np.arange(40), 32, n_epochs=2,
                                            rng=np.random.default_rng(1)))
    batches.append((np.arange(32, dtype=np.int32) % 40,
                    np.full(32, int(lens.max()) - 10, np.int32)))
    for u, s in batches:
        got = on_card.gather(torch.as_tensor(u, device=cuda), torch.as_tensor(s, device=cuda))
        ref = on_cpu.gather(u, s)
        for g, r in zip(got, ref):
            assert g.device.type == "cuda" and g.shape == r.shape == (32, 400, r.shape[2])
            assert torch.equal(g.cpu(), r)


# ------------------------------------------------------------ the parallel layer ---

def _tiny_pipelines(seed=0):
    enc = EncoderConfig(n_timesteps=48, input_dim=80, n_output=61, num_conv_banks=2,
                        num_highwaynet_blocks=1)
    dec = DecoderConfig(n_timesteps=48, input_dim=61, step1=DecoderStepConfig(32, 2, 1, 80),
                        step2=DecoderStepConfig(48, 2, 1, 201))
    return (make_pipeline(enc, dec, seed=seed, n_iter=4, device="cuda"),
            make_pipeline(enc, dec, seed=seed, n_iter=4, device="cpu"))


def _clip(seconds, seed=0):
    t = np.arange(int(16000 * seconds)) / 16000
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 180 * t) + 0.02 * rng.standard_normal(t.size)).astype(
        np.float32)


def test_seq_parallel_on_card_matches_cpu(cuda):
    """convert_seq_parallel over 2 shards of the card against 2 CPU shards:
    mel and stft within 1e-4 of the CPU peak, the waveform within 1e-3
    (chip_smoke.py PARITY_TOL), through the scan kernel (3 CBHG x (2
    shards x 2 directions + the 2 edge scans))."""
    from speech_cloner_tpu_torch.parallel.mesh import make_seq_mesh

    gpu, cpu = _tiny_pipelines()
    wav = _clip(1.5)
    phase = np.pi * np.random.default_rng(1).random((302, 201)).astype(np.float32)
    ck.reset_launch_counts()
    got = gpu.convert_seq_parallel(wav, mesh=make_seq_mesh(2, devices=[cuda, cuda]), warmup=40,
                                   init_phase=phase)
    assert ck.launch_counts["gru_scan", torch.float32] == 3 * (2 * 2 + 2)
    ref = cpu.convert_seq_parallel(wav, n_devices=2, warmup=40, init_phase=phase)
    for g, r, tol in zip(got, ref, (1e-3, 1e-4, 1e-4)):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= tol * np.abs(r).max()


def test_stream_mesh_on_card_matches_unsharded(cuda):
    from speech_cloner_tpu_torch.parallel.mesh import make_seq_mesh
    from speech_cloner_tpu_torch.pipeline.stream import StreamingCloner

    gpu, _ = _tiny_pipelines()
    kw = dict(chunk_frames=64, context_frames=64, lookahead_frames=48, margin_frames=8)
    wavs = np.stack([_clip(1.5, seed=s) for s in range(4)])
    base = StreamingCloner(gpu, batch=4, **kw).convert_all(wavs)
    mesh = make_seq_mesh(2, devices=[cuda, cuda], axis_name="streams")
    got = StreamingCloner(gpu, batch=4, mesh=mesh, **kw).convert_all(wavs)
    assert np.abs(got - base).max() <= 1e-3 * np.abs(base).max()


def test_seq_mesh_refuses_missing_cards(cuda):
    from speech_cloner_tpu_torch.parallel.mesh import make_seq_mesh

    n = torch.cuda.device_count()
    assert make_seq_mesh().size == n
    with pytest.raises(ValueError):
        make_seq_mesh(n + 1)
    with pytest.raises(ValueError):
        make_seq_mesh(1, devices=[f"cuda:{n}"])


def collectives_on_card(rank: int, world: int) -> dict:
    """all_reduce, all_gather and broadcast of CUDA tensors in a world."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    x = torch.full((3,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    parts = [torch.empty(2, device="cuda") for _ in range(world)]
    dist.all_gather(parts, torch.full((2,), float(rank), device="cuda"))
    b = torch.full((1,), float(rank + 7), device="cuda")
    dist.broadcast(b, src=0)
    return {"sum": x.cpu().tolist(), "gathered": [p.cpu().tolist() for p in parts],
            "broadcast": b.item(), "backend": dist.get_backend()}


@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_collectives_of_cuda_tensors(cuda, backend, world):
    """gloo reduces CUDA tensors (through the host) with two ranks on one
    card, which lets a 2 x 2 training world run on one card; NCCL runs a
    world of one (it refuses two ranks on one card)."""
    from speech_cloner_tpu_torch.parallel.distributed import spawn_world

    outs = spawn_world(collectives_on_card, world, backend=backend)
    total = world * (world + 1) / 2
    for out in outs:
        assert out["backend"] == backend and out["sum"] == [total] * 3
        assert out["gathered"] == [[float(r)] * 2 for r in range(world)]
        assert out["broadcast"] == 7.0


# ------------------------------------------- the LSTM CBHG, attention, profiler ---

def rel_l2(a, b):
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_grads"])
def test_lstm_cbhg_on_card_matches_cpu(cuda, train):
    """A CBHG with use_lstm at the decoder's step-1 width (H = 128), card
    against CPU: outputs within 1e-4 of their peak, no scan launched (the
    banks run the bank kernel in eval mode under inference_mode, the packed
    conv when autograd records); in train mode each LSTM gradient leaf (forget biases included) as accurate
    as the CPU's float32 one (chip_smoke's train_parity rule: relative L2
    from the CPU float64 gradient within 1e-4 + 3 x the CPU float32's). The
    leaves before the last highway layer's relu are held by
    `test_cbhg_train_grads_on_card_match_cpu`: at this shape and seed the
    card's float32 takes one relu decision otherwise than float64 does."""
    from speech_cloner_tpu_torch.nn.modules import CBHG, CBHGConfig, cbhg_init

    cfg = CBHGConfig(256, 4, 2, use_lstm=True)
    params, state = cbhg_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(4, 100, 128, generator=torch.Generator().manual_seed(1))
    runs = {"card": (cuda, torch.float32), "f32": ("cpu", torch.float32),
            "f64": ("cpu", torch.float64)}
    models = {k: CBHG(params, state, cfg).to(dev, dt) for k, (dev, dt) in runs.items()}
    ck.reset_launch_counts()
    with torch.enable_grad() if train else torch.inference_mode():
        outs = {k: models[k](x.to(dev, dt), train) for k, (dev, dt) in runs.items()}
    banks = 0 if train else 1
    assert ck.launch_counts["conv_banks", torch.float32] == banks
    assert sum(ck.launch_counts.values()) == banks
    assert_peak_close(outs["card"].detach().cpu(), outs["f32"].detach(), 1e-4)
    if train:
        for out in outs.values():
            (out * out).sum().backward()
        gpu, c32, c64 = (dict(models[k].named_parameters()) for k in runs)
        lstm = [name for name in c64 if name.startswith("gru.")]
        assert len(lstm) == 6
        for name in lstm:
            g64 = c64[name].grad.float()
            assert rel_l2(gpu[name].grad.cpu(), g64) <= 1e-4 + 3 * rel_l2(c32[name].grad, g64), \
                name
        assert gpu["gru.dirs.fw.forget_bias"].grad.shape == ()


# a relu input float32 rounding may put on either side of zero: 2^-24 times
# the 128-term sums of the highway's dense layer (terms below 1), rounded up
RELU_NEAR_TIE = 1e-5


@pytest.mark.parametrize("use_lstm", [False, True], ids=["gru", "lstm"])
def test_cbhg_train_grads_on_card_match_cpu(cuda, use_lstm):
    """The CBHG of the LSTM case above (B = 4, T = 100, H = 128, seed 0) with
    its GRU (the scan kernel's training forward and backward, 2 launches of
    each) and with use_lstm: every gradient leaf by chip_smoke's
    train_parity rule (relative L2 from the CPU float64 gradient within 1e-4
    + 3 x the CPU float32's).

    What was found (cbhg_grad_gap.py on the card, NVIDIA H100 80GB HBM3):
    the card's float32 run takes one relu decision of the second highway
    layer otherwise than float64 does, where the relu's float64 input is
    1.08e-7 (cuBLAS and the CPU round its 128-term sum differently); that
    one position moves the leaves before that relu up to 1.7e-3 from
    float64 (15 of 28 leaves fail the rule with the GRU, 17 of 26 with the
    LSTM), against the CPU float32's 5e-8 to 8e-7, under cuDNN's default,
    deterministic and disabled settings alike. So the leaves after every
    relu (the recurrent layer's, the last highway gate's) are held as they
    run; the card's run is held to take its relu decisions otherwise than
    float64 only within float32 rounding of zero (RELU_NEAR_TIE); and every
    leaf is held with the float64 run's relu decisions (as the relu of the
    float64 run decides)."""
    import cbhg_grad_gap as gap

    cpu32, cpu64 = (gap.run(use_lstm, "cpu", dt) for dt in (torch.float32, torch.float64))
    ck.reset_launch_counts()
    card = gap.run(use_lstm, cuda, torch.float32)
    scans = {k: n for (k, dt), n in ck.launch_counts.items() if n}
    assert scans == ({} if use_lstm else {"gru_scan_train": 2, "gru_scan_bwd": 2})
    for x, ref in zip(card["relu_inputs"], cpu64["relu_inputs"]):
        flips = (x > 0) != (ref > 0)
        assert not flips.any() or ref[flips].abs().max().item() <= RELU_NEAR_TIE
    leaves, _ = gap.leaf_rows(card, cpu32, cpu64)
    after_relus = [n for n in leaves if n.startswith(("gru.", "highway.1.dense2."))]
    assert len(after_relus) == (6 if use_lstm else 8) + 2
    assert [n for n in after_relus if not leaves[n]["ok"]] == []
    forced = gap.run(use_lstm, cuda, torch.float32, force=cpu64["relu_inputs"])
    assert gap.leaf_rows(forced, cpu32, cpu64)[1] == []


def test_attention_decoder_on_card_matches_cpu(cuda):
    """The Bahdanau decoder at B = 4, T' = 100, memory 400 x 256, H = 256:
    outputs and alignments within 1e-4 of their peak."""
    from speech_cloner_tpu_torch.nn.attention import AttentionDecoder, attention_decoder_init

    g = torch.Generator().manual_seed(2)
    dec = AttentionDecoder(attention_decoder_init(g, 80, 256, 256))
    x, memory = torch.randn(4, 100, 80, generator=g), torch.randn(4, 400, 256, generator=g)
    with torch.inference_mode():
        ref = dec(x, memory)
        got = dec.to(cuda)(x.to(cuda), memory.to(cuda))
    for a, b in zip(got, ref):
        assert_peak_close(a.cpu(), b, 1e-4)


def test_profiler_trace_and_memory_on_card(cuda, tmp_path):
    from speech_cloner_tpu_torch.runtime import profiler

    with profiler.trace(str(tmp_path), device="cuda"):
        with profiler.span("card_region", cuda):
            y = torch.ones(256, 256, device=cuda) @ torch.ones(256, 256, device=cuda)
            torch.cuda.synchronize()
    events = json.loads(next(tmp_path.glob("*.json")).read_text())["traceEvents"]
    assert any(e.get("name") == "card_region" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)
    stats = profiler.device_memory_stats()
    assert stats["cuda:0"]["bytes_in_use"] >= y.numel() * 4
    assert stats["cuda:0"]["bytes_limit"] > stats["cuda:0"]["peak_bytes_in_use"] > 0


# ----------------------------------------------- bf16 training, staged ---

# The staged instances (the plans' default for the bf16 training forward
# and backward): T = 400 (12 stages of 32 and a ragged one of 16), T = 77
# (two and a ragged one), T = 21 < S, T = 1; B = 32, or a ragged row tile
STAGED_SHAPES = [(H, T, B) for H in (40, 128, 256)
                 for T, B in ((400, 32), (77, 13), (21, 5), (1, 3))]


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("H,T,B", STAGED_SHAPES)
def test_staged_training_kernels_match_plain(cuda, D, H, T, B):
    """gru_scan_train_forward and gru_scan_train_backward through their
    staged instances against the plain versions (bf16 limits as above), one
    launch each; where the unstaged instance's plan has the same (C, R),
    its outputs bit for bit (staging moves where data waits, not what is
    computed)."""
    gx, cx, Wg, Wc = (t.bfloat16() for t in stacked_operands(D, T, B, H, cuda, seed=H + T + D))
    limits = ck.device_limits(torch.cuda.current_device())
    plans = {S: (ck.gru_scan_plan(H, B, *limits, elem_bytes=2, dirs=D, gates=True, stage_steps=S),
                 ck.gru_scan_plan(H, B, *limits, elem_bytes=2, dirs=D, backward=True,
                                  stage_steps=S)) for S in (None, 0)}
    assert all(p.stage_steps == 32 for p in plans[None])
    ck.reset_launch_counts()
    ys, gates = ck.gru_scan_train_forward(gx, cx, Wg, Wc)
    ref_ys, ref_gates = ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)
    assert_bf16_close(ys, ref_ys)
    torch.testing.assert_close(gates, ref_gates, rtol=0, atol=1e-5)
    dys = torch.randn(ys.shape, generator=torch.Generator(cuda).manual_seed(T),
                      device=cuda).bfloat16()
    dgx, dcx = ck.gru_scan_train_backward(dys, ys, gates, Wg, Wc)
    ref_dgx, ref_dcx = ck.gru_scan_backward_plain(dys, ys, gates, Wg, Wc)
    torch.cuda.synchronize()
    assert_bf16_rounded_close(dgx, ref_dgx)
    assert_bf16_rounded_close(dcx, ref_dcx)
    fwd, bwd = (("gru_scan_train", "gru_scan_bwd") if D == 1
                else ("gru_scan_fused_train", "gru_scan_fused_bwd"))
    assert ck.launch_counts[fwd, torch.bfloat16] == ck.launch_counts[bwd, torch.bfloat16] == 1
    assert sum(ck.launch_counts.values()) == 2
    packed = torch.stack([ck.pack_gru_weights(a, b) for a, b in zip(Wg, Wc)])
    packed_bwd = torch.stack([ck.pack_gru_weights_bwd(a, b) for a, b in zip(Wg, Wc)])
    (fp, bp), (fu, bu) = plans[None], plans[0]
    if (fp.cluster, fp.rows) == (fu.cluster, fu.rows):
        g0 = torch.empty_like(gates)
        y0 = (ck.gru_scan_launch(gx[0], cx[0], packed[0], fu, gates=g0)[None] if D == 1
              else ck.gru_scan_launch(gx, cx, packed, fu, gates=g0))
        assert torch.equal(y0, ys) and torch.equal(g0, gates)
    if (bp.cluster, bp.rows) == (bu.cluster, bu.rows):
        d0 = ck.gru_scan_bwd_launch(dys, ys, gates, packed_bwd, bu, stacked=D == 2)
        assert torch.equal(d0[0], dgx) and torch.equal(d0[1], dcx)
    # only the widened staged tables move the rows: to the forward's (4, 32)
    # or the backward's (2, 32)
    assert fp.rows == fu.rows or (fp.rows, fp.reg_columns) == (4, 32)
    assert bp.rows == bu.rows or (bp.rows, bp.reg_columns) == (2, 32)


@pytest.mark.parametrize("C,H", [(1, 40), (4, 128), (8, 256)])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_staged_row_tiles(cuda, R, C, H):
    """Every staged instance (R rows, 5 / 16 / 32 register columns; at 32
    the forward's (4, 32) and the backward's (2, 32), which only the staged
    table holds), both directions, 8 steps a stage over T = 45 (a ragged
    last stage), B = 13 (a ragged tile), against the plain versions; a row
    count without a staged instance runs the unstaged one. A staged plan
    whose shared memory is the unstaged layout's, or on the float32 entry,
    is refused."""
    T, B, S = 45, 13, 8
    gx, cx, Wg, Wc = (t.bfloat16() for t in stacked_operands(2, T, B, H, cuda, seed=R + C))
    limits = ck.device_limits(torch.cuda.current_device())
    packed = torch.stack([ck.pack_gru_weights(a, b) for a, b in zip(Wg, Wc)])
    packed_bwd = torch.stack([ck.pack_gru_weights_bwd(a, b) for a, b in zip(Wg, Wc)])
    plans = []
    for bwd in (False, True):
        base = ck.gru_scan_plan(H, B, *limits, cluster=C, elem_bytes=2, dirs=2, backward=bwd,
                                gates=not bwd)
        staged = ck.gru_reg_columns(H, R, base.threads, bwd, not bwd, staged=True) > 0
        assert staged == (not (H == 256 and R >= (4 if bwd else 8)))
        plans.append(dataclasses.replace(
            base, rows=R, clusters=-(-B // R), stage_steps=S if staged else 0,
            smem_bytes=ck.gru_scan_smem_bytes(H, C, R, 2, bwd, not bwd, S if staged else 0)))
    gates = torch.empty((2, T, B, 3 * H), device=cuda)
    ys = ck.gru_scan_launch(gx, cx, packed, plans[0], gates=gates)
    ref_ys, ref_gates = ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)
    assert_bf16_close(ys, ref_ys)
    torch.testing.assert_close(gates, ref_gates, rtol=0, atol=1e-5)
    dys = torch.randn(ys.shape, generator=torch.Generator(cuda).manual_seed(R),
                      device=cuda).bfloat16()
    dgx, dcx = ck.gru_scan_bwd_launch(dys, ys, gates, packed_bwd, plans[1])
    ref_dgx, ref_dcx = ck.gru_scan_backward_plain(dys, ys, gates, Wg, Wc)
    assert_bf16_rounded_close(dgx, ref_dgx)
    assert_bf16_rounded_close(dcx, ref_dcx)
    if plans[0].stage_steps:
        with pytest.raises(RuntimeError, match="launch failed"):
            ck.gru_scan_launch(gx, cx, packed, dataclasses.replace(
                plans[0], smem_bytes=ck.gru_scan_smem_bytes(H, C, R, 2, gates=True)), gates=gates)
        with pytest.raises(RuntimeError, match="launch failed"):
            ck.gru_scan_launch(gx.float(), cx.float(), packed.float(), plans[0], gates=gates)


@pytest.mark.parametrize("H,T,B", [(128, 77, 13), (256, 400, 32)])
def test_staged_autograd_goes_through_the_kernels(cuda, H, T, B):
    """`gru_scan_fused` with bf16 operands that require grad runs `GruScan`
    through the staged training forward and backward, one launch each: ys
    and the input gradients are those kernels' outputs on the same values
    bit for bit, within the bf16 limit of the plain backward on them, and
    the weight gradients are GruScan's two products of them."""
    gx, cx, Wg, Wc = (t.bfloat16() for t in stacked_operands(2, T, B, H, cuda, seed=H))
    w = torch.randn(2, T, B, H, generator=torch.Generator(cuda).manual_seed(13), device=cuda)
    args = [t.detach().requires_grad_() for t in (gx, cx, Wg, Wc)]
    ck.reset_launch_counts()
    ys = ck.gru_scan_fused(*args)
    (ys.float() * w).sum().backward()
    assert ck.launch_counts["gru_scan_fused_train", torch.bfloat16] == 1
    assert ck.launch_counts["gru_scan_fused_bwd", torch.bfloat16] == 1
    assert sum(ck.launch_counts.values()) == 2
    with torch.no_grad():
        ref_ys, gates = ck.gru_scan_train_forward(gx, cx, Wg, Wc)
        dys = w.bfloat16()        # the gradient of ys.float() * w
        dgx, dcx = ck.gru_scan_train_backward(dys, ref_ys, gates, Wg, Wc)
        plain_dgx, plain_dcx = ck.gru_scan_backward_plain(dys, ref_ys, gates, Wg, Wc)
        dWg, dWc = ck.gru_weight_grads(ref_ys, gates, dgx, dcx)
    assert torch.equal(ys, ref_ys)
    assert torch.equal(args[0].grad, dgx) and torch.equal(args[1].grad, dcx)
    assert torch.equal(args[2].grad, dWg) and torch.equal(args[3].grad, dWc)
    assert_bf16_rounded_close(dgx, plain_dgx)
    assert_bf16_rounded_close(dcx, plain_dcx)


@pytest.mark.parametrize("H,T,B", [(128, 77, 13), (256, 400, 32)])
def test_staged_autograd_matches_cpu(cuda, H, T, B):
    """`gru_scan_fused` with bf16 operands that require grad, through the
    staged training forward and backward on the card, against the CPU's
    plain path at each stage on the same inputs (bf16 limits as above): ys
    and the gates against the CPU's forward; dgx and dcx against the CPU's
    backward run on the card's ys and gates; the weight gradients against
    the CPU's `gru_weight_grads` of the card's ys, gates, dgx and dcx.
    End to end the card lies further from the CPU: a ys element rounded to
    the other bf16 neighbour enters the backward as h[t-1] (in hp - c and
    hp r), and a weight gradient sums T*B products of elements that may
    each differ by a rounding (gru_scan_grad_drift.py measures both)."""
    ops = [t.bfloat16() for t in stacked_operands(2, T, B, H, torch.device("cpu"), seed=H)]
    w = torch.randn(2, T, B, H, generator=torch.Generator().manual_seed(13))
    runs = {}
    for dev in ("cpu", "cuda"):
        args = [t.detach().to(dev).requires_grad_() for t in ops]
        ck.reset_launch_counts()
        ys = ck.gru_scan_fused(*args)
        (ys.float() * w.to(dev)).sum().backward()
        if dev == "cuda":
            assert ck.launch_counts["gru_scan_fused_train", torch.bfloat16] == 1
            assert ck.launch_counts["gru_scan_fused_bwd", torch.bfloat16] == 1
        with torch.no_grad():
            gates = ck.gru_scan_train_forward(*[a.detach() for a in args])[1]
        runs[dev] = ys.detach().cpu(), gates.cpu(), [a.grad.cpu() for a in args]
    (cpu_ys, cpu_gates, _), (ys, gates, grads) = runs["cpu"], runs["cuda"]
    assert_bf16_close(ys, cpu_ys)
    torch.testing.assert_close(gates, cpu_gates, rtol=0, atol=1e-5)
    dys = w.bfloat16()                  # the gradient of ys.float() * w
    refs = (*ck.gru_scan_train_backward(dys, ys, gates, ops[2], ops[3]),
            *ck.gru_weight_grads(ys, gates, grads[0], grads[1]))
    for g, r in zip(grads, refs):
        assert g.dtype == torch.bfloat16
        assert_bf16_rounded_close(g, r)


# ------------------------------ the inference forward of both directions ---

def fused_inference_operands(T, B, H, dtype, seed):
    gx, cx, Wg, Wc = (t.to(dtype) for t in stacked_operands(2, T, B, H, torch.device("cuda"),
                                                             seed=seed))
    packed = torch.stack([ck.pack_gru_weights(a, b) for a, b in zip(Wg, Wc)])
    return gx, cx, Wg, Wc, packed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,T,B", STAGED_SHAPES)
def test_staged_inference_matches_plain(cuda, dtype, H, T, B):
    """`gru_scan_fused` (the inference forward of both directions, the
    register kernel in either type) against `gru_scan_fused_plain`, one
    launch: float32 at 1e-4 as `test_fused_inference_matches_two_directions`,
    bf16 at the bf16 limit. In bf16 the default plan is staged, and its
    staged instance (32 steps a stage) and the unstaged one at the same (C,
    R) give the same bits; float32 is not staged (a depth given raises). At
    one row a cluster each direction equals, bit for bit, the inference
    forward of one direction on its inputs (direction 1 on the
    time-reversed ones), whose one-row instance sums in the shared-memory
    kernel's order (`test_one_direction_f32_route_keeps_the_bits`)."""
    gx, cx, Wg, Wc, packed = fused_inference_operands(T, B, H, dtype, seed=H + T)
    limits = ck.device_limits(torch.cuda.current_device())
    plan = ck.gru_scan_plan(H, B, *limits, elem_bytes=dtype.itemsize, dirs=2)
    unstaged = ck.gru_scan_plan(H, B, *limits, elem_bytes=dtype.itemsize, dirs=2, stage_steps=0)
    assert plan.reg_columns == unstaged.reg_columns == {40: 5, 128: 16, 256: 32}[H]
    assert (unstaged.cluster, unstaged.rows, unstaged.stage_steps) == (plan.cluster, plan.rows, 0)
    ck.reset_launch_counts()
    ys = ck.gru_scan_fused(gx, cx, Wg, Wc, packed)
    assert ck.launch_counts["gru_scan_fused", dtype] == sum(ck.launch_counts.values()) == 1
    ref = ck.gru_scan_fused_plain(gx, cx, Wg, Wc)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(ys, ref, rtol=0, atol=1e-4)
        assert plan.stage_steps == 0
        with pytest.raises(ValueError, match="stage_steps"):
            ck.gru_scan_plan(H, B, *limits, dirs=2, stage_steps=32)
    else:
        assert_bf16_close(ys, ref)
        staged = ck.gru_scan_plan(H, B, *limits, elem_bytes=2, dirs=2, stage_steps=32)
        assert plan.stage_steps > 0 and staged.stage_steps == 32
        assert (staged.cluster, staged.rows, staged.reg_columns) == (
            plan.cluster, plan.rows, plan.reg_columns)
        assert torch.equal(ys, ck.gru_scan_launch(gx, cx, packed, staged))
    assert torch.equal(ys, ck.gru_scan_launch(gx, cx, packed, unstaged))
    if dtype == torch.float32 and plan.rows == 1:
        one = ck.gru_scan_plan(H, B, *limits)
        one = dataclasses.replace(one, rows=1, clusters=B,
                                  smem_bytes=ck.gru_scan_smem_bytes(H, one.cluster, 1))
        assert one.reg_columns == plan.reg_columns   # the register kernel, one direction
        fw = ck.gru_scan_launch(gx[0], cx[0], packed[0], one)
        bw = ck.gru_scan_launch(gx[1].flip(0).contiguous(), cx[1].flip(0).contiguous(),
                                packed[1], one).flip(0)
        assert torch.equal(ys[0], fw) and torch.equal(ys[1], bw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,H", [(1, 40), (1, 64), (4, 128), (8, 256)])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_inference_row_tiles(cuda, dtype, R, C, H):
    """Every compiled instance of the inference forward of both directions
    (R rows, 5 / 8 / 16 / 32 register columns; (4, 16) with its candidate
    rows in shared memory), over T = 45, B = 13 (a ragged tile), against
    `gru_scan_fused_plain` (float32 at 1e-5, bf16 at the bf16 limit). bf16
    also staged at 8 steps a stage (a ragged last stage), the same bits as
    unstaged. Refused, nothing run in their place: a staged plan on the
    float32 entry and the staged plan with the unstaged layout's shared
    memory. A staged plan of one direction runs: bf16, direction 0's bits
    (the form of `test_one_direction_row_tiles`); float32 refuses it."""
    T, B, S = 45, 13, 8
    gx, cx, Wg, Wc, packed = fused_inference_operands(T, B, H, dtype, seed=R + C + H)
    base = ck.gru_scan_plan(H, B, *ck.device_limits(torch.cuda.current_device()), cluster=C,
                            elem_bytes=dtype.itemsize, dirs=2, stage_steps=0)
    nk = ck.gru_reg_columns(H, R, base.threads)
    assert nk == ck.gru_reg_columns(H, R, base.threads, staged=True) == {
        40: 5, 64: 8, 128: 16, 256: 32}[H]
    staged, unstaged = (
        dataclasses.replace(base, rows=R, clusters=-(-B // R), stage_steps=s,
                            smem_bytes=ck.gru_scan_smem_bytes(H, C, R, dtype.itemsize,
                                                              stage_steps=s))
        for s in (S, 0))
    assert staged.stage_bytes > 0 and staged.reg_columns == unstaged.reg_columns == nk
    ys = ck.gru_scan_launch(gx, cx, packed, unstaged)
    ref = ck.gru_scan_fused_plain(gx, cx, Wg, Wc)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(ys, ref, rtol=0, atol=1e-5)
        with pytest.raises(RuntimeError, match="launch failed"):
            ck.gru_scan_launch(gx, cx, packed, staged)
    else:
        assert_bf16_close(ys, ref)
        assert torch.equal(ck.gru_scan_launch(gx, cx, packed, staged), ys)
        with pytest.raises(RuntimeError, match="launch failed"):
            ck.gru_scan_launch(gx, cx, packed, dataclasses.replace(
                staged, smem_bytes=unstaged.smem_bytes))
    one = dataclasses.replace(staged, dirs=1)
    if dtype == torch.float32:
        with pytest.raises(RuntimeError, match="launch failed"):
            ck.gru_scan_launch(gx[0], cx[0], packed[0], one)
    else:
        assert torch.equal(ck.gru_scan_launch(gx[0], cx[0], packed[0], one), ys[0])


# ------------------------------ the inference forward of one direction ---

@pytest.mark.parametrize("B", [1, 13])
@pytest.mark.parametrize("H", [40, 128, 256])
def test_one_direction_f32_route_keeps_the_bits(cuda, H, B):
    """The float32 inference forward of one direction, the Pallas kernel's
    own form, runs the register kernel (5 / 16 / 32 columns, one row a
    cluster at B = 1 and 13), one launch, within 1e-5 of the plain version.
    At one row its sums take the shared-memory kernel's order, so it equals
    bit for bit each direction of the both-directions form at one row on the
    same inputs, and the shared-memory kernel itself where a cluster size of
    512-thread CTAs reaches that kernel (H = 128 over 2 CTAs, 256 over 4;
    its sums depend neither on the cluster size nor on the rows). At H = 40
    no cluster size reaches it (gru_scan_bits.py holds the route against the
    kernel's earlier build there)."""
    T = 77
    gx, cx, Wg, Wc = operands(T, B, H, cuda, seed=H + B)
    limits = ck.device_limits(torch.cuda.current_device())
    plan = ck.gru_scan_plan(H, B, *limits)
    assert (plan.rows, plan.reg_columns, plan.stage_steps) == (1, {40: 5, 128: 16, 256: 32}[H], 0)
    ck.reset_launch_counts()
    ys = ck.gru_scan(gx, cx, Wg, Wc)
    assert ck.launch_counts["gru_scan", torch.float32] == sum(ck.launch_counts.values()) == 1
    torch.testing.assert_close(ys, ck.gru_scan_plain(gx, cx, Wg, Wc), rtol=0, atol=1e-5)
    both = ck.gru_scan_plan(H, B, *limits, dirs=2)     # at one row too
    both = dataclasses.replace(both, rows=1, clusters=B,
                               smem_bytes=ck.gru_scan_smem_bytes(H, both.cluster, 1))
    ys2 = ck.gru_scan_launch(*(torch.stack([t, t.flip(0)]) for t in (gx, cx)),
                             torch.stack([ck.pack_gru_weights(Wg, Wc)] * 2), both)
    assert torch.equal(ys2[0], ys) and torch.equal(ys2[1].flip(0), ys)
    if H in (128, 256):
        C = {128: 2, 256: 4}[H]
        smem_plan = ck.gru_scan_plan(H, B, *limits, cluster=C)
        assert (smem_plan.threads, smem_plan.reg_columns) == (512, 0)
        assert smem_plan.smem_bytes == shared_memory_kernel_bytes(H, C, smem_plan.rows)
        got = ck.gru_scan_launch(gx, cx, ck.pack_gru_weights(Wg, Wc, cluster=C), smem_plan)
        assert torch.equal(got, ys)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,H", [(1, 40), (1, 64), (4, 128), (8, 256)])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_one_direction_row_tiles(cuda, dtype, R, C, H):
    """Every instance of the inference forward of one direction (R rows, 5 /
    8 / 16 / 32 register columns; (4, 16), and unstaged (4|8, 32), with
    their candidate rows in shared memory) over T = 45, B = 13 (a ragged tile), against `gru_scan_plain`
    (float32 at 1e-5, bf16 at the bf16 limit), and bit for bit the one-row
    instance's output (its sums take two sets at every R, so a row's output
    does not depend on the batch it runs in); bf16 also staged at 8 steps
    a stage (a ragged last stage), the same bits as unstaged. Refused,
    nothing run in their place: a staged plan on the float32 entry, the
    staged plan with the unstaged layout's shared memory, and the register
    plan with the shared-memory kernel's."""
    T, B, S = 45, 13, 8
    gx, cx, Wg, Wc = operands(T, B, H, cuda, seed=R + C + H, dtype=dtype)
    packed = ck.pack_gru_weights(Wg, Wc, cluster=C)
    base = ck.gru_scan_plan(H, B, *ck.device_limits(torch.cuda.current_device()), cluster=C,
                            elem_bytes=dtype.itemsize, stage_steps=0)
    nk = {40: 5, 64: 8, 128: 16, 256: 32}[H]
    staged, unstaged = (
        dataclasses.replace(base, rows=R, clusters=-(-B // R), stage_steps=s,
                            smem_bytes=ck.gru_scan_smem_bytes(H, C, R, dtype.itemsize,
                                                              stage_steps=s))
        for s in (S, 0))
    assert staged.reg_columns == unstaged.reg_columns == nk and staged.stage_bytes > 0
    ys = ck.gru_scan_launch(gx, cx, packed, unstaged)
    ref = ck.gru_scan_plain(gx, cx, Wg, Wc)
    one_row = dataclasses.replace(base, rows=1, clusters=B,
                                  smem_bytes=ck.gru_scan_smem_bytes(H, C, 1, dtype.itemsize))
    assert torch.equal(ck.gru_scan_launch(gx, cx, packed, one_row), ys)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(ys, ref, rtol=0, atol=1e-5)
        with pytest.raises(RuntimeError, match="launch failed"):
            ck.gru_scan_launch(gx, cx, packed, staged)
    else:
        assert_bf16_close(ys, ref)
        assert torch.equal(ck.gru_scan_launch(gx, cx, packed, staged), ys)
        with pytest.raises(RuntimeError, match="launch failed"):
            ck.gru_scan_launch(gx, cx, packed, dataclasses.replace(
                staged, smem_bytes=unstaged.smem_bytes))
    with pytest.raises(RuntimeError, match="launch failed"):
        ck.gru_scan_launch(gx, cx, packed, dataclasses.replace(
            unstaged, smem_bytes=shared_memory_kernel_bytes(H, C, R)))


@pytest.mark.parametrize("T,B", [(1008, 1), (901, 1), (1008, 16), (3401, 1), (400, 59)])
@pytest.mark.parametrize("H", [40, 128, 256])
def test_one_direction_bf16_staged_matches_unstaged(cuda, H, T, B):
    """The bf16 inference forward of one direction at the stream's (T =
    1008, B = 1 and 16), the sequence-parallel shards' (B = 1, T = 3,401)
    and the convert's (T = 400, B = 59) shapes, and T = 901: none a
    multiple of 32, so the last stage is ragged; tensor-map rows of 80
    bytes at H = 40, B = 1. `gru_scan` launches the staged instance (32
    steps a stage), once, within the bf16 limit of `gru_scan_plain`, and its
    output equals the unstaged instance's at the same plan bit for bit."""
    gx, cx, Wg, Wc = operands(T, B, H, cuda, seed=H + T + B, dtype=torch.bfloat16)
    limits = ck.device_limits(torch.cuda.current_device())
    plan = ck.gru_scan_plan(H, B, *limits, elem_bytes=2)
    unstaged = ck.gru_scan_plan(H, B, *limits, elem_bytes=2, stage_steps=0)
    assert plan.stage_steps == 32 and T % 32 and plan.reg_columns == {40: 5, 128: 16, 256: 32}[H]
    assert (unstaged.cluster, unstaged.rows) == (plan.cluster, plan.rows)
    packed = ck.pack_gru_weights(Wg, Wc)
    ck.reset_launch_counts()
    ys = ck.gru_scan(gx, cx, Wg, Wc, packed)
    assert ck.launch_counts["gru_scan", torch.bfloat16] == sum(ck.launch_counts.values()) == 1
    assert_bf16_close(ys, ck.gru_scan_plain(gx, cx, Wg, Wc))
    assert torch.equal(ck.gru_scan_launch(gx, cx, packed, unstaged), ys)


# ------------------------------------------------------- the bank kernel ---

def bank_operands(B, T, C, K, c, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((B, T, C), generator=g, device=device)
    kernels = [torch.randn((k, C, c), generator=g, device=device) / math.sqrt(k * C)
               for k in range(1, K + 1)]
    return x, kernels


# float32 sums of up to K*C = 8192 products (outputs of rms ~1) in another
# order than cuDNN's per-bank convolutions, TF32 off on both sides
BANK_TOL = 1e-4


@pytest.mark.parametrize("B,T,C,K,c", [
    (59, 400, 40, 6, 128),      # offline: the encoder, decoder step 1, decoder step 2
    (59, 400, 128, 32, 128),
    (59, 400, 256, 32, 128),
    (16, 1008, 256, 32, 128),   # a stream step's window
    (1, 12001, 256, 32, 128),   # a long-form clip, one sequence
    (3, 131, 128, 32, 128),     # ragged: T no multiple of the 128-row tile
    (5, 50, 40, 6, 64),         # two model ranks (c = 64); tiles cross two batch rows
    (2, 37, 7, 5, 10),          # odd K (the middle bank alone), C and c off 16 bytes
    (2, 100, 1000, 32, 128),    # C past one launch's shared memory: four chunks
])
def test_bank_kernel_matches_plain(cuda, B, T, C, K, c):
    with torch.inference_mode():
        x, kernels = bank_operands(B, T, C, K, c, cuda, seed=T + C + K)
        before = ck.launch_counts["conv_banks", torch.float32]
        got = ck.conv_banks(x, kernels)
        torch.cuda.synchronize()
        plan = ck.conv_banks_plan(B, T, C, K, ck.device_limits(torch.cuda.current_device())[1])
        assert ck.launch_counts["conv_banks", torch.float32] == before + len(plan.chunks)
        torch.testing.assert_close(got, ck.conv_banks_plain(x, kernels), rtol=0, atol=BANK_TOL)


def test_bank_kernel_on_halo_rows(cuda):
    """Rows the caller padded (a sequence-parallel shard's halo) with
    padding 0, against the 'same' banks of the unpadded rows."""
    with torch.inference_mode():
        x, kernels = bank_operands(2, 300, 128, 32, 128, cuda, seed=5)
        xp = torch.nn.functional.pad(x, (0, 0, 15, 16))
        got = ck.conv_banks(xp, kernels, pad=(0, 0))
        torch.testing.assert_close(got, ck.conv_banks(x, kernels), rtol=0, atol=BANK_TOL)
        torch.testing.assert_close(got, ck.conv_banks_plain(x, kernels), rtol=0, atol=BANK_TOL)


def test_bank_kernel_rejects_what_it_does_not_take(cuda):
    with torch.inference_mode():
        x, kernels = bank_operands(2, 40, 16, 4, 32, cuda)
        with pytest.raises(TypeError):              # dtype
            ck.conv_banks(x.double(), [k.double() for k in kernels])
        with pytest.raises(TypeError):
            ck.conv_banks(x.bfloat16(), [k.bfloat16() for k in kernels])
        with pytest.raises(ValueError):             # device
            ck.conv_banks(x, [k.cpu() for k in kernels])
        with pytest.raises(ValueError):             # layout: a bank as [k, c, C]
            ck.conv_banks(x, [k.transpose(1, 2).contiguous() for k in kernels])
        with pytest.raises(ValueError):             # banks out of order
            ck.conv_banks(x, kernels[::-1])
        with pytest.raises(ValueError):             # not contiguous
            ck.conv_banks(x.transpose(0, 1).contiguous().transpose(0, 1), kernels)
        with pytest.raises(ValueError):
            ck.conv_banks(x, [k.transpose(1, 2).contiguous().transpose(1, 2) for k in kernels])
    x, kernels = bank_operands(2, 40, 16, 4, 32, cuda)
    x.requires_grad_()
    with pytest.raises(ValueError):                 # autograd records
        ck.conv_banks(x, kernels)


def test_bank_kernel_launches_on_the_main_paths(cuda):
    """One launch a CBHG: 3 a float32 convert, a stream step and a long-form
    clip (each shard its own); none in a bf16 convert, an encoder train step
    (autograd records), a decoder train step (its frozen encoder runs under
    no_grad) and a no_grad forward; the outputs against the CPU's."""
    from speech_cloner_tpu_torch.models import encoder as enc_m
    from speech_cloner_tpu_torch.parallel.mesh import make_seq_mesh
    from speech_cloner_tpu_torch.pipeline.stream import StreamingCloner
    from speech_cloner_tpu_torch.train import (DecoderLossConfig, decoder_train_step,
                                               encoder_train_step, make_train_state)
    from speech_cloner_tpu_torch.train.optimizer import OptimizerConfig

    gpu, cpu = _tiny_pipelines()
    wav = _clip(1.5)
    banks = lambda: ck.launch_counts["conv_banks", torch.float32]  # noqa: E731
    ck.reset_launch_counts()
    with torch.inference_mode():
        got = gpu.device_predict(gpu.pad_wav(wav))
        assert banks() == 3
        ref = cpu.device_predict(cpu.pad_wav(wav))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=0, atol=1e-4)

    ck.reset_launch_counts()
    streamer = StreamingCloner(gpu, batch=1, chunk_frames=64, context_frames=64,
                               lookahead_frames=48, margin_frames=8)
    streamer.push(wav[None])
    steps = ck.launch_counts["gru_scan", torch.float32] // 6     # 6 scans a step
    assert steps > 0 and banks() == 3 * steps

    for n in (1, 2):                 # 301 frames, padded to a multiple of the shards
        phase = np.pi * np.random.default_rng(n).random((-(-301 // n) * n, 201)).astype(np.float32)
        ck.reset_launch_counts()
        out = gpu.convert_seq_parallel(wav, mesh=make_seq_mesh(n, devices=[cuda] * n), warmup=40,
                                       init_phase=phase)
        assert banks() == 3 * n
        ref = cpu.convert_seq_parallel(wav, n_devices=n, warmup=40, init_phase=phase)
        for g, r, tol in zip(out, ref, (1e-3, 1e-4, 1e-4)):
            assert np.abs(g - r).max() <= tol * np.abs(r).max()

    bf16 = make_pipeline(gpu.enc_cfg, gpu.dec_cfg, seed=0, n_iter=4,
                         compute_dtype=torch.bfloat16)
    ck.reset_launch_counts()
    bf16.convert_pcm16(wav)
    assert banks() == 0 and ck.launch_counts["gru_scan", torch.bfloat16] == 6

    cfg = EncoderConfig(n_timesteps=32, input_dim=16, num_conv_banks=3, num_highwaynet_blocks=1,
                        dropout_rate=0.0)
    model = enc_m.init(torch.Generator().manual_seed(0), cfg, device=cuda)
    opt_cfg = OptimizerConfig()
    x = np.random.default_rng(0).standard_normal((4, 32, 16)).astype(np.float32)
    y = np.eye(61, dtype=np.float32)[np.random.default_rng(1).integers(0, 61, (4, 32))]
    ck.reset_launch_counts()
    encoder_train_step(make_train_state(model, opt_cfg, 1), x, y, model=model, opt_cfg=opt_cfg,
                       opt=opt_cfg.make())
    assert banks() == 0 and ck.launch_counts["gru_scan_train", torch.float32] == 2

    rng = np.random.default_rng(2)
    mfcc, mel, stft = (rng.uniform(-1, 1, (2, 48, n)).astype(np.float32) for n in (80, 80, 201))
    ck.reset_launch_counts()
    decoder_train_step(make_train_state(gpu.decoder, opt_cfg, 1), mfcc, mel, stft,
                       encoder=gpu.encoder, model=gpu.decoder, loss_cfg=DecoderLossConfig(),
                       opt_cfg=opt_cfg, opt=opt_cfg.make())
    assert banks() == 0 and ck.launch_counts["gru_scan", torch.float32] == 2
    with torch.no_grad():
        gpu.forward_windows(torch.tensor(mfcc, device=cuda))
    assert banks() == 0


# ------------------------------------------------ Griffin-Lim round kernel ---

# The kernel (csrc/griffin_lim.cu) against its plain version and against
# today's rounds through istft / stft on cuBLAS, max-abs relative to the
# magnitudes' peak. All three are float32; the kernel sums each product as
# one chain in k order (the inverse's re and im parts apart), as cuBLAS's
# kernels mostly do (a round is bit for bit cuBLAS's at 740 of T = 4..2500),
# the plain version's matmuls and some cuBLAS shapes cut them otherwise,
# which moves most bins of S' by ~1e-6 of the peak; a bin whose projection
# X is nearly 0 has an ill-conditioned phase and moves by up to its
# magnitude, so over ~2.4 M bins the largest gap after one round read
# 3.8e-4 on an H100, and after 8 rounds, which carry it on, 4.3e-3 (the
# plain version against cuBLAS).
GL_TOL = {1: 2e-3, 8: 2e-2}
# over all bins: the gap's norm against the magnitudes' norm
GL_L2_TOL = {1: 1e-4, 8: 1e-3}


def gl_operands(B, T, device, seed):
    g = torch.Generator(device).manual_seed(seed)
    amp = 10 * torch.rand((B, T, 201), generator=g, device=device) ** 4
    return torch.polar(amp, math.pi * torch.rand((B, T, 201), generator=g, device=device)), amp


def gl_constants(T, device):
    from speech_cloner_tpu_torch.ops.stft import _window, window_sumsquare
    return _window("hann", 400, 400, device), window_sumsquare("hann", T, 80, 400, 400, device)


def gl_plan(B, T, rows=None):
    plan = ck.gl_round_plan(B, T, 400, 80, *reversed(ck.device_limits(
        torch.cuda.current_device())))
    if rows is None:
        return plan
    wr, rl, lanes, _ = next(i for i in ck.GL_INSTANCES if ck.gl_instance_rows(*i[:3]) == rows)
    return dataclasses.replace(plan, rows=rows, tiles=-(-T // (rows - 4)), warp_rows=wr,
                               lanes=lanes, smem_bytes=ck.gl_round_smem_bytes(rows))


def assert_gl_close(got, ref, amp, n):
    assert (got - ref).abs().max().item() <= GL_TOL[n] * amp.max().item()
    assert torch.linalg.vector_norm(got - ref) <= GL_L2_TOL[n] * torch.linalg.vector_norm(amp)


@pytest.mark.parametrize("T,B", [(12001, 1), (401, 1), (1400, 1), (2401, 1), (1400, 4)])
@pytest.mark.parametrize("n", [1, 8])
def test_gl_round_kernel_matches_plain_and_gemm_rounds(cuda, T, B, n):
    from speech_cloner_tpu_torch.ops.griffin_lim import rounds
    from speech_cloner_tpu_torch.ops.stft import istft, stft

    S0, amp = gl_operands(B, T, cuda, seed=T + B)
    win, env = gl_constants(T, cuda)
    plan = gl_plan(B, T)
    before = ck.launch_counts["gl_round", torch.float32]
    got = ck.gl_rounds(S0.clone(), amp, n, win, env, plan)
    torch.cuda.synchronize()
    assert ck.launch_counts["gl_round", torch.float32] == before + n
    plain = S0
    for _ in range(n):
        plain = ck.gl_round_plain(plain, amp, win, env, plan)
    project = lambda x: stft(istft(x, 80, 400, 400, dft="matmul"), 400, 80, 400,  # noqa: E731
                             dft="matmul")
    gemm = rounds(S0, amp, project, n + 1, 0.0)
    assert_gl_close(got, plain, amp, n)
    assert_gl_close(got, gemm, amp, n)
    torch.testing.assert_close(got.abs(), amp, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows", [16, 32, 64, 96])
@pytest.mark.parametrize("T", [13, 401, 2401])
def test_gl_round_every_instance_gives_the_same_bits(cuda, rows, T):
    """Every instance, whatever its tiles, computes each output in one order:
    the bits of the planned launch, and the plain version's values."""
    S0, amp = gl_operands(2, T, cuda, seed=rows)
    win, env = gl_constants(T, cuda)
    got = ck.gl_rounds(S0.clone(), amp, 2, win, env, gl_plan(2, T, rows))
    assert torch.equal(got, ck.gl_rounds(S0.clone(), amp, 2, win, env, gl_plan(2, T)))
    plain = ck.gl_round_plain(ck.gl_round_plain(S0, amp, win, env, gl_plan(2, T, rows)), amp,
                              win, env, gl_plan(2, T, rows))
    assert_gl_close(got, plain, amp, 8)


def test_gl_round_batch_clip_bits(cuda):
    """Each clip of a batch of 4 (a plan of other tiles than a single clip's)
    gets the bits of its single conversion after 8 rounds."""
    S0, amp = gl_operands(4, 1400, cuda, seed=3)
    win, env = gl_constants(1400, cuda)
    assert gl_plan(4, 1400).rows != gl_plan(1, 1400).rows
    got = ck.gl_rounds(S0.clone(), amp, 8, win, env, gl_plan(4, 1400))
    for b in range(4):
        alone = ck.gl_rounds(S0[b:b + 1].clone(), amp[b:b + 1].contiguous(), 8, win, env,
                             gl_plan(1, 1400))
        assert torch.equal(got[b:b + 1], alone)


def test_gl_round_launches_and_counter(cuda):
    """n_iter - 1 launches a vocoder call where the rule holds, none with the
    FFT DFT or momentum; the ``vocode.gl_rounds_fused`` counter under the
    vocode span reads them."""
    from speech_cloner_tpu_torch.ops.features import FeatureConfig
    from speech_cloner_tpu_torch.pipeline.vocoder import device_vocode
    from speech_cloner_tpu_torch.runtime import profiler

    P = torch.rand((2, 500, 201), generator=torch.Generator(cuda).manual_seed(6), device=cuda)
    kw = dict(realse=1.2, mean_abs_amp_norm=0.01, generator=torch.Generator(cuda).manual_seed(0))
    ck.reset_launch_counts()
    with profiler.recording():
        device_vocode(P, FeatureConfig(), n_iter=12, momentum=0.0, dft="matmul", **kw)
        assert ck.launch_counts["gl_round", torch.float32] == 11
        device_vocode(P, FeatureConfig(), n_iter=12, momentum=0.0, dft="fft", **kw)
        device_vocode(P, FeatureConfig(), n_iter=12, momentum=0.99, dft="matmul", **kw)
        assert ck.launch_counts["gl_round", torch.float32] == 11
        profiler.take()
        counts = [(c.name, c.total) for c in profiler.take_counts()]
    assert counts == [("vocode.gl_rounds_fused", 11), ("vocode.gl_rounds_fused", 0),
                      ("vocode.gl_rounds_fused", 0)]


def test_gl_round_rejects_what_it_does_not_take(cuda):
    S0, amp = gl_operands(1, 50, cuda, seed=0)
    win, env = gl_constants(50, cuda)
    plan = gl_plan(1, 50)
    with pytest.raises(ValueError):                       # the plan's shape
        ck.gl_rounds(S0.clone(), amp, 1, win, env, gl_plan(2, 50))
    with pytest.raises(TypeError):                        # dtype
        ck.gl_rounds(S0.to(torch.complex128), amp.double(), 1, win, env, plan)
    with pytest.raises(ValueError):                       # device
        ck.gl_rounds(S0.clone(), amp.cpu(), 1, win, env, plan)
    with pytest.raises(ValueError):                       # envelope of another T
        ck.gl_rounds(S0.clone(), amp, 1, win, gl_constants(51, cuda)[1], plan)
    with pytest.raises(ValueError):                       # autograd records
        ck.gl_rounds(S0.clone(), amp.clone().requires_grad_(), 1, win, env, plan)
