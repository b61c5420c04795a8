"""The CBHG bank convolutions of the port, on the CPU: the bank kernel's
plain version (`conv_banks_plain`) against the packed width-K conv the JAX
package runs, the launch plan of the kernel (csrc/conv_banks.cu), and the
dispatch of `Conv1dBanks.conv` by what its input shows.

Tolerance: atol 1e-5, float32 both sides; the plain version sums each
bank's taps where the packed conv also adds zero taps, so the two differ
only in the order of their sums.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech_cloner_tpu_torch.nn import modules as TM
from speech_cloner_tpu_torch.ops import cuda_kernels as TK

torch.set_num_threads(2)
ATOL = 1e-5
H100_SMEM_OPTIN = 232448


def bank_operands(B, T, C, K, c, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, T, C), generator=g)
    kernels = [torch.randn((k, C, c), generator=g) / np.sqrt(k * C) for k in range(1, K + 1)]
    return x, kernels


def packed_conv(x, kernels, pad=None):
    w = TM.pack_bank_kernels(kernels, len(kernels)).permute(2, 1, 0).contiguous()
    return TM.conv1d(x, w, pad)


# the encoder's K = 6 at C = 40 and the decoder's K = 32 at C = 128; a bank
# of 128 channels and of 64 (two model ranks, parallel/sharding.py); T = 37
# and 131 are no multiple of the kernel's 128-row tile
@pytest.mark.parametrize("K,C", [(6, 40), (32, 128)])
@pytest.mark.parametrize("c", [128, 64])
@pytest.mark.parametrize("B,T", [(2, 37), (3, 131)])
def test_plain_banks_equal_packed_conv(K, C, c, B, T):
    x, kernels = bank_operands(B, T, C, K, c, seed=K + C + c + T)
    got = TK.conv_banks_plain(x, kernels)
    assert got.shape == (B, T, K * c)
    torch.testing.assert_close(got, packed_conv(x, kernels), rtol=0, atol=ATOL)


@pytest.mark.parametrize("K,C", [(6, 40), (32, 128)])
def test_plain_banks_on_halo_rows(K, C):
    """Rows padded by the caller (the halo rows of a sequence-parallel
    shard) with padding 0 give the 'same' conv of the unpadded rows; an odd
    K's halo is split as TF splits it."""
    x, kernels = bank_operands(2, 45, C, K, 64, seed=K)
    halo = (K - 1) // 2, K // 2
    xp = F.pad(x, (0, 0, *halo))
    got = TK.conv_banks_plain(xp, kernels, pad=(0, 0))
    torch.testing.assert_close(got, TK.conv_banks_plain(x, kernels), rtol=0, atol=ATOL)
    torch.testing.assert_close(got, packed_conv(xp, kernels, (0, 0)), rtol=0, atol=ATOL)
    odd = kernels[:5]
    torch.testing.assert_close(TK.conv_banks_plain(F.pad(x, (0, 0, 2, 2)), odd, pad=(0, 0)),
                               packed_conv(x, odd), rtol=0, atol=ATOL)


# input tile rows: 128 frames, K - 1 halo, and K - 1 more for each batch row
# a tile crosses
@pytest.mark.parametrize("B,T,C,K,rows", [
    (59, 400, 40, 6, 128 + 5 * 2),          # offline encoder: a tile crosses one batch row
    (59, 400, 128, 32, 128 + 31 * 2),       # offline decoder step 1
    (59, 400, 256, 32, 128 + 31 * 2),       # offline decoder step 2
    (16, 1008, 256, 32, 128 + 31 * 2),      # stream step
    (1, 12001, 256, 32, 128 + 31),          # long-form: one row, no crossing
    (3, 50, 128, 32, 128 + 31 * 3),         # short rows: a tile crosses two
])
def test_plan_main_path_shapes_take_one_launch(B, T, C, K, rows):
    plan = TK.conv_banks_plan(B, T, C, K, H100_SMEM_OPTIN)
    assert plan.x_rows == rows and plan.chunks == [(0, C)]
    assert plan.smem_bytes == TK.BANK_RING_BYTES + 4 * rows * (C + 4)     # rows 4 words apart
    assert plan.smem_bytes <= H100_SMEM_OPTIN


@pytest.mark.parametrize("B,T,C,K", [(2, 100, 2000, 32), (4, 1, 256, 32), (3, 7, 1001, 9)])
def test_plan_splits_channels_that_do_not_fit(B, T, C, K):
    plan = TK.conv_banks_plan(B, T, C, K, H100_SMEM_OPTIN)
    chunks = plan.chunks
    assert len(chunks) > 1
    assert [c0 for c0, _ in chunks] == list(range(0, C, plan.chunk))
    assert sum(n for _, n in chunks) == C and plan.chunk % 4 == 0
    assert all(TK.conv_banks_smem_bytes(plan.x_rows, n) <= H100_SMEM_OPTIN for _, n in chunks)
    # the fewest launches: one fewer would not fit
    fewer = -(-C // (len(chunks) - 1))
    assert TK.conv_banks_smem_bytes(plan.x_rows, fewer) > H100_SMEM_OPTIN


@pytest.mark.parametrize("args", [(1, 1, 1, TK.MAX_BANKS + 1), (0, 10, 8, 4), (1, 1, 8, 1000)])
def test_plan_rejects_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        TK.conv_banks_plan(*args, H100_SMEM_OPTIN)


def small_banks(K=4, C=8, c=16, seed=0):
    _, kernels = bank_operands(1, 1, C, K, c, seed)
    params = {"kernels": kernels, "bn": {"gamma": torch.ones(K * c), "beta": torch.zeros(K * c)}}
    state = {"bn": {"mean": torch.zeros(K * c), "var": torch.ones(K * c)}}
    return TM.Conv1dBanks(params, state)


class _Like:
    """What `bank_kernel_takes` reads of a tensor, on any device."""

    def __init__(self, is_cuda, dtype=torch.float32, requires_grad=False, inference=True):
        self.is_cuda, self.dtype, self.requires_grad = is_cuda, dtype, requires_grad
        self.inference = inference

    def is_inference(self):
        return self.inference


# (device, made under inference mode, dtype, autograd records): a float32
# inference tensor on the card takes the bank kernel; training (autograd
# records, or the frozen encoder under no_grad), bf16 and the CPU take the
# packed conv
@pytest.mark.parametrize("cuda", [True, False])
@pytest.mark.parametrize("inference", [True, False])
@pytest.mark.parametrize("dtype,records,kernel", [
    (torch.float32, False, True),
    (torch.float32, True, False),
    (torch.bfloat16, False, False),
    (torch.bfloat16, True, False),
])
def test_bank_kernel_takes_cuda_float32_inference_only(cuda, inference, dtype, records, kernel):
    x = _Like(cuda, dtype, inference=inference)
    kernels = [_Like(cuda, dtype, records) for _ in range(3)]
    with torch.set_grad_enabled(True):
        assert TM.bank_kernel_takes(x, kernels) == (kernel and cuda and inference)
    with torch.set_grad_enabled(False):            # nothing records with grad off
        assert TM.bank_kernel_takes(x, kernels) == (cuda and inference
                                                    and dtype == torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["records", "no_grad", "inference"])
def test_dispatch_by_what_the_input_shows(monkeypatch, dtype, mode):
    """On the CPU every case takes the packed conv: the kernel's entry point
    is never called, and the result is the packed conv's."""
    banks = small_banks().to(dtype)
    x = torch.randn((2, 9, 8)).to(dtype)
    calls = []

    def spy(*args, **kw):
        calls.append(args)
        return TK.conv_banks(*args, **kw)
    monkeypatch.setattr(TM, "conv_banks", spy)
    with {"records": torch.enable_grad, "no_grad": torch.no_grad,
          "inference": torch.inference_mode}[mode]():
        y = banks.conv(x * 1, banks.weight())
    assert not calls
    assert y.requires_grad == (mode == "records")
    ref = packed_conv(x.float(), [k.detach().float() for k in banks.weight()])
    torch.testing.assert_close(y.detach().float(), ref, rtol=0,
                               atol=ATOL if dtype == torch.float32 else 5e-2)


def test_recording_forward_trains_the_live_taps_only():
    """The packed path's gradient reaches each bank's own taps: the packed
    weight's zero taps have no parameter behind them."""
    banks = small_banks()
    x = torch.randn((2, 9, 8))
    banks(x, train=True).square().sum().backward()
    assert all(k.grad is not None and k.grad.shape == k.shape and k.grad.abs().max() > 0
               for k in banks.kernels)


def test_kernel_entry_rejects_unsupported_device():
    x, kernels = bank_operands(1, 4, 8, 2, 8, seed=0)
    with pytest.raises(ValueError, match="unsupported device"):
        TK.conv_banks(x.to("meta"), [k.to("meta") for k in kernels])
