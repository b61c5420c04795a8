"""bf16 ``compute_dtype`` of the PyTorch port against the JAX package, on the CPU.

The two packages round to bf16 at different places (JAX's ``lax.scan`` carries
the GRU state in bf16, the port's scan in float32, as the Pallas kernel does),
so port-bf16 is not bounded against JAX-bf16. Both are bounded against
JAX-float32: max|port_bf16 - jax_f32| <= 2 * max|jax_bf16 - jax_f32| for each
output. At this geometry the measured ratio was at most 0.94 (mel 0.45-0.56,
stft 0.50-0.76, ppg 0.51-0.94 over seeds 0-2).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_pipeline import T_DEC, T_ENC, clip, pipes  # noqa: F401

from speech_cloner_tpu.ops.pallas_kernels import gru_scan_pallas
from speech_cloner_tpu_torch.models import decoder as tdec
from speech_cloner_tpu_torch.nn.modules import GRU, gru_init
from speech_cloner_tpu_torch.ops import cuda_kernels as ck
from speech_cloner_tpu_torch.pipeline import clone as tclone

torch.set_num_threads(2)
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def bf16_pipes(pipes):  # noqa: F811
    jp, tp = pipes
    return (jp, dataclasses.replace(jp, compute_dtype=jnp.bfloat16),
            dataclasses.replace(tp, compute_dtype=BF16))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_windows_bf16_within_twice_jax_gap(bf16_pipes, seed):
    jp, jpb, tpb = bf16_pipes
    x = np.random.default_rng(seed).uniform(-1, 1, (3, 48, 80)).astype(np.float32)
    ref = [np.asarray(a) for a in jp.forward_windows(jnp.asarray(x))]
    jax_bf16 = [np.asarray(a, np.float32) for a in jpb.forward_windows(jnp.asarray(x))]
    with torch.inference_mode():
        got = tpb.forward_windows(torch.tensor(x))
    for name, g, jb, r in zip(("mel", "stft", "ppg"), got, jax_bf16, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        jax_gap = np.abs(jb - r).max()
        assert 0 < jax_gap < 1e-2, name          # bf16 rounding happened, and is small
        assert np.abs(g.numpy() - r).max() <= 2 * jax_gap, name


def test_plain_bf16_scan_matches_pallas_interpret():
    """bf16 operands: the Pallas kernel widens them, carries h in float32 and
    returns float32; the plain version does the same and rounds ys to bf16.
    So each element is within the float32 sum-order gap (1e-5, as the float32
    test) plus the rounding to bf16 (half an ulp, at most 2^-8 of |y|)."""
    T, B, H = 24, 5, 16
    rng = np.random.default_rng(0)

    def bf(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(jnp.bfloat16)

    gx, cx = bf(T, B, 2 * H), bf(T, B, H)
    Wg, Wc = bf(H, 2 * H, scale=0.3), bf(H, H, scale=0.3)
    ref = np.asarray(gru_scan_pallas(*map(jnp.asarray, (gx, cx, Wg, Wc)), interpret=True))
    as_torch = lambda a: torch.tensor(a.astype(np.float32)).to(BF16)  # noqa: E731
    got = ck.gru_scan(*map(as_torch, (gx, cx, Wg, Wc)))     # a CPU tensor: the plain version
    assert got.dtype == BF16 and ref.dtype == np.float32
    err = np.abs(got.float().numpy() - ref)
    assert (err <= 2.0**-8 * np.abs(ref) + 1e-5).all(), err.max()
    # the state stays float32: a bf16 carry would drift well past this
    assert (got.float().numpy() == ref.astype(jnp.bfloat16).astype(np.float32)).mean() > 0.99


def test_gru_cast_casts_packed_weights():
    g = torch.Generator().manual_seed(0)
    gru = GRU(gru_init(g, 24, 40))
    b = gru.to(BF16)
    for d in ("fw", "bw"):
        pd = b.dirs[d]
        assert pd["gates_kernel"].dtype == BF16
        want = ck.pack_gru_weights(pd["gates_kernel"][-40:], pd["candidate_kernel"][-40:])
        assert torch.equal(getattr(b, f"packed_{d}"), want) and want.dtype == BF16


def test_models_cast_copy_and_pipeline(pipes):  # noqa: F811
    _, tp = pipes
    assert tdec.cast(tp.decoder, None) is tp.decoder
    dec_b = tdec.cast(tp.decoder, BF16)
    assert dec_b is not tp.decoder
    assert all(p.dtype == BF16 for p in dec_b.parameters())
    assert all(p.dtype == torch.float32 for p in tp.decoder.parameters())   # untouched
    assert dec_b.step1.cbhg.bn1.var.dtype == BF16                           # BN statistics
    # make_pipeline takes compute_dtype; convert returns float32 and finite PCM
    pipe = tclone.make_pipeline(T_ENC, T_DEC, seed=0, device="cpu", n_iter=2,
                                compute_dtype=BF16)
    wav, mel, stft, ppg = pipe.convert(clip(2 * 3840 + 10))
    assert all(a.dtype == np.float32 and np.isfinite(a).all() for a in (wav, mel, stft, ppg))
    np.testing.assert_allclose(ppg.sum(-1), 1.0, rtol=1e-5)
    pcm = pipe.convert_batch_pcm16([clip(3000), clip(5000)])
    assert [p.shape for p in pcm] == [((96 - 1) * 80,)] * 2
