"""NN-block parity of the PyTorch port against the JAX package, on the CPU.

Weights are JAX ``*_init`` trees (numpy leaves), BN running statistics are
drawn at random so eval-mode BN does real work, and inputs come from
``np.random.default_rng``. Tolerance: atol 1e-5 throughout: both sides are
float32 and differ only in the order of their sums (XLA CPU against ATen).
The GRU scan's plain version is also held against the Pallas kernel in
interpret mode, as tests/test_pallas.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_cloner_tpu.nn import modules as JM
from speech_cloner_tpu.ops.pallas_kernels import gru_dir_apply_pallas, gru_scan_pallas
from speech_cloner_tpu_torch.nn import modules as TM
from speech_cloner_tpu_torch.ops import cuda_kernels as TK

torch.set_num_threads(2)
ATOL = 1e-5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def random_bn_state(dim, seed):
    rng = np.random.default_rng(seed)
    return {"mean": (0.3 * rng.standard_normal(dim)).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, dim).astype(np.float32)}


def check(got: torch.Tensor, ref, atol=ATOL):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=atol)


def test_dense():
    p = np_tree(JM.dense_init(jax.random.PRNGKey(0), 12, 7, bias_init=0.5))
    x = randn((2, 5, 12), 0)
    check(TM.Dense(p)(torch.tensor(x)), JM.dense(p, x))


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 32])
def test_conv1d(width):
    p = np_tree(JM.conv1d_init(jax.random.PRNGKey(width), width, 6, 9))
    x = randn((2, 40, 6), width)
    ref = JM.conv1d(p, jnp.asarray(x))
    w = torch.tensor(p["kernel"]).permute(2, 1, 0).contiguous()
    check(TM.conv1d(torch.tensor(x), w), ref)
    check(TM.Conv1d(p)(torch.tensor(x)), ref)


def test_bn_eval():
    params = {"gamma": randn(8, 1) + 1.0, "beta": randn(8, 2)}
    state = random_bn_state(8, 3)
    x = randn((3, 10, 8), 4)
    ref, new_state = JM.bn_apply(params, state, jnp.asarray(x), train=False)
    check(TM.BatchNorm(params, state)(torch.tensor(x)), ref)


def test_prenet_and_highway():
    p = np_tree(JM.prenet_init(jax.random.PRNGKey(1), 10, 16))
    x = randn((2, 7, 10), 5)
    check(TM.Prenet(p)(torch.tensor(x)),
          JM.prenet_apply(p, jnp.asarray(x), dropout_rate=0.5, train=False))
    h = np_tree(JM.highway_init(jax.random.PRNGKey(2), 8))
    x = randn((2, 7, 8), 6)
    check(TM.Highway(h)(torch.tensor(x)), JM.highway_apply(h, jnp.asarray(x)))


def test_maxpool1d_same():
    x = randn((2, 9, 4), 7)
    check(TM.maxpool1d_same(torch.tensor(x)), JM.maxpool1d_same(jnp.asarray(x)), atol=0)


@pytest.mark.parametrize("K", [2, 6])
def test_conv1d_banks(K):
    params, state = np_tree(JM.conv1d_banks_init(jax.random.PRNGKey(K), K, 5, 8))
    state = {"bn": random_bn_state(K * 8, K)}
    packed = TM.pack_bank_kernels(params["kernels"], K)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JM.pack_bank_kernels(params["kernels"], K)))
    x = randn((2, 13, 5), K)
    ref, _ = JM.conv1d_banks_apply(params, state, jnp.asarray(x), train=False)
    check(TM.Conv1dBanks(params, state)(torch.tensor(x)), ref)


def _gru_operands(T, B, H, seed):
    lim = np.sqrt(6.0 / (3 * H))
    return (randn((T, B, 2 * H), seed), randn((T, B, H), seed + 1),
            randn((H, 2 * H), seed + 2, lim), randn((H, H), seed + 3, lim))


@pytest.mark.parametrize("T,B,H", [(24, 3, 8), (48, 2, 40)])
def test_gru_scan_plain_matches_pallas(T, B, H):
    ops = _gru_operands(T, B, H, seed=T + H)
    ref = gru_scan_pallas(*map(jnp.asarray, ops), interpret=True)
    check(TK.gru_scan_plain(*map(torch.tensor, ops)), ref)


def test_gru_dir_apply_matches_scan_and_pallas():
    B, T, C, H = 4, 24, 8, 16
    params = np_tree(JM.gru_dir_init(jax.random.PRNGKey(0), C, H))
    x = randn((B, T, C), 8, 0.5)
    got = TK.gru_dir_apply({k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x))
    check(got, JM._gru_dir_apply(params, jnp.asarray(x)))
    check(got, gru_dir_apply_pallas(params, jnp.asarray(x), interpret=True))


def test_gru_bidirectional():
    B, T, C, H = 2, 10, 6, 8
    params = np_tree(JM.gru_init(jax.random.PRNGKey(1), C, H))
    x = randn((B, T, C), 9, 0.5)
    check(TM.GRU(params)(torch.tensor(x)), JM.gru_apply(params, jnp.asarray(x)))
    uni = {"fw": params["fw"]}
    check(TM.GRU(uni)(torch.tensor(x)), JM.gru_apply(uni, jnp.asarray(x)))


def test_cbhg_eval():
    cfg_j = JM.CBHGConfig(embed_size=16, num_banks=3, num_highway=2)
    params, state = np_tree(JM.cbhg_init(jax.random.PRNGKey(3), cfg_j))
    state = {"banks": {"bn": random_bn_state(3 * 128, 10)},
             "bn1": random_bn_state(8, 11), "bn2": random_bn_state(8, 12)}
    x = randn((2, 20, 8), 13)
    ref, _ = JM.cbhg_apply(params, state, jnp.asarray(x), cfg=cfg_j, train=False)
    cbhg = TM.CBHG(params, state, TM.CBHGConfig(embed_size=16, num_banks=3, num_highway=2))
    check(cbhg(torch.tensor(x)), ref)


@pytest.mark.parametrize("option", [{}, {"fused_gru": True}, {"use_lstm": True}])
def test_cbhg_without_new_fields_keeps_trees_and_bits(option):
    """The CBHG's projections, pre-highway dense and lengths are new: built
    without them, its init draws and tree are the JAX package's layout (the
    same keys, in order, from the same draws as before), and lengths that
    cover every frame give the output of no lengths, bit for bit (to the
    order of the sums under ``fused_gru``, whose lengths path runs a scan a
    direction)."""
    cfg = TM.CBHGConfig(embed_size=16, num_banks=3, num_highway=2, **option)
    params, state = TM.cbhg_init(torch.Generator().manual_seed(5), cfg)
    assert list(params) == ["banks", "conv1d_1", "bn1", "conv1d_2", "bn2", "highway", "gru"]
    assert list(state) == ["banks", "bn1", "bn2"] and not cfg.pre_highway
    g = torch.Generator().manual_seed(5)          # the draws of the layout before the fields
    banks = [TM.glorot_uniform(g, (k, 8, 128), k * 8, k * 128) for k in range(1, 4)]
    c1 = TM.glorot_uniform(g, (3, 384, 8), 3 * 384, 3 * 8)
    c2 = TM.glorot_uniform(g, (3, 8, 8), 24, 24)
    assert all(torch.equal(a, b) for a, b in zip(params["banks"]["kernels"], banks))
    assert torch.equal(params["conv1d_1"]["kernel"], c1)
    assert torch.equal(params["conv1d_2"]["kernel"], c2)
    jstate = {"banks": {"bn": random_bn_state(3 * 128, 10)},
              "bn1": random_bn_state(8, 11), "bn2": random_bn_state(8, 12)}
    cbhg = TM.CBHG(params, jstate, cfg)
    assert cbhg.pre_highway is None and list(cbhg.params_tree()) == list(params)
    x = torch.tensor(randn((2, 20, 8), 13))
    with torch.no_grad():
        out = cbhg(x)
        full = cbhg(x, lengths=torch.tensor([20, 20]))
    if option.get("fused_gru"):
        torch.testing.assert_close(full, out, rtol=0, atol=1e-6)
    else:
        assert torch.equal(out, full)
    if not option:
        ref, _ = JM.cbhg_apply(np_tree({k: v for k, v in params.items()}), jstate,
                               jnp.asarray(x.numpy()), cfg=JM.CBHGConfig(16, 3, 2), train=False)
        check(out, ref)


@pytest.mark.parametrize("option", ["use_lstm", "fused_gru"])
def test_cbhg_unported_options_raise(option):
    """Both options are ported now: fused_gru builds a CBHG whose GRU runs
    both directions in one scan; use_lstm (once refused) one whose "gru"
    is an LSTM, computing the JAX CBHG's function on its tree."""
    cfg = TM.CBHGConfig(embed_size=16, num_banks=2, num_highway=1, **{option: True})
    params, state = np_tree(JM.cbhg_init(jax.random.PRNGKey(0),
                                         JM.CBHGConfig(16, 2, 1, **{option: True})))
    if option == "fused_gru":
        assert TM.CBHG(params, state, cfg).gru.fused
        return
    cbhg = TM.CBHG(params, state, cfg)
    assert isinstance(cbhg.gru, TM.LSTM)
    x = randn((2, 20, 8), 14)
    ref, _ = JM.cbhg_apply(params, state, jnp.asarray(x),
                           cfg=JM.CBHGConfig(16, 2, 1, use_lstm=True), train=False)
    check(cbhg(torch.tensor(x)), ref)


def test_gru_scan_dispatch_on_cpu():
    ops = [torch.tensor(a) for a in _gru_operands(6, 2, 4, seed=20)]
    before = dict(TK.launch_counts)
    torch.testing.assert_close(TK.gru_scan(*ops), TK.gru_scan_plain(*ops), rtol=0, atol=0)
    assert TK.launch_counts == before            # the CPU path launches no kernel
    with pytest.raises(ValueError, match="unsupported device"):
        TK.gru_scan(*(t.to("meta") for t in ops))
    with pytest.raises(ValueError, match="cx must be"):
        TK.gru_scan(ops[0], ops[1][:, :, :3], ops[2], ops[3])
