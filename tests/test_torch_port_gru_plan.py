"""The GRU scan kernels' launch plans and work split, on the CPU.

`gru_scan_plan` and `pack_gru_weights` are plain Python and tensor code;
the kernels themselves (csrc/gru_scan.cu) run only on a card. Here the
plans of the float32 forward, the bf16 forward and the backward are checked
over the widths and batch sizes the port meets, and slice-by-slice
emulations of the kernels (below, in numpy float32: clusters of CTAs, each
CTA its packed weight slice, the row tile, a team of 8 lanes per unit each
summing its strided share of k) are held against the JAX package: the
forward's (exchanges of r*h and h) against the Pallas kernel in interpret
mode at atol 1e-5, as tests/test_torch_port_nn.py holds the plain version,
and the register forward's (the float32 training forward: each lane's
register columns, both directions, the gates out) the same way, its gates
against the plain version's; the backward's (each lane's register columns, the [dcx, dgu] exchange, then
the dgr one) against ``jax.vjp`` of the package's ``lax.scan`` GRU within
1e-5 of each output's peak, as tests/test_torch_port_train.py holds the
plain backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_cloner_tpu.nn import modules as JM
from speech_cloner_tpu.ops.pallas_kernels import gru_scan_pallas
from speech_cloner_tpu_torch.nn import modules as TM
from speech_cloner_tpu_torch.ops import cuda_kernels as ck

N_SMS = 132          # H100 SXM
SMEM_OPTIN = 232_448
ATOL = 1e-5


def cta_units(H, C):
    """The units CTA c of a cluster owns: [c*Hc, (c+1)*Hc) cut at H, as the kernel
    and pack_gru_weights lay them out."""
    Hc = -(-H // C)
    return [range(min(c * Hc, H), min((c + 1) * Hc, H)) for c in range(C)]


# the kernels' plan arguments: the f32 forward (inference, and training:
# the gates out), the bf16 forward (inference and training), the backward
# (f32 and bf16 operands)
KINDS = {"float32": {}, "bfloat16": {"elem_bytes": 2}, "backward": {"backward": True},
         "bf16_train": {"elem_bytes": 2, "gates": True},
         "bf16_backward": {"elem_bytes": 2, "backward": True},
         "float32_train": {"gates": True}}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("B", [1, 3, 9, 59])
@pytest.mark.parametrize("H", [1, 8, 40, 128, 256, 512])
def test_plan_partitions_rows_and_units(H, B, kind):
    plan = ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN, **KINDS[kind])
    bwd, gates = KINDS[kind].get("backward", False), KINDS[kind].get("gates", False)
    assert (plan.backward, plan.gates) == (bwd, gates)
    C, R = plan.cluster, plan.rows
    # every batch row in exactly one cluster
    rows = [r for g in range(plan.clusters) for r in range(g * R, min(B, (g + 1) * R))]
    assert rows == list(range(B))
    assert (plan.clusters - 1) * R < B <= plan.clusters * R
    # the CTAs' units partition [0, H), none empty
    units = cta_units(H, C)
    assert [j for u in units for j in u] == list(range(H))
    assert all(len(u) for u in units) and plan.units == len(units[0])
    # a cluster size the card allows (16 only as a non-portable size)
    assert C in (1, 2, 4, 8, 16) and C <= ck.MAX_CLUSTER
    # a team of 8 lanes per unit, a lane per row of the tile
    assert R in ck.ROWS_PER_CTA and R <= ck.TEAM_LANES
    assert plan.threads % 32 == 0
    assert plan.units * ck.TEAM_LANES <= plan.threads <= ck.MAX_THREADS
    assert plan.smem_bytes == ck.gru_scan_smem_bytes(H, C, R, **KINDS[kind],
                                                     stage_steps=plan.stage_steps)
    assert plan.smem_bytes <= SMEM_OPTIN
    # every bf16 kernel stages where the shape allows; no float32 one does
    staged = kind in ("bfloat16", "bf16_train", "bf16_backward") and H % 8 == 0 and H <= 256
    assert (plan.stage_steps > 0) == staged
    nk = plan.reg_columns
    # bf16 weights stay bf16 pairs in the forward's shared memory; the
    # backward widens them to float32 rows
    weight_bytes = 3 * H * plan.units * (2 if kind in ("bfloat16", "bf16_train") else 4)
    if nk == 0:
        # weights and state in one CTA's shared memory
        assert weight_bytes < plan.smem_bytes
        assert H > 256
    else:
        # weights in registers: the lanes' columns cover H, the vectors with
        # their pad rows in shared memory and no weights
        assert ck.TEAM_LANES * nk >= H and (nk == 5 or ck.TEAM_LANES * nk < 2 * H)
        hp = ck.TEAM_LANES * nk
        vectors = 4 * (2 * hp * 2 * R + 2 * hp * R) if bwd else 16 * hp * R
        if ck._reg_instance(bwd, R, nk, gates, staged)[2]:     # candidate rows, f32
            vectors += 4 * plan.units * ck.gru_weight_stride(H)
        # the mbarriers (6 staged) ahead; staged, the ring behind, on 128 bytes
        bars, slack = (64, 128) if staged else (32, 0)
        assert vectors <= plan.smem_bytes - plan.stage_bytes - bars < vectors + 64 + slack
        assert plan.threads <= (256 if nk >= 16 else ck.MAX_THREADS)


def test_plan_on_the_main_path():
    """The scans of one convert: B = 59 at H = 40, 128, 256, float32 and
    bf16 operands, both the register forward with one plan (bf16 staged,
    32 steps a stage); the shared-memory kernel's plan where no column
    class serves; a train step's backward: B = 32."""
    p40, p128, p256 = (ck.gru_scan_plan(H, 59, N_SMS, SMEM_OPTIN) for H in (40, 128, 256))
    assert (p40.cluster, p40.rows, p40.clusters, p40.threads) == (1, 1, 59, 320)
    assert (p128.cluster, p128.rows, p128.clusters, p128.threads) == (4, 1, 59, 256)
    assert (p256.cluster, p256.rows, p256.clusters, p256.threads) == (8, 4, 15, 256)
    # weights in registers; two CTAs to an SM at H = 128, one at H = 256
    # (its register budget), where 15 clusters of 4 rows fit at once; the
    # unstaged (4, 32) instance keeps its candidate rows in shared memory
    assert [p.reg_columns for p in (p40, p128, p256)] == [5, 16, 32]
    assert N_SMS < p128.ctas <= 2 * N_SMS
    assert p256.clusters <= N_SMS // p256.cluster - 1
    assert all(p.smem_bytes < 20 * 1024 and p.stage_steps == 0 for p in (p40, p128))
    assert p256.smem_bytes - 4 * p256.units * ck.gru_weight_stride(256) < 20 * 1024
    b40, b128, b256 = (ck.gru_scan_plan(H, 59, N_SMS, SMEM_OPTIN, elem_bytes=2)
                       for H in (40, 128, 256))
    assert [(p.cluster, p.rows, p.ctas) for p in (b40, b128, b256)] == [
        (1, 1, 59), (4, 1, 236), (8, 4, 120)]
    assert [(p.reg_columns, p.stage_steps) for p in (b40, b128, b256)] == [
        (5, 32), (16, 32), (32, 32)]
    assert [dataclasses.replace(p, smem_bytes=0, stage_steps=0) for p in (b40, b128, b256)] == [
        dataclasses.replace(p, smem_bytes=0) for p in (p40, p128, p256)]
    # no column class: 512-thread CTAs (H = 128 over 2, H = 256 over 4) take
    # the shared-memory kernel, 3 H Hc float32 weights a CTA (96 KB at H = 256)
    s128, s256 = (ck.gru_scan_plan(H, 59, N_SMS, SMEM_OPTIN, cluster=C)
                  for H, C in ((128, 2), (256, 4)))
    assert [(p.threads, p.reg_columns, p.rows) for p in (s128, s256)] == [(512, 0, 1),
                                                                          (512, 0, 2)]
    assert 12 * 128 * s128.units == 96 * 1024 < s128.smem_bytes
    assert s256.smem_bytes == ck.gru_scan_smem_bytes(256, 4, 2) > 12 * 256 * s256.units
    # the backward at B = 32, one direction and both: one row per cluster
    for dirs in (1, 2):
        w40, w128, w256 = (ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, dirs=dirs, backward=True)
                           for H in (40, 128, 256))
        assert [(p.cluster, p.rows, p.ctas) for p in (w40, w128, w256)] == [
            (1, 1, 32 * dirs), (4, 1, 128 * dirs), (8, 1, 256 * dirs)]
        assert [ck.gru_reg_columns(p.H, 1, p.threads, True) for p in (w40, w128, w256)] == [
            5, 16, 32]
        assert all(p.smem_bytes < 8 * 1024 for p in (w40, w128, w256))


def test_bf16_training_plans():
    """The bf16 training kernels at a train step's shapes (B = 32). The
    backward's unstaged plan does not depend on the operand type (it widens
    the bf16 weights to float32 wherever it keeps them). The unstaged bf16
    training forward's instances with NK = 32 columns and 4 or 8 rows spill
    (its r and u live to the gates' store), so they are shared-memory
    instances and its unstaged plan at H = 256 takes 2 rows, where the
    inference forward takes 4; the staged instances (the plans' default)
    hold (4, 32) in registers and take 4 rows there, and both directions of
    the staged backward 2."""
    for H in (1, 40, 128, 256, 300, 512):
        for dirs in (1, 2):
            f32, bf = (ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, elem_bytes=e, dirs=dirs,
                                        backward=True, stage_steps=0) for e in (4, 2))
            assert f32 == bf
    assert [ck._reg_instance(False, R, 32, gates=True)[0] for R in (1, 2, 4, 8)] == [
        True, True, False, False]
    assert [ck._reg_instance(False, R, 32)[0] for R in (1, 2, 4, 8)] == [True] * 4
    assert all(ck._reg_instance(False, R, nk, gates=True) == ck._reg_instance(False, R, nk)
               for R in (1, 2, 4, 8) for nk in (5, 8, 16))
    train = [ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, elem_bytes=2, gates=True, stage_steps=0)
             for H in (40, 128, 256)]
    infer = [ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, elem_bytes=2) for H in (40, 128, 256)]
    assert [(p.cluster, p.rows) for p in train] == [(1, 1), (4, 1), (8, 2)]
    assert [(p.cluster, p.rows) for p in infer] == [(1, 1), (4, 1), (8, 4)]
    assert [ck.gru_reg_columns(p.H, p.rows, p.threads, gates=True) for p in train] == [5, 16, 32]
    assert ck.gru_reg_columns(256, 4, 256, gates=True) == 0
    staged = [ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, elem_bytes=2, dirs=d, backward=b,
                               gates=not b) for b in (False, True) for d in (1, 2)
              for H in (40, 128, 256)]
    assert [(p.cluster, p.rows) for p in staged] == [
        (1, 1), (4, 1), (8, 4), (1, 1), (4, 1), (8, 2),      # training forward, dirs 1 and 2
        (1, 1), (4, 1), (8, 1), (1, 1), (4, 1), (8, 2)]      # backward
    assert [p.reg_columns for p in staged] == [5, 16, 32] * 4
    assert ck.gru_reg_columns(256, 4, 256, gates=True, staged=True) == 32
    assert ck.gru_scan_smem_bytes(256, 8, 4, 2, gates=True) > ck.gru_scan_smem_bytes(256, 8, 4, 2)
    with pytest.raises(ValueError, match="elem_bytes"):
        ck.gru_scan_plan(40, 4, N_SMS, SMEM_OPTIN, elem_bytes=8)


def test_f32_training_plans():
    """The float32 training forward at a train step's shapes (B = 32) is
    the register forward with float32 operands: the bf16 training forward's
    plans, column classes and spill table, and its register layout of
    shared memory (the vectors only); past H = 256, and for the row counts
    whose register instance spills, the shared-memory forward's layout.
    The float32 inference forward, whose instances do not spill, keeps the
    register layout at every row count."""
    for dirs in (1, 2):
        train = [ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, dirs=dirs, gates=True)
                 for H in (40, 128, 256)]
        bf16 = [ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, elem_bytes=2, dirs=dirs, gates=True,
                                 stage_steps=0) for H in (40, 128, 256)]
        assert [(p.cluster, p.rows) for p in train] == [(1, 1), (4, 1), (8, 2)]
        assert [dataclasses.replace(p, smem_bytes=0) for p in train] == [
            dataclasses.replace(p, smem_bytes=0) for p in bf16]
        assert [ck.gru_reg_columns(p.H, p.rows, p.threads, gates=True) for p in train] == [
            5, 16, 32]
        assert [p.smem_bytes for p in train] == [p.smem_bytes for p in bf16]
        assert all(p.smem_bytes < 16 * 1024 for p in train)   # no weights
    # the spill table: (4 | 8, 32) keep the shared-memory instance
    assert [ck._reg_instance(False, R, 32, gates=True)[0] for R in (1, 2, 4, 8)] == [
        True, True, False, False]
    infer = ck.gru_scan_smem_bytes(256, 8, 4)
    assert ck.gru_scan_smem_bytes(256, 8, 4, gates=True) > 96 * 1024 > infer
    assert ck.gru_scan_smem_bytes(256, 8, 2, gates=True) == ck.gru_scan_smem_bytes(256, 8, 2)
    for H in (300, 512):       # no column class: the shared-memory forward's plan
        assert ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, gates=True) == dataclasses.replace(
            ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN), gates=True)


def test_plan_refuses_what_does_not_fit():
    for H, B in ((0, 4), (ck.MAX_H + 1, 4), (40, 0)):
        with pytest.raises(ValueError):
            ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN)
    with pytest.raises(ValueError, match="cluster size"):
        ck.gru_scan_plan(40, 4, N_SMS, SMEM_OPTIN, cluster=3)
    with pytest.raises(RuntimeError, match="no plan fits"):
        ck.gru_scan_plan(512, 4, N_SMS, SMEM_OPTIN, cluster=8)     # 384 KB of weights
    with pytest.raises(RuntimeError, match="no plan fits"):
        ck.gru_scan_plan(128, 4, N_SMS, 48 * 1024, cluster=2)
    with pytest.raises(RuntimeError, match="no plan fits"):
        ck.gru_scan_plan(128, 4, N_SMS, SMEM_OPTIN, cluster=1)    # 1024 threads


@pytest.mark.parametrize("H,C", [(8, None), (40, 16), (129, 2), (256, None)])
def test_pack_gru_weights_layout(H, C):
    rng = np.random.default_rng(H)
    Wg = rng.standard_normal((H, 2 * H)).astype(np.float32)
    Wc = rng.standard_normal((H, H)).astype(np.float32)
    packed = ck.pack_gru_weights(torch.tensor(Wg), torch.tensor(Wc), cluster=C).numpy()
    C = C or ck.gru_cluster_size(H)
    Hc = -(-H // C)
    assert packed.shape == (C, 3 * Hc, H)
    for c, units in enumerate(cta_units(H, C)):
        n = len(units)
        np.testing.assert_array_equal(packed[c, :n], Wg[:, units].T)
        np.testing.assert_array_equal(packed[c, Hc:Hc + n], Wg[:, [H + j for j in units]].T)
        np.testing.assert_array_equal(packed[c, 2 * Hc:2 * Hc + n], Wc[:, units].T)
        for lo in (n, Hc + n, 2 * Hc + n):           # zero past H
            assert not packed[c, lo:lo + Hc - n].any()


def test_gru_module_packs_once():
    params = {d: {k: np.asarray(v) for k, v in JM.gru_dir_init(
        jax.random.PRNGKey(i), 6, 40).items()} for i, d in enumerate(("fw", "bw"))}
    gru = TM.GRU(params)
    for d in ("fw", "bw"):
        want = ck.pack_gru_weights(torch.tensor(params[d]["gates_kernel"][6:]),
                                   torch.tensor(params[d]["candidate_kernel"][6:]))
        torch.testing.assert_close(getattr(gru, f"packed_{d}"), want, rtol=0, atol=0)
    assert not any(k.startswith("packed") for k in gru.state_dict())


def test_gru_module_packs_backward_once_per_weight_version(monkeypatch):
    """The backward kernel's packing (`pack_gru_weights_bwd`) is cached in
    the module beside the forward's, while autograd records too: one pack
    per version of a direction's weights, a fresh one after an in-place
    update (what an optimizer step does), none in the state dict."""
    params = {d: {k: np.asarray(v) for k, v in JM.gru_dir_init(
        jax.random.PRNGKey(i), 6, 40).items()} for i, d in enumerate(("fw", "bw"))}
    gru = TM.GRU(params)
    calls = []
    real = TM.pack_gru_weights_bwd
    monkeypatch.setattr(TM, "pack_gru_weights_bwd",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))

    def want(d):
        pd = gru.dirs[d]
        return ck.pack_gru_weights_bwd(pd["gates_kernel"].detach()[6:],
                                       pd["candidate_kernel"].detach()[6:])

    with torch.enable_grad():
        assert all(p.requires_grad for p in gru.parameters())
        first = gru.packed_bwd("fw")
        assert gru.packed_bwd("fw") is first and len(calls) == 1
        assert not first.requires_grad
        torch.testing.assert_close(first, want("fw"), rtol=0, atol=0)
        bw = gru.packed_bwd("bw")
        assert len(calls) == 2
        with torch.no_grad():
            gru.dirs["fw"]["candidate_kernel"].mul_(0.5)
        again = gru.packed_bwd("fw")
        assert len(calls) == 3 and again is not first
        torch.testing.assert_close(again, want("fw"), rtol=0, atol=0)
        assert gru.packed_bwd("fw") is again and gru.packed_bwd("bw") is bw and len(calls) == 3
    assert not any(k.startswith("packed") for k in gru.state_dict())


@pytest.mark.parametrize("fused", [False, True])
def test_backward_pack_reaches_the_scan_backward(monkeypatch, fused):
    """`gru_apply` and `gru_apply_fused` hand the backward's packs to
    `GruScan`, whose backward passes them to `gru_scan_train_backward` (on
    the CPU the plain version, which does not read them): the gradients are
    those of the plain backward."""
    params = {d: {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in JM.gru_dir_init(
        jax.random.PRNGKey(i), 6, 8).items()} for i, d in enumerate(("fw", "bw"))}
    marks = {d: torch.full((1, 3, 8), float(i)) for i, d in enumerate(("fw", "bw"))}
    seen = []
    real = ck.gru_scan_train_backward
    monkeypatch.setattr(ck, "gru_scan_train_backward",
                        lambda *a: seen.append(a[5]) or real(*a))
    x = torch.tensor(np.random.default_rng(0).standard_normal((2, 5, 6)), dtype=torch.float32)
    if fused:
        y = TM.gru_apply_fused(params, x, None, torch.stack([marks["fw"], marks["bw"]]))
    else:
        y = TM.gru_apply(params, x, None, marks)
    grads = torch.autograd.grad(y.square().sum(), [p for pd in params.values()
                                                   for p in pd.values()])
    if fused:
        assert len(seen) == 1 and torch.equal(seen[0][:, 0, 0, 0], torch.tensor([0.0, 1.0]))
    else:
        assert sorted(t.flatten()[0].item() for t in seen) == [0.0, 1.0]
    with torch.no_grad():
        plain = [{k: v.detach().requires_grad_() for k, v in pd.items()}
                 for pd in params.values()]
    ref_y = TM.gru_apply(dict(zip(("fw", "bw"), plain)), x)
    ref = torch.autograd.grad(ref_y.square().sum(), [p for pd in plain for p in pd.values()])
    torch.testing.assert_close(y, ref_y, rtol=0, atol=1e-6)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)


def sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def emulate_gru_scan(gx, cx, packed, plan):
    """csrc/gru_scan.cu's split of the work, step by step, in numpy float32."""
    T, B, _ = gx.shape
    H, C, Hc, R = plan.H, plan.cluster, plan.units, plan.rows
    units = cta_units(H, C)
    ys = np.zeros((T, B, H), np.float32)

    def team_sums(vT, w):                 # vT [R, H], w [n, H] -> [R, n]
        L = ck.TEAM_LANES                 # lane l: k = l, l + L, ...
        return sum(vT[:, lane::L] @ w[:, lane::L].T for lane in range(L))

    for g in range(plan.clusters):
        rows = list(range(g * R, min(B, (g + 1) * R)))
        n = len(rows)
        h = np.zeros((R, H), np.float32)          # every CTA's copy is the same
        for t in range(T):
            rh, u = np.zeros((R, H), np.float32), {}
            for c, us in enumerate(units):        # (a) in each CTA, then r*h exchanged
                ga = team_sums(h, packed[c, :2 * Hc])
                gxr = np.zeros((R, len(us)), np.float32)
                gxu = np.zeros_like(gxr)
                gxr[:n] = gx[t, rows][:, list(us)]
                gxu[:n] = gx[t, rows][:, [H + j for j in us]]
                r = sigmoid(gxr + ga[:, :len(us)])
                u[c] = sigmoid(gxu + ga[:, Hc:Hc + len(us)])
                rh[:, list(us)] = r * h[:, list(us)]
            h_new = np.zeros_like(h)
            for c, us in enumerate(units):        # (c) in each CTA, then h exchanged
                cc = np.zeros((R, len(us)), np.float32)
                cc[:n] = cx[t, rows][:, list(us)]
                cand = np.tanh(cc + team_sums(rh, packed[c, 2 * Hc:])[:, :len(us)])
                h_new[:, list(us)] = u[c] * h[:, list(us)] + (1.0 - u[c]) * cand
            h = h_new
            ys[t, rows] = h[:n]
    return ys


def with_rows(plan, R):
    """The plan with R rows per cluster, as the kernel's R instantiations take
    it (float32 operands)."""
    return dataclasses.replace(plan, rows=R, clusters=-(-plan.B // R),
                               smem_bytes=ck.gru_scan_smem_bytes(plan.H, plan.cluster, R,
                                                                 backward=plan.backward,
                                                                 gates=plan.gates))


@pytest.mark.parametrize("T,B,H,C,R", [
    (16, 13, 40, None, None),  # C = 1, one row per cluster
    (12, 5, 40, 16, 2),        # ragged units: 13 CTAs of 3, one of 1, two empty
    (10, 13, 8, 4, 8),         # ragged rows: B = 13 in tiles of 8
    (6, 3, 1, 2, None),        # H = 1: one unit, one empty CTA
    (8, 7, 129, None, None),   # C = 8, seven CTAs of 17 units and one of 10
    (6, 59, 256, None, None),  # the decoder's width: C = 8, the plan's 4 rows per cluster
    (6, 31, 256, None, 2),     # and 2 rows, the last cluster ragged
    (5, 59, 256, None, 4),     # and 4 rows, the last cluster ragged
])
def test_emulated_split_matches_pallas(T, B, H, C, R):
    rng = np.random.default_rng(T * 1000 + H)
    lim = np.sqrt(6.0 / (3 * H))
    gx = rng.standard_normal((T, B, 2 * H)).astype(np.float32)
    cx = rng.standard_normal((T, B, H)).astype(np.float32)
    Wg = (lim * rng.standard_normal((H, 2 * H))).astype(np.float32)
    Wc = (lim * rng.standard_normal((H, H))).astype(np.float32)
    packed = ck.pack_gru_weights(torch.tensor(Wg), torch.tensor(Wc), cluster=C).numpy()
    plan = ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN, cluster=packed.shape[0])
    if R is not None:
        plan = with_rows(plan, R)
    got = emulate_gru_scan(gx, cx, packed, plan)
    ref = np.asarray(gru_scan_pallas(*map(jnp.asarray, (gx, cx, Wg, Wc)), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def lane_sets(n, A):
    """The accumulator set of each of a lane's n products: i % A in the
    register kernel (A sets); the shared-memory kernel's two sets take
    i % 2 over whole blocks of 4 and set 0 for the rest (A = 0 here)."""
    i = np.arange(n)
    return i % A if A else np.where(i < n // 4 * 4, i % 2, 0)


def team_product(v, w, A):
    """The team's sums of v [R, K] against weight rows w [n, K]: lane l sums
    k = l, l + 8, ... in its accumulator sets, the sets added in order, then
    the three-level butterfly of the shuffle reduction -> [R, n]."""
    L = ck.TEAM_LANES
    lanes = []
    for lane in range(L):
        ks = np.arange(lane, v.shape[1], L)
        sets = lane_sets(len(ks), A)
        part = [v[:, ks[sets == q]] @ w[:, ks[sets == q]].T for q in range(A or 2)]
        total = part[0]
        for x in part[1:]:
            total = total + x
        lanes.append(total)
    for m in (4, 2, 1):
        lanes = [lanes[lane] + lanes[lane ^ m] for lane in range(L)]
    return lanes[0]


def reg_sets(plan, nk):
    """The register forward's accumulator sets (csrc/gru_scan.cu reg_sums,
    smem_sums) of the gate sums and the candidate's: two at every R in the
    inference forward (a row's output then does not depend on R); in the
    training forward two where N rows times R are under 4, one for the (4,
    16) instance's candidate rows in shared memory."""
    R = plan.rows
    if not plan.gates:
        return 2, 2
    cand_in_smem = ck._reg_instance(False, R, nk, True, plan.stage_steps > 0)[2]
    return (2 if 2 * R < 4 else 1), (1 if cand_in_smem else 2 if R < 4 else 1)


def emulate_gru_scan_reg(gx, cx, packed, plan):
    """csrc/gru_scan.cu's register forward with float32 operands
    (gru_scan_reg_kernel: the training forward with ``plan.gates``, else
    the inference forward), step by step in numpy float32:
    D stacked directions [D, T, B, .] in their own clusters, direction 1
    running time backwards; in each CTA each lane's register columns k =
    lane + 8 i (i < NK) of its units' rows over the Hp = 8 NK rows of the
    exchanged vectors (pad rows and weights past H zero), in A accumulator
    sets (the inference forward two at every R; the training forward two
    where the product's N rows times R are under 4: the gate sums at R = 1,
    the candidate's at R < 4, and one for the (R, NK) = (4, 16) instance's
    candidate rows in shared memory), the team's reduction, r*h then h exchanged; ys and the gates r, u, c [D, T, B, 3H]
    out. A plan without a column class (a spilling row count, H > 256) runs
    the shared-memory kernel's split (its two sets over blocks of 4)."""
    D, T, B, _ = gx.shape
    H, C, Hc, R = plan.H, plan.cluster, plan.units, plan.rows
    nk = ck.gru_reg_columns(H, R, plan.threads, gates=plan.gates)
    hp = ck.TEAM_LANES * nk if nk else H
    sets_g, sets_c = reg_sets(plan, nk) if nk else (0, 0)
    units = cta_units(H, C)
    w = np.zeros((D, C, 3 * Hc, hp), np.float32)
    w[..., :H] = packed
    ys = np.zeros((D, T, B, H), np.float32)
    gates = np.zeros((D, T, B, 3 * H), np.float32)
    for d in range(D):
        order = range(T) if d == 0 else range(T - 1, -1, -1)
        for g in range(plan.clusters):
            rows = list(range(g * R, min(B, (g + 1) * R)))
            n = len(rows)
            h = np.zeros((R, hp), np.float32)         # every CTA's copy, pad rows zero
            for t in order:
                rh, keep = np.zeros((R, hp), np.float32), {}
                for c, us in enumerate(units):        # (a), then r*h exchanged
                    k, cols = len(us), list(us)
                    ga = team_product(h, w[d, c, :2 * Hc], sets_g)
                    gxr, gxu = np.zeros((R, k), np.float32), np.zeros((R, k), np.float32)
                    gxr[:n] = gx[d, t, rows][:, cols]
                    gxu[:n] = gx[d, t, rows][:, [H + j for j in us]]
                    r = sigmoid(gxr + ga[:, :k])
                    u = sigmoid(gxu + ga[:, Hc:Hc + k])
                    rh[:, cols] = r * h[:, cols]
                    keep[c] = (r, u)
                h_new = np.zeros_like(h)
                for c, us in enumerate(units):        # (c), then h exchanged
                    k, cols = len(us), list(us)
                    (r, u) = keep[c]
                    cc = np.zeros((R, k), np.float32)
                    cc[:n] = cx[d, t, rows][:, cols]
                    cand = np.tanh(cc + team_product(rh, w[d, c, 2 * Hc:2 * Hc + k],
                                                     sets_c)).astype(np.float32)
                    h_new[:, cols] = u * h[:, cols] + (1.0 - u) * cand
                    for a, part in enumerate((r, u, cand)):
                        gates[d, t, rows, a * H + us.start:a * H + us.stop] = part[:n]
                h = h_new
                ys[d, t, rows] = h[:n, :H]
    return ys, gates


@pytest.mark.parametrize("T,B,H,C,R", [
    (16, 13, 40, None, None),  # C = 1, one row per cluster: two sets in every product
    (12, 5, 40, 16, 2),        # ragged units: 13 CTAs of 3, one of 1, two empty
    (10, 13, 8, 4, 8),         # ragged rows: B = 13 in tiles of 8
    (6, 3, 1, 2, None),        # H = 1: one unit, one empty CTA
    (8, 7, 129, None, None),   # C = 8, seven CTAs of 17 units and one of 10, 32 columns
    (6, 59, 256, None, None),  # the decoder's width: C = 8, 2 rows per cluster
    (5, 59, 256, None, 4),     # and 4 rows: no register instance, the shared-memory split
])
def test_emulated_register_training_forward_matches_pallas(T, B, H, C, R):
    """The float32 training forward's split, both directions: ys against the
    Pallas kernel in interpret mode (direction 1 on the time-reversed
    inputs), the gates against `gru_scan_fused_plain(with_gates=True)`,
    atol 1e-5."""
    rng = np.random.default_rng(T * 1000 + H + 7)
    lim = np.sqrt(6.0 / (3 * H))
    gx = rng.standard_normal((2, T, B, 2 * H)).astype(np.float32)
    cx = rng.standard_normal((2, T, B, H)).astype(np.float32)
    Wg = (lim * rng.standard_normal((2, H, 2 * H))).astype(np.float32)
    Wc = (lim * rng.standard_normal((2, H, H))).astype(np.float32)
    packed = np.stack([ck.pack_gru_weights(torch.tensor(a), torch.tensor(b), cluster=C).numpy()
                       for a, b in zip(Wg, Wc)])
    plan = ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN, cluster=packed.shape[1], dirs=2,
                            gates=True)
    if R is not None:
        plan = with_rows(plan, R)
    assert (ck.gru_reg_columns(H, plan.rows, plan.threads, gates=True) == 0) == (R == 4)
    ys, gates = emulate_gru_scan_reg(gx, cx, packed, plan)
    for d, flip in ((0, slice(None)), (1, slice(None, None, -1))):
        ref = np.asarray(gru_scan_pallas(*map(jnp.asarray, (gx[d][flip], cx[d][flip], Wg[d], Wc[d])),
                                         interpret=True))[flip]
        np.testing.assert_allclose(ys[d], ref, rtol=0, atol=ATOL)
    _, ref_gates = ck.gru_scan_fused_plain(*map(torch.tensor, (gx, cx, Wg, Wc)), with_gates=True)
    np.testing.assert_allclose(gates, ref_gates.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("T,B,H,C,R", [
    (37, 1, 40, None, None),   # a stream or sequence-parallel scan: B = 1, C = 1, odd T
    (21, 1, 128, None, None),  # C = 4, 16 columns
    (13, 1, 256, None, None),  # C = 8, 32 columns
    (11, 13, 128, None, 4),    # (4, 16): the candidate rows in shared memory, ragged tile
    (9, 59, 256, None, None),  # the convert's B = 59: 4 rows per cluster, one set a product
    (7, 5, 40, 16, 2),         # ragged units: 13 CTAs of 3, one of 1, two empty
])
def test_emulated_register_inference_forward_matches_pallas(T, B, H, C, R):
    """The float32 inference forward of one direction on the register
    kernel (each lane's register columns, its accumulator sets, r*h and h
    exchanged): ys against the Pallas kernel in interpret mode, atol
    1e-5."""
    rng = np.random.default_rng(T * 1000 + H + B)
    lim = np.sqrt(6.0 / (3 * H))
    gx = rng.standard_normal((1, T, B, 2 * H)).astype(np.float32)
    cx = rng.standard_normal((1, T, B, H)).astype(np.float32)
    Wg = (lim * rng.standard_normal((H, 2 * H))).astype(np.float32)
    Wc = (lim * rng.standard_normal((H, H))).astype(np.float32)
    packed = ck.pack_gru_weights(torch.tensor(Wg), torch.tensor(Wc), cluster=C).numpy()
    plan = ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN, cluster=packed.shape[0])
    if R is not None:
        plan = with_rows(plan, R)
    assert plan.reg_columns == ck.gru_reg_columns(H, plan.rows, plan.threads) > 0
    assert not plan.gates and plan.dirs == 1 and plan.stage_steps == 0
    ys, _ = emulate_gru_scan_reg(gx, cx, packed[None], plan)
    ref = np.asarray(gru_scan_pallas(*map(jnp.asarray, (gx[0], cx[0], Wg, Wc)), interpret=True))
    np.testing.assert_allclose(ys[0], ref, rtol=0, atol=ATOL)


def emulate_gru_scan_bwd(dys, ys, gates, packed, plan):
    """csrc/gru_scan.cu's backward, step by step in reverse, in numpy
    float32: each CTA's weight rows (`pack_gru_weights_bwd`: rows of Wg_h's
    r half, its u half, Wc_h), each lane's NK register columns k = lane +
    8 i (zero past H, and the exchanged vectors' pad rows zero), the
    [dcx, dgu] exchange, the pass of Wc_h and Wg_h's u half over it with
    only d(rh) reduced, the dgr exchange, then Wg_h's r half added to the u
    half's lane shares before the carry's reduction."""
    T, B, H = ys.shape
    C, Hc, R, L = plan.cluster, plan.units, plan.rows, ck.TEAM_LANES
    nk = ck.gru_reg_columns(H, R, plan.threads, backward=True)
    hp = L * nk if nk else H
    units = cta_units(H, C)
    w = np.zeros((C, 3 * Hc, hp), np.float32)
    w[:, :, :H] = packed

    def lane_shares(v, rows):             # v [R, hp], rows [n, hp] -> [L, R, n]
        return np.stack([v[:, lane::L] @ rows[:, lane::L].T for lane in range(L)])

    dgx = np.zeros((T, B, 2 * H), np.float32)
    dcx = np.zeros((T, B, H), np.float32)
    for g in range(plan.clusters):
        rows = list(range(g * R, min(B, (g + 1) * R)))
        n = len(rows)

        def tile(a):                      # [T, B, k] -> [T, R, k], rows past B zero
            out = np.zeros((T, R) + a.shape[2:], np.float32)
            out[:, :n] = a[:, rows]
            return out

        dy, y, gt = tile(dys), tile(ys), tile(gates)
        carry = np.zeros((R, H), np.float32)
        for s in reversed(range(T)):
            hprev = y[s - 1] if s > 0 else np.zeros((R, H), np.float32)
            r, u, c = gt[s, :, :H], gt[s, :, H:2 * H], gt[s, :, 2 * H:]
            dh = dy[s] + carry
            a_dcx = np.zeros((R, hp), np.float32)       # the first exchange
            a_dgu = np.zeros((R, hp), np.float32)
            a_dcx[:, :H] = dh * (1.0 - u) * (1.0 - c * c)
            a_dgu[:, :H] = dh * (hprev - c) * u * (1.0 - u)
            drh, su = np.zeros((R, H), np.float32), {}
            for cta, us in enumerate(units):            # one pass over both halves
                k = len(us)
                wc = w[cta, 2 * Hc:2 * Hc + k]
                wu = w[cta, Hc:Hc + k]
                drh[:, list(us)] = lane_shares(a_dcx, wc).sum(0)
                su[cta] = lane_shares(a_dgu, wu)        # kept per lane
            g_dgr = np.zeros((R, hp), np.float32)       # the second exchange
            g_dgr[:, :H] = drh * hprev * r * (1.0 - r)
            new = np.zeros_like(carry)
            for cta, us in enumerate(units):
                k = len(us)
                sr = lane_shares(g_dgr, w[cta, :k])
                new[:, list(us)] = (sr + su[cta]).sum(0)
            carry = dh * u + drh * r + new
            dcx[s, rows] = a_dcx[:n, :H]
            dgx[s, rows] = np.concatenate([g_dgr[:n, :H], a_dgu[:n, :H]], axis=1)
    return dgx, dcx


@pytest.mark.parametrize("T,B,H,C,R", [
    (12, 5, 40, None, None),   # C = 1: one CTA, 5 register columns
    (10, 13, 40, 16, 2),       # ragged units: 13 CTAs of 3, one of 1, two empty
    (8, 7, 129, None, None),   # C = 8, 32 columns, the last CTA ragged
    (6, 11, 256, None, 4),     # the decoder's width, the last cluster ragged
    (5, 9, 200, None, 2),      # 32 columns and R = 2: the shared-memory instance
    (4, 3, 300, None, None),   # past 256: the weights in shared memory
])
def test_emulated_backward_matches_jax_vjp(T, B, H, C, R):
    rng = np.random.default_rng(T * 1000 + H)
    lim = np.sqrt(6.0 / (3 * H))
    gx = rng.standard_normal((T, B, 2 * H)).astype(np.float32)
    cx = rng.standard_normal((T, B, H)).astype(np.float32)
    Wg = (lim * rng.standard_normal((H, 2 * H))).astype(np.float32)
    Wc = (lim * rng.standard_normal((H, H))).astype(np.float32)
    dys = rng.standard_normal((T, B, H)).astype(np.float32)

    # jax.vjp of the package's lax.scan GRU, its input projections copying
    # x = [gx, cx], so dx is (dgx, dcx)
    eye = np.eye(3 * H, dtype=np.float32)
    params = {"gates_kernel": np.concatenate([eye[:, :2 * H], Wg]),
              "gates_bias": np.zeros(2 * H, np.float32),
              "candidate_kernel": np.concatenate([eye[:, 2 * H:], Wc]),
              "candidate_bias": np.zeros(H, np.float32)}
    x = np.concatenate([gx, cx], axis=2).transpose(1, 0, 2)
    y, vjp = jax.vjp(lambda xx: JM._gru_dir_apply(params, xx), jnp.asarray(x))
    dx = np.asarray(vjp(jnp.asarray(dys.transpose(1, 0, 2)))[0]).transpose(1, 0, 2)

    ys, gates = (t[0].numpy() for t in ck.gru_scan_fused_plain(
        *(torch.tensor(a)[None] for a in (gx, cx, Wg, Wc)), with_gates=True))
    np.testing.assert_allclose(ys, np.asarray(y).transpose(1, 0, 2), rtol=0, atol=ATOL)
    packed = ck.pack_gru_weights_bwd(torch.tensor(Wg), torch.tensor(Wc), cluster=C).numpy()
    plan = ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN, cluster=packed.shape[0], backward=True)
    if R is not None:
        plan = with_rows(plan, R)
    dgx, dcx = emulate_gru_scan_bwd(dys, ys, gates, packed, plan)
    for got, ref in ((dgx, dx[..., :2 * H]), (dcx, dx[..., 2 * H:])):
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL * max(np.abs(ref).max(), 1.0))


# ---------------------------------------------------- the staged instances ---

def hand_stage_bytes(S, R, Hc, backward):
    """One slot of the ring counted by hand: the forward's gx r, gx u, cx,
    ys (bf16) and r, u, c (f32) boxes, the backward's dy, h[t-1] (bf16), r,
    u, c (f32), dcx, dgr, dgu (bf16); each [S][R][Hc], on 128 bytes."""
    sizes = [2, 2, 4, 4, 4, 2, 2, 2] if backward else [2, 2, 2, 2, 4, 4, 4]
    return sum(-(-S * R * Hc * b // 128) * 128 for b in sizes)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dirs", [1, 2])
def test_staged_plans_at_train_shapes(backward, dirs):
    """The staged bf16 training instances at a train step's shapes (B = 32,
    H = 40 / 128 / 256): 32 steps a stage, the ring's bytes as counted by
    hand beside the unstaged layout (6 mbarriers, the ring on 128 bytes),
    within the opt-in limit, and the CTAs per SM of the unstaged instance
    kept (two at 16 columns)."""
    kw = dict(elem_bytes=2, dirs=dirs, backward=backward, gates=not backward)
    for H in (40, 128, 256):
        plan = ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, **kw)
        unstaged = ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, stage_steps=0, **kw)
        C, R, Hc = plan.cluster, plan.rows, plan.units
        assert plan.stage_steps == 32 and unstaged.stage_steps == 0
        assert plan.stage_bytes == 2 * hand_stage_bytes(32, R, Hc, backward)
        nk = plan.reg_columns
        hp, r4 = ck.TEAM_LANES * nk, lambda n: -(-n // 4) * 4
        vectors = 2 * r4(hp * 2 * R) + 2 * r4(hp * R) if backward else 4 * r4(hp * R)
        head = 64 + 4 * vectors   # 6 mbarriers on 64 bytes, the f32 vectors, no weights
        assert plan.smem_bytes == -(-head // 128) * 128 + plan.stage_bytes
        assert plan.smem_bytes <= SMEM_OPTIN
        per_sm = ck._ctas_by_registers(plan.threads, nk, backward, R)
        assert per_sm * (plan.smem_bytes + ck.CTA_RESERVED_SMEM) <= SMEM_OPTIN + 1024
        assert (per_sm == 2) == (nk == 16)
        # the rows are the unstaged instance's, except where the staged table
        # is wider (the forward's (4, 32), the backward's (2, 32))
        wider = (H, dirs, backward) in ((256, 1, False), (256, 2, True))
        assert (R != unstaged.rows) == wider
    # a forward step of H = 256 at R = 2 is 1280 bytes a CTA, a backward one at R = 1 704
    assert hand_stage_bytes(1, 2, 32, False) == 20 * 2 * 32
    assert ck.gru_stage_slot_bytes(32, 1, 32, True) == 32 * 22 * 32


# (C, R, clusters, threads, shared memory, stage depth) of the other plans
# at B = 32, by operand bytes: the inference forward of one direction (the
# register forward in either type, its rows the same, bf16 staged), the
# training forward and the backward of one and both directions
KEPT_PLANS_B32 = {
    ("forward", 4, 1): [(1, 1, 32, 320, 672, 0), (4, 1, 32, 256, 2080, 0),
                        (8, 4, 8, 256, 50208, 0)],
    ("forward", 2, 1): [(1, 1, 32, 320, 21248, 32), (4, 1, 32, 256, 18560, 32),
                        (8, 4, 8, 256, 82048, 32)],
    ("training", 4, 1): [(1, 1, 32, 320, 672, 0), (4, 1, 32, 256, 2080, 0),
                         (8, 2, 16, 256, 8224, 0)],
    ("training", 4, 2): [(1, 1, 32, 320, 672, 0), (4, 1, 32, 256, 2080, 0),
                         (8, 2, 16, 256, 8224, 0)],
    ("training", 2, 1): [(1, 1, 32, 320, 51968, 32), (4, 1, 32, 256, 43136, 32),
                         (8, 4, 8, 256, 180352, 32)],
    ("training", 2, 2): [(1, 1, 32, 320, 51968, 32), (4, 1, 32, 256, 43136, 32),
                         (8, 2, 16, 256, 90240, 32)],
    ("backward", 4, 1): [(1, 1, 32, 320, 992, 0), (4, 1, 32, 256, 3104, 0),
                         (8, 1, 32, 256, 6176, 0)],
    ("backward", 4, 2): [(1, 1, 32, 320, 992, 0), (4, 1, 32, 256, 3104, 0),
                         (8, 1, 32, 256, 6176, 0)],
    ("backward", 2, 1): [(1, 1, 32, 320, 57344, 32), (4, 1, 32, 256, 48256, 32),
                         (8, 1, 32, 256, 51328, 32)],
    ("backward", 2, 2): [(1, 1, 32, 320, 57344, 32), (4, 1, 32, 256, 48256, 32),
                         (8, 2, 16, 256, 102528, 32)],
}


@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_fused_inference_plans(elem_bytes):
    """The inference forward of both directions at a train step's shapes (B
    = 32, H = 40 / 128 / 256), float32 or bf16: the register forward with 5
    / 16 / 32 columns, the stage depth the plan chose (32 in bf16; float32
    is not staged, and a depth given for it raises), its shared memory
    counted by hand (6 mbarriers and the vectors on 128 bytes, then two
    slots of 4 bf16 boxes gx r, gx u, cx, ys, each [S][R][Hc] on 128
    bytes); unstaged, the register layout (4 mbarriers, the vectors). Every
    other plan at B = 32 is pinned (KEPT_PLANS_B32), each with its register
    columns."""
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    for H, nk in ((40, 5), (128, 16), (256, 32)):
        plan = ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, elem_bytes=elem_bytes, dirs=2)
        unstaged = ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, elem_bytes=elem_bytes, dirs=2,
                                    stage_steps=0)
        C, R, Hc, S = plan.cluster, plan.rows, plan.units, plan.stage_steps
        assert (C, plan.reg_columns, unstaged.reg_columns) == (ck.gru_cluster_size(H), nk, nk)
        assert S == (32 if elem_bytes == 2 else 0)
        if elem_bytes == 4:
            with pytest.raises(ValueError, match="stage_steps=32"):
                ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, elem_bytes=4, dirs=2, stage_steps=32)
        assert (R, unstaged.rows, unstaged.stage_steps) == ({256: 2}.get(H, 1), R, 0)
        vectors = 4 * r4(ck.TEAM_LANES * nk * R)       # h, r*h: two buffers each, f32
        assert unstaged.smem_bytes == 4 * (8 + vectors)
        box = -(-S * R * Hc * 2 // 128) * 128
        assert plan.stage_bytes == (2 * 4 * box if S else 0)
        assert plan.smem_bytes == (-(-4 * (16 + vectors) // 128) * 128 + 2 * 4 * box if S
                                   else unstaged.smem_bytes)
        assert plan.smem_bytes <= SMEM_OPTIN
    for (form, e, dirs), want in KEPT_PLANS_B32.items():
        got = [ck.gru_scan_plan(H, 32, N_SMS, SMEM_OPTIN, elem_bytes=e, dirs=dirs,
                                backward=form == "backward", gates=form == "training")
               for H in (40, 128, 256)]
        assert [(p.cluster, p.rows, p.clusters, p.threads, p.smem_bytes, p.stage_steps)
                for p in got] == want, (form, e, dirs)
        assert [p.reg_columns for p in got] == [5, 16, 32]


# (C, R, clusters) of the one-direction inference forward's plan by (B, H),
# either operand type: the stream's B = 1, 4, 16 and the sequence-parallel
# shards' B = 1; the kernel rows' 9, 59, 236 (the convert's 59, a batch of
# four clips' 236); a train step's 32. Where the shared-memory kernel's rule
# took other rows (H = 256 at B = 16, 32, 59, 236, H = 128 at B = 59 and 236,
# H = 40 at 236) these are the register instance's least waves x ROW_COST
ONE_DIRECTION_PLANS = {
    1: [(1, 1, 1), (4, 1, 1), (8, 1, 1)],
    4: [(1, 1, 4), (4, 1, 4), (8, 1, 4)],
    9: [(1, 1, 9), (4, 1, 9), (8, 1, 9)],
    16: [(1, 1, 16), (4, 1, 16), (8, 2, 8)],
    32: [(1, 1, 32), (4, 1, 32), (8, 4, 8)],
    59: [(1, 1, 59), (4, 1, 59), (8, 4, 15)],
    236: [(1, 2, 118), (4, 4, 59), (8, 4, 59)],
}


@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("B", list(ONE_DIRECTION_PLANS))
def test_one_direction_inference_plans(B, elem_bytes):
    """The inference forward of one direction, the Pallas kernel's own
    form, at the batch sizes the main paths launch it at (H = 40 / 128 /
    256): the register forward in either operand type, 5 / 16 / 32
    columns, the rows pinned (ONE_DIRECTION_PLANS: one row at B = 1 at every
    width); bf16 staged (32 steps a stage at every one of these shapes,
    its shared memory the ring beside the register layout, the CTAs per SM
    kept), float32 not (a depth given for it raises)."""
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    for (H, nk), want in zip(((40, 5), (128, 16), (256, 32)), ONE_DIRECTION_PLANS[B]):
        plan = ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN, elem_bytes=elem_bytes)
        unstaged = ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN, elem_bytes=elem_bytes,
                                    stage_steps=0)
        assert (plan.cluster, plan.rows, plan.clusters) == want, (H, B)
        assert (plan.dirs, plan.gates, plan.backward) == (1, False, False)
        assert plan.reg_columns == unstaged.reg_columns == nk
        assert (unstaged.cluster, unstaged.rows, unstaged.stage_steps) == (*want[:2], 0)
        vectors = 4 * r4(ck.TEAM_LANES * nk * plan.rows)
        cand = [r4(plan.units * ck.gru_weight_stride(H))     # unstaged, staged
                if ck._reg_instance(False, plan.rows, nk, staged=st)[2] else 0
                for st in (False, True)]
        assert unstaged.smem_bytes == 4 * (8 + vectors + cand[0])
        if elem_bytes == 4:
            assert plan == unstaged
            with pytest.raises(ValueError, match="stage_steps=32"):
                ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN, stage_steps=32)
            continue
        S, Hc, R = plan.stage_steps, plan.units, plan.rows
        assert S == 32 == ck.gru_stage_steps(H, plan.cluster, R, SMEM_OPTIN)
        box = -(-S * R * Hc * 2 // 128) * 128          # gx r, gx u, cx, ys: bf16
        assert plan.stage_bytes == 2 * 4 * box
        assert plan.smem_bytes == -(-4 * (16 + vectors + cand[1]) // 128) * 128 + 2 * 4 * box
        per_sm = ck._ctas_by_registers(plan.threads, nk, False, R)
        assert per_sm * (plan.smem_bytes + ck.CTA_RESERVED_SMEM) <= SMEM_OPTIN + 1024


def test_stage_depth_and_what_stages():
    """What is staged: bf16 operands (the inference forward, the training
    forward or the backward), H a multiple of 8 C, a register column class;
    the depth the largest of STAGE_STEPS that keeps the CTAs per SM (16 at
    B = 236, H = 128, R = 4, two CTAs an SM, for the training forward); a
    forced depth the shape cannot take raises."""
    assert ck.gru_stageable(40, 1) and ck.gru_stageable(128, 4) and ck.gru_stageable(256, 8)
    assert not ck.gru_stageable(40, 2) and not ck.gru_stageable(129, 8)
    assert not ck.gru_stageable(12, 1)
    for H, C, staged in ((40, 1, True), (40, 2, False), (12, 1, False), (300, None, False),
                         (512, None, False)):
        for bwd, gates in ((False, True), (True, False), (False, False)):
            p = ck.gru_scan_plan(H, 9, N_SMS, SMEM_OPTIN, cluster=C, elem_bytes=2,
                                 backward=bwd, gates=gates)
            assert (p.stage_steps > 0) == staged, (H, C, bwd, gates)
    # nothing else stages: the float32 kernels; every bf16 form does
    for kw in ({}, {"gates": True}, {"backward": True}, {"dirs": 2}):
        assert ck.gru_scan_plan(128, 32, N_SMS, SMEM_OPTIN, **kw).stage_steps == 0
        assert ck.gru_scan_plan(128, 32, N_SMS, SMEM_OPTIN, elem_bytes=2,
                                **kw).stage_steps == 32
    p = ck.gru_scan_plan(128, 236, N_SMS, SMEM_OPTIN, elem_bytes=2, gates=True)
    assert (p.rows, p.stage_steps) == (4, 16)
    assert 2 * (p.smem_bytes + 1024) <= SMEM_OPTIN + 1024
    assert 2 * (ck.gru_scan_smem_bytes(128, 4, 4, 2, gates=True, stage_steps=32) + 1024) > (
        SMEM_OPTIN + 1024)
    forced = ck.gru_scan_plan(40, 9, N_SMS, SMEM_OPTIN, elem_bytes=2, gates=True, stage_steps=8)
    assert forced.stage_steps == 8
    assert forced.smem_bytes == ck.gru_scan_smem_bytes(40, 1, 1, 2, gates=True, stage_steps=8)
    for bad in ({"stage_steps": 12}, {"stage_steps": 8, "cluster": 2},
                {"stage_steps": 8, "elem_bytes": 4}):
        kw = {"elem_bytes": 2, "gates": True, **bad}
        with pytest.raises(ValueError, match="stage_steps"):
            ck.gru_scan_plan(40, 9, N_SMS, SMEM_OPTIN, **kw)


def test_staged_tables_widen_only_the_staged_instances():
    """The staged instances hold the forward's (4, 32) and the backward's
    (2, 32) in registers (they compile without a spill); the unstaged ones
    keep their tables."""
    for R in (1, 2, 4, 8):
        for nk in (5, 8, 16, 32):
            for bwd in (False, True):
                plain = ck._reg_instance(bwd, R, nk, gates=not bwd)[0]
                staged = ck._reg_instance(bwd, R, nk, gates=not bwd, staged=True)[0]
                assert staged == (plain or (nk, R) == ((32, 2) if bwd else (32, 4))), (R, nk, bwd)
    assert ck.gru_reg_columns(256, 2, 256, backward=True) == 0
    assert ck.gru_reg_columns(256, 2, 256, backward=True, staged=True) == 32


def box_load(a, d, t0, row0, c0, S, R, Hc):
    """A tensor map's box of a [D, T, B, W] array: [S, R, Hc] at (unit c0,
    row row0, time t0, direction d), zero where it leaves the array."""
    _, T, B, W = a.shape
    out = np.zeros((S, R, Hc), np.float32)
    t_lo, t_hi, r_hi, w_hi = max(t0, 0), min(t0 + S, T), min(row0 + R, B), min(c0 + Hc, W)
    if t_lo < t_hi and row0 < r_hi and c0 < w_hi:
        out[t_lo - t0:t_hi - t0, :r_hi - row0, :w_hi - c0] = a[d, t_lo:t_hi, row0:r_hi, c0:w_hi]
    return out


def box_store(a, box, d, t0, row0, c0):
    """A box out to a tensor map: what leaves the array is dropped. No store
    box starts before time 0 (the card faulted on one)."""
    assert t0 >= 0
    _, T, B, W = a.shape
    S, R, Hc = box.shape
    t_hi, r_hi, w_hi = min(t0 + S, T), min(row0 + R, B), min(c0 + Hc, W)
    if t0 < t_hi and row0 < r_hi and c0 < w_hi:
        a[d, t0:t_hi, row0:r_hi, c0:w_hi] = box[:t_hi - t0, :r_hi - row0, :w_hi - c0]


class Ring:
    """One CTA's ring of two stage slots, as csrc/gru_scan.cu walks it: a
    stage is a block of S times starting at a multiple of S, walked up or
    (``down``) from the ragged top block; thread 0 loads stages 0 and 1
    before the first step and, at each later stage's first step, stores the
    stage before it and loads the one after it into the same slot; the last
    stage is stored after the loop. Inputs come in as `box_load`s, outputs
    start as NaN so a box stored before a step wrote it shows."""

    def __init__(self, T, S, down, loads, outputs, R, Hc):
        self.T, self.S, self.down, self.n = T, S, down, -(-T // S)
        self.loads, self.outputs, self.shape = loads, outputs, (S, R, Hc)
        self.slots = [{}, {}]
        self.load(0)
        if self.n > 1:
            self.load(1)

    def t0(self, k):
        return (self.n - 1 - k if self.down else k) * self.S

    def load(self, k):
        slot = self.slots[k % 2]
        slot.update({name: fn(self.t0(k)) for name, fn in self.loads.items()})
        for name in self.outputs:
            slot.setdefault(name, np.full(self.shape, np.nan, np.float32))

    def store(self, k):
        for name, fn in self.outputs.items():
            fn(self.slots[k % 2][name], self.t0(k))

    def walk(self):
        """(stage k, the step's slot, its time's index l in the block, the
        stage's first step) for each step of the walk; runs thread 0's
        copies at their points."""
        for k in range(self.n):
            t0 = self.t0(k)
            length = min(self.T - t0, self.S)
            for i in range(length):
                if i == 0 and k > 0:
                    self.store(k - 1)
                    if k + 1 < self.n:
                        self.load(k + 1)
                yield k, self.slots[k % 2], length - 1 - i if self.down else i
        self.store(self.n - 1)


def emulate_staged_forward(gx, cx, packed, plan):
    """The staged register forward (gru_scan_reg_staged_kernel) in numpy
    float32: each CTA's ring of stages over gx's two halves and cx in, ys
    and (the bf16 training form, ``plan.gates``) the gates out, the register
    forward's sums (team_product, its accumulator sets), r*h and h
    exchanged. Returns (ys, the gates or None)."""
    D, T, B, _ = gx.shape
    H, C, Hc, R, S = plan.H, plan.cluster, plan.units, plan.rows, plan.stage_steps
    nk = plan.reg_columns
    hp = ck.TEAM_LANES * nk
    sets_g, sets_c = reg_sets(plan, nk)
    w = np.zeros((D, C, 3 * Hc, hp), np.float32)
    w[..., :H] = packed
    ys = np.full((D, T, B, H), np.nan, np.float32)       # NaN where no box stored
    gates = np.full((D, T, B, 3 * H), np.nan, np.float32)
    for d in range(D):
        for g in range(plan.clusters):
            row0 = g * R

            def ring(c):
                j0 = c * Hc
                box = lambda a, c0: lambda t0: box_load(a, d, t0, row0, c0, S, R, Hc)  # noqa: E731
                put = lambda a, c0: lambda b, t0: box_store(a, b, d, t0, row0, c0)  # noqa: E731
                outputs = {"ys": put(ys, j0)}
                if plan.gates:
                    outputs.update(r=put(gates, j0), u=put(gates, H + j0),
                                   c=put(gates, 2 * H + j0))
                return Ring(T, S, d == 1, {"gr": box(gx, j0), "gu": box(gx, H + j0),
                                           "cx": box(cx, j0)}, outputs, R, Hc)

            walks = [ring(c).walk() for c in range(C)]
            h = np.zeros((R, hp), np.float32)
            for steps in zip(*walks):
                rh, keep = np.zeros((R, hp), np.float32), {}
                for c, (_, slot, l, *_) in enumerate(steps):       # (a), then r*h exchanged
                    cols = slice(c * Hc, (c + 1) * Hc)
                    ga = team_product(h, w[d, c, :2 * Hc], sets_g)
                    r = sigmoid(slot["gr"][l] + ga[:, :Hc])
                    u = sigmoid(slot["gu"][l] + ga[:, Hc:])
                    rh[:, cols] = r * h[:, cols]
                    keep[c] = (r, u)
                h_new = np.zeros_like(h)
                for c, (_, slot, l, *_) in enumerate(steps):       # (c), then h exchanged
                    cols = slice(c * Hc, (c + 1) * Hc)
                    r, u = keep[c]
                    cand = np.tanh(slot["cx"][l] + team_product(rh, w[d, c, 2 * Hc:3 * Hc],
                                                                sets_c)).astype(np.float32)
                    h_new[:, cols] = u * h[:, cols] + (1.0 - u) * cand
                    slot["ys"][l] = h_new[:, cols]
                    if plan.gates:
                        slot["r"][l], slot["u"][l], slot["c"][l] = r, u, cand
                h = h_new
            for walk in walks:        # every CTA's last store
                next(walk, None)
    return ys, gates if plan.gates else None


def emulate_staged_backward(dys, ys, gates, packed, plan):
    """The staged bf16 backward (gru_scan_bwd_staged_kernel) in numpy
    float32: each CTA's ring over dy, h[t-1] (ys' box one forward step
    behind: before time 0 a zero), r, u, c in and dcx, dgx's halves out,
    direction 0 walking time down; the backward's exchanges and sums of
    `emulate_gru_scan_bwd`."""
    D, T, B, H = ys.shape
    C, Hc, R, S, L = plan.cluster, plan.units, plan.rows, plan.stage_steps, ck.TEAM_LANES
    hp = L * plan.reg_columns
    w = np.zeros((D, C, 3 * Hc, hp), np.float32)
    w[..., :H] = packed
    dgx = np.zeros((D, T, B, 2 * H), np.float32)
    dcx = np.zeros((D, T, B, H), np.float32)

    def lane_shares(v, rows):             # v [R, hp], rows [n, hp] -> [L, R, n]
        return np.stack([v[:, lane::L] @ rows[:, lane::L].T for lane in range(L)])

    for d in range(D):
        for g in range(plan.clusters):
            row0 = g * R

            def ring(c):
                j0, behind = c * Hc, 1 if d else -1
                box = lambda a, c0, dt=0: lambda t0: box_load(a, d, t0 + dt, row0, c0, S, R, Hc)  # noqa: E731
                put = lambda a, c0: lambda b, t0: box_store(a, b, d, t0, row0, c0)  # noqa: E731
                return Ring(T, S, d == 0, {"dy": box(dys, j0), "h": box(ys, j0, behind),
                                           "r": box(gates, j0), "u": box(gates, H + j0),
                                           "c": box(gates, 2 * H + j0)},
                            {"dcx": put(dcx, j0), "dgr": put(dgx, j0), "dgu": put(dgx, H + j0)},
                            R, Hc)

            walks = [ring(c).walk() for c in range(C)]
            carry = np.zeros((R, H), np.float32)
            for steps in zip(*walks):
                a_dcx, a_dgu = np.zeros((R, hp), np.float32), np.zeros((R, hp), np.float32)
                x = {}
                for c, (_, slot, l, *_) in enumerate(steps):     # the first exchange
                    cols = slice(c * Hc, (c + 1) * Hc)
                    dy, hb, r, u, cc = (slot[n][l] for n in ("dy", "h", "r", "u", "c"))
                    dh = dy + carry[:, cols]
                    a_dcx[:, cols] = dh * (1.0 - u) * (1.0 - cc * cc)
                    a_dgu[:, cols] = dh * (hb - cc) * u * (1.0 - u)
                    slot["dcx"][l], slot["dgu"][l] = a_dcx[:, cols], a_dgu[:, cols]
                    x[c] = (dh, hb, r, u)
                drh, su = np.zeros((R, H), np.float32), {}
                for c in range(C):                                # one pass over both halves
                    cols = slice(c * Hc, (c + 1) * Hc)
                    drh[:, cols] = lane_shares(a_dcx, w[d, c, 2 * Hc:3 * Hc]).sum(0)
                    su[c] = lane_shares(a_dgu, w[d, c, Hc:2 * Hc])
                g_dgr = np.zeros((R, hp), np.float32)             # the second exchange
                for c, (_, slot, l, *_) in enumerate(steps):
                    cols = slice(c * Hc, (c + 1) * Hc)
                    _, hb, r, _ = x[c]
                    g_dgr[:, cols] = drh[:, cols] * hb * r * (1.0 - r)
                    slot["dgr"][l] = g_dgr[:, cols]
                new = np.zeros_like(carry)
                for c in range(C):
                    cols = slice(c * Hc, (c + 1) * Hc)
                    dh, _, r, u = x[c]
                    part = (lane_shares(g_dgr, w[d, c, :Hc]) + su[c]).sum(0)
                    new[:, cols] = dh * u + drh[:, cols] * r + part
                carry = new
            for walk in walks:        # every CTA's last store
                next(walk, None)
    return dgx, dcx


# (T, B, H, cluster, stage depth, rows): stages of S steps with a ragged last
# one, T < S, T = 1, exact stages, ragged row tiles, two CTAs exchanging
STAGED_CASES = [
    (13, 5, 16, None, 4, 2),   # 4 stages, the last of 1 step; B = 5 in tiles of 2
    (3, 3, 16, None, 4, 1),    # T < S: one ragged stage
    (1, 2, 40, None, 8, 1),    # T = 1
    (8, 4, 40, None, 4, 4),    # exact stages, one full tile
    (10, 3, 64, 2, 4, 2),      # two CTAs of 32 units; ragged stage and tile
]


@pytest.mark.parametrize("T,B,H,C,S,R", STAGED_CASES)
def test_emulated_staged_forward_matches_pallas(T, B, H, C, S, R):
    """The staged training forward's walk, both directions: ys against the
    Pallas kernel in interpret mode (direction 1 on the time-reversed
    inputs), the gates against `gru_scan_fused_plain(with_gates=True)`, atol
    1e-5; no box element the steps did not write reaches an output."""
    rng = np.random.default_rng(T * 100 + H + S)
    lim = np.sqrt(6.0 / (3 * H))
    gx = rng.standard_normal((2, T, B, 2 * H)).astype(np.float32)
    cx = rng.standard_normal((2, T, B, H)).astype(np.float32)
    Wg = (lim * rng.standard_normal((2, H, 2 * H))).astype(np.float32)
    Wc = (lim * rng.standard_normal((2, H, H))).astype(np.float32)
    packed = np.stack([ck.pack_gru_weights(torch.tensor(a), torch.tensor(b), cluster=C).numpy()
                       for a, b in zip(Wg, Wc)])
    plan = ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN, cluster=packed.shape[1], elem_bytes=2,
                            dirs=2, gates=True, stage_steps=S)
    plan = dataclasses.replace(plan, rows=R, clusters=-(-B // R))
    assert plan.stage_steps == S and plan.reg_columns > 0
    ys, gates = emulate_staged_forward(gx, cx, packed, plan)
    assert np.isfinite(ys).all() and np.isfinite(gates).all()
    for d, flip in ((0, slice(None)), (1, slice(None, None, -1))):
        ref = np.asarray(gru_scan_pallas(*map(jnp.asarray, (gx[d][flip], cx[d][flip], Wg[d], Wc[d])),
                                         interpret=True))[flip]
        np.testing.assert_allclose(ys[d], ref, rtol=0, atol=ATOL)
    _, ref_gates = ck.gru_scan_fused_plain(*map(torch.tensor, (gx, cx, Wg, Wc)), with_gates=True)
    np.testing.assert_allclose(gates, ref_gates.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("T,B,H,C,S,R", STAGED_CASES)
def test_emulated_staged_inference_matches_pallas(T, B, H, C, S, R):
    """The staged inference forward of both directions (the bf16 register
    forward's walk without the gates, its boxes and sums emulated in
    float32): ys against the Pallas kernel in interpret mode,
    direction 1 on the time-reversed inputs, atol 1e-5; every element of ys
    comes from a box the steps wrote (the emulation's outputs start NaN,
    and so does each slot's output box)."""
    rng = np.random.default_rng(T * 100 + H + S + 2)
    lim = np.sqrt(6.0 / (3 * H))
    gx = rng.standard_normal((2, T, B, 2 * H)).astype(np.float32)
    cx = rng.standard_normal((2, T, B, H)).astype(np.float32)
    Wg = (lim * rng.standard_normal((2, H, 2 * H))).astype(np.float32)
    Wc = (lim * rng.standard_normal((2, H, H))).astype(np.float32)
    packed = np.stack([ck.pack_gru_weights(torch.tensor(a), torch.tensor(b), cluster=C).numpy()
                       for a, b in zip(Wg, Wc)])
    plan = ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN, cluster=packed.shape[1],
                            elem_bytes=2, dirs=2, stage_steps=S)
    plan = dataclasses.replace(plan, rows=R, clusters=-(-B // R))
    assert plan.stage_steps == S and plan.reg_columns > 0 and not plan.gates
    ys, gates = emulate_staged_forward(gx, cx, packed, plan)
    assert gates is None and np.isfinite(ys).all()
    for d, flip in ((0, slice(None)), (1, slice(None, None, -1))):
        ref = np.asarray(gru_scan_pallas(*map(jnp.asarray, (gx[d][flip], cx[d][flip], Wg[d], Wc[d])),
                                         interpret=True))[flip]
        np.testing.assert_allclose(ys[d], ref, rtol=0, atol=ATOL)


# one direction (the stream's and the sequence-parallel shards' B = 1, T
# not a multiple of S): ragged last stages, T < S, T = 1, C = 4 and 8
STAGED_ONE_DIRECTION_CASES = [
    (45, 1, 40, None, 8, 1),    # 6 stages, the last of 5 steps
    (37, 1, 128, None, 8, 1),   # C = 4, 16 columns; the last stage of 5
    (11, 1, 256, None, 4, 1),   # C = 8, 32 columns; the last stage of 3
    (3, 1, 40, None, 8, 1),     # T < S
    (1, 1, 40, None, 8, 1),     # T = 1
    (13, 5, 16, None, 4, 2),    # B = 5 in tiles of 2
]


@pytest.mark.parametrize("T,B,H,C,S,R", STAGED_ONE_DIRECTION_CASES)
def test_emulated_staged_one_direction_matches_pallas(T, B, H, C, S, R):
    """The staged inference forward of one direction (the bf16 register
    forward's walk, direction 0 only, the tensor maps' outer dimension 1,
    its boxes and sums emulated in float32): ys against the Pallas kernel
    in interpret mode, atol 1e-5; every element of ys comes from a box the
    steps wrote."""
    rng = np.random.default_rng(T * 100 + H + S + 5)
    lim = np.sqrt(6.0 / (3 * H))
    gx = rng.standard_normal((1, T, B, 2 * H)).astype(np.float32)
    cx = rng.standard_normal((1, T, B, H)).astype(np.float32)
    Wg = (lim * rng.standard_normal((H, 2 * H))).astype(np.float32)
    Wc = (lim * rng.standard_normal((H, H))).astype(np.float32)
    packed = ck.pack_gru_weights(torch.tensor(Wg), torch.tensor(Wc), cluster=C).numpy()
    plan = ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN, cluster=packed.shape[0], elem_bytes=2,
                            stage_steps=S)
    plan = dataclasses.replace(plan, rows=R, clusters=-(-B // R))
    assert plan.stage_steps == S and plan.reg_columns > 0 and plan.dirs == 1
    ys, gates = emulate_staged_forward(gx, cx, packed[None], plan)
    assert gates is None and np.isfinite(ys).all()
    ref = np.asarray(gru_scan_pallas(*map(jnp.asarray, (gx[0], cx[0], Wg, Wc)), interpret=True))
    np.testing.assert_allclose(ys[0], ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("T,B,H,C,S,R", STAGED_CASES)
def test_emulated_staged_backward_matches_jax_vjp(T, B, H, C, S, R):
    """The staged backward's walk, both directions (direction 0 walking time
    down, direction 1 up, h[t-1] a box one step behind), against ``jax.vjp``
    of the JAX package's ``lax.scan`` GRU (direction 1 on the time-reversed
    operands), within 1e-5 of each output's peak."""
    rng = np.random.default_rng(T * 100 + H + S + 1)
    lim = np.sqrt(6.0 / (3 * H))
    gx = rng.standard_normal((2, T, B, 2 * H)).astype(np.float32)
    cx = rng.standard_normal((2, T, B, H)).astype(np.float32)
    Wg = (lim * rng.standard_normal((2, H, 2 * H))).astype(np.float32)
    Wc = (lim * rng.standard_normal((2, H, H))).astype(np.float32)
    dys = rng.standard_normal((2, T, B, H)).astype(np.float32)
    ys, gates = (t.numpy() for t in ck.gru_scan_fused_plain(
        *map(torch.tensor, (gx, cx, Wg, Wc)), with_gates=True))
    packed = np.stack([ck.pack_gru_weights_bwd(torch.tensor(a), torch.tensor(b),
                                               cluster=C).numpy() for a, b in zip(Wg, Wc)])
    plan = ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN, cluster=packed.shape[1], elem_bytes=2,
                            dirs=2, backward=True, stage_steps=S)
    plan = dataclasses.replace(plan, rows=R, clusters=-(-B // R))
    assert plan.stage_steps == S and plan.reg_columns > 0
    dgx, dcx = emulate_staged_backward(dys, ys, gates, packed, plan)
    eye = np.eye(3 * H, dtype=np.float32)
    for d, flip in ((0, slice(None)), (1, slice(None, None, -1))):
        params = {"gates_kernel": np.concatenate([eye[:, :2 * H], Wg[d]]),
                  "gates_bias": np.zeros(2 * H, np.float32),
                  "candidate_kernel": np.concatenate([eye[:, 2 * H:], Wc[d]]),
                  "candidate_bias": np.zeros(H, np.float32)}
        x = np.concatenate([gx[d][flip], cx[d][flip]], axis=2).transpose(1, 0, 2)
        _, vjp = jax.vjp(lambda xx: JM._gru_dir_apply(params, xx), jnp.asarray(x))
        dx = np.asarray(vjp(jnp.asarray(dys[d][flip].transpose(1, 0, 2)))[0]).transpose(1, 0, 2)
        dx = dx[flip]
        for got, ref in ((dgx[d], dx[..., :2 * H]), (dcx[d], dx[..., 2 * H:])):
            np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL * max(np.abs(ref).max(), 1.0))
