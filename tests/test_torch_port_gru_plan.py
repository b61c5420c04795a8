"""The GRU scan kernel's launch plan and work split, on the CPU.

`gru_scan_plan` and `pack_gru_weights` are plain Python and tensor code;
the kernel itself (csrc/gru_scan.cu) runs only on a card. Here the plan is
checked over the widths and batch sizes the port meets, and a slice-by-slice
emulation of the kernel (below, in numpy float32: clusters of CTAs, each CTA
its packed weight slice, the row tile, a team of 8 lanes per unit each
summing its strided share of k, the exchanges of r*h and h) is held against
the Pallas kernel in interpret mode at atol 1e-5, as
tests/test_torch_port_nn.py holds the plain version.
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


@pytest.mark.parametrize("B", [1, 3, 9, 59])
@pytest.mark.parametrize("H", [1, 8, 40, 128, 256, 512])
def test_plan_partitions_rows_and_units(H, B):
    plan = ck.gru_scan_plan(H, B, N_SMS, SMEM_OPTIN)
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
    # weights and state in one CTA's shared memory
    assert plan.smem_bytes == ck.gru_scan_smem_bytes(H, C, R)
    assert 12 * H * plan.units < plan.smem_bytes <= SMEM_OPTIN


def test_plan_on_the_main_path():
    """The scans of one convert: B = 59 at H = 40, 128, 256."""
    p40, p128, p256 = (ck.gru_scan_plan(H, 59, N_SMS, SMEM_OPTIN) for H in (40, 128, 256))
    assert (p40.cluster, p40.rows, p40.clusters, p40.threads) == (1, 1, 59, 320)
    assert (p128.cluster, p128.rows, p128.clusters, p128.threads) == (4, 2, 30, 256)
    assert (p256.cluster, p256.rows, p256.clusters, p256.threads) == (8, 2, 30, 256)
    # more CTAs than the 59 rows, all resident at once: one to an SM at
    # H = 128, two at H = 256
    assert 59 < p128.ctas <= N_SMS
    assert N_SMS < p256.ctas <= 2 * N_SMS and 2 * p256.smem_bytes + 1024 <= SMEM_OPTIN
    assert 12 * 256 * p256.units == 96 * 1024      # 96 KB of weights per CTA


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
    """The plan with R rows per cluster, as the kernel's R instantiations take it."""
    return dataclasses.replace(plan, rows=R, clusters=-(-plan.B // R),
                               smem_bytes=ck.gru_scan_smem_bytes(plan.H, plan.cluster, R))


@pytest.mark.parametrize("T,B,H,C,R", [
    (16, 13, 40, None, None),  # C = 1, one row per cluster
    (12, 5, 40, 16, 2),        # ragged units: 13 CTAs of 3, one of 1, two empty
    (10, 13, 8, 4, 8),         # ragged rows: B = 13 in tiles of 8
    (6, 3, 1, 2, None),        # H = 1: one unit, one empty CTA
    (8, 7, 129, None, None),   # C = 8, seven CTAs of 17 units and one of 10
    (6, 59, 256, None, None),  # the decoder's width: C = 8, 2 rows per cluster
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
