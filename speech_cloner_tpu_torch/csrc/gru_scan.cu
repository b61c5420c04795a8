// Time-major GRU recurrence (TF GRUCell form) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_gru_kernel` / `gru_scan_pallas` in
// speech_cloner_tpu/ops/pallas_kernels.py. Computes, with h0 = 0:
//   ru  = sigmoid(gx[t] + h @ Wg_h)            r = ru[:, :H], u = ru[:, H:]
//   c   = tanh(cx[t] + (r * h) @ Wc_h)
//   h   = u * h + (1 - u) * c ;  ys[t] = h
// gx [T,B,2H], cx [T,B,H], ys [T,B,H], row-major and contiguous. The
// recurrent weights come packed by CTA (ops/cuda_kernels.py
// `pack_gru_weights`): wpack [C, 3*Hc, H] with Hc = ceil(H / C); row g*Hc + i
// of CTA c is the column of gate g (r, u, candidate) for its unit c*Hc + i,
// over k, zero past H. Sums are f32 FFMA (no TF32).
//
// Two operand types, one kernel template: f32 (scl_gru_scan_f32) and bf16
// (scl_gru_scan_bf16, the models' compute_dtype=bfloat16). As the Pallas
// kernel does with bf16 inputs (f32 h scratch, f32-accumulating dots), the
// bf16 form reads gx, cx and the weights as bf16, keeps the weights in shared
// memory as bf16 (half the f32 bytes), widens every operand to f32 in
// registers, keeps h, r*h and the exchanges in f32, and rounds only ys to
// bf16 (round to nearest even), the models' type.
//
// What bounds it. Step t needs all of h from step t-1, and inside a step the
// candidate needs all of r*h: a scan is T dependent rounds of two mat-vec
// products over H, each followed by an exchange of a [rows, H] vector among
// all the threads that computed its pieces. The operations, 6*T*B*H^2 FLOP,
// bound it at 0.14 ms for H = 256, B = 59, T = 400 (67 TFLOP/s f32); the 2*T
// exchanges, each a wait for the peers' values, and the latency of each
// round's dependent chain (shared-memory loads, sums, a shuffle reduction,
// sigmoid/tanh) set a floor the roofline does not show.
//
// Design (the launch plan comes from ops/cuda_kernels.py `gru_scan_plan`;
// this file checks it and takes it as given):
//  - Weights over a thread-block cluster. A cluster of C CTAs splits the H
//    hidden units; CTA c owns Hc of them and copies their 3*H*Hc weights from
//    device memory into its shared memory once per launch (96 KB at H = 256,
//    C = 8 in f32, 48 KB in bf16). Nothing reads the weights from device memory inside the scan.
//  - Rows. Each cluster owns R batch rows (R = 1, 2, 4, 8, a template
//    argument) and runs all T steps on them; clusters never talk to each
//    other. Every CTA keeps the full h and r*h of its rows in shared memory,
//    laid out [H][R], so one weight read and one 16-byte state read feed R
//    FMAs: the row dimension is a register tile. Both are double-buffered
//    by the parity of t, so a step's writes never land on what a slower CTA
//    still reads.
//  - Teams. A team of kL = 8 lanes owns one unit: lane l sums k = l, l+8,
//    ... of the r, u and candidate columns, and a three-level shuffle
//    reduction gives the team the totals. No shared-memory partial sums and
//    no barrier inside a product. Weight rows are padded to a stride of 8
//    mod 32 words, so the four teams of a warp hit distinct banks. A CTA has
//    8 * Hc threads (Hc <= 64).
//  - Step t: (a) gate sums over h; lane q of each team applies the sigmoids
//    for row q % R; the team gathers its R values of r*h by shuffles and
//    sends them to every CTA of the cluster. (c) candidate sum over r*h;
//    new h of row q % R to ys[t] (lanes q < R) and, gathered, to every CTA.
//  - Exchange without cluster barriers. A cluster barrier orders global
//    memory too (it compiles to a GPU-wide MEMBAR), so it would wait for the
//    ys stores and for the prefetched loads of the next step. Instead each
//    send is an st.async into the peer's shared memory that completes bytes
//    on the peer's mbarrier; a CTA waits on its own mbarrier (one per buffer
//    and vector, H*R*4 bytes a phase) for the bytes of all its peers. With
//    C = 1 the sends are plain shared stores and the waits __syncthreads.
//  - Inputs. Lane q loads gx[t+1] and cx[t+1] of its row into registers at
//    the start of step t (volatile loads, so they issue there), and their
//    latency hides behind step t.
//
// Directions. `dirs` (1 or 2) stacks independent scans on a leading axis of
// every operand ([dirs, T, B, .], weights [dirs, C, 3*Hc, H]); the clusters
// of direction 1 run time backwards (step s reads and writes time T-1-s),
// so the CBHG's two GRU directions run in one launch without a flipped
// copy of their inputs (`gru_apply_fused` of the JAX package's
// nn/modules.py, which runs both directions in one lax.scan).
//
// Training. With `gates` not null the forward also writes r, u, c of each
// step as [dirs, T, B, 3H] f32 for the backward (storing them costs 3H
// floats a row and step; recomputing them in the backward would take the
// forward's two exchanges per step again).
//
// Backward (gru_scan_bwd_kernel, f32). The Pallas kernel has no VJP; the
// JAX package trains by differentiating lax.scan. This kernel runs the
// reverse-time recurrence of that gradient, with dh = dy[t] + the carry:
//   dc = dh (1-u), du = dh (h[t-1] - c), dcx[t] = dc (1 - c^2)
//   d(rh) = dcx[t] @ Wc_h^T,  dr = d(rh) h[t-1]
//   dgx[t] = [dr r (1-r), du u (1-u)]
//   carry = dh u + d(rh) r + dgx[t] @ Wg_h^T
// It mirrors the forward: a CTA owns units j and keeps ROW j of Wg_h (both
// halves) and of Wc_h in shared memory (`pack_gru_weights_bwd`, the same
// 3*H words a unit), the carry of unit j and row q stays in a register of
// lane q of team j (it is elementwise), and the two exchanges of a step are
// dcx[t] (before the Wc_h^T product) and dgx[t] (before the Wg_h^T one).
// The weight gradients, sums over T*B rows, are matrix products the caller
// leaves to cuBLAS. Bound: 6*T*B*H^2 FLOP and 2*T exchanges, as the forward.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxH = 512;
constexpr int kMaxCluster = 16;      // above 8 needs the non-portable cluster size
constexpr int kPortableCluster = 8;
constexpr int kMaxThreads = 512;
constexpr int kL = 8;                // lanes per unit

// libm's expf and tanhf, as the plain version's torch.sigmoid and torch.tanh:
// the ex2.approx forms (__expf, and tanh from it) moved the full-width
// decoder's output past chip_smoke.py's 1e-4 parity limit against the CPU.
__device__ __forceinline__ float sigmoid_f32(float x) { return __frcp_rn(1.0f + expf(-x)); }
__device__ __forceinline__ float tanh_f32(float x) { return tanhf(x); }

__host__ __device__ __forceinline__ size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

// Row stride of the weight slice: the least >= H that is 8 mod 32.
__host__ __device__ __forceinline__ int weight_stride(int H) {
  return H + (kL - H % 32 + 32) % 32;
}

__host__ __device__ __forceinline__ int cta_threads(int Hc) { return (Hc * kL + 31) / 32 * 32; }

// Shared-memory layout, in floats: 4 mbarriers (8 bytes each: r*h and h,
// two buffers each), hT [2][H][R], rhT [2][H][R], then the weights
// [3*Hc][stride] of `wbytes` bytes each (4 for f32, 2 for bf16); each region
// starts on 16 bytes. Mirrors ops/cuda_kernels.py gru_scan_smem_bytes.
struct Layout {
  size_t bars, h, rh, w, total;
  __host__ __device__ Layout(int H, int C, int R, int wbytes) {
    const int Hc = (H + C - 1) / C;
    bars = 0;
    h = bars + 8;
    rh = h + 2 * round4((size_t)H * R);
    w = rh + 2 * round4((size_t)H * R);
    total = w + round4(((size_t)3 * Hc * weight_stride(H) * wbytes + 3) / 4);
  }
};

// Operand widening, output rounding and non-coherent loads, per type.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float load_nc(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float load_nc(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __uint_as_float((uint32_t)v << 16);   // bf16 is the high half of an f32
}

template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else if constexpr (R == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// s[n][r] = sum over this lane's k (lane, lane+8, ...) of vT[k][r] * w[n][k],
// for N weight rows (W: float or bf16, widened); two interleaved sets of sums
// for more FMAs in flight.
template <int R, int N, typename W>
__device__ __forceinline__ void lane_sums(const float* __restrict__ vT,
                                          const W* const (&w)[N], int H, int lane,
                                          float (&s)[N][R]) {
  float a[2][N][R];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int r = 0; r < R; ++r) a[q][n][r] = 0.0f;
  const int nk = lane < H ? (H - 1 - lane) / kL + 1 : 0;
  const float* vp = vT + (size_t)lane * R;
  const W* wp[N];
#pragma unroll
  for (int n = 0; n < N; ++n) wp[n] = w[n] + lane;
  int i = 0;
  for (; i + 4 <= nk; i += 4) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float v[R];
      load_rows<R>(vp + x * kL * R, v);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float wv = to_f32(wp[n][x * kL]);
#pragma unroll
        for (int r = 0; r < R; ++r) a[x & 1][n][r] = fmaf(v[r], wv, a[x & 1][n][r]);
      }
    }
    vp += 4 * kL * R;
#pragma unroll
    for (int n = 0; n < N; ++n) wp[n] += 4 * kL;
  }
  for (; i < nk; ++i) {
    float v[R];
    load_rows<R>(vp, v);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float wv = to_f32(*wp[n]);
#pragma unroll
      for (int r = 0; r < R; ++r) a[0][n][r] = fmaf(v[r], wv, a[0][n][r]);
      wp[n] += kL;
    }
    vp += kL * R;
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int r = 0; r < R; ++r) s[n][r] = a[0][n][r] + a[1][n][r];
}

// Sum over the kL lanes of each team (aligned groups of 8 lanes of a warp).
// Every lane of the warp must call it.
template <int R, int N>
__device__ __forceinline__ void team_sum(float (&s)[N][R]) {
#pragma unroll
  for (int m = kL >> 1; m > 0; m >>= 1)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int r = 0; r < R; ++r) s[n][r] += __shfl_xor_sync(0xffffffffu, s[n][r], m);
}

// s[row], row a run-time index, without local memory.
template <int R>
__device__ __forceinline__ float pick(const float (&s)[R], int row) {
  float v = s[0];
#pragma unroll
  for (int r = 1; r < R; ++r) v = row == r ? s[r] : v;
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address `addr` (this CTA's shared memory) has in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// This phase's one arrival, expecting `bytes` of st.async into the CTA.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// R floats to shared::cluster address `addr`, completing 4*R bytes on `bar`.
template <int R>
__device__ __forceinline__ void send_rows(uint32_t addr, const float (&v)[R], uint32_t bar) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
          "[%5];" ::"r"(addr + 4 * i), "r"(__float_as_uint(v[i])), "r"(__float_as_uint(v[i + 1])),
          "r"(__float_as_uint(v[i + 2])), "r"(__float_as_uint(v[i + 3])), "r"(bar)
          : "memory");
  } else if constexpr (R == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];" ::"r"(
            addr), "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])), "r"(bar)
        : "memory");
  } else {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                     addr), "r"(__float_as_uint(v[0])), "r"(bar)
                 : "memory");
  }
}

// Row q's value (held by lane q of the team, lanes base..base+R-1 of the
// warp) into v[q] of every lane. Every lane of the warp must call it.
template <int R>
__device__ __forceinline__ void gather_rows(float mine, int base, float (&v)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = __shfl_sync(0xffffffffu, mine, base + r);
}

// The team's R values of unit j0 + j into buffer `buf` of every CTA: st.async
// completing on each peer's `bar` when C > 1, a plain store (lanes < R) when
// C == 1.
template <int R>
__device__ __forceinline__ void exchange(float mine, float* buf, uint32_t bar, int j0, int j,
                                         int nu, int lane, int C) {
  if (C == 1) {
    if (j < nu && lane < R) buf[(size_t)(j0 + j) * R + lane] = mine;
    return;
  }
  float v[R];
  gather_rows<R>(mine, (threadIdx.x & 31) & ~(kL - 1), v);
  if (j < nu) {
    const uint32_t addr = smem_u32(buf + (size_t)(j0 + j) * R);
    for (int d = lane; d < C; d += kL) send_rows<R>(map_rank(addr, d), v, map_rank(bar, d));
  }
}

// This CTA's weight slice [3*Hc][H] from device memory into shared memory
// once per launch, rows padded to `ld`; 16-byte copies where the rows allow.
template <typename In>
__device__ __forceinline__ void load_weights(In* ws, const In* src, int H, int Hc, int ld,
                                             int tid, int nt) {
  constexpr int V = 16 / sizeof(In);
  if (H % V == 0 && ld % V == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int hv = H / V;
    for (int i = tid; i < 3 * Hc * hv; i += nt) {
      const int row = i / hv, kv = i - row * hv;
      reinterpret_cast<uint4*>(ws + (size_t)row * ld)[kv] =
          __ldg(reinterpret_cast<const uint4*>(src) + i);
    }
  } else {
    for (int i = tid; i < 3 * Hc * H; i += nt) {
      const int row = i / H, k = i - row * H;
      ws[(size_t)row * ld + k] = __ldg(src + i);
    }
  }
}

// kFull: the stacked directions and the gates output. Without it (the
// inference scan of one direction) both compile away: dir is 0, step t is
// time t and nothing is stored but ys.
template <typename In, int R, bool kFull>
__global__ void __launch_bounds__(kMaxThreads)
gru_scan_kernel(const In* __restrict__ gx, const In* __restrict__ cx,
                const In* __restrict__ wpack, In* __restrict__ ys, float* __restrict__ gates,
                int* __restrict__ sm_ids, int T, int B, int H, int C, int nclus) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Hc = (H + C - 1) / C;
  const int rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int cl = blockIdx.x / C;           // 1-D clusters: consecutive blocks
  const int dir = kFull ? cl / nclus : 0;  // direction 1 runs time backwards
  const int row0 = (cl - dir * nclus) * R;
  const int j0 = rank * Hc;
  const size_t TB = (size_t)T * B;
  if (kFull) {
    gx += dir * TB * 2 * H;
    cx += dir * TB * H;
    ys += dir * TB * H;
    wpack += (size_t)dir * C * 3 * Hc * H;
    if (gates != nullptr) gates += dir * TB * 3 * H;
  }
  auto tix = [=](int t) { return (size_t)(kFull && dir ? T - 1 - t : t); };   // step -> time
  const int nu = max(0, min(Hc, H - j0));  // units this CTA owns
  const int ld = weight_stride(H);
  const Layout lay(H, C, R, (int)sizeof(In));
  const size_t hr = round4((size_t)H * R);   // buffer b of h: smem + lay.h + b * hr
  In* ws = reinterpret_cast<In*>(smem + lay.w);
  const uint32_t bar0 = smem_u32(smem + lay.bars);   // r*h: bar0 + 8b; h: bar0 + 16 + 8b
  const uint32_t phase_bytes = (uint32_t)(H * R * sizeof(float));

  if (sm_ids != nullptr && tid == 0) {
    unsigned int s;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
    sm_ids[blockIdx.x] = (int)s;
  }
  if (C > 1 && tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  load_weights<In>(ws, wpack + (size_t)rank * 3 * Hc * H, H, Hc, ld, tid, nt);
  for (int i = tid; i < H * R; i += nt) smem[lay.h + i] = 0.0f;   // h0 in buffer 0

  const int j = tid / kL, lane = tid % kL;   // team j owns unit j0 + j
  const int jr = min(j, Hc - 1);             // teams past Hc sum a valid row and drop it
  const int q = lane % R;                    // the row this lane finishes
  const int row = row0 + q;
  const bool live = j < nu && row < B;
  const size_t e = (size_t)(j0 + jr) * R + q;
  const In* const wg[2] = {ws + (size_t)jr * ld, ws + (size_t)(Hc + jr) * ld};
  const In* const wc[1] = {ws + (size_t)(2 * Hc + jr) * ld};
  const In* gx_p = gx + (size_t)row * 2 * H + j0 + j;   // time t: + t * B * 2H
  const In* cx_p = cx + (size_t)row * H + j0 + j;
  const size_t gx_t = (size_t)B * 2 * H, cx_t = (size_t)B * H;

  float gr = 0.0f, gu = 0.0f, gc = 0.0f;
  if (live && T > 0) {
    gr = load_nc(gx_p + tix(0) * gx_t);
    gu = load_nc(gx_p + tix(0) * gx_t + H);
    gc = load_nc(cx_p + tix(0) * cx_t);
  }
  // weights, h0 and the mbarriers in place; every CTA of the cluster running
  if (C > 1) cluster.sync(); else __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const bool last = t + 1 == T;
    const float* h_cur = smem + lay.h + cur * hr;
    float* h_nxt = smem + lay.h + nxt * hr;
    float* rh_cur = smem + lay.rh + cur * hr;
    const uint32_t bar_rh = bar0 + 8 * cur, bar_h_cur = bar0 + 16 + 8 * cur,
                   bar_h_nxt = bar0 + 16 + 8 * nxt;
    float ngr = 0.0f, ngu = 0.0f, ngc = 0.0f;
    if (live && !last) {
      ngr = load_nc(gx_p + tix(t + 1) * gx_t);
      ngu = load_nc(gx_p + tix(t + 1) * gx_t + H);
      ngc = load_nc(cx_p + tix(t + 1) * cx_t);
    }
    if (C > 1) {
      if (t > 0) mbar_wait(bar_h_cur, ((t - 1) >> 1) & 1);   // h of step t-1
      if (tid == 0) {
        mbar_expect(bar_rh, phase_bytes);
        if (!last) mbar_expect(bar_h_nxt, phase_bytes);
      }
    }

    // (a) gates over h, then r*h of this unit into every CTA
    float sg[2][R];
    lane_sums<R, 2>(h_cur, wg, H, lane, sg);
    team_sum<R, 2>(sg);
    const float rg = sigmoid_f32(gr + pick<R>(sg[0], q));
    const float u = sigmoid_f32(gu + pick<R>(sg[1], q));
    exchange<R>(rg * h_cur[e], rh_cur, bar_rh, j0, j, nu, lane, C);
    if (C > 1) mbar_wait(bar_rh, (t >> 1) & 1); else __syncthreads();

    // (c) candidate over r*h, new h into ys[t] and every CTA
    float sc[1][R];
    lane_sums<R, 1>(rh_cur, wc, H, lane, sc);
    team_sum<R, 1>(sc);
    const float c = tanh_f32(gc + pick<R>(sc[0], q));
    const float hn = u * h_cur[e] + (1.0f - u) * c;
    if (live && lane < R) {
      const size_t o = tix(t) * B + row;
      store_out(ys + o * H + j0 + j, hn);
      if (kFull && gates != nullptr) {
        float* g = gates + o * 3 * H + j0 + j;
        g[0] = rg; g[H] = u; g[2 * H] = c;
      }
    }
    if (!last) exchange<R>(hn, h_nxt, bar_h_nxt, j0, j, nu, lane, C);
    if (C == 1) __syncthreads();

    gr = ngr; gu = ngu; gc = ngc;
  }
  if (C > 1) cluster.sync();   // no CTA leaves while a peer may still address it
}

// Shared-memory layout of the backward, in floats: 4 mbarriers (dcx and
// dgx, two buffers each), dcxT [2][H][R], dgxT [2][2H][R] (the r half, then
// the u half), the transposed weights [3*Hc][stride] (f32). Mirrors
// ops/cuda_kernels.py gru_scan_smem_bytes(..., backward=True).
struct LayoutBwd {
  size_t bars, a, g, w, total;
  __host__ __device__ LayoutBwd(int H, int C, int R) {
    const int Hc = (H + C - 1) / C;
    bars = 0;
    a = bars + 8;
    g = a + 2 * round4((size_t)H * R);
    w = g + 2 * round4((size_t)2 * H * R);
    total = w + round4((size_t)3 * Hc * weight_stride(H));
  }
};

// dys, ys [dirs, T, B, H]; gates [dirs, T, B, 3H] (r, u, c from the forward);
// wpack [dirs, C, 3*Hc, H] from pack_gru_weights_bwd (row g*Hc + i of CTA c:
// row c*Hc + i of Wg_h's r half, its u half, Wc_h); out dgx [dirs, T, B, 2H],
// dcx [dirs, T, B, H]. Direction 1's forward ran time backwards, so its
// backward runs time forwards.
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
gru_scan_bwd_kernel(const float* __restrict__ dys, const float* __restrict__ ys,
                    const float* __restrict__ gates, const float* __restrict__ wpack,
                    float* __restrict__ dgx, float* __restrict__ dcx, int T, int B, int H,
                    int C, int nclus) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Hc = (H + C - 1) / C;
  const int rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int cl = blockIdx.x / C;
  const int dir = cl / nclus;
  const int row0 = (cl - dir * nclus) * R;
  const int j0 = rank * Hc;
  const int nu = max(0, min(Hc, H - j0));
  const int ld = weight_stride(H);
  const LayoutBwd lay(H, C, R);
  const size_t ab = round4((size_t)H * R), gb = round4((size_t)2 * H * R);
  const size_t TB = (size_t)T * B;
  dys += dir * TB * H;
  ys += dir * TB * H;
  gates += dir * TB * 3 * H;
  dgx += dir * TB * 2 * H;
  dcx += dir * TB * H;
  wpack += (size_t)dir * C * 3 * Hc * H;
  auto tix = [=](int s) { return (size_t)(dir ? T - 1 - s : s); };   // forward step -> time
  float* ws = smem + lay.w;
  const uint32_t bar0 = smem_u32(smem + lay.bars);   // dcx: bar0 + 8b; dgx: bar0 + 16 + 8b
  const uint32_t a_bytes = (uint32_t)(H * R * sizeof(float)), g_bytes = 2 * a_bytes;

  if (C > 1 && tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  load_weights<float>(ws, wpack + (size_t)rank * 3 * Hc * H, H, Hc, ld, tid, nt);

  const int j = tid / kL, lane = tid % kL;   // team j owns unit j0 + j
  const int jr = min(j, Hc - 1);
  const int q = lane % R;                    // the row this lane carries
  const int row = row0 + q;
  const bool live = j < nu && row < B;
  const int unit = j0 + j;
  const float* const wr[1] = {ws + (size_t)jr * ld};
  const float* const wu[1] = {ws + (size_t)(Hc + jr) * ld};
  const float* const wc[1] = {ws + (size_t)(2 * Hc + jr) * ld};

  // step s's inputs of this lane's row and unit: dy, r, u, c and h[s-1]
  float dy = 0.0f, r = 0.0f, u = 0.0f, c = 0.0f, hp = 0.0f;
  auto load_step = [&](int s, float& dy_, float& r_, float& u_, float& c_, float& hp_) {
    const size_t o = tix(s) * B + row;
    dy_ = load_nc(dys + o * H + unit);
    const float* g = gates + o * 3 * H + unit;
    r_ = load_nc(g); u_ = load_nc(g + H); c_ = load_nc(g + 2 * H);
    hp_ = s > 0 ? load_nc(ys + (tix(s - 1) * B + row) * H + unit) : 0.0f;
  };
  if (live && T > 0) load_step(T - 1, dy, r, u, c, hp);
  // weights and the mbarriers in place; every CTA of the cluster running
  if (C > 1) cluster.sync(); else __syncthreads();

  float carry = 0.0f;
  for (int i = 0; i < T; ++i) {
    const int s = T - 1 - i, b = i & 1;
    const uint32_t bar_a = bar0 + 8 * b, bar_g = bar0 + 16 + 8 * b;
    float* a_buf = smem + lay.a + b * ab;
    float* g_buf = smem + lay.g + b * gb;
    float ndy = 0.0f, nr = 0.0f, nu_ = 0.0f, nc = 0.0f, nhp = 0.0f;
    if (live && s > 0) load_step(s - 1, ndy, nr, nu_, nc, nhp);
    if (C > 1 && tid == 0) {
      mbar_expect(bar_a, a_bytes);
      mbar_expect(bar_g, g_bytes);
    }
    const size_t o = tix(s) * B + row;

    // dcx of this unit into dcx[t] and every CTA
    const float dh = dy + carry;
    const float du = dh * (hp - c);
    const float dcv = dh * (1.0f - u) * (1.0f - c * c);
    if (live && lane < R) dcx[o * H + unit] = dcv;
    exchange<R>(dcv, a_buf, bar_a, j0, j, nu, lane, C);
    if (C > 1) mbar_wait(bar_a, (i >> 1) & 1); else __syncthreads();

    // d(rh) = dcx @ Wc_h^T over row `unit` of Wc_h; dgx of this unit out and to every CTA
    float sa[1][R];
    lane_sums<R, 1>(a_buf, wc, H, lane, sa);
    team_sum<R, 1>(sa);
    const float drh = pick<R>(sa[0], q);
    const float dgr = drh * hp * r * (1.0f - r);
    const float dgu = du * u * (1.0f - u);
    if (live && lane < R) {
      dgx[o * 2 * H + unit] = dgr;
      dgx[o * 2 * H + H + unit] = dgu;
    }
    exchange<R>(dgr, g_buf, bar_g, j0, j, nu, lane, C);
    exchange<R>(dgu, g_buf + (size_t)H * R, bar_g, j0, j, nu, lane, C);
    if (C > 1) mbar_wait(bar_g, (i >> 1) & 1); else __syncthreads();

    // carry to step s-1: dh u + d(rh) r + dgx @ Wg_h^T over row `unit` of Wg_h
    float sr[1][R], su[1][R];
    lane_sums<R, 1>(g_buf, wr, H, lane, sr);
    lane_sums<R, 1>(g_buf + (size_t)H * R, wu, H, lane, su);
#pragma unroll
    for (int k = 0; k < R; ++k) sr[0][k] += su[0][k];
    team_sum<R, 1>(sr);
    carry = dh * u + drh * r + pick<R>(sr[0], q);

    dy = ndy; r = nr; u = nu_; c = nc; hp = nhp;
  }
  if (C > 1) cluster.sync();   // no CTA leaves while a peer may still address it
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

bool plan_ok(int H, int C, int R, int threads) {
  if (H <= 0 || H > kMaxH) return false;
  if (!pow2(C) || C > kMaxCluster) return false;
  if (R != 1 && R != 2 && R != 4 && R != 8) return false;   // R <= kL: a lane per row
  return threads == cta_threads((H + C - 1) / C) && threads <= kMaxThreads;
}

// Launch `kernel` on `blocks` CTAs in 1-D clusters of C with `smem` bytes of
// dynamic shared memory; returns the CUDA error of the launch.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int C, int blocks, int threads,
                            size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  if (C > kPortableCluster) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The plan checks both entries share: T, B, the cluster, rows and clusters
// per direction, the directions.
bool grid_ok(int T, int B, int H, int C, int R, int clusters, int dirs, int threads) {
  if (T <= 0 || B <= 0 || !plan_ok(H, C, R, threads)) return false;
  if (dirs != 1 && dirs != 2) return false;
  return clusters > 0 && (long long)clusters * R >= B && (long long)(clusters - 1) * R < B;
}

// The forward's instantiation for R and kFull.
template <typename In, bool kFull>
cudaError_t launch_r(int R, int C, int blocks, int threads, size_t smem, cudaStream_t s,
                     const In* gx, const In* cx, const In* wpack, In* ys, float* gates,
                     int* sm_ids, int T, int B, int H, int clusters) {
  switch (R) {
    case 1: return launch_clusters(gru_scan_kernel<In, 1, kFull>, C, blocks, threads, smem, s,
                                   gx, cx, wpack, ys, gates, sm_ids, T, B, H, C, clusters);
    case 2: return launch_clusters(gru_scan_kernel<In, 2, kFull>, C, blocks, threads, smem, s,
                                   gx, cx, wpack, ys, gates, sm_ids, T, B, H, C, clusters);
    case 4: return launch_clusters(gru_scan_kernel<In, 4, kFull>, C, blocks, threads, smem, s,
                                   gx, cx, wpack, ys, gates, sm_ids, T, B, H, C, clusters);
    default: return launch_clusters(gru_scan_kernel<In, 8, kFull>, C, blocks, threads, smem,
                                    s, gx, cx, wpack, ys, gates, sm_ids, T, B, H, C, clusters);
  }
}

// Checks the plan and launches the forward's instantiation; returns the CUDA error.
template <typename In>
int launch_checked(const In* gx, const In* cx, const In* wpack, In* ys, float* gates,
                   int* sm_ids, int T, int B, int H, int C, int R, int clusters, int dirs,
                   int threads, long long smem, void* stream) {
  if (!grid_ok(T, B, H, C, R, clusters, dirs, threads)) return (int)cudaErrorInvalidValue;
  if (smem != (long long)(Layout(H, C, R, (int)sizeof(In)).total * sizeof(float)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = dirs * clusters * C;
  if (dirs == 1 && gates == nullptr)
    return (int)launch_r<In, false>(R, C, blocks, threads, smem, s, gx, cx, wpack, ys, gates,
                                    sm_ids, T, B, H, clusters);
  return (int)launch_r<In, true>(R, C, blocks, threads, smem, s, gx, cx, wpack, ys, gates,
                                 sm_ids, T, B, H, clusters);
}

// Checks the plan and launches the backward's instantiation for R.
int launch_bwd_checked(const float* dys, const float* ys, const float* gates,
                       const float* wpack, float* dgx, float* dcx, int T, int B, int H, int C,
                       int R, int clusters, int dirs, int threads, long long smem,
                       void* stream) {
  if (!grid_ok(T, B, H, C, R, clusters, dirs, threads)) return (int)cudaErrorInvalidValue;
  if (smem != (long long)(LayoutBwd(H, C, R).total * sizeof(float)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = dirs * clusters * C;
  cudaError_t e;
  switch (R) {
    case 1: e = launch_clusters(gru_scan_bwd_kernel<1>, C, blocks, threads, smem, s, dys, ys,
                                gates, wpack, dgx, dcx, T, B, H, C, clusters);
      break;
    case 2: e = launch_clusters(gru_scan_bwd_kernel<2>, C, blocks, threads, smem, s, dys, ys,
                                gates, wpack, dgx, dcx, T, B, H, C, clusters);
      break;
    case 4: e = launch_clusters(gru_scan_bwd_kernel<4>, C, blocks, threads, smem, s, dys, ys,
                                gates, wpack, dgx, dcx, T, B, H, C, clusters);
      break;
    default: e = launch_clusters(gru_scan_bwd_kernel<8>, C, blocks, threads, smem, s, dys, ys,
                                 gates, wpack, dgx, dcx, T, B, H, C, clusters);
      break;
  }
  return (int)e;
}

}  // namespace

extern "C" {

// SM count and opt-in shared memory per block of device `dev`; returns the CUDA error.
int scl_gru_scan_device_limits(int dev, int* n_sms, int* smem_optin) {
  cudaError_t e = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Launch the scan with the given plan on `stream` and return the CUDA error
// of the launch (0 = launched). `clusters` is per direction; with dirs = 2
// every operand has a leading direction axis and direction 1 runs time
// backwards. gates, when not null, receives r, u, c [dirs, T, B, 3H] in f32;
// sm_ids, when not null, each CTA's SM. f32 operands and output:
int scl_gru_scan_f32(const float* gx, const float* cx, const float* wpack, float* ys,
                     float* gates, int* sm_ids, int T, int B, int H, int C, int R, int clusters,
                     int dirs, int threads, long long smem, void* stream) {
  return launch_checked<float>(gx, cx, wpack, ys, gates, sm_ids, T, B, H, C, R, clusters, dirs,
                               threads, smem, stream);
}

// bf16 operands and output (f32 state and sums inside):
int scl_gru_scan_bf16(const __nv_bfloat16* gx, const __nv_bfloat16* cx,
                      const __nv_bfloat16* wpack, __nv_bfloat16* ys, float* gates, int* sm_ids,
                      int T, int B, int H, int C, int R, int clusters, int dirs, int threads,
                      long long smem, void* stream) {
  return launch_checked<__nv_bfloat16>(gx, cx, wpack, ys, gates, sm_ids, T, B, H, C, R,
                                       clusters, dirs, threads, smem, stream);
}

// The scan's backward, f32: dys, ys, gates of the forward and the weights
// packed by pack_gru_weights_bwd in; dgx [dirs, T, B, 2H], dcx [dirs, T, B, H] out.
int scl_gru_scan_bwd_f32(const float* dys, const float* ys, const float* gates,
                         const float* wpack, float* dgx, float* dcx, int T, int B, int H, int C,
                         int R, int clusters, int dirs, int threads, long long smem,
                         void* stream) {
  return launch_bwd_checked(dys, ys, gates, wpack, dgx, dcx, T, B, H, C, R, clusters, dirs,
                            threads, smem, stream);
}

}  // extern "C"
