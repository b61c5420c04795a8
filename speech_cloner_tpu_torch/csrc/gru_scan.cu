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
// Three kernels, two of them also in a staged form:
//  - gru_scan_kernel (scl_gru_scan_f32): the f32 forward, weights in shared
//    memory, only where no register instance serves a form: past H = 256,
//    at a cluster size whose CTAs pass the register instances' launch
//    bounds, or at a row count whose register instance would spill (the
//    training forward's (4 | 8, 32)).
//  - gru_scan_reg_kernel: the forward with its weights in registers, every
//    form (the inference forward of one direction or both, the training
//    forward), for operands In = bf16 (scl_gru_scan_bf16, the models'
//    compute_dtype=bfloat16) and In = f32 (scl_gru_scan_f32). As the Pallas
//    kernel does with bf16 inputs (f32 h scratch, f32-accumulating dots) it
//    reads gx, cx and the weights as In, keeps h, r*h, the exchanges and the
//    sums f32, and rounds only a bf16 ys (nearest even). Training forward:
//    gates out, kGates.
//  - gru_scan_bwd_kernel (scl_gru_scan_bwd_f32, scl_gru_scan_bwd_bf16):
//    the gradient, for f32 or bf16 operands. Weights in registers.
//  - gru_scan_reg_staged_kernel, gru_scan_bwd_staged_kernel: the bf16
//    register forward (every form) and the bf16 gradient with their
//    operands staged through shared memory by the TMA ("staging by the TMA"
//    below), where the plan gives a stage depth; the same steps and sums.
//
// What bounds them on this card. Step t needs all of h from step t-1, and
// inside a step the candidate needs all of r*h: a scan is T dependent
// rounds of two mat-vec products over H, each followed by an exchange of a
// [rows, H] vector among all the threads that computed its pieces. The
// operations, 6*T*B*H^2 FLOP, bound it at 0.14 ms for H = 256, B = 59,
// T = 400 (67 TFLOP/s f32), the bytes far lower; the kernels run at 5-20%
// of that. A step's time is its chain, 2*T times over (PERF.md has the
// probe builds' breakdown): the products, which at H = 256 are bound by
// what shared memory delivers to the lanes (every team reads the whole
// exchanged vector, B*H^2*4 bytes a product across the card, 128 bytes a
// clock an SM; in the shared-memory forward the weights too), a three-level shuffle
// reduction, sigmoid/tanh, the exchange's wait for every peer's values, and
// device-memory loads and stores issued inside the chain.
//
// Design (the launch plan comes from ops/cuda_kernels.py `gru_scan_plan`;
// this file checks it and takes it as given):
//  - Units over a thread-block cluster. A cluster of C CTAs splits the H
//    hidden units; CTA c owns Hc of them. Nothing reads the weights from
//    device memory inside the scan.
//  - Where the weights live. The register forward (every form, either
//    operand type) and the backward hold them in registers: lane l of unit
//    j's team keeps k = l, l + 8, ... of unit j's three rows (3*NK floats,
//    NK = 5, 8, 16, 32 at H <= 40, 64, 128, 256: a column class per
//    compiled instance, zero past H), read (and widened from bf16) to f32
//    once per launch, so a product step reads only the vector and the
//    chain is the same for either operand type. At NK = 32 a thread holds
//    96 weights, so those instances allow one 256-thread CTA per SM (<= 255
//    registers); at NK = 16 most take two. Which (R, NK) instances do so is the table
//    reg_instance, the ones ptxas compiles without a spill. The others,
//    and every instance past H = 256, keep the weights in shared memory:
//    f32 rows in the backward, bf16 pairs read as 32-bit words and widened
//    by a shift and a mask in the bf16 forward; the f32 forward there is
//    the shared-memory kernel, which copies its CTA's 3*H*Hc weights into
//    shared memory once per launch, so each product step reads a weight
//    and a vector row from there.
//  - Rows. Each cluster owns R batch rows (R = 1, 2, 4, 8, a template
//    argument) and runs all T steps on them; clusters never talk to each
//    other. Every CTA keeps the full exchanged vectors of its rows in shared
//    memory, laid out [H][R], so one vector read feeds N*R FMAs (N weight
//    rows): the row dimension is a register tile. They are double-buffered
//    by step parity, so a step's writes never land on what a slower CTA
//    still reads.
//  - Teams. A team of kL = 8 lanes owns one unit: lane l sums its k share
//    and a three-level shuffle reduction gives the team the totals. No
//    shared-memory partial sums and no barrier inside a product. Weight rows
//    in shared memory are padded to a stride of 8 mod 32 words, so the four
//    teams of a warp hit distinct banks. A CTA has 8 * Hc threads.
//  - Forward step t: (a) gate sums over h; lane q of each team applies the
//    sigmoids for row q % R; the team gathers its R values of r*h by
//    shuffles and sends them to every CTA of the cluster. (c) candidate sum
//    over r*h; new h of row q % R to ys[t] (lanes q < R) and, gathered, to
//    every CTA.
//  - Exchange without cluster barriers. A cluster barrier orders global
//    memory too (it compiles to a GPU-wide MEMBAR), so it would wait for the
//    ys stores and for the prefetched loads of the next step. Instead each
//    send is an st.async into the peer's shared memory that completes bytes
//    on the peer's mbarrier; a CTA waits on its own mbarrier (one per buffer
//    and vector) for the bytes of all its peers. With C = 1 the sends are
//    plain shared stores and the waits __syncthreads.
//  - Inputs (unstaged). Each lane loads the next step's inputs of its row into
//    registers one step ahead (volatile loads, so they issue there). The
//    shared-memory forward issues them at the start of a step and stores ys
//    before its send. The register forward and the backward issue loads and
//    stores after a send, while the peers' values arrive (issued ahead of
//    the st.async they delayed it), address them by 32-bit element offsets
//    (fewer registers), and run two steps a round with two sets of input
//    registers swapped, so no step ends copying a load still in flight (the
//    copy waited for it). In bf16 that is not enough: the widening of a
//    16-bit load consumes it in the block that issued it, ahead of the
//    exchange's wait, so each step waited out the load there (on the H100
//    the bf16 training kernels ran 16-45% behind f32 at equal plans); the staged
//    forms take device memory out of the step instead.
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
// forward's two exchanges per step again): the register forward in its
// kGates instances (a compile-time switch, so its inference instances
// compile as they did without the output), the shared-memory one in its
// kFull ones. The gates are f32 for either operand type, as the kernel
// computed them.
//
// Backward. The Pallas kernel has no VJP; the JAX package trains by
// differentiating lax.scan. This kernel runs the reverse-time recurrence of
// that gradient, with dh = dy[t] + the carry:
//   dcx[t] = dh (1-u) (1 - c^2),  dgu = dh (h[t-1] - c) u (1-u)
//   d(rh) = dcx[t] @ Wc_h^T,      dgr = d(rh) h[t-1] r (1-r)
//   dgx[t] = [dgr, dgu]
//   carry = dh u + d(rh) r + dgr @ Wg_h[:, :H]^T + dgu @ Wg_h[:, H:]^T
// A CTA owns units j and holds ROW j of Wg_h (both halves) and of Wc_h
// (`pack_gru_weights_bwd`); the carry of unit j and row q stays in a
// register of lane q of team j (it is elementwise). dgu needs only the
// carry and the step's inputs, so a step has this order:
//   1. dcx and dgu out, and both to every CTA in one phase ([H][2R]);
//   2. one pass over that buffer: the Wc_h^T sum, reduced to d(rh), and the
//      lanes' shares of the Wg_h[:, H:]^T sum, kept unreduced;
//   3. dgr out and to every CTA (the second phase, [H][R]);
//   4. one pass of Wg_h[:, :H]^T over dgr, added to the kept shares, one
//      reduction, the carry.
// After the second exchange one product pass remains, not two. The weight
// gradients, sums over T*B rows, are matrix products the caller leaves to
// cuBLAS.
//
// bf16 backward (the models' compute_dtype=bfloat16 in training): the same
// kernel with In = bf16. It reads the bf16 packed weights and widens them
// to f32 once per launch (into registers, or f32 rows in shared memory),
// reads dys and ys as bf16 and widens them at the load, reads the f32
// gates the bf16 training forward wrote, keeps the carry, the exchanges
// and every sum f32, and rounds dgx and dcx to bf16 once, at the store
// (nearest even). The state it reads for h[t-1] is the widened bf16 ys,
// what the forward returns (no f32 copy of h is kept);
// ops/cuda_kernels.py gru_scan_backward_plain reads the same.

#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap; cuTensorMapEncodeTiled comes through the runtime's entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxH = 512;
constexpr int kMaxCluster = 16;      // above 8 needs the non-portable cluster size
constexpr int kPortableCluster = 8;
constexpr int kMaxThreads = 512;
constexpr int kL = 8;                // lanes per unit

// Probe builds. gru_scan_sweep.py --attribute compiles this file with
// -DSCL_PROBE=<bits> to time a step with one part taken out (the results are
// then wrong); the package's own build leaves SCL_PROBE at 0, where every
// probe branch compiles away. The staged instances' steps touch no device
// memory and their stage copies run in every build, so kProbeGlobal leaves
// them as they are.
#ifndef SCL_PROBE
#define SCL_PROBE 0
#endif
constexpr int kProbe = SCL_PROBE;
constexpr int kProbeWeights = 1;    // weight operands from a register, not shared memory
constexpr int kProbeWiden = 2;      // bf16 weights loaded from shared memory but not widened
constexpr int kProbeShuffle = 4;    // no team reductions
constexpr int kProbeGlobal = 8;     // no device-memory loads or stores inside the scan
constexpr int kProbeProducts = 16;  // no products at all (nor their loads)

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

// Shared-memory layout of the f32 forward, in floats: 4 mbarriers (8 bytes
// each: r*h and h, two buffers each), hT [2][H][R], rhT [2][H][R], then the
// weights [3*Hc][stride] of `wbytes` bytes each; each region starts on 16
// bytes. Mirrors ops/cuda_kernels.py gru_scan_smem_bytes.
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

// An f32 weight operand from shared memory, or what a probe build puts there.
__device__ __forceinline__ float weight_operand(const float* p, float probe_w) {
  if constexpr ((kProbe & kProbeWeights) != 0) return probe_w;
  else return *p;
}

// Output rounding and non-coherent loads, per type.
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
// for N weight rows (f32 rows in shared memory); two interleaved sets of sums
// for more FMAs in flight.
template <int R, int N, typename W>
__device__ __forceinline__ void lane_sums(const float* __restrict__ vT,
                                          const W* const (&w)[N], int H, int lane,
                                          float (&s)[N][R]) {
  if constexpr ((kProbe & kProbeProducts) != 0) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int r = 0; r < R; ++r) s[n][r] = 0.0f;
    return;
  }
  const float pw = 1e-3f * (float)(lane + 1);   // the weights probe's operand
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
        const float wv = weight_operand(wp[n] + x * kL, pw);
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
      const float wv = weight_operand(wp[n], pw);
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
  if constexpr ((kProbe & kProbeShuffle) != 0) return;
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

// The Tensor Memory Accelerator (the staged kernels): a box of a 4-D tensor
// map at (c0, c1, c2, c3) into shared memory at `dst`, completing its bytes
// on `bar`; a box from shared memory at `src` out to the map, in the current
// bulk group; the group's commit, the wait until every earlier group has read
// its shared memory, and the wait until every group has written.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                          uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3, %4}], [%5];" ::
          "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_written() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// This thread's shared-memory writes before it, to the async proxy (the bulk stores).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A bf16 of a stage widened (the high half of an f32), and an output rounded
// into one (nearest even).
__device__ __forceinline__ float stage_bf16(const char* p) {
  return __uint_as_float((uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
}
__device__ __forceinline__ void stage_bf16(char* p, float v) {
  *reinterpret_cast<unsigned short*>(p) = __bfloat16_as_ushort(__float2bfloat16_rn(v));
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

// The shared-memory f32 forward. Its callers (scl_gru_scan_f32 through
// launch_checked) are the f32 plans without a register column class: every
// form past H = 256, a cluster size whose CTAs pass the register instances'
// launch bounds (512 threads at 16 or 32 columns: H = 128 over 2 CTAs, H =
// 256 over 4), and the training forward's spilling rows (4 | 8, 32). kFull:
// the stacked directions and the gates output. Without it (the inference
// scan of one direction) both compile away: dir is 0, step t is time t and
// nothing is stored but ys.
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
    if ((kProbe & kProbeGlobal) == 0 && live && !last) {
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
    if ((kProbe & kProbeGlobal) == 0 && live && lane < R) {
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

// ------------------------------------------------ weights held in registers ---
//
// The register forward and the backward hold their weights in registers:
// lane l of the team of unit j holds k = l, l + kL, ... of unit j's three
// rows, NK of each, as f32. NK is a column class, the least of 5, 8, 16, 32
// that is >= ceil(H / kL) (past H the weights are zero, and so are the
// exchanged vectors' pad rows). NK = 0: the weights stay in shared memory
// (H > 256, more threads than the class's launch bounds, or an instance
// that spills).

// Which (R, NK) instances of the register forward (kBwd false) and the
// backward hold their weights in registers, and the CTAs per SM each is
// compiled for (its __launch_bounds__: the register budget of a thread is
// 65536 over threads times CTAs): the pairs where ptxas -v reports no spill
// on sm_90a. The rest take a shared-memory instance (NK = 0). A CTA has at
// most 256 threads from NK = 16 on. The forward's (4, 16) keeps its
// candidate rows in shared memory (as f32) and the r and u rows in
// registers: with all three the bf16 one spilled at two CTAs to an SM,
// which the batch's H = 128 scans (B = 236) need. The training forward
// (`gates`, kGates, either operand type) keeps r and u live to the store:
// its (4|8, 32) spill (48 and 84 bytes of spill stores and loads, in
// either operand type), so they take a shared-memory instance. The staged
// instances (`staged`, bf16; no next-step registers, no device addresses)
// also compile the training forward's (4, 32) and the backward's (2, 32)
// without a spill (the latter with its inputs read at the point of use;
// read ahead it spilled). The inference forward (no gates live), staged or
// not, bf16 or (unstaged) f32, compiles every (R, NK) without a spill; the
// unstaged (4|8, 32) keep their candidate rows in shared memory as (4, 16)
// does (with all three rows in registers and two sets of sums at every R,
// reg_sums kTwoSets, they spilled 12 and 24 bytes). Mirrors
// ops/cuda_kernels.py _reg_instance.
__host__ __device__ constexpr int reg_max_threads(int NK) { return NK >= 16 ? 256 : kMaxThreads; }
__host__ __device__ constexpr bool reg_instance(bool bwd, int R, int NK, bool gates = false,
                                                bool staged = false) {
  return NK > 0 && !(bwd && NK == 32 && R >= (staged ? 4 : 2)) &&
         !(gates && NK == 32 && R >= (staged ? 8 : 4));
}
__host__ __device__ constexpr bool cand_in_smem(int R, int NK, bool gates, bool staged) {
  return (NK == 16 && R == 4) || (NK == 32 && R >= 4 && !gates && !staged);
}
__host__ __device__ constexpr int reg_min_ctas(bool bwd, int R, int NK) {
  return NK == 16 && R <= (bwd ? 1 : 4) ? 2 : 1;
}

// The column class of width H for R rows and CTAs of `threads` threads; 0:
// shared memory. Mirrors ops/cuda_kernels.py gru_reg_columns.
__host__ __device__ inline int reg_columns(bool bwd, int H, int R, int threads,
                                           bool gates = false, bool staged = false) {
  const int n = (H + kL - 1) / kL;
  const int nk = n <= 5 ? 5 : n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : 0;
  return reg_instance(bwd, R, nk, gates, staged) && threads <= reg_max_threads(nk) ? nk : 0;
}

// Rows of the exchanged vectors: NK * kL with the weights in registers, H
// rounded up to even (whole bf16 pairs) with them in shared memory.
__host__ __device__ inline int padded_h(int H, int NK) { return NK > 0 ? NK * kL : H + (H & 1); }

// The row of unit k in the register forward's vectors: k itself, or with bf16
// pairs in shared memory (NK = 0) split by parity, [2][Hp / 2].
template <int NK>
__device__ __forceinline__ int pair_row(int k, int hp) {
  return NK > 0 ? k : (k & 1) * (hp >> 1) + (k >> 1);
}

// ------------------------------------------------------ staging by the TMA ---
//
// The staged instances (gru_scan_reg_staged_kernel, every bf16 forward
// form: the inference forward of one direction or both, the training
// forward; gru_scan_bwd_staged_kernel, the bf16 backward; where the plan
// gives a stage depth S) keep device memory out of the step. Their inputs
// and outputs move between device memory and a ring of kRing slots in
// shared memory by the Tensor Memory Accelerator, S steps a slot; each slot
// holds, for the CTA's R rows and Hc units, S steps of every input and
// output: boxes [S][R][Hc] of bf16 or f32 (StageLayout). Thread 0 fills and
// drains the ring: tensor-map loads completing on the slot's mbarrier, bulk
// tensor stores in one bulk group a stage. A stage is a block of S times
// starting at a multiple of S, walked up or (direction 1 of the forward,
// direction 0 of the backward) down; a box's elements past T or B are
// zero-filled on the load and dropped on the store, so the ragged time
// block (T mod S) and row tile (B mod R) take no path of their own, and the
// backward's h[t-1] box, one step behind dy's, starts at -1 for the block at
// time 0 (a zero there). No store box starts before time 0: on the H100 one
// that did (the backward's last block when it started at T - S) faulted
// with an illegal instruction. A step reads its operands from the slot (a
// bf16 widened by a shift) and rounds its outputs into it; no step touches
// device memory. The forward reads them at the point of use; the backward
// too, except with one row and 32 register columns (`bwd_read_ahead`),
// where it reads them in the previous step's first exchange window and the
// eight CTAs' wait hides the read (timed both ways on the H100 at B = 32,
// T = 400: reading ahead paid off there and cost time at H = 40 and 128).
//
// Stage k (slot k % 2) of a kernel's walk over the steps:
//  - its inputs are loaded at the first step of stage k - 1 (stages 0 and 1
//    before the first step); every thread waits on the slot's mbarrier at
//    the stage's first step;
//  - at its last step each thread fences its output writes to the async
//    proxy, thread 0 waits until the bulk stores issued before have read
//    their slot, and the CTA meets at __syncthreads: the slot's inputs are
//    read, its outputs written, the other slot's outputs free;
//  - at the first step of stage k + 1, between a send and its exchange's
//    wait (where the chain waits anyway), thread 0 stores stage k's outputs
//    and loads stage k + 2's inputs into the same slot.
// Staging needs tensor-map rows and boxes of whole 16 bytes: bf16 rows of H
// and boxes of H / C units, so H a multiple of 8 C (`stageable`).
constexpr int kRing = 2;

__host__ __device__ constexpr bool stageable(int H, int C) { return H % (kL * C) == 0; }
__host__ __device__ constexpr bool bwd_read_ahead(int R, int NK) { return NK >= 32 && R == 1; }

// One slot's boxes, [S][R][Hc] each, every one on 128 bytes (the TMA's
// alignment): the forward's inputs gx's r half, its u half, cx, its output
// ys (bf16) and with `gates` (the training forward) r, u, c (f32); the
// backward's inputs dy, h[t-1]
// (bf16), r, u, c (f32), its outputs dcx, dgx's r half, its u half (bf16).
// Offsets and sizes in bytes. Mirrors ops/cuda_kernels.py gru_stage_slot_bytes.
struct StageLayout {
  static constexpr int kMaxBoxes = 8;
  uint32_t box[kMaxBoxes];
  uint32_t in_bytes, slot_bytes;
  __host__ __device__ StageLayout(bool bwd, bool gates, int S, int R, int Hc) {
    const int fwd_sizes[7] = {2, 2, 2, 2, 4, 4, 4}, bwd_sizes[8] = {2, 2, 4, 4, 4, 2, 2, 2};
    const int n = bwd ? 8 : gates ? 7 : 4, n_in = bwd ? 5 : 3;
    const uint32_t elems = (uint32_t)S * R * Hc;
    uint32_t off = 0;
    in_bytes = 0;
    for (int i = 0; i < kMaxBoxes; ++i) {
      box[i] = off;
      if (i >= n) continue;
      const uint32_t bytes = elems * (bwd ? bwd_sizes[i] : fwd_sizes[i]);
      if (i < n_in) in_bytes += bytes;
      off += (bytes + 127) & ~127u;
    }
    slot_bytes = off;
  }
};

// The staged kernels' tensor maps, encoded on the host per launch: each over
// a [dirs, T, B, width] operand as (width, B, T, dirs), boxes (Hc, R, S, 1).
// Forward: gx, cx, ys, gates; backward: dys, ys, gates, dgx, dcx.
struct StageMaps {
  CUtensorMap m[5];
};

// Shared memory of the register forward, in floats: 4 mbarriers (6 staged:
// the ring's two), h [2][Hp][R], r*h [2][Hp][R], and with NK = 0 (bf16 only)
// the weights as bf16 pairs [3*Hc][weight_stride(ceil(H/2))] words, with
// cand_in_smem the candidate rows [Hc][weight_stride(H)] f32; staged (S > 0),
// from the next 128 bytes the ring, kRing slots of StageLayout (the form's
// boxes, with or without `gates`). Mirrors ops/cuda_kernels.py
// gru_scan_smem_bytes(..., elem_bytes=2, stage_steps=S), and with
// elem_bytes=4 its f32 forward where a column class serves it.
struct LayoutReg {
  size_t bars, h, rh, w, ring, total;
  int hp;
  __host__ __device__ LayoutReg(int H, int C, int R, int NK, int S, bool gates) {
    const int Hc = (H + C - 1) / C;
    hp = padded_h(H, NK);
    bars = 0;
    h = bars + (S > 0 ? 16 : 8);
    rh = h + 2 * round4((size_t)hp * R);
    w = rh + 2 * round4((size_t)hp * R);
    total = w + (NK == 0 ? round4((size_t)3 * Hc * weight_stride((H + 1) / 2))
                 : cand_in_smem(R, NK, gates, S > 0) ? round4((size_t)Hc * weight_stride(H))
                                                      : 0);
    ring = (total + 31) & ~(size_t)31;
    if (S > 0) total = ring + kRing * StageLayout(false, gates, S, R, Hc).slot_bytes / 4;
  }
};

// Shared memory of the backward, in floats: 4 mbarriers (6 staged), [dcx,
// dgu] [2][Hp][2R] (per unit dcx's R rows, then dgu's), dgr [2][Hp][R], and
// only with NK = 0 the weight rows [3*Hc][weight_stride(H)] f32; staged, the
// ring as in LayoutReg. Mirrors ops/cuda_kernels.py gru_scan_smem_bytes(...,
// backward=True).
struct LayoutBwd {
  size_t bars, a, g, w, ring, total;
  int hp;
  __host__ __device__ LayoutBwd(int H, int C, int R, int NK, int S = 0) {
    const int Hc = (H + C - 1) / C;
    hp = padded_h(H, NK);
    bars = 0;
    a = bars + (S > 0 ? 16 : 8);
    g = a + 2 * round4((size_t)hp * 2 * R);
    w = g + 2 * round4((size_t)hp * R);
    total = w + (NK > 0 ? 0 : round4((size_t)3 * Hc * weight_stride(H)));
    ring = (total + 31) & ~(size_t)31;
    if (S > 0) total = ring + kRing * StageLayout(true, false, S, R, Hc).slot_bytes / 4;
  }
};

// This lane's k = lane + kL*i of one weight row (H values), widened to f32,
// zero past H.
template <int NK, typename In>
__device__ __forceinline__ void load_lane_row(const In* src, int H, int lane, float (&w)[NK]) {
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const int k = lane + kL * i;
    w[i] = k < H ? load_nc(src + k) : 0.0f;
  }
}

template <int N, int R>
__device__ __forceinline__ void zero(float (&a)[N][R]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int r = 0; r < R; ++r) a[n][r] = 0.0f;
}

// s[n][r] = sum over this lane's k = lane + kL*i (i < NK) of w[n][i] times
// row r of the vector: N weight rows against one vector (V = 1, x [Hp][R])
// or each against its own (V = N, x [Hp][N*R], row n's R values at n*R).
// One shared-memory read of V*R floats feeds N*R FMAs. The sums go into A
// sets, i % A, added in order at the end: two where N*R < 4 (enough
// independent FMAs in flight), else one; kTwoSets: two at every R (the
// inference forward), so a row's sums, and the scan's output, do not
// depend on the rows its cluster holds: a clip converted in a batch gets
// the bits of its single conversion, and at R = 1 both are the
// shared-memory kernel's (lane_sums: two sets, i % 2).
template <int R, int N, int V, int NK, bool kTwoSets = false>
__device__ __forceinline__ void reg_sums(const float* __restrict__ x, const float (&w)[N][NK],
                                         int lane, float (&s)[N][R]) {
  static_assert(V == 1 || V == N, "one vector, or one per row");
  constexpr int A = kTwoSets || N * R < 4 ? 2 : 1;
  float a[A][N][R];
#pragma unroll
  for (int q = 0; q < A; ++q) zero(a[q]);
  if constexpr ((kProbe & kProbeProducts) == 0) {
    const float* xp = x + (size_t)lane * V * R;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      float v[V * R];
      load_rows<V * R>(xp + (size_t)i * kL * V * R, v);
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int r = 0; r < R; ++r)
          a[i % A][n][r] = fmaf(v[(V == 1 ? 0 : n * R) + r], w[n][i], a[i % A][n][r]);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[n][r] = a[0][n][r];
#pragma unroll
      for (int q = 1; q < A; ++q) s[n][r] += a[q][n][r];
    }
}

// reg_sums with f32 weight rows in shared memory (w[n][k], k < H): one set,
// or with kTwoSets reg_sums' two (k = lane + kL*i into set i % 2).
template <int R, int N, int V, bool kTwoSets = false>
__device__ __forceinline__ void smem_sums(const float* __restrict__ x,
                                          const float* const (&w)[N], int H, int lane,
                                          float (&s)[N][R]) {
  zero(s);
  if constexpr ((kProbe & kProbeProducts) != 0) return;
  const float pw = 1e-3f * (float)(lane + 1);   // the weights probe's operand
  auto add = [&](float (&a)[N][R], int k) {     // column k into the set a
    float v[V * R];
    load_rows<V * R>(x + (size_t)k * V * R, v);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float wv = weight_operand(w[n] + k, pw);
#pragma unroll
      for (int r = 0; r < R; ++r) a[n][r] = fmaf(v[(V == 1 ? 0 : n * R) + r], wv, a[n][r]);
    }
  };
  if constexpr (kTwoSets) {
    float b[N][R];
    zero(b);
#pragma unroll 2
    for (int k = lane; k < H; k += 2 * kL) {
      add(s, k);
      if (k + kL < H) add(b, k + kL);
    }
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int r = 0; r < R; ++r) s[n][r] += b[n][r];
  } else {
#pragma unroll 4
    for (int k = lane; k < H; k += kL) add(s, k);
  }
}

// reg_sums (V = 1) with bf16 weight pairs in shared memory: word m of row n
// holds k = 2m in its low half and 2m + 1 in its high one, widened by a
// shift and a mask; m < Hw words. The vector x is split by the parity of k
// ([2][Hw][R], pair_row), so each lane's reads of k = 2m and 2m + 1 are
// contiguous across the team's lanes (no bank conflict at R >= 4).
template <int R, int N>
__device__ __forceinline__ void pair_sums(const float* __restrict__ x,
                                          const uint32_t* const (&w)[N], int Hw, int lane,
                                          float (&s)[N][R]) {
  zero(s);
  if constexpr ((kProbe & kProbeProducts) != 0) return;
  const float pw = 1e-3f * (float)(lane + 1);   // the weights probe's operand
#pragma unroll 4
  for (int m = lane; m < Hw; m += kL) {
    float ve[R], vo[R];                           // rows k = 2m, 2m + 1
    load_rows<R>(x + (size_t)m * R, ve);
    load_rows<R>(x + (size_t)(Hw + m) * R, vo);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float lo = pw, hi = pw;
      if constexpr ((kProbe & kProbeWeights) == 0) {
        const uint32_t wd = w[n][m];
        lo = __uint_as_float((kProbe & kProbeWiden) != 0 ? wd : wd << 16);
        hi = __uint_as_float((kProbe & kProbeWiden) != 0 ? wd : wd & 0xffff0000u);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) s[n][r] = fmaf(vo[r], hi, fmaf(ve[r], lo, s[n][r]));
    }
  }
}

// This CTA's bf16 weight slice [3*Hc][H] as word pairs [3*Hc][ld] (a
// pair's high half zero past H), from device memory once per launch.
__device__ __forceinline__ void load_weight_pairs(uint32_t* ws, const __nv_bfloat16* src, int H,
                                                  int Hc, int ld, int tid, int nt) {
  const int Hw = (H + 1) / 2;
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  for (int i = tid; i < 3 * Hc * Hw; i += nt) {
    const int row = i / Hw, m = i - row * Hw, k = 2 * m;
    const uint32_t lo = __ldg(s16 + (size_t)row * H + k);
    const uint32_t hi = k + 1 < H ? __ldg(s16 + (size_t)row * H + k + 1) : 0u;
    ws[(size_t)row * ld + m] = lo | (hi << 16);
  }
}

// The team's R values of a and of b for unit j0 + j into `buf` ([Hp][2R]:
// a's R rows, then b's) of every CTA, one send of 2R floats per peer.
template <int R>
__device__ __forceinline__ void exchange2(float a, float b, float* buf, uint32_t bar, int j0,
                                          int j, int nu, int lane, int C) {
  if (C == 1) {
    if (j < nu && lane < R) {
      buf[(size_t)(j0 + j) * 2 * R + lane] = a;
      buf[(size_t)(j0 + j) * 2 * R + R + lane] = b;
    }
    return;
  }
  float v[2 * R];
  const int base = (threadIdx.x & 31) & ~(kL - 1);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = __shfl_sync(0xffffffffu, a, base + r);
    v[R + r] = __shfl_sync(0xffffffffu, b, base + r);
  }
  if (j < nu) {
    const uint32_t addr = smem_u32(buf + (size_t)(j0 + j) * 2 * R);
    for (int d = lane; d < C; d += kL) send_rows<2 * R>(map_rank(addr, d), v, map_rank(bar, d));
  }
}

// The register forward: gx, cx, wpack, ys of type In (bf16:
// scl_gru_scan_bf16, ys rounded to nearest even; f32: scl_gru_scan_f32
// where a column class serves the form, nothing rounded); the weights read
// (and widened) to f32 once per launch into registers (NK > 0) or, bf16
// only, kept as bf16 pairs in shared memory (NK = 0); h, r*h, the exchanges
// and the sums f32. The steps of gru_scan_kernel, with its directions.
// kGates (the training forward): also r, u, c of each step into `gates`
// [dirs, T, B, 3H] f32; without it `gates` is not read, nothing but ys
// is stored, and the sums take two sets at every R (the inference
// instances; reg_sums kTwoSets). kStaged (bf16, NK > 0;
// gru_scan_reg_staged_kernel, every form): the inputs and outputs go
// through the ring of stages (`maps`, S steps a stage) instead of
// device-memory loads and stores in the step.
template <typename In, int R, int NK, bool kGates, bool kStaged>
__device__ __forceinline__ void reg_forward(float* smem, const In* __restrict__ gx,
                                            const In* __restrict__ cx,
                                            const In* __restrict__ wpack, In* __restrict__ ys,
                                            float* __restrict__ gates, int* __restrict__ sm_ids,
                                            int T, int B, int H, int C, int nclus,
                                            const StageMaps* maps, int S) {
  static_assert(!kStaged || (NK > 0 && std::is_same_v<In, __nv_bfloat16>),
                "staged: bf16 with a column class");
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Hc = (H + C - 1) / C;
  const int rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int cl = blockIdx.x / C;
  const int dir = cl / nclus;   // direction 1 runs time backwards
  const int row0 = (cl - dir * nclus) * R;
  const int j0 = rank * Hc;
  const size_t TB = (size_t)T * B;
  gx += dir * TB * 2 * H;
  cx += dir * TB * H;
  ys += dir * TB * H;
  wpack += (size_t)dir * C * 3 * Hc * H;
  if (kGates) gates += dir * TB * 3 * H;
  auto tix = [=](int t) { return (size_t)(dir ? T - 1 - t : t); };   // step -> time
  const int nu = max(0, min(Hc, H - j0));
  const LayoutReg lay(H, C, R, NK, kStaged ? S : 0, kGates);
  const size_t hr = round4((size_t)lay.hp * R);   // buffer b of h: smem + lay.h + b * hr
  // r*h: bar0 + 8b; h: bar0 + 16 + 8b; staged, the ring's slot b: bar0 + 32 + 8b
  const uint32_t bar0 = smem_u32(smem + lay.bars);
  const uint32_t phase_bytes = (uint32_t)(H * R * sizeof(float));
  const int Hw = (H + 1) / 2, ld = weight_stride(Hw);

  if (sm_ids != nullptr && tid == 0) {
    unsigned int s;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
    sm_ids[blockIdx.x] = (int)s;
  }
  // the ring: stage k of the walk over the steps holds the time block
  // [t0, t0 + S), t0 a multiple of S (direction 1 walks the blocks down from
  // the ragged last one); `stage_load`, `stage_store` are thread 0's
  const StageLayout st(false, kGates, kStaged ? S : 1, R, Hc);
  char* const ring = reinterpret_cast<char*>(smem + lay.ring);
  const int n_stages = kStaged ? (T + S - 1) / S : 0;
  auto t0_of = [=](int k) { return (dir ? n_stages - 1 - k : k) * S; };
  auto stage_load = [&](int k) {   // gx's r and u halves, cx
    const uint32_t slot = smem_u32(ring + (k & 1) * st.slot_bytes), bar = bar0 + 32 + 8 * (k & 1);
    const int t0 = t0_of(k);
    mbar_expect(bar, st.in_bytes);
    tma_load(slot + st.box[0], &maps->m[0], j0, row0, t0, dir, bar);
    tma_load(slot + st.box[1], &maps->m[0], H + j0, row0, t0, dir, bar);
    tma_load(slot + st.box[2], &maps->m[1], j0, row0, t0, dir, bar);
  };
  auto stage_store = [&](int k) {   // ys; training, r, u, c
    const uint32_t slot = smem_u32(ring + (k & 1) * st.slot_bytes);
    const int t0 = t0_of(k);
    tma_store(&maps->m[2], j0, row0, t0, dir, slot + st.box[3]);
    if constexpr (kGates) {
      tma_store(&maps->m[3], j0, row0, t0, dir, slot + st.box[4]);
      tma_store(&maps->m[3], H + j0, row0, t0, dir, slot + st.box[5]);
      tma_store(&maps->m[3], 2 * H + j0, row0, t0, dir, slot + st.box[6]);
    }
    bulk_commit();
  };
  if ((C > 1 || kStaged) && tid == 0) {
    for (int i = 0; i < (kStaged ? 6 : 4); ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if constexpr (kStaged) {
      stage_load(0);
      if (n_stages > 1) stage_load(1);
    }
  }
  for (size_t i = tid; i < 4 * hr; i += nt) smem[lay.h + i] = 0.0f;   // h0 and every pad row

  const int j = tid / kL, lane = tid % kL;   // team j owns unit j0 + j
  const int jr = min(j, Hc - 1);             // teams past Hc sum a valid row and drop it
  const int q = lane % R;                    // the row this lane finishes
  const int row = row0 + q;
  const bool live = j < nu && row < B;
  // this unit's row of the vectors; exchange() targets row j0 + j, so its
  // buffers are passed shifted by the difference
  const int vrow = pair_row<NK>(j0 + jr, lay.hp), shift = (vrow - (j0 + jr)) * R;
  const size_t e = (size_t)vrow * R + q;
  const In* wsrc = wpack + (size_t)rank * 3 * Hc * H;
  constexpr bool kCandRegs = NK > 0 && !cand_in_smem(R, NK, kGates, kStaged);
  constexpr int NR = NK > 0 ? NK : 1;
  float wg[2][NR] = {}, wc[1][kCandRegs ? NR : 1] = {};   // rows r, u; candidate
  const uint32_t* ws = reinterpret_cast<const uint32_t*>(smem + lay.w);
  const uint32_t* const pg[2] = {ws + (size_t)jr * ld, ws + (size_t)(Hc + jr) * ld};
  const uint32_t* const pc[1] = {ws + (size_t)(2 * Hc + jr) * ld};
  const int ldf = weight_stride(H);           // candidate rows in f32 (cand_in_smem)
  const float* const pcf[1] = {smem + lay.w + (size_t)jr * ldf};
  if constexpr (NK > 0) {
    load_lane_row<NK>(wsrc + (size_t)jr * H, H, lane, wg[0]);
    load_lane_row<NK>(wsrc + (size_t)(Hc + jr) * H, H, lane, wg[1]);
    if constexpr (kCandRegs) {
      load_lane_row<NK>(wsrc + (size_t)(2 * Hc + jr) * H, H, lane, wc[0]);
    } else {
      for (int i = tid; i < Hc * H; i += nt) {
        const int r = i / H, k = i - r * H;
        smem[lay.w + (size_t)r * ldf + k] = load_nc(wsrc + (size_t)(2 * Hc + r) * H + k);
      }
    }
  } else {
    static_assert(std::is_same_v<In, __nv_bfloat16>, "f32 weights are not kept as pairs");
    load_weight_pairs(reinterpret_cast<uint32_t*>(smem + lay.w), wsrc, H, Hc, ld, tid, nt);
  }
  // this lane's element of the current step in cx and ys, a 32-bit offset
  // moving by cs a step (fewer registers than pointers); in gx 2 co - unit
  const int unit = j0 + j, cs = dir ? -B * H : B * H;
  int co = ((int)tix(0) * B + row) * H + unit;
  float xa[3] = {0.0f, 0.0f, 0.0f}, xb[3] = {0.0f, 0.0f, 0.0f};   // gx's r, u; cx
  if (!kStaged && live && T > 0) {
    xa[0] = load_nc(gx + 2 * co - unit);
    xa[1] = load_nc(gx + 2 * co - unit + H);
    xa[2] = load_nc(cx + co);
  }
  // staged: the lane's place in the ring, stage k (slot k % 2) with `left`
  // steps left in it, the byte of the lane's element in a bf16 box of the
  // slot (x; in an f32 box 2x), moving by dx a step
  const int row_bytes = R * Hc * 2, dx = dir ? -row_bytes : row_bytes, lane_x = (q * Hc + j) * 2;
  int k = 0, left = 0, x = 0;
  bool first = true;
  auto enter = [&](int kk) {   // stage kk's first step
    const int t0 = t0_of(kk), len = min(T - t0, S);
    left = len;
    x = (dir ? len - 1 : 0) * row_bytes + lane_x;
  };
  if (kStaged) enter(0);
  // weights, h0 and the mbarriers in place; every CTA of the cluster running
  if (C > 1) cluster.sync(); else __syncthreads();

  // Step t, its buffers' parity a constant. Unstaged, `in` holds its inputs
  // and the next step's go into `next`; the loop runs two steps a round with
  // the sets swapped, so no step ends copying a load still in flight (the
  // copy would wait for it). Staged, both are unused: the step reads its
  // slot.
  auto step = [&](auto parity, int t, const float (&in)[3], float (&next)[3]) {
    constexpr int cur = decltype(parity)::value, nxt = cur ^ 1;
    const bool last = t + 1 == T;
    const float* h_cur = smem + lay.h + cur * hr;
    float* h_nxt = smem + lay.h + nxt * hr;
    float* rh_cur = smem + lay.rh + cur * hr;
    const uint32_t bar_rh = bar0 + 8 * cur, bar_h_cur = bar0 + 16 + 8 * cur,
                   bar_h_nxt = bar0 + 16 + 8 * nxt;
    char* const slot = ring + (k & 1) * st.slot_bytes;   // staged: the step's slot
    if constexpr (kStaged)
      if (first) mbar_wait(bar0 + 32 + 8 * (k & 1), (k >> 1) & 1);
    if (C > 1) {
      if (t > 0) mbar_wait(bar_h_cur, ((t - 1) >> 1) & 1);   // h of step t-1
      if (tid == 0) {
        mbar_expect(bar_rh, phase_bytes);
        if (!last) mbar_expect(bar_h_nxt, phase_bytes);
      }
    }

    // the step's inputs: staged, read from the slot here, ahead of the
    // products they wait behind
    const float xr = kStaged ? stage_bf16(slot + st.box[0] + x) : in[0];
    const float xu = kStaged ? stage_bf16(slot + st.box[1] + x) : in[1];
    const float xc = kStaged ? stage_bf16(slot + st.box[2] + x) : in[2];

    // (a) gates over h, then r*h of this unit into every CTA
    float sg[2][R];
    if constexpr (NK > 0) reg_sums<R, 2, 1, NK, !kGates>(h_cur, wg, lane, sg);
    else pair_sums<R, 2>(h_cur, pg, Hw, lane, sg);
    team_sum<R, 2>(sg);
    const float rg = sigmoid_f32(xr + pick<R>(sg[0], q));
    const float u = sigmoid_f32(xu + pick<R>(sg[1], q));
    exchange<R>(rg * h_cur[e], rh_cur + shift, bar_rh, j0, j, nu, lane, C);
    if constexpr (kStaged) {
      // the ring while the peers' r*h arrive: stage k - 1 out, k + 1 in
      if (tid == 0 && first && k > 0) {
        stage_store(k - 1);
        if (k + 1 < n_stages) stage_load(k + 1);
      }
    } else {
      // the next step's inputs while the peers' r*h arrive (device-memory
      // traffic issued ahead of a send would delay it)
      next[0] = next[1] = next[2] = 0.0f;
      if ((kProbe & kProbeGlobal) == 0 && live && !last) {
        const int cn = co + cs;
        next[0] = load_nc(gx + 2 * cn - unit);
        next[1] = load_nc(gx + 2 * cn - unit + H);
        next[2] = load_nc(cx + cn);
      }
    }
    if (C > 1) mbar_wait(bar_rh, (t >> 1) & 1); else __syncthreads();

    // (c) candidate over r*h, new h into ys[t] and every CTA
    float sc[1][R];
    if constexpr (kCandRegs) reg_sums<R, 1, 1, NK, !kGates>(rh_cur, wc, lane, sc);
    else if constexpr (NK > 0) smem_sums<R, 1, 1, !kGates>(rh_cur, pcf, H, lane, sc);
    else pair_sums<R, 1>(rh_cur, pc, Hw, lane, sc);
    team_sum<R, 1>(sc);
    const float c = tanh_f32(xc + pick<R>(sc[0], q));
    const float hn = u * h_cur[e] + (1.0f - u) * c;
    if (!last) exchange<R>(hn, h_nxt + shift, bar_h_nxt, j0, j, nu, lane, C);
    if constexpr (kStaged) {
      if (lane < R) {   // rows past B are dropped by the store
        stage_bf16(slot + st.box[3] + x, hn);
        if constexpr (kGates) {
          *reinterpret_cast<float*>(slot + st.box[4] + 2 * x) = rg;
          *reinterpret_cast<float*>(slot + st.box[5] + 2 * x) = u;
          *reinterpret_cast<float*>(slot + st.box[6] + 2 * x) = c;
        }
      }
    } else if ((kProbe & kProbeGlobal) == 0 && live && lane < R) {
      store_out(ys + co, hn);
      if constexpr (kGates) {   // gates' element of (time, row, unit): 3 co - 2 unit
        float* g = gates + 3 * co - 2 * unit;
        g[0] = rg; g[H] = u; g[2 * H] = c;
      }
    }
    if (C == 1) __syncthreads();
    if constexpr (kStaged) {
      first = false;
      if (--left == 0) {   // the stage's last step
        fence_async_shared();
        if (tid == 0) bulk_wait_read();
        __syncthreads();
        if (++k < n_stages) {
          enter(k);
          first = true;
        }
      } else {
        x += dx;
      }
    } else {
      co += cs;
    }
  };
  for (int t = 0; t < T; t += 2) {
    step(std::integral_constant<int, 0>{}, t, xa, xb);
    if (t + 1 < T) step(std::integral_constant<int, 1>{}, t + 1, xb, xa);
  }
  if constexpr (kStaged) {
    if (tid == 0) {
      stage_store(n_stages - 1);
      bulk_wait_written();
    }
  }
  if (C > 1) cluster.sync();   // no CTA leaves while a peer may still address it
}

template <typename In, int R, int NK, bool kGates>
__global__ void __launch_bounds__(reg_max_threads(NK), reg_min_ctas(false, R, NK))
gru_scan_reg_kernel(const In* __restrict__ gx, const In* __restrict__ cx,
                    const In* __restrict__ wpack, In* __restrict__ ys,
                    float* __restrict__ gates, int* __restrict__ sm_ids, int T, int B, int H,
                    int C, int nclus) {
  extern __shared__ __align__(16) float smem[];
  reg_forward<In, R, NK, kGates, false>(smem, gx, cx, wpack, ys, gates, sm_ids, T, B, H, C, nclus,
                                        nullptr, 0);
}

// The bf16 register forward staged through shared memory (S steps a
// stage): the inference forward of one direction or both, and the training
// forward (kGates).
template <int R, int NK, bool kGates>
__global__ void __launch_bounds__(reg_max_threads(NK), reg_min_ctas(false, R, NK))
gru_scan_reg_staged_kernel(const __nv_bfloat16* __restrict__ gx,
                           const __nv_bfloat16* __restrict__ cx,
                           const __nv_bfloat16* __restrict__ wpack,
                           __nv_bfloat16* __restrict__ ys, float* __restrict__ gates,
                           int* __restrict__ sm_ids, int T, int B, int H, int C, int nclus,
                           const __grid_constant__ StageMaps maps, int S) {
  extern __shared__ __align__(128) float smem_staged[];
  reg_forward<__nv_bfloat16, R, NK, kGates, true>(smem_staged, gx, cx, wpack, ys, gates, sm_ids,
                                                  T, B, H, C, nclus, &maps, S);
}

// This CTA's weight rows [3*Hc][H] as f32 rows [3*Hc][ld] in shared memory,
// once per launch: copied (f32) or widened (bf16).
template <typename In>
__device__ __forceinline__ void load_weights_f32(float* ws, const In* src, int H, int Hc, int ld,
                                                 int tid, int nt) {
  if constexpr (std::is_same_v<In, float>) {
    load_weights<float>(ws, src, H, Hc, ld, tid, nt);
  } else {
    for (int i = tid; i < 3 * Hc * H; i += nt) {
      const int row = i / H, k = i - row * H;
      ws[(size_t)row * ld + k] = load_nc(src + i);
    }
  }
}

// dys, ys [dirs, T, B, H]; gates [dirs, T, B, 3H] f32 (r, u, c from the
// forward); wpack [dirs, C, 3*Hc, H] from pack_gru_weights_bwd (row g*Hc + i
// of CTA c: row c*Hc + i of Wg_h's r half, its u half, Wc_h); out dgx
// [dirs, T, B, 2H], dcx [dirs, T, B, H]. dys, ys, wpack, dgx and dcx are
// In (f32 or bf16: widened at the load, rounded at the store). Direction
// 1's forward ran time backwards, so its backward runs time forwards.
// Weights in registers (NK > 0) or shared memory (NK = 0), f32 either way.
// kStaged (bf16, NK > 0; gru_scan_bwd_staged_kernel): the operands go
// through the ring of stages (`maps`, S steps a stage), h[t-1] a box one
// step behind dy's.
template <typename In, int R, int NK, bool kStaged>
__device__ __forceinline__ void bwd_body(float* smem, const In* __restrict__ dys,
                                         const In* __restrict__ ys,
                                         const float* __restrict__ gates,
                                         const In* __restrict__ wpack, In* __restrict__ dgx,
                                         In* __restrict__ dcx, int T, int B, int H, int C,
                                         int nclus, const StageMaps* maps, int S) {
  static_assert(!kStaged || (NK > 0 && std::is_same_v<In, __nv_bfloat16>),
                "staged: the bf16 backward with a column class");
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Hc = (H + C - 1) / C;
  const int rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int cl = blockIdx.x / C;
  const int dir = cl / nclus;
  const int row0 = (cl - dir * nclus) * R;
  const int j0 = rank * Hc;
  const int nu = max(0, min(Hc, H - j0));
  const LayoutBwd lay(H, C, R, NK, kStaged ? S : 0);
  const size_t ab = round4((size_t)lay.hp * 2 * R), gb = round4((size_t)lay.hp * R);
  const size_t TB = (size_t)T * B;
  dys += dir * TB * H;
  ys += dir * TB * H;
  gates += dir * TB * 3 * H;
  dgx += dir * TB * 2 * H;
  dcx += dir * TB * H;
  wpack += (size_t)dir * C * 3 * Hc * H;
  auto tix = [=](int s) { return (size_t)(dir ? T - 1 - s : s); };   // forward step -> time
  // [dcx, dgu]: bar0 + 8b; dgr: bar0 + 16 + 8b; staged, the ring's slot b: bar0 + 32 + 8b
  const uint32_t bar0 = smem_u32(smem + lay.bars);
  const uint32_t g_bytes = (uint32_t)(H * R * sizeof(float)), a_bytes = 2 * g_bytes;
  const int ld = weight_stride(H);

  // the ring: stage k of the reverse walk holds the time block [t0, t0 +
  // S), t0 a multiple of S (direction 0 walks the blocks down from the
  // ragged last one), h[t-1]'s box one forward step behind it
  const StageLayout st(true, false, kStaged ? S : 1, R, Hc);
  char* const ring = reinterpret_cast<char*>(smem + lay.ring);
  constexpr bool kReadAhead = kStaged && bwd_read_ahead(R, NK);
  const int n_stages = kStaged ? (T + S - 1) / S : 0;
  auto t0_of = [=](int k) { return (dir ? k : n_stages - 1 - k) * S; };
  auto stage_load = [&](int k) {   // dy, h[t-1]; r, u, c
    const uint32_t slot = smem_u32(ring + (k & 1) * st.slot_bytes), bar = bar0 + 32 + 8 * (k & 1);
    const int t0 = t0_of(k);
    mbar_expect(bar, st.in_bytes);
    tma_load(slot + st.box[0], &maps->m[0], j0, row0, t0, dir, bar);
    tma_load(slot + st.box[1], &maps->m[1], j0, row0, dir ? t0 + 1 : t0 - 1, dir, bar);
    tma_load(slot + st.box[2], &maps->m[2], j0, row0, t0, dir, bar);
    tma_load(slot + st.box[3], &maps->m[2], H + j0, row0, t0, dir, bar);
    tma_load(slot + st.box[4], &maps->m[2], 2 * H + j0, row0, t0, dir, bar);
  };
  auto stage_store = [&](int k) {   // dcx; dgx's r half (dgr), its u half (dgu)
    const uint32_t slot = smem_u32(ring + (k & 1) * st.slot_bytes);
    const int t0 = t0_of(k);
    tma_store(&maps->m[4], j0, row0, t0, dir, slot + st.box[5]);
    tma_store(&maps->m[3], j0, row0, t0, dir, slot + st.box[6]);
    tma_store(&maps->m[3], H + j0, row0, t0, dir, slot + st.box[7]);
    bulk_commit();
  };
  if ((C > 1 || kStaged) && tid == 0) {
    for (int i = 0; i < (kStaged ? 6 : 4); ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if constexpr (kStaged) {
      stage_load(0);
      if (n_stages > 1) stage_load(1);
    }
  }
  for (size_t i = tid; i < 2 * (ab + gb); i += nt) smem[lay.a + i] = 0.0f;   // the pad rows

  const int j = tid / kL, lane = tid % kL;   // team j owns unit j0 + j
  const int jr = min(j, Hc - 1);
  const int q = lane % R;                    // the row this lane carries
  const int row = row0 + q;
  const bool live = j < nu && row < B;
  const int unit = j0 + j;
  const In* wsrc = wpack + (size_t)rank * 3 * Hc * H;
  constexpr int NR = NK > 0 ? NK : 1;
  float w2[2][NR] = {}, w3[1][NR] = {};   // rows of Wc_h and Wg_h's u half; its r half
  const float* ws = smem + lay.w;
  const float* const p2[2] = {ws + (size_t)(2 * Hc + jr) * ld, ws + (size_t)(Hc + jr) * ld};
  const float* const p3[1] = {ws + (size_t)jr * ld};
  if constexpr (NK > 0) {
    load_lane_row<NK>(wsrc + (size_t)(2 * Hc + jr) * H, H, lane, w2[0]);
    load_lane_row<NK>(wsrc + (size_t)(Hc + jr) * H, H, lane, w2[1]);
    load_lane_row<NK>(wsrc + (size_t)jr * H, H, lane, w3[0]);
  } else {
    load_weights_f32<In>(smem + lay.w, wsrc, H, Hc, ld, tid, nt);
  }

  // step s's inputs of this lane's row and unit: dy, r, u, c and h[s-1];
  // o is the row's index (time * B + row) of step s, 32-bit, moving by os a
  // step (fewer registers than pointers)
  const int os = dir ? B : -B;
  auto load_step = [&](int s, int o, float (&x)[5]) {   // dy, r, u, c, h[s-1]
    x[0] = load_nc(dys + o * H + unit);
    const float* g = gates + o * 3 * H + unit;
    x[1] = load_nc(g); x[2] = load_nc(g + H); x[3] = load_nc(g + 2 * H);
    x[4] = s > 0 ? load_nc(ys + (o + os) * H + unit) : 0.0f;
  };
  int o = (int)tix(T - 1) * B + row;
  float xa[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, xb[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (!kStaged && live && T > 0) load_step(T - 1, o, xa);
  // staged: the lane's place in the ring, stage k (slot k % 2) with `left`
  // steps left in it, the byte of the lane's element in a bf16 box of the
  // slot (x; in an f32 box 2x), moving by dx a step
  const int row_bytes = R * Hc * 2, dx = dir ? row_bytes : -row_bytes, lane_x = (q * Hc + j) * 2;
  int k = 0, left = 0, x = 0;
  bool first = true;
  auto x_first = [&](int kk) {   // x at stage kk's first step
    const int t0 = t0_of(kk);
    return (dir ? 0 : min(T - t0, S) - 1) * row_bytes + lane_x;
  };
  auto stage_read = [&](int kk, int xx, float (&v)[5]) {   // dy, r, u, c, h[t-1] at xx of kk
    const char* slot = ring + (kk & 1) * st.slot_bytes;
    v[0] = stage_bf16(slot + st.box[0] + xx);
    v[1] = *reinterpret_cast<const float*>(slot + st.box[2] + 2 * xx);
    v[2] = *reinterpret_cast<const float*>(slot + st.box[3] + 2 * xx);
    v[3] = *reinterpret_cast<const float*>(slot + st.box[4] + 2 * xx);
    v[4] = stage_bf16(slot + st.box[1] + xx);
  };
  if (kStaged) {
    left = min(T - t0_of(0), S);
    x = x_first(0);
  }
  // weights, pad rows and the mbarriers in place; every CTA of the cluster running
  if (C > 1) cluster.sync(); else __syncthreads();
  if (kStaged && kReadAhead) {
    mbar_wait(bar0 + 32, 0);
    stage_read(0, x, xa);
  }

  // Reverse step i (forward step s = T-1-i), its buffers' parity a
  // constant. Unstaged, `in` holds its inputs, the next step's go into
  // `next`, two steps a round with the sets swapped (no step ends copying a
  // load in flight), as in the register forward; staged, the step reads its
  // slot.
  float carry = 0.0f;
  auto step = [&](auto parity, int i, const float (&in)[5], float (&next)[5]) {
    constexpr int b = decltype(parity)::value;
    const int s = T - 1 - i;
    char* const slot = ring + (k & 1) * st.slot_bytes;   // staged: the step's slot
    float v[5] = {in[0], in[1], in[2], in[3], in[4]};   // dy, r, u, c, h[t-1]
    if constexpr (kStaged && !kReadAhead) {
      if (first) mbar_wait(bar0 + 32 + 8 * (k & 1), (k >> 1) & 1);
      stage_read(k, x, v);
    }
    const float dy = v[0], r = v[1], u = v[2], c = v[3], hp = v[4];
    const uint32_t bar_a = bar0 + 8 * b, bar_g = bar0 + 16 + 8 * b;
    float* a_buf = smem + lay.a + b * ab;
    float* g_buf = smem + lay.g + b * gb;
    if (C > 1 && tid == 0) {
      mbar_expect(bar_a, a_bytes);
      mbar_expect(bar_g, g_bytes);
    }

    // dcx and du's half of dgx need only the carry and the step's inputs:
    // both into every CTA in one phase; then, while the peers' values
    // arrive, both out and the next step's inputs in (device-memory
    // traffic issued ahead of the sends would delay them)
    const float dh = dy + carry;
    const float dcv = dh * (1.0f - u) * (1.0f - c * c);
    const float dgu = dh * (hp - c) * u * (1.0f - u);
    exchange2<R>(dcv, dgu, a_buf, bar_a, j0, j, nu, lane, C);
    if constexpr (kStaged) {
      if (lane < R) {   // rows past B are dropped by the store
        stage_bf16(slot + st.box[5] + x, dcv);
        stage_bf16(slot + st.box[7] + x, dgu);
      }
      // the ring: stage k - 1 out, k + 1 in
      if (tid == 0 && first && k > 0) {
        stage_store(k - 1);
        if (k + 1 < n_stages) stage_load(k + 1);
      }
      if (kReadAhead && i + 1 < T) {   // the next step's inputs while the peers' values arrive
        if (left > 1) {
          stage_read(k, x + dx, next);
        } else {   // the next step opens stage k + 1
          mbar_wait(bar0 + 32 + 8 * ((k + 1) & 1), ((k + 1) >> 1) & 1);
          stage_read(k + 1, x_first(k + 1), next);
        }
      }
    } else {
      if ((kProbe & kProbeGlobal) == 0 && live && lane < R) {
        store_out(dcx + o * H + unit, dcv);
        store_out(dgx + o * 2 * H + H + unit, dgu);
      }
#pragma unroll
      for (int m = 0; m < 5; ++m) next[m] = (kProbe & kProbeGlobal) != 0 ? in[m] : 0.0f;
      if ((kProbe & kProbeGlobal) == 0 && live && s > 0) load_step(s - 1, o + os, next);
    }
    if (C > 1) mbar_wait(bar_a, (i >> 1) & 1); else __syncthreads();

    // one pass: d(rh) = dcx @ Wc_h^T (reduced now) and this lane's share of
    // dgu @ Wg_h[:, H:]^T (reduced with the r half below); then dgr out and
    // into every CTA
    float s2[2][R];
    if constexpr (NK > 0) reg_sums<R, 2, 2, NK>(a_buf, w2, lane, s2);
    else smem_sums<R, 2, 2>(a_buf, p2, H, lane, s2);
    float sa[1][R];
#pragma unroll
    for (int m = 0; m < R; ++m) sa[0][m] = s2[0][m];
    team_sum<R, 1>(sa);
    const float drh = pick<R>(sa[0], q);
    const float dgr = drh * hp * r * (1.0f - r);
    exchange<R>(dgr, g_buf, bar_g, j0, j, nu, lane, C);
    if constexpr (kStaged) {
      if (lane < R) stage_bf16(slot + st.box[6] + x, dgr);
    } else if ((kProbe & kProbeGlobal) == 0 && live && lane < R) {
      store_out(dgx + o * 2 * H + unit, dgr);
    }
    if (C > 1) mbar_wait(bar_g, (i >> 1) & 1); else __syncthreads();

    // carry to step s-1: dh u + d(rh) r + dgx @ Wg_h^T, the r half's pass
    // added to the u half's lane shares before one reduction
    float s3[1][R];
    if constexpr (NK > 0) reg_sums<R, 1, 1, NK>(g_buf, w3, lane, s3);
    else smem_sums<R, 1, 1>(g_buf, p3, H, lane, s3);
#pragma unroll
    for (int m = 0; m < R; ++m) s3[0][m] += s2[1][m];
    team_sum<R, 1>(s3);
    carry = dh * u + drh * r + pick<R>(s3[0], q);
    if constexpr (kStaged) {
      first = false;
      if (--left == 0) {   // the stage's last step
        fence_async_shared();
        if (tid == 0) bulk_wait_read();
        __syncthreads();
        if (++k < n_stages) {
          left = min(T - t0_of(k), S);
          x = x_first(k);
          first = true;
        }
      } else {
        x += dx;
      }
    } else {
      o += os;
    }
  };
  for (int i = 0; i < T; i += 2) {
    step(std::integral_constant<int, 0>{}, i, xa, xb);
    if (i + 1 < T) step(std::integral_constant<int, 1>{}, i + 1, xb, xa);
  }
  if constexpr (kStaged) {
    if (tid == 0) {
      stage_store(n_stages - 1);
      bulk_wait_written();
    }
  }
  if (C > 1) cluster.sync();   // no CTA leaves while a peer may still address it
}

template <typename In, int R, int NK>
__global__ void __launch_bounds__(reg_max_threads(NK), reg_min_ctas(true, R, NK))
gru_scan_bwd_kernel(const In* __restrict__ dys, const In* __restrict__ ys,
                    const float* __restrict__ gates, const In* __restrict__ wpack,
                    In* __restrict__ dgx, In* __restrict__ dcx, int T, int B, int H,
                    int C, int nclus) {
  extern __shared__ __align__(16) float smem[];
  bwd_body<In, R, NK, false>(smem, dys, ys, gates, wpack, dgx, dcx, T, B, H, C, nclus, nullptr,
                             0);
}

// The bf16 backward staged through shared memory (S steps a stage).
template <int R, int NK>
__global__ void __launch_bounds__(reg_max_threads(NK), reg_min_ctas(true, R, NK))
gru_scan_bwd_staged_kernel(const __nv_bfloat16* __restrict__ dys,
                           const __nv_bfloat16* __restrict__ ys,
                           const float* __restrict__ gates,
                           const __nv_bfloat16* __restrict__ wpack,
                           __nv_bfloat16* __restrict__ dgx, __nv_bfloat16* __restrict__ dcx,
                           int T, int B, int H, int C, int nclus,
                           const __grid_constant__ StageMaps maps, int S) {
  extern __shared__ __align__(128) float smem_staged[];
  bwd_body<__nv_bfloat16, R, NK, true>(smem_staged, dys, ys, gates, wpack, dgx, dcx, T, B, H, C,
                                       nclus, &maps, S);
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

// The shared-memory f32 forward's instantiation for R and kFull.
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

// Checks the plan and launches the shared-memory f32 forward's
// instantiation; returns the CUDA error.
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

// f(integral_constant R, integral_constant NK) for run-time R and column
// class NK; only the instances reg_instance names are compiled.
template <bool kBwd, int NK, bool kGates, bool kStaged, typename F>
cudaError_t with_rows(int R, F&& f) {
  using std::integral_constant;
  constexpr auto cols = [](int r) { return reg_instance(kBwd, r, NK, kGates, kStaged) ? NK : 0; };
  switch (R) {
    case 1: return f(integral_constant<int, 1>{}, integral_constant<int, cols(1)>{});
    case 2: return f(integral_constant<int, 2>{}, integral_constant<int, cols(2)>{});
    case 4: return f(integral_constant<int, 4>{}, integral_constant<int, cols(4)>{});
    default: return f(integral_constant<int, 8>{}, integral_constant<int, cols(8)>{});
  }
}

template <bool kBwd, bool kGates, bool kStaged = false, typename F>
cudaError_t with_rows_columns(int R, int NK, F&& f) {
  switch (NK) {
    case 5: return with_rows<kBwd, 5, kGates, kStaged>(R, f);
    case 8: return with_rows<kBwd, 8, kGates, kStaged>(R, f);
    case 16: return with_rows<kBwd, 16, kGates, kStaged>(R, f);
    case 32: return with_rows<kBwd, 32, kGates, kStaged>(R, f);
    default: return with_rows<kBwd, 0, kGates, kStaged>(R, f);
  }
}

// cuTensorMapEncodeTiled through the runtime's entry point into the driver
// (nothing links against libcuda); null where the driver lacks it.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A tensor map over the [dirs, T, B, width] operand at `base` (bf16, or f32
// with `f32`) as (width, B, T, dirs), boxes (Hc, R, S, 1), zero-filled past
// its bounds; false if the driver refuses it.
bool stage_map(CUtensorMap* map, const void* base, bool f32, int width, int T, int B, int dirs,
               int Hc, int R, int S) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t es = f32 ? 4 : 2, row = es * (cuuint64_t)width;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)B, (cuuint64_t)T, (cuuint64_t)dirs};
  const cuuint64_t strides[3] = {row, row * B, row * B * T};   // bytes, dims 1..3
  const cuuint32_t box[4] = {(cuuint32_t)Hc, (cuuint32_t)R, (cuuint32_t)S, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A stage depth the staged kernels take (a power of two, a TMA box's time
// extent <= 256) for width H over C CTAs, with a column class.
bool stage_ok(int H, int C, int nk, int S) {
  return nk > 0 && stageable(H, C) && pow2(S) && S <= 256;
}

// Checks the plan and launches the register forward's instantiation for
// operands In: the inference one (one direction or both), or with `gates`
// the training one (kGates); with a stage depth S > 0 (bf16, every form)
// the staged one. f32 operands have only unstaged instances with a column
// class (NK > 0): scl_gru_scan_f32 sends here every form whose plan has
// one.
template <typename In>
int launch_reg_checked(const In* gx, const In* cx, const In* wpack, In* ys, float* gates,
                       int* sm_ids, int T, int B, int H, int C, int R, int clusters, int dirs,
                       int threads, int S, long long smem, void* stream) {
  const bool gated = gates != nullptr;
  // 32-bit element offsets (the gates' reach 3 T B H)
  if (!grid_ok(T, B, H, C, R, clusters, dirs, threads) ||
      (long long)T * B * (gated ? 3 : 2) * H >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int nk = reg_columns(false, H, R, threads, gated, S != 0);
  if (S != 0 && !(std::is_same_v<In, __nv_bfloat16> && stage_ok(H, C, nk, S)))
    return (int)cudaErrorInvalidValue;
  const LayoutReg lay(H, C, R, nk, S, gated);
  if (smem != (long long)(lay.total * sizeof(float))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = dirs * clusters * C;
  StageMaps maps;
  if (S != 0) {
    const int Hc = H / C;
    if (!stage_map(&maps.m[0], gx, false, 2 * H, T, B, dirs, Hc, R, S) ||
        !stage_map(&maps.m[1], cx, false, H, T, B, dirs, Hc, R, S) ||
        !stage_map(&maps.m[2], ys, false, H, T, B, dirs, Hc, R, S) ||
        (gated && !stage_map(&maps.m[3], gates, true, 3 * H, T, B, dirs, Hc, R, S)))
      return (int)cudaErrorNotSupported;
  }
  // the instance of (R, NK) with or without the gates, staged or not; those
  // not compiled (f32 with NK = 0 or staged, staged with NK = 0) refuse
  auto launch = [&](auto r, auto k, auto with_gates, auto staged) -> cudaError_t {
    constexpr int kR = decltype(r)::value, kNK = decltype(k)::value;
    constexpr bool kG = decltype(with_gates)::value, kS = decltype(staged)::value;
    constexpr bool f32 = std::is_same_v<In, float>;
    if constexpr (kS) {
      if constexpr (f32 || kNK == 0)
        return cudaErrorInvalidValue;   // not compiled
      else
        return launch_clusters(gru_scan_reg_staged_kernel<kR, kNK, kG>, C, blocks, threads,
                               smem, s, gx, cx, wpack, ys, gates, sm_ids, T, B, H, C, clusters,
                               maps, S);
    } else if constexpr (f32 && kNK == 0) {
      return cudaErrorInvalidValue;   // not compiled
    } else {
      return launch_clusters(gru_scan_reg_kernel<In, kR, kNK, kG>, C, blocks, threads, smem, s,
                             gx, cx, wpack, ys, gates, sm_ids, T, B, H, C, clusters);
    }
  };
  using std::false_type, std::true_type;
  if (gated && S != 0)
    return (int)with_rows_columns<false, true, true>(
        R, nk, [&](auto r, auto k) { return launch(r, k, true_type{}, true_type{}); });
  if (gated)
    return (int)with_rows_columns<false, true>(
        R, nk, [&](auto r, auto k) { return launch(r, k, true_type{}, false_type{}); });
  if (S != 0)
    return (int)with_rows_columns<false, false, true>(
        R, nk, [&](auto r, auto k) { return launch(r, k, false_type{}, true_type{}); });
  return (int)with_rows_columns<false, false>(
      R, nk, [&](auto r, auto k) { return launch(r, k, false_type{}, false_type{}); });
}

// Checks the plan and launches the backward's instantiation for operands
// In; with a stage depth S > 0 (bf16 only) the staged one.
template <typename In>
int launch_bwd_checked(const In* dys, const In* ys, const float* gates, const In* wpack, In* dgx,
                       In* dcx, int T, int B, int H, int C, int R, int clusters, int dirs,
                       int threads, int S, long long smem, void* stream) {
  if (!grid_ok(T, B, H, C, R, clusters, dirs, threads) ||
      (long long)T * B * 3 * H >= (1LL << 31))   // 32-bit element offsets
    return (int)cudaErrorInvalidValue;
  const int nk = reg_columns(true, H, R, threads, false, S != 0);
  if (S != 0 && !(std::is_same_v<In, __nv_bfloat16> && stage_ok(H, C, nk, S)))
    return (int)cudaErrorInvalidValue;
  if (smem != (long long)(LayoutBwd(H, C, R, nk, S).total * sizeof(float)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = dirs * clusters * C;
  StageMaps maps;
  if (S != 0) {
    const int Hc = H / C;
    if (!stage_map(&maps.m[0], dys, false, H, T, B, dirs, Hc, R, S) ||
        !stage_map(&maps.m[1], ys, false, H, T, B, dirs, Hc, R, S) ||
        !stage_map(&maps.m[2], gates, true, 3 * H, T, B, dirs, Hc, R, S) ||
        !stage_map(&maps.m[3], dgx, false, 2 * H, T, B, dirs, Hc, R, S) ||
        !stage_map(&maps.m[4], dcx, false, H, T, B, dirs, Hc, R, S))
      return (int)cudaErrorNotSupported;
  }
  if (S != 0)
    return (int)with_rows_columns<true, false, true>(R, nk, [&](auto r, auto k) -> cudaError_t {
      constexpr int kR = decltype(r)::value, kNK = decltype(k)::value;
      if constexpr (std::is_same_v<In, __nv_bfloat16> && kNK > 0)
        return launch_clusters(gru_scan_bwd_staged_kernel<kR, kNK>, C, blocks, threads, smem, s,
                               dys, ys, gates, wpack, dgx, dcx, T, B, H, C, clusters, maps, S);
      else
        return cudaErrorInvalidValue;   // not compiled
    });
  return (int)with_rows_columns<true, false>(R, nk, [&](auto r, auto k) {
    return launch_clusters(gru_scan_bwd_kernel<In, decltype(r)::value, decltype(k)::value>, C,
                           blocks, threads, smem, s, dys, ys, gates, wpack, dgx, dcx, T, B, H,
                           C, clusters);
  });
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
// sm_ids, when not null, each CTA's SM. `stage_steps`: the stage depth S of
// a staged instance (bf16), 0 for the others (and always for f32). f32
// operands and output; every form (the inference forward of one direction
// or both, the training forward) runs the register kernel where its plan
// has a register column class (`smem` then follows LayoutReg), and the
// shared-memory one (Layout) where it has none: past H = 256, at a cluster
// size whose CTAs pass the register instances' launch bounds, or at a
// spilling row count (reg_instance):
int scl_gru_scan_f32(const float* gx, const float* cx, const float* wpack, float* ys,
                     float* gates, int* sm_ids, int T, int B, int H, int C, int R, int clusters,
                     int dirs, int threads, int stage_steps, long long smem, void* stream) {
  if (stage_steps != 0) return (int)cudaErrorInvalidValue;
  if (reg_columns(false, H, R, threads, gates != nullptr) > 0)
    return launch_reg_checked<float>(gx, cx, wpack, ys, gates, sm_ids, T, B, H, C, R, clusters,
                                     dirs, threads, 0, smem, stream);
  return launch_checked<float>(gx, cx, wpack, ys, gates, sm_ids, T, B, H, C, R, clusters, dirs,
                               threads, smem, stream);
}

// bf16 operands and output (f32 state and sums inside); gates, when not
// null, receives r, u, c [dirs, T, B, 3H] in f32 (the training forward);
// staged with stage_steps > 0 (every form):
int scl_gru_scan_bf16(const __nv_bfloat16* gx, const __nv_bfloat16* cx,
                      const __nv_bfloat16* wpack, __nv_bfloat16* ys, float* gates, int* sm_ids,
                      int T, int B, int H, int C, int R, int clusters, int dirs, int threads,
                      int stage_steps, long long smem, void* stream) {
  return launch_reg_checked<__nv_bfloat16>(gx, cx, wpack, ys, gates, sm_ids, T, B, H, C, R,
                                           clusters, dirs, threads, stage_steps, smem, stream);
}

// The scan's backward, f32: dys, ys, gates of the forward and the weights
// packed by pack_gru_weights_bwd in; dgx [dirs, T, B, 2H], dcx [dirs, T, B, H]
// out. stage_steps must be 0.
int scl_gru_scan_bwd_f32(const float* dys, const float* ys, const float* gates,
                         const float* wpack, float* dgx, float* dcx, int T, int B, int H, int C,
                         int R, int clusters, int dirs, int threads, int stage_steps,
                         long long smem, void* stream) {
  if (stage_steps != 0) return (int)cudaErrorInvalidValue;
  return launch_bwd_checked<float>(dys, ys, gates, wpack, dgx, dcx, T, B, H, C, R, clusters,
                                   dirs, threads, 0, smem, stream);
}

// The same with bf16 dys, ys, weights, dgx and dcx (f32 gates, carry and
// sums inside; dgx and dcx rounded to nearest even at the store), staged
// with stage_steps > 0.
int scl_gru_scan_bwd_bf16(const __nv_bfloat16* dys, const __nv_bfloat16* ys, const float* gates,
                          const __nv_bfloat16* wpack, __nv_bfloat16* dgx, __nv_bfloat16* dcx,
                          int T, int B, int H, int C, int R, int clusters, int dirs, int threads,
                          int stage_steps, long long smem, void* stream) {
  return launch_bwd_checked<__nv_bfloat16>(dys, ys, gates, wpack, dgx, dcx, T, B, H, C, R,
                                           clusters, dirs, threads, stage_steps, smem, stream);
}

}  // extern "C"
