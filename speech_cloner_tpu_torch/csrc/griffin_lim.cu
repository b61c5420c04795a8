// One Griffin-Lim round of the float32 matmul-DFT vocoder for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the JAX package's Griffin-Lim is plain jnp
// matmuls (speech_cloner_tpu/ops/griffin_lim.py), which the port ran as
// `ops/stft.istft` and `stft` with dft="matmul": per round four cuBLAS
// GEMMs and some twenty element-wise launches, each intermediate (frames,
// signal, complex spectra) through device memory. This kernel does a whole
// round in one launch, for n_fft = 400 and hop = 80 (the models' STFT):
//   frames[t, n] = (sum_f Sre[t, f] inv_re[f, n] + sum_f Sim[t, f] inv_im[f, n]) * win[n]
//   y[p]         = sum_j frames[p/80 - j, 80 j + p%80]       j = 0..4, in that order
//   y[p]        /= wss[p] where wss[p] > tiny                the squared-window envelope
//   yp           = y trimmed by 200 and reflect-padded by 200 (the centered STFT)
//   X[t, f]      = sum_n yp[80 t + n] * win[n] * fwd[n, f]
//   S'[t, f]     = amp[t, f] * (X / max(|X|, tiny))
// with `inv` and `fwd` the float32 bases of ops/stft.py `_dft_mats` (built
// in float64), the window multiplies, overlap-add order, envelope test and
// projection of `istft`, `stft` and `ops/griffin_lim.rounds`, and each
// dot product as one float32 FFMA chain in k order, the re and im parts of
// the inverse apart and then added (no TF32, no tensor cores, no FFT). The
// sums' order matters beyond rounding here: the DC and Nyquist bins' X is
// real, so the projection keeps only its sign, and where it lies within a
// rounding of 0 another order flips that bin (an order of one chain over
// interleaved re and im parts read up to 1.3e-4 against the reference
// vocoder's 5e-5 limit on 1 seed in 22 of offline_short_f32).
//
// What bounds it on this card: operations. A round is two dense products
// of T x 400 x 402 multiply-adds (7.72 GFLOP at T = 12,001, 115 us at the
// float32 FFMA peak of 67 TFLOP/s); the bases (2 x 643 KB) stay in L2 and
// are read again by every CTA, about 0.25 * M multiply-adds a byte for a
// tile of M frames.
//
// Design (the plan comes from ops/cuda_kernels.py `gl_round_plan`; this
// file checks it and takes it as given):
//  - A CTA a tile of one clip's frames [t0, t1), at most kRows - 4 of them;
//    a clip's T frames split into `tiles` tiles of balanced size (each at
//    least 2 frames), so no tile crosses clips. The tile's frames read the
//    signal's chunks of 80 samples [t0, t1 + 4), and those need the
//    inverse frames [t0 - 4, t1 + 4): the CTA computes kRows chunks from
//    kRows + 4 rows of S (the 4 before t0 are the halo; rows outside the
//    clip are zeros). Every output's arithmetic is the same whichever tile
//    it falls in, so a clip in a batch gets the bits of its single
//    conversion.
//  - Inverse product, split by tap. Warp (g, j) of 5 x WR computes, for its
//    rows of chunks m, frame t0 + m - j's samples [80 j, 80 j + 80): a
//    product [kRows x 201] x [201 x 80] over the re parts of the S rows
//    shifted by j, its sums put aside in device memory (`stash`), then the
//    same over the im parts, the two added. The frames are multiplied by the
//    window and overlap-added into a shared segment in five phases, tap 0
//    first (the order `overlap_add` adds them), and the last phase divides
//    by the envelope.
//  - The reflect padding of the centered STFT is applied inside the
//    segment at each clip's first 200 and last 200 samples; a frame then
//    reads its 400 samples straight out of the segment (no framing copy),
//    times the window as it loads them.
//  - Forward product: warp (g, q) computes its rows' frames at bins
//    [40 q, 40 q + 40), re and im interleaved in the basis so a lane holds
//    both parts of a bin and projects it as it writes S'. The Nyquist bin
//    (200) is a chain of 400 FFMA a part and frame, one thread each.
//  - Bases through a ring. A stage is 40 rows of a basis (64 KB, and the
//    40 S parts of the tile's rows for the inverse), two stages, one
//    filling by cp.async while the other is read, one barrier a stage. The
//    forward's first stage loads while the inverse's epilogue runs.
//  - Register tiling. A warp's tile is RL rows a lane by the 80 columns of
//    its tap or bin group, a bin's re and im side by side in one lane: 4 row
//    lanes x 8 column lanes of 10 columns (two float4 and a float2 of the
//    basis a k), or 8 row lanes x 4 column lanes of 20 (five float4). A row
//    is read 4 k at a time (one float4), times the window in the forward;
//    one chain of FFMA an output, k in order. The rows a warp reads at once
//    lie 44 (inverse) or 84 (segment) words apart, in distinct banks.
//  - What the sums reach (an H100, PERF.md section 6): about a third of the
//    FFMA peak. ptxas gives 55-65% of the inner products' FFMA two fresh
//    source registers in one register bank (so two cycles, not one), and
//    the basis reads keep shared memory's pipe busy; more rows a lane, or
//    fewer, trades one for the other.
//  - Instances (WR warp rows, RL rows a lane, columns a lane): (2, 2, 10),
//    (2, 4, 10), (4, 4, 10), (4, 3, 20): 16, 32, 64 or 96 chunk rows a CTA,
//    320 or 640 threads, one CTA an SM.
//
// S, S' are complex64 [B, T, 201] (re, im interleaved), amp float32
// [B, T, 201], wss float32 [(T - 1) * 80 + 400], the window float32 [400];
// inv_b [402][400] (rows inv_re[0..200], then inv_im[0..200]), fwd_b [400][400]
// (column 2f: fwd_re[f], 2f + 1: fwd_im[f], f < 200), nyq_b [400][2] (bin
// 200's re and im).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kNfft = 400;
constexpr int kHop = 80;
constexpr int kTaps = kNfft / kHop;               // 5 frames overlap each sample
constexpr int kBins = kNfft / 2 + 1;              // 201
constexpr int kSpec = 2 * kBins;                  // 402 floats a frame of S
constexpr int kColWarps = 5;                      // warps across a product's 400 columns
constexpr int kWarpCols = 80;
constexpr int kWarpBins = kWarpCols / 2;
constexpr int kDepth = 40;                        // basis rows a stage
constexpr int kHalfStages = (kBins + kDepth - 1) / kDepth;    // a half: 5 of 40 rows, 1 of 1
constexpr int kHalfTail = kBins - (kHalfStages - 1) * kDepth;
constexpr int kInvStages = 2 * kHalfStages;                    // the re half, then the im half
constexpr int kFwdStages = kNfft / kDepth;
constexpr int kAStride = kDepth + 4;              // S rows of a stage, words
constexpr int kSegStride = kHop + 4;              // the segment's chunks, words
constexpr float kTiny = 1.17549435e-38f;          // float32 tiny
static_assert(kNfft % kHop == 0 && kHop % kDepth == 0 && kColWarps * kWarpCols == kNfft, "");
static_assert(kDepth % 4 == 0 && kHalfTail % 4 != 0, "");

// shared memory of an instance with `rows` chunk rows, in floats: two ring
// slots (S rows, basis rows), the segment, the window
constexpr long long smem_floats(int rows) {
  return 2LL * ((rows + kTaps - 1) * kAStride + kDepth * kNfft) +
         (long long)(rows + kTaps - 1) * kSegStride + kNfft;
}

struct Shape {
  int B, T, tiles;
  long long wss_len;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// A warp's tile: RL rows a lane (kRowLanes apart) of kRowLanes * RL rows, by
// the 80 columns of its tap or bin group, kLC of them a lane. Two layouts:
// kLC = 10, 4 row lanes x 8 column lanes, columns 4 lc + 0..3, 32 + 4 lc +
// 0..3, 64 + 2 lc + 0..1; kLC = 20, 8 row lanes x 4 column lanes, columns
// 20 lc + 0..19. Either way a bin's re and im sit side by side in a lane.
template <int kLC>
struct Lanes;

template <>
struct Lanes<10> {
  static constexpr int kRowLanes = 4;
  __device__ static int col(int c, int lc) {
    return c < 4 ? 4 * lc + c : c < 8 ? 32 + 4 * lc + (c - 4) : 64 + 2 * lc + (c - 8);
  }
  __device__ static void load(float (&b)[10], const float* row, int lc) {
    const float4 p = *reinterpret_cast<const float4*>(row + 4 * lc);
    const float4 q = *reinterpret_cast<const float4*>(row + 32 + 4 * lc);
    const float2 r = *reinterpret_cast<const float2*>(row + 64 + 2 * lc);
    b[0] = p.x; b[1] = p.y; b[2] = p.z; b[3] = p.w;
    b[4] = q.x; b[5] = q.y; b[6] = q.z; b[7] = q.w;
    b[8] = r.x; b[9] = r.y;
  }
};

template <>
struct Lanes<20> {
  static constexpr int kRowLanes = 8;
  __device__ static int col(int c, int lc) { return 20 * lc + c; }
  __device__ static void load(float (&b)[20], const float* row, int lc) {
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(row + 20 * lc + 4 * j);
      b[4 * j] = v.x; b[4 * j + 1] = v.y; b[4 * j + 2] = v.z; b[4 * j + 3] = v.w;
    }
  }
};

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// D rows of a stage: acc[i][c] += sum_k A[i][k] * B[k][c]. A's row i at
// a + i * a_step, read 4 k at a time, times w[k] where kWin; B's row k at
// b + k * kNfft (the warp's 80 columns). One chain of FFMA an output, k in
// order.
template <int kLC, int RL, int D, bool kWin>
__device__ __forceinline__ void stage_mma(float (&acc)[RL][kLC], const float* a, int a_step,
                                          const float* b, int lc, const float* w) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 4) {
      float4 av[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * a_step + k0);
      if (kWin) {
        const float4 w4 = *reinterpret_cast<const float4*>(w + k0);
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          av[i].x *= w4.x;
          av[i].y *= w4.y;
          av[i].z *= w4.z;
          av[i].w *= w4.w;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[kLC];
        Lanes<kLC>::load(bv, b + (k0 + kk) * kNfft, lc);
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          const float x = lane4(av[i], kk);
#pragma unroll
          for (int c = 0; c < kLC; ++c) acc[i][c] = fmaf(x, bv[c], acc[i][c]);
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float bv[kLC];
      Lanes<kLC>::load(bv, b + k * kNfft, lc);
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const float x = kWin ? a[i * a_step + k] * w[k] : a[i * a_step + k];
#pragma unroll
        for (int c = 0; c < kLC; ++c) acc[i][c] = fmaf(x, bv[c], acc[i][c]);
      }
    }
  }
}

// S'[idx] = amp[idx] * (X / max(|X|, tiny)), X = (re, im): the projection
// of `rounds` (a complex divided by a real is its parts times 1/d)
__device__ __forceinline__ void project(float re, float im, const float* __restrict__ amp,
                                        float* __restrict__ s_out, long long idx) {
  const float h = hypotf(re, im);
  const float sc = 1.0f / (h < kTiny ? kTiny : h);
  const float a = amp[idx];
  *reinterpret_cast<float2*>(s_out + 2 * idx) = make_float2(a * (re * sc), a * (im * sc));
}

// segment position q (samples from the tile's first chunk)
__device__ __forceinline__ float& seg_at(float* seg, long long q) {
  return seg[(q / kHop) * kSegStride + q % kHop];
}

template <int WR, int RL, int kLC>
__global__ void __launch_bounds__(WR * kColWarps * 32, 1)
    gl_round_kernel(const float* __restrict__ s_in, float* __restrict__ s_out,
                    const float* __restrict__ amp, const float* __restrict__ wss,
                    const float* __restrict__ inv_b, const float* __restrict__ fwd_b,
                    const float* __restrict__ nyq_b, const float* __restrict__ window,
                    float* __restrict__ stash, const Shape s) {
  using L = Lanes<kLC>;
  constexpr int kStep = L::kRowLanes;             // a lane's rows lie kStep apart
  constexpr int kRows = WR * kStep * RL;          // chunk rows (and frame rows) a CTA
  constexpr int kThreads = WR * kColWarps * 32;
  constexpr int kARows = kRows + kTaps - 1;       // S rows: the halo before t0, then kRows
  constexpr int kSlotA = kARows * kAStride;
  constexpr int kSlot = kSlotA + kDepth * kNfft;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                       // [2][kSlot]
  float* seg = smem + 2 * kSlot;                            // [kARows][kSegStride]
  float* win = seg + kARows * kSegStride;                   // [kNfft]

  const int b = blockIdx.x / s.tiles, tile = blockIdx.x - b * s.tiles;
  const int t0 = (int)((long long)tile * s.T / s.tiles);
  const int t1 = (int)((long long)(tile + 1) * s.T / s.tiles);
  const int n_frames = t1 - t0;
  const long long clip = (long long)b * s.T;              // the clip's first row
  const int tid = threadIdx.x;

  for (int i = tid; i < kNfft; i += kThreads) win[i] = window[i];
  for (int i = tid; i < (kTaps - 1) * kSegStride; i += kThreads)
    seg[kRows * kSegStride + i] = 0.f;                    // chunks past the computed ones

  // stage st: the inverse's re parts of 40 bins (then, from stage
  // kHalfStages on, their im parts) of the tile's S rows and the 40 rows of
  // inv_re (inv_im) they multiply, then the forward basis's rows
  auto load = [&](int st) {
    float* slot = ring + (st & 1) * kSlot;
    if (st < kInvStages) {
      const int half = st / kHalfStages, f0 = (st % kHalfStages) * kDepth;
      const int depth = f0 + kDepth <= kBins ? kDepth : kHalfTail;
      for (int e = tid; e < kARows * depth; e += kThreads) {
        const int a = e / depth, j = e - a * depth;
        const int t = t0 - (kTaps - 1) + a;
        const bool ok = t >= 0 && t < s.T;
        cp_async4(slot + a * kAStride + j,
                  s_in + (clip + (ok ? t : 0)) * kSpec + 2 * (f0 + j) + half, ok);
      }
      const float* src = inv_b + (long long)(half * kBins + f0) * kNfft;
      for (int e = tid; e < depth * (kNfft / 4); e += kThreads)
        cp_async16(slot + kSlotA + 4 * e, src + 4 * e);
    } else if (st < kInvStages + kFwdStages) {
      const float* src = fwd_b + (long long)(st - kInvStages) * kDepth * kNfft;
      for (int e = tid; e < kDepth * (kNfft / 4); e += kThreads)
        cp_async16(slot + kSlotA + 4 * e, src + 4 * e);
    }
    cp_async_commit();
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = warp / kColWarps, cw = warp - g * kColWarps;   // row group; tap or bin group
  const int lr = lane % kStep, lc = lane / kStep;
  const int m0 = g * kStep * RL + lr;                           // the lane's rows m0 + kStep i
  float acc[RL][kLC];
#pragma unroll
  for (int i = 0; i < RL; ++i)
#pragma unroll
    for (int c = 0; c < kLC; ++c) acc[i][c] = 0.f;

  load(0);
  for (int st = 0; st < kInvStages + kFwdStages; ++st) {
    cp_async_wait_all();                       // stage st is in
    __syncthreads();                           // and every thread is done with stage st - 1
    load(st + 1);
    const float* slot = ring + (st & 1) * kSlot;
    const float* bw = slot + kSlotA + cw * kWarpCols;           // the warp's basis columns
    if (st < kInvStages) {
      // chunk m, tap cw: frame t0 + m - cw, staged at row m + 4 - cw
      const float* a = slot + (m0 + kTaps - 1 - cw) * kAStride;
      if (st % kHalfStages < kHalfStages - 1) {
        stage_mma<kLC, RL, kDepth, false>(acc, a, kStep * kAStride, bw, lc, nullptr);
        continue;
      }
      stage_mma<kLC, RL, kHalfTail, false>(acc, a, kStep * kAStride, bw, lc, nullptr);
      // the re parts' sums wait in `stash` (this CTA's [RL * kLC][kThreads]
      // floats) while the im parts' run; a frame is then the two sums added,
      // as S.real @ inv_re + S.imag @ inv_im
      float* mine = stash + (long long)blockIdx.x * RL * kLC * kThreads + tid;
      if (st < kInvStages - 1) {
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int c = 0; c < kLC; ++c) {
            mine[(i * kLC + c) * kThreads] = acc[i][c];
            acc[i][c] = 0.f;
          }
        continue;
      }
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int c = 0; c < kLC; ++c) acc[i][c] = mine[(i * kLC + c) * kThreads] + acc[i][c];
      // frames times the window, overlap-added tap by tap; the envelope last
      const float* wj = win + cw * kHop;
      for (int ph = 0; ph < kTaps; ++ph) {
        if (cw == ph) {
#pragma unroll
          for (int i = 0; i < RL; ++i) {
            const int m = m0 + kStep * i;
            float* y = seg + m * kSegStride;
            const long long p0 = (long long)(t0 + m) * kHop;
#pragma unroll
            for (int c = 0; c < kLC; ++c) {
              const int col = L::col(c, lc);
              const float v = acc[i][c] * wj[col];
              float u = ph == 0 ? v : y[col] + v;
              if (ph == kTaps - 1 && p0 + col < s.wss_len) {
                const float e = wss[p0 + col];
                if (e > kTiny) u = u / e;
              }
              y[col] = u;
            }
          }
        }
        __syncthreads();
      }
      // the centered STFT's reflect padding: padded sample i of the clip is
      // y[i] for 200 <= i < L + 200, y[400 - i] before, y[2 L + 398 - i] after
      // (only the samples the tile's frames read, [80 t0, 80 (t1 - 1) + 400))
      const long long Ln = (long long)(s.T - 1) * kHop, base = (long long)t0 * kHop;
      const long long hi = (long long)(t1 - 1) * kHop + kNfft;
      for (long long i = base + tid; i < (hi < kNfft / 2 ? hi : kNfft / 2); i += kThreads)
        seg_at(seg, i - base) = seg_at(seg, kNfft - i - base);
      for (long long i = (Ln + kNfft / 2 > base ? Ln + kNfft / 2 : base) + tid; i < hi;
           i += kThreads)
        seg_at(seg, i - base) = seg_at(seg, 2 * Ln + kNfft - 2 - i - base);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int c = 0; c < kLC; ++c) acc[i][c] = 0.f;
    } else {
      // frame m's samples [80 tap + r0, +40): chunk m + tap, offsets r0..
      const int fs = st - kInvStages, tap = fs / (kHop / kDepth);
      const int r0 = (fs % (kHop / kDepth)) * kDepth;
      stage_mma<kLC, RL, kDepth, true>(acc, seg + (m0 + tap) * kSegStride + r0,
                                       kStep * kSegStride, bw, lc, win + tap * kHop + r0);
    }
  }

  // projection of the lane's bins (re, im side by side) of its frames
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const int m = m0 + kStep * i;
    if (m < n_frames) {
      const long long row = (clip + t0 + m) * kBins + cw * kWarpBins;
#pragma unroll
      for (int c = 0; c < kLC; c += 2)
        project(acc[i][c], acc[i][c + 1], amp, s_out, row + L::col(c, lc) / 2);
    }
  }
  // the Nyquist bin: a thread each of its re and im parts of a frame, n in
  // order as the other bins' sums, the im part handed to its re's lane
  for (int q0 = warp * 32; q0 < 2 * n_frames; q0 += kThreads) {
    const int q = q0 + lane, m = q / 2, part = q % 2;
    float x_sum = 0.f;
    if (q < 2 * n_frames)
      for (int n = 0; n < kNfft; ++n)
        x_sum = fmaf(seg[(m + n / kHop) * kSegStride + n % kHop] * win[n],
                     __ldg(nyq_b + 2 * n + part), x_sum);
    const float im = __shfl_down_sync(0xffffffffu, x_sum, 1);
    if (q < 2 * n_frames && part == 0)
      project(x_sum, im, amp, s_out, (clip + t0 + m) * kBins + kBins - 1);
  }
  cp_async_wait_all();
}

bool aligned(const void* p, uintptr_t bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }

template <int WR, int RL, int kLC>
int launch(const float* s_in, float* s_out, const float* amp, const float* wss,
           const float* inv_b, const float* fwd_b, const float* nyq_b, const float* window,
           float* stash, const Shape& s, long long smem, cudaStream_t stream) {
  auto kernel = gl_round_kernel<WR, RL, kLC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)((long long)s.B * s.tiles), WR * kColWarps * 32, (size_t)smem, stream>>>(
      s_in, s_out, amp, wss, inv_b, fwd_b, nyq_b, window, stash, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory of the instance with `rows` chunk rows.
long long scl_gl_round_smem_bytes(int rows) { return 4 * smem_floats(rows); }

// One Griffin-Lim round: s_out from s_in (both [B, T, 201] complex64, not
// the same buffer), amp, wss, the packed bases and the window (see the
// top), `stash` B * tiles * rows * 400 floats of scratch, each clip's T frames in `tiles` tiles of the instance with `rows`
// chunk rows, `warp_rows` warp rows and `lane_cols` columns a lane (see the
// instances above), `smem` its bytes. Returns the CUDA
// error of the launch (0 = launched); cudaErrorInvalidValue for a shape or
// plan the kernel does not take.
int scl_gl_round_f32(const float* s_in, float* s_out, const float* amp, const float* wss,
                     const float* inv_b, const float* fwd_b, const float* nyq_b,
                     const float* window, float* stash, int B, int T, int rows, int warp_rows,
                     int lane_cols, int tiles, long long smem, void* stream) {
  if (B < 1 || T < kTaps - 1 || tiles < 1 || (long long)B * tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;
  // every tile at least 2 frames and at most rows - 4
  if (T < 2LL * tiles || (T + tiles - 1) / tiles > rows - (kTaps - 1))
    return (int)cudaErrorInvalidValue;
  if (smem != scl_gl_round_smem_bytes(rows) || s_in == s_out || stash == nullptr)
    return (int)cudaErrorInvalidValue;
  if (!aligned(s_in, 8) || !aligned(s_out, 8) || !aligned(inv_b, 16) || !aligned(fwd_b, 16))
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.B = B; s.T = T; s.tiles = tiles;
  s.wss_len = (long long)(T - 1) * kHop + kNfft;
  cudaStream_t st = (cudaStream_t)stream;
#define GL_CASE(WR, RL, LC)                                                                \
  if (warp_rows == WR && lane_cols == LC && rows == WR * Lanes<LC>::kRowLanes * RL)           \
    return launch<WR, RL, LC>(s_in, s_out, amp, wss, inv_b, fwd_b, nyq_b, window, stash, s, \
                              smem, st);
  GL_CASE(2, 2, 10) GL_CASE(2, 4, 10) GL_CASE(4, 4, 10) GL_CASE(4, 3, 20)
#undef GL_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
