// The CBHG bank convolutions in float32 for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the JAX package packs the K bank kernels of
// widths 1..K into one width-K kernel and calls `lax.conv_general_dilated`
// (speech_cloner_tpu/nn/modules.py `conv1d_banks_apply`), which the port
// ran as one cuDNN convolution. That multiplies every zero tap: K*K taps
// where the banks have K(K+1)/2. This kernel runs the nonzero taps only.
// Computes, for x [B, T_in, C] row-major and bank kernels W_k [k, C, c]
// (k = 1..K, each contiguous):
//   out[b, t, (k-1)*c + j] = sum_{i<k} sum_ch xp[b, t + off_k + i, ch] * W_k[i, ch, j]
// where xp is x with pad_left zero rows before and pad_right after each
// row b, off_k = (K-1)/2 - (k-1)/2 (bank k's offset inside the packed
// width-K conv) and t < T_out = T_in + pad_left + pad_right - K + 1. With
// TF 'same' padding (pad_left = (K-1)/2, pad_right = K/2) that is the packed
// conv's output, in the layout [B, T_out, K*c] that the batch norm reads;
// with pad 0 the caller hands in rows it padded itself (the halo rows of
// sequence-parallel shards). Sums are f32 FFMA (no TF32), as cuDNN with
// TF32 off.
//
// What bounds it on this card: operations. The decoder's second step
// (C = 256, K = 32, c = 128) does 2 * 528 * 256 * 128 = 34.6 MFLOP a frame
// and reads 1 KB of input and writes 16 KB of output; its weights
// (69 MB) are read again by every time tile, 64 FLOP a byte at 128 rows a
// tile. Float32 has no tensor-core path without TF32, so the ceiling is
// the SMs' FFMA rate (67 TFLOP/s): what matters is keeping the FFMA pipes
// fed from shared memory and registers.
//
// Design (the plan comes from ops/cuda_kernels.py `conv_banks_plan`; this
// file checks it and takes it as given):
//  - Grouped implicit GEMM over the nonzero taps. Output rows (frames) are
//    numbered densely over the batch, q = b*T_out + t, and cut into tiles of
//    kRows = 128; a bank's c columns into tiles of kCols = 128. A block
//    computes one tile of rows for one pair of banks: bank k and bank
//    K + 1 - k, so every block does K + 1 taps (16 equal blocks a row tile
//    at K = 32, 3 at K = 6; at odd K the middle bank runs alone, half a
//    block). It runs bank k's taps, writes its tile, then bank K + 1 - k's:
//    a bank of width k does k taps, not K. Every frame's sums run in one
//    order wherever its tile falls, so a clip converted in a batch gets the
//    bits of its single conversion.
//  - Input staged once. The block copies the rows its tile reads (the
//    tile's 128 frames plus K - 1 halo rows, and K - 1 more for each batch
//    row the tile crosses; zeros where the padding lies) into shared memory
//    once, with cp.async, in the channels [ch_begin, ch_begin + ch_count) of
//    this launch. Every tap of both banks reads that tile shifted by its
//    tap's row offset: no im2col in device memory, no reload per tap. Rows
//    are padded to a stride of 4 mod 8 words, so the four distinct rows a
//    quarter-warp reads at once fall in distinct banks of shared memory.
//  - Weights through a ring. A stage is one tap of one bank over kDepth =
//    32 channels x 128 columns (16 KB, 2048 FFMA a thread); two stages, one
//    filling by cp.async while the other is read; one barrier a stage. The
//    depth is what the speed rests on: the barriers and each stage's
//    bookkeeping cost, at the decoder's second step on an H100 (59 x 400
//    frames), 48% of the float32 peak at 8 channels a stage, 57% at 16 and
//    63% at 32. The stage loop is compiled once for each case of 16-byte
//    weight copies and of whole stages, so it carries no branch for them.
//  - Register tiling. 256 threads, 8 warps as 4 (rows) x 2 (columns), a
//    warp 32 x 64, a lane 8 rows (strided by 4) x 8 columns (two runs of
//    4): 64 f32 sums a thread. For every 4 channels a thread reads its 8
//    rows' 4 channels and 4 x 8 weights, 16 loads of 16 bytes, and issues
//    256 FFMA; those loads are as much as shared memory delivers at the
//    FFMA pipes' rate. (Windows over consecutive taps, which read each input
//    row once for several taps, measured slower on this card: 55-60%.)
//  - No transposes: x is read as [B, T_in, C] and the output written as
//    [B, T_out, K*c], 16 bytes a thread where the widths allow.
//  - Channels beyond what fits. A launch reduces the channels it is given;
//    where the input tile of all C channels does not fit in shared memory,
//    the wrapper launches once per channel chunk, the later launches adding
//    to the output (`accumulate`). Every shape of the models fits in one.
//
// One 256-thread block an SM (its input tile takes up to 193 KB at
// C = 256, K = 32).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kRows = 128;      // output frames a tile
constexpr int kCols = 128;      // output columns of a bank a tile
constexpr int kDepth = 32;      // input channels a stage
constexpr int kRing = 2;        // stages
constexpr int kThreads = 256;
constexpr int kMaxBanks = 128;
constexpr int kStage = kDepth * kCols;

struct Banks {
  const float* w[kMaxBanks];    // W_k [k, C, c] at w[k - 1]
};

struct Shape {
  int B, T_in, C, K, c;
  int pad_left, T_out;
  int ch_begin, ch_count, ch_round;   // this launch's channels, and them rounded up to 4
  int x_stride;                       // the input tile's row stride in shared memory
  int n_tiles, n_col_tiles;
  int x_vec, out_vec;                 // 16-byte copies and stores where the widths allow
  int accumulate;                     // add to the output (a later channel chunk)
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 4 channels of one tap: the thread's 8 rows' 4 channels (xa + xoff[r]) and
// the 4 channels' weights at the thread's columns (wb, kCols apart), 256 FFMA.
__device__ __forceinline__ void four_channels(float (&acc)[8][8], const float* xa,
                                              const int (&xoff)[8], const float* wb) {
  float4 a[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) a[r] = *reinterpret_cast<const float4*>(xa + xoff[r]);
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const float4 b0 = *reinterpret_cast<const float4*>(wb + cc * kCols);
    const float4 b1 = *reinterpret_cast<const float4*>(wb + cc * kCols + 32);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float av = lane4(a[r], cc);
      acc[r][0] = fmaf(av, b0.x, acc[r][0]);
      acc[r][1] = fmaf(av, b0.y, acc[r][1]);
      acc[r][2] = fmaf(av, b0.z, acc[r][2]);
      acc[r][3] = fmaf(av, b0.w, acc[r][3]);
      acc[r][4] = fmaf(av, b1.x, acc[r][4]);
      acc[r][5] = fmaf(av, b1.y, acc[r][5]);
      acc[r][6] = fmaf(av, b1.z, acc[r][6]);
      acc[r][7] = fmaf(av, b1.w, acc[r][7]);
    }
  }
}

// kVecW: the weights' rows are copied 16 bytes at a time (c a multiple of 4,
// aligned); kWhole: every stage holds kDepth channels. Each instance keeps
// its stage loop free of the other cases' branches.
template <bool kVecW, bool kWhole>
__global__ void __launch_bounds__(kThreads, 1)
    conv_banks_kernel(const float* __restrict__ x, const __grid_constant__ Banks banks,
                      float* __restrict__ out, const Shape s) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                  // [kRing][kDepth][kCols]
  float* xs = smem + kRing * kStage;                 // [x_rows][x_stride]

  // the block's work: a row tile, a column tile, a pair of banks
  int item = blockIdx.x;
  const int tile = item % s.n_tiles;
  item /= s.n_tiles;
  const int ct = item % s.n_col_tiles;
  const int pair = item / s.n_col_tiles;
  const int kA = pair + 1, kB = s.K - pair;          // bank widths; kA == kB: the middle bank
  const int nbanks = kA == kB ? 1 : 2;
  const int nchunk = (s.ch_round + kDepth - 1) / kDepth;
  const int stagesA = kA * nchunk;                   // a stage: one tap, kDepth channels
  const int n_stages = stagesA + (nbanks == 2 ? kB * nchunk : 0);
  const float* wA = banks.w[kA - 1];
  const float* wB = banks.w[kB - 1];
  const int col0 = ct * kCols;

  const int halo = s.K - 1;
  const int Tp = s.T_out + halo;                     // padded row length
  const int n_out = s.B * s.T_out;
  const int q0 = tile * kRows;
  const int b0 = q0 / s.T_out;
  const int v0 = q0 + halo * b0;                     // padded row index of the first output
  const int q_last = min(q0 + kRows, n_out) - 1;
  const int rows = q_last + halo * (q_last / s.T_out) + s.K - v0;
  const int tid = threadIdx.x;

  // the input tile, once: padded rows v0 .. v0 + rows - 1, zero in the padding
  {
    const int quads = s.ch_round / 4;
    for (int i = tid; i < rows * quads; i += kThreads) {
      const int r = i / quads, ch = (i - r * quads) * 4;
      const int v = v0 + r, b = v / Tp, t = v - b * Tp - s.pad_left;
      const bool row_ok = b < s.B && t >= 0 && t < s.T_in;
      const float* src = x + ((long long)b * s.T_in + t) * s.C + s.ch_begin + ch;
      float* dst = xs + r * s.x_stride + ch;
      if (s.x_vec) {
        const bool ok = row_ok && ch < s.ch_count;
        cp_async16(dst, ok ? src : x, ok);
      } else {
        for (int e = 0; e < 4; ++e) {
          const bool ok = row_ok && ch + e < s.ch_count;
          cp_async4(dst + e, ok ? src + e : x, ok);
        }
      }
    }
    cp_async_commit();
  }

  // stage st: bank A's taps, then bank B's; in each tap, chunks of kDepth channels
  auto load_w = [&](int st) {
    if (st < n_stages) {
      const bool in_a = st < stagesA;
      const int sb = in_a ? st : st - stagesA;
      const int tap = sb / nchunk, chunk = sb - tap * nchunk;
      const float* w = (in_a ? wA : wB) + (long long)tap * s.C * s.c;
      float* slot = ws + (st % kRing) * kStage;
#pragma unroll
      for (int h = 0; h < kStage / 4 / kThreads; ++h) {
        const int e = (tid + h * kThreads) * 4;        // [channel][column]
        const int d = e / kCols, col = e % kCols;
        const int ch = chunk * kDepth + d;
        const bool row_ok = ch < s.ch_count;
        const float* src = w + (long long)(s.ch_begin + ch) * s.c + col0 + col;
        if (kVecW) {
          const bool ok = row_ok && col0 + col < s.c;
          cp_async16(slot + e, ok ? src : wA, ok);
        } else {
          for (int j = 0; j < 4; ++j) {
            const bool ok = row_ok && col0 + col + j < s.c;
            cp_async4(slot + e + j, ok ? src + j : wA, ok);
          }
        }
      }
    }
    cp_async_commit();
  };

  const int warp = tid / 32, lane = tid % 32;
  const int lr = lane & 3, lc = lane >> 2;
  const int m_base = (warp & 3) * 32 + lr;           // rows m_base + 4r
  const int n_base = (warp >> 2) * 64 + lc * 4;      // columns n_base + {0..3}, + 32 + {0..3}
  int xoff[8];                                       // each row's tile row, times the stride
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = m_base + 4 * r;
    const int q = min(q0 + m, n_out - 1);            // rows past the end read a staged row
    xoff[r] = (m + halo * (q / s.T_out - b0)) * s.x_stride;
  }

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  load_w(0);
  int st = 0;
  for (int bank = 0; bank < nbanks; ++bank) {
    const int k = bank == 0 ? kA : kB;
    const int u_bank = (s.K - 1) / 2 - (k - 1) / 2;  // bank k's first tap's row offset
    for (const int st_end = bank == 0 ? stagesA : n_stages; st < st_end; ++st) {
      cp_async_wait_all();                           // the input tile and stage st are in
      __syncthreads();                               // and every thread is done with stage st - 1
      load_w(st + 1);
      const int sb = bank == 0 ? st : st - stagesA;
      const int tap = sb / nchunk, chunk = sb - tap * nchunk;
      const float* xa = xs + (u_bank + tap) * s.x_stride + chunk * kDepth;
      const float* wb = ws + (st % kRing) * kStage + n_base;
      if (kWhole) {
#pragma unroll
        for (int kk = 0; kk < kDepth; kk += 4) four_channels(acc, xa + kk, xoff, wb + kk * kCols);
      } else {
        const int depth = min(kDepth, s.ch_round - chunk * kDepth);
        for (int kk = 0; kk < depth; kk += 4) four_channels(acc, xa + kk, xoff, wb + kk * kCols);
      }
    }
    // bank k's tile out, sums cleared
    const long long Kc = (long long)s.K * s.c;
    float* o = out + (long long)(k - 1) * s.c + col0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int q = q0 + m_base + 4 * r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n_base + 32 * h;
        if (q < n_out) {
          float* p = o + q * Kc + col;
          if (s.out_vec) {
            if (col0 + col < s.c) {
              float4 v = make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                                     acc[r][4 * h + 3]);
              if (s.accumulate) {
                const float4 u = *reinterpret_cast<const float4*>(p);
                v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
              }
              *reinterpret_cast<float4*>(p) = v;
            }
          } else {
            for (int e = 0; e < 4; ++e)
              if (col0 + col + e < s.c) p[e] = acc[r][4 * h + e] + (s.accumulate ? p[e] : 0.f);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][4 * h + e] = 0.f;
      }
    }
  }
  cp_async_wait_all();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The input tile's row stride for `ch_round` channels: 4 more, or 8 where that
// would be a multiple of 16 words (rows 1 apart would then share banks).
int x_stride(int ch_round) { return ch_round + ((ch_round + 4) % 16 == 0 ? 8 : 4); }

}  // namespace

extern "C" {

// Bytes of shared memory a launch needs: the ring of weight stages and the
// input tile [x_rows][x_stride(ch_round)], f32.
long long scl_conv_banks_smem_bytes(int x_rows, int ch_round) {
  return 4LL * kRing * kStage + 4LL * x_rows * x_stride(ch_round);
}

// The bank convolutions of x [B, T_in, C] (f32, row-major) with the K bank
// kernels w[k - 1] = W_k [k, C, c] (f32, contiguous) over the input channels
// [ch_begin, ch_begin + ch_count), into out [B, T_out, K*c]; with
// `accumulate` the sums are added to out (a later channel chunk). The plan
// (ops/cuda_kernels.py conv_banks_plan): `x_rows` rows of the input tile,
// channels of a chunk rounded to `ch_round`, `smem` bytes. Returns the CUDA
// error of the launch (0 = launched); cudaErrorInvalidValue for a shape or
// plan the kernel does not take.
int scl_conv_banks_f32(const float* x, const float* const* w, float* out, int B, int T_in,
                       int C, int K, int c, int pad_left, int pad_right, int ch_begin,
                       int ch_count, int ch_round, int x_rows, int accumulate, long long smem,
                       void* stream) {
  const int T_out = T_in + pad_left + pad_right - K + 1;
  if (B < 1 || T_in < 1 || C < 1 || c < 1 || K < 1 || K > kMaxBanks || pad_left < 0 ||
      pad_right < 0 || T_out < 1)
    return (int)cudaErrorInvalidValue;
  if (ch_begin < 0 || ch_count < 1 || ch_begin + ch_count > C || ch_round % 4 != 0 ||
      ch_round < ch_count || ch_round - ch_count >= 4)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * T_out > INT_MAX - kRows || (long long)B * (T_out + K - 1) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  // the most batch rows a tile crosses, and the input rows it then reads
  const long long crossed = (long long)(kRows - 1 + T_out - 1) / T_out;
  const long long need = kRows + (long long)(K - 1) * (1 + (crossed < B - 1 ? crossed : B - 1));
  if (x_rows < need || smem != scl_conv_banks_smem_bytes(x_rows, ch_round))
    return (int)cudaErrorInvalidValue;
  Banks banks;
  bool w_aligned = true;
  for (int k = 0; k < K; ++k) {
    if (w[k] == nullptr) return (int)cudaErrorInvalidValue;
    banks.w[k] = w[k];
    w_aligned = w_aligned && aligned16(w[k]);
  }
  for (int k = K; k < kMaxBanks; ++k) banks.w[k] = nullptr;
  Shape s;
  s.B = B; s.T_in = T_in; s.C = C; s.K = K; s.c = c;
  s.pad_left = pad_left; s.T_out = T_out;
  s.ch_begin = ch_begin; s.ch_count = ch_count; s.ch_round = ch_round;
  s.x_stride = x_stride(ch_round);
  s.n_tiles = (int)(((long long)B * T_out + kRows - 1) / kRows);
  s.n_col_tiles = (c + kCols - 1) / kCols;
  s.x_vec = C % 4 == 0 && ch_begin % 4 == 0 && aligned16(x);
  s.out_vec = c % 4 == 0 && aligned16(out);
  s.accumulate = accumulate != 0;
  const long long blocks = (long long)s.n_tiles * s.n_col_tiles * ((K + 1) / 2);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec_w = c % 4 == 0 && w_aligned, whole = ch_round % kDepth == 0;
  auto kernel = vec_w ? (whole ? conv_banks_kernel<true, true> : conv_banks_kernel<true, false>)
                      : (whole ? conv_banks_kernel<false, true> : conv_banks_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(x, banks, out, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
