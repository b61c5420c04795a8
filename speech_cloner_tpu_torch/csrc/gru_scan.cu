// Time-major GRU recurrence (TF GRUCell form) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `gru_scan_pallas` / `_gru_kernel` in
// speech_cloner_tpu/ops/pallas_kernels.py. Computes, with h0 = 0:
//   ru  = sigmoid(gx[t] + h @ Wg_h)            r = ru[:, :H], u = ru[:, H:]
//   c   = tanh(cx[t] + (r * h) @ Wc_h)
//   h   = u * h + (1 - u) * c ;  ys[t] = h
// gx [T,B,2H], cx [T,B,H], Wg_h [H,2H], Wc_h [H,H], ys [T,B,H], all f32,
// row-major and contiguous. Accumulation is f32 throughout.
//
// Design. On the TPU the grid walks T in order and h stays in VMEM scratch.
// Here one block owns one batch row and loops over all T steps itself, so
// h never leaves shared memory. Threads cover the 2H gate columns, so the
// reads of row-major Wg_h[k, j] are coalesced in j; h[k] is a shared-memory
// broadcast. Per step: gate matvec -> sigmoid -> r*h and u to shared memory
// -> barrier -> candidate matvec (threads j < H) -> update h, write ys[t]
// -> barrier. H need not be a multiple of 32 (H = 40): threads past 2H only
// take part in the barriers.
//
// Weights. When 3*H*H floats (plus the 3*H of state) fit in the opt-in
// shared memory of a block (H = 40: 19 KB, H = 128: 194 KB), the block
// copies them in once and every step reads shared memory. At H = 256 they
// are 768 KB, far over the 227 KB limit, and every step reads them through
// L2 (50 MB holds them for all blocks).
//
// What bounds it on this card. The roofline bound for the work is
// max(6*T*B*H^2 FLOP / 67 TFLOP/s f32, (16*T*B*H + 12*H^2) B / 3.35 TB/s):
// about 0.14 ms at H = 256, B = 59, T = 400. The kernel does not come near
// it, for two reasons left to later work:
//  - B is only 9..59 blocks against 132 SMs, so most SMs idle; and
//  - every block re-reads the weights every step (from shared memory, or
//    from L2 at H = 256), B times the bytes a shared read would need.
// Beyond both, the T = 400 dependent steps, each ending in a barrier, set a
// latency floor that the roofline does not show.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxH = 512;  // 2H gate columns <= 1024 threads per block

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

// acc = sum_k v[k] * W[k * stride + j], four independent partial sums.
__device__ __forceinline__ float matvec_col(const float* v, const float* __restrict__ W,
                                            int n, int stride, int j) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int k = 0;
  for (; k + 4 <= n; k += 4) {
    a0 = fmaf(v[k + 0], W[(size_t)(k + 0) * stride + j], a0);
    a1 = fmaf(v[k + 1], W[(size_t)(k + 1) * stride + j], a1);
    a2 = fmaf(v[k + 2], W[(size_t)(k + 2) * stride + j], a2);
    a3 = fmaf(v[k + 3], W[(size_t)(k + 3) * stride + j], a3);
  }
  for (; k < n; ++k) a0 = fmaf(v[k], W[(size_t)k * stride + j], a0);
  return (a0 + a1) + (a2 + a3);
}

template <bool kWeightsInSmem>
__global__ void __launch_bounds__(1024)
gru_scan_kernel(const float* __restrict__ gx, const float* __restrict__ cx,
                const float* __restrict__ wg, const float* __restrict__ wc,
                float* __restrict__ ys, int T, int B, int H) {
  extern __shared__ float smem[];
  const int H2 = 2 * H;
  float* h = smem;        // [H]  hidden state
  float* rh = h + H;      // [H]  r * h
  float* u = rh + H;      // [H]  update gate
  const float* Wg = wg;
  const float* Wc = wc;
  if constexpr (kWeightsInSmem) {
    float* wg_s = u + H;             // [H, 2H]
    float* wc_s = wg_s + H * H2;     // [H, H]
    for (int i = threadIdx.x; i < H * H2; i += blockDim.x) wg_s[i] = wg[i];
    for (int i = threadIdx.x; i < H * H; i += blockDim.x) wc_s[i] = wc[i];
    Wg = wg_s;
    Wc = wc_s;
  }
  for (int i = threadIdx.x; i < H; i += blockDim.x) h[i] = 0.0f;
  __syncthreads();

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  for (int t = 0; t < T; ++t) {
    const size_t row = (size_t)t * B + b;
    if (j < H2) {
      const float g = sigmoid_f32(gx[row * H2 + j] + matvec_col(h, Wg, H, H2, j));
      if (j < H) {
        rh[j] = g * h[j];
      } else {
        u[j - H] = g;
      }
    }
    __syncthreads();
    if (j < H) {
      const float c = tanhf(cx[row * H + j] + matvec_col(rh, Wc, H, H, j));
      const float uj = u[j];
      const float hn = uj * h[j] + (1.0f - uj) * c;
      h[j] = hn;
      ys[row * H + j] = hn;
    }
    __syncthreads();
  }
}

size_t state_bytes(int H) { return (size_t)3 * H * sizeof(float); }
size_t weight_bytes(int H) { return (size_t)3 * H * H * sizeof(float); }

}  // namespace

extern "C" {

// Dynamic shared memory the launch for this H uses (weights included when
// they fit), or -1 for an H the kernel does not take.
long long scl_gru_scan_smem_bytes(int H) {
  if (H <= 0 || H > kMaxH) return -1;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  const size_t all = state_bytes(H) + weight_bytes(H);
  return (long long)(all <= (size_t)optin ? all : state_bytes(H));
}

// Launches the scan on `stream` and returns cudaGetLastError() (0 = launched).
int scl_gru_scan_f32(const float* gx, const float* cx, const float* wg, const float* wc,
                     float* ys, int T, int B, int H, void* stream) {
  if (T < 0 || B < 0 || H <= 0 || H > kMaxH) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0) return (int)cudaSuccess;
  const long long smem = scl_gru_scan_smem_bytes(H);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const int threads = ((2 * H + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((size_t)smem > state_bytes(H)) {
    cudaError_t e = cudaFuncSetAttribute(gru_scan_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    gru_scan_kernel<true><<<B, threads, (size_t)smem, s>>>(gx, cx, wg, wc, ys, T, B, H);
  } else {
    gru_scan_kernel<false><<<B, threads, (size_t)smem, s>>>(gx, cx, wg, wc, ys, T, B, H);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
