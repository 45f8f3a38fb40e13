// Saliency logits of IPS selection:
//     out[b, l, t] = sum_d x[b, l, d] * w[d, t]      (fp32 accumulation)
//
// Replaces the TPU kernel ips_tpu/ops/score_kernel.py:_logits_kernel
// (launched by _pallas_logits, wrapped by pallas_scores). The masked
// softmax over L and the mean over the T*H columns stay in PyTorch, as
// the reference leaves them to XLA after its kernel.
//
// x is (B, L, D), fp32 or bf16, contiguous; w is the query-folded key
// projection W_eff (D, TH) in x's dtype; out is (B, L, TH) fp32. The
// TPU kernel wrote its output transposed, (TH_pad, L_pad), for the TPU's
// lanes; here the layout is the one the PyTorch epilogue reads.
//
// What bounds it on an H100: memory. At the MNIST selection shape
// (B=16, L=200, D=128, TH=32, fp32) it reads 1.64 MB of x and writes
// 0.41 MB of logits, 0.6 us at 3.35 TB/s, against 26 MFLOP, 0.4 us at
// the fp32 rate; at that size the launch itself costs more than either.
// The design is the simple one: one block per (L tile of kRows rows,
// batch row); the block walks D in slices of kDepth, staging a slice of
// x (coalesced: consecutive threads read consecutive d of one row) and
// the matching rows of W_eff in shared memory as fp32; each thread keeps
// up to kAcc (l, t) sums in registers. Each slice's global loads are all
// in flight at once before they are stored to shared memory. x is never
// padded: rows past L are not read (bounds checks) and their outputs are
// not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;                           // L rows per block
constexpr int kDepth = 64;                          // D slice per step
constexpr int kMaxTH = 64;                          // largest TH taken
constexpr int kThreads = 256;
constexpr int kAcc = kRows * kMaxTH / kThreads;     // sums per thread
constexpr int kXLoads = kRows * kDepth / kThreads;  // x loads per slice
constexpr int kWLoads = kDepth * kMaxTH / kThreads; // W_eff loads per slice

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
score_logits_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    float* __restrict__ out, int L, int D, int TH) {
  __shared__ float xs[kRows][kDepth + 1];   // +1: rows fall in other banks
  __shared__ float ws[kDepth * kMaxTH];     // W_eff rows, stride TH

  const int b = blockIdx.y;
  const int l0 = blockIdx.x * kRows;
  const int rows = min(kRows, L - l0);
  const int tid = threadIdx.x;
  const int n_out = rows * TH;
  const T* xb = x + (static_cast<size_t>(b) * L + l0) * D;

  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kDepth) {
    const int kw = min(kDepth, D - k0);
    // All of a slice's global loads are issued before any is stored, so
    // their latencies overlap instead of adding up.
    float xv[kXLoads], wv[kWLoads];
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / kDepth, c = i % kDepth;
      xv[u] = (r < rows && c < kw)
                  ? to_float(xb[static_cast<size_t>(r) * D + k0 + c])
                  : 0.f;
    }
    // rows k0 .. k0+kw of W_eff are contiguous: a flat copy, no division
    const T* wk = w + static_cast<size_t>(k0) * TH;
#pragma unroll
    for (int u = 0; u < kWLoads; ++u) {
      const int i = tid + u * kThreads;
      wv[u] = (i < kw * TH) ? to_float(wk[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int i = tid + u * kThreads;
      xs[i / kDepth][i % kDepth] = xv[u];
    }
#pragma unroll
    for (int u = 0; u < kWLoads; ++u) {
      const int i = tid + u * kThreads;
      if (i < kw * TH) ws[i] = wv[u];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int o = tid + j * kThreads;
      if (o < n_out) {
        const int r = o / TH, t = o % TH;
        float s = acc[j];
#pragma unroll 8
        for (int k = 0; k < kw; ++k) {
          s = fmaf(xs[r][k], ws[k * TH + t], s);
        }
        acc[j] = s;
      }
    }
    __syncthreads();
  }

  // Output index o = r * TH + t: consecutive threads write consecutive
  // addresses of the (rows, TH) tile, which is contiguous in out.
  float* ob = out + (static_cast<size_t>(b) * L + l0) * TH;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int o = tid + j * kThreads;
    if (o < n_out) ob[o] = acc[j];
  }
}

}  // namespace

extern "C" {

int score_logits_max_th() { return kMaxTH; }

const char* score_logits_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).
int score_logits(const void* x, const void* w, void* out, int B, int L,
                 int D, int TH, int x_is_bf16, int device, void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || D <= 0 || TH <= 0 || TH > kMaxTH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kRows - 1) / kRows, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    score_logits_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), L, D,
        TH);
  } else {
    score_logits_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), L, D, TH);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
