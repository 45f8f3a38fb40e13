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
// lanes; here the layout is the one the PyTorch epilogue reads. Since x
// is contiguous, its B*L rows form one (B*L, D) matrix and the kernel is
// one (B*L, D) x (D, TH) product.
//
// What bounds it on an H100: memory. At the MNIST selection shape
// (B=16, L=200, D=128, TH=32, fp32) it reads 1.64 MB of x and writes
// 0.41 MB of logits, 0.6 us at 3.35 TB/s; at the camelyon shape
// (1, 10000, 512) x (512, 8) in bf16, 10.2 MB, 3.2 us. So the design
// puts as many bytes in flight as it can and keeps the arithmetic off
// the critical path:
//   - one small block per 16 rows (200 blocks at MNIST, 625 at camelyon),
//     all resident at once (the kernels ask for the whole SM's shared
//     memory), each issuing its x tile and the matching rows of W_eff as
//     16-byte cp.async copies into shared memory. A D that is not a
//     multiple of the vector width (or a misaligned x) copies element by
//     element;
//   - fp32: exact fp32 FMA (no TF32), D in chunks of 64, two chunks in
//     flight: chunk c+1 lands while chunk c is summed (D=128: both at
//     once, one barrier each). Each thread owns a 1x4 or 2x4 (row,
//     column) register tile; each k-step of 4 reads one float4 of x per
//     row and four float4 rows of W_eff for 16 or 32 FMAs. The sum runs
//     over d in order, one fp32 FMA chain per output;
//   - bf16: tensor cores, mma.sync m16n8k16 (bf16 products are exact,
//     fp32 accumulation), ceil(TH/8) n8 tiles. The 16 rows are one m16
//     tile; D is staged in chunks of 512 (TH <= 16) or 256, so D=512 is
//     one chunk and one barrier; the four warps split its k16 steps and
//     their partial sums are added in a fixed order through shared
//     memory (no atomics).
// Outputs of rows past B*L and of columns past TH are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;      // rows of x per block
constexpr int kMaxTH = 64;     // largest TH taken
constexpr int kDcF32 = 64;     // fp32 D chunk

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// f(r, c) for every r < kRows and c < n; n is a literal in the common
// case (a whole D chunk), so the division compiles to a multiply.
template <int kThreads, typename F>
__device__ __forceinline__ void for_tile(int n, F f) {
  for (int v = threadIdx.x; v < kRows * n; v += kThreads) f(v / n, v % n);
}

// ------------------------------------------------------------------ fp32
// NCG = column groups of 4 (TH rounded up to 4, then to a power of two).
template <int NCG>
struct F32 {
  static constexpr int kRPT = NCG >= 8 ? 2 : 1;       // rows per thread
  static constexpr int kThreads = kRows * NCG / kRPT; // 16 .. 128
  static constexpr int kCols = 4 * NCG;               // W_eff smem row
  static constexpr int kXStride = kDcF32 + 4;         // x smem row
};

template <int NCG>
__global__ void __launch_bounds__(F32<NCG>::kThreads)
logits_f32(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ out, long long R, int D, int TH, int x_vec,
           int w_vec) {
  using C = F32<NCG>;
  constexpr int kXElems = kRows * C::kXStride, kWElems = kDcF32 * C::kCols;
  __shared__ __align__(16) float xs[2 * kXElems];
  __shared__ __align__(16) float ws[2 * kWElems];

  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(R - r0 < kRows ? R - r0 : kRows);
  const float* xb = x + r0 * D;
  const int cg = tid % NCG, rg = tid / NCG;
  const int n_chunks = (D + kDcF32 - 1) / kDcF32;

  // Copy D chunk `c` into buffer `buf`: x rows (zero past kw, and past the
  // last row on the element path), W_eff rows k0 .. k0+kw (zero to kw4).
  // Always commits one cp.async group, empty past the last chunk.
  auto stage = [&](int c, int buf) {
    if (c < n_chunks) {
      float* xd = xs + buf * kXElems;
      float* wd = ws + buf * kWElems;
      const int k0 = c * kDcF32, kw = min(kDcF32, D - k0);
      const int kw4 = (kw + 3) & ~3;
      if (x_vec) {
        auto cp = [&](int r, int v) {
          if (r < rows) {
            cp_async16(xd + r * C::kXStride + 4 * v,
                       xb + static_cast<long long>(r) * D + k0 + 4 * v);
          }
        };
        if (kw == kDcF32) {
          for_tile<C::kThreads>(kDcF32 / 4, cp);
        } else {
          for_tile<C::kThreads>(kw / 4, cp);
        }
      } else {
        for_tile<C::kThreads>(kw4, [&](int r, int k) {
          if (r < rows && k < kw) {
            cp_async4(xd + r * C::kXStride + k,
                      xb + static_cast<long long>(r) * D + k0 + k);
          } else {
            xd[r * C::kXStride + k] = 0.f;
          }
        });
      }
      const float* wk = w + static_cast<long long>(k0) * TH;
      if (w_vec && TH == C::kCols) {   // W_eff rows match smem rows
        for (int v = tid; v < kw * TH / 4; v += C::kThreads) {
          cp_async16(wd + 4 * v, wk + 4 * v);
        }
      } else {
        for (int v = tid; v < kw * TH; v += C::kThreads) {
          cp_async4(wd + (v / TH) * C::kCols + v % TH, wk + v);
        }
      }
      for (int v = tid; v < (kw4 - kw) * C::kCols; v += C::kThreads) {
        wd[kw * C::kCols + v] = 0.f;
      }
    }
    cp_async_commit();
  };

  float acc[C::kRPT][4];
#pragma unroll
  for (int i = 0; i < C::kRPT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // two-stage pipeline over D: chunk c+1 is in flight while c is summed
  stage(0, 0);
  stage(1, 1);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();                // chunk c has landed
    __syncthreads();
    const float* xc = xs + (c & 1) * kXElems;
    const float* wc = ws + (c & 1) * kWElems;
    const int kw4 = (min(kDcF32, D - c * kDcF32) + 3) & ~3;
#pragma unroll 4
    for (int k = 0; k < kw4; k += 4) {
      float4 xv[C::kRPT], wv[4];
#pragma unroll
      for (int i = 0; i < C::kRPT; ++i) {
        xv[i] = *reinterpret_cast<const float4*>(
            xc + (rg + i * (kRows / C::kRPT)) * C::kXStride + k);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        wv[u] = *reinterpret_cast<const float4*>(wc + (k + u) * C::kCols +
                                                 4 * cg);
      }
#pragma unroll
      for (int i = 0; i < C::kRPT; ++i) {
        const float xk[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(xk[u], wv[u].x, acc[i][0]);
          acc[i][1] = fmaf(xk[u], wv[u].y, acc[i][1]);
          acc[i][2] = fmaf(xk[u], wv[u].z, acc[i][2]);
          acc[i][3] = fmaf(xk[u], wv[u].w, acc[i][3]);
        }
      }
    }
    if (c + 2 < n_chunks) __syncthreads();   // buffer c & 1 is free again
    stage(c + 2, c & 1);
  }

  const int c0 = 4 * cg;
  if (c0 >= TH) return;
#pragma unroll
  for (int i = 0; i < C::kRPT; ++i) {
    const int r = rg + i * (kRows / C::kRPT);
    if (r >= rows) continue;
    float* o = out + (r0 + r) * TH + c0;
    if (TH % 4 == 0) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c0 + e < TH) o[e] = acc[i][e];
      }
    }
  }
}

// ------------------------------------------------------------------ bf16
constexpr int kWarpsB = 4;
constexpr int kThreadsB = 32 * kWarpsB;

// NT = n8 tiles (ceil(TH / 8)).
template <int NT>
struct B16 {
  static constexpr int kDc = NT <= 2 ? 512 : 256;          // D chunk
  static constexpr int kXStride = kDc + 8;                 // bf16
  // W_eff smem row: an odd number of 16-byte units, so the eight rows of
  // an ldmatrix phase fall in distinct banks
  static constexpr int kWStride = (NT % 2 ? NT : NT + 1) * 8;
  static constexpr int kXBytes = kRows * kXStride * 2;
  static constexpr int kWBytes = kDc * kWStride * 2;
  static_assert(kXBytes % 16 == 0, "x tile alignment");
  static_assert(kWBytes >= 4 * (kWarpsB - 1) * NT * 32 * 4,
                "the reduction reuses the W_eff tile");
  static_assert(kXBytes + kWBytes <= 48 * 1024, "static shared memory");
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a * b for one 16x8 tile, K = 16.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__global__ void __launch_bounds__(kThreadsB)
logits_bf16(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
            long long R, int D, int TH, int x_vec, int w_vec) {
  using C = B16<NT>;
  __shared__ __align__(16) unsigned char smem[C::kXBytes + C::kWBytes];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + C::kXBytes);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(R - r0 < kRows ? R - r0 : kRows);
  const __nv_bfloat16* xb = x + r0 * D;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // ldmatrix row addresses: A rows (lane & 15), k half (lane >> 4); B
  // (transposed) k rows 0-15 from lanes 0-15, n8 tile +1 from lanes 16-31
  const int a_off = (lane & 15) * C::kXStride + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * C::kWStride +
                    (lane >> 4) * 8;

  for (int k0 = 0; k0 < D; k0 += C::kDc) {
    const int kw = min(C::kDc, D - k0);
    const int kw16 = (kw + 15) & ~15;
    if (k0 > 0) __syncthreads();
    if (x_vec) {
      auto cp = [&](int r, int v) {
        if (r < rows) {
          cp_async16(xs + r * C::kXStride + 8 * v,
                     xb + static_cast<long long>(r) * D + k0 + 8 * v);
        }
      };
      if (kw == C::kDc) {
        for_tile<kThreadsB>(C::kDc / 8, cp);
      } else {
        for_tile<kThreadsB>(kw / 8, cp);
      }
      for_tile<kThreadsB>(kw16 - kw, [&](int r, int c) {
        xs[r * C::kXStride + kw + c] = zero;
      });
    } else {
      for_tile<kThreadsB>(kw16, [&](int r, int c) {
        xs[r * C::kXStride + c] =
            (r < rows && c < kw) ? xb[static_cast<long long>(r) * D + k0 + c]
                                 : zero;
      });
    }
    const __nv_bfloat16* wk = w + static_cast<long long>(k0) * TH;
    if (w_vec && TH == 8 * NT) {   // W_eff rows: whole 16-byte units
      for (int v = tid; v < kw * NT; v += kThreadsB) {
        const int k = v / NT, c = (v % NT) * 8;
        cp_async16(ws + k * C::kWStride + c,
                   wk + static_cast<long long>(k) * TH + c);
      }
    } else {
      for (int v = tid; v < kw * TH; v += kThreadsB) {
        ws[(v / TH) * C::kWStride + v % TH] = wk[v];
      }
    }
    for (int v = tid; v < (kw16 - kw) * C::kWStride; v += kThreadsB) {
      ws[kw * C::kWStride + v] = zero;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int ks = warp * 16; ks < kw16; ks += kWarpsB * 16) {
      uint32_t a[4];
      ldmatrix_x4(a, xs + a_off + ks);
#pragma unroll
      for (int j = 0; j + 1 < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, ws + b_off + ks * C::kWStride + j * 8);
        mma_bf16(acc[j], a, r[0], r[1]);
        mma_bf16(acc[j + 1], a, r[2], r[3]);
      }
      if (NT % 2) {
        uint32_t r[2];
        ldmatrix_x2_trans(r, ws + b_off + ks * C::kWStride + (NT - 1) * 8);
        mma_bf16(acc[NT - 1], a, r[0], r[1]);
      }
    }
  }

  // Sum the four warps' partial tiles in warp order: warps 1-3 leave
  // theirs in the W_eff tile's room, warp 0 adds them and stores.
  __syncthreads();
  float* red = reinterpret_cast<float*>(ws);
  if (warp > 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(((warp - 1) * NT + j) * 4 + e) * 32 + lane] = acc[j][e];
  }
  __syncthreads();
  if (warp > 0) return;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = acc[j][e];
#pragma unroll
      for (int q = 0; q < kWarpsB - 1; ++q) {
        s += red[((q * NT + j) * 4 + e) * 32 + lane];
      }
      acc[j][e] = s;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half, c = j * 8 + t2;
      if (r >= rows || c >= TH) continue;
      float* o = out + (r0 + r) * TH + c;
      if (TH % 2 == 0) {
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      } else {
        o[0] = acc[j][2 * half];
        if (c + 1 < TH) o[1] = acc[j][2 * half + 1];
      }
    }
  }
}

template <int NCG>
void launch_f32(const void* x, const void* w, void* out, long long R, int D,
                int TH, int x_vec, int w_vec, unsigned grid,
                cudaStream_t s) {
  // as much shared memory as the SM has, so that every block of a call is
  // resident at once (a hint, set once)
  static const cudaError_t carveout = cudaFuncSetAttribute(
      logits_f32<NCG>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  (void)carveout;
  logits_f32<NCG><<<grid, F32<NCG>::kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), R, D, TH, x_vec, w_vec);
}

template <int NT>
void launch_bf16(const void* x, const void* w, void* out, long long R, int D,
                 int TH, int x_vec, int w_vec, unsigned grid,
                 cudaStream_t s) {
  static const cudaError_t carveout = cudaFuncSetAttribute(
      logits_bf16<NT>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  (void)carveout;
  logits_bf16<NT><<<grid, kThreadsB, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), R, D,
      TH, x_vec, w_vec);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

int score_logits_max_th() { return kMaxTH; }

const char* score_logits_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success). out must be 16-byte aligned.
int score_logits(const void* x, const void* w, void* out, int B, int L,
                 int D, int TH, int x_is_bf16, int device, void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || D <= 0 || TH <= 0 || TH > kMaxTH ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long R = static_cast<long long>(B) * L;
  const unsigned grid = static_cast<unsigned>((R + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w_vec = aligned16(w);
  if (x_is_bf16) {
    const int x_vec = D % 8 == 0 && aligned16(x);
    const int nt = (TH + 7) / 8;
    void (*launch)(const void*, const void*, void*, long long, int, int,
                   int, int, unsigned, cudaStream_t);
    switch (nt) {
      case 1: launch = launch_bf16<1>; break;
      case 2: launch = launch_bf16<2>; break;
      case 3: launch = launch_bf16<3>; break;
      case 4: launch = launch_bf16<4>; break;
      case 5: launch = launch_bf16<5>; break;
      case 6: launch = launch_bf16<6>; break;
      case 7: launch = launch_bf16<7>; break;
      default: launch = launch_bf16<8>; break;
    }
    launch(x, w, out, R, D, TH, x_vec, w_vec, grid, s);
  } else {
    const int x_vec = D % 4 == 0 && aligned16(x);
    const int ncg4 = (TH + 3) / 4;
    if (ncg4 <= 1) {
      launch_f32<1>(x, w, out, R, D, TH, x_vec, w_vec, grid, s);
    } else if (ncg4 <= 2) {
      launch_f32<2>(x, w, out, R, D, TH, x_vec, w_vec, grid, s);
    } else if (ncg4 <= 4) {
      launch_f32<4>(x, w, out, R, D, TH, x_vec, w_vec, grid, s);
    } else if (ncg4 <= 8) {
      launch_f32<8>(x, w, out, R, D, TH, x_vec, w_vec, grid, s);
    } else {
      launch_f32<16>(x, w, out, R, D, TH, x_vec, w_vec, grid, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
