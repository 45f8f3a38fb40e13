// One ResNet BasicBlock in eval mode, fused:
//     h = bf16(relu(conv3x3(x, w1) * s1 + b1))
//     y = bf16(relu(conv3x3(h, w2) * s2 + b2 + float(x)))
// with zero padding 1, stride 1, fp32 accumulation, and h kept on chip.
//
// Replaces the TPU kernel scripts/probe_conv.py:_pallas_block_kernel
// (launched by pallas_block, used by layer1_pallas_pair). The TPU kernel
// runs on the pair-packed layer1 layout (800, 13, 13, 128) with
// block-diagonal weights to fill its 128 lanes; this kernel takes the same
// function at any supported C, paired (C=128) or not (C=64).
//
// Layouts (the JAX kernel's): x and out (n, s, s, C) bf16 NHWC,
// contiguous; w1, w2 (9, C, C) bf16, tap-major HWIO (tap = 3*dy + dx,
// then input channel, then output channel); s1, b1, s2, b2 (C,) fp32.
//
// What bounds it on an H100: operations. At the layer1 shape
// (1600, 13, 13, 64) one block is 2 convs x 270,400 pixels x 576 x 64 x 2
// = 39.9 GFLOP, 40.3 us at the bf16 tensor-core rate, against 69 MB of
// activations in and out, 20.7 us at 3.35 TB/s.
//
// Design (simple first): one thread block per patch, 8 warps. The patch
// is an implicit GEMM, M = s*s pixels (padded to 16-row tiles), N = C,
// K = 9*C, run as nine tap GEMMs with mma.sync m16n8k16 (bf16 in, fp32
// accumulate). Shared memory holds:
//   act  (s+2)^2 positions x C channels bf16: x with a zero halo, staged
//        by cp.async; after conv 1 the block overwrites its interior with
//        h (the halo stays zero, which is conv 2's padding), so h never
//        leaves the SM;
//   wbuf two taps of weights, (C, C) each: the next tap is copied in by
//        cp.async while the current one is multiplied. Whole weights do
//        not fit at C=128 (295 KB a conv).
// Rows are padded by 8 bf16 so that ldmatrix's eight 16-byte rows fall
// in distinct banks. Warps split N in 32-column groups and M in strided
// 16-row tiles; each warp keeps its (m, n) tiles' sums in registers for
// the whole conv. The residual is read again from x in global memory in
// the last epilogue (act then holds h). Rows past s*s read a valid
// position and are never stored; there are no atomics, so the result is
// deterministic. The kernel multiplies whatever weights it is given:
// block-diagonal zeros are not skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 16;
constexpr int kRowPad = 8;   // bf16 of padding per shared-memory row
constexpr int kNT = 4;       // n8 tiles per warp: 32 output channels

template <int C>
struct Tiling {
  static constexpr int kStride = C + kRowPad;        // smem row, bf16
  static constexpr int kNGroups = C / (8 * kNT);     // warps along N
  static constexpr int kMGroups = kWarps / kNGroups; // warps along M
  static constexpr int kMaxMTiles = (kMaxS * kMaxS + 15) / 16;
  static constexpr int kMT = (kMaxMTiles + kMGroups - 1) / kMGroups;
  static constexpr int kTapElems = C * kStride;      // one tap in smem
  static_assert(C % (8 * kNT) == 0 && kWarps % kNGroups == 0,
                "C must be 32, 64 or 128");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// Copy tap `tap` of w (9, C, C) into a (C, kStride) smem buffer.
template <int C>
__device__ __forceinline__ void stage_tap(__nv_bfloat16* dst,
                                          const __nv_bfloat16* w, int tap) {
  using T = Tiling<C>;
  constexpr int kVecs = C * C / 8;
  const __nv_bfloat16* src = w + static_cast<size_t>(tap) * C * C;
  for (int v = threadIdx.x; v < kVecs; v += kThreads) {
    const int k = v / (C / 8), nv = v % (C / 8);
    cp_async16(dst + k * T::kStride + nv * 8, src + v * 8);
  }
}

// acc += conv3x3(act, w) over the warp's tiles. On entry the caller has
// issued (and committed) the copy of tap 0 into wbuf[0]; on exit every
// warp is done with act and both weight buffers.
template <int C>
__device__ __forceinline__ void conv_taps(
    float (&acc)[Tiling<C>::kMT][kNT][4], const __nv_bfloat16* act,
    __nv_bfloat16* wbuf, const __nv_bfloat16* w, const int (&a_off)[Tiling<C>::kMT],
    int s, int n_mtiles, int mg, int n_base) {
  using T = Tiling<C>;
  const int lane = threadIdx.x & 31;
  // ldmatrix.trans row addresses for B: lanes 8j..8j+7 give matrix j's
  // rows; matrices (k 0-7 | k 8-15) x (n 0-7 | n 8-15).
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * T::kStride +
                    n_base + (lane >> 4) * 8;
  for (int tap = 0; tap < 9; ++tap) {
    if (tap + 1 < 9) {
      stage_tap<C>(wbuf + ((tap + 1) & 1) * T::kTapElems, w, tap + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* wt = wbuf + (tap & 1) * T::kTapElems;
    const int tap_off = ((tap / 3) * (s + 2) + tap % 3) * T::kStride;
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 16) {
      uint32_t b[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, wt + b_off + k0 * T::kStride + j * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
        if (mg + i * T::kMGroups < n_mtiles) {
          uint32_t a[4];
          ldmatrix_x4(a, act + a_off[i] + tap_off + k0);
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
        }
      }
    }
    __syncthreads();   // the next copy overwrites the buffer just read
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
conv_block_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w1,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2,
                  const float* __restrict__ s2, const float* __restrict__ b2,
                  __nv_bfloat16* __restrict__ out, int s) {
  using T = Tiling<C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = s + 2;                      // padded side
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wbuf = act + sp * sp * T::kStride;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_pix = s * s;
  const int n_mtiles = (n_pix + 15) / 16;
  const int mg = warp / T::kNGroups;
  const int n_base = (warp % T::kNGroups) * (8 * kNT);
  const size_t patch = static_cast<size_t>(blockIdx.x) * n_pix * C;
  const __nv_bfloat16* xb = x + patch;

  // Stage x into act's interior and w1's tap 0, then zero the halo.
  for (int v = tid; v < n_pix * (C / 8); v += kThreads) {
    const int pix = v / (C / 8), cv = v % (C / 8);
    const int pos = (pix / s + 1) * sp + pix % s + 1;
    cp_async16(act + pos * T::kStride + cv * 8, xb + static_cast<size_t>(v) * 8);
  }
  stage_tap<C>(wbuf, w1, 0);
  cp_async_commit();
  const int n_halo = 4 * s + 4;
  for (int v = tid; v < n_halo * (C / 8); v += kThreads) {
    const int hp = v / (C / 8), cv = v % (C / 8);
    int py, px;
    if (hp < sp) {
      py = 0; px = hp;
    } else if (hp < 2 * sp) {
      py = s + 1; px = hp - sp;
    } else {
      py = 1 + (hp - 2 * sp) / 2;
      px = ((hp - 2 * sp) & 1) ? s + 1 : 0;
    }
    *reinterpret_cast<uint4*>(act + (py * sp + px) * T::kStride + cv * 8) =
        make_uint4(0, 0, 0, 0);
  }

  // Each lane's ldmatrix row for A: pixel m = 16*tile + (lane & 15), its
  // 3x3 window's top-left position, channel half (lane >> 4).
  int a_off[T::kMT];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i) {
    const int m = (mg + i * T::kMGroups) * 16 + (lane & 15);
    const int pos = m < n_pix ? (m / s) * sp + m % s : 0;
    a_off[i] = pos * T::kStride + (lane >> 4) * 8;
  }

  float acc[T::kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  conv_taps<C>(acc, act, wbuf, w1, a_off, s, n_mtiles, mg, n_base);

  // w2's tap 0 goes into wbuf[0] while h is written over x in act.
  stage_tap<C>(wbuf, w2, 0);
  cp_async_commit();
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = n_base + j * 8 + 2 * tig;
    const float sa = __ldg(s1 + n), sb = __ldg(s1 + n + 1);
    const float ba = __ldg(b1 + n), bb = __ldg(b1 + n + 1);
#pragma unroll
    for (int i = 0; i < T::kMT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (mg + i * T::kMGroups) * 16 + g + 8 * half;
        if (mg + i * T::kMGroups < n_mtiles && m < n_pix) {
          // round h to bf16 here, as the reference does before conv 2
          const float h0 = fmaxf(__fadd_rn(__fmul_rn(acc[i][j][2 * half], sa), ba), 0.f);
          const float h1 = fmaxf(__fadd_rn(__fmul_rn(acc[i][j][2 * half + 1], sb), bb), 0.f);
          const int pos = (m / s + 1) * sp + m % s + 1;
          *reinterpret_cast<__nv_bfloat162*>(act + pos * T::kStride + n) =
              __floats2bfloat162_rn(h0, h1);
        }
        acc[i][j][2 * half] = 0.f;
        acc[i][j][2 * half + 1] = 0.f;
      }
    }
  }
  // conv_taps' first barrier orders these stores before any warp reads h.

  conv_taps<C>(acc, act, wbuf, w2, a_off, s, n_mtiles, mg, n_base);

  __nv_bfloat16* ob = out + patch;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = n_base + j * 8 + 2 * tig;
    const float sa = __ldg(s2 + n), sb = __ldg(s2 + n + 1);
    const float ba = __ldg(b2 + n), bb = __ldg(b2 + n + 1);
#pragma unroll
    for (int i = 0; i < T::kMT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (mg + i * T::kMGroups) * 16 + g + 8 * half;
        if (mg + i * T::kMGroups < n_mtiles && m < n_pix) {
          const size_t o = static_cast<size_t>(m) * C + n;
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xb + o));
          const float y0 = __fadd_rn(
              __fadd_rn(__fmul_rn(acc[i][j][2 * half], sa), ba), r.x);
          const float y1 = __fadd_rn(
              __fadd_rn(__fmul_rn(acc[i][j][2 * half + 1], sb), bb), r.y);
          *reinterpret_cast<__nv_bfloat162*>(ob + o) =
              __floats2bfloat162_rn(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
        }
      }
    }
  }
}

template <int C>
size_t smem_bytes(int s) {
  using T = Tiling<C>;
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>(s + 2) * (s + 2) * T::kStride +
          2 * T::kTapElems);
}

template <int C>
cudaError_t launch(const void* x, const void* w1, const void* s1,
                   const void* b1, const void* w2, const void* s2,
                   const void* b2, void* out, int n, int s,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<C>(s);
  cudaError_t err = cudaFuncSetAttribute(
      conv_block_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  conv_block_kernel<C><<<n, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int conv_block_max_s() { return kMaxS; }

// 1 if the kernel takes C channels, else 0.
int conv_block_supports_c(int c) { return c == 32 || c == 64 || c == 128; }

const char* conv_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success). Every pointer must be 16-byte aligned.
int conv_block(const void* x, const void* w1, const void* s1,
               const void* b1, const void* w2, const void* s2,
               const void* b2, void* out, int n, int s, int c, int device,
               void* stream) {
  if (n <= 0 || s <= 0 || s > kMaxS || !conv_block_supports_c(c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 32: err = launch<32>(x, w1, s1, b1, w2, s2, b2, out, n, s, st); break;
    case 64: err = launch<64>(x, w1, s1, b1, w2, s2, b2, out, n, s, st); break;
    default: err = launch<128>(x, w1, s1, b1, w2, s2, b2, out, n, s, st); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
