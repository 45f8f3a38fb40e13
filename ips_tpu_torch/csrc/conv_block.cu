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
// Both designs below are persistent: one block per SM (grid = min(work,
// SMs)) walks its share of the patches, with two activation buffers
// where they fit, so that the next patch's x is copied in by cp.async
// while this one computes (with one buffer the copy overlaps the last
// epilogue). Halos are zeroed once per block: no copy ever writes them.
// h is written over x in shared memory and never leaves the SM; the
// residual is read again from x in global memory. The epilogues use
// __fmul_rn/__fadd_rn so that nothing is contracted into an FMA the
// reference does not do, and round h to bf16 before conv 2. There are
// no atomics and every patch is computed by the same code whichever
// block takes it, so the result is deterministic. The kernels multiply
// whatever weights they are given: block-diagonal zeros are not skipped.
//
// C = 64 and 128 (the layer1 and layer2 widths) run on Hopper's
// warpgroup MMA (namespace wg); C = 32 on mma.sync (namespace ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxS = 16;

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

// ------------------------------------------------------- C = 32: mma.sync
// One patch is an implicit GEMM, M = s*s pixels (16-row tiles), N = C,
// K = 9*C, run as nine tap GEMMs with mma.sync m16n8k16 from ldmatrix
// fragments. act is (s+2)^2 positions x C channels with a zero halo, rows
// padded by 8 bf16 so that ldmatrix's eight rows fall in distinct banks;
// both convs' weights stay in shared memory. 8 warps each own 16-row
// tiles mg, mg+8 and all 32 columns; a conv's 9 x 2 k16 steps run as one
// unrolled sequence with the next step's fragments loaded before this
// step's mma. 3 barriers a patch.
namespace ms {

constexpr int kC = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStride = kC + 8;                   // smem row, bf16
constexpr int kNT = kC / 8;                       // n8 tiles per warp
constexpr int kMT = (kMaxS * kMaxS / 16 + kWarps - 1) / kWarps;
constexpr int kTapElems = kC * kStride;           // one tap in smem
constexpr int kWBytes = 18 * kTapElems * 2;

__host__ __device__ constexpr int act_bytes(int s) {
  return (s + 2) * (s + 2) * kStride * 2;
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

// The fragments of one k16 step for the warp's first NV m-tiles: B (the
// tap's weights) by ldmatrix.trans, A (act shifted by the tap) by
// ldmatrix.
template <int NV>
__device__ __forceinline__ void load_frags(
    uint32_t (&fa)[NV][4], uint32_t (&fb)[kNT][2], const __nv_bfloat16* act,
    const __nv_bfloat16* wt, const int (&a_off)[kMT], int tap_off,
    int b_off, int k0) {
#pragma unroll
  for (int j = 0; j < kNT; j += 2) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, wt + b_off + k0 * kStride + j * 8);
    fb[j][0] = r[0];
    fb[j][1] = r[1];
    fb[j + 1][0] = r[2];
    fb[j + 1][1] = r[3];
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    ldmatrix_x4(fa[i], act + a_off[i] + tap_off + k0);
  }
}

// acc += conv3x3(act, w) for the warp's first NV m-tiles; the 9 x kC/16
// k16 steps run unrolled, step i+1's loads issued before step i's mma.
template <int NV>
__device__ __forceinline__ void conv(float (&acc)[kMT][kNT][4],
                                     const __nv_bfloat16* act,
                                     const __nv_bfloat16* w,
                                     const int (&a_off)[kMT], int row_off,
                                     int b_off) {
  constexpr int kKS = kC / 16;
  constexpr int kSteps = 9 * kKS;
  uint32_t fa[2][NV][4], fb[2][kNT][2];
  auto load = [&](int st, int buf) {
    const int t = st / kKS;
    load_frags<NV>(fa[buf], fb[buf], act, w + t * kTapElems, a_off,
                   (t / 3) * row_off + (t % 3) * kStride, b_off,
                   (st % kKS) * 16);
  };
  load(0, 0);
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    if (st + 1 < kSteps) load(st + 1, (st + 1) & 1);
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mma_bf16(acc[i][j], fa[st & 1][i], fb[st & 1][j][0],
                 fb[st & 1][j][1]);
  }
}

__device__ __forceinline__ void conv_nv(int nv, float (&acc)[kMT][kNT][4],
                                        const __nv_bfloat16* act,
                                        const __nv_bfloat16* w,
                                        const int (&a_off)[kMT], int row_off,
                                        int b_off) {
  if (nv == 2) {
    conv<2>(acc, act, w, a_off, row_off, b_off);
  } else if (nv == 1) {
    conv<1>(acc, act, w, a_off, row_off, b_off);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
kernel(const __nv_bfloat16* __restrict__ x,
       const __nv_bfloat16* __restrict__ w1, const float* __restrict__ s1,
       const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
       const float* __restrict__ s2, const float* __restrict__ b2,
       __nv_bfloat16* __restrict__ out, int n, int s, int nbuf) {
  static_assert(kMT == 2, "two m-tiles per warp at s <= 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = s + 2;                      // padded side
  const int act_elems = sp * sp * kStride;
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* act0 = wbuf + 18 * kTapElems;

  const int tid = threadIdx.x, lane = tid & 31, mg = tid >> 5;
  const int n_pix = s * s;
  const int n_mtiles = (n_pix + 15) / 16;
  const int g = lane >> 2, tig = lane & 3;
  const size_t patch_elems = static_cast<size_t>(n_pix) * kC;
  // the warp's m-tiles are mg, mg + kWarps: nv of them are valid
  const int nv = mg < n_mtiles ? (n_mtiles - mg + kWarps - 1) / kWarps : 0;
  const int row_off = sp * kStride;

  auto stage = [&](__nv_bfloat16* act, int p) {
    const __nv_bfloat16* xb = x + p * patch_elems;
    for (int v = tid; v < n_pix * (kC / 8); v += kThreads) {
      const int pix = v / (kC / 8), cv = v % (kC / 8);
      const int pos = (pix / s + 1) * sp + pix % s + 1;
      cp_async16(act + pos * kStride + cv * 8, xb + static_cast<size_t>(v) * 8);
    }
  };
  // zero the activation buffers (the halo stays zero), then copy both
  // convs' weights and the first patch
  for (int v = tid; v < nbuf * act_elems / 8; v += kThreads) {
    reinterpret_cast<uint4*>(act0)[v] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  for (int v = tid; v < 18 * kC * (kC / 8); v += kThreads) {
    const int t = v / (kC * kC / 8), r = v % (kC * kC / 8);
    const int k = r / (kC / 8), nc = r % (kC / 8);
    cp_async16(wbuf + t * kTapElems + k * kStride + nc * 8,
               (t < 9 ? w1 : w2) +
                   (static_cast<size_t>(t % 9) * kC * kC + r * 8));
  }
  stage(act0, blockIdx.x);
  cp_async_commit();

  // Each lane's ldmatrix row for A: pixel m = 16*tile + (lane & 15), its
  // 3x3 window's top-left position, channel half (lane >> 4).
  int a_off[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int m = (mg + i * kWarps) * 16 + (lane & 15);
    const int pos = m < n_pix ? (m / s) * sp + m % s : 0;
    a_off[i] = pos * kStride + (lane >> 4) * 8;
  }
  // ldmatrix.trans row addresses for B: lanes 8j..8j+7 give matrix j's
  // rows; matrices (k 0-7 | k 8-15) x (n 0-7 | n 8-15).
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                    (lane >> 4) * 8;
  // The accumulator rows this lane holds, m = 16*tile + g (+ 8): the
  // pixel, or -1 past s*s. The same for every patch.
  int pix[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (mg + i * kWarps) * 16 + g + 8 * half;
      pix[i][half] = i < nv && m < n_pix ? m : -1;
    }

  float acc[kMT][kNT][4];
  int buf = 0;
  for (int p = blockIdx.x; p < n; p += gridDim.x) {
    __nv_bfloat16* act = act0 + buf * act_elems;
    const int next = p + gridDim.x;
    // x of this patch (and, the first time, the weights) have landed;
    // every warp is done with the previous patch, so the other buffer is
    // free for the next patch's x
    cp_async_wait<0>();
    __syncthreads();
    if (nbuf == 2 && next < n) {
      stage(act0 + (buf ^ 1) * act_elems, next);
      cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    conv_nv(nv, acc, act, wbuf, a_off, row_off, b_off);
    __syncthreads();         // every warp is done reading x: h goes over it
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = pix[i][half];
        if (m < 0) continue;
        __nv_bfloat16* hrow = act + ((m / s + 1) * sp + m % s + 1) * kStride;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int nn = j * 8 + 2 * tig;
          // round h to bf16 here, as the reference does before conv 2
          const float h0 = fmaxf(__fadd_rn(__fmul_rn(
              acc[i][j][2 * half], __ldg(s1 + nn)), __ldg(b1 + nn)), 0.f);
          const float h1 = fmaxf(__fadd_rn(__fmul_rn(
              acc[i][j][2 * half + 1], __ldg(s1 + nn + 1)),
              __ldg(b1 + nn + 1)), 0.f);
          *reinterpret_cast<__nv_bfloat162*>(hrow + nn) =
              __floats2bfloat162_rn(h0, h1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    __syncthreads();         // h is in place
    conv_nv(nv, acc, act, wbuf + 9 * kTapElems, a_off, row_off, b_off);
    if (nbuf == 1 && next < n) {
      __syncthreads();       // every warp is done reading h
      stage(act, next);
      cp_async_commit();
    }
    const __nv_bfloat16* xb = x + p * patch_elems;
    __nv_bfloat16* ob = out + p * patch_elems;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = pix[i][half];
        if (m < 0) continue;
        const size_t o = static_cast<size_t>(m) * kC;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int nn = j * 8 + 2 * tig;
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xb + o + nn));
          const float y0 = __fadd_rn(__fadd_rn(__fmul_rn(
              acc[i][j][2 * half], __ldg(s2 + nn)), __ldg(b2 + nn)), r.x);
          const float y1 = __fadd_rn(__fadd_rn(__fmul_rn(
              acc[i][j][2 * half + 1], __ldg(s2 + nn + 1)),
              __ldg(b2 + nn + 1)), r.y);
          *reinterpret_cast<__nv_bfloat162*>(ob + o + nn) =
              __floats2bfloat162_rn(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
        }
      }
    }
    buf ^= nbuf - 1;
  }
  cp_async_wait<0>();
}

}  // namespace ms

// --------------------------------------------------- C = 64, 128: wgmma
// Warpgroup MMA reads both operands straight from shared memory (no
// ldmatrix, no register copies of A or B) and runs asynchronously.
//
// Every tap's A operand is a plain strided window. A block's work item
// is a stack of P patches: slots in rows of w = s+1 (one zero column
// serves as the right halo of a row and the left halo of the next), a
// zero row above each patch and below the last, one leading zero slot.
// Pixel (j, y, x) of patch j sits at slot (j*(s+1) + y + 1)*w + x + 2.
// Output q (q = 0 .. (P*(s+1) - 1)*w - 1) sits at slot q + w + 1 and
// reads tap (dy, dx) from slot q + dy*w + dx; outputs in halo columns
// and separator rows are computed and dropped. So each tap's A tile is
// the 64 consecutive slots from 64*tile + dy*w + dx. At s=13, P=1: 182
// outputs, 3 m64 tiles (192 rows for 169 pixels); at s=7, P=3 stacks
// three patches into the same 3 tiles (192 rows for 147 pixels).
//
// A slot is 128 bytes (64 channels) per 64-channel K atom, its eight
// 16-byte chunks permuted by the 128-byte swizzle (chunk c at c ^
// (address bits 7-9)), the layout wgmma reads without bank conflicts.
// The swizzle follows the address bits, so a window may start on any
// slot. Weights are rows of 64 output channels (B is MN-major) in the
// same swizzle: both convs resident at C=64 (147,456 B); at C=128
// (590 KB) a ring of three taps, each tap copied once per stack, tap
// q+2's copy in flight while tap q is multiplied (one barrier a tap).
//
// Three warpgroups; warpgroup g takes m64 tiles g, g+3, ... (at most
// kMaxT). A conv is 9 x C/16 wgmma m64nCk16 per tile, issued back to
// back and waited on once (C=64) or once a tap (C=128).
namespace wg {

constexpr int kGroups = 3;                  // warpgroups per block
constexpr int kThreads = 128 * kGroups;
constexpr int kRing = 3;                    // C=128: weight taps in smem

template <int C>
struct Dims {
  static constexpr int kAtoms = C / 64;             // 64-channel atoms
  static constexpr int kTapBytes = C * C * 2;
  static constexpr int kAtomRows = C * 128;         // one N atom of a tap
  static constexpr bool kResident = C == 64;
  static constexpr int kWBytes = (kResident ? 18 : kRing) * kTapBytes;
  static constexpr int kAcc = C / 2;                // fp32 sums per tile
};

__host__ __device__ constexpr int n_tiles(int s, int P) {
  return ((P * (s + 1) - 1) * (s + 1) + 63) / 64;
}
// slots: every slot a tile's window reads, in whole 8-row swizzle atoms
__host__ __device__ constexpr int n_slots(int s, int P) {
  return (64 * n_tiles(s, P) + 2 * (s + 1) + 2 + 7) / 8 * 8;
}
template <int C>
__host__ __device__ constexpr int act_bytes(int s, int P) {
  return Dims<C>::kAtoms * n_slots(s, P) * 128;
}
// tiles g, g + kGroups, ... below `tiles` belong to warpgroup g
__device__ __forceinline__ int tile_count(int tiles, int g) {
  return g < tiles ? (tiles - g + kGroups - 1) / kGroups : 0;
}

// Byte offset of 16-byte chunk c in the 128-byte row at shared address
// `row` under the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(uint32_t row, int c) {
  return static_cast<uint32_t>((c ^ ((row >> 7) & 7)) * 16);
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units). The swizzle
// follows the address bits, so a window may start on any 128-byte row:
// the base offset stays 0.
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d = A * B + (accumulate ? d : 0), m64nCk16, A K-major and B MN-major
// from shared memory.
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// acc[t] += taps t0 .. t0+kTaps-1 for this warpgroup's NT tiles (acc[t]
// = at tap 0: the first product overwrites the sums, so no instruction
// but a wgmma writes them while the products are in flight): tap t's
// weights at wtap + (t - t0) * kTapBytes, A windows in act (atoms
// atom_bytes apart).
template <int C, int NT, int kMaxT, int kTaps>
__device__ __forceinline__ void taps(float (&acc)[kMaxT][Dims<C>::kAcc],
                                     uint32_t act, int atom_bytes,
                                     uint32_t wtap, int t0, int tile0,
                                     int w) {
  using D = Dims<C>;
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
    const int tap = t0 + i;
    const int shift = (tap / 3) * w + tap % 3;
#pragma unroll
    for (int kc = 0; kc < C / 16; ++kc) {
      // B: 16 weight rows from row 16*kc; N atoms kAtomRows apart, 8-row
      // groups 1024 bytes apart
      const uint64_t db = desc(wtap + i * D::kTapBytes + kc * 16 * 128,
                               D::kAtomRows, 1024);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        // A: 64 slots from the window's start, channels 16*kc ..
        const int slot = 64 * (tile0 + kGroups * t) + shift;
        const uint64_t da = desc(act + (kc / 4) * atom_bytes + slot * 128 +
                                     (kc % 4) * 32,
                                 16, 1024);
        wgmma(acc[t], da, db, tap > 0 || kc > 0);
      }
    }
  }
  wgmma_commit();
}

template <int C, int kMaxT>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const __nv_bfloat16* __restrict__ x,
       const __nv_bfloat16* __restrict__ w1, const float* __restrict__ s1,
       const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
       const float* __restrict__ s2, const float* __restrict__ b2,
       __nv_bfloat16* __restrict__ out, int n, int s, int P, int nbuf) {
  using D = Dims<C>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int group = tid / 128, wi = (tid / 32) % 4;
  const int w = s + 1, n_pix = s * s;
  const int atom_bytes = n_slots(s, P) * 128;
  const int abytes = act_bytes<C>(s, P);
  unsigned char* act0 = smem_raw + D::kWBytes;
  const uint32_t wsm_addr = smem_addr(smem_raw);
  const uint32_t act0_addr = smem_addr(act0);
  const size_t patch_elems = static_cast<size_t>(n_pix) * C;
  const int nt = tile_count(n_tiles(s, P), group);
  const int n_items = (n + P - 1) / P;        // stacks of P patches

  // 16-byte chunk nc of row k of tap t of w (9, C, C) -> slot `dst` of
  // the ring or of the resident taps
  auto stage_tap = [&](uint32_t dst, const __nv_bfloat16* wsrc, int t) {
    for (int v = tid; v < C * (C / 8); v += kThreads) {
      const int k = v / (C / 8), nc = v % (C / 8);
      const uint32_t row = dst + (nc / 8) * D::kAtomRows + k * 128;
      cp_async16(smem_raw + (row - wsm_addr) + swz(row, nc % 8),
                 wsrc + (static_cast<size_t>(t) * C * C + v * 8));
    }
  };
  // the P patches of stack `item` (those below n) into act
  auto stage_x = [&](unsigned char* act, int item) {
    const uint32_t base = smem_addr(act);
    for (int j = 0; j < P; ++j) {
      const int p = item * P + j;
      if (p >= n) break;
      const __nv_bfloat16* xb = x + p * patch_elems;
      for (int v = tid; v < n_pix * (C / 8); v += kThreads) {
        const int m = v / (C / 8), c = v % (C / 8);
        const uint32_t row = (c / 8) * atom_bytes +
            ((j * (s + 1) + m / s + 1) * w + m % s + 2) * 128;
        cp_async16(act + row + swz(base + row, c % 8), xb + v * 8);
      }
    }
  };

  // Zero the activation buffers (halos and separators stay zero for
  // good), then copy the weights (resident) or the ring's first two taps,
  // and the first stack.
  for (int v = tid; v < nbuf * abytes / 16; v += kThreads) {
    reinterpret_cast<uint4*>(act0)[v] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  // C=128: the block's taps form one sequence, step q = 18 * (stack
  // number in this block) + (tap of conv 1, then of conv 2), held in ring
  // slot q % kRing. One cp.async group is committed per step (empty past
  // the end) so that, within a stack, wait_group<1> means "step q has
  // landed".
  const int n_steps = 18 * ((n_items - blockIdx.x + gridDim.x - 1) /
                            gridDim.x);
  auto issue_step = [&](int q) {
    if (q < n_steps) {
      const int t = q % 18;
      stage_tap(wsm_addr + (q % kRing) * D::kTapBytes, t < 9 ? w1 : w2,
                t % 9);
    }
    cp_async_commit();
  };
  stage_x(act0, blockIdx.x);
  if (D::kResident) {
    for (int t = 0; t < 18; ++t) {
      stage_tap(wsm_addr + t * D::kTapBytes, t < 9 ? w1 : w2, t % 9);
    }
    cp_async_commit();
  } else {
    issue_step(0);           // with the first stack's x
    issue_step(1);
  }

  // This thread's accumulator rows: q = 64*tile + 16*wi + g (+8): the
  // slot where its h goes, and its patch and pixel, or -1 for a halo
  // column, a separator row or a q past the stack.
  const int g = lane >> 2, tig = lane & 3;
  int slot_of[kMaxT][2], pix_of[kMaxT][2], patch_of[kMaxT][2];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = 64 * (group + kGroups * t) + 16 * wi + g + 8 * half;
      const int row = q / w, col = q % w;
      const int j = row / (s + 1), y = row % (s + 1);
      const bool ok = t < nt && j < P && y < s && col != 0;
      slot_of[t][half] = q + w + 1;
      patch_of[t][half] = j;
      pix_of[t][half] = ok ? y * s + col - 1 : -1;
    }

  // zeroed once, so that no read is of an undefined value; each conv's
  // first product then overwrites them
  float acc[kMaxT][D::kAcc];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t)
#pragma unroll
    for (int e = 0; e < D::kAcc; ++e) acc[t][e] = 0.f;
  int buf = 0, q = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    unsigned char* act = act0 + buf * abytes;
    const uint32_t act_addr = act0_addr + buf * abytes;
    const int next = item + gridDim.x;
    if (D::kResident) {
      // this stack's x (and, the first time, the weights) have landed;
      // every warpgroup is done with the previous stack, so the other
      // buffer is free for the next one
      cp_async_wait<0>();
      fence_proxy_async();   // the copies, seen by the tensor cores
      __syncthreads();
      if (nbuf == 2 && next < n_items) {
        stage_x(act0 + (buf ^ 1) * abytes, next);
        cp_async_commit();
      }
    }
    for (int cv = 0; cv < 2; ++cv) {
      if (D::kResident) {
        const uint32_t wconv = wsm_addr + 9 * cv * D::kTapBytes;
        if (nt == 2) {
          if constexpr (kMaxT == 2)
            taps<C, 2, kMaxT, 9>(acc, act_addr, atom_bytes, wconv, 0, group,
                                 w);
        } else if (nt == 1) {
          taps<C, 1, kMaxT, 9>(acc, act_addr, atom_bytes, wconv, 0, group,
                               w);
        }
        wgmma_wait();
      } else {
        for (int tap = 0; tap < 9; ++tap) {
          // step q has landed (a stack's first step waits for every copy:
          // its x may be in a group of its own); this warpgroup's
          // products of step q-1 are done; after the barrier so are every
          // warpgroup's, and step q-1's slot takes step q+2 (with the
          // next stack's x at a stack's first step)
          if (cv == 0 && tap == 0) {
            cp_async_wait<0>();
          } else {
            cp_async_wait<1>();
          }
          wgmma_wait();
          fence_proxy_async();
          __syncthreads();
          if (cv == 0 && tap == 0 && nbuf == 2 && next < n_items) {
            stage_x(act0 + (buf ^ 1) * abytes, next);
          }
          issue_step(q + 2);
          const uint32_t wt = wsm_addr + (q % kRing) * D::kTapBytes;
          if (nt == 2) {
            if constexpr (kMaxT == 2)
              taps<C, 2, kMaxT, 1>(acc, act_addr, atom_bytes, wt, tap, group,
                                   w);
          } else if (nt == 1) {
            taps<C, 1, kMaxT, 1>(acc, act_addr, atom_bytes, wt, tap, group,
                                 w);
          }
          ++q;
        }
        wgmma_wait();
      }
      if (cv == 1) break;
      __syncthreads();       // every warpgroup is done reading x
#pragma unroll
      for (int t = 0; t < kMaxT; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (pix_of[t][half] < 0) continue;
          const uint32_t row = slot_of[t][half] * 128;
#pragma unroll
          for (int j = 0; j < C / 8; ++j) {
            const int nn = 8 * j + 2 * tig;
            // round h to bf16 here, as the reference does before conv 2
            const float h0 = fmaxf(__fadd_rn(__fmul_rn(
                acc[t][4 * j + 2 * half], __ldg(s1 + nn)), __ldg(b1 + nn)),
                0.f);
            const float h1 = fmaxf(__fadd_rn(__fmul_rn(
                acc[t][4 * j + 2 * half + 1], __ldg(s1 + nn + 1)),
                __ldg(b1 + nn + 1)), 0.f);
            const uint32_t at = (j / 8) * atom_bytes + row;
            *reinterpret_cast<__nv_bfloat162*>(
                act + at + swz(act_addr + at, j % 8) + 4 * tig) =
                __floats2bfloat162_rn(h0, h1);
          }
        }
      fence_proxy_async();   // the h stores, seen by the tensor cores
      // resident: this barrier orders them before conv 2's reads;
      // streaming: conv 2's first tap barrier does
      if (D::kResident) __syncthreads();
    }

    if (nbuf == 1 && next < n_items) {
      __syncthreads();       // every warpgroup is done reading h
      stage_x(act, next);
      cp_async_commit();
    }

#pragma unroll
    for (int t = 0; t < kMaxT; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = pix_of[t][half];
        const int p = item * P + patch_of[t][half];
        if (m < 0 || p >= n) continue;
        const size_t o = p * patch_elems + static_cast<size_t>(m) * C;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int nn = 8 * j + 2 * tig;
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + o + nn));
          const float y0 = __fadd_rn(__fadd_rn(__fmul_rn(
              acc[t][4 * j + 2 * half], __ldg(s2 + nn)), __ldg(b2 + nn)),
              r.x);
          const float y1 = __fadd_rn(__fadd_rn(__fmul_rn(
              acc[t][4 * j + 2 * half + 1], __ldg(s2 + nn + 1)),
              __ldg(b2 + nn + 1)), r.y);
          *reinterpret_cast<__nv_bfloat162*>(out + o + nn) =
              __floats2bfloat162_rn(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
        }
      }
    buf ^= nbuf - 1;
  }
  cp_async_wait<0>();        // no copy outlives the block
}

// Patches per stack: the P in 1..8 whose tiles, spread over the three
// warpgroups (at most kMaxT each), waste the fewest rows, the smaller P
// on a tie; 0 if none fits.
template <int C>
int choose_p(int s, int max_smem, int max_t) {
  int best = 0;
  double best_use = 0.0;
  for (int P = 1; P <= 8; ++P) {
    const int tiles = n_tiles(s, P);
    const int per_group = (tiles + kGroups - 1) / kGroups;
    if (per_group > max_t ||
        Dims<C>::kWBytes + act_bytes<C>(s, P) > max_smem) {
      continue;
    }
    const double use = static_cast<double>(P * s * s) /
                       (64.0 * kGroups * per_group);
    if (use > best_use + 1e-9) {
      best = P;
      best_use = use;
    }
  }
  return best;
}

template <int C, int kMaxT>
cudaError_t launch(const void* x, const void* w1, const void* s1,
                   const void* b1, const void* w2, const void* s2,
                   const void* b2, void* out, int n, int s, int P,
                   int max_smem, int sms, cudaStream_t stream) {
  // two activation buffers where they fit, else one
  const int nbuf =
      Dims<C>::kWBytes + 2 * act_bytes<C>(s, P) <= max_smem ? 2 : 1;
  const int bytes = Dims<C>::kWBytes + nbuf * act_bytes<C>(s, P);
  cudaError_t err = cudaFuncSetAttribute(
      kernel<C, kMaxT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int items = (n + P - 1) / P;
  const int grid = items < sms ? items : sms;
  kernel<C, kMaxT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), n, s, P, nbuf);
  return cudaGetLastError();
}

// One tile per warpgroup where a stack fits in three tiles, else two.
template <int C>
cudaError_t launch_any(const void* x, const void* w1, const void* s1,
                       const void* b1, const void* w2, const void* s2,
                       const void* b2, void* out, int n, int s,
                       int max_smem, int sms, cudaStream_t stream) {
  int P = choose_p<C>(s, max_smem, 1);
  if (P > 0) {
    return launch<C, 1>(x, w1, s1, b1, w2, s2, b2, out, n, s, P, max_smem,
                        sms, stream);
  }
  P = choose_p<C>(s, max_smem, 2);
  if (P == 0) return cudaErrorInvalidValue;
  return launch<C, 2>(x, w1, s1, b1, w2, s2, b2, out, n, s, P, max_smem,
                      sms, stream);
}

}  // namespace wg

cudaError_t launch_mma_sync(const void* x, const void* w1, const void* s1,
                            const void* b1, const void* w2, const void* s2,
                            const void* b2, void* out, int n, int s,
                            int max_smem, int sms, cudaStream_t stream) {
  // two activation buffers where they fit, else one
  const int nbuf = ms::kWBytes + 2 * ms::act_bytes(s) <= max_smem ? 2 : 1;
  const int bytes = ms::kWBytes + nbuf * ms::act_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(
      ms::kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int grid = n < sms ? n : sms;
  ms::kernel<<<grid, ms::kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), n, s, nbuf);
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
  int max_smem = 0, sms = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 32:
      err = launch_mma_sync(x, w1, s1, b1, w2, s2, b2, out, n, s, max_smem,
                            sms, st);
      break;
    case 64:
      err = wg::launch_any<64>(x, w1, s1, b1, w2, s2, b2, out, n, s,
                               max_smem, sms, st);
      break;
    default:
      err = wg::launch_any<128>(x, w1, s1, b1, w2, s2, b2, out, n, s,
                                max_smem, sms, st);
      break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
