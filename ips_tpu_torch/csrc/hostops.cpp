// Host-side data-path functions of the ips_tpu_torch input pipeline (the
// port's own copy of ips_tpu/native/hostops.cpp, same functions, same
// arithmetic: each one only copies float32 values, so its output is
// bitwise the numpy version's, ips_tpu_torch/native.py plain_*).
//
//   * densify_patchify_f32 -- scatter sparse (index, value) pixels straight
//     into the (n_patches, ph, pw, C) patch tensor, never materializing the
//     dense H*W image: O(nnz) instead of O(H*W) (dense megapixel MNIST).
//   * patchify_f32 -- strided row-memcpy patch extraction of a dense image.
//   * gather_patches_f32 -- batched patch gather (B, K) out of (B, N, ...)
//     host arrays, the streaming selector's chunk assembly; it writes into
//     the caller's buffer (pinned memory on a card).
//
// Built with g++ -O3 -march=native at first use by
// ips_tpu_torch/utils/cuda_build.py into csrc/build/ and bound with ctypes
// (ips_tpu_torch/native.py). Single-threaded, as the reference.

#include <cstdint>
#include <cstring>

extern "C" {

// Scatter sparse pixels straight into (n_patches, ph, pw, C) patches.
// flat indices address a row-major (H, W, C) image. Patches follow torch
// unfold order: rows of patches scanned left-to-right. Supports
// overlapping patches (stride < size): a pixel lands in every patch
// containing it. `out` must be zero-initialized by the caller.
void densify_patchify_f32(const int64_t* idx, const float* vals,
                          int64_t nnz, int64_t H, int64_t W, int64_t C,
                          int64_t ph, int64_t pw, int64_t sh, int64_t sw,
                          float* out) {
  const int64_t nh = (H - ph) / sh + 1;
  const int64_t nw = (W - pw) / sw + 1;
  const int64_t patch_elems = ph * pw * C;
  for (int64_t k = 0; k < nnz; ++k) {
    const int64_t flat = idx[k];
    const float v = vals[k];
    const int64_t c = flat % C;
    const int64_t w = (flat / C) % W;
    const int64_t h = flat / (C * W);
    // patch-row range containing h: i*sh <= h <= i*sh + ph - 1
    int64_t i_lo = (h - ph + sh) / sh;  // ceil((h - ph + 1) / sh)
    if (h - ph + 1 <= 0) i_lo = 0;
    if (i_lo < 0) i_lo = 0;
    int64_t i_hi = h / sh;
    if (i_hi > nh - 1) i_hi = nh - 1;
    int64_t j_lo = (w - pw + sw) / sw;
    if (w - pw + 1 <= 0) j_lo = 0;
    if (j_lo < 0) j_lo = 0;
    int64_t j_hi = w / sw;
    if (j_hi > nw - 1) j_hi = nw - 1;
    for (int64_t i = i_lo; i <= i_hi; ++i) {
      const int64_t dy = h - i * sh;
      for (int64_t j = j_lo; j <= j_hi; ++j) {
        const int64_t dx = w - j * sw;
        out[(i * nw + j) * patch_elems + (dy * pw + dx) * C + c] = v;
      }
    }
  }
}

// Dense (H, W, C) image -> (nh*nw, ph, pw, C) patches via row memcpy.
void patchify_f32(const float* img, int64_t H, int64_t W, int64_t C,
                  int64_t ph, int64_t pw, int64_t sh, int64_t sw,
                  float* out) {
  const int64_t nh = (H - ph) / sh + 1;
  const int64_t nw = (W - pw) / sw + 1;
  const int64_t row_bytes = pw * C * sizeof(float);
  float* dst = out;
  for (int64_t i = 0; i < nh; ++i) {
    for (int64_t j = 0; j < nw; ++j) {
      const float* src = img + (i * sh * W + j * sw) * C;
      for (int64_t y = 0; y < ph; ++y) {
        std::memcpy(dst, src, row_bytes);
        dst += pw * C;
        src += W * C;
      }
    }
  }
}

// out[b, k] = src[b, idx[b, k]] for patch records of `elems` floats.
void gather_patches_f32(const float* src, const int32_t* idx,
                        int64_t B, int64_t N, int64_t K, int64_t elems,
                        float* out) {
  const int64_t rec_bytes = elems * sizeof(float);
  for (int64_t b = 0; b < B; ++b) {
    const float* base = src + b * N * elems;
    float* dst = out + b * K * elems;
    const int32_t* row_idx = idx + b * K;
    for (int64_t k = 0; k < K; ++k) {
      std::memcpy(dst + k * elems, base + (int64_t)row_idx[k] * elems,
                  rec_bytes);
    }
  }
}

}  // extern "C"
