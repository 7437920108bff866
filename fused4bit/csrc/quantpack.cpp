// Native host-side INT4 quantize + pack (offline weight conversion).
//
// Counterpart of the reference's native layer role: where the reference
// builds CUDA extensions for the device path (csrc/*.cu via
// setup.py:22-48), the device path here is Pallas — but the *host*
// conversion pipeline (checkpoint import: dense fp32 -> per-row affine INT4
// -> planar-packed bytes) is a real hot loop for multi-GB models, and the
// reference's own MoE packer is a slow Python loop
// (python/moe_int4_module.py:62-76). This is that loop done natively:
// OpenMP-parallel rows, single pass min/max, fused quant+pack, no
// intermediate nibble array.
//
// Exposed via ctypes (fused4bit/native.py); a pure-NumPy fallback keeps
// the framework dependency-free when no compiler is available.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstddef>

extern "C" {

// Quantize a row-major [n, k] float32 matrix to planar-packed INT4.
//   packed:      [n, k/2] uint8 out — byte c = ((q[c+k/2] ^ 8) << 4) | q[c]
//   scales, zps: [n] float32 out
// The high-nibble XOR 8 matches fused4bit.quant.core.pack_planar (see
// its docstring for why the kernel wants two's-complement high nibbles).
void quantize_pack_planar_f32(
    const float* __restrict__ w,
    std::int64_t n,
    std::int64_t k,
    std::uint8_t* __restrict__ packed,
    float* __restrict__ scales,
    float* __restrict__ zps) {
  const std::int64_t half = k / 2;
  const float max_q = 15.0f;

#pragma omp parallel for schedule(static)
  for (std::int64_t r = 0; r < n; ++r) {
    const float* row = w + r * k;
    float mn = row[0], mx = row[0];
    for (std::int64_t i = 1; i < k; ++i) {
      mn = std::min(mn, row[i]);
      mx = std::max(mx, row[i]);
    }
    float scale = (mx - mn) / max_q;
    if (mx == mn) {
      // constant-row guard (reference python/quantize.py:85-94)
      scale = std::max(std::fabs(mx), 1.0f) / max_q;
    }
    scale = std::max(scale, 1e-8f);
    float zp = std::nearbyint(-mn / scale);
    zp = std::min(std::max(zp, 0.0f), max_q);
    scales[r] = scale;
    zps[r] = zp;

    const float inv = 1.0f / scale;
    std::uint8_t* prow = packed + r * half;
    for (std::int64_t c = 0; c < half; ++c) {
      float qlo = std::nearbyint(row[c] * inv + zp);
      float qhi = std::nearbyint(row[c + half] * inv + zp);
      qlo = std::min(std::max(qlo, 0.0f), max_q);
      qhi = std::min(std::max(qhi, 0.0f), max_q);
      const std::uint8_t lo = static_cast<std::uint8_t>(qlo);
      const std::uint8_t hi = static_cast<std::uint8_t>(qhi) ^ 0x8u;
      prow[c] = static_cast<std::uint8_t>((hi << 4) | lo);
    }
  }
}

// Dequantize planar-packed INT4 back to float32 [n, k] (verification path).
void dequantize_planar_f32(
    const std::uint8_t* __restrict__ packed,
    std::int64_t n,
    std::int64_t k,
    const float* __restrict__ scales,
    const float* __restrict__ zps,
    float* __restrict__ out) {
  const std::int64_t half = k / 2;
#pragma omp parallel for schedule(static)
  for (std::int64_t r = 0; r < n; ++r) {
    const std::uint8_t* prow = packed + r * half;
    float* orow = out + r * k;
    const float scale = scales[r];
    const float zp = zps[r];
    for (std::int64_t c = 0; c < half; ++c) {
      const std::uint8_t b = prow[c];
      const float lo = static_cast<float>(b & 0x0F);
      const float hi = static_cast<float>((b >> 4) ^ 0x8u);
      orow[c] = (lo - zp) * scale;
      orow[c + half] = (hi - zp) * scale;
    }
  }
}

}  // extern "C"
