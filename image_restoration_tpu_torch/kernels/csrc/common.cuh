// Shared helpers of the port's CUDA kernels (block_front.cu,
// block_apply_gdfn.cu, ln_qkv_dwconv.cu, attn_core.cu, ln_gdfn.cu,
// drs_apply_msfn.cu, mefc_step.cu, ska.cu; front.cuh and gdfn.cuh hold the
// device code the Restormer block kernels share). Built for sm_90a with
// nvcc into one shared library with a plain C interface; see
// kernels/build.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace irk {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// Output tiles are TILE_W pixels wide and `th` rows high; the 3x3 depthwise
// convs need a one-pixel halo on every side.
constexpr int TILE_W = 16;
// Largest dynamic shared memory one block may use on Hopper (227 KB).
constexpr int SMEM_LIMIT = 232448;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

// 16-byte asynchronous copy from device to shared memory (cp.async, L2
// only); with `valid` false nothing is read and the 16 bytes become zeros.
// Both addresses 16-byte aligned; `src` must still be a device address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// Waits for this thread's outstanding cp_async16 copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Where a halo pixel of a tile lies in the image. Tiles start at image
// (r0, c0); halo pixel p is at halo row p / (TILE_W + 2), column
// p % (TILE_W + 2), i.e. image (r0 - 1 + row, c0 - 1 + col).
struct Halo {
  int r0, c0, h, w;
  __device__ bool inside(int gr, int gc) const {
    return gr >= 0 && gr < h && gc >= 0 && gc < w;
  }
};

// LayerNorm of one pixel's C channels by one warp: fp32 statistics over the
// real C (two passes, biased variance), result rounded to bf16. `src(c)`
// gives the fp32 input of channel c; BiasFree when ln_b is null.
template <typename Src>
__device__ __forceinline__ void warp_layernorm(Src src, int C, float eps,
                                               const float* ln_w,
                                               const float* ln_b, bf16* dst,
                                               int lane) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += src(c);
  const float mu = warp_sum(s) / C;
  float s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = src(c) - mu;
    s2 += d * d;
  }
  const float inv = rsqrtf(warp_sum(s2) / C + eps);
  for (int c = lane; c < C; c += 32) {
    const float xv = src(c);
    const float y = ln_b ? (xv - mu) * inv * ln_w[c] + ln_b[c]
                         : xv * inv * ln_w[c];
    dst[c] = f2bf(y);
  }
}

}  // namespace irk
