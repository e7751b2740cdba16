// Shared helpers of the port's CUDA kernels (block_front.cu,
// block_apply_gdfn.cu, ln_qkv_dwconv.cu, attn_core.cu, ln_gdfn.cu,
// drs_apply_msfn.cu, mefc_step.cu, ska.cu, ska_bwd.cu; front.cuh and gdfn.cuh hold the
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

// Closes this thread's cp_async16 copies started so far into one group;
// groups complete in the order they were committed.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory (ldmatrix): lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); r[j]
// is this lane's pair of matrix j: row lane / 4, columns 2 (lane % 4), + 1.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same with every matrix transposed: r[j] is rows 2 (lane % 4), + 1 of
// column lane / 4 of matrix j as it lies in memory.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 16 x 16 bf16 tile at `tile` (row-major, leading dimension ld) as the A
// operand of mma_16816: a[0..3].
__device__ __forceinline__ void load_a_16x16(unsigned (&a)[4], const bf16* tile,
                                             int ld, int lane) {
  ldmatrix_x4(a, tile + (lane % 16) * ld + (lane / 16) * 8);
}

// 16 (k) x 16 (n) bf16 tile at `tile` (row-major, n contiguous) as two B
// operands of mma_16816: b[0..1] for columns 0-7, b[2..3] for columns 8-15.
__device__ __forceinline__ void load_b_16x16(unsigned (&b)[4], const bf16* tile,
                                             int ld, int lane) {
  ldmatrix_x4_trans(b, tile + (lane % 16) * ld + (lane / 16) * 8);
}

// 16 x 16 bf16 tile whose transpose lies at `tile` (row-major k x m,
// leading dimension ld) as the A operand of mma_16816: A = tile^T.
__device__ __forceinline__ void load_at_16x16(unsigned (&a)[4],
                                              const bf16* tile, int ld,
                                              int lane) {
  ldmatrix_x4_trans(a, tile + ((lane / 16) * 8 + lane % 8) * ld +
                           (lane / 8) % 2 * 8);
}

// d += a (16 x 16, bf16) @ b (16 x 8, bf16), fp32 accumulation on the
// tensor cores (mma.sync m16n8k16). With g = lane / 4 and t = lane % 4,
// d[0..1] are row g, columns 2t and 2t + 1; d[2..3] row g + 8.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// 8 bf16 (16 bytes) <-> 8 floats.
__device__ __forceinline__ void unpack8(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&y)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
  return u;
}

// 4 floats -> 4 bf16 (8 bytes), rounded to nearest as f2bf.
__device__ __forceinline__ uint2 pack4(const float (&y)[4]) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(y[0], y[1]);
  h[1] = __floats2bfloat162_rn(y[2], y[3]);
  return u;
}

// LayerNorm of one pixel by a group of 8 lanes, four pixels a warp at a
// time (a warp a pixel leaves most lanes idle at C = 48 and serialises 14
// pixels a warp): lane l of the group takes the 8-channel vectors l, l + 8,
// ... `load(v, x)` gives vector v's fp32 values, `emit(v, x, y)` takes them
// back beside the normalised ones. fp32 statistics over C (two passes,
// biased variance), BiasFree when ln_b is null, as warp_layernorm. Every
// lane of the warp must call it; a group that is not `live` only takes part
// in the shuffles.
template <typename Load, typename Emit>
__device__ __forceinline__ void group8_layernorm(bool live, int C, float eps,
                                                 const float* ln_w,
                                                 const float* ln_b, int l,
                                                 Load load, Emit emit) {
  const int nvec = C / 8;
  auto sum8 = [](float v) {
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  float s = 0.f;
  if (live)
    for (int v = l; v < nvec; v += 8) {
      float x[8];
      load(v, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += x[e];
    }
  const float mu = sum8(s) / C;
  float s2 = 0.f;
  if (live)
    for (int v = l; v < nvec; v += 8) {
      float x[8];
      load(v, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) s2 += (x[e] - mu) * (x[e] - mu);
    }
  const float inv = rsqrtf(sum8(s2) / C + eps);
  if (live)
    for (int v = l; v < nvec; v += 8) {
      float x[8], y[8];
      load(v, x);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = ln_b ? (x[e] - mu) * inv * ln_w[v * 8 + e] + ln_b[v * 8 + e]
                    : x[e] * inv * ln_w[v * 8 + e];
      emit(v, x, y);
    }
}

}  // namespace irk
