// Shared by the SKA kernels' strip paths (ska.cu's forward, ska_bwd.cu's
// backward): the shared-memory layout of a strip of x (or of any (B, H, W,
// C) operand staged with a one-pixel halo) and its 16-byte shared-memory
// loads and global stores. Functions are static: each source is its own
// translation unit.
#pragma once

#include "common.cuh"

namespace irk {

// Shared-memory layout: `ring` strip slots, each x's planes ((th + 2) rows
// x (W + 2) pixels at a padded stride of S bytes, 2 C bytes used) and the
// strip's weights. fp32's second plane starts 64 bytes past a 128-byte
// boundary, so that the staging copies of a pixel's chunks, which alternate
// between the planes, fall on other banks.
struct StripSmem {
  int W2, S, plane, xbytes, slot, total;
  __host__ __device__ StripSmem(int W, int C, int wc, int th, int esize,
                                int ring) {
    const int npl = esize / 2;
    W2 = W + 2;
    S = 2 * C + ((2 * wc - 2 * C) % 128 + 128) % 128;  // 16 G = 2 wc
    plane = static_cast<int>(align128((th + 2) * W2 * S)) + 64;
    xbytes = static_cast<int>(align128(npl * plane));
    slot = xbytes + static_cast<int>(align128(
                        static_cast<size_t>(th) * W * wc * 9 * esize));
    total = ring * slot;
  }
};

// 16 bytes of shared memory at shared-space address `a` (32-bit
// addressing: no generic-to-shared conversion on the tap loop's path).
static __device__ __forceinline__ uint4 lds128(unsigned a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

static __device__ __forceinline__ void unpack4(const uint4& u, float (&x)[8],
                                               int o) {
  x[o] = __uint_as_float(u.x), x[o + 1] = __uint_as_float(u.y);
  x[o + 2] = __uint_as_float(u.z), x[o + 3] = __uint_as_float(u.w);
}

// Eight fp32 values of x at shared address `a` of plane 0 (bf16: one
// 16-byte chunk; fp32: channels 0-3 from plane 0, 4-7 from the same place
// in plane 1).
static __device__ __forceinline__ void load_x8(unsigned a, int, const bf16*,
                                               float (&v)[8]) {
  unpack8(lds128(a), v);
}
static __device__ __forceinline__ void load_x8(unsigned a, int plane,
                                               const float*, float (&v)[8]) {
  unpack4(lds128(a), v, 0);
  unpack4(lds128(a + plane), v, 4);
}

static __device__ __forceinline__ void store8(bf16* dst,
                                              const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) = pack8(v);
}
static __device__ __forceinline__ void store8(float* dst,
                                              const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

}  // namespace irk
