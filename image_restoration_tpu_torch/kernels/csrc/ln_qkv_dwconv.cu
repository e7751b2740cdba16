// LN1 -> qkv 1x1 -> 3x3 depthwise of the three-kernel Restormer block,
// writing the whole (B, H, W, 3C) qkv map, channels [q | k | v].
//
// Replaces the TPU kernel image_restoration_tpu/kernels/mdta_pallas.py
// `_kernel` (behind `fused_ln_qkv_dwconv` and `fused_ln_qkv_dwconv_split`).
// Same math and rounding points: LN1 with fp32 statistics over the real C,
// output rounded to bf16; the 1x1 on bf16 operands with fp32 accumulation
// (tensor cores, mma.sync); bias added and out-of-image pixels zeroed
// before the fp32 depthwise (torch zero-pads the projected map); only the
// result is rounded to bf16. The TPU's 128-lane slots for q, k and v (the
// split variant) are a TPU layout: q, k and v are contiguous here.
//
// The kernel is pass 1 of the whole-block pair (block_front.cu, K1) with q
// and k written to device memory instead of reduced: it runs the same
// device code (front.cuh `front_run`) over all 3C projected channels in
// chunks of 48 (32 or 16 where C needs it), one output tile of th x 16
// pixels per block with a one-pixel halo, recomputing the 1x1 on the halo.
//
// What bounds it on the card: by its bound the x read and the 3C-wide write
// (4 x H*W*C bf16); in fact a tile's short stages between barriers, as K1
// (front.cuh). Blocks of 8 or 16 warps.
//
// Shared memory: K1's without q, k and the sums (FrontSmem with `gram`
// false). At the tile heights and warps of kernels/mdta.py (bytes, blocks
// an SM, ms a call at Restormer-base's 512x512 shapes on an NVIDIA H100
// 80GB HBM3, 700 W; PERF.md): C = 48, th 8, 8 warps: 79,488, 2, 0.179;
// C = 96, th 8, 8 warps: 108,672, 2, 0.101 (256x256) and 0.355 (512x512);
// C = 192, th 8, 16 warps: 167,040, 1, 0.074; C = 384, th 2, 8 warps:
// 170,880, 1, 0.133.
#include "front.cuh"

namespace irk {

template <int NW>
__global__ void __launch_bounds__(NW * 32) ln_qkv_dwconv_kernel(FrontArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  front_run<NW, 0>(a, smem);
}

template <int NW>
static cudaError_t launch_ln_qkv_dwconv(const FrontArgs& a, dim3 grid,
                                        size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ln_qkv_dwconv_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  ln_qkv_dwconv_kernel<NW><<<grid, NW * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace irk

extern "C" {

// Dynamic shared memory one block of the kernel needs; above the card's
// limit for a block size that is not built (8 or 16 warps are).
int ir_ln_qkv_dwconv_smem(int C, int th, int warps) {
  if (warps != 8 && warps != 16) return irk::SMEM_LIMIT + 1;
  return static_cast<int>(irk::FrontSmem(C, th, false).total);
}

// Launches the kernel on `stream`, one block of `warps` (8 or 16) warps per
// output tile and batch image; `out` is (B, H, W, 3C). Returns
// cudaGetLastError().
int ir_ln_qkv_dwconv(const void* x, const void* ln_w, const void* ln_b,
                     const void* wqkv, const void* bqkv, const void* dw,
                     const void* db, void* out, int B, int H, int W, int C,
                     int th, int warps, float eps, void* stream) {
  using namespace irk;
  const FrontSmem L(C, th, false);
  if (L.total > static_cast<size_t>(SMEM_LIMIT) || C % 16)
    return cudaErrorInvalidValue;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  FrontArgs a{static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
              static_cast<const float*>(ln_b), static_cast<const bf16*>(wqkv),
              static_cast<const float*>(bqkv), static_cast<const float*>(dw),
              static_cast<const float*>(db), static_cast<bf16*>(out),
              nullptr, nullptr, H, W, C, 1, th, tiles_w, tiles, eps};
  const dim3 grid(tiles, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warps == 8) return launch_ln_qkv_dwconv<8>(a, grid, L.total, s);
  if (warps == 16) return launch_ln_qkv_dwconv<16>(a, grid, L.total, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
