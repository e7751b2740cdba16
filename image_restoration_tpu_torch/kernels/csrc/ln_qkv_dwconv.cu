// LN1 -> qkv 1x1 -> 3x3 depthwise of the three-kernel Restormer block,
// writing the whole (B, H, W, 3C) qkv map, channels [q | k | v].
//
// Replaces the TPU kernel image_restoration_tpu/kernels/mdta_pallas.py
// `_kernel` (behind `fused_ln_qkv_dwconv` and `fused_ln_qkv_dwconv_split`).
// Same math and rounding points: LN1 with fp32 statistics over the real C,
// output rounded to bf16; the 1x1 on bf16 operands with fp32 accumulation
// (tensor cores, nvcuda::wmma); bias added and out-of-image pixels zeroed
// before the fp32 depthwise (torch zero-pads the projected map); only the
// result is rounded to bf16. The TPU's 128-lane slots for q, k and v (the
// split variant) are a TPU layout: q, k and v are contiguous here.
//
// The kernel is pass 1 of the whole-block pair (block_front.cu, K1) with q
// and k written to device memory instead of reduced: it runs the same
// device functions (front.cuh) over all 3C projected channels in chunks of
// 48 (32 or 16 where C needs it), one output tile of th x 16 pixels per
// block with a one-pixel halo, recomputing the 1x1 on the halo.
//
// What bounds it on the card: the x read and the 3C-wide write (4 x H*W*C
// bf16) are its device-memory traffic, ~0.03 ms at 512x512x48 at the
// H100's 3.35 TB/s;
// like K1 this first version is held back by the scalar depthwise loop and
// shared-memory traffic, not by DRAM. wgmma/TMA pipelining is later work.
//
// Shared memory: the LN'd halo tile (bf16, all C) and one fp32 projected
// chunk (FrontSmem without K1's q, k and Gram buffers), ~80 KB at C = 384
// and th = 2.
#include "front.cuh"

namespace irk {

__global__ void __launch_bounds__(F_THREADS)
    ln_qkv_dwconv_kernel(FrontArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FrontSmem L(a.C, 1, a.th, false);
  bf16* ys = reinterpret_cast<bf16*>(smem + L.off_y);
  float* proj = reinterpret_cast<float*>(smem + L.off_p);

  const int C = a.C, C3 = 3 * C, nc = front_chunk(C);
  const int b = blockIdx.y, t = blockIdx.x, tid = threadIdx.x,
            warp = tid / 32, lane = tid % 32;
  const Halo hl{(t / a.tiles_w) * a.th, (t % a.tiles_w) * TILE_W, a.H, a.W};
  const bf16* xb = a.x + (size_t)b * a.H * a.W * C;
  bf16* ob = a.v + (size_t)b * a.H * a.W * C3;

  front_ln_tile(a, L, hl, xb, ys, warp, lane);
  __syncthreads();
  for (int col0 = 0; col0 < C3; col0 += nc) {
    front_project(a, L, ys, proj, col0, nc, warp);
    __syncthreads();
    // ends with __syncthreads(): proj is free for the next chunk
    front_dwconv<true>(a, L, hl, proj, col0, nc, nullptr, 0, nullptr,
                       nullptr, ob, tid);
  }
}

}  // namespace irk

extern "C" {

// Dynamic shared memory one block of the kernel needs.
int ir_ln_qkv_dwconv_smem(int C, int th) {
  return static_cast<int>(irk::FrontSmem(C, 1, th, false).total);
}

// Launches the kernel on `stream`, one block per output tile and batch
// image; `out` is (B, H, W, 3C). Returns cudaGetLastError().
int ir_ln_qkv_dwconv(const void* x, const void* ln_w, const void* ln_b,
                     const void* wqkv, const void* bqkv, const void* dw,
                     const void* db, void* out, int B, int H, int W, int C,
                     int th, float eps, void* stream) {
  using namespace irk;
  const FrontSmem L(C, 1, th, false);
  if (L.total > static_cast<size_t>(SMEM_LIMIT) || C % 16)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ln_qkv_dwconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return e;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  FrontArgs a{static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
              static_cast<const float*>(ln_b), static_cast<const bf16*>(wqkv),
              static_cast<const float*>(bqkv), static_cast<const float*>(dw),
              static_cast<const float*>(db), static_cast<bf16*>(out),
              nullptr, nullptr, H, W, C, 1, th, tiles_w, tiles, eps};
  ln_qkv_dwconv_kernel<<<dim3(tiles, B), F_THREADS, L.total,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
