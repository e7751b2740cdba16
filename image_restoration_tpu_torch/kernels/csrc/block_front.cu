// Pass 1 of the Restormer TransformerBlock: LN1 -> qkv 1x1 -> 3x3 depthwise,
// writing v and the per-head q^T k Gram and sums of squares of q and k.
//
// Replaces the TPU kernel image_restoration_tpu/kernels/block_pallas.py
// `_front_kernel` (launched by `run_front`). Same math, same rounding points:
// LN1 with fp32 statistics over the real C, output rounded to bf16; the qkv
// 1x1 on bf16 operands with fp32 accumulation (tensor cores, nvcuda::wmma);
// bias added and out-of-image pixels zeroed before the fp32 depthwise (torch
// zero-pads the projected map); v stored as bf16; q and k rounded to bf16
// for the Gram, their sums of squares taken in fp32.
//
// Differences from the TPU design:
// * The TPU carries q^T k across a sequential grid. Hopper blocks run in no
//   order, so each block walks a strided set of tiles, accumulates its own
//   Gram in shared memory, and writes one partial; `front_reduce_kernel`
//   sums the partials in a fixed order, so the result is deterministic.
// * Only the per-head diagonal (ch x ch) blocks of q^T k are computed: they
//   are all the finalize reads. The TPU's full lane-span product is an
//   artefact of its 128-lane layout.
// * No canvas: tiles are 16 pixels wide and `th` rows high, the halo is
//   loaded under a mask, and ragged image edges are masked.
//
// What bounds it on the card: the x read and v write (2 x H*W*C bf16) are
// the only full-size traffic; q and k never reach device memory. The qkv
// product is recomputed on the halo ((th+2)*18 pixels for th*16 outputs),
// and the LN, depthwise and Gram passes run from shared memory, so this
// first version is bound by shared-memory traffic and the scalar depthwise
// loop rather than by DRAM; wgmma/TMA pipelining is later work.
//
// Shared memory (FrontSmem): the LN'd halo tile (bf16, all C channels), one
// 48-channel (or 32/16 when ch needs it) fp32 chunk of the projected map,
// bf16 q and k of one head, the fp32 Gram accumulator of every head and the
// sums of squares. The tile height th is the host's (kernels/block.py
// _FRONT_TILE_ROWS, the fastest of 8/4/2/1 measured on an H100 at each
// width): the limit is the 227 KB of shared memory a block may take, and
// at C = 384 (8 heads of 48) th = 8 does not fit, th = 4 takes ~198 KB and
// th = 2 (~160 KB, the one chosen) gives the 64x64 latent level 128 blocks
// for the 132 SMs where th = 4 gives 64.
#include "front.cuh"

namespace irk {

__global__ void __launch_bounds__(F_THREADS)
    block_front_kernel(FrontArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FrontSmem L(a.C, a.heads, a.th);
  bf16* ys = reinterpret_cast<bf16*>(smem + L.off_y);
  float* proj = reinterpret_cast<float*>(smem + L.off_p);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.off_q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.off_k);
  float* gacc = reinterpret_cast<float*>(smem + L.off_g);
  float* ssacc = reinterpret_cast<float*>(smem + L.off_ss);
  float* red = reinterpret_cast<float*>(smem + L.off_red);

  const int C = a.C, heads = a.heads, ch = C / heads, nc = front_chunk(ch);
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid / 32,
            lane = tid % 32;
  const int ng = heads * ch * ch;
  for (int i = tid; i < ng; i += F_THREADS) gacc[i] = 0.f;
  for (int i = tid; i < 2 * C; i += F_THREADS) ssacc[i] = 0.f;

  const bf16* xb = a.x + (size_t)b * a.H * a.W * C;
  bf16* vb = a.v + (size_t)b * a.H * a.W * C;

  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const Halo hl{(t / a.tiles_w) * a.th, (t % a.tiles_w) * TILE_W, a.H, a.W};
    __syncthreads();  // the previous tile is done with ys and proj
    front_ln_tile(a, L, hl, xb, ys, warp, lane);
    __syncthreads();

    for (int h = 0; h < heads; ++h) {
      for (int part = 0; part < 2; ++part) {  // q, then k
        bf16* dst = part ? ks : qs;
        for (int sub = 0; sub < ch; sub += nc) {
          const int col0 = part * C + h * ch + sub;
          front_project(a, L, ys, proj, col0, nc, warp);
          __syncthreads();
          front_dwconv(a, L, hl, proj, col0, nc, dst, sub, ssacc, red,
                       nullptr, tid);
        }
      }
      front_gram(L.npix, L.ldq, ch, qs, ks, gacc + h * ch * ch, warp,
                 F_WARPS);
      __syncthreads();
    }
    for (int sub = 0; sub < C; sub += nc) {
      const int col0 = 2 * C + sub;
      front_project(a, L, ys, proj, col0, nc, warp);
      __syncthreads();
      front_dwconv(a, L, hl, proj, col0, nc, nullptr, 0, nullptr, nullptr,
                   vb, tid);
    }
  }
  __syncthreads();
  const size_t part = (size_t)b * gridDim.x + blockIdx.x;
  for (int i = tid; i < ng; i += F_THREADS) a.gram_part[part * ng + i] = gacc[i];
  for (int i = tid; i < 2 * C; i += F_THREADS)
    a.ss_part[part * 2 * C + i] = ssacc[i];
}

}  // namespace irk

extern "C" {

// Dynamic shared memory one block of the pass-1 kernel needs.
int ir_block_front_smem(int C, int heads, int th) {
  return static_cast<int>(irk::FrontSmem(C, heads, th).total);
}

// Launches pass 1 on `stream`: `grid_x` blocks per batch image walk the
// tiles; partial buffers hold B * grid_x entries. Returns cudaGetLastError().
int ir_block_front(const void* x, const void* ln_w, const void* ln_b,
                   const void* wqkv, const void* bqkv, const void* dw,
                   const void* db, void* v, void* gram_part, void* ss_part,
                   void* gram, void* ss, int B, int H, int W, int C,
                   int heads, int th, int grid_x, float eps, void* stream) {
  using namespace irk;
  const FrontSmem L(C, heads, th);
  if (L.total > static_cast<size_t>(SMEM_LIMIT)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      block_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return e;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  FrontArgs a{static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
              static_cast<const float*>(ln_b), static_cast<const bf16*>(wqkv),
              static_cast<const float*>(bqkv), static_cast<const float*>(dw),
              static_cast<const float*>(db), static_cast<bf16*>(v),
              static_cast<float*>(gram_part), static_cast<float*>(ss_part),
              H, W, C, heads, th, tiles_w, tiles, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  block_front_kernel<<<dim3(grid_x, B), F_THREADS, L.total, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_front_reduce(gram_part, ss_part, gram, ss, B, grid_x,
                             C * (C / heads), 2 * C, s);
}

const char* ir_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
