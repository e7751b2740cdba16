// Pass 1 of the Restormer TransformerBlock: LN1 -> qkv 1x1 -> 3x3 depthwise,
// writing v and the per-head q^T k Gram and sums of squares of q and k.
//
// Replaces the TPU kernel image_restoration_tpu/kernels/block_pallas.py
// `_front_kernel` (launched by `run_front`). Same math, same rounding points:
// LN1 with fp32 statistics over the real C, output rounded to bf16; the qkv
// 1x1 on bf16 operands with fp32 accumulation (tensor cores, mma.sync);
// bias added and out-of-image pixels zeroed before the fp32 depthwise (torch
// zero-pads the projected map); v stored as bf16; q and k rounded to bf16
// for the Gram, their sums of squares taken in fp32.
//
// Differences from the TPU design:
// * The TPU carries q^T k across a sequential grid. Hopper blocks run in no
//   order, so each block walks a strided set of tiles, accumulates its own
//   Gram in registers, and writes one partial; `front_reduce_kernel` sums
//   the partials in a fixed order, so the result is deterministic.
// * Only the per-head diagonal (ch x ch) blocks of q^T k are computed: they
//   are all the finalize reads. The TPU's full lane-span product is an
//   artefact of its 128-lane layout.
// * No canvas: tiles are 16 pixels wide and `th` rows high, the halo is
//   loaded under a mask, and ragged image edges are masked.
//
// What bounds it on the card: by its bound the x read and the v write (2 x
// H*W*C bf16; q and k never reach device memory); in fact a tile's short
// stages between barriers (front.cuh says what the design does about them).
// Blocks of 8 or 16 warps; with 8, a warp keeps 1, 2, 3, 5 or 9 Gram
// fragments (16 x 16) in registers over all its tiles, with 16 at most 3,
// so 8 heads of 48 (72 fragments) take 8 warps. The grid holds as many
// blocks as the card runs at once (ir_block_front_blocks).
//
// Shared memory (FrontSmem): the LN'd halo tile (bf16, all C), two buffers
// of a chunk's W_qkv slice and of its taps, the fp32 projected chunk, q and
// k of every head of the tile (bf16), the sums of squares. At the tile
// heights and warps of kernels/block.py (bytes, blocks an SM, ms a call at
// Restormer-base's 512x512 shapes on an NVIDIA H100 80GB HBM3, 700 W;
// PERF.md): C = 48, th 8, 8 warps: 114,688, 2, 0.212; C = 96, th 8, 16
// warps: 168,832, 1, 0.138 (256x256, 2 heads) and 0.500 (512x512, 1 head);
// C = 192, th 4, 16 warps: 172,928, 1, 0.124 (th 8 does not fit); C = 384,
// th 2, 8 warps: 225,664, 1, 0.156 (th 4 does not fit).
#include "front.cuh"

namespace irk {

template <int NW, int NF>
__global__ void __launch_bounds__(NW * 32) block_front_kernel(FrontArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  front_run<NW, NF>(a, smem);
}

// Launches block_front_kernel<NW, NF>, or with `blocks` set only reports
// how many of its blocks one SM holds.
struct LaunchFront {
  FrontArgs a;
  dim3 grid;
  size_t smem;
  cudaStream_t stream;
  int* blocks;
  template <int NW, int NF>
  cudaError_t run() const {
    const auto kernel = block_front_kernel<NW, NF>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    if (blocks)
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                           NW * 32, smem);
    kernel<<<grid, NW * 32, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

// Calls `launch.run<NW, NF>()` with the block's warps and the Gram
// fragments a warp holds.
static cudaError_t dispatch_front(int C, int heads, int warps,
                                  const LaunchFront& launch) {
  const int nf = front_frags(C, heads, warps);
  if (warps == 8) switch (nf) {
      case 1: return launch.run<8, 1>();
      case 2: return launch.run<8, 2>();
      case 3: return launch.run<8, 3>();
      case 5: return launch.run<8, 5>();
      case 9: return launch.run<8, 9>();
    }
  if (warps == 16) switch (nf) {
      case 1: return launch.run<16, 1>();
      case 2: return launch.run<16, 2>();
      case 3: return launch.run<16, 3>();
    }
  return cudaErrorInvalidValue;
}

static bool front_takes(int C, int heads) {
  return heads > 0 && C % 16 == 0 && C % heads == 0 && (C / heads) % 16 == 0;
}

}  // namespace irk

extern "C" {

// Dynamic shared memory one block of the pass-1 kernel needs; above the
// card's limit where no instantiation holds the Gram of C / heads-wide
// heads in `warps` warps.
int ir_block_front_smem(int C, int heads, int th, int warps) {
  if (!irk::front_takes(C, heads) || !irk::front_frags(C, heads, warps))
    return irk::SMEM_LIMIT + 1;
  return static_cast<int>(irk::FrontSmem(C, th, true).total);
}

// Blocks of the pass-1 kernel one SM holds at once (0 if none).
int ir_block_front_blocks(int C, int heads, int th, int warps) {
  using namespace irk;
  const FrontSmem L(C, th, true);
  if (!front_takes(C, heads) || L.total > static_cast<size_t>(SMEM_LIMIT))
    return 0;
  int blocks = 0;
  FrontArgs a{};
  if (dispatch_front(C, heads, warps,
                     LaunchFront{a, dim3(1), L.total, nullptr, &blocks}) !=
      cudaSuccess)
    return 0;
  return blocks;
}

// Launches pass 1 on `stream`: `grid_x` blocks of `warps` warps per batch
// image walk the tiles; partial buffers hold B * grid_x entries. Returns
// cudaGetLastError().
int ir_block_front(const void* x, const void* ln_w, const void* ln_b,
                   const void* wqkv, const void* bqkv, const void* dw,
                   const void* db, void* v, void* gram_part, void* ss_part,
                   void* gram, void* ss, int B, int H, int W, int C,
                   int heads, int th, int warps, int grid_x, float eps,
                   void* stream) {
  using namespace irk;
  const FrontSmem L(C, th, true);
  if (!front_takes(C, heads) || L.total > static_cast<size_t>(SMEM_LIMIT))
    return cudaErrorInvalidValue;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  FrontArgs a{static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
              static_cast<const float*>(ln_b), static_cast<const bf16*>(wqkv),
              static_cast<const float*>(bqkv), static_cast<const float*>(dw),
              static_cast<const float*>(db), static_cast<bf16*>(v),
              static_cast<float*>(gram_part), static_cast<float*>(ss_part),
              H, W, C, heads, th, tiles_w, tiles, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dispatch_front(
      C, heads, warps, LaunchFront{a, dim3(grid_x, B), L.total, s, nullptr});
  if (e != cudaSuccess) return e;
  return launch_front_reduce(gram_part, ss_part, gram, ss, B, grid_x,
                             C * (C / heads), 2 * C, s);
}

const char* ir_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
