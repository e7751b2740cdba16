// Pass 2 of the Restormer TransformerBlock: attention apply + residual, LN2,
// and the whole gated-Dconv FFN + residual, one tile of output per block.
//
// Replaces the TPU kernel image_restoration_tpu/kernels/block_pallas.py
// `_apply_gdfn_kernel`. Per output tile, with a one-pixel halo:
//   ao  = x + v @ (A^T W_proj) + b_proj   (atw folded per batch beforehand)
//   y   = bf16(LN2(ao))                    (fp32 statistics over the real C)
//   cg  = y @ [W_content | W_gate] + b     (masked to 0 outside the image)
//   act = bf16(gelu(dw3x3(cg_c)) * dw3x3(cg_g))   (exact erf GELU, fp32 taps)
//   out = bf16(act @ W_out + b_out + ao)
// Every product takes bf16 operands and accumulates in fp32 on the tensor
// cores (mma.sync in the FFN, nvcuda::wmma in phase 1); the rounding points
// are the TPU kernel's.
//
// What bounds it on the card: the hidden width is 2.66 C (x2 for content
// and gate), so the expanded activation is 5.3x the block's input. The
// kernel never writes it: it loops over hidden chunks of 32 content + 32
// gate channels, and each chunk's act @ W_out is accumulated into the
// (pixels x C) output tile, which the warps hold in registers. Device-memory
// traffic is the v and x reads (with halo) and the output write; the time
// goes to shared-memory and tensor-core work in short stages between
// barriers (gdfn.cuh says what the FFN tail does about that).
//
// Phase 1 (here): cp.async stages the x halo tile into ys and v 16 halo
// pixels at a time into one of two buffers, a block of rows ahead of the
// product v @ atw that reads it (wmma, atw through L1); LN2 then takes 8
// lanes a pixel in place. Phase 2 is gdfn_tail. Still open in phase 1: the
// atw fragments come from device memory (L1) inside the k loop, and at
// C = 384 one 16-row product keeps 16 warps busy for 24 dependent steps.
//
// Shared memory (ApplySmem): the LN2'd halo tile (bf16, all C), then one
// region that the fp32 output tile and phase 1's staging (2 x 16 rows of v,
// 16 rows of ao) share with phase 2's chunk buffers. The tile height th and
// the warps a block are the host's (kernels/block.py _APPLY_TILE_ROWS and
// _APPLY_WARPS, the fastest of 8/4/2 rows x 8/16 warps measured on an H100
// at each width); gdfn.cuh lists the bytes per width. The limit is the 227
// KB a block may take: at C = 384 th = 4 no longer fits beside phase 1's
// staging, and th = 2 also gives the 64x64 latent level 128 blocks for the
// 132 SMs instead of 64.
#include "gdfn.cuh"

namespace irk {

template <int NF, int NW>
__global__ void __launch_bounds__(NW * 32)
    block_apply_gdfn_kernel(ApplyArgs a) {
  constexpr int A_THREADS = NW * 32, A_WARPS = NW;
  extern __shared__ __align__(128) unsigned char smem[];
  const ApplySmem L(a.C, a.th);
  bf16* ys = reinterpret_cast<bf16*>(smem + L.off_y);
  float* oacc = reinterpret_cast<float*>(smem + L.off_o);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.off_vs);  // two buffers
  float* ao = reinterpret_cast<float*>(smem + L.off_ao);

  const int C = a.C, b = blockIdx.y, t = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Halo hl{(t / a.tiles_w) * a.th, (t % a.tiles_w) * TILE_W, a.H, a.W};
  const size_t img = (size_t)b * a.H * a.W * C;
  const bf16* atw = a.atw + (size_t)b * C * C;

  // Phase 1. The x halo tile goes to ys, 16 bytes a copy and zeros outside
  // the image; v follows 16 halo pixels at a time, one block of rows ahead
  // of the product that reads it, so no step waits on device memory but the
  // first.
  const int per_row = C / 8;
  for (int i = tid; i < L.Pp * per_row; i += A_THREADS) {
    const int p = i / per_row, s = i % per_row * 8;
    const int gr = hl.r0 - 1 + p / L.hcols, gc = hl.c0 - 1 + p % L.hcols;
    const bool in = p < L.P && hl.inside(gr, gc);
    cp_async16(ys + p * L.ldy + s,
               in ? a.x + img + ((size_t)gr * a.W + gc) * C + s : a.x, in);
  }
  auto stage_v = [&](int rb, bf16* dst) {
    for (int i = tid; i < 16 * per_row; i += A_THREADS) {
      const int r = i / per_row, s = i % per_row * 8, p = rb + r;
      const int gr = hl.r0 - 1 + p / L.hcols, gc = hl.c0 - 1 + p % L.hcols;
      const bool in = p < L.P && hl.inside(gr, gc);
      cp_async16(dst + r * L.ldy + s,
                 in ? a.v + img + ((size_t)gr * a.W + gc) * C + s : a.v, in);
    }
  };
  stage_v(0, vs);
  cp_async_commit();
  for (int i = tid; i < L.npix * L.ldo; i += A_THREADS) oacc[i] = 0.f;

  // Per 16 halo pixels: ao = v @ atw, then LN2 of ao + b_proj + x in place
  // in ys, 8 lanes a pixel; centre pixels also seed the output accumulator
  // with that sum + b_out (both residuals of the block).
  for (int rb = 0, it = 0; rb < L.Pp; rb += 16, ++it) {
    const bf16* vcur = vs + (it & 1) * 16 * L.ldy;
    if (rb + 16 < L.Pp) stage_v(rb + 16, vs + ((it + 1) & 1) * 16 * L.ldy);
    cp_async_commit();
    cp_async_wait_group<1>();  // all but the rows just asked for
    __syncthreads();
    for (int ni = warp; ni < C / 16; ni += A_WARPS) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < C; k += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, vcur + k, L.ldy);
        wmma::load_matrix_sync(fb, atw + (size_t)k * C + ni * 16, C);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(ao + ni * 16, acc, L.ldo, wmma::mem_row_major);
    }
    __syncthreads();
    // the next round's first barrier keeps its product off ao until every
    // warp is through here
    for (int r0 = warp * 4; r0 < 16; r0 += A_WARPS * 4) {
      const int r = r0 + lane / 8, p = rb + r;
      const int hr = p / L.hcols, hc = p % L.hcols;
      const bool live =
          p < L.P && hl.inside(hl.r0 - 1 + hr, hl.c0 - 1 + hc);
      const bool centre = hr >= 1 && hr <= a.th && hc >= 1 && hc <= TILE_W;
      bf16* yrow = ys + p * L.ldy;
      const float* arow = ao + r * L.ldo;
      float* orow = oacc + ((hr - 1) * TILE_W + hc - 1) * L.ldo;
      group8_layernorm(
          live, C, a.c_real, a.eps, a.ln_w, a.ln_b, lane % 8,
          [&](int v, float(&x)[8]) {
            unpack8(*reinterpret_cast<const uint4*>(yrow + v * 8), x);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              x[e] += arow[v * 8 + e] + (a.bp ? a.bp[v * 8 + e] : 0.f);
          },
          [&](int v, const float(&x)[8], const float(&y)[8]) {
            if (centre) {
#pragma unroll
              for (int e = 0; e < 8; ++e)
                orow[v * 8 + e] = x[e] + (a.bo ? a.bo[v * 8 + e] : 0.f);
            }
            *reinterpret_cast<uint4*>(yrow + v * 8) = pack8(y);
          });
    }
  }
  __syncthreads();

  // Phase 2: the FFN, one hidden chunk at a time, and the output.
  gdfn_tail<NF, NW>(a, L, hl, smem, img);
}

struct LaunchApplyGdfn {
  ApplyArgs a;
  dim3 grid;
  size_t smem;
  cudaStream_t stream;
  template <int NF, int NW>
  cudaError_t run() const {
    cudaError_t e = cudaFuncSetAttribute(
        block_apply_gdfn_kernel<NF, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    block_apply_gdfn_kernel<NF, NW><<<grid, NW * 32, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace irk

extern "C" {

// Dynamic shared memory one block of the pass-2 kernel needs; above the
// card's limit for a tile whose output fragments no instantiation holds.
int ir_block_apply_gdfn_smem(int C, int th, int warps) {
  if (!irk::tail_frags(C, th, warps)) return irk::SMEM_LIMIT + 1;
  return static_cast<int>(irk::ApplySmem(C, th).total);
}

// Launches pass 2 on `stream`, one block per output tile and batch image.
// `hp` is the hidden width padded to a multiple of 32; `warps` (8 or 16) the
// block size. Returns cudaGetLastError().
// `c_real` (1 <= c_real <= C) is the number of real channels, those
// the LayerNorm's statistics take; the other C - c_real are pads that
// are 0 in every input and weight (kernels/widths.py).
int ir_block_apply_gdfn(const void* v, const void* x, const void* atw,
                        const void* bp, const void* ln_w, const void* ln_b,
                        const void* wcg, const void* bcg, const void* dwcg,
                        const void* dbcg, const void* wo, const void* bo,
                        void* out, int B, int H, int W, int C, int c_real,
                        int hp, int th, int warps, float eps, void* stream) {
  using namespace irk;
  const ApplySmem L(C, th);
  if (L.total > static_cast<size_t>(SMEM_LIMIT) || hp % NH || c_real < 1 ||
      c_real > C)
    return cudaErrorInvalidValue;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  ApplyArgs a{static_cast<const bf16*>(v), static_cast<const bf16*>(x),
              static_cast<const bf16*>(atw), static_cast<const float*>(bp),
              static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
              static_cast<const bf16*>(wcg), static_cast<const float*>(bcg),
              static_cast<const float*>(dwcg), static_cast<const float*>(dbcg),
              static_cast<const bf16*>(wo), static_cast<const float*>(bo),
              static_cast<bf16*>(out), H, W, C, hp, th, tiles_w, eps,
              c_real};
  return dispatch_tail(
      C, th, warps,
      LaunchApplyGdfn{a, dim3(tiles, B), L.total,
                      static_cast<cudaStream_t>(stream)});
}

}  // extern "C"
