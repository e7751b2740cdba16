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
// cores (nvcuda::wmma); the rounding points are the TPU kernel's.
//
// What bounds it on the card: the hidden width is 2.66 C (x2 for content
// and gate), so the expanded activation is 5.3x the block's input. The
// kernel never writes it: it loops over hidden chunks of 32 content + 32
// gate channels, and each chunk's act @ W_out is accumulated into the fp32
// (pixels x C) output tile kept in shared memory. Device-memory traffic is
// the v and x reads (with halo) and the output write; the rest is
// shared-memory and tensor-core work, which this first version does not yet
// pipeline (no TMA, no wgmma).
//
// Shared memory (ApplySmem): the LN2'd halo tile (bf16, all C), the fp32
// output accumulator (th*16 pixels x C), and a region shared by the phase-1
// staging (16 rows of v, 16 rows of ao) and the phase-2 chunk buffers
// (fp32 content|gate of the halo tile, bf16 act). The tile height th is
// the host's (kernels/block.py _APPLY_TILE_ROWS, the fastest of 8/4/2/1
// measured on an H100 at each width): the limit is the 227 KB of shared
// memory a block may take, which at C = 384 rules out th = 8 and leaves
// th = 4 (~219 KB, one block per SM) or th = 2 (~146 KB, the one chosen,
// which also gives the 64x64 latent level 128 blocks instead of 64).
#include "gdfn.cuh"

namespace irk {

__global__ void __launch_bounds__(A_THREADS)
    block_apply_gdfn_kernel(ApplyArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ApplySmem L(a.C, a.th);
  bf16* ys = reinterpret_cast<bf16*>(smem + L.off_y);
  float* oacc = reinterpret_cast<float*>(smem + L.off_o);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.off_vs);
  float* ao = reinterpret_cast<float*>(smem + L.off_ao);
  float* cg = reinterpret_cast<float*>(smem + L.off_cg);
  bf16* act = reinterpret_cast<bf16*>(smem + L.off_act);

  const int C = a.C, b = blockIdx.y, t = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Halo hl{(t / a.tiles_w) * a.th, (t % a.tiles_w) * TILE_W, a.H, a.W};
  const size_t img = (size_t)b * a.H * a.W * C;
  const bf16* atw = a.atw + (size_t)b * C * C;

  for (int i = tid; i < L.npix * L.ldo; i += A_THREADS) oacc[i] = 0.f;

  // Phase 1, 16 halo pixels at a time: ao = x + v @ atw + b_proj, then LN2
  // into ys; centre pixels also seed the output accumulator with
  // ao + b_out (both residuals of the block).
  for (int rb = 0; rb < L.Pp; rb += 16) {
    for (int r = warp; r < 16; r += A_WARPS) {
      const int p = rb + r;
      const int gr = hl.r0 - 1 + p / L.hcols, gc = hl.c0 - 1 + p % L.hcols;
      bf16* dst = vs + r * L.ldy;
      if (p < L.P && hl.inside(gr, gc)) {
        const bf16* src = a.v + img + ((size_t)gr * a.W + gc) * C;
        for (int c = lane; c < C; c += 32) dst[c] = src[c];
      } else {
        for (int c = lane; c < C; c += 32) dst[c] = f2bf(0.f);
      }
    }
    __syncthreads();
    for (int ni = warp; ni < C / 16; ni += A_WARPS) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < C; k += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, vs + k, L.ldy);
        wmma::load_matrix_sync(fb, atw + (size_t)k * C + ni * 16, C);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(ao + ni * 16, acc, L.ldo, wmma::mem_row_major);
    }
    __syncthreads();
    for (int r = warp; r < 16; r += A_WARPS) {
      const int p = rb + r;
      const int hr = p / L.hcols, hc = p % L.hcols;
      const int gr = hl.r0 - 1 + hr, gc = hl.c0 - 1 + hc;
      bf16* yrow = ys + p * L.ldy;
      if (p >= L.P || !hl.inside(gr, gc)) {
        for (int c = lane; c < C; c += 32) yrow[c] = f2bf(0.f);
        continue;
      }
      const bf16* xr = a.x + img + ((size_t)gr * a.W + gc) * C;
      float* arow = ao + r * L.ldo;
      for (int c = lane; c < C; c += 32)
        arow[c] += (a.bp ? a.bp[c] : 0.f) + bf2f(xr[c]);
      __syncwarp();
      warp_layernorm([&](int c) { return arow[c]; }, C, a.eps, a.ln_w,
                     a.ln_b, yrow, lane);
      if (hr >= 1 && hr <= a.th && hc >= 1 && hc <= TILE_W) {
        float* orow = oacc + ((hr - 1) * TILE_W + hc - 1) * L.ldo;
        for (int c = lane; c < C; c += 32)
          orow[c] = arow[c] + (a.bo ? a.bo[c] : 0.f);
      }
    }
    __syncthreads();
  }

  // Phase 2: the FFN, one hidden chunk at a time, and the output.
  gdfn_tail(a, L, hl, ys, oacc, cg, act, img, tid, warp, lane);
}

}  // namespace irk

extern "C" {

// Dynamic shared memory one block of the pass-2 kernel needs.
int ir_block_apply_gdfn_smem(int C, int th) {
  return static_cast<int>(irk::ApplySmem(C, th).total);
}

// Launches pass 2 on `stream`, one block per output tile and batch image.
// `hp` is the hidden width padded to a multiple of 32. Returns
// cudaGetLastError().
int ir_block_apply_gdfn(const void* v, const void* x, const void* atw,
                        const void* bp, const void* ln_w, const void* ln_b,
                        const void* wcg, const void* bcg, const void* dwcg,
                        const void* dbcg, const void* wo, const void* bo,
                        void* out, int B, int H, int W, int C, int hp, int th,
                        float eps, void* stream) {
  using namespace irk;
  const ApplySmem L(C, th);
  if (L.total > static_cast<size_t>(SMEM_LIMIT) || hp % NH)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      block_apply_gdfn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return e;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  ApplyArgs a{static_cast<const bf16*>(v), static_cast<const bf16*>(x),
              static_cast<const bf16*>(atw), static_cast<const float*>(bp),
              static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
              static_cast<const bf16*>(wcg), static_cast<const float*>(bcg),
              static_cast<const float*>(dwcg), static_cast<const float*>(dbcg),
              static_cast<const bf16*>(wo), static_cast<const float*>(bo),
              static_cast<bf16*>(out), H, W, C, hp, th, tiles_w, eps};
  block_apply_gdfn_kernel<<<dim3(tiles, B), A_THREADS, L.total,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
