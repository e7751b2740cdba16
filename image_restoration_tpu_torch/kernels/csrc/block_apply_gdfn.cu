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
#include "common.cuh"

namespace irk {

constexpr int A_THREADS = 256;  // 8 warps
constexpr int A_WARPS = A_THREADS / 32;
constexpr int NH = 32;  // hidden channels per chunk (content and gate each)

struct ApplySmem {
  int hcols, P, Pp, npix, ldy, ldo, ldcg, ldact;
  size_t off_y, off_o, off_vs, off_ao, off_cg, off_act, total;
  __host__ __device__ ApplySmem(int C, int th) {
    hcols = TILE_W + 2;
    P = (th + 2) * hcols;
    Pp = round16(P);
    npix = th * TILE_W;
    ldy = C + 8;
    ldo = C + 4;
    ldcg = 2 * NH + 4;
    ldact = NH + 8;
    size_t o = 0;
    off_y = o; o = align128(o + sizeof(bf16) * Pp * ldy);
    off_o = o; o = align128(o + sizeof(float) * npix * ldo);
    // phase 1 staging and phase 2 chunk buffers share one region
    off_vs = o;
    off_ao = align128(off_vs + sizeof(bf16) * 16 * ldy);
    const size_t end1 = align128(off_ao + sizeof(float) * 16 * ldo);
    off_cg = o;
    off_act = align128(off_cg + sizeof(float) * Pp * ldcg);
    const size_t end2 = align128(off_act + sizeof(bf16) * npix * ldact);
    total = end1 > end2 ? end1 : end2;
  }
};

struct ApplyArgs {
  const bf16* v;      // (B, H, W, C)
  const bf16* x;      // (B, H, W, C) block input (residual)
  const bf16* atw;    // (B, C, C) = A^T W_proj per batch
  const float* bp;    // (C) or null
  const float* ln_w;  // (C)
  const float* ln_b;  // (C) or null (BiasFree)
  const bf16* wcg;    // (C, 2 hp): content at [0, hp), gate at [hp, 2 hp)
  const float* bcg;   // (2 hp) or null
  const float* dwcg;  // (9, 2 hp) depthwise taps, kh * 3 + kw
  const float* dbcg;  // (2 hp) or null
  const bf16* wo;     // (hp, C)
  const float* bo;    // (C) or null
  bf16* out;          // (B, H, W, C)
  int H, W, C, hp, th, tiles_w;
  float eps;
};

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

  // Phase 2, one hidden chunk at a time.
  const int ldcgw = 2 * a.hp;
  for (int j0 = 0; j0 < a.hp; j0 += NH) {
    // cg[Pp x 2NH] = ys @ [W_content chunk | W_gate chunk]
    for (int i = warp; i < (L.Pp / 16) * 4; i += A_WARPS) {
      const int mi = i / 4, ni = i % 4;
      const int col = ni < 2 ? j0 + ni * 16 : a.hp + j0 + (ni - 2) * 16;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < C; k += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, ys + mi * 16 * L.ldy + k, L.ldy);
        wmma::load_matrix_sync(fb, a.wcg + (size_t)k * ldcgw + col, ldcgw);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(cg + mi * 16 * L.ldcg + ni * 16, acc, L.ldcg,
                              wmma::mem_row_major);
    }
    __syncthreads();
    {
      // depthwise 3x3 of content and gate, gelu(content) * gate -> bf16.
      // Thread (n, g) owns chunk channel n and pixels g, g + 8, ...
      const int n = tid % NH, g = tid / NH;
      const int cc = j0 + n, gcol = a.hp + j0 + n;
      float wc[9], wg[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        wc[k] = a.dwcg[k * ldcgw + cc];
        wg[k] = a.dwcg[k * ldcgw + gcol];
      }
      const float bc = a.bcg ? a.bcg[cc] : 0.f;
      const float bg = a.bcg ? a.bcg[gcol] : 0.f;
      const float dbc = a.dbcg ? a.dbcg[cc] : 0.f;
      const float dbg = a.dbcg ? a.dbcg[gcol] : 0.f;
      for (int q = g; q < L.npix; q += A_THREADS / NH) {
        const int orow = q / TILE_W, ocol = q % TILE_W;
        const int gr = hl.r0 + orow, gc = hl.c0 + ocol;
        float ac = dbc, ag = dbg;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            if (hl.inside(gr - 1 + kh, gc - 1 + kw)) {
              const float* cp =
                  cg + ((orow + kh) * L.hcols + ocol + kw) * L.ldcg;
              ac += (cp[n] + bc) * wc[kh * 3 + kw];
              ag += (cp[NH + n] + bg) * wg[kh * 3 + kw];
            }
        const float gel = 0.5f * ac * (1.f + erff(ac * 0.70710678118654752f));
        act[q * L.ldact + n] = f2bf(hl.inside(gr, gc) ? gel * ag : 0.f);
      }
    }
    __syncthreads();
    // oacc[npix x C] += act[npix x NH] @ W_out[j0 : j0 + NH, :]
    const int no = C / 16;
    for (int i = warp; i < (L.npix / 16) * no; i += A_WARPS) {
      const int mi = i / no, ni = i % no;
      FragC acc;
      float* optr = oacc + mi * 16 * L.ldo + ni * 16;
      wmma::load_matrix_sync(acc, optr, L.ldo, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < NH; k += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, act + mi * 16 * L.ldact + k, L.ldact);
        wmma::load_matrix_sync(fb, a.wo + (size_t)(j0 + k) * C + ni * 16, C);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(optr, acc, L.ldo, wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int q = warp; q < L.npix; q += A_WARPS) {
    const int gr = hl.r0 + q / TILE_W, gc = hl.c0 + q % TILE_W;
    if (!hl.inside(gr, gc)) continue;
    bf16* dst = a.out + img + ((size_t)gr * a.W + gc) * C;
    const float* src = oacc + q * L.ldo;
    for (int c = lane; c < C; c += 32) dst[c] = f2bf(src[c]);
  }
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
