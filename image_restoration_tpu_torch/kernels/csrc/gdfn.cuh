// Device code shared by the two kernels that end a Restormer block with
// LN2 and the gated-Dconv FFN: pass 2 of the whole-block pair
// (block_apply_gdfn.cu, K2) and the LN + GDFN kernel of the three-kernel
// block (ln_gdfn.cu, K3). Both first fill, for a th x 16 output tile with a
// one-pixel halo, the LN2'd tile `ys` (bf16) and the fp32 output
// accumulator `oacc` seeded with the residual + b_out; gdfn_tail then runs
// the FFN in hidden chunks of NH content + NH gate channels:
//   cg  = ys @ [W_content | W_gate] + b     (masked to 0 outside the image)
//   act = bf16(gelu(dw3x3(cg_c)) * dw3x3(cg_g))   (exact erf GELU, fp32 taps)
//   oacc += act @ W_out
// and writes bf16(oacc). Every product takes bf16 operands and accumulates
// in fp32 on the tensor cores (nvcuda::wmma).
#pragma once

#include "common.cuh"

namespace irk {

constexpr int A_THREADS = 256;  // 8 warps
constexpr int A_WARPS = A_THREADS / 32;
constexpr int NH = 32;  // hidden channels per chunk (content and gate each)

struct ApplySmem {
  int hcols, P, Pp, npix, ldy, ldo, ldcg, ldact;
  size_t off_y, off_o, off_vs, off_ao, off_cg, off_act, total;
  __host__ __device__ ApplySmem(int C, int th, bool staging = true) {
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
    // K2's phase-1 staging and the chunk buffers share one region
    off_vs = o;
    off_ao = align128(off_vs + sizeof(bf16) * 16 * ldy);
    const size_t end1 =
        staging ? align128(off_ao + sizeof(float) * 16 * ldo) : o;
    off_cg = o;
    off_act = align128(off_cg + sizeof(float) * Pp * ldcg);
    const size_t end2 = align128(off_act + sizeof(bf16) * npix * ldact);
    total = end1 > end2 ? end1 : end2;
  }
};

struct ApplyArgs {
  const bf16* v;      // (B, H, W, C); K2 only
  const bf16* x;      // (B, H, W, C) block input (residual)
  const bf16* atw;    // (B, C, C) = A^T W_proj per batch; K2 only
  const float* bp;    // (C) or null; K2 only
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

// The FFN of the tile (`ys` and `oacc` filled) and the bf16 write of the
// output; `img` is the batch image's offset in x and out.
static __device__ void gdfn_tail(const ApplyArgs& a, const ApplySmem& L,
                                 const Halo& hl, const bf16* ys, float* oacc,
                                 float* cg, bf16* act, size_t img, int tid,
                                 int warp, int lane) {
  const int C = a.C;
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
