// Device code shared by the two kernels that end a Restormer block with
// LN2 and the gated-Dconv FFN: pass 2 of the whole-block pair
// (block_apply_gdfn.cu, K2) and the LN + GDFN kernel of the three-kernel
// block (ln_gdfn.cu, K3). Both first fill, for a th x 16 output tile with a
// one-pixel halo, the LN2'd tile `ys` (bf16) and the fp32 output tile
// `oacc` seeded with the residual + b_out; gdfn_tail then runs the FFN in
// hidden chunks of NH content + NH gate channels:
//   cg  = ys @ [W_content | W_gate] + b     (fp32; 0 outside the image)
//   act = bf16(gelu(dw3x3(cg_c)) * dw3x3(cg_g))   (exact erf GELU, fp32 taps)
//   out += act @ W_out
// and writes bf16(out). Every product takes bf16 operands and accumulates in
// fp32 on the tensor cores (mma.sync m16n8k16, operands by ldmatrix).
//
// What bounds the tail on an H100. By its roofline bound it is the x read
// and the out write, or the fp32 taps; in fact a tile's three short stages
// a chunk (two products around a stencil, a barrier after each) leave the
// tensor and fp32 pipes waiting on shared memory and on each other, far
// below that bound (PERF.md has the times). What the design does about it:
// * no product reads a weight from device memory: cp.async brings chunk
//   j + 1's W_cg slice and its table of taps and biases while chunk j's taps
//   and out product run, and chunk j's W_out slice while its first product
//   and taps run (padded leading dimensions, conflict-free ldmatrix);
// * a warp keeps its output fragments in registers over the whole chunk
//   loop, so `oacc` is read once and written once, and its bytes serve the
//   chunk buffers in between (th = 8 fits at C = 192, th = 4 at C = 384);
// * the first product adds the 1x1 bias and zeroes the pixels outside the
//   image in registers as it stores cg, so the taps run without a test: a
//   warp slides a 3-column window along a run of 4 output pixels, 18 loads
//   for 36 taps, summing kh then kw as the plain version does;
// * LN2 takes 8 lanes a pixel from a tile that cp.async staged, and the bf16
//   result leaves 8 bytes a thread.
// Shared memory a block at the tile heights and warps of kernels/block.py
// (K2 / K3, bytes): C = 48, th 8, 8 warps: 103,168 / 103,168; C = 96, th 4,
// 8 warps: 86,784 / 86,784 (two blocks an SM); C = 192, th 8, 16 warps:
// 202,496 / 188,416; C = 384, th 2, 16 warps: 174,336 / 174,336.
// Still open: product 1 of chunk j + 1 does not overlap the taps of chunk
// j (cg is single-buffered), and the products are mma.sync, not wgmma.
#pragma once

#include "common.cuh"

namespace irk {

// Both kernels are built for blocks of 8 and of 16 warps (template
// parameter NW); the host picks by channel width.
constexpr int NH = 32;  // hidden channels per chunk (content and gate each)

// Rows of a chunk's fp32 table: the 9 depthwise taps, the 1x1 bias and the
// depthwise bias, each NH content then NH gate values.
constexpr int TAP_ROWS = 11;

// Shared memory of a tile. `ys` stays for the whole kernel. One region
// follows that two users take in turn: first the fp32 output tile `oacc`
// seeded with the residual (and, in K2, phase 1's staging: two buffers of
// 16 rows of v, 16 rows of ao); then, once every warp holds its part of
// `oacc` in registers, the chunk buffers: the chunk's W_cg slice (C x 2 NH), its W_out slice
// (NH x C), two tables of taps and biases, content|gate (fp32) and act. At
// the end `oacc` takes the accumulators back for the bf16 write.
struct ApplySmem {
  int hcols, P, Pp, npix, ldy, ldo, ldw, ldcg, ldact;
  size_t off_y, off_o, off_vs, off_ao, off_w, off_wo, off_tp, off_cg, off_act,
      total;
  __host__ __device__ ApplySmem(int C, int th, bool staging = true) {
    hcols = TILE_W + 2;
    P = (th + 2) * hcols;
    Pp = round16(P);
    npix = th * TILE_W;
    ldy = C + 8;  // also the leading dimension of the W_out slice
    ldo = C + 4;
    ldw = 2 * NH + 8;
    ldcg = 2 * NH + 8;
    ldact = NH + 8;
    off_y = 0;
    const size_t o = align128(sizeof(bf16) * Pp * ldy);
    off_o = o;
    off_vs = align128(off_o + sizeof(float) * npix * ldo);
    off_ao = align128(off_vs + sizeof(bf16) * 2 * 16 * ldy);
    const size_t end1 =
        staging ? align128(off_ao + sizeof(float) * 16 * ldo) : off_vs;
    off_w = o;
    off_wo = align128(off_w + sizeof(bf16) * C * ldw);
    off_tp = align128(off_wo + sizeof(bf16) * NH * ldy);
    off_cg = align128(off_tp + sizeof(float) * 2 * TAP_ROWS * 2 * NH);
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

// Output fragments (16 x 16) one warp owns in the out product, by tile:
// the smallest instantiated count that holds them, 0 when none does.
// 16 warps leave a thread 128 registers, which 12 fragments overrun.
__host__ __device__ inline int tail_frags(int C, int th, int warps) {
  if (warps != 8 && warps != 16) return 0;
  const int need = (th * (C / 16) + warps - 1) / warps;
  const int have[] = {1, 2, 3, 6, 12};
  for (int nf : have)
    if (need <= nf) return nf == 12 && warps == 16 ? 0 : nf;
  return 0;
}

// The FFN of the tile (`ys` and `oacc` filled) and the bf16 write of the
// output; `img` is the batch image's offset in x and out. Each warp keeps
// its NF output fragments in registers over the whole chunk loop: fragment
// f of a warp is number warp + f * A_WARPS of the (npix / 16) x (C / 16).
// No product reads a weight from device memory: cp.async brings chunk
// j + 1's W_cg slice and table while chunk j's taps and out product run,
// and chunk j's W_out slice while its first product and taps run.
template <int NF, int NW>
static __device__ void gdfn_tail(const ApplyArgs& a, const ApplySmem& L,
                                 const Halo& hl, unsigned char* smem,
                                 size_t img) {
  const bf16* ys = reinterpret_cast<const bf16*>(smem + L.off_y);
  float* oacc = reinterpret_cast<float*>(smem + L.off_o);
  bf16* wcs = reinterpret_cast<bf16*>(smem + L.off_w);
  bf16* wos = reinterpret_cast<bf16*>(smem + L.off_wo);
  float* tps = reinterpret_cast<float*>(smem + L.off_tp);
  float* cg = reinterpret_cast<float*>(smem + L.off_cg);
  bf16* act = reinterpret_cast<bf16*>(smem + L.off_act);
  constexpr int A_THREADS = NW * 32, A_WARPS = NW;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int C = a.C;
  const int ldcgw = 2 * a.hp;
  const int no = C / 16;
  const int nfrag = (L.npix / 16) * no;
  constexpr int TP = TAP_ROWS * 2 * NH;

  // chunk j0's W_cg slice and table, 16 bytes a copy: 8 copies a weight
  // row (4 content, 4 gate), 16 a table row
  auto stage_in = [&](int j0, float* tp) {
    for (int i = tid; i < C * 8; i += A_THREADS) {
      const int k = i >> 3, s = i & 7;
      const int col = (s < 4 ? j0 : a.hp + j0 - NH) + s * 8;
      cp_async16(wcs + k * L.ldw + s * 8, a.wcg + (size_t)k * ldcgw + col,
                 true);
    }
    for (int i = tid; i < TAP_ROWS * 16; i += A_THREADS) {
      const int r = i >> 4, s = i & 15;
      const int col = (s < 8 ? j0 : a.hp + j0 - NH) + s * 4;
      const float* src =
          r < 9 ? a.dwcg + r * ldcgw : (r == 9 ? a.bcg : a.dbcg);
      cp_async16(tp + r * 2 * NH + s * 4, src ? src + col : a.dwcg,
                 src != nullptr);
    }
  };
  // chunk j0's W_out slice: NH contiguous rows of C
  auto stage_out = [&](int j0) {
    const int per_row = C / 8;
    for (int i = tid; i < NH * per_row; i += A_THREADS) {
      const int r = i / per_row, s = i % per_row;
      cp_async16(wos + r * L.ldy + s * 8,
                 a.wo + (size_t)(j0 + r) * C + s * 8, true);
    }
  };

  // out[f][t]: fragment f's columns 8t .. 8t + 7 as mma_16816 lays them out
  float out[NF][2][4];
  // this lane's first element of fragment i in oacc: row lane / 4 (the
  // other two values lie 8 rows down), column 2 (lane % 4)
  auto oacc_at = [&](int i) {
    return oacc + ((i / no) * 16 + lane / 4) * L.ldo + (i % no) * 16 +
           2 * (lane % 4);
  };
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int i = warp + f * A_WARPS;
    if (i >= nfrag) continue;
    const float* o = oacc_at(i);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float2 lo = *reinterpret_cast<const float2*>(o + 8 * t);
      const float2 hi =
          *reinterpret_cast<const float2*>(o + 8 * L.ldo + 8 * t);
      out[f][t][0] = lo.x, out[f][t][1] = lo.y;
      out[f][t][2] = hi.x, out[f][t][3] = hi.y;
    }
  }
  __syncthreads();  // oacc is in registers: its bytes go to the chunk buffers
  stage_in(0, tps);
  cp_async_commit();

  const int nchunk = a.hp / NH;
  for (int j = 0; j < nchunk; ++j) {
    const float* tp = tps + (j & 1) * TP;
    cp_async_wait_group<0>();
    __syncthreads();  // W_cg slice and table of this chunk have landed
    stage_out(j * NH);
    cp_async_commit();
    // cg[Pp x 2NH] = ys @ [W_content chunk | W_gate chunk] (+ the 1x1 bias,
    // and 0 outside the image, which a bias would otherwise fill: ys is 0
    // there). A warp takes 16 pixels x the NH content or NH gate channels.
    for (int u = warp; u < (L.Pp / 16) * 2; u += A_WARPS) {
      const int mi = u >> 1, half = u & 1;
      float acc[NH / 8][4];
#pragma unroll
      for (int t = 0; t < NH / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
      const bf16* arow = ys + mi * 16 * L.ldy;
      const bf16* bcol = wcs + half * NH;
#pragma unroll 2
      for (int k = 0; k < C; k += 16) {
        unsigned fa[4];
        load_a_16x16(fa, arow + k, L.ldy, lane);
#pragma unroll
        for (int t = 0; t < NH / 16; ++t) {
          unsigned fb[4];
          load_b_16x16(fb, bcol + k * L.ldw + t * 16, L.ldw, lane);
          mma_16816(acc[2 * t], fa, fb[0], fb[1]);
          mma_16816(acc[2 * t + 1], fa, fb[2], fb[3]);
        }
      }
      // this lane holds pixels p0 and p0 + 8, columns 8t + 2 (lane % 4), + 1
      const int p0 = mi * 16 + lane / 4;
      bool in0 = true, in1 = true;
      if (a.bcg) {
        in0 = p0 < L.P && hl.inside(hl.r0 - 1 + p0 / L.hcols,
                                    hl.c0 - 1 + p0 % L.hcols);
        in1 = p0 + 8 < L.P && hl.inside(hl.r0 - 1 + (p0 + 8) / L.hcols,
                                        hl.c0 - 1 + (p0 + 8) % L.hcols);
      }
      float* dst = cg + p0 * L.ldcg + half * NH + 2 * (lane % 4);
      const float* bias = tp + 9 * 2 * NH + half * NH + 2 * (lane % 4);
#pragma unroll
      for (int t = 0; t < NH / 8; ++t) {
        const float b0 = bias[8 * t], b1 = bias[8 * t + 1];
        *reinterpret_cast<float2*>(dst + 8 * t) =
            in0 ? make_float2(acc[t][0] + b0, acc[t][1] + b1)
                : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(dst + 8 * L.ldcg + 8 * t) =
            in1 ? make_float2(acc[t][2] + b0, acc[t][3] + b1)
                : make_float2(0.f, 0.f);
      }
    }
    __syncthreads();  // cg is whole, the W_cg slice is free
    if (j + 1 < nchunk) stage_in((j + 1) * NH, tps + ((j + 1) & 1) * TP);
    cp_async_commit();
    {
      // depthwise 3x3 of content and gate, gelu(content) * gate -> bf16.
      // Lane n owns chunk channel n; a warp takes runs of SEG neighbouring
      // output pixels of one row, sliding a 3-column window over the halo
      // rows in registers: 3 (SEG + 2) loads for 9 SEG taps, no test (cg
      // is 0 outside the image). Each sum runs kh, then kw.
      constexpr int SEG = 4;
      const int n = lane;
      float wc[9], wg[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        wc[k] = tp[k * 2 * NH + n];
        wg[k] = tp[k * 2 * NH + NH + n];
      }
      const float dbc = tp[10 * 2 * NH + n], dbg = tp[10 * 2 * NH + NH + n];
      for (int run = warp; run < L.npix / SEG; run += A_WARPS) {
        const int orow = run / (TILE_W / SEG);
        const int oc0 = run % (TILE_W / SEG) * SEG;
        float ac[SEG], ag[SEG];
#pragma unroll
        for (int r = 0; r < SEG; ++r) ac[r] = dbc, ag[r] = dbg;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const float* rp = cg + ((orow + kh) * L.hcols + oc0) * L.ldcg + n;
          float vc[SEG + 2], vg[SEG + 2];
#pragma unroll
          for (int i = 0; i < SEG + 2; ++i) {
            vc[i] = rp[i * L.ldcg];
            vg[i] = rp[i * L.ldcg + NH];
          }
#pragma unroll
          for (int r = 0; r < SEG; ++r)
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              ac[r] += vc[r + kw] * wc[kh * 3 + kw];
              ag[r] += vg[r + kw] * wg[kh * 3 + kw];
            }
        }
        const int gr = hl.r0 + orow;
#pragma unroll
        for (int r = 0; r < SEG; ++r) {
          const float gel =
              0.5f * ac[r] * (1.f + erff(ac[r] * 0.70710678118654752f));
          act[(orow * TILE_W + oc0 + r) * L.ldact + n] =
              f2bf(hl.inside(gr, hl.c0 + oc0 + r) ? gel * ag[r] : 0.f);
        }
      }
    }
    cp_async_wait_group<1>();  // this chunk's W_out; the next W_cg may fly
    __syncthreads();           // act is whole, the W_out slice has landed
    // out[npix x C] += act[npix x NH] @ W_out[j0 : j0 + NH, :]
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int i = warp + f * A_WARPS;
      if (i >= nfrag) continue;
      const int mi = i / no, ni = i % no;
#pragma unroll
      for (int k = 0; k < NH; k += 16) {
        unsigned fa[4], fb[4];
        load_a_16x16(fa, act + mi * 16 * L.ldact + k, L.ldact, lane);
        load_b_16x16(fb, wos + k * L.ldy + ni * 16, L.ldy, lane);
        mma_16816(out[f][0], fa, fb[0], fb[1]);
        mma_16816(out[f][1], fa, fb[2], fb[3]);
      }
    }
  }
  __syncthreads();  // the chunk buffers are done with: oacc takes its bytes
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int i = warp + f * A_WARPS;
    if (i >= nfrag) continue;
    float* o = oacc_at(i);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      *reinterpret_cast<float2*>(o + 8 * t) =
          make_float2(out[f][t][0], out[f][t][1]);
      *reinterpret_cast<float2*>(o + 8 * L.ldo + 8 * t) =
          make_float2(out[f][t][2], out[f][t][3]);
    }
  }
  __syncthreads();

  // bf16 write, 4 channels (8 bytes) a thread
  const int c4n = C / 4;
  for (int i = tid; i < L.npix * c4n; i += A_THREADS) {
    const int q = i / c4n, c = i % c4n * 4;
    const int gr = hl.r0 + q / TILE_W, gc = hl.c0 + q % TILE_W;
    if (!hl.inside(gr, gc)) continue;
    const float4 v = *reinterpret_cast<const float4*>(oacc + q * L.ldo + c);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 packed;
    packed.x = *reinterpret_cast<const unsigned*>(&lo);
    packed.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(a.out + img + ((size_t)gr * a.W + gc) * C + c) =
        packed;
  }
}

// Calls `launch.run<NF, NW>()` with the tile's fragment count and the
// block's warps.
template <typename Launch>
static cudaError_t dispatch_tail(int C, int th, int warps,
                                 const Launch& launch) {
  const int nf = tail_frags(C, th, warps);
  if (warps == 8) switch (nf) {
      case 1: return launch.template run<1, 8>();
      case 2: return launch.template run<2, 8>();
      case 3: return launch.template run<3, 8>();
      case 6: return launch.template run<6, 8>();
      case 12: return launch.template run<12, 8>();
    }
  if (warps == 16) switch (nf) {
      case 1: return launch.template run<1, 16>();
      case 2: return launch.template run<2, 16>();
      case 3: return launch.template run<3, 16>();
      case 6: return launch.template run<6, 16>();
    }
  return cudaErrorInvalidValue;
}

}  // namespace irk
