// The attention core of the three-kernel Restormer block, on the qkv map of
// ln_qkv_dwconv.cu: (B, H, W, 3C) bf16, channels [q | k | v], head-major.
//
// Replaces the TPU kernels image_restoration_tpu/kernels/attn_core_pallas.py
// `_acc_kernel` (:41, pass A, K5) and `_apply_kernel` (:67, pass B, K6),
// behind `fused_mdta_core`; the finalize between them stays plain torch
// (kernels/attn_core.py `finalize_at`).
//
// What they compute. K5: the per-head q^T k (fp32) and the per-channel sums
// of squares of the bf16 q and k widened to fp32, over all H*W pixels; only
// the per-head diagonal (ch x ch) blocks, all that the finalize reads (the
// TPU's full C x C product is an artefact of its 128-lane layout). K6:
// out = bf16(x + (bf16(v @ A^T) @ W_proj + b_proj)), A^T applied per head
// with fp32 accumulation and t rounded to bf16 before the second product, as
// the TPU kernel rounds it; A^T is not folded into W_proj (that is the
// whole-block pair's rounding, not this kernel's).
//
// What bounds them on this card: bytes. K5 reads q and k once (4 bytes a
// channel and pixel), K6 reads v and x and writes out (6 bytes); their
// products are ch and ch + C multiply-adds a channel and pixel, so at
// Restormer-base's widths the tensor cores need a tenth of the bytes' time
// or less. 512x512 x 96 (one head) carries half of both bounds.
//
// K6, attn_apply_kernel<CH, WCOL>: persistent blocks, about as many as the
// card holds at once, each owning `ncol` output columns (a column group:
// C / groups) and walking pixel tiles of P pixels with a stride.
// - Weights staged once a block: A^T of every head (bf16, cp.async) and the
//   block's W_proj rows, read from their own (out, in) fp32 layout and
//   rounded to bf16 as they are staged (the bits the old wrapper's cast
//   gave), four chunks' loads a thread in flight; the wrapper packs
//   nothing. At C = 384 W_proj (288 KB in bf16) does not fit. Streaming it
//   in k-slabs would restage 576 KB of fp32 from L2 a tile, through
//   registers (cp.async cannot convert), so instead the output columns are
//   split over 4 blocks of 96 columns (75 KB staged once), each of which
//   recomputes t for its tiles: product 1 is ch / C of product 2's work.
// - The next tile's v and x slice are loaded with cp.async while the
//   current tile's products run (two buffers of each).
// - Both products on mma.sync m16n8k16 + ldmatrix from shared memory. A
//   warp's job is a 16-pixel strip times WCOL output columns; per head and
//   16 channels of t it runs product 1 (v_h A_h^T, fp32), rounds the two
//   n8 C fragments to bf16 in registers, which are product 2's A fragment
//   for that k16 step as they lie, and adds t_h W_proj[h ch:..] into the
//   output fragments. t never touches shared memory; a warp holds WCOL / 2
//   output floats and 8 of t. Where a strip's columns are split over warps
//   (WCOL < ncol), each recomputes the strip's t.
// - The epilogue adds b_proj (staged) and x (from the staged tile) to the
//   fragments in registers, rounds, writes out over x in shared memory, and
//   the block stores the tile with 16-byte writes.
//
// K5, attn_acc_kernel<CH>: one head a block, heads x tile strides blocks,
// as many as the card holds at once. A block stages q and k of its head for
// a tile of P pixels by cp.async one or two tiles ahead (a ring of 2 or 3
// slots, one barrier a tile). Each warp owns MR x (CH / 16) 16x16 Gram
// tiles (MR rows of them) and a 1 / KG share of the tile's pixel rows; it
// keeps its fragments in registers over the whole walk (mma.sync, q^T by
// ldmatrix.trans). Every thread sums the squares of 8 channels (16-byte
// loads from the staged tile) over its share of the rows, in registers. At
// the end the KG partial Grams are summed in a fixed order through shared
// memory, and so are the squares; one partial a (batch, stride index) goes
// to device memory, and attn_reduce_kernel sums the partials in a fixed
// order with 8 warps a 32 entries, so two runs give the same bits.
//
// Measured (chip_smoke.py phase 2d and --attn, NVIDIA H100 80GB HBM3,
// 700 W; PERF.md section 6): per Restormer-base forward K6 5.55 -> 1.72 ms
// (39% of its bound), K5 2.48 -> 1.38 ms (33%). Skip builds of the old
// kernels ranked K6's scalar epilogue and its products (B from L1/L2)
// first, K5's Gram with its shared-memory round trips, then its loads. At
// the 512^2 maps both now run at 35-58% of their bound; at the deep maps
// (128^2 x 192, 64^2 x 384) at 9-21%, where a block's fixed cost (K6's
// W_proj staging, K5's partial) and the launch are most of the time.
// Still open: mma.sync, not wgmma; no TMA; K6 at one head of 96 recomputes
// t in both column warps of a strip; K5's second launch (the reduction).
#include "common.cuh"

namespace irk {

// ---------------------------------------------------------------- pass B

// 16 (n) x 16 (k) bf16 tile stored n-major (row n holds k contiguously, as
// W_proj's (out, in) layout) as two B operands of mma_16816: b[0..1] for
// n 0-7, b[2..3] for n 8-15.
__device__ __forceinline__ void load_bt_16x16(unsigned (&b)[4],
                                              const bf16* tile, int ld,
                                              int lane) {
  ldmatrix_x4(b, tile + ((lane / 16) * 8 + lane % 8) * ld +
                     (lane / 8) % 2 * 8);
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

struct ApplyArgs {
  const bf16* qkv;
  const bf16* x;
  const bf16* at;   // (B, heads, ch, ch): A^T per head, [k][j]
  const float* wp;  // (C, C): W_proj as (out, in), fp32
  const float* bp;  // (C) or null
  bf16* out;
  int HW, C, heads, P, groups, tiles;
};

// Shared memory of one pass-B block: W_proj's ncol rows and A^T (bf16,
// rows padded by 16 bytes so that ldmatrix's eight rows hit distinct
// banks), the bias, two v tiles and two x-slice tiles.
struct ApplySmem {
  int ldw, lda, ldv, ldx;
  size_t off_w, off_a, off_b, off_v, off_x, vbytes, xbytes, total;
  __host__ __device__ ApplySmem(int C, int heads, int P, int ncol) {
    const int ch = C / heads;
    ldw = C + 8;
    lda = ch + 8;
    ldv = C + 8;
    ldx = ncol + 8;
    vbytes = align128(sizeof(bf16) * P * ldv);
    xbytes = align128(sizeof(bf16) * P * ldx);
    size_t o = 0;
    off_w = o; o = align128(o + sizeof(bf16) * ncol * ldw);
    off_a = o; o = align128(o + sizeof(bf16) * heads * ch * lda);
    off_b = o; o = align128(o + sizeof(float) * ncol);
    off_v = o; o += 2 * vbytes;
    off_x = o; o += 2 * xbytes;
    total = o;
  }
};

template <int CH, int WCOL>
__global__ void __launch_bounds__(256, 2)
    attn_apply_kernel(const ApplyArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, C3 = 3 * C, ncol = C / a.groups;
  const ApplySmem L(C, a.heads, a.P, ncol);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.off_w);
  bf16* as = reinterpret_cast<bf16*>(smem + L.off_a);
  float* bs = reinterpret_cast<float*>(smem + L.off_b);

  const int nt = blockDim.x, nw = nt / 32, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y, grp = blockIdx.x % a.groups;
  const int S = gridDim.x / a.groups, n0 = grp * ncol;
  const size_t pix0 = (size_t)b * a.HW;
  const bf16* vb = a.qkv + pix0 * C3 + 2 * C;
  const bf16* xb = a.x + pix0 * C + n0;
  bf16* ob = a.out + pix0 * C + n0;
  const int nv = C / 8, nx = ncol / 8;

  // v (all C) and x (this block's columns) of tile t's pixels into buffer
  // `buf`; pixels past the image become zeros and are not stored
  auto load_tile = [&](int t, int buf) {
    bf16* vs = reinterpret_cast<bf16*>(smem + L.off_v + buf * L.vbytes);
    bf16* xs = reinterpret_cast<bf16*>(smem + L.off_x + buf * L.xbytes);
    const int p0 = t * a.P;
    for (int i = tid; i < a.P * nv; i += nt) {
      const int r = i / nv, c8 = i - r * nv, pix = p0 + r;
      const bool valid = pix < a.HW;
      cp_async16(vs + r * L.ldv + c8 * 8,
                 vb + (size_t)(valid ? pix : 0) * C3 + c8 * 8, valid);
    }
    for (int i = tid; i < a.P * nx; i += nt) {
      const int r = i / nx, c8 = i - r * nx, pix = p0 + r;
      const bool valid = pix < a.HW;
      cp_async16(xs + r * L.ldx + c8 * 8,
                 xb + (size_t)(valid ? pix : 0) * C + c8 * 8, valid);
    }
  };

  int t = blockIdx.x / a.groups;
  if (t < a.tiles) load_tile(t, 0);
  // A^T of every head of this image
  const bf16* atb = a.at + (size_t)b * a.heads * CH * CH;
  for (int i = tid; i < a.heads * CH * (CH / 8); i += nt) {
    const int r = i / (CH / 8), c8 = i % (CH / 8);
    cp_async16(as + r * L.lda + c8 * 8, atb + (size_t)r * CH + c8 * 8, true);
  }
  cp_async_commit();
  // W_proj rows n0.. n0 + ncol, rounded to bf16 as they are staged; four
  // chunks' loads a thread in flight at once (each block stages up to 147
  // KB of fp32 from L2 before its first product)
  for (int i0 = tid; i0 < ncol * nv; i0 += 4 * nt) {
    float4 w8[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nt, r = i / nv, c8 = i - r * nv;
      if (i < ncol * nv) {
        const float4* src = reinterpret_cast<const float4*>(
            a.wp + (size_t)(n0 + r) * C + c8 * 8);
        w8[u][0] = __ldg(src);
        w8[u][1] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nt, r = i / nv, c8 = i - r * nv;
      if (i < ncol * nv) {
        const float y[8] = {w8[u][0].x, w8[u][0].y, w8[u][0].z, w8[u][0].w,
                            w8[u][1].x, w8[u][1].y, w8[u][1].z, w8[u][1].w};
        *reinterpret_cast<uint4*>(ws + r * L.ldw + c8 * 8) = pack8(y);
      }
    }
  }
  for (int i = tid; i < ncol; i += nt) bs[i] = a.bp ? a.bp[n0 + i] : 0.f;

  const int wgn = ncol / WCOL, jobs = (a.P / 16) * wgn;
  const int g = lane / 4, q = lane % 4;
  for (int buf = 0; t < a.tiles; t += S, buf ^= 1) {
    cp_async_wait_group<0>();
    __syncthreads();  // tile t and the weights have landed; the last tile's
                      // store is done with the other buffer
    if (t + S < a.tiles) load_tile(t + S, buf ^ 1);
    cp_async_commit();
    const bf16* vs =
        reinterpret_cast<const bf16*>(smem + L.off_v + buf * L.vbytes);
    bf16* xs = reinterpret_cast<bf16*>(smem + L.off_x + buf * L.xbytes);

    for (int j = warp; j < jobs; j += nw) {
      const int strip = j / wgn, c0 = (j - strip * wgn) * WCOL;
      float acc[WCOL / 8][4];
#pragma unroll
      for (int n = 0; n < WCOL / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      const bf16* vrow = vs + strip * 16 * L.ldv;
      const bf16* wrow = ws + c0 * L.ldw;
#pragma unroll 1
      for (int h = 0; h < a.heads; ++h) {
        unsigned va[CH / 16][4];
#pragma unroll
        for (int kk = 0; kk < CH / 16; ++kk)
          load_a_16x16(va[kk], vrow + h * CH + kk * 16, L.ldv, lane);
        const bf16* ah = as + h * CH * L.lda;
#pragma unroll
        for (int s = 0; s < CH / 16; ++s) {
          // t[:, h ch + 16 s ..+16] = v_h A_h^T[:, 16 s ..], fp32
          float tf[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < CH / 16; ++kk) {
            unsigned fb[4];
            load_b_16x16(fb, ah + kk * 16 * L.lda + s * 16, L.lda, lane);
            mma_16816(tf[0], va[kk], fb[0], fb[1]);
            mma_16816(tf[1], va[kk], fb[2], fb[3]);
          }
          // bf16(t) as the A fragment of product 2's k16 step
          const unsigned ta[4] = {pack2(tf[0][0], tf[0][1]),
                                  pack2(tf[0][2], tf[0][3]),
                                  pack2(tf[1][0], tf[1][1]),
                                  pack2(tf[1][2], tf[1][3])};
#pragma unroll
          for (int np = 0; np < WCOL / 16; ++np) {
            unsigned fb[4];
            load_bt_16x16(fb, wrow + np * 16 * L.ldw + h * CH + s * 16,
                          L.ldw, lane);
            mma_16816(acc[2 * np], ta, fb[0], fb[1]);
            mma_16816(acc[2 * np + 1], ta, fb[2], fb[3]);
          }
        }
      }
      // out = bf16(x + (o + b)), written over x in the staged tile
#pragma unroll
      for (int n = 0; n < WCOL / 8; ++n) {
        const int col = c0 + n * 8 + 2 * q;
        const float b0 = bs[col], b1 = bs[col + 1];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(
              xs + (strip * 16 + g + 8 * hr) * L.ldx + col);
          const float2 xf = __bfloat1622float2(*px);
          *px = __floats2bfloat162_rn(xf.x + (acc[n][2 * hr] + b0),
                                      xf.y + (acc[n][2 * hr + 1] + b1));
        }
      }
    }
    __syncthreads();  // the tile's out is whole
    const int p0 = t * a.P;
    for (int i = tid; i < a.P * nx; i += nt) {
      const int r = i / nx, c8 = i - r * nx, pix = p0 + r;
      if (pix < a.HW)
        *reinterpret_cast<uint4*>(ob + (size_t)pix * C + c8 * 8) =
            *reinterpret_cast<const uint4*>(xs + r * L.ldx + c8 * 8);
    }
  }
}

// ---------------------------------------------------------------- pass A

// Rows of 16x16 Gram tiles a K5 warp owns (all CH / 16 columns of them):
// at most 72 fp32 accumulators a thread.
__host__ __device__ constexpr int acc_rows(int ch) {
  return ch == 48 ? 3 : (ch == 32 || ch == 64) ? 2 : 1;
}

// A pass-A block's warps: (ch / 16) / acc_rows(ch) unit groups (the warps
// that cover one head's Gram) times kg pixel shares, kg as many as 8 warps
// allow (at least 1) that split the tile's P / 16 row blocks evenly.
__host__ __device__ inline int acc_groups(int ch) {
  return ch / 16 / acc_rows(ch);
}
__host__ __device__ inline int acc_kg(int ch, int P) {
  int k = 8 / acc_groups(ch);
  k = k < P / 16 ? k : P / 16;
  if (k < 1) return 1;
  while ((P / 16) % k) --k;
  return k;
}
__host__ __device__ inline int acc_threads(int ch, int P) {
  return 32 * acc_groups(ch) * acc_kg(ch, P);
}

struct AccArgs {
  const bf16* qkv;
  float* gram_part;  // (B, S, heads * ch * ch)
  float* ss_part;    // (B, S, 2 C)
  int HW, C, heads, P, kg, ring, tiles;
};

// Shared memory of one pass-A block: `ring` (2 or 3) slots of a tile's q
// and k of its head ([pixel][q | k], rows padded by 16 bytes); after the
// walk the same bytes hold the Gram and the sums of squares being reduced.
struct AccSmem {
  int ldq;
  size_t slot, red_ss, total;
  __host__ __device__ AccSmem(int ch, int P, int nt, int ring) {
    ldq = 2 * ch + 8;
    slot = align128(sizeof(bf16) * P * ldq);
    red_ss = align128(sizeof(float) * ch * ch);
    const size_t red = red_ss + sizeof(float) * nt * 8;
    total = ring * slot > red ? ring * slot : red;
  }
};

template <int CH>
__global__ void __launch_bounds__(256, 2) attn_acc_kernel(const AccArgs a) {
  constexpr int MR = acc_rows(CH), NC = CH / 16, UG = NC / MR, NQ = CH / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const AccSmem L(CH, a.P, nt, a.ring);
  const int C = a.C, C3 = 3 * C;
  const int b = blockIdx.y, head = blockIdx.x % a.heads;
  const int S = gridDim.x / a.heads;
  const int warp = tid / 32, lane = tid % 32;
  const int mi0 = (warp % UG) * MR, kgi = warp / UG;
  const int rows = a.P / a.kg, r0 = kgi * rows;
  const bf16* img = a.qkv + (size_t)b * a.HW * C3 + head * CH;

  // q and k of this head for tile t's pixels into `slot`; pixels past the
  // image become zeros and add nothing
  auto load_tile = [&](int t, int slot) {
    bf16* qs = reinterpret_cast<bf16*>(smem + slot * L.slot);
    const int p0 = t * a.P;
    for (int i = tid; i < a.P * 2 * NQ; i += nt) {
      const int r = i / (2 * NQ), c8 = i % (2 * NQ), pix = p0 + r;
      const bool valid = pix < a.HW;
      const int src = c8 < NQ ? c8 * 8 : C + (c8 - NQ) * 8;
      cp_async16(qs + r * L.ldq + c8 * 8,
                 img + (size_t)(valid ? pix : 0) * C3 + src, valid);
    }
  };

  float gf[MR][NC][2][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 8; ++e) gf[m][n][e / 4][e % 4] = 0.f;
  // sums of squares: thread -> 8 channels (chunk sc8 of [q | k]) and the
  // rows rg, rg + RG, ... of each tile
  const int RG = nt / (2 * NQ), sc8 = tid % (2 * NQ), rg = tid / (2 * NQ);
  float ssr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  int t = blockIdx.x / a.heads;
  if (t < a.tiles) load_tile(t, 0);
  cp_async_commit();
  if (a.ring == 3) {
    if (t + S < a.tiles) load_tile(t + S, 1);
    cp_async_commit();
  }
  for (int slot = 0; t < a.tiles;
       t += S, slot = slot + 1 == a.ring ? 0 : slot + 1) {
    if (a.ring == 3)
      cp_async_wait_group<1>();
    else
      cp_async_wait_group<0>();
    __syncthreads();  // tile t has landed; the last tile is done with its
                      // slot
    const int ahead = t + (a.ring - 1) * S;
    if (ahead < a.tiles)
      load_tile(ahead, slot == 0 ? a.ring - 1 : slot - 1);
    cp_async_commit();
    const bf16* qs = reinterpret_cast<const bf16*>(smem + slot * L.slot);
    const bf16* qa = qs + mi0 * 16;
    const bf16* kb = qs + CH;
    for (int r = r0; r < r0 + rows; r += 16) {
      unsigned fa[MR][4];
#pragma unroll
      for (int m = 0; m < MR; ++m)
        load_at_16x16(fa[m], qa + r * L.ldq + m * 16, L.ldq, lane);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        unsigned fb[4];
        load_b_16x16(fb, kb + r * L.ldq + n * 16, L.ldq, lane);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          mma_16816(gf[m][n][0], fa[m], fb[0], fb[1]);
          mma_16816(gf[m][n][1], fa[m], fb[2], fb[3]);
        }
      }
    }
    if (rg < RG)
      for (int r = rg; r < a.P; r += RG) {
        float v[8];
        unpack8(*reinterpret_cast<const uint4*>(qs + r * L.ldq + sc8 * 8), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) ssr[e] += v[e] * v[e];
      }
  }
  cp_async_wait_group<0>();
  __syncthreads();  // the slots are free: they hold the reduction now
  float* red = reinterpret_cast<float*>(smem);
  float* rss = reinterpret_cast<float*>(smem + L.red_ss);
  // the kg pixel shares' Grams, summed in share order
  for (int k = 0; k < a.kg; ++k) {
    if (kgi == k) {
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              // this lane: row lane / 4 (+ 8), columns 2 (lane % 4), + 1
              float2* o = reinterpret_cast<float2*>(
                  red + ((mi0 + m) * 16 + lane / 4 + 8 * hr) * CH + n * 16 +
                  8 * s + 2 * (lane % 4));
              const float2 v = make_float2(gf[m][n][s][2 * hr],
                                           gf[m][n][s][2 * hr + 1]);
              if (k == 0) {
                *o = v;
              } else {
                const float2 u = *o;
                *o = make_float2(u.x + v.x, u.y + v.y);
              }
            }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) rss[tid * 8 + e] = ssr[e];
  __syncthreads();
  const size_t part = (size_t)b * S + blockIdx.x / a.heads;
  float* gp = a.gram_part + (part * a.heads + head) * CH * CH;
  for (int i = tid; i < CH * CH; i += nt) gp[i] = red[i];
  for (int j = tid; j < 2 * CH; j += nt) {
    // channel j of [q | k]: lane j % 8 of chunk j / 8, row groups in order
    float s = 0.f;
    for (int r = 0; r < RG; ++r) s += rss[(r * 2 * NQ + j / 8) * 8 + j % 8];
    a.ss_part[part * 2 * C + (j / CH) * C + head * CH + j % CH] = s;
  }
}

// Sums the G partials of each batch, gram_part (B, G, ng) into gram and
// ss_part (B, G, nss) into ss, in a fixed order: blocks of 8 warps take 32
// entries, warp w adds partials w, w + 8, ... and the eight warp sums are
// added in warp order. K1's front_reduce_kernel gives one thread a whole
// entry, which leaves K5's hundreds of partials to a few SMs.
__global__ void __launch_bounds__(256)
    attn_reduce_kernel(const float* __restrict__ gram_part,
                       const float* __restrict__ ss_part, float* gram,
                       float* ss, int G, int ng, int nss) {
  __shared__ float red[8][32];
  const int b = blockIdx.y, lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int gblocks = (ng + 31) / 32;
  const bool is_gram = blockIdx.x < gblocks;
  const int n = is_gram ? ng : nss;
  const int i = (is_gram ? blockIdx.x : blockIdx.x - gblocks) * 32 + lane;
  const float* part = (is_gram ? gram_part : ss_part) + (size_t)b * G * n + i;
  float s = 0.f;
  if (i < n)
    for (int g = w; g < G; g += 8) s += part[(size_t)g * n];
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][lane];
    (is_gram ? gram : ss)[(size_t)b * n + i] = t;
  }
}

// ---------------------------------------------------------------- launch

// Calls `f.template run<CH, ...>()` for a head width the kernels are built
// for.
template <typename F>
static cudaError_t dispatch_ch(int ch, const F& f) {
  switch (ch) {
    case 16: return f.template run<16>();
    case 32: return f.template run<32>();
    case 48: return f.template run<48>();
    case 64: return f.template run<64>();
    case 96: return f.template run<96>();
    case 128: return f.template run<128>();
  }
  return cudaErrorInvalidValue;
}

static bool attn_takes(int C, int heads) {
  return heads > 0 && C % 16 == 0 && C % heads == 0 && (C / heads) % 16 == 0;
}

// Pass B's configuration: P pixels a tile, `warps` a block, WCOL output
// columns a warp job, `groups` column groups (blocks) a tile.
static bool apply_takes(int C, int heads, int P, int warps, int wcol,
                        int groups) {
  if (!attn_takes(C, heads) || P <= 0 || P % 16 || groups <= 0 ||
      C % groups || warps < 1 || warps > 8)
    return false;
  const int ncol = C / groups;
  return ncol % wcol == 0 && (wcol == 16 || wcol == 48 || wcol == 96);
}

struct LaunchApply {
  ApplyArgs a;
  int wcol;
  dim3 grid;
  int threads;
  size_t smem;
  cudaStream_t stream;
  int* blocks;
  template <int CH, int WCOL>
  cudaError_t go() const {
    const auto kernel = attn_apply_kernel<CH, WCOL>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    if (blocks)
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                           threads, smem);
    kernel<<<grid, threads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  template <int CH>
  cudaError_t run() const {
    if (wcol == 16) return go<CH, 16>();
    if constexpr (CH == 48 || CH == 96) {
      if (wcol == 48) return go<CH, 48>();
      if (wcol == 96) return go<CH, 96>();
    }
    return cudaErrorInvalidValue;
  }
};

struct LaunchAcc {
  AccArgs a;
  dim3 grid;
  int threads;
  size_t smem;
  cudaStream_t stream;
  int* blocks;
  template <int CH>
  cudaError_t run() const {
    const auto kernel = attn_acc_kernel<CH>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    if (blocks)
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                           threads, smem);
    kernel<<<grid, threads, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

// Pass A's configuration: P pixels a tile, `ring` tile slots (loads
// ring - 1 tiles ahead).
static bool acc_takes(int C, int heads, int P, int ring) {
  if (!attn_takes(C, heads) || P <= 0 || P % 16 || (ring != 2 && ring != 3))
    return false;
  const int ch = C / heads, nt = acc_threads(ch, P);
  return nt <= 256 && 2 * ch / 8 <= nt;
}

}  // namespace irk

extern "C" {

// Dynamic shared memory of one pass-A block; above the card's limit where
// the configuration is not built.
int ir_attn_acc_smem(int C, int heads, int P, int ring) {
  using namespace irk;
  if (!acc_takes(C, heads, P, ring)) return SMEM_LIMIT + 1;
  return static_cast<int>(AccSmem(C / heads, P, acc_threads(C / heads, P),
                                  ring).total);
}

// Pass-A blocks one SM holds at once (0 if none).
int ir_attn_acc_blocks(int C, int heads, int P, int ring) {
  using namespace irk;
  if (!acc_takes(C, heads, P, ring)) return 0;
  const int nt = acc_threads(C / heads, P);
  const AccSmem L(C / heads, P, nt, ring);
  if (L.total > static_cast<size_t>(SMEM_LIMIT)) return 0;
  int blocks = 0;
  if (dispatch_ch(C / heads, LaunchAcc{AccArgs{}, dim3(1), nt, L.total,
                                       nullptr, &blocks}) != cudaSuccess)
    return 0;
  return blocks;
}

// Launches pass A and the fixed-order reduction on `stream`: `grid_x`
// blocks per batch image (heads x S, one head a block) walk the P-pixel
// tiles with stride S; the partial buffers hold B * S entries. gram is
// (B, heads, ch, ch), ss (B, 2, C). Returns cudaGetLastError().
int ir_attn_acc(const void* qkv, void* gram_part, void* ss_part, void* gram,
                void* ss, int B, int HW, int C, int heads, int P, int ring,
                int grid_x, void* stream) {
  using namespace irk;
  if (!acc_takes(C, heads, P, ring) || grid_x % heads)
    return cudaErrorInvalidValue;
  const int ch = C / heads, nt = acc_threads(ch, P);
  const AccSmem L(ch, P, nt, ring);
  if (L.total > static_cast<size_t>(SMEM_LIMIT)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AccArgs a{static_cast<const bf16*>(qkv),
                  static_cast<float*>(gram_part),
                  static_cast<float*>(ss_part), HW, C, heads, P,
                  acc_kg(ch, P), ring, (HW + P - 1) / P};
  cudaError_t e = dispatch_ch(
      ch, LaunchAcc{a, dim3(grid_x, B), nt, L.total, s, nullptr});
  if (e != cudaSuccess) return e;
  const int ng = heads * ch * ch;
  attn_reduce_kernel<<<dim3((ng + 31) / 32 + (2 * C + 31) / 32, B), 256, 0,
                       s>>>(
      static_cast<const float*>(gram_part), static_cast<const float*>(ss_part),
      static_cast<float*>(gram), static_cast<float*>(ss), grid_x / heads, ng,
      2 * C);
  return cudaGetLastError();
}

// Dynamic shared memory of one pass-B block; above the card's limit where
// the configuration is not built.
int ir_attn_apply_smem(int C, int heads, int P, int warps, int wcol,
                       int groups) {
  using namespace irk;
  if (!apply_takes(C, heads, P, warps, wcol, groups)) return SMEM_LIMIT + 1;
  return static_cast<int>(ApplySmem(C, heads, P, C / groups).total);
}

// Pass-B blocks one SM holds at once (0 if none).
int ir_attn_apply_blocks(int C, int heads, int P, int warps, int wcol,
                         int groups) {
  using namespace irk;
  if (!apply_takes(C, heads, P, warps, wcol, groups)) return 0;
  const ApplySmem L(C, heads, P, C / groups);
  if (L.total > static_cast<size_t>(SMEM_LIMIT)) return 0;
  int blocks = 0;
  if (dispatch_ch(C / heads, LaunchApply{ApplyArgs{}, wcol, dim3(1),
                                         32 * warps, L.total, nullptr,
                                         &blocks}) != cudaSuccess)
    return 0;
  return blocks;
}

// Launches pass B on `stream`: `grid_x` blocks per batch image (a multiple
// of `groups`) walk the P-pixel tiles. at is (B, heads, ch, ch) = A^T per
// head, bf16; wp (C, C) = W_proj as (out, in), fp32; bp (C) fp32 or null.
// Returns cudaGetLastError().
int ir_attn_apply(const void* qkv, const void* x, const void* at,
                  const void* wp, const void* bp, void* out, int B, int HW,
                  int C, int heads, int P, int warps, int wcol, int groups,
                  int grid_x, void* stream) {
  using namespace irk;
  if (!apply_takes(C, heads, P, warps, wcol, groups) || grid_x % groups)
    return cudaErrorInvalidValue;
  const ApplySmem L(C, heads, P, C / groups);
  if (L.total > static_cast<size_t>(SMEM_LIMIT)) return cudaErrorInvalidValue;
  const ApplyArgs a{static_cast<const bf16*>(qkv),
                    static_cast<const bf16*>(x),
                    static_cast<const bf16*>(at),
                    static_cast<const float*>(wp),
                    static_cast<const float*>(bp),
                    static_cast<bf16*>(out),
                    HW, C, heads, P, groups, (HW + P - 1) / P};
  return dispatch_ch(C / heads,
                     LaunchApply{a, wcol, dim3(grid_x, B), 32 * warps,
                                 L.total, static_cast<cudaStream_t>(stream),
                                 nullptr});
}

}  // extern "C"
