// Device code shared by the kernels that open a Restormer block: pass 1 of
// the whole-block pair (block_front.cu, K1) and the LN + qkv 1x1 + 3x3
// depthwise kernel of the three-kernel block (ln_qkv_dwconv.cu, K4); the
// attention accumulation (attn_core.cu, K5) shares front_reduce_kernel.
//
// For a th x 16 output tile with a one-pixel halo, front_run computes
//   y    = bf16(LN1(x))                 (fp32 statistics over the real C)
//   proj = y @ W_qkv + b_qkv             (fp32; 0 outside the image)
//   acc  = db + sum_taps proj * w_tap    (3x3 depthwise, fp32)
// in chunks of nc = 48 (32 or 16 where C needs it) of the 3C projected
// channels. K4 writes every chunk to device memory as bf16. K1 writes v so
// and keeps q and k of every head of the tile in shared memory as bf16,
// with the sums of squares of their fp32 values; one Gram pass per tile
// then adds each head's q^T k to accumulators the warps hold in registers
// over all of the block's tiles. Each block writes one partial;
// front_reduce_kernel sums the partials in a fixed order.
//
// What the design does on an H100 (PERF.md has the times):
// * cp.async stages the x tile, then LN1 runs in place, 8 lanes a pixel;
// * the qkv product runs on mma.sync fed by ldmatrix, a warp's A fragment
//   serving all nc columns; no product reads a weight from device memory:
//   cp.async brings chunk j + 1's W_qkv slice and its table of taps and
//   biases while chunk j's product and taps run (two buffers);
// * the product adds the 1x1 bias and zeroes the pixels outside the image
//   in registers as it stores proj, so the taps run without a test, in row
//   segments of F_SEG pixels x 4 channels (a sliding 3-column window, 16-byte
//   loads), and write 8 bytes a store;
// * the Gram runs on mma.sync (q^T by ldmatrix.trans), its accumulators in
//   registers; no atomics, so two runs give the same bits.
// Two barriers a chunk. Where the time goes (scratch builds that skip one
// stage; PERF.md): the product first, then the taps and writes, then LN;
// the staging, the x load and K1's Gram far behind. Still open: the halo
// is recomputed ((th + 2) x 18 pixels for th x 16 outputs: 2.5x at 64x64 x
// 384, where a tile's 5 row blocks leave 3 of 8 warps idle in the product
// and the 128 tiles give each SM one block); the product of chunk j + 1
// does not overlap the taps of chunk j (a second proj does not fit beside
// K1's buffers at every width); the products are mma.sync, not wgmma.
#pragma once

#include "common.cuh"

namespace irk {

// Output pixels of a depthwise work item (one row segment).
constexpr int F_SEG = 4;
// Rows of a chunk's fp32 table: the 9 depthwise taps, the 1x1 bias and the
// depthwise bias (zeros where the conv has none).
constexpr int TAP_ROWS_F = 11;

__host__ __device__ inline int front_chunk(int C) {
  return C % 48 == 0 ? 48 : (C % 32 == 0 ? 32 : 16);
}

// Shared memory of a front kernel: the LN'd halo tile `ys`, two buffers of
// a chunk's W_qkv slice and two of its table, the fp32 projected chunk
// `proj`; with `gram` (K1) also q and k of every head of the tile (bf16),
// the per-run partial sums of squares of a chunk and the block's sums.
struct FrontSmem {
  int hcols, P, Pp, npix, nc, ldy, ldw, ldp, ldq;
  size_t off_y, off_w, off_tp, off_p, off_q, off_k, off_red, off_ss, total;
  __host__ __device__ FrontSmem(int C, int th, bool gram) {
    nc = front_chunk(C);
    hcols = TILE_W + 2;
    P = (th + 2) * hcols;
    Pp = round16(P);
    npix = th * TILE_W;
    ldy = C + 8;
    ldw = nc + 8;
    ldp = nc + 8;
    ldq = C + 8;
    size_t o = 0;
    off_y = o; o = align128(o + sizeof(bf16) * Pp * ldy);
    off_w = o; o = align128(o + sizeof(bf16) * 2 * C * ldw);
    off_tp = o; o = align128(o + sizeof(float) * 2 * TAP_ROWS_F * nc);
    off_p = o; o = align128(o + sizeof(float) * Pp * ldp);
    off_q = off_k = off_red = off_ss = o;
    if (gram) {
      off_q = o; o = align128(o + sizeof(bf16) * npix * ldq);
      off_k = o; o = align128(o + sizeof(bf16) * npix * ldq);
      off_red = o; o = align128(o + sizeof(float) * npix / F_SEG * nc);
      off_ss = o; o = align128(o + sizeof(float) * 2 * C);
    }
    total = o;
  }
};

struct FrontArgs {
  const bf16* x;      // (B, H, W, C)
  const float* ln_w;  // (C)
  const float* ln_b;  // (C) or null (BiasFree)
  const bf16* wqkv;   // (C, 3C): [q | k | v] output channels
  const float* bqkv;  // (3C) or null
  const float* dw;    // (9, 3C) depthwise taps, kh * 3 + kw
  const float* db;    // (3C) or null
  bf16* v;            // K1: (B, H, W, C) v; K4: (B, H, W, 3C) q | k | v
  float* gram_part;   // (B, G, heads, ch, ch); K1 only
  float* ss_part;     // (B, G, 2, C); K1 only
  int H, W, C, heads, th, tiles_w, tiles;
  float eps;
};

// LN1 of the halo tile of `hl` into ys: cp.async stages the x tile, 16
// bytes a copy, with zeros outside the image and in the pad rows up to Pp
// (so the product after it stays finite), then LN1 runs in place, 8 lanes
// a pixel. Ends with this thread's copies landed, not with a barrier.
static __device__ void front_ln_tile(const FrontArgs& a, const FrontSmem& L,
                                     const Halo& hl, const bf16* xb, bf16* ys,
                                     int tid, int nthreads) {
  const int C = a.C, per_row = C / 8;
  for (int i = tid; i < L.Pp * per_row; i += nthreads) {
    const int p = i / per_row, s = i % per_row * 8;
    const int gr = hl.r0 - 1 + p / L.hcols, gc = hl.c0 - 1 + p % L.hcols;
    const bool in = p < L.P && hl.inside(gr, gc);
    cp_async16(ys + p * L.ldy + s,
               in ? xb + ((size_t)gr * a.W + gc) * C + s : xb, in);
  }
  cp_async_commit();
  cp_async_wait_group<0>();
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int p0 = warp * 4; p0 < L.P; p0 += nthreads / 32 * 4) {
    const int p = p0 + lane / 8;
    const bool live = p < L.P && hl.inside(hl.r0 - 1 + p / L.hcols,
                                           hl.c0 - 1 + p % L.hcols);
    bf16* yrow = ys + p * L.ldy;
    group8_layernorm(
        live, C, a.eps, a.ln_w, a.ln_b, lane % 8,
        [&](int v, float(&x)[8]) {
          unpack8(*reinterpret_cast<const uint4*>(yrow + v * 8), x);
        },
        [&](int v, const float(&)[8], const float(&y)[8]) {
          *reinterpret_cast<uint4*>(yrow + v * 8) = pack8(y);
        });
  }
}

// The chunk's W_qkv slice (columns col0 .. col0 + nc) into ws and its
// table of taps and biases into tp, by cp.async (16 bytes a copy); the
// caller commits and waits.
static __device__ void front_stage_w(const FrontArgs& a, const FrontSmem& L,
                                     bf16* ws, float* tp, int col0, int nc,
                                     int tid, int nthreads) {
  const int per_row = nc / 8, C3 = 3 * a.C;
  for (int i = tid; i < a.C * per_row; i += nthreads) {
    const int k = i / per_row, s = i % per_row * 8;
    cp_async16(ws + k * L.ldw + s, a.wqkv + (size_t)k * C3 + col0 + s, true);
  }
  const int per_trow = nc / 4;
  for (int i = tid; i < TAP_ROWS_F * per_trow; i += nthreads) {
    const int r = i / per_trow, s = i % per_trow * 4;
    const float* src = r < 9 ? a.dw + r * C3 : (r == 9 ? a.bqkv : a.db);
    cp_async16(tp + r * nc + s, src ? src + col0 + s : a.dw, src != nullptr);
  }
}

// proj[Pp x nc] = ys[Pp x C] @ ws[C x nc] (the staged slice) + the 1x1
// bias, fp32 accumulation on mma.sync fed by ldmatrix. A warp takes 16 rows
// and all nc (16, 32 or 48) columns, so its A fragment serves every column.
// Pixels outside the image store 0, as torch's zero padding of the
// projected map; without a 1x1 bias the product is 0 there already (ys is).
static __device__ void front_project(const FrontArgs& a, const FrontSmem& L,
                                     const Halo& hl, const bf16* ys,
                                     const bf16* ws, const float* tp,
                                     float* proj, int nc, int warp,
                                     int nwarps, int lane) {
  const int nt = nc / 16;
  for (int mi = warp; mi < L.Pp / 16; mi += nwarps) {
    float acc[6][4];
#pragma unroll
    for (int t = 0; t < 6; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    const bf16* arow = ys + mi * 16 * L.ldy;
#pragma unroll 2
    for (int k = 0; k < a.C; k += 16) {
      unsigned fa[4];
      load_a_16x16(fa, arow + k, L.ldy, lane);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        if (t >= nt) break;
        unsigned fb[4];
        load_b_16x16(fb, ws + k * L.ldw + t * 16, L.ldw, lane);
        mma_16816(acc[2 * t], fa, fb[0], fb[1]);
        mma_16816(acc[2 * t + 1], fa, fb[2], fb[3]);
      }
    }
    // this lane holds pixels p0 and p0 + 8, columns 8t + 2 (lane % 4), + 1
    const int p0 = mi * 16 + lane / 4;
    bool in0 = true, in1 = true;
    if (a.bqkv) {
      in0 = p0 < L.P && hl.inside(hl.r0 - 1 + p0 / L.hcols,
                                  hl.c0 - 1 + p0 % L.hcols);
      in1 = p0 + 8 < L.P && hl.inside(hl.r0 - 1 + (p0 + 8) / L.hcols,
                                      hl.c0 - 1 + (p0 + 8) % L.hcols);
    }
    float* dst = proj + p0 * L.ldp + 2 * (lane % 4);
    const float* bias = tp + 9 * nc + 2 * (lane % 4);
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      if (t >= 2 * nt) break;
      const float b0 = bias[8 * t], b1 = bias[8 * t + 1];
      *reinterpret_cast<float2*>(dst + 8 * t) =
          in0 ? make_float2(acc[t][0] + b0, acc[t][1] + b1)
              : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(dst + 8 * L.ldp + 8 * t) =
          in1 ? make_float2(acc[t][2] + b0, acc[t][3] + b1)
              : make_float2(0.f, 0.f);
    }
  }
}

// 3x3 depthwise over one projected chunk (0 outside the image, the 1x1
// bias added) for the tile's output pixels. A work item is a run of F_SEG
// neighbouring output pixels of one row x 4 channels: 3 (F_SEG + 2)
// 16-byte loads slide a 3-column window over the halo rows for 36 F_SEG
// taps, with no test; each sum starts from the depthwise bias and runs kh,
// then kw. q/k chunks (qk_dst != null) go to shared memory as bf16 at
// column `sub`, zeros outside the image, and add their fp32 sums of
// squares, one partial per run, to `red` (the caller sums them in a fixed
// order: deterministic); other chunks go to device memory, 8 bytes a store: v's
// channels to vb's C (K1), or, with kAllChannels, every projected channel
// to vb's 3C (K4).
template <bool kAllChannels = false>
static __device__ void front_dwconv(const FrontArgs& a, const FrontSmem& L,
                                    const Halo& hl, const float* proj,
                                    const float* tp, int col0, int nc,
                                    bf16* qk_dst, int sub, float* red,
                                    bf16* vb, int tid, int nthreads) {
  const int n4 = nc / 4, runs_w = TILE_W / F_SEG, nruns = L.npix / F_SEG;
  for (int i = tid; i < n4 * nruns; i += nthreads) {
    const int c = i % n4 * 4, run = i / n4;
    const int orow = run / runs_w, oc0 = run % runs_w * F_SEG;
    float4 wt[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      wt[k] = *reinterpret_cast<const float4*>(tp + k * nc + c);
    const float4 db = *reinterpret_cast<const float4*>(tp + 10 * nc + c);
    float acc[F_SEG][4];
#pragma unroll
    for (int r = 0; r < F_SEG; ++r)
      acc[r][0] = db.x, acc[r][1] = db.y, acc[r][2] = db.z, acc[r][3] = db.w;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const float* rp = proj + ((orow + kh) * L.hcols + oc0) * L.ldp + c;
      float4 v[F_SEG + 2];
#pragma unroll
      for (int j = 0; j < F_SEG + 2; ++j)
        v[j] = *reinterpret_cast<const float4*>(rp + j * L.ldp);
#pragma unroll
      for (int r = 0; r < F_SEG; ++r)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4 w = wt[kh * 3 + kw], x = v[r + kw];
          acc[r][0] += x.x * w.x;
          acc[r][1] += x.y * w.y;
          acc[r][2] += x.z * w.z;
          acc[r][3] += x.w * w.w;
        }
    }
    const int gr = hl.r0 + orow;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < F_SEG; ++r) {
      const int gc = hl.c0 + oc0 + r;
      const bool in = hl.inside(gr, gc);
      if (qk_dst) {
        *reinterpret_cast<uint2*>(
            qk_dst + (orow * TILE_W + oc0 + r) * L.ldq + sub + c) =
            in ? pack4(acc[r]) : make_uint2(0u, 0u);
        if (in)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[e] += acc[r][e] * acc[r][e];
      } else if (in) {
        const size_t pix = (size_t)gr * a.W + gc;
        bf16* dst = kAllChannels ? vb + pix * 3 * a.C + col0 + c
                                 : vb + pix * a.C + col0 - 2 * a.C + c;
        *reinterpret_cast<uint2*>(dst) = pack4(acc[r]);
      }
    }
    if (qk_dst)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[run * nc + c + e] = s[e];
  }
}

// Gram fragments (16 x 16) one warp of K1 owns: the smallest instantiated
// count that holds heads x (ch / 16)^2 over the block's warps, 0 when none
// does. 16 warps leave a thread 128 registers, which the fragments a warp
// keeps over all of its tiles overrun above 3.
__host__ __device__ inline int front_frags(int C, int heads, int warps) {
  if (warps != 8 && warps != 16) return 0;
  const int cht = C / heads / 16, units = heads * cht * cht;
  const int need = (units + warps - 1) / warps;
  const int have[] = {1, 2, 3, 5, 9};
  for (int nf : have)
    if (need <= nf) return nf > 3 && warps == 16 ? 0 : nf;
  return 0;
}

// The front over the tiles blockIdx.x, + gridDim.x, ... of batch image
// blockIdx.y, in blocks of NW warps. NF = 0 (K4): every projected channel
// goes to device memory, a.v's 3C. NF > 0 (K1): v goes to a.v's C; q and
// k stay in shared memory for the tile's Gram pass, whose NF fragments a
// warp keeps in registers; the block's partial Gram and sums of squares go
// to a.gram_part and a.ss_part at the end.
template <int NW, int NF>
static __device__ void front_run(const FrontArgs& a, unsigned char* smem) {
  constexpr int NT = NW * 32;
  constexpr bool kGram = NF > 0;
  const FrontSmem L(a.C, a.th, kGram);
  bf16* ys = reinterpret_cast<bf16*>(smem + L.off_y);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.off_w);
  float* tp = reinterpret_cast<float*>(smem + L.off_tp);
  float* proj = reinterpret_cast<float*>(smem + L.off_p);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.off_q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.off_k);
  float* red = reinterpret_cast<float*>(smem + L.off_red);
  float* ssacc = reinterpret_cast<float*>(smem + L.off_ss);

  const int C = a.C, nc = L.nc, nch = 3 * C / nc;
  const int nqk = kGram ? 2 * C / nc : 0;  // q and k chunks
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ch = C / a.heads, cht = ch / 16, units = a.heads * cht * cht;
  const int WS = C * L.ldw, TP = TAP_ROWS_F * nc;  // a buffer's elements
  const bf16* xb = a.x + (size_t)b * a.H * a.W * C;
  bf16* vb = a.v + (size_t)b * a.H * a.W * (kGram ? C : 3 * C);

  // g[f]: Gram fragment warp + f * NW (head u / cht^2, block u % cht^2),
  // columns 0-7 and 8-15 as mma_16816 lays them out
  float g[kGram ? NF : 1][2][4];
#pragma unroll
  for (int f = 0; f < (kGram ? NF : 1); ++f)
#pragma unroll
    for (int e = 0; e < 8; ++e) g[f][e / 4][e % 4] = 0.f;
  if (kGram)
    for (int i = tid; i < 2 * C; i += NT) ssacc[i] = 0.f;

  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const Halo hl{(t / a.tiles_w) * a.th, (t % a.tiles_w) * TILE_W, a.H, a.W};
    __syncthreads();  // the previous tile is done with every buffer
    front_stage_w(a, L, ws, tp, 0, nc, tid, NT);
    front_ln_tile(a, L, hl, xb, ys, tid, NT);
    __syncthreads();
    for (int j = 0; j < nch; ++j) {
      const int col0 = j * nc, buf = j & 1;
      if (j + 1 < nch)
        front_stage_w(a, L, ws + (buf ^ 1) * WS, tp + (buf ^ 1) * TP,
                      col0 + nc, nc, tid, NT);
      cp_async_commit();
      if (kGram && j > 0 && j <= nqk) {
        // chunk j - 1's sums of squares, runs in a fixed order
        for (int n = tid; n < nc; n += NT) {
          float s = 0.f;
          for (int r = 0; r < L.npix / F_SEG; ++r) s += red[r * nc + n];
          ssacc[col0 - nc + n] += s;
        }
      }
      if (kGram && j == nqk) {
        // q and k of every head are whole: gram[h] += q_h^T k_h
#pragma unroll
        for (int f = 0; f < (kGram ? NF : 1); ++f) {
          const int u = warp + f * NW;
          if (u >= units) continue;
          const int h = u / (cht * cht), r = u % (cht * cht);
          const bf16* qa = qs + h * ch + r / cht * 16;
          const bf16* kb = ks + h * ch + r % cht * 16;
          for (int k = 0; k < L.npix; k += 16) {
            unsigned fa[4], fb[4];
            load_at_16x16(fa, qa + k * L.ldq, L.ldq, lane);
            load_b_16x16(fb, kb + k * L.ldq, L.ldq, lane);
            mma_16816(g[f][0], fa, fb[0], fb[1]);
            mma_16816(g[f][1], fa, fb[2], fb[3]);
          }
        }
      }
      const float* tpj = tp + buf * TP;
      front_project(a, L, hl, ys, ws + buf * WS, tpj, proj, nc, warp, NW,
                    lane);
      __syncthreads();  // proj is whole
      bf16* qk = j >= nqk ? nullptr : (j < nqk / 2 ? qs : ks);
      front_dwconv<!kGram>(a, L, hl, proj, tpj, col0, nc, qk, col0 % C, red,
                           vb, tid, NT);
      cp_async_wait_group<0>();
      __syncthreads();  // chunk j + 1's slice and table have landed; proj,
                        // red and the other buffers are free
    }
  }
  if (kGram) {
    const size_t part = (size_t)b * gridDim.x + blockIdx.x;
    float* gp = a.gram_part + part * a.heads * ch * ch;
#pragma unroll
    for (int f = 0; f < (kGram ? NF : 1); ++f) {
      const int u = warp + f * NW;
      if (u >= units) continue;
      const int h = u / (cht * cht), r = u % (cht * cht);
      // this lane: rows lane / 4 and + 8, columns 2 (lane % 4), + 1 (+ 8)
      float* o = gp + h * ch * ch + (r / cht * 16 + lane / 4) * ch +
                 r % cht * 16 + 2 * (lane % 4);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        *reinterpret_cast<float2*>(o + 8 * s) =
            make_float2(g[f][s][0], g[f][s][1]);
        *reinterpret_cast<float2*>(o + 8 * ch + 8 * s) =
            make_float2(g[f][s][2], g[f][s][3]);
      }
    }
    __syncthreads();  // ssacc is whole
    for (int i = tid; i < 2 * C; i += NT)
      a.ss_part[part * 2 * C + i] = ssacc[i];
  }
}

// Sums the G per-block partials of each batch in a fixed order. `static`:
// each source that launches it holds its own copy.
static __global__ void front_reduce_kernel(const float* gram_part,
                                           const float* ss_part, float* gram,
                                           float* ss, int G, int ng,
                                           int nss) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < ng) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += gram_part[((size_t)b * G + g) * ng + i];
    gram[(size_t)b * ng + i] = s;
  } else if (i < ng + nss) {
    const int j = i - ng;
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += ss_part[((size_t)b * G + g) * nss + j];
    ss[(size_t)b * nss + j] = s;
  }
}

// Launches front_reduce_kernel for B batches of G partials on `s`.
static inline cudaError_t launch_front_reduce(const void* gram_part,
                                              const void* ss_part, void* gram,
                                              void* ss, int B, int G, int ng,
                                              int nss, cudaStream_t s) {
  front_reduce_kernel<<<dim3((ng + nss + 255) / 256, B), 256, 0, s>>>(
      static_cast<const float*>(gram_part), static_cast<const float*>(ss_part),
      static_cast<float*>(gram), static_cast<float*>(ss), G, ng, nss);
  return cudaGetLastError();
}

}  // namespace irk
