// Device code shared by the kernels that open a Restormer block: pass 1 of
// the whole-block pair (block_front.cu, K1), the LN + qkv 1x1 + 3x3
// depthwise kernel of the three-kernel block (ln_qkv_dwconv.cu, K4) and the
// attention accumulation (attn_core.cu, K5).
//
// * front_ln_tile: LN1 of a halo tile into shared memory (bf16).
// * front_project: one chunk of the qkv 1x1 on the tensor cores (fp32).
// * front_dwconv: the 3x3 depthwise of that chunk, to shared memory (q and
//   k of K1) or to device memory (v of K1, all of q, k and v in K4).
// * front_gram: per-head q^T k accumulated in shared memory.
// * front_reduce_kernel: sums per-block partials in a fixed order.
#pragma once

#include "common.cuh"

namespace irk {

constexpr int F_THREADS = 192;  // 6 warps; 192 = nc * groups for nc 16/32/48
constexpr int F_WARPS = F_THREADS / 32;

__host__ __device__ inline int front_chunk(int ch) {
  return ch % 48 == 0 ? 48 : (ch % 32 == 0 ? 32 : 16);
}

// Shared-memory layout of a front kernel. With `gram` false (K4) only the
// LN'd halo tile and one projected chunk are held.
struct FrontSmem {
  int hcols, P, Pp, npix, ldy, ldp, ldq;
  size_t off_y, off_p, off_q, off_k, off_g, off_ss, off_red, total;
  __host__ __device__ FrontSmem(int C, int heads, int th, bool gram = true) {
    const int ch = C / heads, nc = front_chunk(ch);
    hcols = TILE_W + 2;
    P = (th + 2) * hcols;
    Pp = round16(P);
    npix = th * TILE_W;
    ldy = C + 8;
    ldp = nc + 4;
    ldq = ch + 8;
    size_t o = 0;
    off_y = o; o = align128(o + sizeof(bf16) * Pp * ldy);
    off_p = o; o = align128(o + sizeof(float) * Pp * ldp);
    off_q = off_k = off_g = off_ss = off_red = o;
    if (gram) {
      off_q = o; o = align128(o + sizeof(bf16) * npix * ldq);
      off_k = o; o = align128(o + sizeof(bf16) * npix * ldq);
      off_g = o; o = align128(o + sizeof(float) * heads * ch * ch);
      off_ss = o; o = align128(o + sizeof(float) * 2 * C);
      off_red = o; o = align128(o + sizeof(float) * F_THREADS);
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

// LN1 of the halo tile of `hl` into ys; pixels outside the image (and the
// pad rows up to Pp) become zeros, so the product after it stays finite.
__device__ __forceinline__ void front_ln_tile(const FrontArgs& a,
                                              const FrontSmem& L,
                                              const Halo& hl, const bf16* xb,
                                              bf16* ys, int warp, int lane) {
  const int C = a.C;
  for (int p = warp; p < L.Pp; p += F_WARPS) {
    const int gr = hl.r0 - 1 + p / L.hcols, gc = hl.c0 - 1 + p % L.hcols;
    bf16* yrow = ys + p * L.ldy;
    if (p >= L.P || !hl.inside(gr, gc)) {
      for (int c = lane; c < C; c += 32) yrow[c] = f2bf(0.f);
      continue;
    }
    const bf16* xr = xb + ((size_t)gr * a.W + gc) * C;
    warp_layernorm([&](int c) { return bf2f(xr[c]); }, C, a.eps, a.ln_w,
                   a.ln_b, yrow, lane);
  }
}

// proj[Pp x nc] = ys[Pp x C] @ wqkv[:, col0 : col0 + nc], fp32 accumulation.
static __device__ void front_project(const FrontArgs& a, const FrontSmem& L,
                                     const bf16* ys, float* proj, int col0,
                                     int nc, int warp) {
  const int mt = L.Pp / 16, nt = nc / 16, ldw = 3 * a.C;
  for (int t = warp; t < mt * nt; t += F_WARPS) {
    const int mi = t / nt, ni = t % nt;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < a.C; k += 16) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, ys + mi * 16 * L.ldy + k, L.ldy);
      wmma::load_matrix_sync(fb, a.wqkv + (size_t)k * ldw + col0 + ni * 16,
                             ldw);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(proj + mi * 16 * L.ldp + ni * 16, acc, L.ldp,
                            wmma::mem_row_major);
  }
}

// 3x3 depthwise over one projected chunk for the tile's output pixels.
// Thread (n, g) owns chunk channel n and output pixels g, g + groups, ...
// q/k chunks (qk_dst != null) go to shared memory as bf16 at column `sub`
// and add their fp32 sums of squares to ss (fixed order: deterministic);
// other chunks go straight to device memory: v's channels to vb's C (K1),
// or, with kAllChannels, every projected channel to vb's 3C (K4). K1's
// index is kept as it was written: a form with the row stride and column
// offset as arguments measured 16% slower at 64x64x384 on an H100.
template <bool kAllChannels = false>
static __device__ void front_dwconv(const FrontArgs& a, const FrontSmem& L,
                                    const Halo& hl, const float* proj,
                                    int col0, int nc, bf16* qk_dst, int sub,
                                    float* ss, float* red, bf16* vb,
                                    int tid) {
  const int n = tid % nc, g = tid / nc, groups = F_THREADS / nc;
  const int col = col0 + n, C3 = 3 * a.C;
  float wt[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wt[k] = a.dw[k * C3 + col];
  const float bias = a.bqkv ? a.bqkv[col] : 0.f;
  const float dbias = a.db ? a.db[col] : 0.f;
  float ssum = 0.f;
  for (int q = g; q < L.npix; q += groups) {
    const int orow = q / TILE_W, ocol = q % TILE_W;
    const int gr = hl.r0 + orow, gc = hl.c0 + ocol;
    float acc = dbias;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
        if (hl.inside(gr - 1 + kh, gc - 1 + kw))
          acc += (proj[((orow + kh) * L.hcols + ocol + kw) * L.ldp + n] +
                  bias) * wt[kh * 3 + kw];
    const bool in = hl.inside(gr, gc);
    if (qk_dst) {
      qk_dst[q * L.ldq + sub + n] = f2bf(in ? acc : 0.f);
      if (in) ssum += acc * acc;
    } else if (in && kAllChannels) {
      vb[((size_t)gr * a.W + gc) * C3 + col] = f2bf(acc);
    } else if (in) {
      vb[((size_t)gr * a.W + gc) * a.C + (col - 2 * a.C)] = f2bf(acc);
    }
  }
  if (qk_dst) {
    red[tid] = ssum;
    __syncthreads();
    if (g == 0) {
      float s = 0.f;
      for (int i = 0; i < groups; ++i) s += red[i * nc + n];
      ss[col] += s;  // col < 2C: q sums at [0, C), k sums at [C, 2C)
    }
  }
  __syncthreads();
}

// gram[ch x ch] += q^T[ch x npix] @ k[npix x ch], the accumulator in shared
// memory; q and k rows `ldq` apart, npix a multiple of 16.
static __device__ void front_gram(int npix, int ldq, int ch, const bf16* qs,
                                  const bf16* ks, float* gram, int warp,
                                  int nwarps) {
  const int t = ch / 16;
  for (int i = warp; i < t * t; i += nwarps) {
    const int mi = i / t, ni = i % t;
    FragC acc;
    wmma::load_matrix_sync(acc, gram + mi * 16 * ch + ni * 16, ch,
                           wmma::mem_row_major);
    for (int k = 0; k < npix; k += 16) {
      FragAT fa;
      FragB fb;
      wmma::load_matrix_sync(fa, qs + k * ldq + mi * 16, ldq);
      wmma::load_matrix_sync(fb, ks + k * ldq + ni * 16, ldq);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(gram + mi * 16 * ch + ni * 16, acc, ch,
                            wmma::mem_row_major);
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
