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
#include "common.cuh"

namespace irk {

constexpr int F_THREADS = 192;  // 6 warps; 192 = nc * groups for nc 16/32/48
constexpr int F_WARPS = F_THREADS / 32;

__host__ __device__ inline int front_chunk(int ch) {
  return ch % 48 == 0 ? 48 : (ch % 32 == 0 ? 32 : 16);
}

struct FrontSmem {
  int hcols, P, Pp, npix, ldy, ldp, ldq;
  size_t off_y, off_p, off_q, off_k, off_g, off_ss, off_red, total;
  __host__ __device__ FrontSmem(int C, int heads, int th) {
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
    off_q = o; o = align128(o + sizeof(bf16) * npix * ldq);
    off_k = o; o = align128(o + sizeof(bf16) * npix * ldq);
    off_g = o; o = align128(o + sizeof(float) * heads * ch * ch);
    off_ss = o; o = align128(o + sizeof(float) * 2 * C);
    off_red = o; o = align128(o + sizeof(float) * F_THREADS);
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
  bf16* v;            // (B, H, W, C)
  float* gram_part;   // (B, G, heads, ch, ch)
  float* ss_part;     // (B, G, 2, C)
  int H, W, C, heads, th, tiles_w, tiles;
  float eps;
};

// proj[Pp x nc] = ys[Pp x C] @ wqkv[:, col0 : col0 + nc], fp32 accumulation.
__device__ void front_project(const FrontArgs& a, const FrontSmem& L,
                              const bf16* ys, float* proj, int col0, int nc,
                              int warp) {
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
// v chunks go straight to device memory.
__device__ void front_dwconv(const FrontArgs& a, const FrontSmem& L,
                             const Halo& hl, const float* proj, int col0,
                             int nc, bf16* qk_dst, int sub, float* ss,
                             float* red, bf16* vb, int tid) {
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

// gram[ch x ch] += q^T[ch x npix] @ k[npix x ch], accumulator in smem.
__device__ void front_gram(const FrontSmem& L, int ch, const bf16* qs,
                           const bf16* ks, float* gram, int warp) {
  const int t = ch / 16;
  for (int i = warp; i < t * t; i += F_WARPS) {
    const int mi = i / t, ni = i % t;
    FragC acc;
    wmma::load_matrix_sync(acc, gram + mi * 16 * ch + ni * 16, ch,
                           wmma::mem_row_major);
    for (int k = 0; k < L.npix; k += 16) {
      FragAT fa;
      FragB fb;
      wmma::load_matrix_sync(fa, qs + k * L.ldq + mi * 16, L.ldq);
      wmma::load_matrix_sync(fb, ks + k * L.ldq + ni * 16, L.ldq);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(gram + mi * 16 * ch + ni * 16, acc, ch,
                            wmma::mem_row_major);
  }
}

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
    // LN1 of the halo tile; pixels outside the image (and the pad rows up
    // to Pp) become zeros, so the product below stays finite there.
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
      front_gram(L, ch, qs, ks, gacc + h * ch * ch, warp);
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

// Sums the G per-block partials of each batch in a fixed order.
__global__ void front_reduce_kernel(const float* gram_part,
                                    const float* ss_part, float* gram,
                                    float* ss, int G, int ng, int nss) {
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
  const int ng = C * (C / heads), nss = 2 * C;
  front_reduce_kernel<<<dim3((ng + nss + 255) / 256, B), 256, 0, s>>>(
      static_cast<const float*>(gram_part), static_cast<const float*>(ss_part),
      static_cast<float*>(gram), static_cast<float*>(ss), grid_x, ng, nss);
  return cudaGetLastError();
}

const char* ir_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
