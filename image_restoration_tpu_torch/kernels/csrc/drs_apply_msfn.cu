// Pass 2 of the DRSformer TransformerBlock: attention apply + residual, LN2,
// and the whole mixed-scale FFN (MSFN) + residual.
//
// Replaces the TPU kernel image_restoration_tpu/kernels/drs_block_pallas.py
// `_apply_msfn_kernel`. Two launches on one stream (three with a split):
//
// 1. msfn_pre_kernel, per pixel (no halo):
//      ao  = x + v @ (A^T W_proj) + b_proj        (fp32)
//      y   = bf16(LN2(ao))  -> device memory       (C wide)
//      res = ao + b_out     -> device memory       (fp32, C wide)
// 2. msfn_main_kernel, per output tile of th x 16 pixels, with a 4-pixel
//    halo (a 5x5 stage-1 bank followed by a 5x5 stage-2 bank):
//      for each chunk of 16 stage-2 groups (kernels/drs_block.py
//      msfn_chunks; one path, one stage-1 bank size per chunk):
//        u  = bf16(y @ W_in[:, chunk operands] + b)   on the halo-4 tile,
//             zero outside the image
//        d  = bf16(relu(dw_k1(u) + b1))               on the halo-2 tile,
//             zero outside the image
//        s  = bf16(relu(dw_k2(d_A) + dw_k2(d_B) + b2)) on the tile
//        acc += s @ W_out[chunk groups, :]            (fp32, in smem)
//      out = bf16(acc), acc starting from res.
// Products take bf16 operands and accumulate in fp32 on the tensor cores
// (nvcuda::wmma); taps are fp32 on bf16 inputs. The rounding points are
// the TPU kernel's (its _BF16_STORE default).
//
// Each stage-2 group reads two stage-1 results ("operands"); the host
// gathers W_in's columns per operand, so a chunk's 32 operands are 32
// columns of one product and every pair sits side by side (columns 2g,
// 2g+1). With an odd hidden width one group pairs d3[H-1] with d5[0]: its
// d3 operand rides a 5x5 chunk with its 3x3 taps zero-padded. A u channel
// feeds one d3 and one d5 operand, so the W_in product is done twice per
// channel; it runs on the tensor cores, the taps do not.
//
// What bounds it on the card: the 2H-wide u, d and stage-2 sums (2H = 5.3 C)
// never reach device memory; the C-wide y and res do (step 1), which costs
// ~8 C bytes per pixel of traffic and frees step 2 from holding the LN2'd
// halo tile: at C = 384 that tile alone would need ~200 KB of shared memory.
// Step 2 is bound by the fp32 tap loops reading shared memory (two stages,
// 9 or 25 taps each, per hidden channel and pixel, stage 1 over the halo-2
// tile) and by the tensor-core products re-done on the halo-4 tile. The tap
// loops walk row segments so one load feeds several outputs, and 16 warps
// per block hide the loads' latency; the products are not pipelined yet
// (no TMA, no wgmma).
//
// Shared memory (MainSmem): y's halo-4 tile (all C channels when they fit,
// else `kc` channels at a time), the chunk's W_in columns (the same kc rows)
// and W_out rows, u of one chunk in fp32 (then reused for d and s), u in
// bf16, and the fp32 output accumulator (th*16 x C). Every product reads
// its operands from shared memory, staged with 16-byte async copies: with
// one block per SM there are too few warps to hide a load from L2. The accumulator is what limits the
// tile: the host (kernels/drs_block.py _msfn_launch) takes the tallest of
// 8/4/2/1 rows that fits 227 KB, which is th = 8 up to C = 192 and th = 4 at
// C = 384. The deep levels then have fewer tiles than two per SM (128 at
// 128x128, 64 at 64x64), and one block walking all 4H/32 chunks of a tile
// in series leaves most SMs idle; there the host splits each tile's chunks
// over several blocks, which write fp32 partials that msfn_reduce_kernel
// sums in a fixed order (deterministic, no atomics).
#include "common.cuh"

namespace irk {

constexpr int M_THREADS = 512;  // 16 warps
constexpr int M_WARPS = M_THREADS / 32;
constexpr int NG = 16;       // stage-2 groups per chunk
constexpr int NO = 2 * NG;   // operands (u columns) per chunk; one per lane
constexpr int HALO4 = 4;
constexpr int C4 = TILE_W + 2 * HALO4;  // halo-4 tile columns (24)
constexpr int C2 = TILE_W + 4;          // halo-2 tile columns (20)
constexpr int PRE_PIX = 64;             // pixels per step-1 block

// ------------------------------------------------------------- step 1 ---

struct PreSmem {
  int ldv, lda;
  size_t off_v, off_a, total;
  __host__ __device__ PreSmem(int C) {
    ldv = C + 8;
    lda = C + 4;
    off_v = 0;
    off_a = align128(sizeof(bf16) * PRE_PIX * ldv);
    total = align128(off_a + sizeof(float) * PRE_PIX * lda);
  }
};

struct PreArgs {
  const bf16* v;      // (B, HW, C)
  const bf16* x;      // (B, HW, C)
  const bf16* atw;    // (B, C, C)
  const float* bp;    // (C) or null
  const float* ln_w;  // (C)
  const float* ln_b;  // (C) or null (BiasFree)
  const float* bo;    // (C) or null
  bf16* y;            // (B, HW, C)
  float* res;         // (B, HW, C)
  int HW, C;
  float eps;
};

__global__ void __launch_bounds__(M_THREADS) msfn_pre_kernel(PreArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PreSmem L(a.C);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.off_v);
  float* ao = reinterpret_cast<float*>(smem + L.off_a);
  const int C = a.C, b = blockIdx.y, p0 = blockIdx.x * PRE_PIX;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t img = (size_t)b * a.HW * C;
  const bf16* atw = a.atw + (size_t)b * C * C;

  for (int r = warp; r < PRE_PIX; r += M_WARPS) {
    const int p = p0 + r;
    bf16* dst = vs + r * L.ldv;
    if (p < a.HW) {
      const bf16* src = a.v + img + (size_t)p * C;
      for (int c = lane; c < C; c += 32) dst[c] = src[c];
    } else {
      for (int c = lane; c < C; c += 32) dst[c] = f2bf(0.f);
    }
  }
  __syncthreads();
  const int nt = C / 16;
  for (int t = warp; t < (PRE_PIX / 16) * nt; t += M_WARPS) {
    const int mi = t / nt, ni = t % nt;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < C; k += 16) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, vs + mi * 16 * L.ldv + k, L.ldv);
      wmma::load_matrix_sync(fb, atw + (size_t)k * C + ni * 16, C);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(ao + mi * 16 * L.lda + ni * 16, acc, L.lda,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int r = warp; r < PRE_PIX; r += M_WARPS) {
    const int p = p0 + r;
    if (p >= a.HW) continue;
    const size_t off = img + (size_t)p * C;
    float* arow = ao + r * L.lda;
    for (int c = lane; c < C; c += 32)
      arow[c] += (a.bp ? a.bp[c] : 0.f) + bf2f(a.x[off + c]);
    __syncwarp();
    warp_layernorm([&](int c) { return arow[c]; }, C, a.eps, a.ln_w, a.ln_b,
                   a.y + off, lane);
    for (int c = lane; c < C; c += 32)
      a.res[off + c] = arow[c] + (a.bo ? a.bo[c] : 0.f);
  }
}

// ------------------------------------------------------------- step 2 ---

struct MainSmem {
  int P4, P4p, P2, npix, ldy, ldu, ldub, ldd, lds, ldo, ldwi, ldwo;
  size_t off_y, off_wi, off_wo, off_ub, off_o, off_u, off_d, off_s, total;
  __host__ __device__ MainSmem(int C, int th, int kc) {
    P4 = (th + 2 * HALO4) * C4;
    P4p = round16(P4);
    P2 = (th + 4) * C2;
    npix = th * TILE_W;
    ldy = kc + 8;
    ldu = NO + 4;
    ldub = NO + 8;
    ldd = NO + 8;
    lds = NG + 8;
    ldo = C + 4;
    ldwi = NO + 8;
    ldwo = C + 8;
    size_t o = 0;
    off_y = o; o = align128(o + sizeof(bf16) * P4p * ldy);
    off_wi = o; o = align128(o + sizeof(bf16) * kc * ldwi);
    off_wo = o; o = align128(o + sizeof(bf16) * NG * ldwo);
    off_ub = o; o = align128(o + sizeof(bf16) * P4p * ldub);
    off_o = o; o = align128(o + sizeof(float) * npix * ldo);
    // u (fp32) of a chunk; once it is in ub, d and s take its place
    off_u = o;
    const size_t end_u = align128(off_u + sizeof(float) * P4p * ldu);
    off_d = o;
    off_s = align128(off_d + sizeof(bf16) * P2 * ldd);
    const size_t end_ds = align128(off_s + sizeof(bf16) * npix * lds);
    total = end_u > end_ds ? end_u : end_ds;
  }
};

struct MainArgs {
  const bf16* y;      // (B, H, W, C)
  const float* res;   // (B, H, W, C)
  const bf16* win;    // (C, nch * NO) gathered project_in columns
  const float* bin;   // (nch * NO) or null
  const float* w1;    // (nch * NO, 25) stage-1 taps, t * k1 + s
  const float* b1;    // (nch * NO) or null
  const float* w2;    // (nch * NG, 2, 25) stage-2 taps of operands A, B
  const float* b2;    // (nch * NG) or null
  const bf16* wout;   // (nch * NG, C) gathered project_out rows
  const int* meta;    // (nch, 2): k1, k2 of each chunk
  bf16* out;          // (B, H, W, C) when split == 1
  float* part;        // (split, B, H, W, C) partial sums when split > 1
  int H, W, C, nch, th, kc, tiles_w, split;
};

// The tap loops walk rows in segments: each u (or d) value a thread loads
// feeds every output of its segment that its taps reach, so a k-tap row
// costs SEG + k - 1 shared-memory loads for SEG outputs instead of k * SEG.
// The fp32 sums still run over the taps in row-major order.
constexpr int SEG1 = 5;  // stage 1: 20 halo-2 columns = 4 segments a row
constexpr int SEG2 = 4;  // stage 2: 16 output columns = 4 segments a row

// d[p][lane] over the halo-2 tile from ub over the halo-4 tile.
template <int K>
__device__ void msfn_stage1(const MainArgs& a, const MainSmem& L,
                            const Halo& hl, const bf16* ub, bf16* d, int j,
                            int warp, int lane) {
  constexpr int R = K / 2, NSEG = C2 / SEG1;
  const int col = j * NO + lane;
  float wt[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wt[t] = a.w1[(size_t)col * 25 + t];
  const float bias = a.b1 ? a.b1[col] : 0.f;
  for (int item = warp; item < (L.P2 / C2) * NSEG; item += M_WARPS) {
    const int i = item / NSEG, j0 = (item % NSEG) * SEG1;
    float acc[SEG1];
#pragma unroll
    for (int e = 0; e < SEG1; ++e) acc[e] = 0.f;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const bf16* src = ub + ((i + 2 - R + t) * C4 + j0 + 2 - R) * L.ldub + lane;
#pragma unroll
      for (int c = 0; c < SEG1 + K - 1; ++c) {
        const float v = bf2f(src[c * L.ldub]);
#pragma unroll
        for (int s = 0; s < K; ++s)
          if (c - s >= 0 && c - s < SEG1) acc[c - s] += v * wt[t * K + s];
      }
    }
#pragma unroll
    for (int e = 0; e < SEG1; ++e) {
      const bool in = hl.inside(hl.r0 - 2 + i, hl.c0 - 2 + j0 + e);
      d[(i * C2 + j0 + e) * L.ldd + lane] =
          f2bf(in ? fmaxf(acc[e] + bias, 0.f) : 0.f);
    }
  }
}

// s[q][g] over the output tile from the operand pair (2g, 2g + 1) of d,
// read as one bf16 pair.
template <int K>
__device__ void msfn_stage2(const MainArgs& a, const MainSmem& L,
                            const Halo& hl, const bf16* d, bf16* s, int j,
                            int warp, int lane) {
  constexpr int R = K / 2, NSEG = TILE_W / SEG2;
  const int g = lane % NG, stream = warp * 2 + lane / NG;
  const float* w = a.w2 + (size_t)(j * NG + g) * 50;
  float wa[K * K], wb[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    wa[t] = w[t];
    wb[t] = w[25 + t];
  }
  const float bias = a.b2 ? a.b2[j * NG + g] : 0.f;
  for (int item = stream; item < (L.npix / TILE_W) * NSEG;
       item += 2 * M_WARPS) {
    const int i = item / NSEG, j0 = (item % NSEG) * SEG2;
    float acc[SEG2];
#pragma unroll
    for (int e = 0; e < SEG2; ++e) acc[e] = 0.f;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const bf16* src = d + ((i + 2 - R + t) * C2 + j0 + 2 - R) * L.ldd + 2 * g;
#pragma unroll
      for (int c = 0; c < SEG2 + K - 1; ++c) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(src + c * L.ldd);
        const float va = __low2float(v), vb = __high2float(v);
#pragma unroll
        for (int u = 0; u < K; ++u)
          if (c - u >= 0 && c - u < SEG2)
            acc[c - u] += va * wa[t * K + u] + vb * wb[t * K + u];
      }
    }
#pragma unroll
    for (int e = 0; e < SEG2; ++e) {
      const bool in = hl.inside(hl.r0 + i, hl.c0 + j0 + e);
      s[(i * TILE_W + j0 + e) * L.lds + g] =
          f2bf(in ? fmaxf(acc[e] + bias, 0.f) : 0.f);
    }
  }
}

// Starts the copies ys[p][0:kc] = y[halo-4 pixel p][kb : kb + kc], zeros
// outside the image; 16 bytes per copy, spread over all threads.
__device__ void msfn_load_y(const MainArgs& a, const MainSmem& L,
                            const Halo& hl, const bf16* yb, bf16* ys, int kb,
                            int tid) {
  const int vec = a.kc / 8;
  for (int i = tid; i < L.P4p * vec; i += M_THREADS) {
    const int p = i / vec, m = i % vec;
    const int gr = hl.r0 - HALO4 + p / C4, gc = hl.c0 - HALO4 + p % C4;
    const bool in = p < L.P4 && hl.inside(gr, gc);
    const bf16* src = in ? yb + ((size_t)gr * a.W + gc) * a.C + kb + 8 * m : yb;
    cp_async16(ys + p * L.ldy + 8 * m, src, in);
  }
}

// Block (t, b, z) takes output tile t of image b and the z-th of `split`
// equal runs of chunks. With split > 1 each block writes its fp32 partial
// (z == 0 carrying the residual terms) and msfn_reduce_kernel sums them.
__global__ void __launch_bounds__(M_THREADS) msfn_main_kernel(MainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MainSmem L(a.C, a.th, a.kc);
  bf16* ys = reinterpret_cast<bf16*>(smem + L.off_y);
  bf16* wi = reinterpret_cast<bf16*>(smem + L.off_wi);
  bf16* wo = reinterpret_cast<bf16*>(smem + L.off_wo);
  bf16* ub = reinterpret_cast<bf16*>(smem + L.off_ub);
  float* oacc = reinterpret_cast<float*>(smem + L.off_o);
  float* uf = reinterpret_cast<float*>(smem + L.off_u);
  bf16* d = reinterpret_cast<bf16*>(smem + L.off_d);
  bf16* s2 = reinterpret_cast<bf16*>(smem + L.off_s);

  const int C = a.C, b = blockIdx.y, t = blockIdx.x, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Halo hl{(t / a.tiles_w) * a.th, (t % a.tiles_w) * TILE_W, a.H, a.W};
  const size_t img = (size_t)b * a.H * a.W * C;
  const bf16* yb = a.y + img;
  const int ldw = a.nch * NO;
  const bool resident = a.kc == C;
  const int j0 = z * a.nch / a.split, j1 = (z + 1) * a.nch / a.split;

  // the accumulator starts from both residual terms, ao + b_out
  for (int q = warp; q < L.npix; q += M_WARPS) {
    const int gr = hl.r0 + q / TILE_W, gc = hl.c0 + q % TILE_W;
    float* orow = oacc + q * L.ldo;
    if (z == 0 && hl.inside(gr, gc)) {
      const float* src = a.res + img + ((size_t)gr * a.W + gc) * C;
      for (int c = lane; c < C; c += 32) orow[c] = src[c];
    } else {
      for (int c = lane; c < C; c += 32) orow[c] = 0.f;
    }
  }
  if (resident) msfn_load_y(a, L, hl, yb, ys, 0, tid);

  for (int j = j0; j < j1; ++j) {
    // u[P4p x NO] = ys @ win[:, chunk j], y staged over C when not resident
    for (int kb = 0; kb < C; kb += a.kc) {
      __syncthreads();  // the readers of ys, wi and wo are done
      if (!resident) msfn_load_y(a, L, hl, yb, ys, kb, tid);
      for (int i = tid; i < a.kc * (NO / 8); i += M_THREADS) {
        const int r = i / (NO / 8), m = i % (NO / 8);
        cp_async16(wi + r * L.ldwi + 8 * m,
                   a.win + (size_t)(kb + r) * ldw + j * NO + 8 * m, true);
      }
      if (kb == 0)
        for (int i = tid; i < NG * (C / 8); i += M_THREADS) {
          const int r = i / (C / 8), m = i % (C / 8);
          cp_async16(wo + r * L.ldwo + 8 * m,
                     a.wout + ((size_t)j * NG + r) * C + 8 * m, true);
        }
      cp_async_wait_all();
      __syncthreads();
      for (int i = warp; i < (L.P4p / 16) * 2; i += M_WARPS) {
        const int mi = i / 2, ni = i % 2;
        float* uptr = uf + mi * 16 * L.ldu + ni * 16;
        FragC acc;
        if (kb == 0)
          wmma::fill_fragment(acc, 0.f);
        else
          wmma::load_matrix_sync(acc, uptr, L.ldu, wmma::mem_row_major);
        for (int k = 0; k < a.kc; k += 16) {
          FragA fa;
          FragB fb;
          wmma::load_matrix_sync(fa, ys + mi * 16 * L.ldy + k, L.ldy);
          wmma::load_matrix_sync(fb, wi + k * L.ldwi + ni * 16, L.ldwi);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(uptr, acc, L.ldu, wmma::mem_row_major);
      }
    }
    __syncthreads();
    // ub = bf16(u + b_in), zero outside the image (torch zero-pads u)
    for (int i = tid; i < L.P4p * NO; i += M_THREADS) {
      const int p = i / NO, col = i % NO;
      const int gr = hl.r0 - HALO4 + p / C4, gc = hl.c0 - HALO4 + p % C4;
      const float val = uf[p * L.ldu + col] + (a.bin ? a.bin[j * NO + col] : 0.f);
      ub[p * L.ldub + col] =
          f2bf(p < L.P4 && hl.inside(gr, gc) ? val : 0.f);
    }
    __syncthreads();
    if (a.meta[2 * j] == 3)
      msfn_stage1<3>(a, L, hl, ub, d, j, warp, lane);
    else
      msfn_stage1<5>(a, L, hl, ub, d, j, warp, lane);
    __syncthreads();
    if (a.meta[2 * j + 1] == 3)
      msfn_stage2<3>(a, L, hl, d, s2, j, warp, lane);
    else
      msfn_stage2<5>(a, L, hl, d, s2, j, warp, lane);
    __syncthreads();
    // oacc[npix x C] += s2[npix x NG] @ wout[chunk j rows, :]
    const int no = C / 16;
    for (int i = warp; i < (L.npix / 16) * no; i += M_WARPS) {
      const int mi = i / no, ni = i % no;
      float* optr = oacc + mi * 16 * L.ldo + ni * 16;
      FragC acc;
      wmma::load_matrix_sync(acc, optr, L.ldo, wmma::mem_row_major);
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, s2 + mi * 16 * L.lds, L.lds);
      wmma::load_matrix_sync(fb, wo + ni * 16, L.ldwo);
      wmma::mma_sync(acc, fa, fb, acc);
      wmma::store_matrix_sync(optr, acc, L.ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  const size_t plane = (size_t)gridDim.y * a.H * a.W * C;
  for (int q = warp; q < L.npix; q += M_WARPS) {
    const int gr = hl.r0 + q / TILE_W, gc = hl.c0 + q % TILE_W;
    if (!hl.inside(gr, gc)) continue;
    const size_t off = img + ((size_t)gr * a.W + gc) * C;
    const float* src = oacc + q * L.ldo;
    if (a.split == 1) {
      for (int c = lane; c < C; c += 32) a.out[off + c] = f2bf(src[c]);
    } else {
      float* dst = a.part + z * plane + off;
      for (int c = lane; c < C; c += 32) dst[c] = src[c];
    }
  }
}

// out = bf16(sum of the `split` partials), in a fixed order.
__global__ void msfn_reduce_kernel(const float* part, bf16* out, size_t n,
                                   int split) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < split; ++z) v += part[z * n + i];
    out[i] = f2bf(v);
  }
}

}  // namespace irk

extern "C" {

// Dynamic shared memory one block of the step-2 kernel needs.
int ir_drs_apply_msfn_smem(int C, int th, int kc) {
  return static_cast<int>(irk::MainSmem(C, th, kc).total);
}

// Launches both steps on `stream`: `y` (bf16) and `res` (fp32) are
// (B, H, W, C) scratch the caller allocates. `nch` chunks of 16 groups,
// tile height `th`, y staged `kc` channels at a time (kc == C: resident),
// each tile's chunks split over `split` blocks; with split > 1, `part` is
// (split, B, H, W, C) fp32 scratch and a third launch sums it into `out`.
// Returns cudaGetLastError().
int ir_drs_apply_msfn(const void* v, const void* x, const void* atw,
                      const void* bp, const void* ln_w, const void* ln_b,
                      const void* bo, void* y, void* res, const void* win,
                      const void* bin, const void* w1, const void* b1,
                      const void* w2, const void* b2, const void* wout,
                      const void* meta, void* out, void* part, int B, int H,
                      int W, int C, int nch, int th, int kc, int split,
                      float eps, void* stream) {
  using namespace irk;
  const PreSmem P(C);
  const MainSmem L(C, th, kc);
  if (L.total > static_cast<size_t>(SMEM_LIMIT) ||
      P.total > static_cast<size_t>(SMEM_LIMIT) || C % 16 || kc % 16 ||
      C % kc || split < 1 || split > nch || (split > 1 && !part))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      msfn_pre_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P.total));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(msfn_main_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(L.total));
  if (e != cudaSuccess) return e;
  PreArgs pa{static_cast<const bf16*>(v), static_cast<const bf16*>(x),
             static_cast<const bf16*>(atw), static_cast<const float*>(bp),
             static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
             static_cast<const float*>(bo), static_cast<bf16*>(y),
             static_cast<float*>(res), H * W, C, eps};
  msfn_pre_kernel<<<dim3((H * W + PRE_PIX - 1) / PRE_PIX, B), M_THREADS,
                    P.total, s>>>(pa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  MainArgs ma{static_cast<const bf16*>(y), static_cast<const float*>(res),
              static_cast<const bf16*>(win), static_cast<const float*>(bin),
              static_cast<const float*>(w1), static_cast<const float*>(b1),
              static_cast<const float*>(w2), static_cast<const float*>(b2),
              static_cast<const bf16*>(wout), static_cast<const int*>(meta),
              static_cast<bf16*>(out), static_cast<float*>(part), H, W, C,
              nch, th, kc, tiles_w, split};
  msfn_main_kernel<<<dim3(tiles, B, split), M_THREADS, L.total, s>>>(ma);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return e;
  const size_t n = (size_t)B * H * W * C;
  msfn_reduce_kernel<<<1024, 256, 0, s>>>(static_cast<const float*>(part),
                                          static_cast<bf16*>(out), n, split);
  return cudaGetLastError();
}

}  // extern "C"
