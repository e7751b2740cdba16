// Pass 2 of the DRSformer TransformerBlock: attention apply + residual, LN2,
// and the whole mixed-scale FFN (MSFN) + residual.
//
// Replaces the TPU kernel image_restoration_tpu/kernels/drs_block_pallas.py
// `_apply_msfn_kernel`. Two launches on one stream (three with a split):
//
// 1. msfn_pre_kernel, per PRE_PIX pixels (no halo):
//      ao  = x + v @ (A^T W_proj) + b_proj        (fp32)
//      u   = bf16(bf16(LN2(ao)) @ W_in + b_in)   -> device memory (U wide)
//      res = ao + b_out                           -> device memory (fp32)
// 2. msfn_main_kernel, per output tile of th x 16 pixels, with a 4-pixel
//    halo (a 5x5 stage-1 bank followed by a 5x5 stage-2 bank):
//      for each chunk of 16 stage-2 groups (kernels/drs_block.py
//      msfn_chunks; one path, one stage-1 bank size per chunk):
//        d  = bf16(relu(dw_k1(u) + b1))               on the halo-2 tile,
//             zero outside the image
//        s  = bf16(relu(dw_k2(d_A) + dw_k2(d_B) + b2)) on the tile
//        acc += s @ W_out[chunk groups, :]            (fp32, registers)
//      out = bf16(acc), acc starting from res.
// Products take bf16 operands and accumulate in fp32 on the tensor cores
// (mma.sync m16n8k16, operands by ldmatrix); taps are fp32 on bf16 inputs.
// The rounding points are the TPU kernel's (its _BF16_STORE default).
//
// u is stored in its natural channel order, each path's H channels padded
// to Hp = a multiple of 8 (U = 2 Hp, 2 U bytes a pixel), so every 8-channel
// segment is one 16-byte copy. A chunk's 32 operands are 32 u channels:
// consecutive, except in the first "rest" chunk of each path with an odd H,
// whose first operand (d3[H-1], its 3x3 taps zero-padded to 5x5) precedes
// channels 0..30 (kernels/drs_block.py msfn_chunks). A chunk therefore
// stages at most NSEGU = 5 segments a pixel (5 for each "rest" chunk of an
// odd H, 4 otherwise), and a per-chunk table gives each operand's column
// among them (kernels/drs_block.py msfn_u_tables). u in operand order
// would need no table but twice the bytes (each channel feeds a d3 and a d5
// operand); in natural order it is 1 KB a pixel at C = 96 (268 MB at
// 512x512, written once, read back by each chunk over a halo-4 tile, mostly
// from L2) and 4 KB at C = 384 (17 MB at 64x64).
//
// What bounds it on an H100. Its roofline bound (chip_smoke.py
// bound_drs_apply_msfn) is the fp32 taps: 2 x 34 per hidden channel and
// pixel. In fact a chunk's stages are short and serial, so latency bounds
// them (PERF.md has the times and the ranking of the stages). The design:
// * the project_in product runs once per pixel and u channel, in the pre
//   kernel, and not on the halo-4 tile of every chunk (3-4.5x) for each of
//   a channel's two operands (2x);
// * nothing in a chunk waits on device memory: the block's chunk records
//   are staged once, and cp.async brings chunk j + 1's u segments (zeros
//   outside the image, so the taps need no test), fp32 table and W_out rows
//   while chunk j runs;
// * each warp keeps its output fragments in registers over the chunk loop
//   and adds s @ W_out to them on mma.sync, so no accumulator crosses shared
//   memory; the bf16 result leaves 16 bytes a store;
// * the taps walk row segments (stage 1 two output rows an item), so one
//   load feeds several outputs;
// * 8 or 16 warps and the tile rows by width (kernels/drs_block.py): 8
//   warps give two blocks an SM at C <= 96. Where the tiles are fewer than
//   two per SM (C >= 192) each tile's chunks are split over several blocks,
//   whose fp32 partials msfn_reduce_kernel sums in a fixed order
//   (deterministic, no atomics).
// Shared memory a block at kernels/drs_block.py's settings: C = 48, th 8:
// 104,576 bytes; C = 96, th 8: 108,672; C = 192, th 8: 116,864; C = 384,
// th 4: 112,512. ptxas gives the main kernel 128 registers a thread at both
// warp counts, with 8 to 56 bytes of spill.
#include "common.cuh"

namespace irk {

constexpr int NG = 16;       // stage-2 groups per chunk
constexpr int NO = 2 * NG;   // operands (u channels) per chunk; one per lane
constexpr int HALO4 = 4;
constexpr int C4 = TILE_W + 2 * HALO4;  // halo-4 tile columns (24)
constexpr int C2 = TILE_W + 4;          // halo-2 tile columns (20)
constexpr int NSEGU = 5;                // u segments (8 channels) a chunk
constexpr int LDU = NSEGU * 8;          // staged u columns a pixel
// A chunk's record in the table `ctab` (ints): k1, k2, the u channel of
// each of its NSEGU segments (-1: none), one unused, then the 32 operands'
// columns in the staged u tile as bytes.
constexpr int CT_INTS = 16;
// A chunk's fp32 table, staged one chunk ahead: stage-1 taps (NO x 25) and
// biases (NO), stage-2 taps (NG x 2 x 25) and biases (NG). Zeros where a
// bias is absent.
constexpr int T_W1 = 0, T_B1 = NO * 25, T_W2 = T_B1 + NO, T_B2 = T_W2 + NG * 50,
              T_LEN = T_B2 + NG;

// ------------------------------------------------------------- step 1 ---

constexpr int PRE_PIX = 32;  // pixels a block
constexpr int P_WARPS = 8;
constexpr int P_THREADS = P_WARPS * 32;
constexpr int PN = 64;  // weight columns a staged slice

struct PreSmem {
  int ldv, lda, ldw, ldo;
  size_t off_v, off_a, off_w, off_b, off_o, total;
  __host__ __device__ PreSmem(int C) {
    ldv = C + 8;
    lda = C + 4;
    ldw = PN + 8;
    ldo = PN + 8;
    off_v = 0;  // v's tile, then y's
    off_a = align128(sizeof(bf16) * PRE_PIX * ldv);
    off_w = align128(off_a + sizeof(float) * PRE_PIX * lda);
    off_b = align128(off_w + sizeof(bf16) * 2 * C * ldw);  // two slices
    off_o = align128(off_b + sizeof(float) * 2 * PN);      // their b_in
    total = align128(off_o + sizeof(bf16) * PRE_PIX * ldo);
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
  const bf16* win;    // (C, U) project_in, paths padded to Hp columns
  const float* bin;   // (U) or null
  bf16* u;            // (B, HW, U)
  float* res;         // (B, HW, C)
  int HW, C, U;
  float eps;
};

// The block's PRE_PIX x ns product of the K-deep tile A (smem, row-major)
// and a staged K x ns slice B, 16 x 16 a warp; epi(row, col, v0, v1)
// takes the values of columns col, col + 1 of each row a lane holds.
template <typename Epi>
__device__ __forceinline__ void pre_gemm(const bf16* A, int lda,
                                         const bf16* B, int ldb, int K,
                                         int ns, int warp, int lane, Epi epi) {
  const int nt = ns / 16;
  for (int t = warp; t < (PRE_PIX / 16) * nt; t += P_WARPS) {
    const int mi = t / nt, ni = t % nt;
    float acc[2][4] = {};
    for (int k = 0; k < K; k += 16) {
      unsigned fa[4], fb[4];
      load_a_16x16(fa, A + mi * 16 * lda + k, lda, lane);
      load_b_16x16(fb, B + k * ldb + ni * 16, ldb, lane);
      mma_16816(acc[0], fa, fb[0], fb[1]);
      mma_16816(acc[1], fa, fb[2], fb[3]);
    }
    const int r = mi * 16 + lane / 4, c = ni * 16 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      epi(r, c + 8 * h, acc[h][0], acc[h][1]);
      epi(r + 8, c + 8 * h, acc[h][2], acc[h][3]);
    }
  }
}

// The block's PRE_PIX pixels: ao (v @ atw in column slices), LN2, res, then
// u in column slices. Weight slices (and b_in's) are staged by cp.async one
// slice ahead; u leaves through shared memory, 16 bytes a copy.
__global__ void __launch_bounds__(P_THREADS) msfn_pre_kernel(PreArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PreSmem L(a.C);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.off_v);
  float* ao = reinterpret_cast<float*>(smem + L.off_a);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.off_w);
  float* bs = reinterpret_cast<float*>(smem + L.off_b);
  bf16* us = reinterpret_cast<bf16*>(smem + L.off_o);
  const int C = a.C, b = blockIdx.y, p0 = blockIdx.x * PRE_PIX;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t img = (size_t)b * a.HW * C;
  const bf16* atw = a.atw + (size_t)b * C * C;
  const int s1 = (C + PN - 1) / PN, s2 = (a.U + PN - 1) / PN;

  // slice i: columns [n0, n0 + ns) of atw (i < s1) or of win
  auto slice = [&](int i, int& n0, int& ns) {
    const int total = i < s1 ? C : a.U;
    n0 = (i < s1 ? i : i - s1) * PN;
    ns = min(PN, total - n0);
  };
  auto stage = [&](int i) {
    int n0, ns;
    slice(i, n0, ns);
    const bf16* src = i < s1 ? atw : a.win;
    const int ld = i < s1 ? C : a.U;
    bf16* dst = ws + (i & 1) * C * L.ldw;
    const int per = ns / 8;
    for (int e = tid; e < C * per; e += P_THREADS) {
      const int k = e / per, m = e % per;
      cp_async16(dst + k * L.ldw + 8 * m, src + (size_t)k * ld + n0 + 8 * m,
                 true);
    }
    if (i >= s1)
      for (int e = tid; e < ns / 4; e += P_THREADS)
        cp_async16(bs + (i & 1) * PN + 4 * e,
                   a.bin ? static_cast<const void*>(a.bin + n0 + 4 * e) : src,
                   a.bin != nullptr);
  };

  for (int e = tid; e < PRE_PIX * (C / 8); e += P_THREADS) {
    const int r = e / (C / 8), m = e % (C / 8);
    const bool in = p0 + r < a.HW;
    cp_async16(vs + r * L.ldv + 8 * m,
               in ? a.v + img + (size_t)(p0 + r) * C + 8 * m : a.v, in);
  }
  stage(0);
  cp_async_commit();

  for (int i = 0; i < s1 + s2; ++i) {
    cp_async_wait_group<0>();
    __syncthreads();  // slice i has landed; slice i - 1's readers are done
    if (i + 1 < s1 + s2) stage(i + 1);
    cp_async_commit();
    int n0, ns;
    slice(i, n0, ns);
    const bf16* wsl = ws + (i & 1) * C * L.ldw;
    if (i < s1) {
      pre_gemm(vs, L.ldv, wsl, L.ldw, C, ns, warp, lane,
               [&](int r, int c, float v0, float v1) {
                 *reinterpret_cast<float2*>(ao + r * L.lda + n0 + c) =
                     make_float2(v0, v1);
               });
      continue;
    }
    if (i == s1) {
      // ao += b_proj + x; y = bf16(LN2(ao)) over v's tile; res = ao + b_out
      for (int r = warp; r < PRE_PIX; r += P_WARPS) {
        const int p = p0 + r;
        if (p >= a.HW) continue;  // y stays 0 there (v was staged as 0)
        const size_t off = img + (size_t)p * C;
        float* arow = ao + r * L.lda;
        for (int c = lane; c < C; c += 32)
          arow[c] += (a.bp ? a.bp[c] : 0.f) + bf2f(a.x[off + c]);
        __syncwarp();
        warp_layernorm([&](int c) { return arow[c]; }, C, a.eps, a.ln_w,
                       a.ln_b, vs + r * L.ldv, lane);
        for (int c = lane; c < C; c += 32)
          a.res[off + c] = arow[c] + (a.bo ? a.bo[c] : 0.f);
      }
      __syncthreads();
    }
    const float* bsl = bs + (i & 1) * PN;
    pre_gemm(vs, L.ldv, wsl, L.ldw, C, ns, warp, lane,
             [&](int r, int c, float v0, float v1) {
               *reinterpret_cast<__nv_bfloat162*>(us + r * L.ldo + c) =
                   __floats2bfloat162_rn(v0 + bsl[c], v1 + bsl[c + 1]);
             });
    __syncthreads();
    const int per = ns / 8;
    for (int e = tid; e < PRE_PIX * per; e += P_THREADS) {
      const int r = e / per, m = e % per;
      if (p0 + r < a.HW)
        *reinterpret_cast<uint4*>(a.u + ((size_t)b * a.HW + p0 + r) * a.U +
                                  n0 + 8 * m) =
            *reinterpret_cast<const uint4*>(us + r * L.ldo + 8 * m);
    }
  }
}

// ------------------------------------------------------------- step 2 ---

// The main kernel is built for blocks of 8 warps (two blocks an SM, 128
// registers a thread) and of 16 (one block an SM); the host picks by width.
// Output fragments (16 x 8) a warp owns: the smallest instantiated count
// that holds the tile's th * C / 8, 0 when none does. Either way a thread
// has 128 registers, and the taps need most of them: 12 fragments (48
// accumulators) spill 56 bytes, 24 would spill 840.
__host__ __device__ inline int msfn_frags(int C, int th, int warps) {
  if (warps != 8 && warps != 16) return 0;
  const int need = (th * (C / 8) + warps - 1) / warps;
  const int have[] = {3, 6, 12};
  for (int nf : have)
    if (need <= nf) return nf;
  return 0;
}

// Shared memory of a tile: the chunk records, two sets of chunk buffers (u
// segments, fp32 table, W_out rows), d and s. The u buffers take the bf16
// output tile (ldo) at the end.
struct MainSmem {
  int P4, P2, npix, ldd, lds, ldo, ldwo;
  size_t off_ct, off_u, off_tb, off_wo, off_d, off_s, total;
  __host__ __device__ MainSmem(int C, int th, int nch) {
    P4 = (th + 2 * HALO4) * C4;
    P2 = (th + 4) * C2;
    npix = th * TILE_W;
    ldd = NO + 8;
    lds = NG + 8;
    ldo = C + 8;
    ldwo = C + 8;
    const size_t ubytes = sizeof(bf16) * 2 * P4 * LDU;
    const size_t obytes = sizeof(bf16) * npix * ldo;
    size_t o = 0;
    off_ct = o; o = align128(o + sizeof(int) * CT_INTS * nch);
    off_u = o; o = align128(o + (ubytes > obytes ? ubytes : obytes));
    off_tb = o; o = align128(o + sizeof(float) * 2 * T_LEN);
    off_wo = o; o = align128(o + sizeof(bf16) * 2 * NG * ldwo);
    off_d = o; o = align128(o + sizeof(bf16) * P2 * ldd);
    off_s = o; o = align128(o + sizeof(bf16) * npix * lds);
    total = o;
  }
};

struct MainArgs {
  const bf16* u;      // (B, H, W, U)
  const float* res;   // (B, H, W, C)
  const float* w1;    // (nch * NO, 25) stage-1 taps, t * k1 + s
  const float* b1;    // (nch * NO) or null
  const float* w2;    // (nch * NG, 2, 25) stage-2 taps of operands A, B
  const float* b2;    // (nch * NG) or null
  const bf16* wout;   // (nch * NG, C) gathered project_out rows
  const int* ctab;    // (nch, CT_INTS) chunk records
  bf16* out;          // (B, H, W, C) when split == 1
  float* part;        // (split, B, H, W, C) partial sums when split > 1
  int H, W, C, U, nch, th, tiles_w, split;
};

// The tap loops walk rows in segments: each u (or d) value a thread loads
// feeds every output of its segment that its taps reach, so a k-tap row
// costs SEG + k - 1 shared-memory loads for SEG outputs instead of k * SEG.
// The fp32 sums still run over the taps in row-major order.
constexpr int SEG1 = 5;  // stage 1: 20 halo-2 columns = 4 segments a row
constexpr int SEG2 = 4;  // stage 2: 16 output columns = 4 segments a row

// d[p][lane] over the halo-2 tile from the staged u tile; lane's operand is
// column `col` of it. An item is two output rows of SEG1 pixels: each u
// row it loads feeds both, so K + 1 rows of SEG1 + K - 1 loads serve
// 2 SEG1 outputs.
template <int K, int NW>
__device__ void msfn_stage1(const MainSmem& L, const Halo& hl,
                            const bf16* ub, bf16* d, const float* tb, int col,
                            int warp, int lane) {
  constexpr int R = K / 2, NSEG = C2 / SEG1;
  const int rows = L.P2 / C2;
  float wt[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wt[t] = tb[T_W1 + lane * 25 + t];
  const float bias = tb[T_B1 + lane];
  for (int item = warp; item < (rows + 1) / 2 * NSEG; item += NW) {
    const int i = item / NSEG * 2, j0 = (item % NSEG) * SEG1;
    const bool two = i + 1 < rows;
    float acc[2][SEG1];
#pragma unroll
    for (int e = 0; e < SEG1; ++e) acc[0][e] = acc[1][e] = 0.f;
#pragma unroll
    for (int t = 0; t <= K; ++t) {
      if (t == K && !two) break;
      const bf16* src = ub + ((i + 2 - R + t) * C4 + j0 + 2 - R) * LDU + col;
#pragma unroll
      for (int c = 0; c < SEG1 + K - 1; ++c) {
        const float v = bf2f(src[c * LDU]);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int s = 0; s < K; ++s)
            if (t - r >= 0 && t - r < K && c - s >= 0 && c - s < SEG1)
              acc[r][c - s] += v * wt[(t - r) * K + s];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < SEG1; ++e) {
        const bool in = hl.inside(hl.r0 - 2 + i + r, hl.c0 - 2 + j0 + e);
        if (r == 0 || two)
          d[((i + r) * C2 + j0 + e) * L.ldd + lane] =
              f2bf(in ? fmaxf(acc[r][e] + bias, 0.f) : 0.f);
      }
  }
}

// s[q][g] over the output tile from the operand pair (2g, 2g + 1) of d,
// read as one bf16 pair; a warp runs two streams of 16 lanes.
template <int K, int NW>
__device__ void msfn_stage2(const MainSmem& L, const Halo& hl,
                            const bf16* d, bf16* s, const float* tb,
                            int warp, int lane) {
  constexpr int R = K / 2, NSEG = TILE_W / SEG2;
  const int g = lane % NG, stream = warp * 2 + lane / NG;
  const float* w = tb + T_W2 + g * 50;
  float wa[K * K], wb[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    wa[t] = w[t];
    wb[t] = w[25 + t];
  }
  const float bias = tb[T_B2 + g];
  for (int item = stream; item < (L.npix / TILE_W) * NSEG;
       item += 2 * NW) {
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

// Starts the copies of chunk j (record cj) into one buffer set: its u
// segments over the halo-4 tile (zeros outside the image), its fp32 table
// and its W_out rows; 16 bytes a copy, absent biases as zeros.
template <int NW>
__device__ void msfn_stage_chunk(const MainArgs& a, const MainSmem& L,
                                 const Halo& hl, const int* cj, int j,
                                 const bf16* ug, bf16* ub, float* tb,
                                 bf16* wo, int tid) {
  for (int i = tid; i < L.P4 * NSEGU; i += NW * 32) {
    const int p = i / NSEGU, sg = i % NSEGU;
    const int seg = cj[2 + sg];
    if (seg < 0) continue;
    const int gr = hl.r0 - HALO4 + p / C4, gc = hl.c0 - HALO4 + p % C4;
    const bool in = hl.inside(gr, gc);
    cp_async16(ub + p * LDU + 8 * sg,
               in ? ug + ((size_t)gr * a.W + gc) * a.U + seg : ug, in);
  }
  for (int i = tid; i < T_LEN / 4; i += NW * 32) {
    const int e = 4 * i;
    const float* src;
    if (e < T_B1) src = a.w1 + (size_t)j * NO * 25 + e;
    else if (e < T_W2) src = a.b1 ? a.b1 + j * NO + e - T_B1 : nullptr;
    else if (e < T_B2) src = a.w2 + (size_t)j * NG * 50 + e - T_W2;
    else src = a.b2 ? a.b2 + j * NG + e - T_B2 : nullptr;
    cp_async16(tb + e, src ? src : a.w1, src != nullptr);
  }
  for (int i = tid; i < NG * (a.C / 8); i += NW * 32) {
    const int r = i / (a.C / 8), m = i % (a.C / 8);
    cp_async16(wo + r * L.ldwo + 8 * m,
               a.wout + ((size_t)j * NG + r) * a.C + 8 * m, true);
  }
}

// Two 8 x 8 bf16 matrices from shared memory, transposed (ldmatrix .x2):
// lanes 0-15 give the addresses of rows 0-15; r[0], r[1] as the two B
// registers of mma_16816 for a 16 (k) x 8 (n) tile stored k-major.
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

// Block (t, b, z) takes output tile t of image b and the z-th of `split`
// equal runs of chunks. With split > 1 each block writes its fp32 partial
// (z == 0 carrying the residual terms) and msfn_reduce_kernel sums them.
// Chunk j + 1's copies fly while chunk j's taps and product run. Warp w
// keeps output fragments w NF .. w NF + NF - 1 of the tile's (th, C / 8)
// grid of 16 x 8 fragments in registers over the whole chunk loop (an
// m-tile is a tile row: TILE_W = 16 pixels).
template <int NF, int NW>
__global__ void __launch_bounds__(NW * 32, 16 / NW)
    msfn_main_kernel(MainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MainSmem L(a.C, a.th, a.nch);
  int* ct = reinterpret_cast<int*>(smem + L.off_ct);
  bf16* ub0 = reinterpret_cast<bf16*>(smem + L.off_u);
  float* tb0 = reinterpret_cast<float*>(smem + L.off_tb);
  bf16* wo0 = reinterpret_cast<bf16*>(smem + L.off_wo);
  bf16* d = reinterpret_cast<bf16*>(smem + L.off_d);
  bf16* s2 = reinterpret_cast<bf16*>(smem + L.off_s);

  const int C = a.C, b = blockIdx.y, t = blockIdx.x, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Halo hl{(t / a.tiles_w) * a.th, (t % a.tiles_w) * TILE_W, a.H, a.W};
  const size_t img = (size_t)b * a.H * a.W * C;
  const bf16* ug = a.u + (size_t)b * a.H * a.W * a.U;
  const int j0 = z * a.nch / a.split, j1 = (z + 1) * a.nch / a.split;

  // the records of this block's chunks
  for (int i = tid; i < (j1 - j0) * CT_INTS / 4; i += NW * 32)
    cp_async16(ct + 4 * i, a.ctab + j0 * CT_INTS + 4 * i, true);
  cp_async_commit();
  // acc[f]: fragment warp * NF + f, rows (pixels) lane / 4 and + 8 of tile
  // row mi, columns 2 (lane % 4), + 1 of its 8; it starts from both
  // residual terms, ao + b_out
  const int n8 = C / 8, nfrag = a.th * n8;
  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int i = warp * NF + f;
    const int gr = hl.r0 + i / n8, gc = hl.c0 + lane / 4;
    const int c = (i % n8) * 8 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 r0 = make_float2(0.f, 0.f);
      if (i < nfrag && z == 0 && hl.inside(gr, gc + 8 * h))
        r0 = *reinterpret_cast<const float2*>(
            a.res + img + ((size_t)gr * a.W + gc + 8 * h) * C + c);
      acc[f][2 * h] = r0.x;
      acc[f][2 * h + 1] = r0.y;
    }
  }
  cp_async_wait_group<0>();
  __syncthreads();
  msfn_stage_chunk<NW>(a, L, hl, ct, j0, ug, ub0, tb0, wo0, tid);
  cp_async_commit();

  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    const int* cj = ct + (j - j0) * CT_INTS;
    const bf16* ub = ub0 + buf * L.P4 * LDU;
    const float* tb = tb0 + buf * T_LEN;
    const bf16* wo = wo0 + buf * NG * L.ldwo;
    cp_async_wait_group<0>();
    __syncthreads();  // chunk j has landed; chunk j - 1's readers are done
    if (j + 1 < j1)
      msfn_stage_chunk<NW>(a, L, hl, cj + CT_INTS, j + 1, ug,
                       ub0 + (buf ^ 1) * L.P4 * LDU, tb0 + (buf ^ 1) * T_LEN,
                       wo0 + (buf ^ 1) * NG * L.ldwo, tid);
    cp_async_commit();
    const int col = reinterpret_cast<const unsigned char*>(cj + 8)[lane];
    if (cj[0] == 3)
      msfn_stage1<3, NW>(L, hl, ub, d, tb, col, warp, lane);
    else
      msfn_stage1<5, NW>(L, hl, ub, d, tb, col, warp, lane);
    __syncthreads();
    if (cj[1] == 3)
      msfn_stage2<3, NW>(L, hl, d, s2, tb, warp, lane);
    else
      msfn_stage2<5, NW>(L, hl, d, s2, tb, warp, lane);
    __syncthreads();
    // acc += s2[tile row x NG] @ wo[NG x 8 columns], one k16 step; the A
    // fragment is loaded once for a warp's run of fragments in one row
    int mi_a = -1;
    unsigned fa[4];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int i = warp * NF + f;
      if (i >= nfrag) break;
      if (i / n8 != mi_a) {
        mi_a = i / n8;
        load_a_16x16(fa, s2 + mi_a * 16 * L.lds, L.lds, lane);
      }
      unsigned fb[2];
      ldmatrix_x2_trans(fb, wo + (lane % 16) * L.ldwo + (i % n8) * 8);
      mma_16816(acc[f], fa, fb[0], fb[1]);
    }
  }

  if (a.split > 1) {  // fp32 partials, 8 bytes a store
    float* dst = a.part + (size_t)z * gridDim.y * a.H * a.W * C + img;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int i = warp * NF + f;
      const int gr = hl.r0 + i / n8, gc = hl.c0 + lane / 4;
      const int c = (i % n8) * 8 + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (i < nfrag && hl.inside(gr, gc + 8 * h))
          *reinterpret_cast<float2*>(
              dst + ((size_t)gr * a.W + gc + 8 * h) * C + c) =
              make_float2(acc[f][2 * h], acc[f][2 * h + 1]);
    }
    return;
  }
  // bf16 out through the u buffers (free once the last chunk's copies have
  // landed and been read), 16 bytes a store
  bf16* ot = ub0;
  __syncthreads();
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int i = warp * NF + f;
    if (i >= nfrag) break;
    const int q = (i / n8) * TILE_W + lane / 4;
    const int c = (i % n8) * 8 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(ot + (q + 8 * h) * L.ldo + c) =
          __floats2bfloat162_rn(acc[f][2 * h], acc[f][2 * h + 1]);
  }
  __syncthreads();
  for (int e = tid; e < L.npix * n8; e += NW * 32) {
    const int q = e / n8, m = e % n8;
    const int gr = hl.r0 + q / TILE_W, gc = hl.c0 + q % TILE_W;
    if (hl.inside(gr, gc))
      *reinterpret_cast<uint4*>(a.out + img + ((size_t)gr * a.W + gc) * C +
                                8 * m) =
          *reinterpret_cast<const uint4*>(ot + q * L.ldo + 8 * m);
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

// Dynamic shared memory one block of the step-2 kernel needs; 1 << 30 (no
// card has it) when no build of the kernel holds the tile's fragments.
int ir_drs_apply_msfn_smem(int C, int th, int warps, int nch) {
  if (!irk::msfn_frags(C, th, warps)) return 1 << 30;
  return static_cast<int>(irk::MainSmem(C, th, nch).total);
}

// Launches both steps on `stream`: `u` (bf16, (B, H, W, U)) and `res`
// (fp32, (B, H, W, C)) are scratch the caller allocates. `nch` chunks of 16
// groups described by `ctab`, tile height `th`, blocks of `warps` warps
// (8 or 16), each tile's chunks split
// over `split` blocks; with split > 1, `part` is (split, B, H, W, C) fp32
// scratch and a third launch sums it into `out`. Returns cudaGetLastError().
int ir_drs_apply_msfn(const void* v, const void* x, const void* atw,
                      const void* bp, const void* ln_w, const void* ln_b,
                      const void* bo, void* u, void* res, const void* win,
                      const void* bin, const void* w1, const void* b1,
                      const void* w2, const void* b2, const void* wout,
                      const void* ctab, void* out, void* part, int B, int H,
                      int W, int C, int U, int nch, int th, int warps,
                      int split, float eps, void* stream) {
  using namespace irk;
  const PreSmem P(C);
  const MainSmem L(C, th, nch);
  if (L.total > static_cast<size_t>(SMEM_LIMIT) ||
      P.total > static_cast<size_t>(SMEM_LIMIT) || C % 16 || U % 16 ||
      th < 1 || split < 1 || split > nch || (split > 1 && !part))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      msfn_pre_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P.total));
  if (e != cudaSuccess) return e;
  const int nf = msfn_frags(C, th, warps);
  void (*main_kernel)(MainArgs) = nullptr;
  if (warps == 8)
    main_kernel = nf == 3    ? msfn_main_kernel<3, 8>
                  : nf == 6  ? msfn_main_kernel<6, 8>
                  : nf == 12 ? msfn_main_kernel<12, 8>
                             : nullptr;
  else if (warps == 16)
    main_kernel = nf == 3    ? msfn_main_kernel<3, 16>
                  : nf == 6  ? msfn_main_kernel<6, 16>
                  : nf == 12 ? msfn_main_kernel<12, 16>
                             : nullptr;
  if (!main_kernel) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(main_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(L.total));
  if (e != cudaSuccess) return e;
  PreArgs pa{static_cast<const bf16*>(v), static_cast<const bf16*>(x),
             static_cast<const bf16*>(atw), static_cast<const float*>(bp),
             static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
             static_cast<const float*>(bo), static_cast<const bf16*>(win),
             static_cast<const float*>(bin), static_cast<bf16*>(u),
             static_cast<float*>(res), H * W, C, U, eps};
  msfn_pre_kernel<<<dim3((H * W + PRE_PIX - 1) / PRE_PIX, B), P_THREADS,
                    P.total, s>>>(pa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  MainArgs ma{static_cast<const bf16*>(u), static_cast<const float*>(res),
              static_cast<const float*>(w1), static_cast<const float*>(b1),
              static_cast<const float*>(w2), static_cast<const float*>(b2),
              static_cast<const bf16*>(wout), static_cast<const int*>(ctab),
              static_cast<bf16*>(out), static_cast<float*>(part), H, W, C, U,
              nch, th, tiles_w, split};
  main_kernel<<<dim3(tiles, B, split), warps * 32, L.total, s>>>(ma);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return e;
  const size_t n = (size_t)B * H * W * C;
  msfn_reduce_kernel<<<1024, 256, 0, s>>>(static_cast<const float*>(part),
                                          static_cast<bf16*>(out), n, split);
  return cudaGetLastError();
}

}  // extern "C"
