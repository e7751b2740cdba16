// One MEFC op-mixture step of DRSformer's Subnet, one tile of output per
// block: out = relu(relu(sum_op op(x) @ M_op) + x).
//
// Replaces the TPU kernel image_restoration_tpu/kernels/mefc_pallas.py
// `_step_kernel`. The eight ops, on the tile's x with a 6-pixel halo
// (SepConv7's 3 + 3, and the dilation-2 7x7's 6):
//   SepConv k in 1,3,5,7: a1 = bf16(dw_k(x)) on the tile + (k/2) halo;
//                         t1 = bf16(relu(a1 @ W1)), zero outside the image
//                         (torch zero-pads t1 for the second dw);
//                         a2 = bf16(dw_k(t1)) on the tile
//   DilConv k in 3,5,7:   a2 = bf16(dilation-2 dw_k(x))
//   AvgPool 3x3:          a2 = bf16(sum / in-image count)
//   each: acc += a2 @ M_op, M_op the per-batch fold of the op's last 1x1,
//   its block of the concat 1x1 and its mix weight (kernels/mefc.py
//   fold_step). Then out = bf16(relu(relu(acc) + x)).
// Products take bf16 operands and accumulate in fp32 on the tensor cores
// (mma.sync m16n8k16, operands by ldmatrix); taps are fp32 on bf16 inputs.
// The rounding points are the TPU kernel's with its _F32_MIX off.
//
// What bounds it on an H100. Device-memory traffic is one read of x (with
// halo) and one write a step; the 8 op outputs, t1 and the concat never
// leave the SM. Its roofline bound (chip_smoke.py bound_mefc_step) is the
// fp32 taps: 1+9+25+49 taps twice for the SepConvs (the first time over a
// halo), 9+25+49 for the DilConvs and 9 for the pool, per channel and
// pixel. A tile runs 24 short phases in a row (four a SepConv, two a
// DilConv and the pool), so latency matters as much as work, and the
// instruction stream does too (PERF.md has the measured steps). The design:
// * every product is mma.sync from weights in shared memory: the phases
//   read their weights (an op's C x C matrix, or a tap stage's K^2 x C fp32
//   taps) from a two-slot ring that cp.async fills one phase ahead, so no
//   phase waits on device memory for them;
// * t1 = relu(a1 @ W1) is masked and rounded in registers and overwrites
//   a1 in place: one warp owns a 16-row block of the product across all its
//   columns and holds the block's a1 fragments before it stores;
// * each warp keeps its output fragments in registers over the eight M
//   products, each k step's B fragments loaded ahead of its products; the
//   epilogue adds x from the resident tile, and the bf16 result leaves 16
//   bytes a store;
// * the taps give every thread 4 channels (8-byte loads) of a row segment
//   of 4 or 8 outputs (stride-2 outputs for the dilated convs), so one load
//   feeds up to 16 multiply-adds and every lane works at C = 48; each tap
//   stage is one out-of-line function, which keeps the code small;
// * the kernel is built for C = 48 and 96 (DRSformer's Subnets), where
//   every index and offset is a constant, and for any C up to 128;
// * 16 warps a block (8 ran slower at both widths), the tile rows by
//   width (kernels/mefc.py `_MEFC_TILE_ROWS`).
// Shared memory (StepSmem): x's halo-6 tile (bf16, all C), the halo-3 tile
// of a1/t1 (later the output's staging), a2 on the tile and the two ring
// slots: 132,352 bytes at C = 48, th 8; 193,920 at C = 96, th 4.
#include "common.cuh"

namespace irk {

constexpr int HALO6 = 6;
constexpr int XC = TILE_W + 2 * HALO6;  // x tile columns (28)
constexpr int HC = TILE_W + 6;          // widest a1/t1 tile columns (22)
constexpr int KMAX = 8;                 // C / 16 the W1 product holds: C <= 128
constexpr int NPHASE = 24;
constexpr int NW = 16;                  // warps a block

struct StepSmem {
  int XP, HP, npix, ld;
  size_t rbytes, off_x, off_h, off_a, off_r, total;
  __host__ __device__ StepSmem(int C, int th) {
    // 4 pixels past the x tile, zero: stage 1's last row segment at k = 7
    // reads two of them, for outputs it does not store
    XP = (th + 2 * HALO6) * XC + 4;
    HP = round16((th + 6) * HC);
    npix = th * TILE_W;
    ld = C + 8;
    const size_t taps = sizeof(float) * 49 * C, mat = sizeof(bf16) * C * ld;
    rbytes = align128(taps > mat ? taps : mat);
    size_t o = 0;
    off_x = o; o = align128(o + sizeof(bf16) * XP * ld);
    off_h = o; o = align128(o + sizeof(bf16) * HP * ld);
    off_a = o; o = align128(o + sizeof(bf16) * npix * ld);
    off_r = o; o += 2 * rbytes;
    total = o;
  }
};

struct StepArgs {
  const bf16* x;      // (B, H, W, C)
  const bf16* w1;     // (4, C, C) SepConv inner 1x1s, (in, out)
  const float* dwa;   // (84, C) SepConv first dw taps, k = 1, 3, 5, 7
  const float* dwb;   // (84, C) SepConv second dw taps
  const float* dwd;   // (83, C) DilConv dw taps, k = 3, 5, 7
  const bf16* m;      // (B, 8, C, C) folded mix matrices, (in, out)
  bf16* out;          // (B, H, W, C)
  int H, W, C, th, tiles_w;
};

// Output fragments (16 x 8) a warp owns: the smallest built count that
// holds the tile's th * C / 8, 0 when none does.
__host__ __device__ inline int mefc_frags(int C, int th) {
  const int need = (th * (C / 8) + NW - 1) / NW;
  return need <= 3 ? 3 : need <= 6 ? 6 : 0;
}

// 4 bf16 (8 bytes) -> 4 floats.
__device__ __forceinline__ void unpack4(const uint2& u, float (&x)[4]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

// Two 8 x 8 bf16 matrices, transposed (ldmatrix .x2): lanes 0-15 give the
// addresses of rows 0-15 of a 16 (k) x 8 (n) tile stored k-major; r[0],
// r[1] are the two B registers of mma_16816.
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

// Phase ph's weights, into ring slot ph & 1 (16-byte copies): phases 0-15
// are the SepConvs (first taps, W1, second taps, M_op each), 16-21 the
// DilConvs (taps, M_op), 22 the pool (nothing) and 23 its M_op.
template <int CT>
__device__ void stage_phase(const StepArgs& a, const StepSmem& L, int ph,
                            int b, unsigned char* ring, int tid) {
  if (ph >= NPHASE) return;
  const int C = CT ? CT : a.C;
  unsigned char* dst = ring + (ph & 1) * L.rbytes;
  const bf16* mb = a.m + (size_t)b * 8 * C * C;
  const float* taps = nullptr;
  const bf16* mat = nullptr;
  int k = 0;
  if (ph < 16) {
    const int op = ph / 4, tap0 = op == 0 ? 0 : op == 1 ? 1 : op == 2 ? 10 : 35;
    k = 2 * op + 1;
    if (ph % 4 == 0) taps = a.dwa + (size_t)tap0 * C;
    else if (ph % 4 == 1) mat = a.w1 + (size_t)op * C * C;
    else if (ph % 4 == 2) taps = a.dwb + (size_t)tap0 * C;
    else mat = mb + (size_t)op * C * C;
  } else if (ph < 22) {
    const int j = (ph - 16) / 2, tap0 = j == 0 ? 0 : j == 1 ? 9 : 34;
    k = 2 * j + 3;
    if (ph % 2 == 0) taps = a.dwd + (size_t)tap0 * C;
    else mat = mb + (size_t)(4 + j) * C * C;
  } else if (ph == 23) {
    mat = mb + (size_t)7 * C * C;
  }
  if (taps)
    for (int i = tid; i < k * k * C / 4; i += NW * 32)
      cp_async16(dst + 16 * i, taps + 4 * i, true);
  if (mat) {
    bf16* ds = reinterpret_cast<bf16*>(dst);
    const int per = C / 8;
    for (int i = tid; i < C * per; i += NW * 32) {
      const int r = i / per, m = i % per;
      cp_async16(ds + r * L.ld + 8 * m, mat + (size_t)r * C + 8 * m, true);
    }
  }
}

// Starts phase ph: its weights have landed and every thread is past phase
// ph - 1; phase ph + 1's weights start to fly. Returns ph's ring slot.
template <int CT>
__device__ __forceinline__ const unsigned char* enter_phase(
    const StepArgs& a, const StepSmem& L, int ph, int b, unsigned char* ring,
    int tid) {
  cp_async_wait_group<0>();
  __syncthreads();
  stage_phase<CT>(a, L, ph + 1, b, ring, tid);
  cp_async_commit();
  return ring + (ph & 1) * L.rbytes;
}

// The four tap stages of an op: a SepConv's first taps (on x, over the
// tile + k/2 halo, into the a1/t1 tile) and second taps (on t1, into a2),
// a DilConv's dilation-2 taps and the 3x3 pool (on x, into a2).
enum TapMode { SEP1, SEP2, DIL, POOL };

// dst[(r * DCOLS + j) * ld + c] = bf16(sum_{t,s} src[((r + SO + t D) *
// SCOLS + j + SO + s D) * ld + c] * w[(t K + s) C + c]) over the stage's
// rows r and columns j; the pool sums with weight 1 and divides by the
// in-image count. A thread takes 4 channels of a row segment of SEG outputs
// (columns j0 + e, or j0 + 2e for the dilated taps), so each 8-byte load
// feeds every output of the segment its taps reach: SEG + K - 1 loads and
// K weight loads a tap row for 4 SEG K multiply-adds. Each output sums its
// taps in row-major order in fp32. SEG is 4, and 8 for the first taps at
// k = 7, whose 22 halo columns take 24 either way. One out-of-line copy a
// stage (the tap rows are not unrolled): fully unrolled and inlined at
// every call, the stages made the kernel's code several times larger and
// ran slower.
template <TapMode MODE, int K, int CT>
__device__ __noinline__ void op_taps(const bf16* src, const float* w,
                                     bf16* dst, int c_rt, int th, Halo hl,
                                     int tid) {
  constexpr int R = K / 2, D = MODE == DIL ? 2 : 1;
  constexpr int SEG = MODE == SEP1 && K == 7 ? 8 : 4;
  constexpr int SCOLS = MODE == SEP2 ? TILE_W + 2 * R : XC;
  constexpr int SO = MODE == SEP2   ? 0
                     : MODE == POOL ? HALO6 - 1
                                    : HALO6 - 2 * R;
  constexpr int DCOLS = MODE == SEP1 ? TILE_W + 2 * R : TILE_W;
  constexpr int NSEG = D == 1 ? (DCOLS + SEG - 1) / SEG : TILE_W / SEG;
  // out of line the pointers are generic: shared loads and stores need this
  __builtin_assume(__isShared(src));
  __builtin_assume(__isShared(dst));
  if (MODE != POOL) __builtin_assume(__isShared(w));
  const int C = CT ? CT : c_rt, ld = C + 8, ng = C / 4;
  const int drows = MODE == SEP1 ? th + 2 * R : th;
  for (int it = tid; it < drows * NSEG * ng; it += NW * 32) {
    const int g = it % ng, rest = it / ng;
    const int sj = rest % NSEG, r = rest / NSEG;
    const int j0 = D == 1 ? sj * SEG : (sj / 2) * 2 * SEG + sj % 2;
    float acc[SEG][4];
#pragma unroll
    for (int e = 0; e < SEG; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[e][i] = 0.f;
#pragma unroll 1
    for (int t = 0; t < K; ++t) {
      float4 wr[K];
      if (MODE != POOL)
#pragma unroll
        for (int s = 0; s < K; ++s)
          wr[s] = *reinterpret_cast<const float4*>(w + (t * K + s) * C +
                                                   4 * g);
      const bf16* s0 =
          src + ((r + SO + t * D) * SCOLS + j0 + SO) * ld + 4 * g;
#pragma unroll
      for (int q = 0; q < SEG + K - 1; ++q) {
        float v[4];
        unpack4(*reinterpret_cast<const uint2*>(s0 + q * D * ld), v);
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const int e = q - s;
          if (e < 0 || e >= SEG) continue;
          if (MODE == POOL) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[e][i] += v[i];
          } else {
            acc[e][0] += v[0] * wr[s].x;
            acc[e][1] += v[1] * wr[s].y;
            acc[e][2] += v[2] * wr[s].z;
            acc[e][3] += v[3] * wr[s].w;
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < SEG; ++e) {
      const int j = j0 + e * D;
      if (j >= DCOLS) break;
      if (MODE == POOL) {
        const int gr = hl.r0 + r, gc = hl.c0 + j;
        const int cnt = (min(gr + 1, hl.h - 1) - max(gr - 1, 0) + 1) *
                        (min(gc + 1, hl.w - 1) - max(gc - 1, 0) + 1);
        const bool in = hl.inside(gr, gc);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[e][i] = in ? acc[e][i] / cnt : 0.f;
      }
      *reinterpret_cast<uint2*>(dst + (r * DCOLS + j) * ld + 4 * g) =
          pack4(acc[e]);
    }
  }
}

// t1 = bf16(relu(a1 @ W1)) over the P pixels of the halo-R tile (`cols`
// wide) in h, in place, zero outside the image; W1 staged (C x C, ld).
// One warp a 16-row block: it holds the block's a1 fragments before it
// stores any t1, and no other warp reads those rows.
template <int CT>
__device__ __forceinline__ void w1_product(bf16* h, int P, int cols, int R,
                                           const bf16* wm, int c_rt,
                                           const Halo& hl, int warp,
                                           int lane) {
  const int C = CT ? CT : c_rt, ld = C + 8, kc = C / 16;
  for (int mi = warp; mi < (P + 15) / 16; mi += NW) {
    bf16* rows = h + mi * 16 * ld;
    unsigned fa[KMAX][4];
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < kc) load_a_16x16(fa[k], rows + 16 * k, ld, lane);
    __syncwarp();
    const int p0 = mi * 16 + lane / 4, p1 = p0 + 8;
    const bool in0 = p0 < P && hl.inside(hl.r0 - R + p0 / cols,
                                         hl.c0 - R + p0 % cols);
    const bool in1 = p1 < P && hl.inside(hl.r0 - R + p1 / cols,
                                         hl.c0 - R + p1 % cols);
    for (int n = 0; n < kc; ++n) {
      unsigned fb[KMAX][4];
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < kc) load_b_16x16(fb[k], wm + 16 * k * ld + 16 * n, ld, lane);
      float acc[2][4] = {};
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < kc) {
          mma_16816(acc[0], fa[k], fb[k][0], fb[k][1]);
          mma_16816(acc[1], fa[k], fb[k][2], fb[k][3]);
        }
      const int c = 16 * n + 2 * (lane % 4);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        *reinterpret_cast<__nv_bfloat162*>(rows + (lane / 4) * ld + c +
                                           8 * hh) =
            __floats2bfloat162_rn(in0 ? fmaxf(acc[hh][0], 0.f) : 0.f,
                                  in0 ? fmaxf(acc[hh][1], 0.f) : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(rows + (lane / 4 + 8) * ld + c +
                                           8 * hh) =
            __floats2bfloat162_rn(in1 ? fmaxf(acc[hh][2], 0.f) : 0.f,
                                  in1 ? fmaxf(acc[hh][3], 0.f) : 0.f);
      }
    }
  }
}

// acc += a2 (npix x C) @ M_op (staged, C x C, ld) for the warp's output
// fragments warp NF .. warp NF + NF - 1 of the tile's (th, C / 8) grid of
// 16 x 8 fragments (a 16-row block is a tile row). The fragments' offsets
// are computed once; each k step loads its B fragments first, then one A
// fragment a tile row, so the loads of a step overlap its products.
template <int NF, int CT>
__device__ __forceinline__ void m_product(float (&acc)[NF][4],
                                          const bf16* a2, const bf16* mm,
                                          int c_rt, int nfrag, int warp,
                                          int lane) {
  const int C = CT ? CT : c_rt, ld = C + 8, n8 = C / 8;
  int aoff[NF], boff[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int i = min(warp * NF + f, nfrag - 1);
    aoff[f] = ((i / n8) * 16 + lane % 16) * ld + (lane / 16) * 8;
    boff[f] = (lane % 16) * ld + (i % n8) * 8;
  }
#pragma unroll
  for (int k = 0; k < C; k += 16) {
    unsigned fb[NF][2];
#pragma unroll
    for (int f = 0; f < NF; ++f) ldsm_x2_trans(fb[f], mm + boff[f] + k * ld);
    unsigned fa[4];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if (warp * NF + f >= nfrag) break;
      if (f == 0 || aoff[f] != aoff[f - 1]) ldmatrix_x4(fa, a2 + aoff[f] + k);
      mma_16816(acc[f], fa, fb[f][0], fb[f][1]);
    }
  }
}

// The phases of one tile, in order; each starts with enter_phase.
template <int CT, int NF>
struct Step {
  const StepArgs& a;
  const StepSmem& L;
  const Halo& hl;
  bf16 *xs, *hs, *as;
  unsigned char* ring;
  int b, tid, warp, lane, nfrag;

  __device__ __forceinline__ const float* taps(int ph) const {
    return reinterpret_cast<const float*>(
        enter_phase<CT>(a, L, ph, b, ring, tid));
  }
  __device__ __forceinline__ const bf16* mat(int ph) const {
    return reinterpret_cast<const bf16*>(
        enter_phase<CT>(a, L, ph, b, ring, tid));
  }

  // SepConv K, phases ph .. ph + 3
  template <int K>
  __device__ __forceinline__ void sep(float (&acc)[NF][4], int ph) const {
    constexpr int R = K / 2;
    const int cols = TILE_W + 2 * R, rows = a.th + 2 * R;
    const float* w = taps(ph);
    op_taps<SEP1, K, CT>(xs, w, hs, a.C, a.th, hl, tid);
    const bf16* w1 = mat(ph + 1);
    w1_product<CT>(hs, rows * cols, cols, R, w1, a.C, hl, warp, lane);
    w = taps(ph + 2);
    op_taps<SEP2, K, CT>(hs, w, as, a.C, a.th, hl, tid);
    const bf16* mm = mat(ph + 3);
    m_product<NF, CT>(acc, as, mm, a.C, nfrag, warp, lane);
  }

  // DilConv K (dilation 2), phases ph, ph + 1
  template <int K>
  __device__ __forceinline__ void dil(float (&acc)[NF][4], int ph) const {
    const float* w = taps(ph);
    op_taps<DIL, K, CT>(xs, w, as, a.C, a.th, hl, tid);
    const bf16* mm = mat(ph + 1);
    m_product<NF, CT>(acc, as, mm, a.C, nfrag, warp, lane);
  }

  // AvgPool 3x3, count_include_pad=False, phases 22, 23
  __device__ __forceinline__ void pool(float (&acc)[NF][4]) const {
    taps(22);  // nothing to read: the barrier, and phase 23's M_op
    op_taps<POOL, 3, CT>(xs, nullptr, as, a.C, a.th, hl, tid);
    const bf16* mm = mat(23);
    m_product<NF, CT>(acc, as, mm, a.C, nfrag, warp, lane);
  }
};

// CT: C when the kernel is built for one width (48, 96: DRSformer's),
// 0 for any C the launch gives.
template <int CT, int NF>
__global__ void __launch_bounds__(NW * 32, 1)
    mefc_step_kernel(StepArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = CT ? CT : a.C;
  const StepSmem L(C, a.th);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.off_x);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.off_h);
  bf16* as = reinterpret_cast<bf16*>(smem + L.off_a);
  unsigned char* ring = smem + L.off_r;

  const int b = blockIdx.y, t = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Halo hl{(t / a.tiles_w) * a.th, (t % a.tiles_w) * TILE_W, a.H, a.W};
  const size_t img = (size_t)b * a.H * a.W * C;

  // x's halo-6 tile, zero outside the image and in the 4 pixels past it,
  // and phase 0's taps
  const int vec = C / 8;
  for (int i = tid; i < L.XP * vec; i += NW * 32) {
    const int p = i / vec, m = i % vec;
    const int gr = hl.r0 - HALO6 + p / XC, gc = hl.c0 - HALO6 + p % XC;
    const bool in = p < L.XP - 4 && hl.inside(gr, gc);
    const bf16* src = a.x + (in ? img + ((size_t)gr * a.W + gc) * C + 8 * m : 0);
    cp_async16(xs + p * L.ld + 8 * m, src, in);
  }
  stage_phase<CT>(a, L, 0, b, ring, tid);
  cp_async_commit();

  const int n8 = C / 8, nfrag = a.th * n8;
  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0.f;

  const Step<CT, NF> st{a, L, hl, xs, hs, as, ring, b, tid, warp, lane,
                            nfrag};
  st.template sep<1>(acc, 0);
  st.template sep<3>(acc, 4);
  st.template sep<5>(acc, 8);
  st.template sep<7>(acc, 12);
  st.template dil<3>(acc, 16);
  st.template dil<5>(acc, 18);
  st.template dil<7>(acc, 20);
  st.pool(acc);

  // out = bf16(relu(relu(acc) + x)), staged in the a1/t1 buffer (last read
  // in phase 14), then 16 bytes a store
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int i = warp * NF + f;
    if (i >= nfrag) break;
    const int q = (i / n8) * TILE_W + lane / 4;
    const int c = (i % n8) * 8 + 2 * (lane % 4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = q + 8 * hh;
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          xs + ((p / TILE_W + HALO6) * XC + p % TILE_W + HALO6) * L.ld + c));
      *reinterpret_cast<__nv_bfloat162*>(hs + p * L.ld + c) =
          __floats2bfloat162_rn(
              fmaxf(fmaxf(acc[f][2 * hh], 0.f) + xv.x, 0.f),
              fmaxf(fmaxf(acc[f][2 * hh + 1], 0.f) + xv.y, 0.f));
    }
  }
  __syncthreads();
  for (int e = tid; e < L.npix * vec; e += NW * 32) {
    const int q = e / vec, m = e % vec;
    const int gr = hl.r0 + q / TILE_W, gc = hl.c0 + q % TILE_W;
    if (hl.inside(gr, gc))
      *reinterpret_cast<uint4*>(a.out + img + ((size_t)gr * a.W + gc) * C +
                                8 * m) =
          *reinterpret_cast<const uint4*>(hs + q * L.ld + 8 * m);
  }
}

using StepKernel = void (*)(StepArgs);

template <int CT>
StepKernel step_kernel(int nf) {
  return nf == 3 ? mefc_step_kernel<CT, 3> : mefc_step_kernel<CT, 6>;
}

}  // namespace irk

extern "C" {

// Dynamic shared memory one block of the step kernel needs; 1 << 30 (no
// card has it) when no build takes C and th.
int ir_mefc_step_smem(int C, int th) {
  if (C % 16 || C > 16 * irk::KMAX || th < 1 || !irk::mefc_frags(C, th))
    return 1 << 30;
  return static_cast<int>(irk::StepSmem(C, th).total);
}

// Launches one op-mixture step on `stream`, one block of 16 warps per
// output tile of `th` rows and batch image. Returns cudaGetLastError().
int ir_mefc_step(const void* x, const void* w1, const void* dwa,
                 const void* dwb, const void* dwd, const void* m, void* out,
                 int B, int H, int W, int C, int th, void* stream) {
  using namespace irk;
  const int smem = ir_mefc_step_smem(C, th);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  const int nf = mefc_frags(C, th);
  const StepKernel kernel = C == 48   ? step_kernel<48>(nf)
                            : C == 96 ? step_kernel<96>(nf)
                                      : step_kernel<0>(nf);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  StepArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
             static_cast<const float*>(dwa), static_cast<const float*>(dwb),
             static_cast<const float*>(dwd), static_cast<const bf16*>(m),
             static_cast<bf16*>(out), H, W, C, th, tiles_w};
  kernel<<<dim3(tiles, B), NW * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
