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
// (nvcuda::wmma); taps are fp32 on bf16 inputs. The rounding points are
// the TPU kernel's with its _F32_MIX off.
//
// What bounds it on the card: device-memory traffic is one read of x (with
// halo) and one write per step; the 8 op outputs, t1 and the concat never
// leave the SM. The work is the fp32 tap loops (1+9+25+49 taps twice for
// the SepConvs, the first time over a halo, 9+25+49 for the DilConvs, 9
// for the pool, per channel and pixel) reading shared memory, plus nine
// C x C tensor-core products per pixel. The tap loops walk row segments so
// one shared-memory load feeds several outputs (step_taps), and 16 warps
// per block hide the loads' latency; the products are not pipelined yet
// (no TMA, no wgmma).
//
// Shared memory (StepSmem): x's halo-6 tile (bf16, all C, loaded with
// 16-byte async copies), a1/a2 and t1 (bf16, up to the halo-3 tile), the
// fp32 output accumulator, and a 16x16 fp32 scratch per warp for t1's relu
// and mask. M and W1 are read from device memory (L2) in the products, one
// op at a time: the eight C x C M matrices would take 147 KB at C = 96. The
// x tile limits the height: the host (kernels/mefc.py mefc_step) takes
// the tallest that fits, th = 8 at C = 48 (~177 KB) and th = 4 at C = 96
// (~228 KB).
#include "common.cuh"

namespace irk {

constexpr int S_THREADS = 512;  // 16 warps
constexpr int S_WARPS = S_THREADS / 32;
constexpr int HALO6 = 6;
constexpr int XC = TILE_W + 2 * HALO6;  // x tile columns (28)

struct StepSmem {
  int XP, AP, npix, ld, ldo;
  size_t off_x, off_a, off_t, off_o, off_scr, total;
  __host__ __device__ StepSmem(int C, int th) {
    XP = (th + 2 * HALO6) * XC;
    AP = round16((th + 6) * (TILE_W + 6));
    npix = th * TILE_W;
    ld = C + 8;
    ldo = C + 4;
    size_t o = 0;
    off_x = o; o = align128(o + sizeof(bf16) * XP * ld);
    off_a = o; o = align128(o + sizeof(bf16) * AP * ld);
    off_t = o; o = align128(o + sizeof(bf16) * AP * ld);
    off_o = o; o = align128(o + sizeof(float) * npix * ldo);
    off_scr = o; o = align128(o + sizeof(float) * S_WARPS * 256);
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

// dst[p][c] = bf16(sum_{t,s} src[(ri + o + t*D) * scols + ci + o + s*D][c]
//                  * w[(t*K + s) * C + c]) for p = ri * dcols + ci over
// `dpix` pixels; one lane per channel, warps stride over row segments of
// SEG outputs (SEG divides dcols). Each loaded value feeds every output of
// its segment that its taps reach, so a k-tap row costs SEG + (k-1)*D
// shared-memory loads for SEG outputs; the sums still run in tap order.
template <int K, int D, int SEG>
__device__ void step_taps(const bf16* src, int scols, int o, const float* w,
                          int C, int ld, bf16* dst, int dcols, int dpix,
                          int warp, int lane) {
  const int nseg = dcols / SEG, items = (dpix / dcols) * nseg;
  for (int cg = 0; cg < C; cg += 32) {
    const int c = cg + lane;
    if (c >= C) break;
    float wt[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) wt[t] = w[t * C + c];
    for (int item = warp; item < items; item += S_WARPS) {
      const int ri = item / nseg, c0 = (item % nseg) * SEG;
      float acc[SEG];
#pragma unroll
      for (int e = 0; e < SEG; ++e) acc[e] = 0.f;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const bf16* s0 = src + ((ri + o + t * D) * scols + c0 + o) * ld + c;
#pragma unroll
        for (int q = 0; q < SEG + (K - 1) * D; ++q) {
          const float v = bf2f(s0[q * ld]);
#pragma unroll
          for (int s = 0; s < K; ++s)
            if (q - s * D >= 0 && q - s * D < SEG)
              acc[q - s * D] += v * wt[t * K + s];
        }
      }
#pragma unroll
      for (int e = 0; e < SEG; ++e)
        dst[(ri * dcols + c0 + e) * ld + c] = f2bf(acc[e]);
    }
  }
}

// acc[npix x C] += a[npix x C] @ mat (C x C, row-major in device memory)
__device__ void step_product(const StepSmem& L, const bf16* a,
                             const bf16* mat, int C, float* oacc, int warp) {
  const int no = C / 16;
  for (int i = warp; i < (L.npix / 16) * no; i += S_WARPS) {
    const int mi = i / no, ni = i % no;
    float* optr = oacc + mi * 16 * L.ldo + ni * 16;
    FragC acc;
    wmma::load_matrix_sync(acc, optr, L.ldo, wmma::mem_row_major);
    for (int k = 0; k < C; k += 16) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, a + mi * 16 * L.ld + k, L.ld);
      wmma::load_matrix_sync(fb, mat + (size_t)k * C + ni * 16, C);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(optr, acc, L.ldo, wmma::mem_row_major);
  }
}

// SepConv k: dw_k -> W1 -> relu (+ mask) -> dw_k -> M_op, into oacc.
template <int K>
__device__ void step_sep(const StepArgs& a, const StepSmem& L, const Halo& hl,
                         const bf16* xs, bf16* as, bf16* ts, float* oacc,
                         float* scr, int op, int tap0, const bf16* mb,
                         int warp, int lane) {
  constexpr int R = K / 2;
  const int C = a.C, cols = TILE_W + 2 * R;
  const int P = (a.th + 2 * R) * cols, Pp = round16(P);
  // a1 on the tile + R halo; its taps reach 2R past the tile into x's 6
  step_taps<K, 1, 2>(xs, XC, HALO6 - 2 * R, a.dwa + (size_t)tap0 * C, C,
                     L.ld, as, cols, P, warp, lane);
  for (int i = P * C + threadIdx.x; i < Pp * C; i += S_THREADS)
    as[(i / C) * L.ld + i % C] = f2bf(0.f);  // rows the product pads to 16
  __syncthreads();
  // t1 = bf16(relu(a1 @ W1)), zero outside the image
  const int no = C / 16;
  const bf16* w1 = a.w1 + (size_t)op * C * C;
  float* sw = scr + warp * 256;
  for (int i = warp; i < (Pp / 16) * no; i += S_WARPS) {
    const int mi = i / no, ni = i % no;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < C; k += 16) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, as + mi * 16 * L.ld + k, L.ld);
      wmma::load_matrix_sync(fb, w1 + (size_t)k * C + ni * 16, C);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sw, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int p = mi * 16 + e / 16;
      const int gr = hl.r0 - R + p / cols, gc = hl.c0 - R + p % cols;
      const bool in = p < P && hl.inside(gr, gc);
      ts[p * L.ld + ni * 16 + e % 16] = f2bf(in ? fmaxf(sw[e], 0.f) : 0.f);
    }
    __syncwarp();
  }
  __syncthreads();
  // a2 = bf16(dw_k(t1)) on the tile, into as (a1 is done)
  step_taps<K, 1, 4>(ts, cols, 0, a.dwb + (size_t)tap0 * C, C, L.ld, as,
                     TILE_W, L.npix, warp, lane);
  __syncthreads();
  step_product(L, as, mb + (size_t)op * C * C, C, oacc, warp);
  __syncthreads();
}

// DilConv k: dilation-2 dw_k -> M_op, into oacc.
template <int K>
__device__ void step_dil(const StepArgs& a, const StepSmem& L,
                         const bf16* xs, bf16* as, float* oacc, int op,
                         int tap0, const bf16* mb, int warp, int lane) {
  constexpr int R = K / 2;
  step_taps<K, 2, 4>(xs, XC, HALO6 - 2 * R, a.dwd + (size_t)tap0 * a.C,
                     a.C, L.ld, as, TILE_W, L.npix, warp, lane);
  __syncthreads();
  step_product(L, as, mb + (size_t)op * a.C * a.C, a.C, oacc, warp);
  __syncthreads();
}

__global__ void __launch_bounds__(S_THREADS) mefc_step_kernel(StepArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StepSmem L(a.C, a.th);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.off_x);
  bf16* as = reinterpret_cast<bf16*>(smem + L.off_a);
  bf16* ts = reinterpret_cast<bf16*>(smem + L.off_t);
  float* oacc = reinterpret_cast<float*>(smem + L.off_o);
  float* scr = reinterpret_cast<float*>(smem + L.off_scr);

  const int C = a.C, b = blockIdx.y, t = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Halo hl{(t / a.tiles_w) * a.th, (t % a.tiles_w) * TILE_W, a.H, a.W};
  const size_t img = (size_t)b * a.H * a.W * C;
  const bf16* mb = a.m + (size_t)b * 8 * C * C;

  // x's halo-6 tile, zero outside the image (16-byte async copies)
  const int vec = C / 8;
  for (int i = tid; i < L.XP * vec; i += S_THREADS) {
    const int p = i / vec, m = i % vec;
    const int gr = hl.r0 - HALO6 + p / XC, gc = hl.c0 - HALO6 + p % XC;
    const bool in = hl.inside(gr, gc);
    const bf16* src = a.x + (in ? img + ((size_t)gr * a.W + gc) * C + 8 * m : 0);
    cp_async16(xs + p * L.ld + 8 * m, src, in);
  }
  for (int i = tid; i < L.npix * L.ldo; i += S_THREADS) oacc[i] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  step_sep<1>(a, L, hl, xs, as, ts, oacc, scr, 0, 0, mb, warp, lane);
  step_sep<3>(a, L, hl, xs, as, ts, oacc, scr, 1, 1, mb, warp, lane);
  step_sep<5>(a, L, hl, xs, as, ts, oacc, scr, 2, 10, mb, warp, lane);
  step_sep<7>(a, L, hl, xs, as, ts, oacc, scr, 3, 35, mb, warp, lane);
  step_dil<3>(a, L, xs, as, oacc, 4, 0, mb, warp, lane);
  step_dil<5>(a, L, xs, as, oacc, 5, 9, mb, warp, lane);
  step_dil<7>(a, L, xs, as, oacc, 6, 34, mb, warp, lane);

  // AvgPool 3x3, count_include_pad=False
  for (int cg = 0; cg < C; cg += 32) {
    const int c = cg + lane;
    if (c >= C) break;
    for (int q = warp; q < L.npix; q += S_WARPS) {
      const int ri = q / TILE_W, ci = q % TILE_W;
      const int gr = hl.r0 + ri, gc = hl.c0 + ci;
      const bf16* s0 = xs + ((ri + HALO6 - 1) * XC + ci + HALO6 - 1) * L.ld + c;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v) sum += bf2f(s0[(u * XC + v) * L.ld]);
      const int cnt = (min(gr + 1, a.H - 1) - max(gr - 1, 0) + 1) *
                      (min(gc + 1, a.W - 1) - max(gc - 1, 0) + 1);
      as[q * L.ld + c] = f2bf(hl.inside(gr, gc) ? sum / cnt : 0.f);
    }
  }
  __syncthreads();
  step_product(L, as, mb + (size_t)7 * C * C, C, oacc, warp);
  __syncthreads();

  for (int q = warp; q < L.npix; q += S_WARPS) {
    const int ri = q / TILE_W, ci = q % TILE_W;
    const int gr = hl.r0 + ri, gc = hl.c0 + ci;
    if (!hl.inside(gr, gc)) continue;
    bf16* dst = a.out + img + ((size_t)gr * a.W + gc) * C;
    const bf16* xr = xs + ((ri + HALO6) * XC + ci + HALO6) * L.ld;
    const float* src = oacc + q * L.ldo;
    for (int c = lane; c < C; c += 32)
      dst[c] = f2bf(fmaxf(fmaxf(src[c], 0.f) + bf2f(xr[c]), 0.f));
  }
}

}  // namespace irk

extern "C" {

// Dynamic shared memory one block of the step kernel needs.
int ir_mefc_step_smem(int C, int th) {
  return static_cast<int>(irk::StepSmem(C, th).total);
}

// Launches one op-mixture step on `stream`, one block per output tile and
// batch image. Returns cudaGetLastError().
int ir_mefc_step(const void* x, const void* w1, const void* dwa,
                 const void* dwb, const void* dwd, const void* m, void* out,
                 int B, int H, int W, int C, int th, void* stream) {
  using namespace irk;
  const StepSmem L(C, th);
  if (L.total > static_cast<size_t>(SMEM_LIMIT) || C % 16)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mefc_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return e;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  StepArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
             static_cast<const float*>(dwa), static_cast<const float*>(dwb),
             static_cast<const float*>(dwd), static_cast<const bf16*>(m),
             static_cast<bf16*>(out), H, W, C, th, tiles_w};
  mefc_step_kernel<<<dim3(tiles, B), S_THREADS, L.total,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
