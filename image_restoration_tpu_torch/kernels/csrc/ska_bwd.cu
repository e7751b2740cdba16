// SKA dynamic convolution (LSNet's Sparse Kernel Aggregation), backward:
// the gradients of
//
//   out[b,i,j,c] = sum_{kh,kw} x[b, i-p+kh, j-p+kw, c] * w[b,i,j, c mod wc, kh*ks+kw]
//
// under the output gradient go (B, H, W, C), as two kernels:
//
//   gx[b,u,v,c]     = sum_{kh,kw} go[b, u+p-kh, v+p-kw, c]
//                                 * w[b, u+p-kh, v+p-kw, c mod wc, kh*ks+kw]
//   gw[b,i,j,c',k]  = sum_r go[b,i,j, c'+r wc] * x[b, i-p+kh, j-p+kw, c'+r wc]
//
// with zero padding p = (ks-1)/2. JAX has no Pallas kernel for it: its
// custom VJP (image_restoration_tpu/kernels/ska_pallas.py `_ska_bwd`)
// runs shifted-slice multiply-adds in XLA; the zoo's original is two
// device kernels (the reference LSNet's ska.py, a Triton forward and two
// backward kernels). Both kernels here take bf16 or fp32 go, x and w,
// multiply and add in fp32 and round once to the input's type, and sum in
// the JAX order: gx over the taps in tap order, gw over the channel
// repeats r in order. Each product and each sum is rounded on its own
// (__fmul_rn, __fadd_rn, no fused multiply-add), so a kernel's bits are
// those of ops/ska.py `ska_bwd_plain`, which computes the same products
// and sums tensor by tensor.
//
// What bounds them on the card: device-memory bytes. gx reads go and w at
// each of a pixel's k^2 neighbours and does 2 k^2 flops a value; gw reads
// go and the k^2 shifted x of a pixel and does 2 C/wc flops a value: at
// LSNet's widths (C = 8 wc, k = 3) about 0.6 flop per byte moved, far
// below the card's ~20 fp32 flops per byte. Every output's reduction is
// short (k^2 taps or C/wc repeats) and stays in one thread, in the plain
// version's order, with no atomics, so two runs give the same bits. Two
// paths, chosen inside the library by the shape and the pointers alone:
// - the strip kernels (ska_bwd_strip_kernel; k = 3, wc a multiple of 8,
//   16-byte aligned pointers, a strip that fits shared memory: every
//   LSNet width). Modelled on ska.cu's strip kernel: a block takes a strip
//   of `th` whole image rows with all C channels and stages its operands
//   into shared memory by 16-byte cp.async (gx: go and w, both with a
//   one-pixel halo; gw: x with the halo and the strip's go), rows outside
//   the image zero-filled and the halo columns zeroed once, so the inner
//   loops need no bounds checks. A staged zero adds +0 to gx's sum, which
//   starts at +0 and never becomes -0, and gives gw the +-0 product that
//   the plain version's zero padding gives: the bits stay. With `ring` 2
//   blocks are persistent and keep the next strip's copies in flight.
//   Against the simple kernels' four costs (scalar loads, 64-bit
//   division, gx's weight reads 9 elements apart, every value fetched
//   again from L1/L2 by each thread that needs it): each global byte is
//   read once, as 16-byte copies of contiguous rows; one thread takes a
//   (pixel, 8 weight channels) unit and reads go and x as 16-byte
//   vectors of 8 channels from shared memory at a bank-padded pixel
//   stride (fp32 as two planes, ska.cu's layout); indices are 32-bit and
//   divide once a unit or a strip, never a load. gx's unit reads its 72
//   weights (8 channels at each tap's neighbour) from shared memory once
//   and loops over the C / wc channel repeats that share them (or its
//   `split` share of them: each gx value sums over taps only, so any
//   split keeps the order), reading nine go vectors and writing 8
//   channels with 16-byte stores; w stays in its (wc, k^2) layout, since
//   each staged weight is read by one unit only. gw's unit keeps its 72
//   sums (8 channels x 9 taps) in registers and loops over the repeats in
//   order, one go vector and nine x vectors each; its 72 outputs are one
//   contiguous range of gw, written as 16-byte stores. Its repeats are
//   not split, since that would reorder the sum; where a strip has too
//   few units to hide the loop's latency, its 8 channels are (`split` 2
//   or 4 threads, each summing its channels' taps over all the repeats).
// - the simple kernels (ska_bwd_x_kernel, ska_bwd_w_kernel; any odd k,
//   any C with C % wc == 0): one thread per output value, the k^2 taps
//   (gx) or the C/wc repeats (gw) summed in the thread, scalar loads. The
//   tests' small widths (wc 2, 6), k = 5, unaligned views and rows too
//   wide for even a one-row strip take them.
#include <algorithm>
#include <atomic>
#include <type_traits>

#include "ska.cuh"

namespace irk {

constexpr int SKA_BWD_THREADS = 256;

static __device__ __forceinline__ float bwd_in(bf16 v) {
  return __bfloat162float(v);
}
static __device__ __forceinline__ float bwd_in(float v) { return v; }
static __device__ __forceinline__ void bwd_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
static __device__ __forceinline__ void bwd_out(float* p, float v) { *p = v; }

// One thread per gx value (b, u, v, c); `total` = B H W C.
template <typename T>
__global__ void __launch_bounds__(SKA_BWD_THREADS)
    ska_bwd_x_kernel(const T* __restrict__ go, const T* __restrict__ w,
                     T* __restrict__ gx, int H, int W, int C, int wc, int ks,
                     long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * SKA_BWD_THREADS + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % C);
  const long long pix = i / C;
  const int v = static_cast<int>(pix % W);
  const long long row = pix / W;       // b * H + u
  const int u = static_cast<int>(row % H);
  const long long img = row - u;       // b * H
  const int p = (ks - 1) / 2, k2 = ks * ks, cw = c % wc;
  float acc = 0.f;
  for (int kh = 0; kh < ks; ++kh) {
    const int rr = u + p - kh;
    if (rr < 0 || rr >= H) continue;
    for (int kw = 0; kw < ks; ++kw) {
      const int cc = v + p - kw;
      if (cc < 0 || cc >= W) continue;
      const long long q = (img + rr) * W + cc;  // the pixel tap k reads u, v
      const float g = bwd_in(go[q * C + c]);
      const float wt = bwd_in(w[(q * wc + cw) * k2 + kh * ks + kw]);
      acc = __fadd_rn(acc, __fmul_rn(g, wt));
    }
  }
  bwd_out(gx + i, acc);
}

// One thread per gw value (b, i, j, c', k); `total` = B H W wc k^2.
template <typename T>
__global__ void __launch_bounds__(SKA_BWD_THREADS)
    ska_bwd_w_kernel(const T* __restrict__ go, const T* __restrict__ x,
                     T* __restrict__ gw, int H, int W, int C, int wc, int ks,
                     long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * SKA_BWD_THREADS + threadIdx.x;
  if (i >= total) return;
  const int k2 = ks * ks;
  const int k = static_cast<int>(i % k2);
  const long long t = i / k2;
  const int cw = static_cast<int>(t % wc);
  const long long pix = t / wc;
  const int j = static_cast<int>(pix % W);
  const long long row = pix / W;
  const int r = static_cast<int>(row % H);
  const int p = (ks - 1) / 2;
  const int rr = r - p + k / ks, cc = j - p + k % ks;
  const bool inside = rr >= 0 && rr < H && cc >= 0 && cc < W;
  const T* xs = inside ? x + ((row - r + rr) * W + cc) * C : x;
  const T* g = go + pix * C;
  float acc = 0.f;
  for (int c = cw; c < C; c += wc) {
    // outside the image x is the zero padding: the product is +-0, as in
    // the padded plain version
    const float prod =
        __fmul_rn(bwd_in(g[c]), inside ? bwd_in(xs[c]) : 0.f);
    acc = c == cw ? prod : __fadd_rn(acc, prod);
  }
  bwd_out(gw + i, acc);
}

// ---- The strip path ----

// Shared-memory layout of a strip slot: the operand staged with a one-pixel
// halo (gx: go; gw: x) laid out as ska.cu lays out x (StripSmem: (th + 2)
// rows x (W + 2) pixels at a bank-padded stride of S bytes, fp32 as two
// planes), then gx: w with the same halo, each pixel's (wc, 9) weights at
// a stride of Sw bytes (fp32: 16 bytes more, so the units' scalar reads
// spread over the banks); gw: go of the strip's own th rows, in planes as
// the halo operand's.
struct BwdSmem {
  int W2, S, plane, hbytes, Sw, oplane, slot, total;
  __host__ __device__ BwdSmem(int W, int C, int wc, int th, int esize,
                              int ring, bool grad_w) {
    const StripSmem x(W, C, wc, th, esize, 1);
    W2 = x.W2, S = x.S, plane = x.plane, hbytes = x.xbytes;
    Sw = wc * 9 * esize + (esize == 4 ? 16 : 0);
    oplane = static_cast<int>(align128(th * W * S)) + 64;
    slot = hbytes + static_cast<int>(grad_w ? align128(esize / 2 * oplane)
                                            : align128((th + 2) * W2 * Sw));
    total = ring * slot;
  }
};

// One value at shared-space address `a`, widened to fp32 (exactly).
static __device__ __forceinline__ float bwd_lds(unsigned a, const bf16*) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
static __device__ __forceinline__ float bwd_lds(unsigned a, const float*) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// CH channels c0 .. c0 + CH - 1 of the 8-channel group at shared address
// `a` of plane 0 (CH 8, 4 or 2; fp32 keeps channels 0-3 of a group in
// plane 0 and 4-7 in plane 1).
template <int CH>
static __device__ __forceinline__ void bwd_load_part(unsigned a, int plane,
                                                     int c0, const bf16* t,
                                                     float (&v)[CH]) {
  if constexpr (CH == 8) {
    load_x8(a, plane, t, v);
  } else if constexpr (CH == 4) {
    unsigned x, y;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(x), "=r"(y)
                 : "r"(a + c0 * 2));
    v[0] = __uint_as_float(x << 16), v[1] = __uint_as_float(x & 0xffff0000u);
    v[2] = __uint_as_float(y << 16), v[3] = __uint_as_float(y & 0xffff0000u);
  } else {
    unsigned x;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(x) : "r"(a + c0 * 2));
    v[0] = __uint_as_float(x << 16), v[1] = __uint_as_float(x & 0xffff0000u);
  }
}
template <int CH>
static __device__ __forceinline__ void bwd_load_part(unsigned a, int plane,
                                                     int c0, const float* t,
                                                     float (&v)[CH]) {
  if constexpr (CH == 8) {
    load_x8(a, plane, t, v);
  } else if constexpr (CH == 4) {
    const uint4 u = lds128(a + (c0 / 4) * plane);
    v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
  } else {
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v[0]), "=f"(v[1])
                 : "r"(a + (c0 / 4) * plane + (c0 % 4) * 4));
  }
}

// N values (N even) rounded once to T, stored at dst as packets of the
// largest of 16, 8 and 4 bytes that divides N values' bytes (dst is aligned
// to it).
template <int N>
static __device__ __forceinline__ void bwd_store_run(bf16* dst,
                                                     const float (&v)[N]) {
  constexpr int WORDS = N / 2;
  unsigned w[WORDS];
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  constexpr int PK = WORDS % 4 == 0 ? 4 : WORDS % 2 == 0 ? 2 : 1;
#pragma unroll
  for (int i = 0; i < WORDS; i += PK) {
    if constexpr (PK == 4)
      *reinterpret_cast<uint4*>(dst + 2 * i) =
          make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
    else if constexpr (PK == 2)
      *reinterpret_cast<uint2*>(dst + 2 * i) = make_uint2(w[i], w[i + 1]);
    else
      *reinterpret_cast<unsigned*>(dst + 2 * i) = w[i];
  }
}
template <int N>
static __device__ __forceinline__ void bwd_store_run(float* dst,
                                                     const float (&v)[N]) {
  constexpr int PK = N % 4 == 0 ? 4 : 2;
#pragma unroll
  for (int i = 0; i < N; i += PK) {
    if constexpr (PK == 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    else
      *reinterpret_cast<float2*>(dst + i) = make_float2(v[i], v[i + 1]);
  }
}

// Starts the 16-byte copies of rows r_first .. r_first + n - 1 of one
// image (`img`, H x W pixels of `ch` chunks each; rows outside 0 .. H-1
// become zeros) into shared memory: chunk k of pixel j of the i-th row to
// dst + (k % NPL) * plane + (i * rowpix + j) * S + (k / NPL) * 16. The
// (chunk, pixel, row) of a thread's copies step on without division.
template <typename T, int NPL>
static __device__ __forceinline__ void bwd_stage(unsigned char* dst,
                                                 int plane, int S, int rowpix,
                                                 const T* img, int r_first,
                                                 int n, int H, int W, int ch) {
  constexpr int PER = 16 / sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int dk = nt % ch, dp = nt / ch;
  const int first = r_first * W * ch;  // chunk of row r_first; < 0 above
  int k = tid % ch, j = tid / ch, i = j / W;
  j -= i * W;
  for (int q = tid; q < n * W * ch; q += nt) {
    const int rr = r_first + i;
    const bool valid = rr >= 0 && rr < H;
    cp_async16(dst + (k % NPL) * plane + (i * rowpix + j) * S +
                   (k / NPL) * 16,
               valid ? img + (first + q) * PER : img, valid);
    k += dk;
    j += dp;
    if (k >= ch) k -= ch, ++j;
    while (j >= W) j -= W, ++i;
  }
}

struct BwdArgs {
  const void* go;
  const void* op;  // gx: w; gw: x
  void* out;
  int B, H, W, C, wc, th, split;
};

// gx (GW false) or gw (GW true) over strips of `th` rows; see the header.
template <typename T, int RING, bool GW>
__global__ void __launch_bounds__(256)
    ska_bwd_strip_kernel(const BwdArgs a) {
  constexpr int NPL = sizeof(T) / 2;  // planes of go and x
  constexpr int ES = sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const T* __restrict__ go = static_cast<const T*>(a.go);
  const T* __restrict__ op = static_cast<const T*>(a.op);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int H = a.H, W = a.W, C = a.C, wc = a.wc, th = a.th;
  const BwdSmem L(W, C, wc, th, ES, RING, GW);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int G = wc / 8, R = C / wc;
  const int xch = C * ES / 16, wch = wc * 9 * ES / 16;  // chunks a pixel
  const int spi = (H + th - 1) / th;
  const int n_strips = a.B * spi;
  const T* hsrc = GW ? op : go;  // the operand with a halo

  {  // the halo columns of every slot, zeroed once
    const int per = L.S / 16, rows = RING * NPL * (th + 2);
    for (int q = tid; q < rows * 2 * per; q += nt) {
      const int r = q / (2 * per), side = q / per % 2, k = q % per;
      const int sl = r / (NPL * (th + 2)), pl = r / (th + 2) % NPL;
      *reinterpret_cast<uint4*>(
          smem + sl * L.slot + pl * L.plane +
          (r % (th + 2) * L.W2 + side * (W + 1)) * L.S + k * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    if constexpr (!GW) {
      const int perw = L.Sw / 16, rowsw = RING * (th + 2);
      for (int q = tid; q < rowsw * 2 * perw; q += nt) {
        const int r = q / (2 * perw), side = q / perw % 2, k = q % perw;
        *reinterpret_cast<uint4*>(
            smem + r / (th + 2) * L.slot + L.hbytes +
            (r % (th + 2) * L.W2 + side * (W + 1)) * L.Sw + k * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  auto stage = [&](int s, int sl) {
    const int b = s / spi, r0 = (s - b * spi) * th;
    const int nr = min(th, H - r0);
    unsigned char* base = smem + sl * L.slot;
    const size_t img = static_cast<size_t>(b) * H * W;  // first pixel
    bwd_stage<T, NPL>(base + L.S, L.plane, L.S, L.W2, hsrc + img * C,
                      r0 - 1, nr + 2, H, W, xch);
    if constexpr (GW)
      bwd_stage<T, NPL>(base + L.hbytes, L.oplane, L.S, W, go + img * C, r0,
                        nr, H, W, xch);
    else
      bwd_stage<T, 1>(base + L.hbytes + L.Sw, 0, L.Sw, L.W2,
                      op + img * wc * 9, r0 - 1, nr + 2, H, W, wch);
  };

  // Thread u takes the (pixel, 8 weight channels) unit u % units (and, in
  // gx, the u / units-th share of its channel repeats).
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  auto compute_gx = [&](int s, int sl) {
    const int b = s / spi, r0 = (s - b * spi) * th;
    const int nr = min(th, H - r0);
    const unsigned gs = sbase + sl * L.slot, ws = gs + L.hbytes;
    const int units = nr * W * G, reps = R / a.split;
    // tap t of output (r0 + i, j) reads pixel (r0 + i + 1 - kh, j + 1 - kw):
    // slot row i + 2 - kh, column j + 2 - kw
    int goff[9], woff[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int px = (2 - t / 3) * L.W2 + 2 - t % 3;
      goff[t] = px * L.S;
      woff[t] = px * L.Sw + t * ES;
    }
    for (int u = tid; u < units * a.split; u += nt) {
      const int part = u / units, v = u - part * units;
      const int p = v / G, g = v - p * G;
      const int i = p / W, j = p - i * W;
      float wf[72];  // w[neighbour of tap t, 8 g + e, t] at e * 9 + t
      const unsigned wb = ws + (i * L.W2 + j) * L.Sw + g * 72 * ES;
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wf[e * 9 + t] = bwd_lds(wb + woff[t] + e * 9 * ES, op);
      const int rep0 = part * reps;
      unsigned gb = gs + (i * L.W2 + j) * L.S + (rep0 * G + g) * 16;
      T* dst = out + ((static_cast<size_t>(b) * H + r0 + i) * W + j) * C +
               rep0 * wc + g * 8;
#pragma unroll 1
      for (int r = 0; r < reps; ++r, gb += G * 16, dst += wc) {
        float acc[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          float gv[8];
          load_x8(gb + goff[t], L.plane, go, gv);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(gv[e], wf[e * 9 + t]));
        }
        store8(dst, acc);
      }
    }
  };
  // gw: a thread takes CH of a unit's 8 channels (split = 8 / CH threads
  // a unit): each output still sums its repeats in order in one thread.
  auto compute_gw = [&](int s, int sl, auto ch) {
    constexpr int CH = decltype(ch)::value, SPLIT = 8 / CH;
    const int b = s / spi, r0 = (s - b * spi) * th;
    const int nr = min(th, H - r0);
    const unsigned xs = sbase + sl * L.slot, gs = xs + L.hbytes;
    const int units = nr * W * G * SPLIT;
    // tap t of output (r0 + i, j) reads x at slot row i + kh, column j + kw
    int xoff[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) xoff[t] = (t / 3 * L.W2 + t % 3) * L.S;
    for (int u = tid; u < units; u += nt) {
      const int part = u % SPLIT, v = u / SPLIT;
      const int p = v / G, g = v - p * G, c0 = part * CH;
      const int i = p / W, j = p - i * W;
      unsigned xb = xs + (i * L.W2 + j) * L.S + g * 16;
      unsigned gb = gs + p * L.S + g * 16;
      float acc[9 * CH];  // gw[pixel, 8 g + c0 + e, t] at e * 9 + t
      {
        float gv[CH];
        bwd_load_part<CH>(gb, L.oplane, c0, go, gv);
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          float xv[CH];
          bwd_load_part<CH>(xb + xoff[t], L.plane, c0, op, xv);
#pragma unroll
          for (int e = 0; e < CH; ++e)
            acc[e * 9 + t] = __fmul_rn(gv[e], xv[e]);
        }
      }
#pragma unroll 1
      for (int r = 1; r < R; ++r) {
        gb += G * 16;
        xb += G * 16;
        float gv[CH];
        bwd_load_part<CH>(gb, L.oplane, c0, go, gv);
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          float xv[CH];
          bwd_load_part<CH>(xb + xoff[t], L.plane, c0, op, xv);
#pragma unroll
          for (int e = 0; e < CH; ++e)
            acc[e * 9 + t] =
                __fadd_rn(acc[e * 9 + t], __fmul_rn(gv[e], xv[e]));
        }
      }
      bwd_store_run(out + ((static_cast<size_t>(b) * H + r0) * W + p) * wc * 9 +
                        g * 72 + c0 * 9,
                    acc);
    }
  };

  int ahead = blockIdx.x;
#pragma unroll
  for (int k = 0; k < RING - 1; ++k, ahead += gridDim.x) {
    if (ahead < n_strips) stage(ahead, k);
    cp_async_commit();
  }
  for (int it = 0, s = blockIdx.x; s < n_strips;
       ++it, s += gridDim.x, ahead += gridDim.x) {
    if (ahead < n_strips) stage(ahead, (it + RING - 1) % RING);
    cp_async_commit();
    cp_async_wait_group<RING - 1>();
    __syncthreads();
    if constexpr (GW) {
      if (a.split == 1)
        compute_gw(s, it % RING, std::integral_constant<int, 8>());
      else if (a.split == 2)
        compute_gw(s, it % RING, std::integral_constant<int, 4>());
      else
        compute_gw(s, it % RING, std::integral_constant<int, 2>());
    } else {
      compute_gx(s, it % RING);
    }
    __syncthreads();  // the slot is refilled next
  }
}

// The strip kernels' configuration: `th` rows a strip, `ring` slots (1,
// 2), a unit's work split over `split` threads (gx: its channel repeats,
// a divisor of C / wc; gw: its 8 channels, 1, 2 or 4), within the card's
// shared memory and 32-bit offsets inside an image.
static bool bwd_strip_takes(int H, int W, int C, int wc, int esize, int th,
                            int ring, int split, bool grad_w) {
  return H > 0 && W > 0 && wc > 0 && wc % 8 == 0 && C % wc == 0 &&
         th >= 1 && ring >= 1 && ring <= 2 && split >= 1 &&
         (grad_w ? split == 1 || split == 2 || split == 4
                 : C / wc % split == 0) &&
         static_cast<long long>(H) * W * std::max(C, 9 * wc) * esize <
             (1LL << 31) &&
         static_cast<long long>(th + 2) * (W + 2) * (C + 9 * wc) * esize <=
             SMEM_LIMIT &&
         BwdSmem(W, C, wc, th, esize, ring, grad_w).total <= SMEM_LIMIT;
}

static bool bwd_strip_route(const void* go, const void* op, const void* out,
                            int H, int W, int C, int wc, int ks, int esize,
                            int th, int ring, int split, bool grad_w) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(go) |
                         reinterpret_cast<uintptr_t>(op) |
                         reinterpret_cast<uintptr_t>(out);
  return ks == 3 && ptrs % 16 == 0 &&
         bwd_strip_takes(H, W, C, wc, esize, th, ring, split, grad_w);
}

// Threads of a strip-kernel block: one a unit share of a full strip, in
// whole warps, at most 256.
static int bwd_threads(int W, int wc, int th, int split) {
  const long long n = static_cast<long long>(th) * W * (wc / 8) * split;
  return 32 * static_cast<int>(std::min(8LL, std::max(1LL, (n + 31) / 32)));
}

// Lets a strip kernel take the card's whole shared memory, once a device.
template <typename T, int RING, bool GW>
static cudaError_t bwd_allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(ska_bwd_strip_kernel<T, RING, GW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_LIMIT);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// Launches a strip kernel for `ring` slots on `grid` blocks or, with
// `blocks` given, only asks how many blocks an SM holds.
template <typename T, bool GW>
static cudaError_t bwd_strip_launch(const BwdArgs& a, int ring, int grid,
                                    cudaStream_t stream, int* blocks) {
  const int smem = BwdSmem(a.W, a.C, a.wc, a.th, sizeof(T), ring, GW).total;
  const int threads = bwd_threads(a.W, a.wc, a.th, a.split);
  const auto kernel = ring == 1 ? ska_bwd_strip_kernel<T, 1, GW>
                                : ska_bwd_strip_kernel<T, 2, GW>;
  cudaError_t e =
      ring == 1 ? bwd_allow_smem<T, 1, GW>() : bwd_allow_smem<T, 2, GW>();
  if (e != cudaSuccess) return e;
  if (blocks)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         threads, smem);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool GW>
static cudaError_t bwd_strip_dispatch(const BwdArgs& a, int fp32, int ring,
                                      int grid, cudaStream_t stream,
                                      int* blocks) {
  return fp32 ? bwd_strip_launch<float, GW>(a, ring, grid, stream, blocks)
              : bwd_strip_launch<bf16, GW>(a, ring, grid, stream, blocks);
}

// ---- The simple path's checks ----

static bool bwd_takes(int B, int H, int W, int C, int wc, int ks) {
  return B > 0 && H > 0 && W > 0 && C > 0 && wc > 0 && C % wc == 0 &&
         ks > 0 && ks % 2 == 1;
}

static unsigned bwd_blocks(long long total) {
  return static_cast<unsigned>((total + SKA_BWD_THREADS - 1) /
                               SKA_BWD_THREADS);
}

}  // namespace irk

extern "C" {

// Strip-kernel blocks one SM holds at once for gx (`grad_w` 0) or gw
// (`fp32` selects float over bf16); 0 where the configuration does not fit
// the card.
int ir_ska_bwd_blocks(int W, int C, int wc, int fp32, int th, int ring,
                      int split, int grad_w) {
  using namespace irk;
  if (!bwd_strip_takes(1, W, C, wc, fp32 ? 4 : 2, th, ring, split, grad_w))
    return 0;
  const BwdArgs a{nullptr, nullptr, nullptr, 1, th, W, C, wc, th, split};
  int blocks = 0;
  const cudaError_t e =
      grad_w ? bwd_strip_dispatch<true>(a, fp32, ring, 0, nullptr, &blocks)
             : bwd_strip_dispatch<false>(a, fp32, ring, 0, nullptr, &blocks);
  return e == cudaSuccess ? blocks : 0;
}

// 1 where a launch of ir_ska_bwd_x (`grad_w` 0) or ir_ska_bwd_w on these
// pointers, shape and configuration takes the strip kernel, 0 where it
// takes the simple one.
int ir_ska_bwd_route(const void* go, const void* operand, const void* out,
                     int H, int W, int C, int wc, int ks, int fp32, int th,
                     int ring, int split, int grad_w) {
  return irk::bwd_strip_route(go, operand, out, H, W, C, wc, ks,
                              fp32 ? 4 : 2, th, ring, split, grad_w);
}

// gx (B, H, W, C) from go (B, H, W, C) and w (B, H, W, wc, ks^2), all of
// one type (`fp32` selects float over bf16), contiguous, on `stream`. With
// k = 3, wc a multiple of 8, 16-byte aligned pointers and a strip
// configuration (th, ring, split) that fits, the strip kernel on `grid`
// blocks (ring 1: one strip a block whatever `grid`); otherwise the simple
// kernel. Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// empty or malformed shape.
int ir_ska_bwd_x(const void* go, const void* w, void* gx, int B, int H,
                 int W, int C, int wc, int ks, int fp32, int th, int ring,
                 int split, int grid, void* stream) {
  using namespace irk;
  if (!bwd_takes(B, H, W, C, wc, ks)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bwd_strip_route(go, w, gx, H, W, C, wc, ks, fp32 ? 4 : 2, th, ring,
                      split, false)) {
    const BwdArgs a{go, w, gx, B, H, W, C, wc, th, split};
    const int n_strips = B * ((H + th - 1) / th);
    return bwd_strip_dispatch<false>(
        a, fp32, ring, ring == 1 || grid <= 0 || grid > n_strips ? n_strips
                                                                 : grid,
        s, nullptr);
  }
  const long long total = static_cast<long long>(B) * H * W * C;
  if (fp32)
    ska_bwd_x_kernel<float><<<bwd_blocks(total), SKA_BWD_THREADS, 0, s>>>(
        static_cast<const float*>(go), static_cast<const float*>(w),
        static_cast<float*>(gx), H, W, C, wc, ks, total);
  else
    ska_bwd_x_kernel<bf16><<<bwd_blocks(total), SKA_BWD_THREADS, 0, s>>>(
        static_cast<const bf16*>(go), static_cast<const bf16*>(w),
        static_cast<bf16*>(gx), H, W, C, wc, ks, total);
  return cudaGetLastError();
}

// gw (B, H, W, wc, ks^2) from go and x (B, H, W, C), as ir_ska_bwd_x (the
// strip kernel's `split` 1, 2 or 4 divides a unit's 8 channels).
int ir_ska_bwd_w(const void* go, const void* x, void* gw, int B, int H,
                 int W, int C, int wc, int ks, int fp32, int th, int ring,
                 int split, int grid, void* stream) {
  using namespace irk;
  if (!bwd_takes(B, H, W, C, wc, ks)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bwd_strip_route(go, x, gw, H, W, C, wc, ks, fp32 ? 4 : 2, th, ring,
                      split, true)) {
    const BwdArgs a{go, x, gw, B, H, W, C, wc, th, split};
    const int n_strips = B * ((H + th - 1) / th);
    return bwd_strip_dispatch<true>(
        a, fp32, ring, ring == 1 || grid <= 0 || grid > n_strips ? n_strips
                                                                 : grid,
        s, nullptr);
  }
  const long long total = static_cast<long long>(B) * H * W * wc * ks * ks;
  if (fp32)
    ska_bwd_w_kernel<float><<<bwd_blocks(total), SKA_BWD_THREADS, 0, s>>>(
        static_cast<const float*>(go), static_cast<const float*>(x),
        static_cast<float*>(gw), H, W, C, wc, ks, total);
  else
    ska_bwd_w_kernel<bf16><<<bwd_blocks(total), SKA_BWD_THREADS, 0, s>>>(
        static_cast<const bf16*>(go), static_cast<const bf16*>(x),
        static_cast<bf16*>(gw), H, W, C, wc, ks, total);
  return cudaGetLastError();
}

}  // extern "C"
