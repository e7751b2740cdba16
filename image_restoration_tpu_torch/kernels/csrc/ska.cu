// SKA dynamic convolution (LSNet's Sparse Kernel Aggregation), forward:
//
//   out[b,i,j,c] = sum_{kh,kw} x[b, i-p+kh, j-p+kw, c] * w[b,i,j, c mod wc, kh*ks+kw]
//
// on x (B, H, W, C) and w (B, H, W, wc, ks*ks), both contiguous, zero
// padding p = (ks-1)/2, fp32 sums in tap order, the output rounded once to
// x's type (bf16 or fp32). Replaces the TPU kernel
// image_restoration_tpu/kernels/ska_pallas.py `_ska_kernel`; its
// workarounds (channels padded to 128 lanes, the weights transposed
// k^2-major) are not carried over. Its tile of whole image rows with a
// one-row halo is.
//
// What bounds it on the card: device-memory bytes. Each output reads one
// pixel of x, its wc*k^2 weights and writes one pixel, and does 2*k^2 flops
// per channel: at LSNet-B's widths (C = 8 wc, k = 3) that is ~0.6 flop per
// byte, far below the card's ~20 fp32 flops per byte. So the design moves
// each byte of device memory once, keeps enough of them in flight, and
// keeps the instructions per output few, since in bf16 each of the nine
// taps also converts its x value:
// - ska_strip_kernel (k = 3, wc a multiple of 8, 16-byte aligned
//   pointers): a block takes a strip of `th` whole image rows with all C
//   channels. It stages the strip's x with a one-pixel halo and the
//   strip's weights (one contiguous range) into shared memory by 16-byte
//   cp.async, rows outside the image zero-filled and the halo columns
//   zeroed once, so the taps need no bounds checks. With `ring` 2 blocks
//   are persistent (as many as the card holds) and keep the next strip's
//   copies in flight while they compute; with ring 1 each block takes one
//   strip. One thread takes one (pixel, 8 weight channels) unit,
//   or its share of the unit's channel repeats (`split` threads a unit):
//   it converts its 72 weights to fp32 registers once and loops over the
//   C / wc channel repeats that share them, reading x's nine 8-channel
//   vectors from shared memory by 32-bit shared-space addresses and
//   writing each result with 16-byte stores. fp32 x is staged as two
//   planes (the halves of each 8-channel group), and each plane's pixel
//   stride is padded to 16 G bytes mod 128 (G = wc / 8): the eight lanes of
//   a 16-byte shared-memory phase then hit eight different bank groups. No
//   64-bit division.
// - ska_scalar_kernel (any odd k, any C with C % wc == 0): one thread per
//   output value, scalar loads; the small widths of the tests (wc = 2, 6),
//   k = 5 and unaligned views take it, and so do rows too wide for even a
//   one-row strip to fit in shared memory.
#include <algorithm>
#include <atomic>

#include "ska.cuh"

namespace irk {

constexpr int SKA_THREADS = 256;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

struct StripArgs {
  const void* x;
  const void* w;
  void* out;
  int B, H, W, C, wc, th, split;
};

template <typename T, int RING>
__global__ void __launch_bounds__(256)
    ska_strip_kernel(const StripArgs a) {
  constexpr int NPL = sizeof(T) / 2;  // x planes
  constexpr int PER = 16 / sizeof(T);  // values a 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int H = a.H, W = a.W, C = a.C, wc = a.wc, th = a.th;
  const StripSmem L(W, C, wc, th, sizeof(T), RING);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int G = wc / 8, reps = C / wc / a.split;  // repeats a thread
  const int xch = C / PER;  // x chunks a pixel
  const int spi = (H + th - 1) / th;
  const int n_strips = a.B * spi;
  // this thread's first x chunk of a strip and its stride, as (pixel,
  // chunk) steps, so that the staging loop divides nothing
  const int k0 = tid % xch, p0 = tid / xch;
  const int dk = nt % xch, dp = nt / xch;

  {  // the halo columns of every slot and plane, zeroed once
    const int per = L.S / 16, rows = RING * NPL * (th + 2);
    for (int q = tid; q < rows * 2 * per; q += nt) {
      const int r = q / (2 * per), side = q / per % 2, k = q % per;
      const int sl = r / (NPL * (th + 2)), pl = r / (th + 2) % NPL;
      unsigned char* dst = smem + sl * L.slot + pl * L.plane +
                           (r % (th + 2) * L.W2 + side * (W + 1)) * L.S +
                           k * 16;
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  auto stage = [&](int s, int sl) {
    const int b = s / spi, r0 = (s - b * spi) * th;
    const int nr = min(th, H - r0);
    unsigned char* xs = smem + sl * L.slot;
    // x rows r0 - 1 .. r0 + nr follow each other in x: chunk q of them
    const long long first = (static_cast<long long>(b) * H + r0 - 1) * W * C;
    const int nx = (nr + 2) * W * xch;
    int k = k0, i = p0 / W, j = p0 - i * W;
    for (int q = tid; q < nx; q += nt) {
      const int rr = r0 - 1 + i;
      const bool valid = rr >= 0 && rr < H;
      const T* src = valid ? x + first + static_cast<long long>(q) * PER : x;
      cp_async16(xs + (k % NPL) * L.plane + (i * L.W2 + j + 1) * L.S +
                     (k / NPL) * 16,
                 src, valid);
      k += dk;
      j += dp;
      if (k >= xch) k -= xch, ++j;
      while (j >= W) j -= W, ++i;
    }
    // the strip's weights: one contiguous range
    const T* wsrc = w + (static_cast<long long>(b) * H + r0) * W * wc * 9;
    const int nw = nr * W * wc * 9 / PER;
    for (int q = tid; q < nw; q += nt)
      cp_async16(xs + L.xbytes + q * 16, wsrc + q * PER, true);
  };

  // Thread u takes the (pixel, 8 weight channels) unit u % units and the
  // u / units-th share of its channel repeats.
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  auto compute = [&](int s, int sl) {
    const int b = s / spi, r0 = (s - b * spi) * th;
    const int nr = min(th, H - r0);
    const unsigned xs = sbase + sl * L.slot, ws = xs + L.xbytes;
    const int units = nr * W * G;
    int toff[9];  // tap t's byte offset from tap (0, 0)
#pragma unroll
    for (int t = 0; t < 9; ++t) toff[t] = (t / 3 * L.W2 + t % 3) * L.S;
    for (int u = tid; u < units * a.split; u += nt) {
      const int part = u / units, v = u - part * units;
      const int p = v / G, g = v - p * G;
      const int i = p / W, j = p - i * W;
      float wf[72];  // w[pixel, 8 g + e, t] at e * 9 + t
#pragma unroll
      for (int q = 0; q < 72 / PER; ++q) {
        const uint4 wv = lds128(ws + (v * 72 / PER + q) * 16);
        const T* vt = reinterpret_cast<const T*>(&wv);
#pragma unroll
        for (int e = 0; e < PER; ++e) wf[q * PER + e] = to_f(vt[e]);
      }
      // tap (0, 0) of output (r0 + i, j) is slot row i, column j
      const int rep0 = part * reps;
      unsigned xb = xs + (i * L.W2 + j) * L.S + (rep0 * G + g) * 16;
      T* dst = out + ((static_cast<long long>(b) * H + r0 + i) * W + j) * C +
               rep0 * wc + g * 8;
#pragma unroll 1
      for (int r = 0; r < reps; ++r, xb += G * 16, dst += wc) {
        float acc[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          float xv[8];
          load_x8(xb + toff[t], L.plane, x, xv);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[e] = fmaf(xv[e], wf[e * 9 + t], acc[e]);
        }
        store8(dst, acc);
      }
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
    compute(s, it % RING);
    __syncthreads();  // the slot is refilled next
  }
}

template <typename T>
__global__ void __launch_bounds__(SKA_THREADS)
    ska_scalar_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      T* __restrict__ out, int H, int W, int C, int wc,
                      int ks, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * SKA_THREADS +
                      threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % C);
  const long long pix = i / C;
  const int j = static_cast<int>(pix % W);
  const long long row = pix / W;
  const int r = static_cast<int>(row % H);
  const int p = (ks - 1) / 2;
  const T* wp = w + (pix * wc + c % wc) * ks * ks;
  float acc = 0.f;
  for (int kh = 0; kh < ks; ++kh) {
    const int rr = r - p + kh;
    if (rr < 0 || rr >= H) continue;
    for (int kw = 0; kw < ks; ++kw) {
      const int cc = j - p + kw;
      if (cc < 0 || cc >= W) continue;
      acc = fmaf(to_f(__ldg(x + ((row - r + rr) * W + cc) * C + c)),
                 to_f(__ldg(wp + kh * ks + kw)), acc);
    }
  }
  out[i] = from_f<T>(acc);
}

// The strip kernel's configuration: `th` rows a strip, `ring` slots (1, 2),
// each unit's channel repeats split over `split` threads, within the card's
// shared memory.
static bool strip_takes(int W, int C, int wc, int esize, int th, int ring,
                        int split) {
  return wc > 0 && wc % 8 == 0 && C % wc == 0 && th >= 1 && ring >= 1 &&
         ring <= 2 && split >= 1 && C / wc % split == 0 &&
         static_cast<long long>(th + 2) * (W + 2) * C * esize <= SMEM_LIMIT &&
         StripSmem(W, C, wc, th, esize, ring).total <= SMEM_LIMIT;
}

// Threads of a strip-kernel block: one a (pixel, 8 weight channels) unit
// share of a full strip, in whole warps, at most 256.
static int strip_threads(int W, int wc, int th, int split) {
  const long long n = static_cast<long long>(th) * W * (wc / 8) * split;
  return 32 * static_cast<int>(std::min(8LL, std::max(1LL, (n + 31) / 32)));
}

// Lets ska_strip_kernel<T, RING> take the card's whole shared memory, once
// a device (the attribute is set by the first call on each).
template <typename T, int RING>
static cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(ska_strip_kernel<T, RING>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_LIMIT);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// Launches the strip kernel for `ring` slots on `grid` blocks or, with
// `blocks` given, only asks how many blocks an SM holds.
template <typename T>
static cudaError_t strip_launch(const StripArgs& a, int ring, int grid,
                                cudaStream_t stream, int* blocks) {
  const int smem = StripSmem(a.W, a.C, a.wc, a.th, sizeof(T), ring).total;
  const int threads = strip_threads(a.W, a.wc, a.th, a.split);
  const auto kernel =
      ring == 1 ? ska_strip_kernel<T, 1> : ska_strip_kernel<T, 2>;
  cudaError_t e = ring == 1 ? allow_smem<T, 1>() : allow_smem<T, 2>();
  if (e != cudaSuccess) return e;
  if (blocks)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         threads, smem);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace irk

extern "C" {

// Strip-kernel blocks one SM holds at once (`fp32` selects float over
// bf16); 0 where the configuration does not fit the card.
int ir_ska_blocks(int W, int C, int wc, int fp32, int th, int ring,
                  int split) {
  using namespace irk;
  if (!strip_takes(W, C, wc, fp32 ? 4 : 2, th, ring, split)) return 0;
  const StripArgs a{nullptr, nullptr, nullptr, 1, th, W, C, wc, th, split};
  int blocks = 0;
  const cudaError_t e =
      fp32 ? strip_launch<float>(a, ring, 0, nullptr, &blocks)
           : strip_launch<bf16>(a, ring, 0, nullptr, &blocks);
  return e == cudaSuccess ? blocks : 0;
}

// Launches the SKA forward on `stream`; `fp32` selects float over bf16 for
// x, w and out alike. k = 3 with wc a multiple of 8, 16-byte aligned
// pointers and a strip configuration (th, ring, split) that fits
// takes the strip kernel on `grid` blocks (ring 1: one strip a block
// whatever `grid`); anything else the scalar kernel. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an empty or malformed
// shape (C not a multiple of wc, even ks).
int ir_ska(const void* x, const void* w, void* out, int B, int H, int W,
           int C, int wc, int ks, int fp32, int th, int ring, int split,
           int grid, void* stream) {
  using namespace irk;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || wc <= 0 || C % wc ||
      ks <= 0 || ks % 2 == 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int esize = fp32 ? 4 : 2;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out);
  if (ks == 3 && ptrs % 16 == 0 &&
      strip_takes(W, C, wc, esize, th, ring, split)) {
    const StripArgs a{x, w, out, B, H, W, C, wc, th, split};
    const int n_strips = B * ((H + th - 1) / th);
    const int blocks =
        ring == 1 || grid <= 0 || grid > n_strips ? n_strips : grid;
    return fp32 ? strip_launch<float>(a, ring, blocks, s, nullptr)
                : strip_launch<bf16>(a, ring, blocks, s, nullptr);
  }
  const long long total = static_cast<long long>(B) * H * W * C;
  const unsigned blocks =
      static_cast<unsigned>((total + SKA_THREADS - 1) / SKA_THREADS);
  if (fp32)
    ska_scalar_kernel<float><<<blocks, SKA_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), H, W, C, wc, ks, total);
  else
    ska_scalar_kernel<bf16><<<blocks, SKA_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), H, W, C, wc, ks, total);
  return cudaGetLastError();
}

}  // extern "C"
