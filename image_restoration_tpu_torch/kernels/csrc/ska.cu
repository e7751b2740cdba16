// SKA dynamic convolution (LSNet's Sparse Kernel Aggregation), forward:
//
//   out[b,i,j,c] = sum_{kh,kw} x[b, i-p+kh, j-p+kw, c] * w[b,i,j, c mod wc, kh*ks+kw]
//
// on x (B, H, W, C) and w (B, H, W, wc, ks*ks), both contiguous, zero
// padding p = (ks-1)/2, fp32 sums in tap order, the output rounded once to
// x's type (bf16 or fp32). Replaces the TPU kernel
// image_restoration_tpu/kernels/ska_pallas.py `_ska_kernel`; its
// workarounds (channels padded to 128 lanes, the weights transposed
// k^2-major, the whole-row halo tile DMA'd to VMEM) are not carried over.
//
// What bounds it on the card: device-memory bytes. Each output reads one
// pixel of x, its wc*k^2 weights and writes one pixel, and does 2*k^2 flops
// per channel: at LSNet-B's widths (C = 8 wc, k = 3) that is ~0.6 flop per
// byte, far below the card's ~20 fp32 flops per byte. The design moves each
// byte of device memory once and does nothing else:
// - ska_vec3_kernel (k = 3, C and wc multiples of 8, 16-byte aligned
//   pointers): one thread per (pixel, 8-channel vector), 16-byte loads
//   along C. Neighbouring threads take neighbouring vectors of one pixel and
//   then the next pixel of the row, so every load of a warp is contiguous.
//   The 3x3 neighbourhood of x is read through the read-only L1 path: each
//   x pixel is requested by 9 outputs but fetched from device memory once.
//   The weights are read in their natural layout: channels c0..c0+7 use
//   weight channels c0 mod wc .. +7, whose 8 x 9 taps are 72 contiguous
//   values (nine 16-byte loads for bf16), held in registers as loaded. The
//   C / wc threads of a pixel that share them hit L1 after the first.
// - ska_scalar_kernel (any odd k, any C with C % wc == 0): one thread per
//   output value, scalar loads; the small widths of the tests (wc = 2, 6)
//   and unaligned views take it.
#include "common.cuh"

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

template <typename T>
__global__ void __launch_bounds__(SKA_THREADS)
    ska_vec3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int H, int W, int C, int wc,
                    long long total) {
  constexpr int K2 = 9;
  constexpr int PER = 16 / sizeof(T);  // values per 16-byte load
  const long long i = static_cast<long long>(blockIdx.x) * SKA_THREADS +
                      threadIdx.x;
  if (i >= total) return;
  const int nv = C / 8;
  const int c0 = static_cast<int>(i % nv) * 8;
  const long long pix = i / nv;  // (b * H + r) * W + j
  const int j = static_cast<int>(pix % W);
  const long long row = pix / W;  // b * H + r
  const int r = static_cast<int>(row % H);

  uint4 wr[8 * K2 / PER];  // w[pix, c0 mod wc + e, k] at e * 9 + k
  const uint4* wsrc =
      reinterpret_cast<const uint4*>(w + (pix * wc + c0 % wc) * K2);
#pragma unroll
  for (int q = 0; q < 8 * K2 / PER; ++q) wr[q] = __ldg(wsrc + q);
  const T* wv = reinterpret_cast<const T*>(wr);

  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int rr = r - 1 + kh;
    if (rr < 0 || rr >= H) continue;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int cc = j - 1 + kw;
      if (cc < 0 || cc >= W) continue;
      uint4 xr[8 / PER];
      const uint4* xsrc = reinterpret_cast<const uint4*>(
          x + ((row - r + rr) * W + cc) * C + c0);
#pragma unroll
      for (int q = 0; q < 8 / PER; ++q) xr[q] = __ldg(xsrc + q);
      const T* xv = reinterpret_cast<const T*>(xr);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[e] = fmaf(to_f(xv[e]), to_f(wv[e * K2 + kh * 3 + kw]), acc[e]);
    }
  }
  uint4 orr[8 / PER];
  T* ov = reinterpret_cast<T*>(orr);
#pragma unroll
  for (int e = 0; e < 8; ++e) ov[e] = from_f<T>(acc[e]);
  uint4* dst = reinterpret_cast<uint4*>(out + pix * C + c0);
#pragma unroll
  for (int q = 0; q < 8 / PER; ++q) dst[q] = orr[q];
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

template <typename T>
int launch_ska(const void* x, const void* w, void* out, int B, int H, int W,
               int C, int wc, int ks, cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out);
  const bool vec = ks == 3 && C % 8 == 0 && wc % 8 == 0 && ptrs % 16 == 0;
  const long long total =
      static_cast<long long>(B) * H * W * (vec ? C / 8 : C);
  const unsigned blocks =
      static_cast<unsigned>((total + SKA_THREADS - 1) / SKA_THREADS);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (vec)
    ska_vec3_kernel<T><<<blocks, SKA_THREADS, 0, stream>>>(xt, wt, ot, H, W,
                                                           C, wc, total);
  else
    ska_scalar_kernel<T><<<blocks, SKA_THREADS, 0, stream>>>(
        xt, wt, ot, H, W, C, wc, ks, total);
  return cudaGetLastError();
}

}  // namespace irk

extern "C" {

// Launches the SKA forward on `stream`; `fp32` selects float over bf16 for
// x, w and out alike. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for an empty or malformed shape (C not a multiple of wc, even ks).
int ir_ska(const void* x, const void* w, void* out, int B, int H, int W,
           int C, int wc, int ks, int fp32, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || wc <= 0 || C % wc ||
      ks <= 0 || ks % 2 == 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp32 ? irk::launch_ska<float>(x, w, out, B, H, W, C, wc, ks, s)
              : irk::launch_ska<irk::bf16>(x, w, out, B, H, W, C, wc, ks, s);
}

}  // extern "C"
