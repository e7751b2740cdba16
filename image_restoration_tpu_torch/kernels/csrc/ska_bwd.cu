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
// LSNet's widths (C = 8 wc, k = 3) under one flop per byte moved, far
// below the card's ~20 fp32 flops per byte. The design is the simple one,
// right before fast: one thread per output value, the
// k^2 taps (gx) or the C/wc repeats (gw) summed in the thread, no shared
// memory and no atomics, so two runs give the same bits. A warp's threads
// take neighbouring channels (gx) or neighbouring (channel, tap) pairs
// (gw), so the stores and most loads are coalesced; the neighbours' reads
// come again from L1/L2.
#include "common.cuh"

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

// gx (B, H, W, C) from go (B, H, W, C) and w (B, H, W, wc, ks^2), all of
// one type (`fp32` selects float over bf16), contiguous, on `stream`.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an empty or
// malformed shape.
int ir_ska_bwd_x(const void* go, const void* w, void* gx, int B, int H,
                 int W, int C, int wc, int ks, int fp32, void* stream) {
  using namespace irk;
  if (!bwd_takes(B, H, W, C, wc, ks)) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(B) * H * W * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

// gw (B, H, W, wc, ks^2) from go and x (B, H, W, C), as ir_ska_bwd_x.
int ir_ska_bwd_w(const void* go, const void* x, void* gw, int B, int H,
                 int W, int C, int wc, int ks, int fp32, void* stream) {
  using namespace irk;
  if (!bwd_takes(B, H, W, C, wc, ks)) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(B) * H * W * wc * ks * ks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
