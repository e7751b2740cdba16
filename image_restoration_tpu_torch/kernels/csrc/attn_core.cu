// The attention core of the three-kernel Restormer block, on the qkv map of
// ln_qkv_dwconv.cu: (B, H, W, 3C) bf16, channels [q | k | v], head-major.
//
// Replaces the TPU kernels image_restoration_tpu/kernels/attn_core_pallas.py
// `_acc_kernel` (pass A) and `_apply_kernel` (pass B), behind
// `fused_mdta_core`; the finalize between them stays plain torch
// (kernels/attn_core.py `finalize_at`).
//
// Pass A, attn_acc_kernel (K5): the per-head q^T k (fp32) and the
// per-channel sums of squares of the bf16 q and k widened to fp32, over all
// H*W pixels. Only the per-head diagonal (ch x ch) blocks of q^T k are
// computed: they are all the finalize reads (the TPU's full C x C product
// is an artefact of its 128-lane layout). The TPU carries the sums across
// a sequential grid; Hopper blocks run in no order, so each block walks a
// strided set of 128-pixel tiles, stages one head's q and k at a time in
// shared memory (16-byte cp.async), accumulates its Gram there with
// acc_gram (wmma), and writes one partial; front_reduce_kernel (front.cuh,
// K1's) sums the partials in a fixed order, so the result is deterministic.
//
// Pass B, attn_apply_kernel (K6): out = bf16(x + (bf16(v @ A^T) @ W_proj +
// b_proj)) per tile of `npix` pixels. t = v @ A^T is computed head by head
// (A^T is block-diagonal), accumulated in fp32 and rounded to bf16 before
// the second product, as the TPU kernel rounds it; A^T is not folded into
// W_proj (that is the whole-block pair's rounding, not this kernel's).
//
// What bounds them on the card: both are bytes-bound by their bound (K5
// reads q and k once, K6 reads v and x and writes out once; their products
// are 2 * ch and 2 * (ch + C) multiply-adds per channel and pixel). This
// first version loads with cp.async but does not pipeline the loads
// against the products (no TMA, no wgmma).
#include "front.cuh"

namespace irk {

constexpr int C_THREADS = 256;  // 8 warps
constexpr int C_WARPS = C_THREADS / 32;
constexpr int ACC_PIX = 128;    // pixels per pass-A tile

// gram[ch x ch] += q^T[ch x npix] @ k[npix x ch], the accumulator in shared
// memory; q and k rows `ldq` apart, npix a multiple of 16.
static __device__ void acc_gram(int npix, int ldq, int ch, const bf16* qs,
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

struct AccSmem {
  int ldq;
  size_t off_q, off_k, off_g, off_ss, total;
  __host__ __device__ AccSmem(int C, int heads) {
    const int ch = C / heads;
    ldq = ch + 8;
    size_t o = 0;
    off_q = o; o = align128(o + sizeof(bf16) * ACC_PIX * ldq);
    off_k = o; o = align128(o + sizeof(bf16) * ACC_PIX * ldq);
    off_g = o; o = align128(o + sizeof(float) * C * ch);
    off_ss = o; o = align128(o + sizeof(float) * 2 * C);
    total = o;
  }
};

__global__ void __launch_bounds__(C_THREADS)
    attn_acc_kernel(const bf16* __restrict__ qkv, float* gram_part,
                    float* ss_part, int HW, int C, int heads, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AccSmem L(C, heads);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.off_q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.off_k);
  float* gacc = reinterpret_cast<float*>(smem + L.off_g);
  float* ssacc = reinterpret_cast<float*>(smem + L.off_ss);

  const int ch = C / heads, ng = C * ch, C3 = 3 * C, nchunk = ch / 8;
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid / 32;
  for (int i = tid; i < ng; i += C_THREADS) gacc[i] = 0.f;
  for (int i = tid; i < 2 * C; i += C_THREADS) ssacc[i] = 0.f;
  const bf16* img = qkv + (size_t)b * HW * C3;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int p0 = t * ACC_PIX;
    for (int h = 0; h < heads; ++h) {
      __syncthreads();  // the last head's Gram and sums are done with qs/ks
      // q and k of head h for the tile's pixels, 8 channels per copy;
      // pixels past the image become zeros and add nothing
      for (int i = tid; i < 2 * ACC_PIX * nchunk; i += C_THREADS) {
        const int part = i / (ACC_PIX * nchunk);
        const int r = (i / nchunk) % ACC_PIX, c8 = i % nchunk;
        const int pix = p0 + r;
        const bool valid = pix < HW;
        const bf16* src = img + (size_t)(valid ? pix : 0) * C3 + part * C +
                          h * ch + c8 * 8;
        cp_async16((part ? ks : qs) + r * L.ldq + c8 * 8, src, valid);
      }
      cp_async_wait_all();
      __syncthreads();
      acc_gram(ACC_PIX, L.ldq, ch, qs, ks, gacc + h * ch * ch, warp,
                 C_WARPS);
      for (int j = tid; j < 2 * ch; j += C_THREADS) {
        const int part = j / ch, c = j % ch;
        const bf16* src = (part ? ks : qs) + c;
        float s = 0.f;
        for (int r = 0; r < ACC_PIX; ++r) {
          const float v = bf2f(src[r * L.ldq]);
          s += v * v;
        }
        ssacc[part * C + h * ch + c] += s;
      }
    }
  }
  __syncthreads();
  const size_t part = (size_t)b * gridDim.x + blockIdx.x;
  for (int i = tid; i < ng; i += C_THREADS) gram_part[part * ng + i] = gacc[i];
  for (int i = tid; i < 2 * C; i += C_THREADS)
    ss_part[part * 2 * C + i] = ssacc[i];
}

struct ApplyAttnSmem {
  int ldv, ldo;
  size_t off_v, off_o, total;
  __host__ __device__ ApplyAttnSmem(int C, int npix) {
    ldv = C + 8;
    ldo = C + 4;
    size_t o = 0;
    off_v = o; o = align128(o + sizeof(bf16) * npix * ldv);
    off_o = o; o = align128(o + sizeof(float) * npix * ldo);
    total = o;
  }
};

__global__ void __launch_bounds__(C_THREADS)
    attn_apply_kernel(const bf16* __restrict__ qkv,
                      const bf16* __restrict__ x, const bf16* __restrict__ at,
                      const bf16* __restrict__ wp, const float* bp, bf16* out,
                      int HW, int C, int heads, int npix) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ApplyAttnSmem L(C, npix);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.off_v);  // v, then bf16 t
  float* os = reinterpret_cast<float*>(smem + L.off_o);

  const int ch = C / heads, C3 = 3 * C, nchunk = C / 8;
  const int b = blockIdx.y, p0 = blockIdx.x * npix;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t pix0 = (size_t)b * HW;
  const bf16* atb = at + (size_t)b * heads * ch * ch;

  for (int i = tid; i < npix * nchunk; i += C_THREADS) {
    const int r = i / nchunk, c8 = i % nchunk;
    const int pix = p0 + r;
    const bool valid = pix < HW;
    cp_async16(vs + r * L.ldv + c8 * 8,
               qkv + (pix0 + (valid ? pix : 0)) * C3 + 2 * C + c8 * 8, valid);
  }
  cp_async_wait_all();
  __syncthreads();

  const int mt = npix / 16, nt = C / 16;
  // t[:, head h] = v[:, head h] @ A_h^T, fp32 accumulation
  for (int i = warp; i < mt * nt; i += C_WARPS) {
    const int mi = i / nt, ni = i % nt;
    const int h = ni * 16 / ch, j0 = ni * 16 - h * ch;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < ch; k += 16) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, vs + mi * 16 * L.ldv + h * ch + k, L.ldv);
      wmma::load_matrix_sync(fb, atb + ((size_t)h * ch + k) * ch + j0, ch);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(os + mi * 16 * L.ldo + ni * 16, acc, L.ldo,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < npix * C; i += C_THREADS) {
    const int r = i / C, c = i % C;
    vs[r * L.ldv + c] = f2bf(os[r * L.ldo + c]);
  }
  __syncthreads();
  // o = bf16(t) @ W_proj, fp32 accumulation
  for (int i = warp; i < mt * nt; i += C_WARPS) {
    const int mi = i / nt, ni = i % nt;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < C; k += 16) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, vs + mi * 16 * L.ldv + k, L.ldv);
      wmma::load_matrix_sync(fb, wp + (size_t)k * C + ni * 16, C);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(os + mi * 16 * L.ldo + ni * 16, acc, L.ldo,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int r = warp; r < npix; r += C_WARPS) {
    const int pix = p0 + r;
    if (pix >= HW) break;
    const bf16* xr = x + (pix0 + pix) * C;
    bf16* dst = out + (pix0 + pix) * C;
    const float* orow = os + r * L.ldo;
    for (int c = lane; c < C; c += 32)
      dst[c] = f2bf(bf2f(xr[c]) + (orow[c] + (bp ? bp[c] : 0.f)));
  }
}

}  // namespace irk

extern "C" {

// Dynamic shared memory of one pass-A block.
int ir_attn_acc_smem(int C, int heads) {
  return static_cast<int>(irk::AccSmem(C, heads).total);
}

// Launches pass A and the fixed-order reduction on `stream`: `grid_x`
// blocks per batch image walk the 128-pixel tiles; the partial buffers hold
// B * grid_x entries. gram is (B, heads, ch, ch), ss (B, 2, C). Returns
// cudaGetLastError().
int ir_attn_acc(const void* qkv, void* gram_part, void* ss_part, void* gram,
                void* ss, int B, int HW, int C, int heads, int grid_x,
                void* stream) {
  using namespace irk;
  const AccSmem L(C, heads);
  if (L.total > static_cast<size_t>(SMEM_LIMIT) || C % 16 ||
      (C / heads) % 16 || (C / heads) * heads != C)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attn_acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return e;
  const int tiles = (HW + ACC_PIX - 1) / ACC_PIX;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  attn_acc_kernel<<<dim3(grid_x, B), C_THREADS, L.total, s>>>(
      static_cast<const bf16*>(qkv), static_cast<float*>(gram_part),
      static_cast<float*>(ss_part), HW, C, heads, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_front_reduce(gram_part, ss_part, gram, ss, B, grid_x,
                             C * (C / heads), 2 * C, s);
}

// Dynamic shared memory of one pass-B block of `npix` pixels.
int ir_attn_apply_smem(int C, int npix) {
  return static_cast<int>(irk::ApplyAttnSmem(C, npix).total);
}

// Launches pass B on `stream`, one block per `npix` pixels (a multiple of
// 16) and batch image. at is (B, heads, ch, ch) = A^T per head, wp (C, C) =
// W_proj as (in, out), both bf16; bp (C) fp32 or null. Returns
// cudaGetLastError().
int ir_attn_apply(const void* qkv, const void* x, const void* at,
                  const void* wp, const void* bp, void* out, int B, int HW,
                  int C, int heads, int npix, void* stream) {
  using namespace irk;
  const ApplyAttnSmem L(C, npix);
  if (L.total > static_cast<size_t>(SMEM_LIMIT) || C % 16 || npix % 16 ||
      (C / heads) % 16 || (C / heads) * heads != C)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attn_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return e;
  attn_apply_kernel<<<dim3((HW + npix - 1) / npix, B), C_THREADS, L.total,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(x),
      static_cast<const bf16*>(at), static_cast<const bf16*>(wp),
      static_cast<const float*>(bp), static_cast<bf16*>(out), HW, C, heads,
      npix);
  return cudaGetLastError();
}

}  // extern "C"
