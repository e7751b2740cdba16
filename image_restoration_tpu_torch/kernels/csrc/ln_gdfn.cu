// x + GDFN(LN2(x)) of the three-kernel Restormer block, one tile of output
// per block.
//
// Replaces the TPU kernel image_restoration_tpu/kernels/gdfn_pallas.py
// `_gdfn_kernel` (behind `fused_ln_gdfn`). Per output tile, with a
// one-pixel halo:
//   y   = bf16(LN2(x))                     (fp32 statistics over the real C)
//   cg  = y @ [W_content | W_gate] + b     (fp32, masked to 0 outside)
//   act = bf16(gelu(dw3x3(cg_c)) * dw3x3(cg_g))   (exact erf GELU, fp32 taps)
//   out = bf16(act @ W_out + b_out + x)
// The rounding points are the TPU kernel's: content and gate stay fp32
// between the 1x1 and the depthwise conv.
//
// Its math is the tail of pass 2 of the whole-block pair (K2) with the
// attention output replaced by x, so it runs K2's device code (gdfn.cuh):
// only the first phase differs, which LNs the x halo tile instead of
// applying the attention. The 2.66 C-wide hidden activations never reach
// device memory; the kernel loops over hidden chunks of 32 content + 32
// gate channels, accumulating each chunk's act @ W_out into the fp32 output
// tile in shared memory.
//
// What bounds it on the card: by its bound the x read and the output write
// (2 x H*W*C bf16); like K2 this first version is held back by the scalar
// depthwise loop and unpipelined shared-memory traffic (no TMA, no wgmma).
//
// Shared memory: K2's (ApplySmem) without the v and ao staging: the LN'd
// halo tile, the fp32 output tile and one chunk's content|gate and act.
#include "gdfn.cuh"

namespace irk {

__global__ void __launch_bounds__(A_THREADS) ln_gdfn_kernel(ApplyArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ApplySmem L(a.C, a.th, false);
  bf16* ys = reinterpret_cast<bf16*>(smem + L.off_y);
  float* oacc = reinterpret_cast<float*>(smem + L.off_o);
  float* cg = reinterpret_cast<float*>(smem + L.off_cg);
  bf16* act = reinterpret_cast<bf16*>(smem + L.off_act);

  const int C = a.C, b = blockIdx.y, t = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Halo hl{(t / a.tiles_w) * a.th, (t % a.tiles_w) * TILE_W, a.H, a.W};
  const size_t img = (size_t)b * a.H * a.W * C;

  for (int i = tid; i < L.npix * L.ldo; i += A_THREADS) oacc[i] = 0.f;
  __syncthreads();

  // LN2 of the halo tile into ys; centre pixels also seed the output
  // accumulator with x + b_out (the block's residual).
  for (int p = warp; p < L.Pp; p += A_WARPS) {
    const int hr = p / L.hcols, hc = p % L.hcols;
    const int gr = hl.r0 - 1 + hr, gc = hl.c0 - 1 + hc;
    bf16* yrow = ys + p * L.ldy;
    if (p >= L.P || !hl.inside(gr, gc)) {
      for (int c = lane; c < C; c += 32) yrow[c] = f2bf(0.f);
      continue;
    }
    const bf16* xr = a.x + img + ((size_t)gr * a.W + gc) * C;
    warp_layernorm([&](int c) { return bf2f(xr[c]); }, C, a.eps, a.ln_w,
                   a.ln_b, yrow, lane);
    if (hr >= 1 && hr <= a.th && hc >= 1 && hc <= TILE_W) {
      float* orow = oacc + ((hr - 1) * TILE_W + hc - 1) * L.ldo;
      for (int c = lane; c < C; c += 32)
        orow[c] = bf2f(xr[c]) + (a.bo ? a.bo[c] : 0.f);
    }
  }
  __syncthreads();

  gdfn_tail(a, L, hl, ys, oacc, cg, act, img, tid, warp, lane);
}

}  // namespace irk

extern "C" {

// Dynamic shared memory one block of the kernel needs.
int ir_ln_gdfn_smem(int C, int th) {
  return static_cast<int>(irk::ApplySmem(C, th, false).total);
}

// Launches the kernel on `stream`, one block per output tile and batch
// image. `hp` is the hidden width padded to a multiple of 32. Returns
// cudaGetLastError().
int ir_ln_gdfn(const void* x, const void* ln_w, const void* ln_b,
               const void* wcg, const void* bcg, const void* dwcg,
               const void* dbcg, const void* wo, const void* bo, void* out,
               int B, int H, int W, int C, int hp, int th, float eps,
               void* stream) {
  using namespace irk;
  const ApplySmem L(C, th, false);
  if (L.total > static_cast<size_t>(SMEM_LIMIT) || hp % NH || C % 16)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ln_gdfn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return e;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  ApplyArgs a{nullptr, static_cast<const bf16*>(x), nullptr, nullptr,
              static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
              static_cast<const bf16*>(wcg), static_cast<const float*>(bcg),
              static_cast<const float*>(dwcg), static_cast<const float*>(dbcg),
              static_cast<const bf16*>(wo), static_cast<const float*>(bo),
              static_cast<bf16*>(out), H, W, C, hp, th, tiles_w, eps};
  ln_gdfn_kernel<<<dim3(tiles, B), A_THREADS, L.total,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
