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
// gate channels, accumulating each chunk's act @ W_out into output
// fragments that the warps hold in registers.
//
// What bounds it on the card: by its bound the x read and the output write
// (2 x H*W*C bf16) or the fp32 taps; in fact the FFN tail's short stages
// between barriers (gdfn.cuh says what the design does about them). Here,
// cp.async stages the x halo tile into ys in 16-byte copies, and LN2 runs
// in place on it, 8 lanes a pixel.
//
// Shared memory: K2's (ApplySmem) without the v and ao staging: the LN'd
// halo tile, and one region that the fp32 output tile shares with one
// chunk's weights, taps, content|gate and act; gdfn.cuh lists the bytes.
#include "gdfn.cuh"

namespace irk {

template <int NF, int NW>
__global__ void __launch_bounds__(NW * 32) ln_gdfn_kernel(ApplyArgs a) {
  constexpr int A_THREADS = NW * 32, A_WARPS = NW;
  extern __shared__ __align__(128) unsigned char smem[];
  const ApplySmem L(a.C, a.th, false);
  bf16* ys = reinterpret_cast<bf16*>(smem + L.off_y);
  float* oacc = reinterpret_cast<float*>(smem + L.off_o);

  const int C = a.C, b = blockIdx.y, t = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Halo hl{(t / a.tiles_w) * a.th, (t % a.tiles_w) * TILE_W, a.H, a.W};
  const size_t img = (size_t)b * a.H * a.W * C;

  // The x halo tile goes to ys first, 16 bytes a copy and zeros outside the
  // image; oacc is cleared meanwhile.
  const int per_row = C / 8;
  for (int i = tid; i < L.Pp * per_row; i += A_THREADS) {
    const int p = i / per_row, s = i % per_row * 8;
    const int gr = hl.r0 - 1 + p / L.hcols, gc = hl.c0 - 1 + p % L.hcols;
    const bool in = p < L.P && hl.inside(gr, gc);
    cp_async16(ys + p * L.ldy + s,
               in ? a.x + img + ((size_t)gr * a.W + gc) * C + s : a.x, in);
  }
  cp_async_commit();
  for (int i = tid; i < L.npix * L.ldo; i += A_THREADS) oacc[i] = 0.f;
  cp_async_wait_group<0>();
  __syncthreads();

  // LN2 of the halo tile in place, 8 lanes a pixel; centre pixels also seed
  // the output accumulator with x + b_out (the block's residual).
  for (int p0 = warp * 4; p0 < L.P; p0 += A_WARPS * 4) {
    const int p = p0 + lane / 8;
    const int hr = p / L.hcols, hc = p % L.hcols;
    const bool live =
        p < L.P && hl.inside(hl.r0 - 1 + hr, hl.c0 - 1 + hc);
    const bool centre = hr >= 1 && hr <= a.th && hc >= 1 && hc <= TILE_W;
    bf16* yrow = ys + p * L.ldy;
    float* orow = oacc + ((hr - 1) * TILE_W + hc - 1) * L.ldo;
    group8_layernorm(
        live, C, a.eps, a.ln_w, a.ln_b, lane % 8,
        [&](int v, float(&x)[8]) {
          unpack8(*reinterpret_cast<const uint4*>(yrow + v * 8), x);
        },
        [&](int v, const float(&x)[8], const float(&y)[8]) {
          if (centre) {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              orow[v * 8 + e] = x[e] + (a.bo ? a.bo[v * 8 + e] : 0.f);
          }
          *reinterpret_cast<uint4*>(yrow + v * 8) = pack8(y);
        });
  }
  __syncthreads();

  gdfn_tail<NF, NW>(a, L, hl, smem, img);
}

struct LaunchLnGdfn {
  ApplyArgs a;
  dim3 grid;
  size_t smem;
  cudaStream_t stream;
  template <int NF, int NW>
  cudaError_t run() const {
    cudaError_t e = cudaFuncSetAttribute(
        ln_gdfn_kernel<NF, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    ln_gdfn_kernel<NF, NW><<<grid, NW * 32, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace irk

extern "C" {

// Dynamic shared memory one block of the kernel needs; above the card's
// limit for a tile whose output fragments no instantiation holds.
int ir_ln_gdfn_smem(int C, int th, int warps) {
  if (!irk::tail_frags(C, th, warps)) return irk::SMEM_LIMIT + 1;
  return static_cast<int>(irk::ApplySmem(C, th, false).total);
}

// Launches the kernel on `stream`, one block per output tile and batch
// image. `hp` is the hidden width padded to a multiple of 32; `warps` (8 or
// 16) the block size. Returns cudaGetLastError().
int ir_ln_gdfn(const void* x, const void* ln_w, const void* ln_b,
               const void* wcg, const void* bcg, const void* dwcg,
               const void* dbcg, const void* wo, const void* bo, void* out,
               int B, int H, int W, int C, int hp, int th, int warps,
               float eps, void* stream) {
  using namespace irk;
  const ApplySmem L(C, th, false);
  if (L.total > static_cast<size_t>(SMEM_LIMIT) || hp % NH || C % 16)
    return cudaErrorInvalidValue;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  ApplyArgs a{nullptr, static_cast<const bf16*>(x), nullptr, nullptr,
              static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
              static_cast<const bf16*>(wcg), static_cast<const float*>(bcg),
              static_cast<const float*>(dwcg), static_cast<const float*>(dbcg),
              static_cast<const bf16*>(wo), static_cast<const float*>(bo),
              static_cast<bf16*>(out), H, W, C, hp, th, tiles_w, eps};
  return dispatch_tail(
      C, th, warps,
      LaunchLnGdfn{a, dim3(tiles, B), L.total,
                   static_cast<cudaStream_t>(stream)});
}

}  // extern "C"
