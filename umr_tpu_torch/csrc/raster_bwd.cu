// Tile-binned soft rasterizer, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel umr_tpu/ops/raster_kernel_bwd.py::_bwd_kernel:
// the reference CUDA backward's gradients (external/SoftRas/.../
// soft_rasterize_cuda_kernel.cu:479-656) of a softmax / product-alpha
// render with respect to the face vertices and the surface texels, with
// its semantics: a pair whose depth is outside [near, far] gives no
// gradient at all; dA/dD = (1 - A) / max(1 - D, 1e-6); rgb_geom_detach
// sends rgb gradients to texels only; tex_grads = 0 gives none to texels;
// mask_only has a zero rgb cotangent. The plain version is
// umr_tpu_torch/ops/rasterize_bwd.py.
//
// What bounds it on this card: the per-pair ALU work, as in the forward.
// Each (pixel, binned face) pair recomputes the forward's pair arithmetic
// (~180 operations; it is cheaper to redo than to store) and adds ~60 for
// the gradient chain. The bytes are the forward's inputs plus rgba, aggr
// and the cotangent, read once (40 bytes per pixel), and the gradients,
// written once.
//
// What the design does about it:
//   * one block per (32x32 tile, image), 256 threads of 4 pixels, over the
//     forward's own bin layout (al_fids, astarts, mf_cap), so exactly the
//     rendered fragments get gradients; a thread keeps its pixels'
//     cotangent, colour, alpha and softmax (sum, max) in registers;
//   * faces are staged CH at a time in shared memory with their setup
//     computed once (raster_common.cuh, shared with the forward);
//   * the TPU kernel wrote one 128-lane row per binned entry to device
//     memory and segment-summed it in XLA (no atomics there). Here each
//     entry's 9 vertex lanes are summed over the tile's pixels inside the
//     block: over a thread's 4 pixels in registers, over the warp with
//     shuffles (skipped when no lane of the warp touched the face), then
//     into a per-face slot in shared memory. Each pixel selects one texel
//     per face, so the 3*T2 texel lanes go to a per-face accumulator in
//     shared memory with shared-memory atomics. After the chunk every
//     non-zero lane is added once to grad_faces / grad_tex with a global
//     atomicAdd (the wrapper zeroes both). The sums therefore run in an
//     order that changes from run to run.
//
// Numerics: --fmad=false, no --use_fast_math, the plain version's
// expressions in its order (see raster_common.cuh).

#include "raster_common.cuh"

using namespace umr;

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NTH)
raster_bwd_kernel(const float* __restrict__ fv,      // [B, F, 3, 3]
                  const float* __restrict__ tex,     // [B, F, T2, 3]
                  const int* __restrict__ al_fids,   // [B, E_al]
                  const int* __restrict__ astarts,   // [B, n_tiles + 1]
                  const float* __restrict__ rgba,    // [B, S, S, 4]
                  const float* __restrict__ aggr,    // [B, 2, S, S]
                  const float* __restrict__ g_rgba,  // [B, S, S, 4]
                  float* __restrict__ grad_fv,       // [B, F, 3, 3]
                  float* __restrict__ grad_tex,      // [B, F, T2, 3]
                  Params p, bool want_tex, bool want_z) {
  extern __shared__ float smem[];
  const int T3 = p.T2 * 3;
  float* s_face = smem;                        // [CH][NF]
  int* s_fid = (int*)(s_face + CH * NF);       // [CH], -1 = skip
  float* s_gv = (float*)(s_fid + CH);          // [CH][9] vertex lanes
  float* s_tex = s_gv + CH * 9;                // [CH][T3] if want_z
  float* s_gt = s_tex + (want_z ? CH * T3 : 0);  // [CH][T3] if want_tex

  const int t = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t plane = (size_t)p.S * p.S;

  float xp[PPT], yp[PPT], g[PPT][4], rgb[PPT][3], alpha[PPT], rs[PPT],
      m[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    int row, col;
    pixel_of(t, q, p, row, col, xp[q], yp[q]);
    const size_t pix = (size_t)b * plane + (size_t)row * p.S + col;
    const float4 gq = reinterpret_cast<const float4*>(g_rgba)[pix];
    const float4 cq = reinterpret_cast<const float4*>(rgba)[pix];
    g[q][0] = gq.x;
    g[q][1] = gq.y;
    g[q][2] = gq.z;
    g[q][3] = gq.w;
    rgb[q][0] = cq.x;
    rgb[q][1] = cq.y;
    rgb[q][2] = cq.z;
    alpha[q] = cq.w;
    const size_t pa = ((size_t)b * 2) * plane + (size_t)row * p.S + col;
    rs[q] = 1.0f / aggr[pa];
    m[q] = aggr[pa + plane];
  }

  const int* starts = astarts + (size_t)b * (p.n_tiles + 1);
  const int start = starts[t];
  const int n = min(starts[t + 1] - start, p.mf_cap);
  const int* fids = al_fids + (size_t)b * p.E_al + start;

  for (int base = 0; base < n; base += CH) {
    const int nc = min(CH, n - base);
    __syncthreads();  // the previous chunk is flushed
    stage_faces(fv, want_z ? tex : nullptr, fids + base, b, nc, p, s_face,
                s_fid, s_tex);
    for (int i = tid; i < nc * 9; i += NTH) s_gv[i] = 0.f;
    if (want_tex)
      for (int i = tid; i < nc * T3; i += NTH) s_gt[i] = 0.f;
    __syncthreads();

    for (int j = 0; j < nc; ++j) {
      if (s_fid[j] < 0) continue;  // uniform across the block
      const float* r = s_face + j * NF;
      float acc[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) acc[i] = 0.f;
      bool any = false;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        Pair o;
        if (!pair_math(r, xp[q], yp[q], p, o)) continue;
        // depth gate: outside [near, far] no gradient at all
        if (!(o.zp >= p.near_ && o.zp <= p.far_)) continue;
        any = true;
        float c_grad_xy =
            g[q][3] * (1.0f - alpha[q]) / fmaxf(1.0f - o.frag, 1e-6f);
        if (o.frag > 0.f && (want_tex || want_z)) {
          const float z_norm = (p.far_ - o.zp) * p.inv_depth_range;
          const float ez_over_s = expf((z_norm - m[q]) * p.inv_gamma) * rs[q];
          if (want_tex) {
            const float val = o.frag * ez_over_s;
            float* gt = s_gt + j * T3 + o.tex_idx * 3;
            atomicAdd(gt + 0, val * g[q][0]);
            atomicAdd(gt + 1, val * g[q][1]);
            atomicAdd(gt + 2, val * g[q][2]);
          }
          if (want_z) {
            const float* col = s_tex + j * T3 + o.tex_idx * 3;
            const float dcol = g[q][0] * (col[0] - rgb[q][0]) +
                               g[q][1] * (col[1] - rgb[q][1]) +
                               g[q][2] * (col[2] - rgb[q][2]);
            const float c_rgb_over_frag = ez_over_s * dcol;
            const float c_rgb = c_rgb_over_frag * o.frag;
            c_grad_xy = c_grad_xy + c_rgb_over_frag;
            const float c_zz = c_rgb * p.c_z * o.zp * o.zp;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              const float rz = r[R_RZ + k];
              acc[3 * k + 2] += c_zz * o.wc[k] * (rz * rz);
            }
          }
        }
        c_grad_xy = c_grad_xy * o.frag * (1.0f - o.frag) * p.inv_sigma;
        const float base_g = 2.0f * o.sign * c_grad_xy;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          acc[3 * k + 0] += base_g * o.tw[k] * o.dis_x;
          acc[3 * k + 1] += base_g * o.tw[k] * o.dis_y;
        }
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          const float v = warp_sum(acc[i]);
          if (lane == 0 && v != 0.f) atomicAdd(s_gv + j * 9 + i, v);
        }
      }
    }
    __syncthreads();

    // one atomic per (entry, lane) into the face's gradients
    for (int i = tid; i < nc * 9; i += NTH) {
      const int f = s_fid[i / 9];
      const float v = s_gv[i];
      if (f >= 0 && v != 0.f)
        atomicAdd(grad_fv + ((size_t)b * p.F + f) * 9 + i % 9, v);
    }
    if (want_tex) {
      for (int i = tid; i < nc * T3; i += NTH) {
        const int f = s_fid[i / T3];
        const float v = s_gt[i];
        if (f >= 0 && v != 0.f)
          atomicAdd(grad_tex + ((size_t)b * p.F + f) * T3 + i % T3, v);
      }
    }
  }
}

}  // namespace

extern "C" {

// Adds the gradients of a softmax render into grad_fv / grad_tex (which
// the caller zeroes) on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Pointers are device pointers to contiguous
// float32 / int32 arrays of the shapes noted on the kernel; al_fids,
// astarts, rgba and aggr are the forward's, S is a multiple of 32.
int umr_raster_bwd(const float* fv, const float* tex, const int* al_fids,
                   const int* astarts, const float* rgba, const float* aggr,
                   const float* g_rgba, float* grad_fv, float* grad_tex,
                   int B, int F, int S, int T2, int E_al, int mf_cap,
                   float near_, float far_, float inv_depth_range,
                   float inv_sigma, float inv_gamma, float threshold,
                   float margin, float wlo, float whi, float c_z,
                   int mask_only, int rgb_geom_detach, int tex_grads,
                   void* stream) {
  Params p{};
  if (S <= 0 || S % TS) return (int)cudaErrorInvalidValue;
  p.F = F;
  p.S = S;
  p.TX = S / TS;
  p.n_tiles = p.TX * p.TX;
  p.T2 = T2;
  int R = 0;
  while ((R + 1) * (R + 1) <= T2) ++R;
  p.R = R;
  p.E_al = E_al;
  p.mf_cap = mf_cap;
  p.near_ = near_;
  p.far_ = far_;
  p.inv_depth_range = inv_depth_range;
  p.inv_sigma = inv_sigma;
  p.inv_gamma = inv_gamma;
  p.threshold = threshold;
  p.margin = margin;
  p.wlo = wlo;
  p.whi = whi;
  p.c_z = c_z;
  const bool want_tex = tex_grads && !mask_only;
  const bool want_z = !(mask_only || rgb_geom_detach);

  const size_t smem = sizeof(float) * CH * NF + sizeof(int) * CH +
                      sizeof(float) * CH * 9 +
                      sizeof(float) * CH * T2 * 3 * (want_z + want_tex);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  raster_bwd_kernel<<<dim3(p.n_tiles, B), NTH, smem, (cudaStream_t)stream>>>(
      fv, tex, al_fids, astarts, rgba, aggr, g_rgba, grad_fv, grad_tex, p,
      want_tex, want_z);
  return (int)cudaGetLastError();
}

}  // extern "C"
