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
// Each (pixel, binned face) pair in the face's bbox recomputes the
// forward's pair arithmetic (~180 operations; it is cheaper to redo than
// to store) and adds ~60 for the gradient chain. The bytes are the
// forward's inputs plus rgba, aggr and the cotangent, read once (40 bytes
// per pixel), and the gradients, written once.
//
// What the design does about it:
//   * one block per (32x32 tile, image), 8 warps, over the forward's own
//     bin layout (al_fids, astarts, mf_cap), so exactly the rendered
//     fragments get gradients; a tile with no face leaves at once;
//   * the tile's pixel state (cotangent, rgba, 1 / softmax sum, softmax
//     max: 10 floats x 1024 pixels) is read once, with float4 loads, into
//     shared memory, not registers;
//   * faces are staged CH at a time in shared memory with their setup
//     computed once (raster_common.cuh, shared with the forward), plus a
//     conservative pixel rectangle of the face's margin-expanded bbox
//     clipped to the tile (pixel_rect; every pixel whose centre passes
//     pair_math's exact bbox test lies in it);
//   * one warp per face: a warp takes the next staged face, largest
//     rectangle first, from a shared counter and walks only its
//     rectangle, 32 pixels at a time, so lanes
//     visit the bbox's pixels (plus the last group's ragged end) instead
//     of every (pixel, binned face) slot, and lanes of one warp work on
//     one face;
//   * registers hold the pair arithmetic, the lanes' sums and little else:
//     the walk (first pixel, width, i / width multiplier, pixel count) and
//     the face's record are re-read from shared memory in every group of
//     32 pixels, so every instance fits 80 registers without a spill at
//     3 blocks of 8 warps per SM;
//   * the 9 vertex lanes accumulate in each lane's registers over all of
//     the face's pixels and are reduced once per (face, tile) with warp
//     shuffles; lanes 0-8 add them to grad_faces with one global atomic
//     each;
//   * the 3 * T2 texel lanes go to a per-warp region of shared memory:
//     lanes that picked the same texel are summed first (__match_any_sync
//     and a shuffle tree), and the group's lowest lane adds the sum, so no
//     two lanes write one address at once and no shared atomics are
//     needed (a shared float atomicAdd is a compare-and-swap loop on this
//     card, ATOMS.CAST.SPIN, which serialises lanes that meet on a
//     texel); when the face is done each non-zero lane goes to grad_tex
//     with one global atomic (the wrapper zeroes both outputs).
//   * Order of the sums: a face's per-tile vertex sum runs over its pixels
//     per lane in rectangle order, then over the lanes in a butterfly; its
//     per-tile texel sum runs over the rectangle's groups of 32 pixels in
//     order, each group's equal-texel lanes in a fixed tree; the tiles'
//     sums meet in global atomics, in an order that changes from run to
//     run.
//
// Numerics: --fmad=false, no --use_fast_math, the plain version's
// expressions in its order (see raster_common.cuh).

#include "raster_common.cuh"

using namespace umr;

namespace {

constexpr int NW = NTH / 32;        // warps per block
constexpr int NPIX = TS * TS;       // pixels per tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The pixel rectangle (col0, row0, width, height), in tile-local pixels,
// of face record r's margin-expanded bbox in tile t: it holds every pixel
// whose centre passes pair_math's bbox test, and width or height is <= 0
// when none does. A pixel (row, col) has its centre at
// xp = (2 col + 1 - S) / S, yp = (S - 1 - 2 row) / S, so the test bounds
// col and row by (box * S + S - 1) / 2 and (S - 1 - box * S) / 2: exact in
// double for a float box; the 1e-3 slack covers the float rounding of
// xp and yp (below 1e-3 / S for S < 30000). The plain twin is
// ops/raster_kernel.py::pixel_rect.
__device__ int4 pixel_rect(const float* __restrict__ r, int t,
                           const Params& p) {
  const double S = (double)p.S;
  const double x0 = (double)((t % p.TX) * TS);
  const double y0 = (double)((t / p.TX) * TS);
  const double c_lo = ceil(((double)r[R_BOX + 1] * S + (S - 1.0)) * 0.5 -
                           1e-3);
  const double c_hi = floor(((double)r[R_BOX + 0] * S + (S - 1.0)) * 0.5 +
                            1e-3);
  const double r_lo = ceil(((S - 1.0) - (double)r[R_BOX + 2] * S) * 0.5 -
                           1e-3);
  const double r_hi = floor(((S - 1.0) - (double)r[R_BOX + 3] * S) * 0.5 +
                            1e-3);
  const double c0 = fmin(fmax(c_lo, x0), x0 + TS);
  const double c1 = fmax(fmin(c_hi, x0 + TS - 1), x0 - 1);
  const double r0 = fmin(fmax(r_lo, y0), y0 + TS);
  const double r1 = fmax(fmin(r_hi, y0 + TS - 1), y0 - 1);
  return make_int4((int)(c0 - x0), (int)(r0 - y0), (int)(c1 - c0) + 1,
                   (int)(r1 - r0) + 1);
}

// Adds val * g.xyz of every lane with a key >= 0 into s[key * 3 ...], one
// warp, all lanes converged, g = s_g[l]: lanes with the same key are
// summed first (the group's lowest lane ends with the sum: a shuffle tree
// over the group's ranks), and only that lane writes, so the adds hit
// distinct addresses. A lane without a term passes key -1 - lane.
__device__ __forceinline__ void add_by_key(float* s, int key, float val,
                                           const float4* s_g, int l,
                                           int lane) {
  const bool live = key >= 0;
  if (!__any_sync(FULL, live)) return;
  float v0 = 0.f, v1 = 0.f, v2 = 0.f;
  if (live) {
    const float4 g = s_g[l];
    v0 = val * g.x;
    v1 = val * g.y;
    v2 = val * g.z;
  }
  const unsigned peers = __match_any_sync(FULL, key);
  unsigned pos = __popc(peers & ((1u << lane) - 1u));  // rank in the group
  unsigned rest = peers & ~((2u << lane) - 1u);        // peers above me
  const bool leader = pos == 0;
  while (__any_sync(FULL, rest != 0u)) {
    const int next = __ffs(rest);        // the next live peer above, 1-based
    const float t0 = __shfl_sync(FULL, v0, next - 1);
    const float t1 = __shfl_sync(FULL, v1, next - 1);
    const float t2 = __shfl_sync(FULL, v2, next - 1);
    if (next) {
      v0 += t0;
      v1 += t1;
      v2 += t2;
    }
    rest &= ~__ballot_sync(FULL, pos & 1u);  // those lanes' sums are taken
    pos >>= 1;
  }
  if (live && leader) {
    float* a = s + key * 3;
    a[0] += v0;
    a[1] += v1;
    a[2] += v2;
  }
  __syncwarp();
}

// 3 blocks of 8 warps per SM: ptxas then fits every instance in 80
// registers without a spill (at 4 blocks, 64 registers, each spills)
template <bool WANT_TEX, bool WANT_Z>
__global__ void __launch_bounds__(NTH, 3)
raster_bwd_kernel(const float* __restrict__ fv,      // [B, F, 3, 3]
                  const float* __restrict__ tex,     // [B, F, T2, 3]
                  const int* __restrict__ al_fids,   // [B, E_al]
                  const int* __restrict__ astarts,   // [B, n_tiles + 1]
                  const float* __restrict__ rgba,    // [B, S, S, 4]
                  const float* __restrict__ aggr,    // [B, 2, S, S]
                  const float* __restrict__ g_rgba,  // [B, S, S, 4]
                  float* __restrict__ grad_fv,       // [B, F, 3, 3]
                  float* __restrict__ grad_tex,      // [B, F, T2, 3]
                  Params p) {
  extern __shared__ float4 smem4[];
  const int T3 = p.T2 * 3;
  float4* s_g = smem4;                          // [NPIX] cotangent
  float4* s_c = s_g + NPIX;                     // [NPIX] rgba
  float2* s_sm = (float2*)(s_c + NPIX);         // [NPIX] 1 / sum, max
  float* s_face = (float*)(s_sm + NPIX);        // [CH][NF]
  int4* s_rect = (int4*)(s_face + CH * NF);     // [CH]
  int* s_fid = (int*)(s_rect + CH);             // [CH], -1 = skip
  int* s_next = s_fid + CH;                     // [4] next face to take
  int* s_order = s_next + 4;                    // [CH] largest first
  float* s_tex = (float*)(s_order + CH);        // [CH][T3] if WANT_Z
  float* s_gt = s_tex + (WANT_Z ? CH * T3 : 0);  // [NW][T3] if WANT_TEX

  const int t = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* starts = astarts + (size_t)b * (p.n_tiles + 1);
  const int start = starts[t];
  const int n = min(starts[t + 1] - start, p.mf_cap);
  if (n <= 0) return;  // uniform across the block
  const int* fids = al_fids + (size_t)b * p.E_al + start;
  const int x0 = (t % p.TX) * TS, y0 = (t / p.TX) * TS;
  const size_t plane = (size_t)p.S * p.S;

  for (int i = tid; i < NPIX; i += NTH) {
    const size_t pix = (size_t)(y0 + i / TS) * p.S + (x0 + i % TS);
    s_g[i] = reinterpret_cast<const float4*>(g_rgba)[(size_t)b * plane + pix];
    s_c[i] = reinterpret_cast<const float4*>(rgba)[(size_t)b * plane + pix];
    const float* a = aggr + (size_t)b * 2 * plane + pix;
    s_sm[i] = make_float2(1.0f / a[0], a[plane]);
  }
  float* s_gw = s_gt + warp * T3;  // this warp's texel sums
  if (WANT_TEX)
    for (int i = tid; i < NW * T3; i += NTH) s_gt[i] = 0.f;

  for (int base = 0; base < n; base += CH) {
    const int nc = min(CH, n - base);
    __syncthreads();  // every warp is done with the previous chunk
    stage_faces(fv, WANT_Z ? tex : nullptr, fids + base, b, nc, p, s_face,
                s_fid, s_tex);
    if (tid < nc) {
      // the face's walk: first column and row (image pixels), width and
      // i / width's multiplier (exact for i < 2048, width <= 32), pixels
      const int4 rc = s_fid[tid] >= 0 ? pixel_rect(s_face + tid * NF, t, p)
                                      : make_int4(0, 0, 0, 0);
      const int w = max(rc.z, 1);
      s_rect[tid] = make_int4(x0 + rc.x, y0 + rc.y,
                              w | (int)((65536u + w - 1u) / w) << 8,
                              rc.z > 0 && rc.w > 0 ? rc.z * rc.w : 0);
    }
    if (tid == 0) s_next[0] = NW;  // the first NW go to warps 0 .. NW-1
    __syncthreads();
    if (tid < nc) {
      // faces are taken largest rectangle first (ties by bin order), so
      // no warp starts a large face when the others are nearly done
      const int mine = s_rect[tid].w;
      int rank = 0;
      // not unrolled: unrolled, it cost the texel instance a spill
#pragma unroll 1
      for (int k = 0; k < nc; ++k) {
        const int o = s_rect[k].w;
        rank += o > mine || (o == mine && k < tid);
      }
      s_order[rank] = tid;
    }
    __syncthreads();

    for (int j = warp < nc ? s_order[warp] : -1; j >= 0;) {
      float acc[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[k] = 0.f;
      bool any = false;
      for (int i0 = 0;; i0 += 32) {
        // the walk and the face's record are read from shared memory in
        // every group of 32 pixels: hidden from the compiler, the index
        // keeps them out of registers across the pair arithmetic
        int jr = j;
        asm volatile("" : "+r"(jr));
        const int4 rc = s_rect[jr];  // uniform across the warp
        if (i0 >= rc.w) break;
        const float* r = s_face + jr * NF;
        const int i = i0 + lane;
        int key = -1 - lane;  // the texel of this lane's term, if any
        float val = 0.f;
        int l = 0;            // the pixel, in the tile
        if (i < rc.w) {
          const int w = rc.z & 0xff;
          const int dy = (int)(((unsigned)i * ((unsigned)rc.z >> 8)) >> 16);
          const int row = rc.y + dy, col = rc.x + i - dy * w;
          l = (row & (TS - 1)) * TS + (col & (TS - 1));
          const float xp =
              (2.0f * (float)col + 1.0f - (float)p.S) / (float)p.S;
          const float yp = (2.0f * (float)(p.S - 1 - row) + 1.0f -
                            (float)p.S) / (float)p.S;
          Pair o;
          // depth gate: outside [near, far] no gradient at all
          if (pair_math(r, xp, yp, p, o) && o.zp >= p.near_ &&
              o.zp <= p.far_) {
            any = true;
            const float4 g = s_g[l];
            const float4 c = s_c[l];
            float c_grad_xy = g.w * (1.0f - c.w) / fmaxf(1.0f - o.frag, 1e-6f);
            if ((WANT_TEX || WANT_Z) && o.frag > 0.f) {
              const float2 sm = s_sm[l];
              const float z_norm = (p.far_ - o.zp) * p.inv_depth_range;
              const float ez_over_s =
                  expf((z_norm - sm.y) * p.inv_gamma) * sm.x;
              if (WANT_TEX) {
                val = o.frag * ez_over_s;
                key = o.tex_idx;
              }
              if (WANT_Z) {
                const float* col = s_tex + j * T3 + o.tex_idx * 3;
                const float dcol = g.x * (col[0] - c.x) +
                                   g.y * (col[1] - c.y) +
                                   g.z * (col[2] - c.z);
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
        }
        if (WANT_TEX) add_by_key(s_gw, key, val, s_g, l, lane);
      }

      const int f = s_fid[j];
      if (__any_sync(FULL, any)) {
        // one reduction per (face, tile); lane k ends with lane group k
        float mine = 0.f;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          if (!WANT_Z && k % 3 == 2) continue;  // z lanes are zero
          const float v = warp_sum(acc[k]);
          if (lane == k) mine = v;
        }
        if (lane < 9 && mine != 0.f)
          atomicAdd(grad_fv + ((size_t)b * p.F + f) * 9 + lane, mine);
      }
      if (WANT_TEX && s_rect[j].w > 0) {
        // the face's texel sums out, and the region zeroed for the next
        float* gt = grad_tex + ((size_t)b * p.F + f) * T3;
        for (int k = lane; k < T3; k += 32) {
          const float v = s_gw[k];
          if (v != 0.f) {
            atomicAdd(gt + k, v);
            s_gw[k] = 0.f;
          }
        }
        __syncwarp();
      }

      int next = -1;
      if (lane == 0) {
        const int k = atomicAdd(s_next, 1);
        if (k < nc) next = s_order[k];
      }
      j = __shfl_sync(FULL, next, 0);
    }
  }
}

template <bool WANT_TEX, bool WANT_Z>
int launch(const float* fv, const float* tex, const int* al_fids,
           const int* astarts, const float* rgba, const float* aggr,
           const float* g_rgba, float* grad_fv, float* grad_tex, int B,
           const Params& p, cudaStream_t stream) {
  auto kern = raster_bwd_kernel<WANT_TEX, WANT_Z>;
  const size_t smem = sizeof(float4) * 2 * NPIX + sizeof(float2) * NPIX +
                      sizeof(float) * CH * NF + sizeof(int4) * CH +
                      sizeof(int) * (2 * CH + 4) +
                      sizeof(float) * p.T2 * 3 *
                          (WANT_Z * CH + WANT_TEX * NW);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(p.n_tiles, B), NTH, smem, stream>>>(
      fv, tex, al_fids, astarts, rgba, aggr, g_rgba, grad_fv, grad_tex, p);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  if (want_tex && want_z)
    return launch<true, true>(fv, tex, al_fids, astarts, rgba, aggr, g_rgba,
                              grad_fv, grad_tex, B, p, s);
  if (want_tex)
    return launch<true, false>(fv, tex, al_fids, astarts, rgba, aggr, g_rgba,
                               grad_fv, grad_tex, B, p, s);
  if (want_z)
    return launch<false, true>(fv, tex, al_fids, astarts, rgba, aggr, g_rgba,
                               grad_fv, grad_tex, B, p, s);
  return launch<false, false>(fv, tex, al_fids, astarts, rgba, aggr, g_rgba,
                              grad_fv, grad_tex, B, p, s);
}

}  // extern "C"
