// Tile-binned soft rasterizer, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel umr_tpu/ops/raster_kernel.py::_fwd_kernel (its
// softmax body, its hard body and its p2f side output): euclidean
// distance, product alpha, softmax or hard RGB over surface texel sheets,
// faces shaded from both sides (the renderer's double_side=True, so no
// front-face test).
//
// What bounds it on this card: the per-pixel ALU work, not bytes. A 32x32
// tile walks its binned face list (about 20 to 160 faces at the renderer's
// shapes); each (pixel, face) pair costs ~150 flops, three divides and two
// exponentials, while the tile reads a few KB of face data (hot in L2) and
// writes 24 bytes per pixel.
//
// What the design does about it:
//   * one block per (32x32 tile, image), 256 threads of 4 pixels each;
//     every thread keeps its pixels' accumulators in registers;
//   * the tile's faces are staged in shared memory CH at a time; one thread
//     per face computes everything that depends on the face alone (the
//     degenerate cull, the inverse barycentric rows, the per-edge foot
//     point coefficients, the obtuse-corner flags, the bbox with the cull
//     margin, 1/z), so the per-pair work is only what depends on the pixel;
//   * a pair outside the face's margin-expanded bbox, or past the distance
//     threshold, leaves after a few compares.
//
// Numerics: compiled without --use_fast_math and with --fmad=false. The
// per-pair expressions are the ones the plain version
// (umr_tpu_torch/ops/rasterize.py) evaluates, in the same order, one
// rounding per operation, so barycentrics, depths, texel indices and the
// hard z-winner agree with it bit for bit; only the order of the softmax
// and alpha sums differs. The faces of a tile arrive in ascending id and
// the hard winner is replaced only on a strictly smaller depth, so ties
// go to the lowest face id, as on the TPU.
//
// p2f (the NEED_P2F instances, softmax only): per face, the sums over
// the image of contrib * (gx, gy, 1), gx = 2 col / (S - 1) - 1 and
// gy = 2 row / (S - 1) - 1, contrib being the softmax weight of the pair
// after the pixel's running max has taken this face in (the reference
// CUDA kernel's rule). A thread sums its 4 pixels, the warp reduces with
// shuffles (skipped when no lane's pixels took the face in), lane 0 adds
// into the face's slot in shared memory, and after each staged chunk
// every non-zero slot goes to the zeroed [B, F, 3] sums with one global
// atomicAdd; the wrapper divides by the weight. The hard body writes no
// p2f, as on the TPU.
//
// The tile's face list is the JAX package's binned layout (al_fids,
// astarts): at most mf_cap entries per tile, padded with the id F, which is
// skipped. Honouring that layout makes an over-full tile lose the same
// faces as on the TPU.

#include "raster_common.cuh"

using namespace umr;

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool HARD, bool MASK_ONLY, bool NEED_P2F>
__global__ void __launch_bounds__(NTH)
raster_fwd_kernel(const float* __restrict__ fv,     // [B, F, 3, 3]
                  const float* __restrict__ tex,    // [B, F, T2, 3]
                  const int* __restrict__ al_fids,  // [B, E_al]
                  const int* __restrict__ astarts,  // [B, n_tiles + 1]
                  float* __restrict__ rgba,         // [B, S, S, 4]
                  float* __restrict__ aggr,         // [B, 2, S, S]
                  float* __restrict__ p2f,          // [B, F, 3] if NEED_P2F
                  Params p) {
  static_assert(!(HARD && NEED_P2F), "the hard body writes no p2f");
  extern __shared__ float smem[];
  float* s_face = smem;                       // [CH][NF]
  int* s_fid = (int*)(s_face + CH * NF);      // [CH], -1 = skip
  float* s_tex = (float*)(s_fid + CH);        // [CH][T2 * 3] unless MASK_ONLY
  float* s_p2f = s_tex + (MASK_ONLY ? 0 : CH * p.T2 * 3);  // [CH][3]

  const int t = blockIdx.x, b = blockIdx.y;
  const int T3 = p.T2 * 3;
  const int tid = threadIdx.x, lane = tid & 31;

  float xp[PPT], yp[PPT];
  float gx[PPT], gy[PPT];  // p2f grid coordinates (NEED_P2F only)
  // softmax: (m, s, c0..c2, la); hard: (depth, fid, c0..c2, la)
  float acc0[PPT], acc1[PPT], c0[PPT], c1[PPT], c2[PPT], la[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    int row, col;
    pixel_of(t, q, p, row, col, xp[q], yp[q]);
    if (NEED_P2F) {
      gx[q] = 2.0f * (float)col / (float)(p.S - 1) - 1.0f;
      gy[q] = 2.0f * (float)row / (float)(p.S - 1) - 1.0f;
    }
    la[q] = 0.f;
    if (HARD) {
      acc0[q] = 1e7f;
      acc1[q] = -1.f;
      c0[q] = p.bg0;
      c1[q] = p.bg1;
      c2[q] = p.bg2;
    } else {
      acc0[q] = p.eps;
      acc1[q] = p.bg_weight;
      c0[q] = p.bg0 * p.bg_weight;
      c1[q] = p.bg1 * p.bg_weight;
      c2[q] = p.bg2 * p.bg_weight;
    }
  }

  const int* starts = astarts + (size_t)b * (p.n_tiles + 1);
  const int start = starts[t];
  const int n = min(starts[t + 1] - start, p.mf_cap);
  const int* fids = al_fids + (size_t)b * p.E_al + start;

  for (int base = 0; base < n; base += CH) {
    const int nc = min(CH, n - base);
    __syncthreads();  // the previous chunk is no longer read
    stage_faces(fv, MASK_ONLY ? nullptr : tex, fids + base, b, nc, p, s_face,
                s_fid, s_tex);
    if (NEED_P2F)
      for (int i = tid; i < nc * 3; i += NTH) s_p2f[i] = 0.f;
    __syncthreads();

    for (int j = 0; j < nc; ++j) {
      const int f = s_fid[j];
      if (f < 0) continue;  // uniform across the block
      const float* r = s_face + j * NF;
      float px = 0.f, py = 0.f, pw = 0.f;  // this face's p2f partials
      bool any = false;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        Pair o;
        if (!pair_math(r, xp[q], yp[q], p, o)) continue;
        la[q] += log1pf(-o.frag);
        const bool z_ok = o.zp >= p.near_ && o.zp <= p.far_;
        if (HARD) {
          if (z_ok && o.inside01 && o.zp < acc0[q]) {
            acc0[q] = o.zp;
            acc1[q] = (float)f;
            const float* tx = s_tex + j * T3 + o.tex_idx * 3;
            c0[q] = tx[0];
            c1[q] = tx[1];
            c2[q] = tx[2];
          }
        } else if (z_ok) {
          const float z = (p.far_ - o.zp) * p.inv_depth_range;
          if (z > acc0[q]) {
            const float sc = expf((acc0[q] - z) * p.inv_gamma);
            acc1[q] *= sc;
            if (!MASK_ONLY) {
              c0[q] *= sc;
              c1[q] *= sc;
              c2[q] *= sc;
            }
            acc0[q] = z;
          }
          const float contrib = expf((z - acc0[q]) * p.inv_gamma) * o.frag;
          acc1[q] += contrib;
          if (NEED_P2F) {
            any = true;
            px += contrib * gx[q];
            py += contrib * gy[q];
            pw += contrib;
          }
          if (!MASK_ONLY) {
            const float* tx = s_tex + j * T3 + o.tex_idx * 3;
            c0[q] += contrib * tx[0];
            c1[q] += contrib * tx[1];
            c2[q] += contrib * tx[2];
          }
        }
      }
      if (NEED_P2F && __any_sync(0xffffffffu, any)) {
        px = warp_sum(px);
        py = warp_sum(py);
        pw = warp_sum(pw);
        if (lane == 0 && pw != 0.f) {
          atomicAdd(s_p2f + j * 3 + 0, px);
          atomicAdd(s_p2f + j * 3 + 1, py);
          atomicAdd(s_p2f + j * 3 + 2, pw);
        }
      }
    }
    if (NEED_P2F) {
      __syncthreads();
      // one atomic per (entry, lane) into the face's sums
      for (int i = tid; i < nc * 3; i += NTH) {
        const int f = s_fid[i / 3];
        const float v = s_p2f[i];
        if (f >= 0 && v != 0.f)
          atomicAdd(p2f + ((size_t)b * p.F + f) * 3 + i % 3, v);
      }
    }
  }

  const size_t plane = (size_t)p.S * p.S;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    int row, col;
    float xq, yq;  // unused here
    pixel_of(t, q, p, row, col, xq, yq);
    const size_t pix = (size_t)row * p.S + col;
    float4 out;
    if (HARD) {
      const bool has = acc1[q] >= 0.f;
      out = make_float4(has ? c0[q] : p.bg0, has ? c1[q] : p.bg1,
                        has ? c2[q] : p.bg2, 1.0f - expf(la[q]));
    } else if (MASK_ONLY) {
      out = make_float4(p.bg0, p.bg1, p.bg2, 1.0f - expf(la[q]));
    } else {
      out = make_float4(c0[q] / acc1[q], c1[q] / acc1[q], c2[q] / acc1[q],
                        1.0f - expf(la[q]));
    }
    reinterpret_cast<float4*>(rgba)[(size_t)b * plane + pix] = out;
    // softmax: (sum, max); hard: (depth, face id)
    aggr[((size_t)b * 2 + 0) * plane + pix] = HARD ? acc0[q] : acc1[q];
    aggr[((size_t)b * 2 + 1) * plane + pix] = HARD ? acc1[q] : acc0[q];
  }
}

template <bool HARD, bool MASK_ONLY, bool NEED_P2F = false>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const float* fv, const float* tex, const int* al_fids,
                   const int* astarts, float* rgba, float* aggr, float* p2f,
                   const Params& p) {
  auto kern = raster_fwd_kernel<HARD, MASK_ONLY, NEED_P2F>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, NTH, smem, stream>>>(fv, tex, al_fids, astarts, rgba, aggr, p2f,
                                    p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the forward rasterizer on `stream`; returns cudaGetLastError()
// after the launch (0 on success). All pointers are device pointers to
// contiguous float32 / int32 arrays of the shapes noted on the kernel;
// S is a multiple of the 32-pixel tile. With need_p2f (softmax only) the
// kernel adds the per-face p2f sums into p2f [B, F, 3], which the caller
// zeroes; otherwise p2f is not read and may be null.
int umr_raster_fwd(const float* fv, const float* tex, const int* al_fids,
                   const int* astarts, float* rgba, float* aggr, float* p2f,
                   int B, int F,
                   int S, int T2, int E_al, int mf_cap, float near_,
                   float far_, float inv_depth_range, float eps,
                   float inv_sigma, float inv_gamma, float threshold,
                   float margin, float bg_weight, float wlo, float whi,
                   float bg0, float bg1, float bg2, int hard, int mask_only,
                   int need_p2f, void* stream) {
  Params p{};
  p.F = F;
  if (S <= 0 || S % TS) return (int)cudaErrorInvalidValue;
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
  p.eps = eps;
  p.inv_sigma = inv_sigma;
  p.inv_gamma = inv_gamma;
  p.threshold = threshold;
  p.margin = margin;
  p.bg_weight = bg_weight;
  p.wlo = wlo;
  p.whi = whi;
  p.bg0 = bg0;
  p.bg1 = bg1;
  p.bg2 = bg2;

  if (need_p2f && (hard || p2f == nullptr))
    return (int)cudaErrorInvalidValue;

  const dim3 grid(p.n_tiles, B);
  const size_t smem = sizeof(float) * CH * NF + sizeof(int) * CH +
                      (mask_only && !hard ? 0 : sizeof(float) * CH * T2 * 3) +
                      (need_p2f ? sizeof(float) * CH * 3 : 0);
  const cudaStream_t st = (cudaStream_t)stream;
  if (hard)
    return (int)launch<true, false>(grid, smem, st, fv, tex, al_fids, astarts,
                                    rgba, aggr, nullptr, p);
  if (mask_only)
    return need_p2f
               ? (int)launch<false, true, true>(grid, smem, st, fv, tex,
                                                al_fids, astarts, rgba, aggr,
                                                p2f, p)
               : (int)launch<false, true>(grid, smem, st, fv, tex, al_fids,
                                          astarts, rgba, aggr, nullptr, p);
  return need_p2f
             ? (int)launch<false, false, true>(grid, smem, st, fv, tex,
                                               al_fids, astarts, rgba, aggr,
                                               p2f, p)
             : (int)launch<false, false>(grid, smem, st, fv, tex, al_fids,
                                         astarts, rgba, aggr, nullptr, p);
}

const char* umr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
