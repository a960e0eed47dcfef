// Tile-binned soft rasterizer, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel umr_tpu/ops/raster_kernel.py::_fwd_kernel (its
// softmax body and its hard body): euclidean distance, product alpha,
// softmax or hard RGB over surface texel sheets, faces shaded from both
// sides (the renderer's double_side=True, so no front-face test).
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
// The tile's face list is the JAX package's binned layout (al_fids,
// astarts): at most mf_cap entries per tile, padded with the id F, which is
// skipped. Honouring that layout makes an over-full tile lose the same
// faces as on the TPU.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TS = 32;                 // tile side, pixels
constexpr int NTH = 256;              // threads per block
constexpr int PPT = TS * TS / NTH;    // pixels per thread
constexpr int CH = 32;  // faces staged per chunk
constexpr int NF = 40;  // floats of per-face setup

// per-face setup record
constexpr int R_X = 0;      // x0..x2
constexpr int R_Y = 3;      // y0..y2
constexpr int R_RZ = 6;     // 1/z0..1/z2
constexpr int R_INV = 9;    // inverse barycentric rows, 9
constexpr int R_A = 18;     // per edge k: a0[0..2] at R_A + 3k
constexpr int R_RDEN = 27;  // per edge k: 1 / (a0[v0] - a0[v1])
constexpr int R_BOX = 30;   // maxx+m, minx-m, maxy+m, miny-m

constexpr int F_OBT0 = 1;  // bits 0..2: corner k's angle is obtuse

struct Params {
  int F, S, TX, n_tiles, T2, R, E_al, mf_cap;
  float near_, far_, inv_depth_range, eps, inv_sigma, inv_gamma;
  float threshold, margin, bg_weight, wlo, whi;
  float bg0, bg1, bg2;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// One face's setup into r[NF]; returns the obtuse flag bits, or -1 for a
// projection-degenerate face (culled everywhere).
__device__ int face_setup(const float* __restrict__ v, float* r,
                          const Params& p) {
  const float x[3] = {v[0], v[3], v[6]};
  const float y[3] = {v[1], v[4], v[7]};
  float det = x[2] * (y[0] - y[1]) + x[0] * (y[1] - y[2]) +
              x[1] * (y[2] - y[0]);
  if (!(fabsf(det) > 1e-10f)) return -1;
  det = det > 0.f ? fmaxf(det, 1e-10f) : fminf(det, -1e-10f);
  const float rdet = 1.0f / det;
  const float star[9] = {
      y[1] - y[2], x[2] - x[1], x[1] * y[2] - x[2] * y[1],
      y[2] - y[0], x[0] - x[2], x[2] * y[0] - x[0] * y[2],
      y[0] - y[1], x[1] - x[0], x[0] * y[1] - x[1] * y[0]};
#pragma unroll
  for (int i = 0; i < 9; ++i) r[R_INV + i] = star[i] * rdet;
  float sym[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) sym[i][j] = x[i] * x[j] + y[i] * y[j] + 1.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int v0 = k, v1 = (k + 1) % 3;
    float a0[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a0[j] = sym[v0][j] - sym[v1][j];
      r[R_A + 3 * k + j] = a0[j];
    }
    float denom = a0[v0] - a0[v1];
    if (fabsf(denom) < 1e-12f) denom = 1e-12f;
    r[R_RDEN + k] = 1.0f / denom;
  }
  int flags = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int k1 = (k + 1) % 3, k2 = (k + 2) % 3;
    const float d = (x[k1] - x[k]) * (x[k2] - x[k]) +
                    (y[k1] - y[k]) * (y[k2] - y[k]);
    if (d < 0.f) flags |= F_OBT0 << k;
    r[R_X + k] = x[k];
    r[R_Y + k] = y[k];
    r[R_RZ + k] = 1.0f / v[3 * k + 2];
  }
  r[R_BOX + 0] = fmaxf(fmaxf(x[0], x[1]), x[2]) + p.margin;
  r[R_BOX + 1] = fminf(fminf(x[0], x[1]), x[2]) - p.margin;
  r[R_BOX + 2] = fmaxf(fmaxf(y[0], y[1]), y[2]) + p.margin;
  r[R_BOX + 3] = fminf(fminf(y[0], y[1]), y[2]) - p.margin;
  return flags;
}

__device__ __forceinline__ float pick3(int k, float a, float b, float c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

// Everything one (pixel, face) pair contributes. Returns false when the
// pair is culled (outside the bbox margin or past the distance threshold).
struct Pair {
  float frag, zp;
  int tex_idx;
  bool inside01;
};

__device__ __forceinline__ bool pair_math(const float* __restrict__ r,
                                          float xp, float yp,
                                          const Params& p, Pair& o) {
  if (xp > r[R_BOX + 0] || xp < r[R_BOX + 1] || yp > r[R_BOX + 2] ||
      yp < r[R_BOX + 3])
    return false;
  const float x[3] = {r[R_X], r[R_X + 1], r[R_X + 2]};
  const float y[3] = {r[R_Y], r[R_Y + 1], r[R_Y + 2]};
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    w[k] = r[R_INV + 3 * k] * xp + r[R_INV + 3 * k + 1] * yp +
           r[R_INV + 3 * k + 2];

  // euclidean distance to each edge's foot point, unclamped and clamped
  float dxu[3], dyu[3], dxc[3], dyc[3], du[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int v0 = k, v1 = (k + 1) % 3, v2 = (k + 2) % 3;
    const float* a0 = r + R_A + 3 * k;
    const float tv0 =
        (w[0] * a0[0] + w[1] * a0[1] + w[2] * a0[2] - a0[v1]) * r[R_RDEN + k];
    float t[3];
    t[v0] = tv0;
    t[v1] = 1.0f - tv0;
    t[v2] = 0.0f;
    float tu[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) tu[j] = t[j] - w[j];
    dxu[k] = tu[0] * x[0] + tu[1] * x[1] + tu[2] * x[2];
    dyu[k] = tu[0] * y[0] + tu[1] * y[1] + tu[2] * y[2];
    const float delta = clampf(tv0, 0.0f, 1.0f) - tv0;
    dxc[k] = dxu[k] + delta * (x[v0] - x[v1]);
    dyc[k] = dyu[k] + delta * (y[v0] - y[v1]);
    du[k] = dxu[k] * dxu[k] + dyu[k] * dyu[k];
  }
  const bool inside = w[0] > 0.f && w[1] > 0.f && w[2] > 0.f &&
                      w[0] < 1.f && w[1] < 1.f && w[2] < 1.f;
  float dis_x, dis_y;
  if (inside) {
    int k_in = du[1] < du[0] ? 1 : 0;
    if (du[2] < fminf(du[0], du[1])) k_in = 2;
    dis_x = pick3(k_in, dxu[0], dxu[1], dxu[2]);
    dis_y = pick3(k_in, dyu[0], dyu[1], dyu[2]);
  } else {
    const int flags = __float_as_int(r[NF - 1]);
    const bool n0 = w[0] <= 0.f, n1 = w[1] <= 0.f, n2 = w[2] <= 0.f;
    int v;
    if (n1 && n2) {
      v = ((flags & (F_OBT0 << 0)) &&
           (xp - x[0]) * (x[2] - x[0]) + (yp - y[0]) * (y[2] - y[0]) > 0.f)
              ? 2 : 0;
    } else if (n2 && n0) {
      v = ((flags & (F_OBT0 << 1)) &&
           (xp - x[1]) * (x[0] - x[1]) + (yp - y[1]) * (y[0] - y[1]) > 0.f)
              ? 0 : 1;
    } else if (n0 && n1) {
      v = ((flags & (F_OBT0 << 2)) &&
           (xp - x[2]) * (x[1] - x[2]) + (yp - y[2]) * (y[1] - y[2]) > 0.f)
              ? 1 : 2;
    } else {
      v = n0 ? 1 : (n1 ? 2 : 0);
    }
    dis_x = pick3(v, dxc[0], dxc[1], dxc[2]);
    dis_y = pick3(v, dyc[0], dyc[1], dyc[2]);
  }
  const float dis = dis_x * dis_x + dis_y * dis_y;
  if (!inside && dis >= p.threshold) return false;
  const float sign = inside ? 1.0f : -1.0f;
  o.frag = 1.0f / (1.0f + expf(-(sign * dis * p.inv_sigma)));

  // clipped barycentrics, perspective-correct depth, nearest texel
  float wc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) wc[k] = clampf(w[k], p.wlo, p.whi);
  const float rws = 1.0f / fmaxf(wc[0] + wc[1] + wc[2], 1e-5f);
#pragma unroll
  for (int k = 0; k < 3; ++k) wc[k] = wc[k] * rws;
  o.zp = 1.0f / (wc[0] * r[R_RZ] + wc[1] * r[R_RZ + 1] + wc[2] * r[R_RZ + 2]);
  const float Rf = (float)p.R;
  const int w_x = (int)floorf(wc[0] * Rf);
  const int w_y = (int)floorf(wc[1] * Rf);
  const bool low = (wc[0] + wc[1]) * Rf - (float)w_x - (float)w_y <= 1.0f;
  int idx = low ? w_y * p.R + w_x
                : (p.R - 1 - w_y) * p.R + (p.R - 1 - w_x);
  o.tex_idx = min(max(idx, 0), p.T2 - 1);
  o.inside01 = w[0] >= 0.f && w[0] <= 1.f && w[1] >= 0.f && w[1] <= 1.f &&
               w[2] >= 0.f && w[2] <= 1.f;
  return true;
}

template <bool HARD, bool MASK_ONLY>
__global__ void __launch_bounds__(NTH)
raster_fwd_kernel(const float* __restrict__ fv,     // [B, F, 3, 3]
                  const float* __restrict__ tex,    // [B, F, T2, 3]
                  const int* __restrict__ al_fids,  // [B, E_al]
                  const int* __restrict__ astarts,  // [B, n_tiles + 1]
                  float* __restrict__ rgba,         // [B, S, S, 4]
                  float* __restrict__ aggr,         // [B, 2, S, S]
                  Params p) {
  extern __shared__ float smem[];
  float* s_face = smem;                       // [CH][NF]
  int* s_fid = (int*)(s_face + CH * NF);      // [CH], -1 = skip
  float* s_tex = (float*)(s_fid + CH);        // [CH][T2 * 3]

  const int t = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int trow = t / p.TX, tcol = t % p.TX;
  const int T3 = p.T2 * 3;

  float xp[PPT], yp[PPT];
  // softmax: (m, s, c0..c2, la); hard: (depth, fid, c0..c2, la)
  float acc0[PPT], acc1[PPT], c0[PPT], c1[PPT], c2[PPT], la[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int lane = tid + q * NTH;
    const int col = tcol * TS + lane % TS;
    const int row = trow * TS + lane / TS;
    xp[q] = (2.0f * (float)col + 1.0f - (float)p.S) / (float)p.S;
    yp[q] = (2.0f * (float)(p.S - 1 - row) + 1.0f - (float)p.S) / (float)p.S;
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
    if (tid < nc) {
      const int f = fids[base + tid];
      int keep = -1;
      if (f < p.F) {
        float* r = s_face + tid * NF;
        const int flags = face_setup(fv + ((size_t)b * p.F + f) * 9, r, p);
        if (flags >= 0) {
          r[NF - 1] = __int_as_float(flags);
          keep = f;
        }
      }
      s_fid[tid] = keep;
    }
    if (!MASK_ONLY) {
      for (int i = tid; i < nc * T3; i += NTH) {
        const int j = i / T3;
        const int f = fids[base + j];
        s_tex[i] = f < p.F ? tex[((size_t)b * p.F + f) * T3 + (i - j * T3)]
                           : 0.f;
      }
    }
    __syncthreads();

    for (int j = 0; j < nc; ++j) {
      const int f = s_fid[j];
      if (f < 0) continue;
      const float* r = s_face + j * NF;
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
          if (!MASK_ONLY) {
            const float* tx = s_tex + j * T3 + o.tex_idx * 3;
            c0[q] += contrib * tx[0];
            c1[q] += contrib * tx[1];
            c2[q] += contrib * tx[2];
          }
        }
      }
    }
  }

  const size_t plane = (size_t)p.S * p.S;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int lane = tid + q * NTH;
    const int col = tcol * TS + lane % TS;
    const int row = trow * TS + lane / TS;
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

template <bool HARD, bool MASK_ONLY>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const float* fv, const float* tex, const int* al_fids,
                   const int* astarts, float* rgba, float* aggr,
                   const Params& p) {
  auto kern = raster_fwd_kernel<HARD, MASK_ONLY>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, NTH, smem, stream>>>(fv, tex, al_fids, astarts, rgba, aggr, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the forward rasterizer on `stream`; returns cudaGetLastError()
// after the launch (0 on success). All pointers are device pointers to
// contiguous float32 / int32 arrays of the shapes noted on the kernel;
// S is a multiple of the 32-pixel tile.
int umr_raster_fwd(const float* fv, const float* tex, const int* al_fids,
                   const int* astarts, float* rgba, float* aggr, int B, int F,
                   int S, int T2, int E_al, int mf_cap, float near_,
                   float far_, float inv_depth_range, float eps,
                   float inv_sigma, float inv_gamma, float threshold,
                   float margin, float bg_weight, float wlo, float whi,
                   float bg0, float bg1, float bg2, int hard, int mask_only,
                   void* stream) {
  Params p;
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

  const dim3 grid(p.n_tiles, B);
  const size_t smem = sizeof(float) * CH * NF + sizeof(int) * CH +
                      (mask_only && !hard ? 0 : sizeof(float) * CH * T2 * 3);
  const cudaStream_t st = (cudaStream_t)stream;
  if (hard)
    return (int)launch<true, false>(grid, smem, st, fv, tex, al_fids, astarts,
                                    rgba, aggr, p);
  if (mask_only)
    return (int)launch<false, true>(grid, smem, st, fv, tex, al_fids, astarts,
                                    rgba, aggr, p);
  return (int)launch<false, false>(grid, smem, st, fv, tex, al_fids, astarts,
                                   rgba, aggr, p);
}

const char* umr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
