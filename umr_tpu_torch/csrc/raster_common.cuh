// Per-face setup and per-(pixel, face) arithmetic shared by the forward
// (raster_fwd.cu) and backward (raster_bwd.cu) rasterizer kernels.
//
// The expressions are the ones the plain version (umr_tpu_torch/ops/
// rasterize.py::_face_info, _euclidean, pair_math) evaluates, in the same
// order; both kernels are compiled with --fmad=false and without
// --use_fast_math, so barycentrics, depths and texel indices round alike
// in the two kernels and the plain version. The backward recomputes
// exactly the fragments the forward rendered.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace umr {

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
// r[NF - 1] holds the obtuse flag bits (as an int)

constexpr int F_OBT0 = 1;  // bits 0..2: corner k's angle is obtuse

struct Params {
  int F, S, TX, n_tiles, T2, R, E_al, mf_cap;
  float near_, far_, inv_depth_range, eps, inv_sigma, inv_gamma;
  float threshold, margin, bg_weight, wlo, whi;
  float bg0, bg1, bg2;
  float c_z;  // backward: 1 / gamma / (near - far)
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// One face's setup into r[NF]; returns the obtuse flag bits, or -1 for a
// projection-degenerate face (culled everywhere).
__device__ inline int face_setup(const float* __restrict__ v, float* r,
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

// Everything one (pixel, face) pair contributes. The forward reads frag,
// zp, tex_idx and inside01; the backward also the distance vector, its
// sign, the foot point's weights tw and the clipped barycentrics wc.
struct Pair {
  float frag, zp, sign, dis_x, dis_y;
  float tw[3], wc[3];
  int tex_idx;
  bool inside01;
};

// Returns false when the pair is culled (outside the bbox margin or past
// the distance threshold).
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
  float dxu[3], dyu[3], dxc[3], dyc[3], du[3], tu[3][3], dl[3];
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
#pragma unroll
    for (int j = 0; j < 3; ++j) tu[k][j] = t[j] - w[j];
    dxu[k] = tu[k][0] * x[0] + tu[k][1] * x[1] + tu[k][2] * x[2];
    dyu[k] = tu[k][0] * y[0] + tu[k][1] * y[1] + tu[k][2] * y[2];
    const float delta = clampf(tv0, 0.0f, 1.0f) - tv0;
    dl[k] = delta;
    dxc[k] = dxu[k] + delta * (x[v0] - x[v1]);
    dyc[k] = dyu[k] + delta * (y[v0] - y[v1]);
    du[k] = dxu[k] * dxu[k] + dyu[k] * dyu[k];
  }
  const bool inside = w[0] > 0.f && w[1] > 0.f && w[2] > 0.f &&
                      w[0] < 1.f && w[1] < 1.f && w[2] < 1.f;
  int e;            // the edge whose foot point is the nearest point
  bool clamped;
  if (inside) {
    e = du[1] < du[0] ? 1 : 0;
    if (du[2] < fminf(du[0], du[1])) e = 2;
    clamped = false;
    o.dis_x = pick3(e, dxu[0], dxu[1], dxu[2]);
    o.dis_y = pick3(e, dyu[0], dyu[1], dyu[2]);
  } else {
    const int flags = __float_as_int(r[NF - 1]);
    const bool n0 = w[0] <= 0.f, n1 = w[1] <= 0.f, n2 = w[2] <= 0.f;
    if (n1 && n2) {
      e = ((flags & (F_OBT0 << 0)) &&
           (xp - x[0]) * (x[2] - x[0]) + (yp - y[0]) * (y[2] - y[0]) > 0.f)
              ? 2 : 0;
    } else if (n2 && n0) {
      e = ((flags & (F_OBT0 << 1)) &&
           (xp - x[1]) * (x[0] - x[1]) + (yp - y[1]) * (y[0] - y[1]) > 0.f)
              ? 0 : 1;
    } else if (n0 && n1) {
      e = ((flags & (F_OBT0 << 2)) &&
           (xp - x[2]) * (x[1] - x[2]) + (yp - y[2]) * (y[1] - y[2]) > 0.f)
              ? 1 : 2;
    } else {
      e = n0 ? 1 : (n1 ? 2 : 0);
    }
    clamped = true;
    o.dis_x = pick3(e, dxc[0], dxc[1], dxc[2]);
    o.dis_y = pick3(e, dyc[0], dyc[1], dyc[2]);
  }
  const float dis = o.dis_x * o.dis_x + o.dis_y * o.dis_y;
  if (!inside && dis >= p.threshold) return false;
  o.sign = inside ? 1.0f : -1.0f;
  o.frag = 1.0f / (1.0f + expf(-(o.sign * dis * p.inv_sigma)));

  // the selected foot point's weights (t - w, shifted by the clamp delta
  // on the edge's two vertices), plus w again: the vertex-gradient factor
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float ts = pick3(e, tu[0][j], tu[1][j], tu[2][j]);
    if (clamped) {
      const float d = pick3(e, dl[0], dl[1], dl[2]);
      if (j == e) ts = ts + d;
      else if (j == (e + 1) % 3) ts = ts - d;
    }
    o.tw[j] = ts + w[j];
  }

  // clipped barycentrics, perspective-correct depth, nearest texel
  float wc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) wc[k] = clampf(w[k], p.wlo, p.whi);
  const float rws = 1.0f / fmaxf(wc[0] + wc[1] + wc[2], 1e-5f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    wc[k] = wc[k] * rws;
    o.wc[k] = wc[k];
  }
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

// Stages faces fids[base .. base + nc) of image b into shared memory: the
// setup records, the kept ids (-1: padding or degenerate) and, when tex is
// given, their texel sheets. Callers synchronise before and after.
__device__ inline void stage_faces(const float* __restrict__ fv,
                                   const float* __restrict__ tex,
                                   const int* __restrict__ fids, int b,
                                   int nc, const Params& p, float* s_face,
                                   int* s_fid, float* s_tex) {
  const int tid = threadIdx.x;
  if (tid < nc) {
    const int f = fids[tid];
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
  if (tex != nullptr) {
    const int T3 = p.T2 * 3;
    for (int i = tid; i < nc * T3; i += NTH) {
      const int j = i / T3;
      const int f = fids[j];
      s_tex[i] = f < p.F ? tex[((size_t)b * p.F + f) * T3 + (i - j * T3)]
                         : 0.f;
    }
  }
}

// Pixel centre (xp, yp) of a thread's q-th pixel in tile t; row/col out.
__device__ __forceinline__ void pixel_of(int t, int q, const Params& p,
                                         int& row, int& col, float& xp,
                                         float& yp) {
  const int lane = threadIdx.x + q * NTH;
  col = (t % p.TX) * TS + lane % TS;
  row = (t / p.TX) * TS + lane / TS;
  xp = (2.0f * (float)col + 1.0f - (float)p.S) / (float)p.S;
  yp = (2.0f * (float)(p.S - 1 - row) + 1.0f - (float)p.S) / (float)p.S;
}

}  // namespace umr
