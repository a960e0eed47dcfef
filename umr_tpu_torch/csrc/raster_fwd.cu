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
// shapes); each (pixel, face) pair in the face's margin-expanded bbox
// costs ~180 operations, three divides and two exponentials, while the
// tile reads a few KB of face data (hot in L2) and writes 24 bytes per
// pixel.
//
// What the design does about it:
//   * one block per (32x32 tile, image), 8 warps of 4 pixel slots; a
//     warp's 32 lanes sit on an 8x4 block of pixels in each slot, so a
//     small face's bbox holds few of a slot's blocks and many of the
//     lanes of those it holds;
//   * the tile's faces are staged in shared memory CH at a time; one thread
//     per face computes everything that depends on the face alone (the
//     degenerate cull, the inverse barycentric rows, the per-edge foot
//     point coefficients, the obtuse-corner flags, the bbox with the cull
//     margin, 1/z), so the per-pair work is only what depends on the pixel;
//     the records have an odd stride, so the 32 staging threads write
//     different banks;
//   * per chunk, each warp learns which of its 4 blocks each face's bbox
//     reaches (lane j tests face j's bbox against the blocks' first and
//     last pixel centres, the warp ballots: one 32-bit mask per slot),
//     walks the union of the 4 masks from low bit to high, and per face
//     runs the pair arithmetic only in the slots whose block the bbox
//     reaches; there each lane's pixel meets pair_math's exact bbox test.
//     A face costs a block it misses one bit test, not the distance code,
//     and the lanes of a slot work on one face at a time;
//   * the pixels' accumulators live in shared memory ([field][slot]), read
//     and written around each pair that passes the distance threshold, so
//     registers hold the pair arithmetic alone: the p2f-free instances fit
//     48 registers without a spill at 5 blocks of 8 warps per SM, the p2f
//     ones 64 at 4.
//   Measured against each lane walking its own pixels' bits (lanes on
//   different faces diverge in the distance code and lose where faces are
//   large), against per-face compaction of the bbox pixels onto the lanes
//   (its bookkeeping costs more than the lanes it saves) and against
//   per-lane bbox masks (a quarter of the time outside the pair
//   arithmetic went to building them); see PERF.md.
//
// Numerics: compiled without --use_fast_math and with --fmad=false. The
// per-pair expressions are the ones the plain version
// (umr_tpu_torch/ops/rasterize.py) evaluates, in the same order, one
// rounding per operation, so barycentrics, depths, texel indices and the
// hard z-winner agree with it bit for bit; only the order of the softmax
// and alpha sums differs. Each pixel sees its faces in ascending bin order
// (the chunks in order, a chunk's faces from low bit to high), skipping
// only faces whose bbox misses its block or its centre, which add nothing;
// so the hard winner, replaced only on a strictly smaller depth, goes to
// the lowest face id on ties, as on the TPU, and every pixel's sequence of
// operations is that of a walk over every binned face.
//
// p2f (the NEED_P2F instances, softmax only): per face, the sums over
// the image of contrib * (gx, gy, 1), gx = 2 col / (S - 1) - 1 and
// gy = 2 row / (S - 1) - 1, contrib being the softmax weight of the pair
// after the pixel's running max has taken this face in (the reference
// CUDA kernel's rule). The warp's lanes are all on the face the walk is
// at: each lane sums its slots, the warp reduces with shuffles (skipped
// when no lane's pixels took the face in), and lane 0 adds the sums into
// the warp's own region of shared memory with plain stores, so there are
// no shared float atomics (a compare-and-swap loop on this card). After
// each chunk the 8 warps' regions are summed in a fixed order and every
// non-zero sum goes to the zeroed [B, F, 3] sums with one global
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

constexpr int NW = NTH / 32;     // warps per block
constexpr int NPIX = TS * TS;    // pixels per tile
constexpr int NFS = NF + 1;      // staged record stride, odd
constexpr unsigned FULL = 0xffffffffu;

static_assert(CH == 32, "a chunk's faces are the bits of one mask");
static_assert(NW == 8 && PPT == 4, "the slot layout below");

// Tile-local column and row of thread tid's slot q: slot q of warp w is
// the 8x4 pixel block (w % 4, 2 q + w / 4) of the tile's 4 x 8 blocks,
// lane l its pixel (l % 8, l / 8). The plain twin is
// ops/raster_kernel.py::fwd_slot_pixels.
__device__ __forceinline__ int slot_col(int tid) {
  return ((tid >> 5) & 3) * 8 + (tid & 7);
}
__device__ __forceinline__ int slot_row(int tid, int q) {
  return (2 * q + (tid >> 7)) * 4 + ((tid >> 3) & 3);
}

// The slot (q * NTH + tid) that holds tile-local pixel (row, col).
__device__ __forceinline__ int slot_of(int row, int col) {
  const int by = row >> 2, bx = col >> 3;
  return (by >> 1) * NTH + ((by & 1) * 4 + bx) * 32 + (row & 3) * 8 +
         (col & 7);
}

// Pixel centre coordinates of an image column and row (the plain
// version's ops/rasterize.py::pixel_coords; the backward computes the same)
__device__ __forceinline__ float centre_x(int col, const Params& p) {
  return (2.0f * (float)col + 1.0f - (float)p.S) / (float)p.S;
}
__device__ __forceinline__ float centre_y(int row, const Params& p) {
  return (2.0f * (float)(p.S - 1 - row) + 1.0f - (float)p.S) / (float)p.S;
}

// Stages faces fids[0 .. nc) of image b: the setup records (stride NFS),
// their bbox test bounds (a face that is padding or degenerate gets bounds
// no pixel passes), the kept ids (-1: skip) and, when tex is given, their
// texel rows. Callers synchronise before and after.
__device__ __forceinline__ void stage(const float* __restrict__ fv,
                                      const float* __restrict__ tex,
                                      const int* __restrict__ fids, int b,
                                      int nc, const Params& p,
                                      float4* s_box, float* s_face,
                                      int* s_fid, float* s_tex) {
  const int tid = threadIdx.x;
  if (tid < nc) {
    const int f = fids[tid];
    int keep = -1;
    float4 box = make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
    if (f < p.F) {
      float* r = s_face + tid * NFS;
      const int flags = face_setup(fv + ((size_t)b * p.F + f) * 9, r, p);
      if (flags >= 0) {
        r[NF - 1] = __int_as_float(flags);
        keep = f;
        box = make_float4(r[R_BOX + 0], r[R_BOX + 1], r[R_BOX + 2],
                          r[R_BOX + 3]);
      }
    }
    s_fid[tid] = keep;
    s_box[tid] = box;
  }
  if (tex != nullptr) {
    const int T3 = p.T2 * 3;
    for (int i = tid; i < nc * T3; i += NTH) {
      const int j = i / T3, k = i - j * T3;
      const int f = fids[j];
      s_tex[i] = f < p.F ? tex[((size_t)b * p.F + f) * T3 + k] : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// 5 blocks of 8 warps per SM for the p2f-free instances (48 registers, no
// spill; 1-5% faster than at 4 blocks, 64 registers), 4 for the p2f ones
// (at 5 they spill)
template <bool HARD, bool MASK_ONLY, bool NEED_P2F>
__global__ void __launch_bounds__(NTH, NEED_P2F ? 4 : 5)
raster_fwd_kernel(const float* __restrict__ fv,     // [B, F, 3, 3]
                  const float* __restrict__ tex,    // [B, F, T2, 3]
                  const int* __restrict__ al_fids,  // [B, E_al]
                  const int* __restrict__ astarts,  // [B, n_tiles + 1]
                  float* __restrict__ rgba,         // [B, S, S, 4]
                  float* __restrict__ aggr,         // [B, 2, S, S]
                  float* __restrict__ p2f,          // [B, F, 3] if NEED_P2F
                  Params p) {
  static_assert(!(HARD && NEED_P2F), "the hard body writes no p2f");
  constexpr bool TEX = HARD || !MASK_ONLY;  // texels are read
  // per-pixel fields: softmax (max, sum, log(1 - alpha), colour sums);
  // hard (depth, face id, log(1 - alpha), colour)
  constexpr int NST = TEX ? 6 : 3;
  extern __shared__ float4 smem4[];
  const int T3 = p.T2 * 3;
  float4* s_box = smem4;                          // [CH]
  float* s_face = (float*)(s_box + CH);           // [CH][NFS]
  int* s_fid = (int*)(s_face + CH * NFS);         // [CH], -1 = skip
  float* s_cy = (float*)(s_fid + CH);            // [TS] rows' centre y
  float* s_cx = s_cy + TS;                        // [TS] columns' centre x
  float* s_st = s_cx + TS;                        // [NST][NPIX] by slot
  float* s_tex = s_st + NST * NPIX;               // [CH][T3] if TEX
  float* s_wp = s_tex + (TEX ? CH * T3 : 0);      // [NW][CH][3] if NEED_P2F

  const int t = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int x0 = (t % p.TX) * TS, y0 = (t / p.TX) * TS;
  const int col = x0 + slot_col(tid);  // the same in every slot
  const float xp = centre_x(col, p);
  const float gx = 2.0f * (float)col / (float)(p.S - 1) - 1.0f;

  if (tid < TS) {
    s_cy[tid] = centre_y(y0 + tid, p);
    s_cx[tid] = centre_x(x0 + tid, p);
  }
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    float* st = s_st + q * NTH + tid;
    st[0] = HARD ? 1e7f : p.eps;
    st[NPIX] = HARD ? -1.f : p.bg_weight;
    st[2 * NPIX] = 0.f;
    if (TEX) {
      st[3 * NPIX] = HARD ? p.bg0 : p.bg0 * p.bg_weight;
      st[4 * NPIX] = HARD ? p.bg1 : p.bg1 * p.bg_weight;
      st[5 * NPIX] = HARD ? p.bg2 : p.bg2 * p.bg_weight;
    }
  }
  if (NEED_P2F)
    for (int i = tid; i < NW * CH * 3; i += NTH) s_wp[i] = 0.f;
  float* s_wq = s_wp + (tid >> 5) * CH * 3;  // this warp's p2f region

  const int* starts = astarts + (size_t)b * (p.n_tiles + 1);
  const int start = starts[t];
  const int n = min(starts[t + 1] - start, p.mf_cap);
  const int* fids = al_fids + (size_t)b * p.E_al + start;

  for (int base = 0; base < n; base += CH) {
    const int nc = min(CH, n - base);
    __syncthreads();  // the previous chunk is no longer read
    stage(fv, TEX ? tex : nullptr, fids + base, b, nc, p, s_box, s_face,
          s_fid, s_tex);
    __syncthreads();

    // bit j of mq[q]: face j's bbox reaches this warp's block in slot q
    // (its x range meets the block's first and last columns' centres, its
    // y range the rows'; pair_math's bbox test then decides each pixel):
    // lane j tests face j, the warp ballots. The plain twin is
    // ops/raster_kernel.py::fwd_block_hits
    unsigned mq[PPT];
    {
      const int bx = ((tid >> 5) & 3) * 8;  // the warp's blocks' columns
      bool in_x = false;
      float4 bb = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lane < nc) {
        bb = s_box[lane];
        in_x = s_cx[bx] <= bb.x && s_cx[bx + 7] >= bb.y;
      }
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int by = (2 * q + (tid >> 7)) * 4;  // rows by .. by + 3
        mq[q] = __ballot_sync(FULL, in_x && s_cy[by + 3] <= bb.z &&
                                        s_cy[by] >= bb.w);
      }
    }

    // the walk: the union of the warp's bits, faces ascending; per face,
    // the slots whose block the bbox reaches
    unsigned u = mq[0] | mq[1] | mq[2] | mq[3];
    while (u) {
      const int j = __ffs(u) - 1;
      u &= u - 1u;
      const float* r = s_face + j * NFS;
      float v0 = 0.f, v1 = 0.f, v2 = 0.f;
      bool any = false;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        if (!((mq[q] >> j) & 1u)) continue;  // uniform across the warp
        const int lr = slot_row(tid, q);
        Pair o;
        if (!pair_math(r, xp, s_cy[lr], p, o)) continue;
        float* st = s_st + q * NTH + tid;
        float a0 = st[0], a1 = st[NPIX], la = st[2 * NPIX];
        float c0 = 0.f, c1 = 0.f, c2 = 0.f;
        if (TEX) {
          c0 = st[3 * NPIX];
          c1 = st[4 * NPIX];
          c2 = st[5 * NPIX];
        }
        la += log1pf(-o.frag);
        const bool z_ok = o.zp >= p.near_ && o.zp <= p.far_;
        if (HARD) {
          if (z_ok && o.inside01 && o.zp < a0) {
            a0 = o.zp;
            a1 = (float)s_fid[j];
            const float* tx = s_tex + j * T3 + o.tex_idx * 3;
            c0 = tx[0];
            c1 = tx[1];
            c2 = tx[2];
          }
        } else if (z_ok) {
          const float z = (p.far_ - o.zp) * p.inv_depth_range;
          if (z > a0) {
            const float sc = expf((a0 - z) * p.inv_gamma);
            a1 *= sc;
            if (!MASK_ONLY) {
              c0 *= sc;
              c1 *= sc;
              c2 *= sc;
            }
            a0 = z;
          }
          const float contrib = expf((z - a0) * p.inv_gamma) * o.frag;
          a1 += contrib;
          if (NEED_P2F) {
            any = true;
            v0 += contrib * gx;
            v1 += contrib * (2.0f * (float)(y0 + lr) / (float)(p.S - 1) -
                             1.0f);
            v2 += contrib;
          }
          if (!MASK_ONLY) {
            const float* tx = s_tex + j * T3 + o.tex_idx * 3;
            c0 += contrib * tx[0];
            c1 += contrib * tx[1];
            c2 += contrib * tx[2];
          }
        }
        st[0] = a0;
        st[NPIX] = a1;
        st[2 * NPIX] = la;
        if (TEX) {
          st[3 * NPIX] = c0;
          st[4 * NPIX] = c1;
          st[5 * NPIX] = c2;
        }
      }
      if (NEED_P2F && __any_sync(FULL, any)) {
        v0 = warp_sum(v0);
        v1 = warp_sum(v1);
        v2 = warp_sum(v2);
        if (lane == 0) {
          s_wq[j * 3 + 0] += v0;
          s_wq[j * 3 + 1] += v1;
          s_wq[j * 3 + 2] += v2;
        }
      }
    }

    if (NEED_P2F) {
      __syncthreads();
      // the warps' sums in a fixed order, one atomic per (entry, lane)
      // into the face's sums; the regions zeroed for the next chunk
      for (int i = tid; i < nc * 3; i += NTH) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          v += s_wp[w * CH * 3 + i];
          s_wp[w * CH * 3 + i] = 0.f;
        }
        const int f = s_fid[i / 3];
        if (f >= 0 && v != 0.f)
          atomicAdd(p2f + ((size_t)b * p.F + f) * 3 + i % 3, v);
      }
    }
  }

  __syncthreads();  // the fields of every slot are final
  const size_t plane = (size_t)p.S * p.S;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * NTH;  // row-major in the tile
    const float* st = s_st + slot_of(i / TS, i % TS);
    const float f0 = st[0], f1 = st[NPIX], fl = st[2 * NPIX];
    const size_t pix = (size_t)(y0 + i / TS) * p.S + (x0 + i % TS);
    float4 out;
    if (HARD) {
      const bool has = f1 >= 0.f;
      out = make_float4(has ? st[3 * NPIX] : p.bg0,
                        has ? st[4 * NPIX] : p.bg1,
                        has ? st[5 * NPIX] : p.bg2, 1.0f - expf(fl));
    } else if (MASK_ONLY) {
      out = make_float4(p.bg0, p.bg1, p.bg2, 1.0f - expf(fl));
    } else {
      out = make_float4(st[3 * NPIX] / f1, st[4 * NPIX] / f1,
                        st[5 * NPIX] / f1, 1.0f - expf(fl));
    }
    reinterpret_cast<float4*>(rgba)[(size_t)b * plane + pix] = out;
    // softmax: (sum, max); hard: (depth, face id)
    aggr[((size_t)b * 2 + 0) * plane + pix] = HARD ? f0 : f1;
    aggr[((size_t)b * 2 + 1) * plane + pix] = HARD ? f1 : f0;
  }
}

template <bool HARD, bool MASK_ONLY, bool NEED_P2F = false>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* fv,
                   const float* tex, const int* al_fids, const int* astarts,
                   float* rgba, float* aggr, float* p2f, const Params& p) {
  constexpr bool TEX = HARD || !MASK_ONLY;
  const size_t smem =
      sizeof(float4) * CH + sizeof(float) * CH * NFS + sizeof(int) * CH +
      sizeof(float) * 2 * TS + sizeof(float) * (TEX ? 6 : 3) * NPIX +
      (TEX ? sizeof(float) * CH * p.T2 * 3 : 0) +
      (NEED_P2F ? sizeof(float) * NW * CH * 3 : 0);
  auto kern = raster_fwd_kernel<HARD, MASK_ONLY, NEED_P2F>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, NTH, smem, stream>>>(fv, tex, al_fids, astarts, rgba, aggr,
                                    p2f, p);
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (hard)
    return (int)launch<true, false>(grid, st, fv, tex, al_fids, astarts, rgba,
                                    aggr, nullptr, p);
  if (mask_only)
    return need_p2f
               ? (int)launch<false, true, true>(grid, st, fv, tex, al_fids,
                                                astarts, rgba, aggr, p2f, p)
               : (int)launch<false, true>(grid, st, fv, tex, al_fids,
                                          astarts, rgba, aggr, nullptr, p);
  return need_p2f
             ? (int)launch<false, false, true>(grid, st, fv, tex, al_fids,
                                               astarts, rgba, aggr, p2f, p)
             : (int)launch<false, false>(grid, st, fv, tex, al_fids, astarts,
                                         rgba, aggr, nullptr, p);
}

const char* umr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
