// Face -> tile bins that keep every entry, for Hopper (sm_90a).
//
// The layout is ops/raster_bins.py's, which both raster kernels walk: per
// image, the face ids of tile 0, then tile 1, ... in ascending face
// order; each tile's range starts at a multiple of GROUP and is padded
// with the dummy id F; astarts [B, n_tiles + 1] holds the ranges' starts
// and the end of the last. Here no cap applies: a tile holds every face
// whose margin-expanded bbox reaches it, however many tiles the face
// spans, so the entry array is sized for the worst case (every face in
// every tile, n_tiles * round_up(F, GROUP) entries an image). Entries
// past astarts[b][n_tiles] are left unwritten. The plain twin is
// ops/raster_bins.py::_full_bins_plain.
//
// Two launches:
//   * bins_count_kernel, one thread per face, 256 faces a block: the
//     face's tile rectangle (ops/raster_bins.py::face_tile_rect, the same
//     float32 expressions in the same order, so the two agree bit for
//     bit under --fmad=false), packed into one word, and a shared
//     histogram of the tiles it covers, added to counts [B, n_tiles];
//   * bins_fill_kernel, one block per (tile, image): the tile's start
//     from the padded counts of the tiles before it, then the image's
//     faces in chunks of 256, each chunk's hits written in ascending order
//     (a ballot per warp and the warps' totals in shared memory), then the
//     padding. A tile stops scanning once it has all its faces.
//
// What bounds it: the fill's scan reads every face's packed rectangle
// once per tile (from L2: 4 bytes a face), so its work grows as
// n_tiles * F an image; the least bytes are the vertices' x and y read
// and the starts and entries written.

#include <cuda_runtime.h>

namespace {

constexpr int NTH = 256;
constexpr int GROUP = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned EMPTY = 0xffu;  // tx0 = 255 > tx1 = 0: no tile

struct BinsParams {
  int B, F, S, TX, n_tiles, E;
  float margin;
  unsigned long long* entries;  // += the pairs binned, or null
};

__device__ __forceinline__ int tile_of(float v, int TX) {
  // torch.floor(v / ts).clamp(0, TX - 1); a division by 32 is exact
  return (int)fminf(fmaxf(floorf(v / 32.0f), 0.0f), (float)(TX - 1));
}

__host__ __device__ __forceinline__ int pad(int n) {
  return (n + GROUP - 1) / GROUP * GROUP;
}

__global__ void __launch_bounds__(NTH)
bins_count_kernel(const float* __restrict__ fv,   // [B, F, 3, 3]
                  unsigned* __restrict__ rect,    // [B, F] packed
                  int* __restrict__ counts,       // [B, n_tiles], zeroed
                  BinsParams p) {
  extern __shared__ int s_hist[];                 // [n_tiles]
  __shared__ int s_sum[NTH / 32];
  const int b = blockIdx.y, f = blockIdx.x * NTH + threadIdx.x;
  for (int i = threadIdx.x; i < p.n_tiles; i += NTH) s_hist[i] = 0;
  __syncthreads();
  int n = 0;
  if (f < p.F) {
    const float* v = fv + ((size_t)b * p.F + f) * 9;
    const float x0 = v[0], x1 = v[3], x2 = v[6];
    const float y0 = v[1], y1 = v[4], y2 = v[7];
    const float fS = (float)p.S, half = (float)(p.S - 1) * 0.5f;
    const float last = (float)(p.S - 1);
    const float xmin = fminf(fminf(x0, x1), x2);
    const float xmax = fmaxf(fmaxf(x0, x1), x2);
    const float ymin = fminf(fminf(y0, y1), y2);
    const float ymax = fmaxf(fmaxf(y0, y1), y2);
    const float col_min = (xmin - p.margin) * fS / 2.0f + half;
    const float col_max = (xmax + p.margin) * fS / 2.0f + half;
    const float row_min = (last - (ymax + p.margin) * fS) / 2.0f;
    const float row_max = (last - (ymin - p.margin) * fS) / 2.0f;
    unsigned packed = EMPTY;
    // a face with a non-finite coordinate covers no tile (the comparisons
    // below are false for NaN, so test it first)
    const bool finite = isfinite(x0) && isfinite(x1) && isfinite(x2) &&
                        isfinite(y0) && isfinite(y1) && isfinite(y2);
    if (finite && !(col_max < 0.0f || col_min > last || row_max < 0.0f ||
                    row_min > last)) {
      const int tx0 = tile_of(col_min, p.TX), tx1 = tile_of(col_max, p.TX);
      const int ty0 = tile_of(row_min, p.TX), ty1 = tile_of(row_max, p.TX);
      packed = (unsigned)tx0 | (unsigned)tx1 << 8 | (unsigned)ty0 << 16 |
               (unsigned)ty1 << 24;
      for (int ty = ty0; ty <= ty1; ++ty)
        for (int tx = tx0; tx <= tx1; ++tx)
          atomicAdd(&s_hist[ty * p.TX + tx], 1);
      n = (tx1 - tx0 + 1) * (ty1 - ty0 + 1);
    }
    rect[(size_t)b * p.F + f] = packed;
  }
  __syncthreads();
  int* cb = counts + (size_t)b * p.n_tiles;
  for (int i = threadIdx.x; i < p.n_tiles; i += NTH)
    if (s_hist[i]) atomicAdd(&cb[i], s_hist[i]);
  if (p.entries) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(FULL, n, o);
    if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = n;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long tot = 0;
      for (int w = 0; w < NTH / 32; ++w) tot += (unsigned)s_sum[w];
      if (tot) atomicAdd(p.entries, tot);
    }
  }
}

__global__ void __launch_bounds__(NTH)
bins_fill_kernel(const unsigned* __restrict__ rect,  // [B, F]
                 const int* __restrict__ counts,     // [B, n_tiles]
                 int* __restrict__ al_fids,          // [B, E]
                 int* __restrict__ astarts,          // [B, n_tiles + 1]
                 BinsParams p) {
  __shared__ int s_w[NTH / 32];
  __shared__ int s_start;
  const int t = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* cb = counts + (size_t)b * p.n_tiles;

  // the tile's start: the padded counts of the tiles before it
  int s = 0;
  for (int i = tid; i < t; i += NTH) s += pad(cb[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) s_w[warp] = s;
  __syncthreads();
  if (tid == 0) {
    int start = 0;
    for (int w = 0; w < NTH / 32; ++w) start += s_w[w];
    s_start = start;
    int* ab = astarts + (size_t)b * (p.n_tiles + 1);
    ab[t] = start;
    if (t == p.n_tiles - 1) ab[p.n_tiles] = start + pad(cb[t]);
  }
  __syncthreads();
  const int start = s_start, n = cb[t];
  if (n == 0) return;  // uniform across the block
  int* out = al_fids + (size_t)b * p.E + start;
  const unsigned tx = (unsigned)(t % p.TX), ty = (unsigned)(t / p.TX);
  const unsigned* rb = rect + (size_t)b * p.F;
  int done = 0;
  for (int f0 = 0; f0 < p.F && done < n; f0 += NTH) {
    const int f = f0 + tid;
    bool hit = false;
    if (f < p.F) {
      const unsigned r = rb[f];
      hit = (r & 0xffu) <= tx && tx <= (r >> 8 & 0xffu) &&
            (r >> 16 & 0xffu) <= ty && ty <= (r >> 24);
    }
    const unsigned m = __ballot_sync(FULL, hit);
    __syncthreads();  // the previous chunk's s_w is read
    if (lane == 0) s_w[warp] = __popc(m);
    __syncthreads();
    int before = done, total = 0;
    for (int w = 0; w < NTH / 32; ++w) {
      if (w < warp) before += s_w[w];
      total += s_w[w];
    }
    if (hit) out[before + __popc(m & ((1u << lane) - 1u))] = f;
    done += total;
  }
  for (int i = n + tid; i < pad(n); i += NTH) out[i] = p.F;
}

}  // namespace

extern "C" {

// Bins of B images of F faces at S x S (S a multiple of 32, S / 32 <=
// 255) on `stream`: counts (zeroed by the caller), rect (scratch), al_fids
// [B, E] with E >= n_tiles * round_up(F, 8), astarts [B, n_tiles + 1];
// entries is an int64 accumulator or null. Returns
// cudaGetLastError() after the launches (0 on success).
int umr_raster_bins(const float* fv, unsigned* rect, int* counts,
                    int* al_fids, int* astarts, int B, int F, int S, int E,
                    float margin, unsigned long long* entries,
                    void* stream) {
  if (S <= 0 || S % 32 || S / 32 > 255 || B <= 0 || F <= 0)
    return (int)cudaErrorInvalidValue;
  BinsParams p{};
  p.B = B;
  p.F = F;
  p.S = S;
  p.TX = S / 32;
  p.n_tiles = p.TX * p.TX;
  p.E = E;
  p.margin = margin;
  p.entries = entries;
  if ((long long)p.n_tiles * pad(F) > (long long)E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)p.n_tiles * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bins_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bins_count_kernel<<<dim3((F + NTH - 1) / NTH, B), NTH, smem, s>>>(
      fv, rect, counts, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bins_fill_kernel<<<dim3(p.n_tiles, B), NTH, 0, s>>>(rect, counts, al_fids,
                                                       astarts, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
