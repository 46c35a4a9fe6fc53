// Run building and run coalescing for NVIDIA Hopper (sm_90a): four kernels.
//
// - match_pairs replaces limg_tpu/pallas_kernels/encode_merged.py:
//   match_pairs_pallas (:516, kernel :488): the 27-probe merge test on paired
//   (7ch, N) float32 row stacks. One warp per pair, lane p probe p
//   (limg_common.cuh match_rows, the predicate fit_levels uses too).
// - match_neighbors replaces match_neighbors_pallas (:587, kernel :537): the
//   same test of each block against its right and its down neighbour on the
//   (7ch, by, bx) row plane. One warp per block, which reads its neighbours
//   by address: no halo tiles (those exist for the TPU's (8, 128) tiling).
// - seg_scan replaces limg_tpu/pallas_kernels/seg_scan.py:
//   seg_mixed_all_pallas (:140, kernel :41): the doubling-scan chain of
//   ops/segments.py over one row of 1024 lanes per CTA, with halos of
//   SEG_CAP lanes on each side in shared memory (a lane's result depends on
//   lanes within SEG_CAP - 1 of it), double-buffered steps.
// - segment_encode replaces limg_tpu/pallas_kernels/encode_segments.py:
//   segment_encode_pallas (:188, kernel :114): refit, factors, crush search,
//   dither and decode of the contiguous segments of the run buffer.
//
// What bounds them on the H100: the match kernels are ~40 float operations
// per probe lane and pair, over 160 K pairs at 4K (compute, a few us); the
// scan is 8 shared-memory steps over data read once. The segment encode
// does the work of the fixed-grid kernel per block (a fit and 35+ exact
// candidate decodes) plus a segment reduction after every fit step and
// candidate batch, so it is compute- and barrier-bound.
//
// segment_encode's design: segment ids are the first member's position,
// members are contiguous and a segment has at most SEG_CAP of them. CTA k
// takes the whole segments that start in lanes [128k, 128k + 128), at most
// 383 lanes, so every reduction stays inside the CTA. A warp works on one
// block at a time (its 64 pixels in registers, as in encode_fixed) and loops
// over the CTA's blocks; between the steps of the fit and between candidate
// batches the blocks' partial values meet in shared memory:
// - float sums (counts, channel sums, unit-vector sums) and the factor
//   extremes go through the doubling scan of ops/segments.py in the plain
//   version's order, fwd + bwd - x, which is not the exact segment sum and
//   can differ between members;
// - the crush's integer pixel maxima and error sums are order-free, so they
//   are per-segment shared-memory atomics;
// - the fit's per-pixel steps are repeated from the image in each phase
//   (limg_common.cuh FitSteps), its factors go to a scratch plane for the
//   crush, and per-block state (region values, ladder boxes, candidates,
//   the running best) lives in shared memory, one column per block.
// Empty blocks (non-run lanes: zero mask) run the same code and get the
// plain version's outputs; nothing is skipped.

#include "limg_common.cuh"

namespace {

using namespace limg;

constexpr int kSegCap = 256;       // ops/segments.py SEG_CAP
constexpr int kSegErrShift = 8;    // ops/segments.py SEG_ERR_SHIFT

// ---------------------------------------------------------------------------
// match_pairs / match_neighbors
// ---------------------------------------------------------------------------

constexpr int kMatchWarps = 8;

template <int CH>
__global__ void __launch_bounds__(kMatchWarps * 32)
match_pairs_kernel(const float* __restrict__ a, const float* __restrict__ b, int n,
                   bool* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kMatchWarps + (threadIdx.x >> 5);
  if (g >= n) return;  // whole warps
  float avg_a[CH], avg_b[CH];
  int ep_a[6][CH], ep_b[6][CH];
  load_decomp<CH>(a, n, g, avg_a, ep_a);
  load_decomp<CH>(b, n, g, avg_b, ep_b);
  bool m;
  match_rows<CH>(avg_a, ep_a, avg_b, ep_b, lane, m);
  if (lane == 0) out[g] = m;
}

template <int CH>
__global__ void __launch_bounds__(kMatchWarps * 32)
match_neighbors_kernel(const float* __restrict__ rows, int by, int bx, bool* __restrict__ right,
                       bool* __restrict__ down) {
  const int lane = threadIdx.x & 31;
  const int nb = by * bx;
  const int g = blockIdx.x * kMatchWarps + (threadIdx.x >> 5);
  if (g >= nb) return;  // whole warps
  const int y = g / bx, x = g % bx;
  float avg_b[CH], avg_a[CH];
  int ep_b[6][CH], ep_a[6][CH];
  load_decomp<CH>(rows, nb, g, avg_b, ep_b);
  bool m_right = false, m_down = false;
  if (x + 1 < bx) {  // a = the +1 neighbour, b = the block itself
    load_decomp<CH>(rows, nb, g + 1, avg_a, ep_a);
    match_rows<CH>(avg_a, ep_a, avg_b, ep_b, lane, m_right);
  }
  if (y + 1 < by) {
    load_decomp<CH>(rows, nb, g + bx, avg_a, ep_a);
    match_rows<CH>(avg_a, ep_a, avg_b, ep_b, lane, m_down);
  }
  if (lane == 0) {
    right[g] = m_right;
    down[g] = m_down;
  }
}

// ---------------------------------------------------------------------------
// seg_scan
// ---------------------------------------------------------------------------

constexpr int kScanTile = 1024;
constexpr int kScanThreads = 256;
constexpr int kScanWidth = kScanTile + 2 * kSegCap;
constexpr int kScanPer = kScanWidth / kScanThreads;

__device__ __forceinline__ int seg_add(int a, int b) { return add_wrap(a, b); }
__device__ __forceinline__ float seg_add(float a, float b) { return a + b; }
__device__ __forceinline__ int seg_max(int a, int b) { return max(a, b); }
__device__ __forceinline__ float seg_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int sum_finish(int f, int b, int x) {
  return (int)((uint32_t)f + (uint32_t)b - (uint32_t)x);
}
__device__ __forceinline__ float sum_finish(float f, float b, float x) { return (f + b) - x; }

// Row blockIdx.y, centre lanes [1024 * blockIdx.x, + 1024). Lanes outside the
// array carry the plain version's shifted-in fills: segment -1 on the left,
// -2 on the right, value 0 (sum rows) or init_max (max rows).
template <class T>
__global__ void __launch_bounds__(kScanThreads)
seg_scan_kernel(const T* __restrict__ x, const int32_t* __restrict__ seg, int n, int n_sum,
                T init_max, int steps, T* __restrict__ out) {
  __shared__ T sx[kScanWidth], sf[kScanWidth], sb[kScanWidth];
  __shared__ int ss[kScanWidth];
  const int row = blockIdx.y;
  const bool is_sum = row < n_sum;
  const T fill = is_sum ? T(0) : init_max;
  const long long lo = (long long)blockIdx.x * kScanTile - kSegCap;
  const T* xr = x + (size_t)row * n;
  for (int i = threadIdx.x; i < kScanWidth; i += kScanThreads) {
    const long long g = lo + i;
    const bool in = g >= 0 && g < n;
    ss[i] = in ? seg[g] : (g < 0 ? -1 : -2);
    const T v = in ? xr[g] : fill;
    sx[i] = v;
    sf[i] = v;
    sb[i] = v;
  }
  __syncthreads();
  for (int k = 0, d = 1; k < steps; ++k, d <<= 1) {
    T nf[kScanPer], nbk[kScanPer];
#pragma unroll
    for (int e = 0; e < kScanPer; ++e) {
      const int i = threadIdx.x + e * kScanThreads;
      T f = sf[i], b = sb[i];
      if (i >= d && ss[i - d] == ss[i]) f = is_sum ? seg_add(f, sf[i - d]) : seg_max(f, sf[i - d]);
      if (i + d < kScanWidth && ss[i + d] == ss[i])
        b = is_sum ? seg_add(b, sb[i + d]) : seg_max(b, sb[i + d]);
      nf[e] = f;
      nbk[e] = b;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kScanPer; ++e) {
      const int i = threadIdx.x + e * kScanThreads;
      sf[i] = nf[e];
      sb[i] = nbk[e];
    }
    __syncthreads();
  }
  for (int i = kSegCap + threadIdx.x; i < kSegCap + kScanTile; i += kScanThreads) {
    const long long g = lo + i;
    if (g < n) out[(size_t)row * n + g] = is_sum ? sum_finish(sf[i], sb[i], sx[i]) : seg_max(sf[i], sb[i]);
  }
}

// ---------------------------------------------------------------------------
// segment_encode
// ---------------------------------------------------------------------------

constexpr int kSegTile = 128;                    // segment starts per CTA
constexpr int kSegLanes = kSegTile + kSegCap - 1;  // the most lanes they cover
constexpr int kSegWarps = 8;
constexpr int kSegThreads = kSegWarps * 32;
constexpr int kScanRows = 6;                     // float rows scanned at once
constexpr int kBatch = 9;                        // candidates per reduction
constexpr int kMaxK = 16;                        // kernels/coalesce.py MAX_LADDER_K

// Per-block state rows (ints; floats by bit pattern). The crush's rows reuse
// the fit's once the endpoints are out, and the ladder candidates reuse the
// box rows once the keys are made.
enum : int {
  S_AVG = 0, S_DIRA = 4, S_DIRB = 8, S_DIRC = 12, S_MN = 16, S_MX = 19,   // fit, floats
  S_BEST = 0, S_TOT = 1, S_ERR = 2, S_FPIX = 3, S_FBLK = 4,              // crush
  S_BASE = 5, S_DBLK = 8, S_DPIX = 20, S_ERR0 = 32, S_PIX0 = 33,          // ladder box
  S_CAND = 8,                                                            // ladder candidates
  S_COUNT = 34,                                                          // segment pixels
  kStateRows = 35,
};

struct SegShared {
  int seg[kSegLanes];  // local index of each block's segment start
  float sx[kScanRows][kSegLanes], sf[kScanRows][kSegLanes], sb[kScanRows][kSegLanes];
  int acc[2 * kBatch][kSegLanes];  // per-segment pixel maxima, then error sums
  int st[kStateRows][kSegLanes];
  int range[2];
};

struct SegParams {
  const int32_t* packed;  // (n, 64) block-major words
  const uint8_t* mask;    // (n, 64) member pixels
  const int32_t* seg;     // (n,) segment ids
  const int32_t* blocks;  // (n,) image block index (the dither counter)
  int n, crush_mode, dither, ladder_k, num_factors, max_pix, max_blk;
  uint32_t key;
  int32_t* f8;            // (n, 64) scratch: the fit's packed factors
  int32_t* shifts;        // (3, n)
  int32_t* q;             // (n, 64) or null
  int32_t* dec;           // (n, 64)
  float* dist_blk;        // (n,)
  int32_t* count_blk;     // (n,)
  int32_t* count_mem;     // (n,)
  int32_t* eps;           // (6, CH, n)
  float* avg;             // (CH, n)
};

__device__ __forceinline__ float getf(const SegShared& S, int row, int i) {
  return __int_as_float(S.st[row][i]);
}
__device__ __forceinline__ void putf(SegShared& S, int row, int i, float v) {
  S.st[row][i] = __float_as_int(v);
}
template <int N>
__device__ __forceinline__ void getv(const SegShared& S, int row, int i, float (&v)[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) v[c] = getf(S, row + c, i);
}
__device__ __forceinline__ int pack3(const int (&s)[3]) { return s[0] | (s[1] << 4) | (s[2] << 8); }
__device__ __forceinline__ void unpack3(int v, int (&s)[3]) {
  s[0] = v & 15;
  s[1] = (v >> 4) & 15;
  s[2] = (v >> 8) & 15;
}

// Block b's pixels. Pixels outside the member mask keep their values: they
// count in no sum, and the factors and decode cover every pixel of the
// buffer, as in the plain version.
template <int CH>
__device__ __forceinline__ void load_pixels(const SegParams& P, size_t b, int lane, Pixels<CH>& p) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t at = b * kP + lane + 32 * j;
    p.set(j, (uint32_t)P.packed[at], true);
    p.mask[j] = P.mask[at] != 0 ? 1 : 0;
    p.mf[j] = (float)p.mask[j];
  }
}

// Doubling scan of rows [0, nrows) of sx over the CTA's nl blocks (sums on
// rows [0, n_sum), max on the rest), results back in sx. All threads.
__device__ void tile_scan(SegShared& S, int nl, int nrows, int n_sum) {
  constexpr int kPer = (kScanRows * kSegLanes + kSegThreads - 1) / kSegThreads;
  const int tid = threadIdx.x;
  for (int e = tid; e < nrows * kSegLanes; e += kSegThreads) {
    const int r = e / kSegLanes, i = e % kSegLanes;
    if (i < nl) S.sf[r][i] = S.sb[r][i] = S.sx[r][i];
  }
  __syncthreads();
  for (int d = 1; d < kSegCap; d <<= 1) {
    float nf[kPer], nbk[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kSegThreads;
      const int r = e / kSegLanes, i = e % kSegLanes;
      if (r < nrows && i < nl) {
        const bool sum = r < n_sum;
        float f = S.sf[r][i], b = S.sb[r][i];
        if (i >= d && S.seg[i - d] == S.seg[i]) f = sum ? f + S.sf[r][i - d] : fmaxf(f, S.sf[r][i - d]);
        if (i + d < nl && S.seg[i + d] == S.seg[i])
          b = sum ? b + S.sb[r][i + d] : fmaxf(b, S.sb[r][i + d]);
        nf[k] = f;
        nbk[k] = b;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kSegThreads;
      const int r = e / kSegLanes, i = e % kSegLanes;
      if (r < nrows && i < nl) {
        S.sf[r][i] = nf[k];
        S.sb[r][i] = nbk[k];
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < nrows * kSegLanes; e += kSegThreads) {
    const int r = e / kSegLanes, i = e % kSegLanes;
    if (i < nl)
      S.sx[r][i] = r < n_sum ? (S.sf[r][i] + S.sb[r][i]) - S.sx[r][i] : fmaxf(S.sf[r][i], S.sb[r][i]);
  }
  __syncthreads();
}

// Block i's region values needed by a fit step, from the state rows.
template <int CH>
struct FitRegion {
  float avg[CH], dir_a[CH], dir_b[CH], dir_c[CH];
  __device__ void load(const SegShared& S, int i, int upto) {
    getv<CH>(S, S_AVG, i, avg);
    if (upto >= 1) getv<CH>(S, S_DIRA, i, dir_a);
    if (upto >= 2) getv<CH>(S, S_DIRB, i, dir_b);
    if (upto >= 3) getv<CH>(S, S_DIRC, i, dir_c);
  }
};

__device__ __forceinline__ float inv_count(const SegShared& S, int i) {
  return 1.0f / fmaxf((float)S.st[S_COUNT][i], 1.0f);
}

// One fit step for every block of the CTA: the per-block values of step
// `step` (1: unit-vector sums of the centred pixels, 2: of the residual
// after axis A, 3: after axis B) go to sx and through the scan, and their
// region means to the state rows at `out_row`.
template <int CH>
__device__ void fit_direction(const SegParams& P, SegShared& S, int a, int nl, int step,
                              int out_row) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < nl; i += kSegWarps) {
    Pixels<CH> p;
    load_pixels<CH>(P, (size_t)(a + i), lane, p);
    FitRegion<CH> r;
    r.load(S, i, step - 1);
    FitSteps<CH> fs;
    fs.center(p, r.avg);
    float part[CH];
    if (step == 1) {
      unit_vector_sums<CH>(fs.corrected, p.mf, part);
    } else {
      fs.axis_a(p, r.avg, r.dir_a);
      if (step == 2) {
        unit_vector_sums<CH>(fs.resid_a, p.mf, part);
      } else {
        fs.axis_b(p, r.dir_b);
        unit_vector_sums<CH>(fs.resid_ab, p.mf, part);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < CH; ++c) S.sx[c][i] = part[c];
    }
  }
  __syncthreads();
  tile_scan(S, nl, CH, CH);
  for (int i = threadIdx.x; i < nl; i += kSegThreads) {
    const float ic = inv_count(S, i);
#pragma unroll
    for (int c = 0; c < CH; ++c) putf(S, out_row + c, i, S.sx[c][i] * ic);
  }
  __syncthreads();
}

// Block i as the crush search evaluates it: pixels, the fit's factors and
// its region's (axis-dropped) endpoints and pixel count.
template <int CH>
__device__ void load_crush_block(const SegParams& P, const SegShared& S, int a, int i, int lane,
                                 Block<CH>& blk) {
  const size_t b = (size_t)(a + i);
  Pixels<CH> p;
  load_pixels<CH>(P, b, lane, p);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    blk.mask[j] = p.mask[j];
#pragma unroll
    for (int c = 0; c < CH; ++c) blk.px[c][j] = p.px[c][j];
    const int w = P.f8[b * kP + lane + 32 * j];
#pragma unroll
    for (int k = 0; k < 3; ++k) blk.f8[k][j] = (w >> (8 * k)) & 0xFF;
  }
  int ep[6][CH];
#pragma unroll
  for (int e = 0; e < 6; ++e) {
#pragma unroll
    for (int c = 0; c < CH; ++c) ep[e][c] = P.eps[((size_t)e * CH + c) * P.n + b];
  }
  blk.set_endpoints(ep);
  blk.count = S.st[S_COUNT][i];
  blk.max_pix = P.max_pix;
  blk.max_blk = P.max_blk;
  blk.es = 0;                   // 64-pixel blocks need no pre-scale ...
  blk.seg_shift = kSegErrShift;  // ... their sums shift before the segment sum
  blk.floors = false;
  blk.floor_pix = blk.floor_blk = 0;
}

// Segment totals of ncand candidates: pixel maxima in acc[c], error sums in
// acc[kBatch + c], at each segment's start. cand(i, c, s) gives block i's
// candidate c (the same for every member of a segment).
template <int CH, class Cand>
__device__ void eval_batch(const SegParams& P, SegShared& S, int a, int nl, int ncand,
                           const Cand& cand) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < 2 * kBatch * kSegLanes; e += kSegThreads) {
    const int r = e / kSegLanes, i = e % kSegLanes;
    if (i < nl) S.acc[r][i] = r < kBatch ? (-2147483647 - 1) : 0;
  }
  __syncthreads();
  for (int i = warp; i < nl; i += kSegWarps) {
    Block<CH> blk;
    load_crush_block<CH>(P, S, a, i, lane, blk);
    const int at = S.seg[i];
    for (int c = 0; c < ncand; ++c) {
      int s[3];
      cand(i, c, s);
      int pm, be;
      blk.eval(s, pm, be);
      if (lane == 0) {
        atomicMax(&S.acc[c][at], pm);
        atomicAdd(&S.acc[kBatch + c][at], be >> kSegErrShift);
      }
    }
  }
  __syncthreads();
}

// Block i's region admissibility test.
struct SegAdm {
  int count, max_pix, max_blk, floor_pix, floor_blk;
  bool floors;
  __device__ bool operator()(int pm, int be) const {
    return admissible(pm, be, count, max_pix, max_blk, kSegErrShift, floors, floor_pix, floor_blk);
  }
};

__device__ __forceinline__ SegAdm seg_adm(const SegParams& P, const SegShared& S, int i,
                                          bool floors) {
  return SegAdm{S.st[S_COUNT][i], P.max_pix, P.max_blk, S.st[S_FPIX][i], S.st[S_FBLK][i],
                floors};
}

// Folds candidate c of the last batch into block i's running best.
__device__ __forceinline__ void fold(SegShared& S, int i, int c, const int (&s)[3],
                                     const SegAdm& adm, bool ties_to_later) {
  const int at = S.seg[i];
  int best[3];
  unpack3(S.st[S_BEST][i], best);
  int tot = S.st[S_TOT][i], err = S.st[S_ERR][i];
  take_if_better(adm, s, S.acc[c][at], S.acc[kBatch + c][at], ties_to_later, best, tot, err);
  S.st[S_BEST][i] = pack3(best);
  S.st[S_TOT][i] = tot;
  S.st[S_ERR][i] = err;
}

template <int CH>
__global__ void __launch_bounds__(kSegThreads, 2) segment_encode_kernel(const SegParams P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SegShared& S = *reinterpret_cast<SegShared*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the CTA's blocks: the segments starting in [lo, hi), up to the next start
  const int lo = blockIdx.x * kSegTile, hi = min(lo + kSegTile, P.n);
  if (tid < 2) S.range[tid] = P.n;
  __syncthreads();
  for (int t = tid; t < 2 * kSegCap; t += kSegThreads) {
    const int g = (t < kSegCap ? lo : hi) + t % kSegCap;
    if (g < P.n && P.seg[g] == g) atomicMin(&S.range[t / kSegCap], g);
  }
  __syncthreads();
  const int a = S.range[0];
  const int nl = min(S.range[1] - a, kSegLanes);
  if (nl <= 0) return;  // uniform: no segment starts here
  for (int i = tid; i < nl; i += kSegThreads) {
    const int s = P.seg[a + i] - a;
    S.seg[i] = (s < 0 || s > i) ? i : s;
    S.acc[0][i] = 0;
  }
  __syncthreads();

  // ---- fit: pixel counts and channel sums -> avg
  for (int i = warp; i < nl; i += kSegWarps) {
    Pixels<CH> p;
    load_pixels<CH>(P, (size_t)(a + i), lane, p);
    const int cnt = __reduce_add_sync(kFull, p.mask[0] + p.mask[1]);
    float sums[CH];
    channel_sums<CH>(p, sums);
    if (lane == 0) {
      atomicAdd(&S.acc[0][S.seg[i]], cnt);
#pragma unroll
      for (int c = 0; c < CH; ++c) S.sx[c][i] = sums[c];
    }
  }
  __syncthreads();
  for (int i = tid; i < nl; i += kSegThreads) S.st[S_COUNT][i] = S.acc[0][S.seg[i]];
  tile_scan(S, nl, CH, CH);
  for (int i = tid; i < nl; i += kSegThreads) {
    const float ic = inv_count(S, i);
#pragma unroll
    for (int c = 0; c < CH; ++c) putf(S, S_AVG + c, i, S.sx[c][i] * ic);
  }
  __syncthreads();

  // ---- fit: the three directions
  fit_direction<CH>(P, S, a, nl, 1, S_DIRA);
  fit_direction<CH>(P, S, a, nl, 2, S_DIRB);
  if (CH == 4) fit_direction<CH>(P, S, a, nl, 3, S_DIRC);

  // ---- fit: factor extremes (min as -max(-x))
  for (int i = warp; i < nl; i += kSegWarps) {
    Pixels<CH> p;
    load_pixels<CH>(P, (size_t)(a + i), lane, p);
    FitRegion<CH> r;
    r.load(S, i, CH == 4 ? 3 : 2);
    if (CH == 3) FitSteps<CH>::cross(r.dir_a, r.dir_b, r.dir_c);
    FitSteps<CH> fs;
    fs.center(p, r.avg);
    fs.axis_a(p, r.avg, r.dir_a);
    fs.axis_b(p, r.dir_b);
    float mn[3], mx[3];
    fs.extremes(p, r.dir_c, mn, mx);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        S.sx[k][i] = -mn[k];
        S.sx[3 + k][i] = mx[k];
      }
      if (CH == 3) {
#pragma unroll
        for (int c = 0; c < CH; ++c) putf(S, S_DIRC + c, i, r.dir_c[c]);
      }
    }
  }
  __syncthreads();
  tile_scan(S, nl, 6, 0);
  for (int i = tid; i < nl; i += kSegThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      putf(S, S_MN + k, i, -S.sx[k][i]);
      putf(S, S_MX + k, i, S.sx[3 + k][i]);
    }
  }
  __syncthreads();

  // ---- fit: endpoints, factors (to the scratch plane), endpoint and avg rows
  for (int i = warp; i < nl; i += kSegWarps) {
    const size_t b = (size_t)(a + i);
    Pixels<CH> p;
    load_pixels<CH>(P, b, lane, p);
    FitRegion<CH> r;
    r.load(S, i, 3);
    float mn[3], mx[3];
    getv<3>(S, S_MN, i, mn);
    getv<3>(S, S_MX, i, mx);
    int ep[6][CH], f8[3][2];
    round_endpoints<CH>(S.st[S_COUNT][i], r.avg, r.dir_a, r.dir_b, r.dir_c, mn, mx, ep);
    extract_factors<CH>(p, ep, f8);
#pragma unroll
    for (int j = 0; j < 2; ++j) P.f8[b * kP + lane + 32 * j] = f8[0][j] | (f8[1][j] << 8) | (f8[2][j] << 16);
    drop_axes<CH>(ep, P.num_factors);
    if (lane < CH) {
      // lane c writes channel c of the six endpoint rows and avg
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (c != lane) continue;
#pragma unroll
        for (int e = 0; e < 6; ++e) P.eps[((size_t)e * CH + c) * P.n + b] = ep[e][c];
        P.avg[(size_t)c * P.n + b] = r.avg[c];
      }
    }
  }
  __syncthreads();  // the factor and endpoint rows are read back below

  // ---- crush search (ops/crush.py cores, region values = segment totals)
  for (int i = tid; i < nl; i += kSegThreads) {
    S.st[S_BEST][i] = 0;
    S.st[S_TOT][i] = -1;
    S.st[S_ERR][i] = 2147483647;
    S.st[S_FPIX][i] = S.st[S_FBLK][i] = 0;
  }
  __syncthreads();
  const bool floors = P.crush_mode != kNone && P.num_factors < 3;
  if (floors) {
    eval_batch<CH>(P, S, a, nl, 1, [](int, int, int (&s)[3]) { s[0] = s[1] = s[2] = 0; });
    for (int i = tid; i < nl; i += kSegThreads) {
      S.st[S_FPIX][i] = S.acc[0][S.seg[i]];
      S.st[S_FBLK][i] = S.acc[kBatch][S.seg[i]];
    }
    __syncthreads();
  }

  if (P.crush_mode == kExhaustive) {
    // all 729 triples in ascending lex order; ties to later
    for (int i0 = 0; i0 < 729; i0 += kBatch) {
      const auto triple = [i0](int, int c, int (&s)[3]) {
        s[0] = (i0 + c) / 81;
        s[1] = ((i0 + c) / 9) % 9;
        s[2] = (i0 + c) % 9;
      };
      eval_batch<CH>(P, S, a, nl, kBatch, triple);
      for (int i = tid; i < nl; i += kSegThreads) {
        const SegAdm adm = seg_adm(P, S, i, floors);
        for (int c = 0; c < kBatch; ++c) {
          int s[3];
          triple(i, c, s);
          fold(S, i, c, s, adm, true);
        }
      }
      __syncthreads();
    }
  } else if (P.crush_mode == kGuess) {
    eval_batch<CH>(P, S, a, nl, 4, [](int, int c, int (&s)[3]) { guess_triple(c, s); });
    for (int i = tid; i < nl; i += kSegThreads) {
      const SegAdm adm = seg_adm(P, S, i, floors);
      bool ok[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) ok[t] = adm(S.acc[t][S.seg[i]], S.acc[kBatch + t][S.seg[i]]);
      int best[3] = {0, 0, 0};
      const int pick = guess_pick(ok);
      if (pick >= 0) guess_triple(pick, best);
      S.st[S_BEST][i] = pack3(best);
    }
    __syncthreads();
  } else if (P.crush_mode == kLadder) {
    // 27 per-axis sweeps, one axis per batch -> the ladder box
    for (int ax = 0; ax < 3; ++ax) {
      eval_batch<CH>(P, S, a, nl, kBatch, [ax](int, int c, int (&s)[3]) {
        s[0] = s[1] = s[2] = 0;
        s[ax] = c;
      });
      for (int i = tid; i < nl; i += kSegThreads) {
        const SegAdm adm = seg_adm(P, S, i, floors);
        int pm_ax[9], be_ax[9];
#pragma unroll
        for (int s = 0; s < 9; ++s) {
          pm_ax[s] = S.acc[s][S.seg[i]];
          be_ax[s] = S.acc[kBatch + s][S.seg[i]];
        }
        LadderBox box;
        ladder_axis(box, ax, pm_ax, be_ax, adm);
        S.st[S_BASE + ax][i] = box.base[ax];
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          S.st[S_DBLK + 4 * ax + o][i] = box.d_blk[ax][o];
          S.st[S_DPIX + 4 * ax + o][i] = box.d_pix[ax][o];
        }
        if (ax == 0) {
          S.st[S_ERR0][i] = box.err0;
          S.st[S_PIX0][i] = box.pix0;
        }
      }
      __syncthreads();
    }
    // lattice keys and the K best candidates of each block
    for (int i = warp; i < nl; i += kSegWarps) {
      LadderBox box;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        box.base[ax] = S.st[S_BASE + ax][i];
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          box.d_blk[ax][o] = S.st[S_DBLK + 4 * ax + o][i];
          box.d_pix[ax][o] = S.st[S_DPIX + 4 * ax + o][i];
        }
      }
      box.err0 = S.st[S_ERR0][i];
      box.pix0 = S.st[S_PIX0][i];
      const SegAdm adm = seg_adm(P, S, i, floors);
      int key[2];
      ladder_keys(box, adm, lane, key);
      __syncwarp();  // every lane has read the box rows the candidates reuse
      for (int r = 0; r < P.ladder_k; ++r) {
        int s[3];
        ladder_peel(key, box, lane, s);
        if (lane == 0) S.st[S_CAND + r][i] = pack3(s);
      }
    }
    __syncthreads();
    // exact verification, best-ranked first
    for (int r0 = 0; r0 < P.ladder_k; r0 += kBatch) {
      const int nc = min(kBatch, P.ladder_k - r0);
      const auto cand = [&S, r0](int i, int c, int (&s)[3]) { unpack3(S.st[S_CAND + r0 + c][i], s); };
      eval_batch<CH>(P, S, a, nl, nc, cand);
      for (int i = tid; i < nl; i += kSegThreads) {
        const SegAdm adm = seg_adm(P, S, i, floors);
        for (int c = 0; c < nc; ++c) {
          int s[3];
          cand(i, c, s);
          fold(S, i, c, s, adm, false);
        }
      }
      __syncthreads();
    }
  }

  // ---- dither, decode and the outputs
  for (int i = warp; i < nl; i += kSegWarps) {
    const size_t b = (size_t)(a + i);
    Block<CH> blk;
    load_crush_block<CH>(P, S, a, i, lane, blk);
    int best[3];
    unpack3(S.st[S_BEST][i], best);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k >= P.num_factors) best[k] = max(best[k], 8);  // statically dropped axes
    int q[3][2], dec[CH][2];
    float err_f[2];
    dither_decode<CH>(blk, best, P.dither != 0, P.key, (uint32_t)P.blocks[b], lane, q, dec, err_f);
    const float dist = tree_sum(err_f[0], err_f[1]);
    const int cnt = __reduce_add_sync(kFull, blk.mask[0] + blk.mask[1]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const size_t at = b * kP + lane + 32 * j;
      if (P.q != nullptr) P.q[at] = q[0][j] | (q[1][j] << 8) | (q[2][j] << 16);
      P.dec[at] = pack_decoded<CH>(dec, j);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) P.shifts[(size_t)k * P.n + b] = best[k];
      P.dist_blk[b] = dist;
      P.count_blk[b] = cnt;
      P.count_mem[b] = blk.count;
    }
  }
}

template <int CH>
int launch_segment_encode(const SegParams& P, cudaStream_t st) {
  const size_t smem = sizeof(SegShared);
  cudaError_t err = cudaFuncSetAttribute(segment_encode_kernel<CH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (P.n + kSegTile - 1) / kSegTile;
  segment_encode_kernel<CH><<<grid, kSegThreads, smem, st>>>(P);
  return (int)cudaGetLastError();
}

template <class T>
int launch_seg_scan(const T* x, const int32_t* seg, int rows, int n, int n_sum, T init_max,
                    int steps, T* out, cudaStream_t st) {
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  if (steps < 0 || steps > 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kScanTile - 1) / kScanTile), (unsigned)rows);
  seg_scan_kernel<T><<<grid, kScanThreads, 0, st>>>(x, seg, n, n_sum, init_max, steps, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The 27-probe match of n pairs of (7 * channels, n) float32 row stacks a
// (candidate) and b (reference) on `stream`; out (n,) bool.
int limg_match_pairs(const float* a, const float* b, int n, int channels, bool* out,
                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((n + kMatchWarps - 1) / kMatchWarps)), block(kMatchWarps * 32);
  if (channels == 4) {
    match_pairs_kernel<4><<<grid, block, 0, st>>>(a, b, n, out);
  } else if (channels == 3) {
    match_pairs_kernel<3><<<grid, block, 0, st>>>(a, b, n, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Right and down neighbour matches on the (7 * channels, by, bx) float32 row
// plane on `stream`; right / down (by, bx) bool, False on the last column /
// row.
int limg_match_neighbors(const float* rows, int by, int bx, int channels, bool* right,
                         bool* down, void* stream) {
  if (by <= 0 || bx <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = by * bx;
  const dim3 grid((unsigned)((nb + kMatchWarps - 1) / kMatchWarps)), block(kMatchWarps * 32);
  if (channels == 4) {
    match_neighbors_kernel<4><<<grid, block, 0, st>>>(rows, by, bx, right, down);
  } else if (channels == 3) {
    match_neighbors_kernel<3><<<grid, block, 0, st>>>(rows, by, bx, right, down);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The doubling-scan chain over (rows, n) int32 / float32 rows x with segment
// ids seg (n,): rows [0, n_sum) summed, the rest maxed, `steps` doubling
// steps (ops/segments.py scan_steps); out (rows, n).
int limg_seg_scan_i32(const int32_t* x, const int32_t* seg, int rows, int n, int n_sum,
                      int init_max, int steps, int32_t* out, void* stream) {
  return launch_seg_scan<int>(x, seg, rows, n, n_sum, init_max, steps, out, (cudaStream_t)stream);
}

int limg_seg_scan_f32(const float* x, const int32_t* seg, int rows, int n, int n_sum,
                      float init_max, int steps, float* out, void* stream) {
  return launch_seg_scan<float>(x, seg, rows, n, n_sum, init_max, steps, out,
                                (cudaStream_t)stream);
}

// Re-encode of the n lanes of a run buffer on `stream`: packed / mask
// block-major (n, 64) words and 0/1 bytes, seg (n,) segment ids (first
// member's position, members contiguous, at most 256 of them), blocks (n,)
// image block indices. f8 is (n, 64) scratch. Outputs: shifts (3, n), q
// (nullable) and dec block-major (n, 64), dist_blk, count_blk, count_mem
// (n,), eps (6, channels, n), avg (channels, n).
int limg_segment_encode(const int32_t* packed, const uint8_t* mask, const int32_t* seg,
                        const int32_t* blocks, int n, int channels, int crush_mode, int dither,
                        int ladder_k, int num_factors, int max_pix, int max_blk, uint32_t key,
                        int32_t* f8, int32_t* shifts, int32_t* q, int32_t* dec, float* dist_blk,
                        int32_t* count_blk, int32_t* count_mem, int32_t* eps, float* avg,
                        void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (crush_mode == kLadder && (ladder_k < 1 || ladder_k > kMaxK)) return (int)cudaErrorInvalidValue;
  const SegParams P{packed, mask, seg, blocks, n, crush_mode, dither, ladder_k, num_factors,
                    max_pix, max_blk, key, f8, shifts, q, dec, dist_blk, count_blk, count_mem,
                    eps, avg};
  cudaStream_t st = (cudaStream_t)stream;
  if (channels == 4) return launch_segment_encode<4>(P, st);
  if (channels == 3) return launch_segment_encode<3>(P, st);
  return (int)cudaErrorInvalidValue;
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
