// Run building and run coalescing for NVIDIA Hopper (sm_90a): four kernels.
//
// - match_pairs replaces limg_tpu/pallas_kernels/encode_merged.py:
//   match_pairs_pallas (:516, kernel :488): the 27-probe merge test on paired
//   (7ch, N) float32 row stacks. One thread per pair, as match_neighbors:
//   a warp's threads read 32 consecutive pairs' rows, and a thread folds
//   its 27 probes in order (limg_common.cuh match_rows<CH, 1>, the
//   predicate fit_levels uses too), skipping them where the match bit does
//   not depend on them.
// - match_neighbors replaces match_neighbors_pallas (:587, kernel :537): the
//   same test of each block against its right and its down neighbour on the
//   (7ch, by, bx) row plane. One thread per block, as the TPU kernel has one
//   lane per block: a warp's threads read 32 consecutive blocks' rows, and
//   their neighbours' by address (no halo tiles: those exist for the TPU's
//   (8, 128) tiling).
// - seg_scan replaces limg_tpu/pallas_kernels/seg_scan.py:
//   seg_mixed_all_pallas (:140, kernel :41): the doubling-scan chain of
//   ops/segments.py, for a batch of independent problems (each its own
//   lanes, segment map, and int32 or float32 rows of sum, max or min) in
//   one launch. A CTA takes one row over a 1,536-lane tile of one problem
//   in a window with SEG_CAP lanes of halo on each side (a lane's result
//   depends on lanes within SEG_CAP - 1 of it); steps d < 32 are warp
//   shuffles, d = 32, 64, 128 shared-memory steps with one barrier each.
// - segment_encode replaces limg_tpu/pallas_kernels/encode_segments.py:
//   segment_encode_pallas (:188, kernel :114): refit, factors, crush search,
//   dither and decode of the contiguous segments of the run buffer.
//
// What bounds them on the H100: the match kernels are ~40 float operations
// per probe and pair, over 2 x 129,600 neighbour pairs at level 0 of a 4K
// image (operations, a few us). A scan reads its data once and does ~50
// operations a lane: its bound is bytes, under a microsecond at 4K, and a
// launch's own cost (a few microseconds) is what it pays; so run building
// issues one launch per stage for all quadtree levels, and a column scan
// reads its (gy, gx) map in place, with no transposed copy. segment_encode's
// bound and design: csrc/segment_encode.cuh (one template; this file
// instantiates it at P = 64, segment_region.cu at P = 256 / 1024 / 4096).

#include "segment_encode.cuh"

namespace {

// ---------------------------------------------------------------------------
// match_pairs / match_neighbors
// ---------------------------------------------------------------------------

// One thread a block (match_neighbors) or a pair (match_pairs): the threads
// of a warp take consecutive columns of the (7ch, ...) rows, so each of their
// row loads is one coalesced read, and each folds its 27 probes in order.
constexpr int kMatchThreads = 128;

template <int CH>
__global__ void __launch_bounds__(kMatchThreads)
match_pairs_kernel(const float* __restrict__ a, const float* __restrict__ b, int n,
                   bool* __restrict__ out) {
  const int g = blockIdx.x * kMatchThreads + threadIdx.x;
  if (g >= n) return;
  float avg_a[CH], avg_b[CH];
  int ep_a[6][CH], ep_b[6][CH];
  load_decomp<CH>(a, n, g, avg_a, ep_a);
  load_decomp<CH>(b, n, g, avg_b, ep_b);
  bool m;
  match_rows<CH, 1>(avg_a, ep_a, avg_b, ep_b, 0, m);
  out[g] = m;
}

template <int CH>
__global__ void __launch_bounds__(kMatchThreads)
match_neighbors_kernel(const float* __restrict__ rows, int by, int bx, bool* __restrict__ right,
                       bool* __restrict__ down) {
  const int nb = by * bx;
  const int g = blockIdx.x * kMatchThreads + threadIdx.x;
  if (g >= nb) return;
  const int y = g / bx, x = g - y * bx;
  float avg_b[CH], avg_a[CH];
  int ep_b[6][CH], ep_a[6][CH];
  load_decomp<CH>(rows, nb, g, avg_b, ep_b);
  bool m_right = false, m_down = false;
  if (x + 1 < bx) {  // a = the +1 neighbour, b = the block itself
    load_decomp<CH>(rows, nb, g + 1, avg_a, ep_a);
    match_rows<CH, 1>(avg_a, ep_a, avg_b, ep_b, 0, m_right);
  }
  if (y + 1 < by) {
    load_decomp<CH>(rows, nb, g + bx, avg_a, ep_a);
    match_rows<CH, 1>(avg_a, ep_a, avg_b, ep_b, 0, m_down);
  }
  right[g] = m_right;
  down[g] = m_down;
}

// ---------------------------------------------------------------------------
// seg_scan
// ---------------------------------------------------------------------------

// A batch of independent scan problems, each with its own lanes, segment
// map and rows; one launch for the whole batch (ScanBatch is the kernel's
// argument: no host-to-device copy).
constexpr int kScanMaxProblems = 16;
constexpr int kScanMaxRows = 4;
enum : int { kScanSum = 0, kScanMax = 1, kScanMin = 2 };

struct ScanRow {
  const void* x;  // the row's n values (int32 or float32); null: a row of ones (int32)
  void* out;      // its n results
  int op;         // kScanSum, kScanMax or kScanMin (-max(-x))
  int fill;       // bits of the value of lanes outside the problem, as scanned
                  // (0 for a sum, init_max for a max, -init for a min)
};

struct ScanProblem {
  const int32_t* seg;  // segment ids
  int n;               // lanes
  int gy;              // 0: lane i at element i; > 0: the columns of a (gy, n / gy)
                       // row-major map, lane i at (i % gy, i / gy)
  int steps;           // doubling steps (ops/segments.py scan_steps(n)), at most 8
  int is_float;
  int n_rows;
  ScanRow rows[kScanMaxRows];
};

struct ScanBatch {
  ScanProblem p[kScanMaxProblems];
  int cta0[kScanMaxProblems + 1];  // each problem's first CTA; the last entry is the grid
  int n_problems;
};

// Each CTA scans one row over one tile of one problem: a window of
// kScanWarps * CHUNKS * 32 lanes, 32-lane chunks, warp w holding chunks
// [w CHUNKS, (w + 1) CHUNKS) lane by lane (thread l: lane l of each chunk),
// plus one chunk on each side in registers. A lane's result depends on
// lanes within SEG_CAP - 1 of it, so the window's first and last SEG_CAP
// lanes are halo and its centre is the tile. A problem's rows are separate
// CTAs, so they run side by side.
constexpr int kScanWarps = 16;
constexpr int kScanThreads = kScanWarps * 32;

template <int CHUNKS>
struct ScanGeom {
  static constexpr int kRegs = CHUNKS + 2;               // register chunks r = c + 1
  static constexpr int kWindow = kScanWarps * CHUNKS * 32;
  static constexpr int kTile = kWindow - 2 * kSegCap;
};

__device__ __forceinline__ int seg_add(int a, int b) { return add_wrap(a, b); }
__device__ __forceinline__ float seg_add(float a, float b) { return a + b; }
__device__ __forceinline__ int seg_max(int a, int b) { return max(a, b); }
__device__ __forceinline__ float seg_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int seg_neg(int a) { return (int)(0u - (uint32_t)a); }
__device__ __forceinline__ float seg_neg(float a) { return -a; }
__device__ __forceinline__ int sum_finish(int f, int b, int x) {
  return (int)((uint32_t)f + (uint32_t)b - (uint32_t)x);
}
__device__ __forceinline__ float sum_finish(float f, float b, float x) { return (f + b) - x; }
__device__ __forceinline__ uint32_t to_word(int v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t to_word(float v) { return __float_as_uint(v); }
__device__ __forceinline__ int from_word(uint32_t w, int) { return (int)w; }
__device__ __forceinline__ float from_word(uint32_t w, float) { return __uint_as_float(w); }

template <class T, bool SUM>
__device__ __forceinline__ T scan_op(T a, T b) {
  if constexpr (SUM) return seg_add(a, b);
  else return seg_max(a, b);
}

// One CTA's row and tile, in registers: the kernel reads the problem's
// fields from its argument once (a field read through a reference into the
// argument is a generic load that every store would force again).
struct ScanTile {
  const int32_t* seg;
  const void* x;  // null: ones
  void* out;
  int n, gy, gx, steps, fill;
  bool neg;
  int lo;  // the problem lane of window lane 0
};

// Element of problem lane g (0 <= g < n).
__device__ __forceinline__ size_t scan_addr(const ScanTile& t, int g) {
  if (t.gy == 0) return (size_t)g;
  return (size_t)(g % t.gy) * (size_t)t.gx + (size_t)(g / t.gy);
}

// Shared memory: two sets (double-buffered steps) of forward and backward
// values, as 32-bit words; before the first step, set 1 holds the ids of
// the window and of one chunk beyond each side (its first write comes
// after a barrier that every guard read precedes).
template <int CHUNKS>
struct ScanShared {
  uint32_t v[2][2][ScanGeom<CHUNKS>::kWindow];  // [set][forward, backward][window lane]
};

// The tile's row: the plain version's Hillis-Steele steps d = 1, 2, 4, ...
// (fwd[i] op fwd[i - d] where seg[i - d] == seg[i], bwd likewise with i +
// d), in its order for floats. Steps d < 32 are register steps: one
// rotating shuffle per chunk, a partner across the chunk boundary coming
// from the same thread's neighbouring chunk; d = 32, 64, 128 go through
// shared memory, one barrier each. The guard bits (gf / gb, bit k for step
// 2^k) are id compares against the ids in shared memory, all steps at once
// with no branch, so that every load is in flight together.
template <int CHUNKS, class T, bool SUM>
__device__ __forceinline__ void scan_row(const ScanTile& t, ScanShared<CHUNKS>& S) {
  using G = ScanGeom<CHUNKS>;
  constexpr int kR = G::kRegs;
  const int lane = threadIdx.x & 31;
  const int base = (threadIdx.x >> 5) * CHUNKS * 32 + lane - 32;  // window lane of r = 0
  const T fill = from_word((uint32_t)t.fill, T());
  const T* xr = static_cast<const T*>(t.x);
  // ids and values, loaded together; lanes outside the problem carry the
  // plain version's shifted-in ids (-1 left, -2 right) and fills
  int id[kR];
  T v[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int g = t.lo + base + 32 * r;
    const bool in = g >= 0 && g < t.n;
    const size_t at = in ? scan_addr(t, g) : 0;
    id[r] = in ? t.seg[at] : (g < 0 ? -1 : -2);
    T x = fill;
    if (in) {
      x = xr == nullptr ? T(1) : xr[at];
      if (t.neg) x = seg_neg(x);
    }
    v[r] = x;
  }
  uint32_t* sid = &S.v[1][0][32];  // window lane j at sid[j], j in [-32, kWindow + 32)
#pragma unroll
  for (int r = 0; r < kR; ++r) sid[base + 32 * r] = (uint32_t)id[r];
  __syncthreads();
  const uint32_t steps_mask = (1u << t.steps) - 1u;
  uint32_t gf[kR], gb[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int j = base + 32 * r;
    gf[r] = gb[r] = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int d = 1 << k;
      // register steps reach only this warp's chunks; shared steps only
      // the window: lanes beyond are halo that no centre lane needs
      const bool has_f = d < 32 ? (r > 0 || lane >= d) : (r > 0 && r <= CHUNKS && j - d >= 0);
      const bool has_b = d < 32 ? (r + 1 < kR || lane + d < 32)
                                : (r > 0 && r <= CHUNKS && j + d < G::kWindow);
      const int idf = (int)sid[has_f ? j - d : j], idb = (int)sid[has_b ? j + d : j];
      gf[r] |= (uint32_t)(has_f && idf == id[r]) << k;
      gb[r] |= (uint32_t)(has_b && idb == id[r]) << k;
    }
    gf[r] &= steps_mask;
    gb[r] &= steps_mask;
  }
  T w[kR], x0[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) w[r] = x0[r] = v[r];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k >= t.steps) break;
    const int d = 1 << k;
    T uf[kR], ub[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      uf[r] = __shfl_sync(kFull, v[r], (lane - d) & 31);
      ub[r] = __shfl_sync(kFull, w[r], (lane + d) & 31);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if ((gf[r] >> k) & 1u) v[r] = scan_op<T, SUM>(v[r], lane >= d ? uf[r] : uf[r > 0 ? r - 1 : 0]);
      if ((gb[r] >> k) & 1u)
        w[r] = scan_op<T, SUM>(w[r], lane + d < 32 ? ub[r] : ub[r + 1 < kR ? r + 1 : r]);
    }
  }
  if (t.steps > 5) {
    int cur = 0;
#pragma unroll
    for (int r = 1; r <= CHUNKS; ++r) {
      const int j = base + 32 * r;
      S.v[cur][0][j] = to_word(v[r]);
      S.v[cur][1][j] = to_word(w[r]);
    }
#pragma unroll
    for (int k = 5; k < 8; ++k) {
      if (k >= t.steps) break;
      __syncthreads();
      const int d = 1 << k;
#pragma unroll
      for (int r = 1; r <= CHUNKS; ++r) {
        const int j = base + 32 * r;
        if ((gf[r] >> k) & 1u) v[r] = scan_op<T, SUM>(v[r], from_word(S.v[cur][0][j - d], T()));
        if ((gb[r] >> k) & 1u) w[r] = scan_op<T, SUM>(w[r], from_word(S.v[cur][1][j + d], T()));
      }
      if (k + 1 < t.steps) {
        cur ^= 1;
#pragma unroll
        for (int r = 1; r <= CHUNKS; ++r) {
          const int j = base + 32 * r;
          S.v[cur][0][j] = to_word(v[r]);
          S.v[cur][1][j] = to_word(w[r]);
        }
      }
    }
  }
  T* out = static_cast<T*>(t.out);
#pragma unroll
  for (int r = 1; r <= CHUNKS; ++r) {
    const int j = base + 32 * r, g = t.lo + j;
    if (j < kSegCap || j >= kSegCap + G::kTile || g >= t.n) continue;
    T y;
    if constexpr (SUM) y = sum_finish(v[r], w[r], x0[r]);
    else y = seg_max(v[r], w[r]);
    out[scan_addr(t, g)] = t.neg ? seg_neg(y) : y;
  }
}

template <int CHUNKS>
__global__ void __launch_bounds__(kScanThreads)
seg_scan_kernel(const __grid_constant__ ScanBatch B) {
  using G = ScanGeom<CHUNKS>;
  __shared__ ScanShared<CHUNKS> S;
  int k = 0;
  while (k + 1 < B.n_problems && B.cta0[k + 1] <= (int)blockIdx.x) ++k;
  const int n_rows = B.p[k].n_rows, local = (int)blockIdx.x - B.cta0[k];
  const int row = local % n_rows;
  ScanTile t;
  t.seg = B.p[k].seg;
  t.x = B.p[k].rows[row].x;
  t.out = B.p[k].rows[row].out;
  t.n = B.p[k].n;
  t.gy = B.p[k].gy;
  t.gx = t.gy > 0 ? t.n / t.gy : 0;
  t.steps = B.p[k].steps;
  t.fill = B.p[k].rows[row].fill;
  t.lo = (local / n_rows) * G::kTile - kSegCap;
  const int op = B.p[k].rows[row].op;
  t.neg = op == kScanMin;
  if (B.p[k].is_float) {
    if (op == kScanSum) scan_row<CHUNKS, float, true>(t, S);
    else scan_row<CHUNKS, float, false>(t, S);
  } else {
    if (op == kScanSum) scan_row<CHUNKS, int, true>(t, S);
    else scan_row<CHUNKS, int, false>(t, S);
  }
}

// 16 warps of 4 chunks: 2,048-lane windows around 1,536-lane tiles. Of the
// geometries measured on the H100 (PERF.md), this scanned a 4K step's
// rows fastest: 8 warps of 10 chunks (the TPU kernel's 2,048-lane tile), of
// 8 or of 6 took 2.0x, 1.4x and 1.2x its time.
constexpr int kScanChunks = 4;

}  // namespace

extern "C" {

// The 27-probe match of n pairs of (7 * channels, n) float32 row stacks a
// (candidate) and b (reference) on `stream`; out (n,) bool.
int limg_match_pairs(const float* a, const float* b, int n, int channels, bool* out,
                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((n + kMatchThreads - 1) / kMatchThreads)), block(kMatchThreads);
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
  const dim3 grid((unsigned)((nb + kMatchThreads - 1) / kMatchThreads)),
      block(kMatchThreads);
  if (channels == 4) {
    match_neighbors_kernel<4><<<grid, block, 0, st>>>(rows, by, bx, right, down);
  } else if (channels == 3) {
    match_neighbors_kernel<3><<<grid, block, 0, st>>>(rows, by, bx, right, down);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The doubling-scan chains of n_problems independent problems (at most
// kScanMaxProblems, each of at most kScanMaxRows rows of one type) in one
// launch on `stream`; see ScanProblem.
int limg_seg_scan(const void* problem_array, int n_problems, void* stream) {
  if (n_problems < 0 || n_problems > kScanMaxProblems) return (int)cudaErrorInvalidValue;
  const ScanProblem* problems = static_cast<const ScanProblem*>(problem_array);
  constexpr int kTile = ScanGeom<kScanChunks>::kTile;
  ScanBatch B{};
  int ctas = 0;
  for (int k = 0; k < n_problems; ++k) {
    const ScanProblem& P = problems[k];
    if (P.n <= 0 || P.steps < 0 || P.steps > 8 || P.n_rows < 1 || P.n_rows > kScanMaxRows ||
        P.gy < 0 || (P.gy > 0 && P.n % P.gy != 0))
      return (int)cudaErrorInvalidValue;
    B.p[k] = P;
    B.cta0[k] = ctas;
    ctas += (P.n + kTile - 1) / kTile * P.n_rows;
  }
  B.cta0[n_problems] = ctas;
  B.n_problems = n_problems;
  if (ctas == 0) return (int)cudaSuccess;
  seg_scan_kernel<kScanChunks><<<ctas, kScanThreads, 0, (cudaStream_t)stream>>>(B);
  return (int)cudaGetLastError();
}

// Re-encode of the n lanes of a run buffer of 8x8 blocks (pixels = 64) on
// `stream`: packed / mask block-major (n, 64) words and 0/1 bytes, seg (n,)
// segment ids (first member's position, members contiguous, at most 256 of
// them), blocks (n,) the blocks' indices in their grid. f8 is (n, 64)
// scratch. Outputs: shifts (3, n), q (nullable) and dec block-major (n, 64),
// dist_blk, count_blk, count_mem (n,), eps (6, channels, n), avg
// (channels, n). segment_region.cu's limg_segment_encode_region takes the
// same arguments for regions of 256, 1024 and 4096 pixels.
int limg_segment_encode(const int32_t* packed, const uint8_t* mask, const int32_t* seg,
                        const int32_t* blocks, int n, int pixels, int channels, int crush_mode,
                        int dither, int ladder_k, int num_factors, int max_pix, int max_blk,
                        uint32_t key, int32_t* f8, int32_t* shifts, int32_t* q, int32_t* dec,
                        float* dist_blk, int32_t* count_blk, int32_t* count_mem, int32_t* eps,
                        float* avg, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (pixels != kP || (crush_mode == kLadder && (ladder_k < 1 || ladder_k > kMaxK)))
    return (int)cudaErrorInvalidValue;
  const SegParams P{packed, mask, seg, blocks, n, crush_mode, dither, ladder_k, num_factors,
                    max_pix, max_blk, key, f8, shifts, q, dec, dist_blk, count_blk, count_mem,
                    eps, avg};
  cudaStream_t st = (cudaStream_t)stream;
  if (channels == 4) return launch_segment_encode<4, 0>(P, st);
  if (channels == 3) return launch_segment_encode<3, 0>(P, st);
  return (int)cudaErrorInvalidValue;
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
