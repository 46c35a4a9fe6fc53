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
// reads its (gy, gx) map in place, with no transposed copy. The segment encode
// does the work of the fixed-grid kernel per member block (a fit and 35+
// exact candidate decodes at ladder K = 8), so its bound is operations
// (chip_smoke.py kernel_bound); it runs far from it, compute- and
// barrier-bound: a segment reduction after every fit step and candidate
// batch.
//
// segment_encode's design: segment ids are the first member's position,
// members are contiguous and a segment has at most SEG_CAP of them. CTA k
// takes the whole segments that start in lanes [128k, 128k + 128), at most
// 383 lanes, so every reduction stays inside the CTA. It first counts each
// segment's member pixels: the lanes of a segment with none (the buffer's
// tail of non-run lanes, 27% of the lanes at 4K) get the plain version's
// outputs for an empty region at once (write_empty), and every later loop
// walks only the other lanes (S.act); a CTA of such lanes alone stops
// there. A warp works on one block at a time (its 64 pixels in registers,
// as in encode_fixed) and loops over the CTA's active blocks; between the
// steps of the fit and between candidate batches the blocks' partial values
// meet in shared memory:
// - float sums (counts, channel sums, unit-vector sums) and the factor
//   extremes go through the doubling scan of ops/segments.py in the plain
//   version's order, fwd + bwd - x, which is not the exact segment sum and
//   can differ between members: between two CTA barriers each warp scans
//   whole segments (scan_segments), a segment of up to 32 members by
//   shuffles (at 4K all but ~70 of ~37,000), a longer one over shared
//   memory with the warp's own barriers;
// - the crush's integer pixel maxima and error sums are order-free, so they
//   are per-segment shared-memory atomics;
// - the fit's per-pixel steps are repeated from the image in each phase
//   (limg_common.cuh FitSteps), its factors go to a scratch plane for the
//   crush, and per-block state (region values, ladder boxes, candidates,
//   the running best) lives in shared memory, one column per block.
// One warp per segment, with no CTA barrier after the counts, computed the
// same bits but took 3x the time at 4K (PERF.md).

#include "limg_common.cuh"

namespace {

using namespace limg;

constexpr int kSegCap = 256;       // ops/segments.py SEG_CAP
constexpr int kSegErrShift = 8;    // ops/segments.py SEG_ERR_SHIFT

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
  int len[kSegLanes];  // at a segment start: its lane count
  int act[kSegLanes];  // the lanes whose segment holds a member pixel
  int n_act;
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

// The doubling scan of ops/segments.py over the CTA's segments that hold a
// member pixel: rows [0, NROWS) of sx, sums on rows [0, NSUM), max on the
// rest, results back in sx. Each warp scans the segments that start in
// every 8th 32-lane chunk, alone: a step's partner outside the segment is
// skipped, as the plain version's segment-id guard skips it, so a segment
// of up to 32 members takes shuffles (the steps from 32 on have no
// partner) and a longer one the rows sf / sb between the warp's barriers.
// Exact: the plain version's fwd + bwd - x and max(fwd, bwd) in its order.
// Called between CTA barriers (the partial values are in sx).
template <int NROWS, int NSUM>
__device__ void scan_segments(SegShared& S, int nl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int chunk = warp; chunk * 32 < nl; chunk += kSegWarps) {
    const int c = chunk * 32 + lane;
    unsigned starts = __ballot_sync(kFull, c < nl && S.seg[c] == c && S.st[S_COUNT][c] > 0);
    while (starts) {
      const int s = chunk * 32 + __ffs(starts) - 1, n = S.len[s];
      starts &= starts - 1;
#pragma unroll
      for (int r = 0; r < NROWS; ++r) {
        const bool sum = r < NSUM;
        if (n <= 32) {
          const float x = lane < n ? S.sx[r][s + lane] : 0.0f;
          float f = x, b = x;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const float pf = __shfl_up_sync(kFull, f, d), pb = __shfl_down_sync(kFull, b, d);
            if (lane >= d) f = sum ? f + pf : fmaxf(f, pf);
            if (lane + d < n) b = sum ? b + pb : fmaxf(b, pb);
          }
          if (lane < n) S.sx[r][s + lane] = sum ? (f + b) - x : fmaxf(f, b);
        } else {
          constexpr int kPer = kSegCap / 32;
          float* sf = S.sf[r] + s;
          float* sb = S.sb[r] + s;
          for (int j = lane; j < n; j += 32) sf[j] = sb[j] = S.sx[r][s + j];
          __syncwarp();
          for (int d = 1; d < n; d <<= 1) {
            float nf[kPer], nbk[kPer];
#pragma unroll
            for (int e = 0; e < kPer; ++e) {
              const int j = lane + 32 * e;
              if (j < n) {
                nf[e] = j >= d ? (sum ? sf[j] + sf[j - d] : fmaxf(sf[j], sf[j - d])) : sf[j];
                nbk[e] = j + d < n ? (sum ? sb[j] + sb[j + d] : fmaxf(sb[j], sb[j + d])) : sb[j];
              }
            }
            __syncwarp();
#pragma unroll
            for (int e = 0; e < kPer; ++e) {
              const int j = lane + 32 * e;
              if (j < n) {
                sf[j] = nf[e];
                sb[j] = nbk[e];
              }
            }
            __syncwarp();
          }
          for (int j = lane; j < n; j += 32) {
            const float x = S.sx[r][s + j];
            S.sx[r][s + j] = sum ? (sf[j] + sb[j]) - x : fmaxf(sf[j], sb[j]);
          }
          __syncwarp();
        }
      }
    }
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
  for (int ai = warp; ai < S.n_act; ai += kSegWarps) {
    const int i = S.act[ai];
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
  scan_segments<CH, CH>(S, nl);
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
  for (int ai = warp; ai < S.n_act; ai += kSegWarps) {
    const int i = S.act[ai];
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

// Block b of a segment with no member pixel: the plain version's outputs
// for an empty region (zero fit and factors, the search's (0, 0, 0) and the
// forced drops, a dither that leaves zero factors zero, a zero decode),
// written without the work (tests/test_torch_kernel_orders.py holds the
// plain version to them).
template <int CH>
__device__ void write_empty(const SegParams& P, size_t b, int lane) {
  const int zero[CH][2] = {};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t at = b * kP + lane + 32 * j;
    if (P.q != nullptr) P.q[at] = 0;
    P.dec[at] = pack_decoded<CH>(zero, 0);
  }
  if (lane < 3) P.shifts[(size_t)lane * P.n + b] = lane >= P.num_factors ? 8 : 0;
  if (lane < 6 * CH) P.eps[(size_t)lane * P.n + b] = 0;
  if (lane < CH) P.avg[(size_t)lane * P.n + b] = 0.0f;
  if (lane == 0) {
    P.dist_blk[b] = 0.0f;
    P.count_blk[b] = 0;
    P.count_mem[b] = 0;
  }
}

template <int CH>
__global__ void __launch_bounds__(kSegThreads, 2) segment_encode_kernel(const SegParams P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SegShared& S = *reinterpret_cast<SegShared*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the CTA's blocks: the segments starting in [lo, hi), up to the next start
  const int lo = blockIdx.x * kSegTile, hi = min(lo + kSegTile, P.n);
  if (tid < 2) S.range[tid] = P.n;
  if (tid == 2) S.n_act = 0;
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

  // ---- segment pixel counts; the lanes of segments with no member pixel
  // (the buffer's tail of non-run lanes) take the short path, the others go
  // on the active list that every per-block loop below walks
  for (int i = warp; i < nl; i += kSegWarps) {
    const size_t at = (size_t)(a + i) * kP + lane;
    const int cnt = __reduce_add_sync(kFull, (P.mask[at] != 0 ? 1 : 0) + (P.mask[at + 32] != 0 ? 1 : 0));
    if (lane == 0 && cnt > 0) atomicAdd(&S.acc[0][S.seg[i]], cnt);
  }
  __syncthreads();
  for (int i = tid; i < nl; i += kSegThreads) {
    S.st[S_COUNT][i] = S.acc[0][S.seg[i]];
    if (S.st[S_COUNT][i] > 0) S.act[atomicAdd(&S.n_act, 1)] = i;
    if (i == nl - 1 || S.seg[i + 1] != S.seg[i]) S.len[S.seg[i]] = i - S.seg[i] + 1;
  }
  __syncthreads();
  const int na = S.n_act;
  for (int i = warp; i < nl; i += kSegWarps)
    if (S.st[S_COUNT][i] == 0) write_empty<CH>(P, (size_t)(a + i), lane);
  if (na == 0) return;  // uniform: no member pixel in the CTA

  // ---- fit: channel sums -> avg
  for (int ai = warp; ai < na; ai += kSegWarps) {
    const int i = S.act[ai];
    Pixels<CH> p;
    load_pixels<CH>(P, (size_t)(a + i), lane, p);
    float sums[CH];
    channel_sums<CH>(p, sums);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < CH; ++c) S.sx[c][i] = sums[c];
    }
  }
  __syncthreads();
  scan_segments<CH, CH>(S, nl);
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
  for (int ai = warp; ai < na; ai += kSegWarps) {
    const int i = S.act[ai];
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
  scan_segments<6, 0>(S, nl);
  for (int i = tid; i < nl; i += kSegThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      putf(S, S_MN + k, i, -S.sx[k][i]);
      putf(S, S_MX + k, i, S.sx[3 + k][i]);
    }
  }
  __syncthreads();

  // ---- fit: endpoints, factors (to the scratch plane), endpoint and avg rows
  for (int ai = warp; ai < na; ai += kSegWarps) {
    const int i = S.act[ai];
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
    for (int ai = warp; ai < na; ai += kSegWarps) {
      const int i = S.act[ai];
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
  for (int ai = warp; ai < na; ai += kSegWarps) {
    const int i = S.act[ai];
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
