// segment_encode for NVIDIA Hopper (sm_90a): the template of the run
// buffer's re-encode, one warp a lane, instantiated by coalesce.cu at P = 64
// (8x8 blocks, the fused paths' level-0 buffer) and by segment_region.cu at
// P = 256 (16x16 px regions, the dense path's level 1); from P = 1024 on
// segment_region.cu runs the cluster design of segment_cluster.cuh, which
// shares this file's per-block pieces. It replaces
// limg_tpu/pallas_kernels/encode_segments.py: segment_encode_pallas (:188,
// kernel :114), which takes any P (:205): refit, factors, crush search,
// dither and decode of the contiguous segments of the run buffer.
//
// What bounds it on the H100: it does the work of the fixed-grid kernel per
// member block (a fit and 25 sweeps plus up to K exact candidate decodes at
// ladder K = 8), so its bound is operations (chip_smoke.py kernel_bound);
// it runs far from it, compute- and barrier-bound: a segment reduction
// after every fit step and candidate pass.
//
// segment_encode's design: segment ids are the first member's position,
// members are contiguous and a segment has at most SEG_CAP of them. A lane
// is an 8x8 block (P = 64) or a region of P = 256 pixels (4 chunks of 64).
// CTA k takes the whole segments that start in its tile of lanes (128 at P
// = 64, 32 at 256, so that fewer, larger lanes still fill the card), at
// most 383 lanes, so every reduction stays inside the CTA. It first counts
// each segment's member pixels: the lanes of a segment with none (the
// buffer's tail of non-run lanes, 27% of the lanes at 4K) get the plain
// version's outputs for an empty region at once (write_empty), and every
// later loop walks only the other lanes (S.act); a CTA of such lanes alone
// stops there. A warp works on one block at a time and loops over the
// CTA's active blocks. In the fit, 64 pixels are in registers at a time
// (two a lane, as in encode_fixed), a larger region chunk by chunk, each
// float sum over its pixels kept lane by lane in the plain version's
// halving-tree order (ChunkTree; the chunk loops are not unrolled:
// unrolled, they spilled 2-3 KB a thread); between the steps of the fit the
// blocks' partial values meet in shared memory: float sums (counts,
// channel sums, unit-vector sums) and the factor extremes go through the
// doubling scan of ops/segments.py in the plain version's order, fwd + bwd
// - x, which is not the exact segment sum and can differ between members:
// between two CTA barriers each warp scans whole segments
// (scan_segments), a segment of up to 32 members by shuffles (at 4K all
// but ~70 of ~37,000), a longer one over shared memory with the warp's own
// barriers. The fit's per-pixel steps are repeated from the image in each
// phase (limg_common.cuh FitSteps), its factors go to a scratch plane, and
// per-block state lives in shared memory, one column per block.
//
// The crush search (ops/crush.py find_shifts on segment totals): its pixel
// maxima and wrapping error sums are order-free, so a lane of a block holds
// all its 2^(LOGC+1) pixels and factors in registers (SegLane), reduces
// each candidate over the warp (two reductions) and keeps the block's
// values of candidate c in lane c, and lanes c of a pass add them to the
// segment's totals, a row of shared memory a segment (its ordinal among
// the CTA's segment starts), one atomic instruction a pass each. Ladder:
// one pass of the 25 distinct sweeps, each axis's on its base (the other
// two axes' decode at shift 0, made once a pixel and channel, as
// crush_search.cuh's sweep_base); after one CTA barrier each warp builds
// its blocks' ladder box and 64 lattice keys from the totals, peels the K
// candidates (lane r keeps the r-th) and evaluates those that are not
// sweeps (a sweep's totals are the sweep pass's); after a second barrier
// the decode pass folds the K candidates, lane r judging the r-th. Exhaustive: passes of two rows
// of 9 triples (s0, s1 fixed), each row a sweep of axis 2 on its base, the
// segment's start folding the totals (ties to later) between barriers.
// Guess: one pass of (0, 0, 0) and the four canned triples. A candidate's
// per-axis constants are hoisted out of the pixel loop and a decoded
// channel's clamp is one DPX instruction (clamped_pixel_err).
// One warp per segment, with no CTA barrier after the counts, computed the
// same bits but took 3x the time at 4K (PERF.md). At P = 256 this design
// measured 3.5x faster than the cluster design on the 4K dense buffer
// (PERF.md): 12,341 member lanes fill the card one warp each.

#pragma once

#include "limg_common.cuh"
#include "crush_search.cuh"

namespace {

using namespace limg;

constexpr int kSegCap = 256;       // ops/segments.py SEG_CAP
constexpr int kSegErrShift = 8;    // ops/segments.py SEG_ERR_SHIFT

// ---------------------------------------------------------------------------
// segment_encode
// ---------------------------------------------------------------------------

// A lane of the run buffer is a region of kP << LOGC pixels (an 8x8 block
// at LOGC = 0; a 16x16 pixel region of the dense level 1 at LOGC = 2), read
// as 2^LOGC chunks of 64: chunk k holds pixels 64k .. 64k + 63, and lane l
// of the warp pixels 64k + l and 64k + l + 32.
constexpr int kSegLanes = 128 + kSegCap - 1;  // the most lanes a CTA covers
constexpr int kSegWarps = 8;
constexpr int kSegThreads = kSegWarps * 32;
constexpr int kScanRows = 6;                     // float rows scanned at once
constexpr int kBatch = 9;                        // candidates a batch (segment_cluster.cuh)
constexpr int kMaxK = 16;                        // kernels/coalesce.py MAX_LADDER_K
constexpr int kMaxTile = 128;                    // the most segment starts a CTA takes
constexpr int kTotCands = 25;                    // the most candidates a pass: the 25 sweeps
constexpr int kTotStride = 2 * kTotCands;        // a segment's totals: pixel maxima, error sums
constexpr int kExhRows = 2;                      // exhaustive: rows of 9 triples a pass

// Segment starts per CTA: 128 for 8x8 blocks; 32 for 16x16 px regions,
// whose buffers hold a quarter of the lanes, so that the card still gets a
// few hundred CTAs.
template <int LOGC>
__host__ __device__ constexpr int seg_tile() {
  return LOGC == 0 ? kMaxTile : 32;
}

// Per-block state rows (ints; floats by bit pattern). The crush's rows reuse
// the fit's once the endpoints are out; they hold a segment's values at its
// start's column.
enum : int {
  S_AVG = 0, S_DIRA = 4, S_DIRB = 8, S_DIRC = 12, S_MN = 16, S_MX = 19,   // fit, floats
  S_BEST = 0, S_TOT = 1, S_ERR = 2, S_FPIX = 3, S_FBLK = 4,              // exhaustive search
  S_CAND = 5,                                                            // ladder candidates
  S_COUNT = 22,                                                          // segment pixels
  kStateRows = 23,
};

// The fit's rows of the doubling scan.
struct SegScan {
  float sx[kScanRows][kSegLanes], sf[kScanRows][kSegLanes], sb[kScanRows][kSegLanes];
};

struct SegShared {
  int seg[kSegLanes];  // local index of each block's segment start
  int len[kSegLanes];  // at a segment start: its lane count; in the crush search, each
                       // lane's segment's ordinal among the CTA's segment starts
  int act[kSegLanes];  // the lanes whose segment holds a member pixel
  int n_act;
  union {
    SegScan scan;                       // the fit
    int tot[kMaxTile * kTotStride];     // the crush: each segment's candidate totals
  };
  int vtot[kMaxTile * kTotStride];      // pixel counts; the ladder's verified candidates' totals
  int st[kStateRows][kSegLanes];
  int frame[kSegWarps][6 * 4];          // each warp's block's decode frame
  unsigned starts[(kSegLanes + 31) / 32];   // the segment starts, a bit a lane
  int range[2];
};

struct SegParams {
  const int32_t* packed;  // (n, P) block-major words
  const uint8_t* mask;    // (n, P) member pixels
  const int32_t* seg;     // (n,) segment ids
  const int32_t* blocks;  // (n,) image region index (the dither counter)
  int n, crush_mode, dither, ladder_k, num_factors, max_pix, max_blk;
  uint32_t key;
  int32_t* f8;            // (n, P) scratch: the fit's packed factors
  int32_t* shifts;        // (3, n)
  int32_t* q;             // (n, P) or null
  int32_t* dec;           // (n, P)
  float* dist_blk;        // (n,)
  int32_t* count_blk;     // (n,)
  int32_t* count_mem;     // (n,)
  int32_t* eps;           // (6, CH, n)
  float* avg;             // (CH, n)
  int logc;               // log2 of the chunks a region (segment_cluster.cuh)
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

// Index of the word of pixel 64k + lane + 32j of lane b's region.
template <int LOGC>
__device__ __forceinline__ size_t pixel_at(size_t b, int k, int lane, int j) {
  return (b << LOGC) * kP + (size_t)(kP * k + lane + 32 * j);
}

// The chunk visited t-th by a region sum: t's LOGC bits reversed.
template <int LOGC>
__device__ __forceinline__ int chunk_at(int t) {
  if constexpr (LOGC == 0) {
    return 0;
  } else {
    return (int)(__brev((unsigned)t) >> (32 - LOGC));
  }
}

// The plain version's halving tree over a region's pixels (ops/fit.py
// tree_sum over P = 64 * 2^LOGC), kept lane by lane: the chunks, visited
// in bit-reversed order (chunk_at), fold pairwise as a binary counter, so
// chunk k meets chunk k + 2^(LOGC-1) first, as x[:P/2] + x[P/2:] pairs
// them; after the last chunk each of the 64 positions holds its sum over
// the chunks, and tree_sum takes them to the region's total.
template <int LOGC, int N>
struct ChunkTree {
  float part[LOGC > 0 ? LOGC : 1][N][2];

  // Folds v, the values of the t-th chunk visited, in; after the last
  // chunk v holds the position sums.
  __device__ __forceinline__ void fold(int t, float (&v)[N][2]) {
    bool open = true;
#pragma unroll
    for (int l = 0; l < LOGC; ++l) {
      if (open) {
        if ((t >> l) & 1) {
#pragma unroll
          for (int n = 0; n < N; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) v[n][j] = part[l][n][j] + v[n][j];
          }
        } else {
#pragma unroll
          for (int n = 0; n < N; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) part[l][n][j] = v[n][j];
          }
          open = false;
        }
      }
    }
  }
};

// Chunk k of lane b's region. Pixels outside the member mask keep their
// values: they count in no sum, and the factors and decode cover every
// pixel of the buffer, as in the plain version.
template <int CH, int LOGC>
__device__ __forceinline__ void load_pixels(const SegParams& P, size_t b, int k, int lane,
                                            Pixels<CH>& p) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t at = pixel_at<LOGC>(b, k, lane, j);
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
          const float x = lane < n ? S.scan.sx[r][s + lane] : 0.0f;
          float f = x, b = x;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const float pf = __shfl_up_sync(kFull, f, d), pb = __shfl_down_sync(kFull, b, d);
            if (lane >= d) f = sum ? f + pf : fmaxf(f, pf);
            if (lane + d < n) b = sum ? b + pb : fmaxf(b, pb);
          }
          if (lane < n) S.scan.sx[r][s + lane] = sum ? (f + b) - x : fmaxf(f, b);
        } else {
          constexpr int kPer = kSegCap / 32;
          float* sf = S.scan.sf[r] + s;
          float* sb = S.scan.sb[r] + s;
          for (int j = lane; j < n; j += 32) sf[j] = sb[j] = S.scan.sx[r][s + j];
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
            const float x = S.scan.sx[r][s + j];
            S.scan.sx[r][s + j] = sum ? (sf[j] + sb[j]) - x : fmaxf(sf[j], sb[j]);
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

// Per-pixel terms of unit_vector_sums (limg_common.cuh): v times its signed
// inverse length.
template <int CH>
__device__ __forceinline__ void unit_vector_terms(const float (&v)[CH][2], const float mf[2],
                                                  float (&t)[CH][2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float vj[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) vj[c] = v[c][j];
    const float il = signed_inv_len<CH>(vj, mf[j]);
#pragma unroll
    for (int c = 0; c < CH; ++c) t[c][j] = v[c][j] * il;
  }
}

// One fit step for every block of the CTA: the per-block values of step
// `step` (1: unit-vector sums of the centred pixels, 2: of the residual
// after axis A, 3: after axis B) go to sx and through the scan, and their
// region means to the state rows at `out_row`.
template <int CH, int LOGC>
__device__ void fit_direction(const SegParams& P, SegShared& S, int a, int nl, int step,
                              int out_row) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the per-pixel terms of chunk k of lane b's region under region i's values
  const auto terms_of = [&](const FitRegion<CH>& r, size_t b, int k, float (&terms)[CH][2]) {
    Pixels<CH> p;
    load_pixels<CH, LOGC>(P, b, k, lane, p);
    FitSteps<CH> fs;
    fs.center(p, r.avg);
    if (step == 1) {
      unit_vector_terms<CH>(fs.corrected, p.mf, terms);
    } else {
      fs.axis_a(p, r.avg, r.dir_a);
      if (step == 2) {
        unit_vector_terms<CH>(fs.resid_a, p.mf, terms);
      } else {
        fs.axis_b(p, r.dir_b);
        unit_vector_terms<CH>(fs.resid_ab, p.mf, terms);
      }
    }
  };
  for (int ai = warp; ai < S.n_act; ai += kSegWarps) {
    const int i = S.act[ai];
    FitRegion<CH> r;
    r.load(S, i, step - 1);
    ChunkTree<LOGC, CH> tree;
    float terms[CH][2];
#pragma unroll 1
    for (int t = 0; t < (1 << LOGC); ++t) {
      terms_of(r, (size_t)(a + i), chunk_at<LOGC>(t), terms);
      tree.fold(t, terms);
    }
    float part[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) part[c] = tree_sum(terms[c][0], terms[c][1]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < CH; ++c) S.scan.sx[c][i] = part[c];
    }
  }
  __syncthreads();
  scan_segments<CH, CH>(S, nl);
  for (int i = threadIdx.x; i < nl; i += kSegThreads) {
    const float ic = inv_count(S, i);
#pragma unroll
    for (int c = 0; c < CH; ++c) putf(S, out_row + c, i, S.scan.sx[c][i] * ic);
  }
  __syncthreads();
}

// The block-error pre-scale of a region of kP << LOGC pixels (ops/crush.py
// err_scale_shift): each pixel's error is shifted right by it before the
// block's sum, and the block's sum by kSegErrShift less it before the
// segment's, so a segment's error is always scaled by kSegErrShift
// (limg_tpu/ops/segments.py:397, :416).
template <int LOGC>
__host__ __device__ constexpr int block_err_scale() {
  return (kP << LOGC) >= 2048 ? 4 : 0;
}

// Block i's values as the crush search evaluates it: its region's
// (axis-dropped) endpoints and pixel count; load_crush_chunk adds a
// chunk's pixels and the fit's factors.
template <int CH, int LOGC>
__device__ void setup_crush_block(const SegParams& P, const SegShared& S, size_t b, int i,
                                  Block<CH>& blk) {
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
  blk.es = block_err_scale<LOGC>();
  blk.seg_shift = kSegErrShift - blk.es;
  blk.floors = false;
  blk.floor_pix = blk.floor_blk = 0;
}

template <int CH, int LOGC>
__device__ __forceinline__ void load_crush_chunk(const SegParams& P, size_t b, int k, int lane,
                                                 Block<CH>& blk) {
  Pixels<CH> p;
  load_pixels<CH, LOGC>(P, b, k, lane, p);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    blk.mask[j] = p.mask[j];
#pragma unroll
    for (int c = 0; c < CH; ++c) blk.px[c][j] = p.px[c][j];
    const int w = P.f8[pixel_at<LOGC>(b, k, lane, j)];
#pragma unroll
    for (int k3 = 0; k3 < 3; ++k3) blk.f8[k3][j] = (w >> (8 * k3)) & 0xFF;
  }
}

// This lane's part of Block::eval over one chunk: the pixel max and the
// sum of err >> es folded into pm / be.
template <int CH>
__device__ __forceinline__ void eval_lane(const Block<CH>& blk, const int (&s)[3], int& pm,
                                          int& be) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    int q[3], est[CH];
#pragma unroll
    for (int k = 0; k < 3; ++k) q[k] = blk.f8[k][j] >> min(s[k], 8);
    decode_est<CH>(q, s, blk.n_int, blk.m_int, est);
    const int err = blk.weighted_err(est, j) * blk.mask[j];
    pm = max(pm, err);
    be = add_wrap(be, err >> blk.es);
  }
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
                                          bool floors, int floor_pix, int floor_blk) {
  return SegAdm{S.st[S_COUNT][i], P.max_pix, P.max_blk, floor_pix, floor_blk, floors};
}

// One lane's part of the crush search of one block: its 2^(LOGC+1) pixels
// (pixel t = 2k + j is pixel 64k + lane + 32j of the region) and their u8
// factors in registers, the block's decode frame in its warp's slot of
// shared memory. A candidate's values are the lane's pixel maximum and
// wrapping error sum, then the warp's (one reduction each), then the
// segment's (atomics): integers, the same in any order. A decoded
// channel's clamp to [0, 255] is one DPX instruction (clamped_pixel_err).
template <int CH, int LOGC>
struct SegLane {
  static constexpr int kPix = 2 << LOGC;
  int px[CH][kPix];
  int f8w[kPix];      // pixel t's u8 factors, axis k in byte k
  unsigned vmask;     // bit t: pixel t is a member
  int lane;
  const int* fr;      // axis normals n[k][c] at k CH + c, offsets m[k][c] at (3 + k) CH + c

  // Block b's pixels and factors, and its frame (from the endpoint rows)
  // into the warp's slot.
  __device__ void load(const SegParams& P, size_t b, int lane_, int* slot) {
    lane = lane_;
    vmask = 0;
#pragma unroll
    for (int k = 0; k < (1 << LOGC); ++k) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = 2 * k + j;
        const size_t at = pixel_at<LOGC>(b, k, lane, j);
        const uint32_t w = (uint32_t)P.packed[at];
#pragma unroll
        for (int c = 0; c < CH; ++c) px[c][t] = (int)((w >> (8 * c)) & 0xFFu);
        vmask |= (P.mask[at] != 0 ? 1u : 0u) << t;
        f8w[t] = P.f8[at];
      }
    }
    // lane e < 6 CH reads endpoint value e (row e / CH, channel e % CH);
    // lane k CH + c < 3 CH writes axis k's normal and offset of channel c
    const int ep = lane < 6 * CH ? P.eps[(size_t)lane * P.n + b] : 0;
    const int kc = min(lane, 3 * CH - 1), k = kc / CH, c = kc % CH;
    const int hi = __shfl_sync(kFull, ep, (2 * k + 1) * CH + c);
    const int lo = __shfl_sync(kFull, ep, 2 * k * CH + c);
    __syncwarp();  // the warp's last block's frame is read
    if (lane < 3 * CH) {
      slot[lane] = hi - lo;
      slot[3 * CH + lane] = lo;
    }
    __syncwarp();
    fr = slot;
  }

  // Axis k's term of decode_est (limg_common.cuh) at shift s, its
  // constants hoisted out of the pixel loop.
  struct Axis {
    int shr, qm, mul, nn[CH], mm[CH];
  };
  __device__ Axis axis(int k, int s) const {
    Axis x;
    const int se = min(s, 8);
    x.shr = 8 * k + se;
    x.qm = 0xFF >> se;
    x.mul = mult_for(se);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      x.nn[c] = s > 7 ? 0 : fr[k * CH + c];
      x.mm[c] = (k == 0 || s <= 7) ? fr[(3 + k) * CH + c] : 0;
    }
    return x;
  }
  __device__ __forceinline__ void add_axis(const Axis& x, int t, int (&est)[CH]) const {
    const int fdec = ((f8w[t] >> x.shr) & x.qm) * x.mul;
#pragma unroll
    for (int c = 0; c < CH; ++c) est[c] += x.mm[c] + ((fdec * x.nn[c] + 128) >> 8);
  }
  // pixel t's error under est (0 outside the members) into (pm, be)
  __device__ __forceinline__ void take(const int (&est)[CH], int t, int& pm, int& be) const {
    const int e = (vmask >> t) & 1 ? clamped_pixel_err<CH, kPix>(est, px, t) : 0;
    pm = max(pm, e);
    be = add_wrap(be, e >> block_err_scale<LOGC>());
  }

  // Exact (pixel max, error sum) of this lane's pixels under triple s.
  __device__ void eval(const int (&s)[3], int& pm, int& be) const {
    const Axis x0 = axis(0, s[0]), x1 = axis(1, s[1]), x2 = axis(2, s[2]);
    pm = be = 0;
#pragma unroll
    for (int t = 0; t < kPix; ++t) {
      int est[CH] = {};
      add_axis(x0, t, est);
      add_axis(x1, t, est);
      add_axis(x2, t, est);
      take(est, t, pm, be);
    }
  }
  // The decode of axes k0 and k1 at shifts s0 and s1, pixel by pixel: the
  // base of the triples that differ only in the third axis.
  __device__ void base2(int k0, int s0, int k1, int s1, int (&base)[CH][kPix]) const {
    const Axis x0 = axis(k0, s0), x1 = axis(k1, s1);
#pragma unroll
    for (int t = 0; t < kPix; ++t) {
      int est[CH] = {};
      add_axis(x0, t, est);
      add_axis(x1, t, est);
#pragma unroll
      for (int c = 0; c < CH; ++c) base[c][t] = est[c];
    }
  }
  // eval of the base's triple with its third axis, k, at shift s
  __device__ void eval_on(const int (&base)[CH][kPix], int k, int s, int& pm, int& be) const {
    const Axis x = axis(k, s);
    pm = be = 0;
#pragma unroll
    for (int t = 0; t < kPix; ++t) {
      int est[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) est[c] = base[c][t];
      add_axis(x, t, est);
      take(est, t, pm, be);
    }
  }

  // The block's values of one candidate (a reduction each over the warp);
  // lane `mine` keeps them.
  __device__ __forceinline__ void keep(int mine, int pm, int be, int& hp, int& hb) const {
    pm = __reduce_max_sync(kFull, pm);
    be = __reduce_add_sync(kFull, be);
    if (lane == mine) {
      hp = pm;
      hb = be;
    }
  }
};

// Lane c adds its candidate c's block values to the segment's totals (pixel
// maxima at tot[c], error sums, each block's shifted first, at tot[kTotCands
// + c]): a pass's atomics in one instruction each.
template <int LOGC>
__device__ __forceinline__ void publish(int* tot, int lane, bool mine, int hp, int hb) {
  if (mine) {
    atomicMax(tot + lane, hp);
    atomicAdd(tot + kTotCands + lane, hb >> (kSegErrShift - block_err_scale<LOGC>()));
  }
}

// limg_common.cuh guess_triple(t) packed (pack3), from a constant rather
// than a table (a table indexed at run time would sit in local memory).
__device__ __forceinline__ int guess_packed(int t) {
  return (int)((0x542864885654ull >> (12 * t)) & 0xFFFu);
}

// Triple s's index among the ladder's 25 distinct sweeps (0: (0, 0, 0);
// 8 a + v: axis a at v > 0, the others 0), or -1.
__device__ __forceinline__ int sweep_index(const int (&s)[3]) {
  const int nz = (s[0] > 0) + (s[1] > 0) + (s[2] > 0);
  if (nz > 1) return -1;
  return s[0] > 0 ? s[0] : (s[1] > 0 ? 8 + s[1] : (s[2] > 0 ? 16 + s[2] : 0));
}

// The ladder box and the 64 lattice keys of a segment from its sweeps'
// totals, spread over the warp (limg_common.cuh ladder_axis and ladder_key,
// the same integers): lane 9 a + s tests axis a's sweep s, a ballot gives
// each axis's base (its largest admissible shift), and each lane makes its
// keys lane and lane + 32 from the totals at the box's shifts.
__device__ __forceinline__ void ladder_keys_of(const int* tot, const SegAdm& adm, int lane,
                                               LadderBox& box, int (&key)[2]) {
  const auto at = [](int a, int s) { return s == 0 ? 0 : 8 * a + s; };
  const int x = at(lane / 9, lane % 9);
  const unsigned ok = __ballot_sync(kFull, lane < 27 && adm(tot[x], tot[kTotCands + x]));
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const unsigned bits = (ok >> (9 * a)) & 0x1FFu;
    box.base[a] = bits == 0 ? 0 : 31 - __clz(bits);
  }
  const int pm0 = tot[0], be0 = tot[kTotCands];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = lane + 32 * j, o[3] = {idx / 16, (idx / 4) % 4, idx % 4};
    int d_blk = 0, d_pix = 0, total = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int s = max(box.base[a] - o[a], 0), y = at(a, s);
      d_blk += tot[kTotCands + y] - be0;
      d_pix += tot[y] - pm0;
      total += s;
    }
    const int ablk = be0 + d_blk, apix = pm0 + d_pix;
    const int fits = adm(apix, ablk) ? 1 : 0;
    const int err_pack = (33554431) - min(ablk >> 6, 33554431);
    key[j] = (int)(((uint32_t)fits << 30) + ((uint32_t)total << 25) + (uint32_t)err_pack);
  }
}

// dither_decode (limg_common.cuh) for chunk k of a region of npix pixels:
// the dither counter takes the pixel's index in the region and npix.
template <int CH>
__device__ void dither_decode_chunk(const Block<CH>& blk, const int (&best)[3], bool dither,
                                    uint32_t key, uint32_t region, int k, int npix, int lane,
                                    int (&q)[3][2], int (&dec)[CH][2], float (&err_f)[2]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int s = best[a];
    const int se = min(s, 8);
    const bool live = dither && s > 0 && s < 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int v = blk.f8[a][j];
      if (live)
        v = min(max(v + dither_noise(dither_bits_p(key, region, a, kP * k + lane + 32 * j, npix),
                                     s), 0), 255);
      q[a][j] = v >> se;
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    int e[CH];
    const int qj[3] = {q[0][j], q[1][j], q[2][j]};
    decode_est<CH>(qj, best, blk.n_int, blk.m_int, e);
#pragma unroll
    for (int c = 0; c < CH; ++c) dec[c][j] = min(max(e[c], 0), 255);
    err_f[j] = (float)(blk.weighted_err(e, j) * blk.mask[j]);
  }
}

// Block b of a segment with no member pixel: the plain version's outputs
// for an empty region (zero fit and factors, the search's (0, 0, 0) and the
// forced drops, a dither that leaves zero factors zero, a zero decode),
// written without the work (tests/test_torch_kernel_orders.py holds the
// plain version to them).
template <int CH, int LOGC>
__device__ void write_empty(const SegParams& P, size_t b, int lane) {
  const int zero[CH][2] = {};
#pragma unroll 1
  for (int k = 0; k < (1 << LOGC); ++k) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const size_t at = pixel_at<LOGC>(b, k, lane, j);
      if (P.q != nullptr) P.q[at] = 0;
      P.dec[at] = pack_decoded<CH>(zero, 0);
    }
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

template <int CH, int LOGC>
__global__ void __launch_bounds__(kSegThreads, 2) segment_encode_kernel(const SegParams P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SegShared& S = *reinterpret_cast<SegShared*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kChunks = 1 << LOGC;

  // the CTA's blocks: the segments starting in [lo, hi), up to the next start
  const int lo = blockIdx.x * seg_tile<LOGC>(), hi = min(lo + seg_tile<LOGC>(), P.n);
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
    S.vtot[i] = 0;
  }
  __syncthreads();

  // ---- segment pixel counts; the lanes of segments with no member pixel
  // (the buffer's tail of non-run lanes) take the short path, the others go
  // on the active list that every per-block loop below walks
  for (int i = warp; i < nl; i += kSegWarps) {
    int m = 0;
#pragma unroll 1
    for (int k = 0; k < kChunks; ++k) {
      const size_t at = pixel_at<LOGC>((size_t)(a + i), k, lane, 0);
      m += (P.mask[at] != 0 ? 1 : 0) + (P.mask[at + 32] != 0 ? 1 : 0);
    }
    const int cnt = __reduce_add_sync(kFull, m);
    if (lane == 0 && cnt > 0) atomicAdd(&S.vtot[S.seg[i]], cnt);
  }
  __syncthreads();
  for (int i = tid; i < nl; i += kSegThreads) {
    S.st[S_COUNT][i] = S.vtot[S.seg[i]];
    if (S.st[S_COUNT][i] > 0) S.act[atomicAdd(&S.n_act, 1)] = i;
    if (i == nl - 1 || S.seg[i + 1] != S.seg[i]) S.len[S.seg[i]] = i - S.seg[i] + 1;
  }
  __syncthreads();
  const int na = S.n_act;
  for (int i = warp; i < nl; i += kSegWarps)
    if (S.st[S_COUNT][i] == 0) write_empty<CH, LOGC>(P, (size_t)(a + i), lane);
  if (na == 0) return;  // uniform: no member pixel in the CTA

  // ---- fit: channel sums -> avg
  for (int ai = warp; ai < na; ai += kSegWarps) {
    const int i = S.act[ai];
    ChunkTree<LOGC, CH> tree;
    float v[CH][2];
#pragma unroll 1
    for (int t = 0; t < kChunks; ++t) {
      Pixels<CH> p;
      load_pixels<CH, LOGC>(P, (size_t)(a + i), chunk_at<LOGC>(t), lane, p);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int j = 0; j < 2; ++j) v[c][j] = p.pxf[c][j] * p.mf[j];
      }
      tree.fold(t, v);
    }
    float sums[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) sums[c] = tree_sum(v[c][0], v[c][1]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < CH; ++c) S.scan.sx[c][i] = sums[c];
    }
  }
  __syncthreads();
  scan_segments<CH, CH>(S, nl);
  for (int i = tid; i < nl; i += kSegThreads) {
    const float ic = inv_count(S, i);
#pragma unroll
    for (int c = 0; c < CH; ++c) putf(S, S_AVG + c, i, S.scan.sx[c][i] * ic);
  }
  __syncthreads();

  // ---- fit: the three directions
  fit_direction<CH, LOGC>(P, S, a, nl, 1, S_DIRA);
  fit_direction<CH, LOGC>(P, S, a, nl, 2, S_DIRB);
  if (CH == 4) fit_direction<CH, LOGC>(P, S, a, nl, 3, S_DIRC);

  // ---- fit: factor extremes (min as -max(-x)); order-free, so each lane
  // folds its chunks before one warp reduction
  for (int ai = warp; ai < na; ai += kSegWarps) {
    const int i = S.act[ai];
    FitRegion<CH> r;
    r.load(S, i, CH == 4 ? 3 : 2);
    if (CH == 3) FitSteps<CH>::cross(r.dir_a, r.dir_b, r.dir_c);
    float mn[3], mx[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      mn[k] = kBig;
      mx[k] = -kBig;
    }
    const float inv_c = inv_or_zero(dot_self<CH>(r.dir_c));
#pragma unroll 1
    for (int k = 0; k < kChunks; ++k) {
      Pixels<CH> p;
      load_pixels<CH, LOGC>(P, (size_t)(a + i), k, lane, p);
      FitSteps<CH> fs;
      fs.center(p, r.avg);
      fs.axis_a(p, r.avg, r.dir_a);
      fs.axis_b(p, r.dir_b);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float f[3] = {fs.fac_a[j], fs.fac_b[j],
                            project<CH>(fs.resid_ab, j, r.dir_c, inv_c) * p.mf[j]};
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          mn[e] = fminf(mn[e], p.mask[j] ? f[e] : kBig);
          mx[e] = fmaxf(mx[e], p.mask[j] ? f[e] : -kBig);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      mn[e] = warp_min(mn[e]);
      mx[e] = warp_max(mx[e]);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        S.scan.sx[k][i] = -mn[k];
        S.scan.sx[3 + k][i] = mx[k];
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
      putf(S, S_MN + k, i, -S.scan.sx[k][i]);
      putf(S, S_MX + k, i, S.scan.sx[3 + k][i]);
    }
  }
  __syncthreads();

  // ---- fit: endpoints, factors (to the scratch plane), endpoint and avg rows
  for (int ai = warp; ai < na; ai += kSegWarps) {
    const int i = S.act[ai];
    const size_t b = (size_t)(a + i);
    FitRegion<CH> r;
    r.load(S, i, 3);
    float mn[3], mx[3];
    getv<3>(S, S_MN, i, mn);
    getv<3>(S, S_MX, i, mx);
    int ep[6][CH];
    round_endpoints<CH>(S.st[S_COUNT][i], r.avg, r.dir_a, r.dir_b, r.dir_c, mn, mx, ep);
#pragma unroll 1
    for (int k = 0; k < kChunks; ++k) {
      Pixels<CH> p;
      load_pixels<CH, LOGC>(P, b, k, lane, p);
      int f8[3][2];
      extract_factors<CH>(p, ep, f8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        P.f8[pixel_at<LOGC>(b, k, lane, j)] = f8[0][j] | (f8[1][j] << 8) | (f8[2][j] << 16);
    }
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
  // Each segment's totals sit in its row of tot (vtot: the ladder's verified
  // candidates), the row its ordinal among the CTA's segment starts, which
  // len holds for each lane from here on.
  constexpr int kPix = SegLane<CH, LOGC>::kPix;
  constexpr int kRows = seg_tile<LOGC>();   // the most segment starts here
  for (int c = warp; c * 32 < nl; c += kSegWarps) {
    const int g = c * 32 + lane;
    const unsigned w = __ballot_sync(kFull, g < nl && S.seg[g] == g);
    if (lane == 0) S.starts[c] = w;
  }
  for (int e = tid; e < kRows * kTotStride; e += kSegThreads) {
    const int v = e % kTotStride < kTotCands ? (-2147483647 - 1) : 0;
    S.tot[e] = v;
    S.vtot[e] = v;
  }
  __syncthreads();
  for (int i = tid; i < nl; i += kSegThreads) {
    const int s = S.seg[i];
    int o = __popc(S.starts[s >> 5] & ((1u << (s & 31)) - 1u));
    for (int c = 0; c < (s >> 5); ++c) o += __popc(S.starts[c]);
    S.len[i] = min(o, kRows - 1);   // well-formed ids: at most kRows segments start here
    if (s == i) {
      S.st[S_BEST][i] = 0;
      S.st[S_TOT][i] = -1;
      S.st[S_ERR][i] = 2147483647;
      S.st[S_FPIX][i] = S.st[S_FBLK][i] = 0;
    }
  }
  __syncthreads();
  const bool floors = P.crush_mode != kNone && P.num_factors < 3;
  if (P.crush_mode == kLadder) {
    // the 25 distinct sweeps (axis ax at shift s, the other axes
    // unquantized) in one pass: per axis the other two axes' decode once
    for (int ai = warp; ai < na; ai += kSegWarps) {
      const int i = S.act[ai];
      SegLane<CH, LOGC> L;
      L.load(P, (size_t)(a + i), lane, S.frame[warp]);
      int hp = 0, hb = 0;
      // unrolled at P = 64 (2 pixels a lane), where registers allow it
#pragma unroll (LOGC == 0 ? 3 : 1)
      for (int ax = 0; ax < 3; ++ax) {
        int base[CH][kPix];
        L.base2(ax == 0 ? 1 : 0, 0, ax == 2 ? 1 : 2, 0, base);
#pragma unroll (LOGC == 0 ? 9 : 1)
        for (int s = ax == 0 ? 0 : 1; s < 9; ++s) {
          int pm, be;
          L.eval_on(base, ax, s, pm, be);
          L.keep(s == 0 ? 0 : 8 * ax + s, pm, be, hp, hb);
        }
      }
      publish<LOGC>(S.tot + S.len[i] * kTotStride, lane, lane < kTotCands, hp, hb);
    }
    __syncthreads();
    // lattice keys and the K best-ranked candidates (lane r keeps the r-th,
    // the segment's start its row), then the exact values of those that
    // are not sweeps
    for (int ai = warp; ai < na; ai += kSegWarps) {
      const int i = S.act[ai], row = S.len[i];
      const int* tot = S.tot + row * kTotStride;
      const SegAdm adm = seg_adm(P, S, i, floors, tot[0], tot[kTotCands]);
      LadderBox box;
      int key[2], mine = 0;
      ladder_keys_of(tot, adm, lane, box, key);
      for (int r = 0; r < P.ladder_k; ++r) {
        int s[3];
        ladder_peel(key, box, lane, s);
        if (lane == r) mine = pack3(s);
      }
      int sm[3];
      unpack3(mine, sm);
      if (lane < P.ladder_k && S.seg[i] == i) S.st[S_CAND + lane][i] = mine;
      const unsigned need = __ballot_sync(kFull, lane < P.ladder_k && sweep_index(sm) < 0);
      if (need == 0) continue;
      SegLane<CH, LOGC> L;
      L.load(P, (size_t)(a + i), lane, S.frame[warp]);
      int hp = 0, hb = 0;
      for (unsigned m = need; m != 0; m &= m - 1) {
        const int r = __ffs(m) - 1;
        int s[3], pm, be;
        unpack3(__shfl_sync(kFull, mine, r), s);
        L.eval(s, pm, be);
        L.keep(r, pm, be, hp, hb);
      }
      publish<LOGC>(S.vtot + row * kTotStride, lane, (need >> lane) & 1, hp, hb);
    }
    __syncthreads();
  } else if (P.crush_mode == kExhaustive) {
    // all 729 triples in ascending lex order, kExhRows rows of 9 (s0 and s1
    // fixed, s2 = 0 .. 8) a pass, each row on its first two axes' decode;
    // the segment's start folds them, ties to later
    for (int r0 = 0; r0 < 81; r0 += kExhRows) {
      const int nr = min(kExhRows, 81 - r0);
      for (int ai = warp; ai < na; ai += kSegWarps) {
        const int i = S.act[ai];
        SegLane<CH, LOGC> L;
        L.load(P, (size_t)(a + i), lane, S.frame[warp]);
        int hp = 0, hb = 0;
#pragma unroll 1
        for (int rr = 0; rr < nr; ++rr) {
          int base[CH][kPix];
          L.base2(0, (r0 + rr) / 9, 1, (r0 + rr) % 9, base);
#pragma unroll 1
          for (int s2 = 0; s2 < 9; ++s2) {
            int pm, be;
            L.eval_on(base, 2, s2, pm, be);
            L.keep(9 * rr + s2, pm, be, hp, hb);
          }
        }
        publish<LOGC>(S.tot + S.len[i] * kTotStride, lane, lane < 9 * nr, hp, hb);
      }
      __syncthreads();
      for (int i = tid; i < nl; i += kSegThreads) {
        if (S.seg[i] != i || S.st[S_COUNT][i] == 0) continue;
        int* tot = S.tot + S.len[i] * kTotStride;
        if (r0 == 0 && floors) {   // the floors: (0, 0, 0)'s values
          S.st[S_FPIX][i] = tot[0];
          S.st[S_FBLK][i] = tot[kTotCands];
        }
        const SegAdm adm = seg_adm(P, S, i, floors, S.st[S_FPIX][i], S.st[S_FBLK][i]);
        int best[3], b_tot = S.st[S_TOT][i], b_err = S.st[S_ERR][i];
        unpack3(S.st[S_BEST][i], best);
        for (int c = 0; c < 9 * nr; ++c) {
          const int t = 9 * r0 + c, s[3] = {t / 81, (t / 9) % 9, t % 9};
          take_if_better(adm, s, tot[c], tot[kTotCands + c], true, best, b_tot, b_err);
          tot[c] = -2147483647 - 1;   // emptied for the next pass
          tot[kTotCands + c] = 0;
        }
        S.st[S_BEST][i] = pack3(best);
        S.st[S_TOT][i] = b_tot;
        S.st[S_ERR][i] = b_err;
      }
      __syncthreads();
    }
  } else if (P.crush_mode == kGuess) {
    // (0, 0, 0), whose values are the floors, and the four canned triples
    for (int ai = warp; ai < na; ai += kSegWarps) {
      const int i = S.act[ai];
      SegLane<CH, LOGC> L;
      L.load(P, (size_t)(a + i), lane, S.frame[warp]);
      int hp = 0, hb = 0;
#pragma unroll 1
      for (int t = 0; t < 5; ++t) {
        int s[3], pm, be;
        unpack3(t > 0 ? guess_packed(t - 1) : 0, s);
        L.eval(s, pm, be);
        L.keep(t, pm, be, hp, hb);
      }
      publish<LOGC>(S.tot + S.len[i] * kTotStride, lane, lane < 5, hp, hb);
    }
    __syncthreads();
  }

  // ---- dither, decode and the outputs
  for (int ai = warp; ai < na; ai += kSegWarps) {
    const int i = S.act[ai];
    const size_t b = (size_t)(a + i);
    // the segment's shift triple from its totals (the same in every lane)
    int best[3] = {0, 0, 0};
    const int at = S.seg[i];
    const int* tot = S.tot + S.len[i] * kTotStride;
    if (P.crush_mode == kLadder) {
      // the K candidates, best-ranked first
      // (take_if_better in turn: the admissible one of the largest total,
      // then of the smallest error, then the first); lane r judges the r-th
      const int* vt = S.vtot + S.len[i] * kTotStride;
      const SegAdm adm = seg_adm(P, S, i, floors, tot[0], tot[kTotCands]);
      const bool real = lane < P.ladder_k;
      const int mine = real ? S.st[S_CAND + lane][at] : 0;
      int s[3];
      unpack3(mine, s);
      const int x = sweep_index(s);
      const int pm = !real ? 0 : (x >= 0 ? tot[x] : vt[lane]);
      const int be = !real ? 0 : (x >= 0 ? tot[kTotCands + x] : vt[kTotCands + lane]);
      const bool ok = real && adm(pm, be);
      const int total = s[0] + s[1] + s[2];
      const int top = __reduce_max_sync(kFull, ok ? total : -1);
      if (top >= 0) {
        const bool at_top = ok && total == top;
        const unsigned order = (unsigned)be ^ 0x80000000u;   // be's order, unsigned
        const unsigned low = __reduce_min_sync(kFull, at_top ? order : 0xFFFFFFFFu);
        const unsigned first = __reduce_min_sync(kFull, at_top && order == low ? (unsigned)lane : 32u);
        unpack3(__shfl_sync(kFull, mine, (int)first), best);
      }
    } else if (P.crush_mode == kExhaustive) {
      unpack3(S.st[S_BEST][at], best);
    } else if (P.crush_mode == kGuess) {
      const SegAdm adm = seg_adm(P, S, i, floors, tot[0], tot[kTotCands]);
      bool ok[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) ok[t] = adm(tot[1 + t], tot[kTotCands + 1 + t]);
      const int pick = guess_pick(ok);
      if (pick >= 0) unpack3(guess_packed(pick), best);
    }
    Block<CH> blk;
    setup_crush_block<CH, LOGC>(P, S, b, i, blk);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k >= P.num_factors) best[k] = max(best[k], 8);  // statically dropped axes
    int cnt = 0;
    // chunk k's outputs; its pixels' errors in err
    const auto decode_chunk = [&](int k, float (&err)[2]) {
      load_crush_chunk<CH, LOGC>(P, b, k, lane, blk);
      int q[3][2], dec[CH][2];
      dither_decode_chunk<CH>(blk, best, P.dither != 0, P.key, (uint32_t)P.blocks[b], k,
                              kP << LOGC, lane, q, dec, err);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const size_t at = pixel_at<LOGC>(b, k, lane, j);
        if (P.q != nullptr) P.q[at] = q[0][j] | (q[1][j] << 8) | (q[2][j] << 16);
        P.dec[at] = pack_decoded<CH>(dec, j);
      }
      cnt += blk.mask[0] + blk.mask[1];
    };
    ChunkTree<LOGC, 1> tree;
    float err_v[1][2];
#pragma unroll 1
    for (int t = 0; t < kChunks; ++t) {
      decode_chunk(chunk_at<LOGC>(t), err_v[0]);
      tree.fold(t, err_v);
    }
    const float dist = tree_sum(err_v[0][0], err_v[0][1]);
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) P.shifts[(size_t)k * P.n + b] = best[k];
      P.dist_blk[b] = dist;
      P.count_blk[b] = cnt;
      P.count_mem[b] = blk.count;
    }
  }
}

template <int CH, int LOGC>
int launch_segment_encode(const SegParams& P, cudaStream_t st) {
  const size_t smem = sizeof(SegShared);
  cudaError_t err = cudaFuncSetAttribute(segment_encode_kernel<CH, LOGC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (P.n + seg_tile<LOGC>() - 1) / seg_tile<LOGC>();
  segment_encode_kernel<CH, LOGC><<<grid, kSegThreads, smem, st>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace
