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
// member block (a fit and 35+ exact candidate decodes at ladder K = 8), so
// its bound is operations (chip_smoke.py kernel_bound); it runs far from
// it, compute- and barrier-bound: a segment reduction after every fit step
// and candidate batch.
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
// CTA's active blocks: 64 pixels in registers at a time (two a lane, as in
// encode_fixed), a larger region chunk by chunk, each float sum over its
// pixels kept lane by lane in the plain version's halving-tree order
// (ChunkTree) and the crush's 9 candidates of a batch evaluated on each
// chunk as it is read (the chunk and candidate loops are not unrolled:
// unrolled, they spilled 2-3 KB a thread, took 1.6x the time and twice the
// build); between the steps of the fit and between candidate batches the
// blocks' partial values meet in shared memory:
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
// same bits but took 3x the time at 4K (PERF.md). At P = 256 this design
// measured 3.5x faster than the cluster design on the 4K dense buffer
// (PERF.md): 12,341 member lanes fill the card one warp each.

#pragma once

#include "limg_common.cuh"

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
constexpr int kBatch = 9;                        // candidates per reduction
constexpr int kMaxK = 16;                        // kernels/coalesce.py MAX_LADDER_K

// Segment starts per CTA: 128 for 8x8 blocks; 32 for 16x16 px regions,
// whose buffers hold a quarter of the lanes, so that the card still gets a
// few hundred CTAs.
template <int LOGC>
__host__ __device__ constexpr int seg_tile() {
  return LOGC == 0 ? 128 : 32;
}

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

// Segment totals of ncand candidates: pixel maxima in acc[c], error sums in
// acc[kBatch + c], at each segment's start. cand(i, c, s) gives block i's
// candidate c (the same for every member of a segment). An 8x8 block is
// read once per batch and each candidate reduced over the warp at once; a
// larger region is read chunk by chunk once per batch, each candidate's
// lane maxima and sums kept until the last chunk.
template <int CH, int LOGC, class Cand>
__device__ void eval_batch(const SegParams& P, SegShared& S, int a, int nl, int ncand,
                           const Cand& cand) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kBlkShift = kSegErrShift - block_err_scale<LOGC>();
  for (int e = tid; e < 2 * kBatch * kSegLanes; e += kSegThreads) {
    const int r = e / kSegLanes, i = e % kSegLanes;
    if (i < nl) S.acc[r][i] = r < kBatch ? (-2147483647 - 1) : 0;
  }
  __syncthreads();
      for (int ai = warp; ai < S.n_act; ai += kSegWarps) {
        const int i = S.act[ai];
        const size_t b = (size_t)(a + i);
        Block<CH> blk;
        setup_crush_block<CH, LOGC>(P, S, b, i, blk);
        const int at = S.seg[i];
        if constexpr (LOGC == 0) {
          load_crush_chunk<CH, LOGC>(P, b, 0, lane, blk);
          for (int c = 0; c < ncand; ++c) {
            int s[3];
            cand(i, c, s);
            int pm, be;
            blk.eval(s, pm, be);
            if (lane == 0) {
              atomicMax(&S.acc[c][at], pm);
              atomicAdd(&S.acc[kBatch + c][at], be >> kBlkShift);
            }
          }
        } else {
          int sv[kBatch], pm[kBatch], be[kBatch];
  #pragma unroll 1
          for (int c = 0; c < kBatch; ++c) {
            int s[3] = {0, 0, 0};
            if (c < ncand) cand(i, c, s);
            sv[c] = pack3(s);
            pm[c] = be[c] = 0;
          }
  #pragma unroll 1
          for (int k = 0; k < (1 << LOGC); ++k) {
            load_crush_chunk<CH, LOGC>(P, b, k, lane, blk);
  #pragma unroll 1
            for (int c = 0; c < kBatch; ++c) {
              if (c < ncand) {
                int s[3];
                unpack3(sv[c], s);
                eval_lane<CH>(blk, s, pm[c], be[c]);
              }
            }
          }
  #pragma unroll 1
          for (int c = 0; c < kBatch; ++c) {
            if (c < ncand) {
              const int pmw = __reduce_max_sync(kFull, pm[c]);
              const int bew = __reduce_add_sync(kFull, be[c]);
              if (lane == 0) {
                atomicMax(&S.acc[c][at], pmw);
                atomicAdd(&S.acc[kBatch + c][at], bew >> kBlkShift);
              }
            }
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
    S.acc[0][i] = 0;
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
  for (int i = tid; i < nl; i += kSegThreads) {
    S.st[S_BEST][i] = 0;
    S.st[S_TOT][i] = -1;
    S.st[S_ERR][i] = 2147483647;
    S.st[S_FPIX][i] = S.st[S_FBLK][i] = 0;
  }
  __syncthreads();
  const bool floors = P.crush_mode != kNone && P.num_factors < 3;
  if (floors) {
    eval_batch<CH, LOGC>(P, S, a, nl, 1, [](int, int, int (&s)[3]) { s[0] = s[1] = s[2] = 0; });
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
      eval_batch<CH, LOGC>(P, S, a, nl, kBatch, triple);
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
    eval_batch<CH, LOGC>(P, S, a, nl, 4, [](int, int c, int (&s)[3]) { guess_triple(c, s); });
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
      eval_batch<CH, LOGC>(P, S, a, nl, kBatch, [ax](int, int c, int (&s)[3]) {
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
      eval_batch<CH, LOGC>(P, S, a, nl, nc, cand);
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
    setup_crush_block<CH, LOGC>(P, S, b, i, blk);
    int best[3];
    unpack3(S.st[S_BEST][i], best);
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
