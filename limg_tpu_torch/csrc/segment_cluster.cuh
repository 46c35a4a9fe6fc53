// segment_encode at P >= 1024 for NVIDIA Hopper (sm_90a): the dense merged
// path's run buffers of levels 2 and up, whose lanes are regions of P = 64 *
// 4^l pixels (32x32 px and larger), instantiated by segment_region.cu. With
// segment_encode.cuh (P = 64 and 256, one warp a region) it replaces
// limg_tpu/pallas_kernels/encode_segments.py: segment_encode_pallas (:188,
// kernel :114, any P :205): refit, factors, crush search, dither and decode
// of the contiguous segments of the run buffer, bit for bit as the plain
// version (kernels/coalesce.py _segment_encode).
//
// What bounds it on the H100: operations (a fit and 35+ exact candidate
// decodes a member pixel at ladder K = 8; chip_smoke.py kernel_bound). What
// held the earlier design (one warp a region, a CTA a tile of segment
// starts) far from it: a 4K dense buffer holds a few large member regions
// (30 of 4,096 px, 7 of 16,384), so a few warps did all the work, each
// reading its region from device memory a chunk at a time, pass after pass.
// This design:
//
// 1. segment_prep_kernel reads the buffer's mask once: each segment's member
//    pixels; the plain version's outputs for an empty region (write_empty)
//    on every lane of a segment with none (memory-bound work over the whole
//    buffer); and a list, on the card, of the other segments.
// 2. segment_cluster_kernel: a thread-block cluster of cs CTAs (2 at P =
//    1024, 16 from 4096 on) takes one listed segment at a time from a
//    counter. Its regions are cut into items, each a subtree of the plain
//    version's halving tree over the region's 64-pixel chunks: 2^lgs
//    subtrees a region, as many as fill the cluster's W = 16 cs warps (at
//    least enough that an item folds at most 2^kFoldDepth chunks), item j =
//    (region j >> lgs, subtree j & (2^lgs - 1)) on warp j mod W, in rounds
//    of W items.
// 3. A warp copies its items' words and mask to shared memory once
//    (cp.async) and every pass reads them there; where they do not fit in
//    its stage, each pass streams them through the stage's two halves, the
//    next group's copy issued before this group is used.
// 4. Float sums keep the plain version's order: an item visits its chunks
//    in bit-reversed order and folds them as a binary counter in registers
//    (as ChunkTree does); the 2^lgs subtree vectors of a region then meet in
//    the same counter's order, in place in their warps' shared-memory slots:
//    a region's items lie on consecutive warps, so each CTA first folds its
//    own (up to 16), and the region's first warp then folds the CTAs'
//    results, read across the cluster (distributed shared memory), before
//    tree_sum. A region of more than W items (P above 4,194,304 on 16 CTAs)
//    takes several rounds: its first warp folds each round's vector with
//    those of the region's earlier rounds in the same counter's order.
//    Each region's values go to every CTA of the cluster, and each CTA
//    scans the segment (the doubling scan of ops/segments.py, fwd + bwd -
//    x) and keeps the region values and the crush search's state itself.
//    The crush's pixel maxima and wrapping error sums are order-free:
//    shared-memory atomics in the CTA, then one atomic per candidate into
//    every CTA of the cluster.
// 5. cluster.sync() stands where the earlier design had a CTA barrier:
//    after each pass of the fit, after each candidate batch.
// 6. A thread has at most 128 registers (512-thread CTAs): a lane's running
//    candidate maxima and sums live in shared memory (unrolled in
//    registers, the candidate loop spilled 1-3 KB a thread and ran 1.2-1.4x
//    slower, PERF.md), and where a batch's candidates differ in one
//    axis only (the ladder's sweeps, the exhaustive search's rows) the other
//    two axes' decode of a chunk is made once.

#pragma once

#include <cuda_pipeline.h>

#include "cluster.cuh"
#include "segment_encode.cuh"

namespace {

constexpr int kCWarps = 16;           // a CTA of 512 threads, at most 128 registers each
constexpr int kCThreads = kCWarps * 32;
constexpr int kBigLogc = 8;           // one instantiation for every P >= 16,384
constexpr int kMaxLogc = 24;          // P <= 64 << 24 (kernels/encode_fixed.py MAX_REGION_PIXELS)
constexpr int kFoldDepth = 8;         // an item folds at most 2^8 chunks
constexpr int kPrepTile = 128;       // the most segment starts a first-pass CTA takes
constexpr int kPrepLanes = kPrepTile + kSegCap - 1;   // the most lanes it covers
// 16-byte pieces of a chunk: its 64 words, 64 mask bytes, 64 packed factors
constexpr int kWordPieces = 16, kMaskPieces = 4, kF8Pieces = 16;
constexpr int kChunkBytes = kP * 4 + kP + kP * 4;

struct ClusterArgs {
  SegParams P;
  int4* list;   // (n,) the segments holding a member pixel: first lane, regions, member pixels
  int* work;    // [0] listed segments, [1] the next list entry to take (zeroed)
  int stage;    // chunks a warp stages in shared memory (even)
  int tile;     // segment starts a first-pass CTA takes
};

// The clusters' size at P = 64 << logc: P = 1024's 4K buffer lists ~200
// segments of 1-4 regions (small clusters, more of them at once); from P =
// 4096 on a buffer lists a few segments of up to tens of regions (the most
// warps on each).
__host__ __device__ constexpr int cluster_size(int logc) { return logc == 4 ? 2 : kMaxCluster; }

// Region value rows (float), after the segment scans.
enum : int {
  R_AVG = 0, R_DIRA = 4, R_DIRB = 8, R_DIRC = 12, R_MN = 16, R_MX = 19, kRegionRows = 22,
};

struct ClusterShared {
  float sx[2][6][kSegCap];        // regions' values, by pass parity (written by the cluster)
  float sf[6][kSegCap], sb[6][kSegCap];   // the scan's forward and backward rows
  float rv[kRegionRows][kSegCap]; // region values
  float slot[kCWarps][4 * kP];    // each warp's item partials, read across the cluster
  // each lane's candidate pixel maxima and error sums; outside a crush
  // batch, the partials of a region's rounds of items (fold_rounds)
  int lane_acc[kCWarps][2][kBatch][32];
  int seg_pm[2][kBatch], seg_be[2][kBatch];   // the segment's candidate totals, by batch parity
  int cta_pm[kBatch], cta_be[kBatch];         // this CTA's share of them
  int cand[kMaxK];                // ladder candidates, packed
  int best, tot, err, fpix, fblk; // the segment's running best and floors
  LadderBox box;
  int entry;                      // the list entry the cluster works on
};

// a region has at most 2^kMaxLogc chunks, so at most 2^(kMaxLogc - 4) / cs
// rounds of items: kMaxLogc - 4 counter levels of 4 vectors a lane
static_assert(sizeof(ClusterShared::lane_acc) >= (kMaxLogc - 4) * 4 * 2 * 32 * sizeof(float),
              "fold_rounds' partials fit in lane_acc");

__host__ __device__ constexpr size_t cluster_smem(int stage) {
  return (sizeof(ClusterShared) + 15) / 16 * 16 + (size_t)kCWarps * stage * kChunkBytes;
}

// ChunkTree's binary counter over an item's chunks, its depth (at most D)
// at run time; the partials stay in registers.
template <int D, int N>
struct Fold {
  float part[D][N][2];

  __device__ __forceinline__ void fold(int t, int depth, float (&v)[N][2]) {
    bool open = true;
#pragma unroll
    for (int l = 0; l < D; ++l) {
      if (open && l < depth) {
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

// Axis k's part of decode_est (limg_common.cuh) for pixel j of a block at
// shift s, added to est.
template <int CH>
__device__ __forceinline__ void axis_decode(const Block<CH>& blk, int k, int s, int j,
                                            int (&est)[CH]) {
  const int fdec = (blk.f8[k][j] >> min(s, 8)) * mult_for(min(s, 8));
  const bool dropped = s > 7;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int n = dropped ? 0 : blk.n_int[k][c];
    const int m = (k == 0 || !dropped) ? blk.m_int[k][c] : 0;
    est[c] += m + ((fdec * n + 128) >> 8);
  }
}

// Region i's values a fit step needs, from the region rows.
template <int CH>
struct RegionFit {
  float avg[CH], dir_a[CH], dir_b[CH], dir_c[CH];
  __device__ void load(const ClusterShared& S, int i, int upto) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      avg[c] = S.rv[R_AVG + c][i];
      dir_a[c] = upto >= 1 ? S.rv[R_DIRA + c][i] : 0.0f;
      dir_b[c] = upto >= 2 ? S.rv[R_DIRB + c][i] : 0.0f;
      dir_c[c] = upto >= 3 ? S.rv[R_DIRC + c][i] : 0.0f;
    }
  }
};

// The first pass: one CTA takes the segments that start in its tile of
// lanes (at most kPrepLanes lanes), a warp a lane at a time.
template <int CH, int LOGC>
__global__ void __launch_bounds__(kCThreads)
segment_prep_kernel(const __grid_constant__ ClusterArgs A) {
  const SegParams& P = A.P;
  __shared__ int range[2];
  __shared__ int seg_l[kPrepLanes], cnt[kPrepLanes], tot[kPrepLanes];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int logc = LOGC < kBigLogc ? LOGC : P.logc;
  const int npix = kP << logc;
  const int lo = blockIdx.x * A.tile, hi = min(lo + A.tile, P.n);
  if (tid < 2) range[tid] = P.n;
  __syncthreads();
  for (int t = tid; t < 2 * kSegCap; t += kCThreads) {
    const int g = (t < kSegCap ? lo : hi) + t % kSegCap;
    if (g < P.n && P.seg[g] == g) atomicMin(&range[t / kSegCap], g);
  }
  __syncthreads();
  const int a = range[0];
  const int nl = min(range[1] - a, kPrepLanes);
  if (nl <= 0) return;  // uniform: no segment starts here
  for (int i = tid; i < nl; i += kCThreads) {
    const int s = P.seg[a + i] - a;
    seg_l[i] = (s < 0 || s > i) ? i : s;
    tot[i] = 0;
  }
  // each lane's member pixels (mask bytes are 0 or 1)
  for (int i = warp; i < nl; i += kCWarps) {
    const uint4* m = reinterpret_cast<const uint4*>(P.mask + ((size_t)(a + i) << logc) * kP);
    int c = 0;
#pragma unroll 4
    for (int v = lane; v < npix / 16; v += 32) {
      const uint4 x = m[v];
      c += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
    }
    c = __reduce_add_sync(kFull, c);
    if (lane == 0) cnt[i] = c;
  }
  __syncthreads();
  for (int i = tid; i < nl; i += kCThreads)
    if (cnt[i] > 0) atomicAdd(&tot[seg_l[i]], cnt[i]);
  __syncthreads();
  // list a segment with a member pixel at its last lane
  for (int i = tid; i < nl; i += kCThreads) {
    const int s = seg_l[i];
    if (tot[s] > 0 && (i == nl - 1 || seg_l[i + 1] != s))
      A.list[atomicAdd(&A.work[0], 1)] = make_int4(a + s, i - s + 1, tot[s], 0);
  }
  // write_empty (segment_encode.cuh) on every lane of a segment with none
  const int zero[CH][2] = {};
  const int dec0 = pack_decoded<CH>(zero, 0);
  for (int i = warp; i < nl; i += kCWarps) {
    if (tot[seg_l[i]] > 0) continue;
    const size_t b = (size_t)(a + i);
    int4* dec = reinterpret_cast<int4*>(P.dec + (b << logc) * kP);
    int4* q = P.q != nullptr ? reinterpret_cast<int4*>(P.q + (b << logc) * kP) : nullptr;
#pragma unroll 4
    for (int v = lane; v < npix / 4; v += 32) {
      dec[v] = make_int4(dec0, dec0, dec0, dec0);
      if (q != nullptr) q[v] = make_int4(0, 0, 0, 0);
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
}

// One segment's work on one CTA of the cluster.
template <int CH, int LOGC>
struct SegCluster {
  static constexpr int kDepth = LOGC < kBigLogc ? LOGC : kFoldDepth;
  // only the run-time chunk count gives a region more items than W
  static constexpr bool kRounds = LOGC >= kBigLogc;

  const SegParams& P;
  ClusterShared& S;
  int* sw;        // this warp's stage: words, packed factors (stage x 64 each), mask
  int* sf8;
  uint8_t* sm;
  int stage, cs, rank, W, gw, warp, lane, tid, logc;
  // the segment: first lane, regions, member pixels; log2 of the subtrees a
  // region and of the chunks an item; items, rounds of W items; whether the
  // warp's chunks stay staged; the parities of the passes and batches
  int a, nreg, count, lgs, lgper, items, rounds;
  bool resident;
  int pass, batch;

  __device__ int chunk(int u, int t) const { return bit_rev(u, lgs) + (bit_rev(t, lgper) << lgs); }
  __device__ size_t first_pixel(int r, int k) const {
    return (((size_t)(a + r) << logc) + (size_t)k) * kP;
  }

  // Picks the items of the segment of `nr` regions at `first` for W warps.
  __device__ void begin(int first, int nr, int members) {
    a = first;
    nreg = nr;
    count = members;
    int par = 0;
    while ((nr << (par + 1)) <= W) ++par;
    lgs = min(logc, max(logc - kDepth, par));
    lgper = logc - lgs;
    items = nr << lgs;
    rounds = (items + W - 1) / W;
    resident = (rounds << lgper) <= stage;
    pass = batch = 0;
    if (tid < kBatch) {
      S.seg_pm[0][tid] = S.seg_pm[1][tid] = S.cta_pm[tid] = -2147483647 - 1;
      S.seg_be[0][tid] = S.seg_be[1][tid] = S.cta_be[tid] = 0;
    }
    if (resident) {
#pragma unroll 1
      for (int rho = 0; rho < rounds; ++rho) {
        const int j = rho * W + gw;
        if (j < items) issue(j >> lgs, j & ((1 << lgs) - 1), 0, 1 << lgper, rho << lgper, false);
      }
      __pipeline_wait_prior(0);
      __syncwarp();
    }
  }

  // Copies chunks [t0, t1) of item (r, u) to stage slots s0 ..., with their
  // packed factors if f8, as one commit group.
  __device__ void issue(int r, int u, int t0, int t1, int s0, bool f8) const {
    const int pieces = kWordPieces + kMaskPieces + (f8 ? kF8Pieces : 0);
#pragma unroll 1
    for (int p = lane; p < (t1 - t0) * pieces; p += 32) {
      const int ci = p / pieces, q = p - ci * pieces, s = s0 + ci;
      const size_t px = first_pixel(r, chunk(u, t0 + ci));
      if (q < kWordPieces) {
        __pipeline_memcpy_async(sw + s * kP + 4 * q, P.packed + px + 4 * q, 16);
      } else if (q < kWordPieces + kMaskPieces) {
        const int o = 16 * (q - kWordPieces);
        __pipeline_memcpy_async(sm + s * kP + o, P.mask + px + o, 16);
      } else {
        const int o = 4 * (q - kWordPieces - kMaskPieces);
        __pipeline_memcpy_async(sf8 + s * kP + o, P.f8 + px + o, 16);
      }
    }
    __pipeline_commit();
  }

  // f(t, k, s) for the chunks of item (r, u) of round rho in fold order: t
  // the chunk's place in the item, k its index in the region, s its stage
  // slot.
  template <class F>
  __device__ void for_chunks(int rho, int r, int u, bool f8, F&& f) const {
    const int per = 1 << lgper;
    if (resident) {
#pragma unroll 1
      for (int t = 0; t < per; ++t) f(t, chunk(u, t), (rho << lgper) + t);
      return;
    }
    const int half = stage / 2;
    const int groups = (per + half - 1) / half;
    issue(r, u, 0, min(half, per), 0, f8);
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      const int t0 = g * half, t1 = min(t0 + half, per);
      if (g + 1 < groups) {
        issue(r, u, t1, min(t1 + half, per), ((g + 1) & 1) * half, f8);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncwarp();
#pragma unroll 1
      for (int t = t0; t < t1; ++t) f(t, chunk(u, t), (g & 1) * half + t - t0);
      __syncwarp();  // the slots are copied to again
    }
  }

  __device__ void pixels(int s, Pixels<CH>& p) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = s * kP + lane + 32 * j;
      p.set(j, (uint32_t)sw[i], true);
      p.mask[j] = sm[i] != 0 ? 1 : 0;
      p.mf[j] = (float)p.mask[j];
    }
  }

  // item(rho, r, u) on this warp's items. Where a region has several items
  // (its 2^lgs items lie on consecutive warps, g = min(2^lgs, 16) of them in
  // each CTA): once every item of the round is in its slot, local(j0, r, g,
  // whole) on the warp of each CTA's first item j0 of the region, to fold
  // the g slots of the CTA (whole: they are the region's); then, from 32
  // items on, owner(j0, r, n, rr, nr) on the warp of the region's first
  // item of the round, to fold the n = min(2^lgs, W) / 16 CTAs' results, in
  // the slots of items j0, j0 + 16, ... (distributed shared memory): round
  // rr of the region's nr (nr > 1: more items than W, see fold_rounds). A
  // cluster barrier ends the round.
  template <class Item, class Local, class Owner>
  __device__ void for_items(Item&& item, Local&& local, Owner&& owner) const {
    const int sub = 1 << lgs, g = min(sub, kCWarps), span = kRounds ? min(sub, W) : sub;
#pragma unroll 1
    for (int rho = 0; rho < rounds; ++rho) {
      const int j = rho * W + gw;
      if (j < items) item(rho, j >> lgs, j & (sub - 1));
      if (sub > 1) {
        __syncthreads();
        if (j < items && (j & (g - 1)) == 0) local(j, j >> lgs, g, sub == g);
        if (sub > g) {
          cluster_sync();
          if (j < items && (j & (span - 1)) == 0)
            owner(j, j >> lgs, span / g, (j & (sub - 1)) / span, sub / span);
        }
        cluster_sync();
      }
    }
  }

  // Round rr's vector of a region of nr rounds (the lane's two positions
  // each, in v) folded with those of its earlier rounds in the binary
  // counter's order; the partials wait in lane_acc, which no crush batch
  // uses meanwhile. True at the last round, with the region's vector in v.
  template <int N>
  __device__ bool fold_rounds(int rr, int nr, float (&v)[N][2]) const {
    float* part = reinterpret_cast<float*>(&S.lane_acc[0][0][0][0]);
    int l = 0;
#pragma unroll 1
    for (; (rr >> l) & 1; ++l) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) v[n][j] = part[(l * 2 * N + 2 * n + j) * 32 + lane] + v[n][j];
      }
    }
    if (rr + 1 == nr) return true;
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) part[(l * 2 * N + 2 * n + j) * 32 + lane] = v[n][j];
    }
    return false;
  }

  // Item j's slot (in the CTA of the warp that holds it).
  __device__ float* slot_of(int j) const {
    const int w = j % W;
    return at_rank(&S.slot[w % kCWarps][0], w / kCWarps);
  }

  // Region r's N values into row n of sx[pass & 1] in every CTA.
  template <int N>
  __device__ void bcast(int r, const float (&v)[N]) const {
#pragma unroll 1
    for (int rk = lane; rk < cs; rk += 32) {
      float* x = at_rank(&S.sx[pass & 1][0][0], rk);
#pragma unroll
      for (int n = 0; n < N; ++n) x[n * kSegCap + r] = v[n];
    }
  }

  // The subtree vectors (lane's two positions each) in the slots of items
  // j0, j0 + step, ... (cnt of them) folded in the binary counter's order,
  // in place: the partial of level l stays in the slot that closed it.
  template <int N>
  __device__ void fold_slots(int j0, int step, int cnt, float (&v)[N][2]) const {
#pragma unroll 1
    for (int u = 0; u < cnt; ++u) {
      float* su = slot_of(j0 + u * step);
#pragma unroll
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) v[n][j] = su[(2 * n + j) * 32 + lane];
      }
#pragma unroll 1
      for (int l = 0; (u >> l) & 1; ++l) {
        const float* sp = slot_of(j0 + (u - (1 << l)) * step);
#pragma unroll
        for (int n = 0; n < N; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) v[n][j] = sp[(2 * n + j) * 32 + lane] + v[n][j];
        }
      }
      if (u + 1 < cnt) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) su[(2 * n + j) * 32 + lane] = v[n][j];
        }
      }
    }
  }

  // Each region's sums of N per-pixel values in the plain version's order
  // into sx[pass & 1] of every CTA: load(r) gives an item's region context
  // x, terms(x, s, v) this lane's two pixels' values of stage slot s.
  template <int N, class Load, class Terms>
  __device__ void region_sums(Load&& load, Terms&& terms) const {
    for_items([&](int rho, int r, int u) {
      const auto x = load(r);
      Fold<kDepth, N> tree;
      float v[N][2];
      for_chunks(rho, r, u, false, [&](int t, int, int s) {
        terms(x, s, v);
        tree.fold(t, lgper, v);
      });
      if (lgs == 0) total<N>(r, v);
      else keep<N>(v);
    }, [&](int j0, int r, int g, bool whole) {
      float v[N][2];
      fold_slots<N>(j0, 1, g, v);
      if (whole) total<N>(r, v);
      else keep<N>(v);
    }, [&](int j0, int r, int n, int rr, int nr) {
      float v[N][2];
      fold_slots<N>(j0, kCWarps, n, v);
      if (!kRounds || nr == 1 || fold_rounds<N>(rr, nr, v)) total<N>(r, v);
    });
    if (lgs == 0) cluster_sync();
  }

  // A region's position sums to its sums in every CTA.
  template <int N>
  __device__ void total(int r, const float (&v)[N][2]) const {
    float sum[N];
#pragma unroll
    for (int n = 0; n < N; ++n) sum[n] = tree_sum(v[n][0], v[n][1]);
    bcast<N>(r, sum);
  }

  // A subtree's position sums to this warp's slot.
  template <int N>
  __device__ void keep(const float (&v)[N][2]) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) S.slot[warp][(2 * n + j) * 32 + lane] = v[n][j];
    }
  }

  // The doubling scan of ops/segments.py over the segment's regions, in
  // place on rows [0, NROWS) of x: sums on [0, NSUM), max on the rest (the
  // plain version's fwd + bwd - x and max(fwd, bwd); a step's partner
  // outside the segment is skipped). A segment of up to 32 regions is a
  // warp's shuffles a row, a longer one the CTA's steps over sf / sb.
  template <int NROWS, int NSUM>
  __device__ void scan(float (*x)[kSegCap]) {
    const int n = nreg;
    if (n <= 32) {
      if (warp < NROWS) {
        const bool sum = warp < NSUM;
        const float xv = lane < n ? x[warp][lane] : 0.0f;
        float f = xv, b = xv;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float pf = __shfl_up_sync(kFull, f, d), pb = __shfl_down_sync(kFull, b, d);
          if (lane >= d) f = sum ? f + pf : fmaxf(f, pf);
          if (lane + d < n) b = sum ? b + pb : fmaxf(b, pb);
        }
        if (lane < n) x[warp][lane] = sum ? (f + b) - xv : fmaxf(f, b);
      }
    } else {
      constexpr int kPer = (NROWS * kSegCap + kCThreads - 1) / kCThreads;
      for (int e = tid; e < NROWS * n; e += kCThreads) {
        const int row = e / n, i = e - row * n;
        S.sf[row][i] = S.sb[row][i] = x[row][i];
      }
      __syncthreads();
#pragma unroll 1
      for (int d = 1; d < n; d <<= 1) {
        float nf[kPer], nbk[kPer];
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int e = tid + q * kCThreads;
          if (e < NROWS * n) {
            const int row = e / n, i = e - row * n;
            const bool sum = row < NSUM;
            const float* sf = S.sf[row];
            const float* sb = S.sb[row];
            nf[q] = i >= d ? (sum ? sf[i] + sf[i - d] : fmaxf(sf[i], sf[i - d])) : sf[i];
            nbk[q] = i + d < n ? (sum ? sb[i] + sb[i + d] : fmaxf(sb[i], sb[i + d])) : sb[i];
          }
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int e = tid + q * kCThreads;
          if (e < NROWS * n) {
            const int row = e / n, i = e - row * n;
            S.sf[row][i] = nf[q];
            S.sb[row][i] = nbk[q];
          }
        }
        __syncthreads();
      }
      for (int e = tid; e < NROWS * n; e += kCThreads) {
        const int row = e / n, i = e - row * n;
        x[row][i] = row < NSUM ? (S.sf[row][i] + S.sb[row][i]) - x[row][i]
                               : fmaxf(S.sf[row][i], S.sb[row][i]);
      }
    }
    __syncthreads();
  }

  // The scanned sums of the last pass over the member count, to region rows
  // [row, row + N).
  template <int N>
  __device__ void finish_means(int row) {
    float (*x)[kSegCap] = S.sx[pass & 1];
    scan<N, N>(x);
    const float ic = 1.0f / fmaxf((float)count, 1.0f);
    for (int i = tid; i < nreg; i += kCThreads) {
#pragma unroll
      for (int c = 0; c < N; ++c) S.rv[row + c][i] = x[c][i] * ic;
    }
    __syncthreads();
    ++pass;
  }

  // The fit: channel sums, the three directions, factor extremes, then
  // endpoints and factors (to the stage, or to the f8 scratch plane).
  __device__ void fit() {
    region_sums<CH>([](int) { return 0; }, [&](int, int s, float (&v)[CH][2]) {
      Pixels<CH> p;
      pixels(s, p);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int j = 0; j < 2; ++j) v[c][j] = p.pxf[c][j] * p.mf[j];
      }
    });
    finish_means<CH>(R_AVG);
    constexpr int kSteps = CH == 4 ? 3 : 2;
#pragma unroll 1
    for (int step = 1; step <= kSteps; ++step) {
      region_sums<CH>([&](int r) {
        RegionFit<CH> rf;
        rf.load(S, r, step - 1);
        return rf;
      }, [&](const RegionFit<CH>& rf, int s, float (&t)[CH][2]) {
        Pixels<CH> p;
        pixels(s, p);
        FitSteps<CH> fs;
        fs.center(p, rf.avg);
        if (step == 1) {
          unit_vector_terms<CH>(fs.corrected, p.mf, t);
        } else {
          fs.axis_a(p, rf.avg, rf.dir_a);
          if (step == 2) {
            unit_vector_terms<CH>(fs.resid_a, p.mf, t);
          } else {
            fs.axis_b(p, rf.dir_b);
            unit_vector_terms<CH>(fs.resid_ab, p.mf, t);
          }
        }
      });
      finish_means<CH>(step == 1 ? R_DIRA : (step == 2 ? R_DIRB : R_DIRC));
    }
    if (CH == 3) {
      for (int i = tid; i < nreg; i += kCThreads) {
        RegionFit<CH> rf;
        rf.load(S, i, 2);
        FitSteps<CH>::cross(rf.dir_a, rf.dir_b, rf.dir_c);
#pragma unroll
        for (int c = 0; c < CH; ++c) S.rv[R_DIRC + c][i] = rf.dir_c[c];
      }
      __syncthreads();
    }

    // factor extremes (min as -max(-x)); order-free (a region's earlier
    // rounds' extremes wait in ext_rounds, lanes 0-5 of its first warp)
    float ext_rounds = 0.0f;
    for_items([&](int rho, int r, int u) {
      RegionFit<CH> rf;
      rf.load(S, r, 3);
      const float inv_c = inv_or_zero(dot_self<CH>(rf.dir_c));
      float mn[3], mx[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        mn[e] = kBig;
        mx[e] = -kBig;
      }
      for_chunks(rho, r, u, false, [&](int, int, int s) {
        Pixels<CH> p;
        pixels(s, p);
        FitSteps<CH> fs;
        fs.center(p, rf.avg);
        fs.axis_a(p, rf.avg, rf.dir_a);
        fs.axis_b(p, rf.dir_b);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float f[3] = {fs.fac_a[j], fs.fac_b[j],
                              project<CH>(fs.resid_ab, j, rf.dir_c, inv_c) * p.mf[j]};
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            mn[e] = fminf(mn[e], p.mask[j] ? f[e] : kBig);
            mx[e] = fmaxf(mx[e], p.mask[j] ? f[e] : -kBig);
          }
        }
      });
      float ext[6];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        ext[e] = -warp_min(mn[e]);
        ext[3 + e] = warp_max(mx[e]);
      }
      if (lgs == 0) {
        bcast<6>(r, ext);
      } else if (lane == 0) {
#pragma unroll
        for (int e = 0; e < 6; ++e) S.slot[warp][e] = ext[e];
      }
    }, [&](int j0, int r, int g, bool whole) {
      const float x = max_slots(j0, 1, g);
      if (whole) bcast_ext(r, x);
      else if (lane < 6) S.slot[warp][lane] = x;
    }, [&](int j0, int r, int n, int rr, int nr) {
      float x = max_slots(j0, kCWarps, n);
      if (kRounds && rr > 0) x = fmaxf(ext_rounds, x);
      if (!kRounds || rr + 1 == nr) bcast_ext(r, x);
      else ext_rounds = x;
    });
    if (lgs == 0) cluster_sync();
    {
      float (*x)[kSegCap] = S.sx[pass & 1];
      scan<6, 0>(x);
      for (int i = tid; i < nreg; i += kCThreads) {
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          S.rv[R_MN + e][i] = -x[e][i];
          S.rv[R_MX + e][i] = x[3 + e][i];
        }
      }
      __syncthreads();
      ++pass;
    }

    // endpoints and factors; the endpoint and avg rows
#pragma unroll 1
    for (int rho = 0; rho < rounds; ++rho) {
      const int j = rho * W + gw;
      if (j >= items) break;
      const int r = j >> lgs, u = j & ((1 << lgs) - 1);
      int ep[6][CH];
      endpoints(r, ep);
      for_chunks(rho, r, u, false, [&](int, int k, int s) {
        Pixels<CH> p;
        pixels(s, p);
        int f8[3][2];
        extract_factors<CH>(p, ep, f8);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int w = f8[0][jj] | (f8[1][jj] << 8) | (f8[2][jj] << 16);
          if (resident) sf8[s * kP + lane + 32 * jj] = w;
          else P.f8[first_pixel(r, k) + lane + 32 * jj] = w;
        }
      });
      if (u == 0) {
        drop_axes<CH>(ep, P.num_factors);
        const size_t b = (size_t)(a + r);
        // lane c writes channel c of the six endpoint rows and avg
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          if (c != lane) continue;
#pragma unroll
          for (int e = 0; e < 6; ++e) P.eps[((size_t)e * CH + c) * P.n + b] = ep[e][c];
          P.avg[(size_t)c * P.n + b] = S.rv[R_AVG + c][r];
        }
      }
    }
    __syncwarp();  // the factors are read back by other lanes
  }

  // Lane e's (< 6) extreme over the slots of items j0, j0 + step, ... (cnt).
  __device__ float max_slots(int j0, int step, int cnt) const {
    float x = lane < 6 ? slot_of(j0)[lane] : 0.0f;
#pragma unroll 1
    for (int u = 1; u < cnt; ++u) x = fmaxf(x, lane < 6 ? slot_of(j0 + u * step)[lane] : 0.0f);
    return x;
  }

  // Region r's six extremes (lane e holds extreme e) to every CTA.
  __device__ void bcast_ext(int r, float x) const {
    float ext[6];
#pragma unroll
    for (int e = 0; e < 6; ++e) ext[e] = __shfl_sync(kFull, x, e);
    bcast<6>(r, ext);
  }

  // Region r's rounded endpoints (before the dropped axes are zeroed).
  __device__ void endpoints(int r, int (&ep)[6][CH]) const {
    RegionFit<CH> rf;
    rf.load(S, r, 3);
    float mn[3], mx[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      mn[e] = S.rv[R_MN + e][r];
      mx[e] = S.rv[R_MX + e][r];
    }
    round_endpoints<CH>(count, rf.avg, rf.dir_a, rf.dir_b, rf.dir_c, mn, mx, ep);
  }

  // Region r as the crush search evaluates it; crush_chunk adds a chunk.
  __device__ void crush_block(int r, Block<CH>& blk) const {
    int ep[6][CH];
    endpoints(r, ep);
    drop_axes<CH>(ep, P.num_factors);
    blk.set_endpoints(ep);
    blk.count = count;
    blk.max_pix = P.max_pix;
    blk.max_blk = P.max_blk;
    blk.es = logc >= 5 ? 4 : 0;   // block_err_scale: P >= 2048
    blk.seg_shift = kSegErrShift - blk.es;
    blk.floors = false;
    blk.floor_pix = blk.floor_blk = 0;
  }

  __device__ void crush_chunk(int s, Block<CH>& blk) const {
    Pixels<CH> p;
    pixels(s, p);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      blk.mask[j] = p.mask[j];
#pragma unroll
      for (int c = 0; c < CH; ++c) blk.px[c][j] = p.px[c][j];
      const int w = sf8[s * kP + lane + 32 * j];
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3) blk.f8[k3][j] = (w >> (8 * k3)) & 0xFF;
    }
  }

  // The segment's totals of ncand candidates (cand(c, s): the segment's
  // c-th): pixel maxima in seg_pm[parity][c], error sums (each region's
  // wrapping sum shifted before the segment's) in seg_be[parity][c], in
  // every CTA; returns the parity. Where the candidates differ only in the
  // shift of axis `sweep` (a ladder sweep, an exhaustive batch), the other
  // two axes' decode of a chunk is made once for all of them (integer
  // sums: the same estimates in any order).
  template <class Cand>
  __device__ int crush_batch(int ncand, const Cand& cand, int sweep = -1) {
    const int par = batch++ & 1;
    const int blk_shift = kSegErrShift - (logc >= 5 ? 4 : 0);
    if (tid < kBatch) {   // read by this CTA in the last batch; refilled in the next
      S.seg_pm[par ^ 1][tid] = -2147483647 - 1;
      S.seg_be[par ^ 1][tid] = 0;
    }
    // a lane's running maxima and sums of the candidates in shared memory,
    // so that the candidate loop need not be unrolled (it spilled)
    int (&pm)[kBatch][32] = S.lane_acc[warp][0];
    int (&be)[kBatch][32] = S.lane_acc[warp][1];
    int be_rounds = 0;   // a region's earlier rounds' wrapping sum (lane c: candidate c)
    for_items([&](int rho, int r, int u) {
      Block<CH> blk;
      crush_block(r, blk);
#pragma unroll 1
      for (int c = 0; c < ncand; ++c) pm[c][lane] = be[c][lane] = 0;
      for_chunks(rho, r, u, true, [&](int, int, int s) {
        crush_chunk(s, blk);
        if (sweep < 0) {
#pragma unroll 1
          for (int c = 0; c < ncand; ++c) {
            int s3[3];
            cand(c, s3);
            int m = pm[c][lane], e = be[c][lane];
            eval_lane<CH>(blk, s3, m, e);
            pm[c][lane] = m;
            be[c][lane] = e;
          }
          return;
        }
        int s0[3], base[2][CH] = {};
        cand(0, s0);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (k == sweep) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j) axis_decode<CH>(blk, k, s0[k], j, base[j]);
        }
#pragma unroll 1
        for (int c = 0; c < ncand; ++c) {
          int s3[3];
          cand(c, s3);
          int m = pm[c][lane], e = be[c][lane];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            int est[CH];
#pragma unroll
            for (int ch = 0; ch < CH; ++ch) est[ch] = base[j][ch];
#pragma unroll
            for (int k = 0; k < 3; ++k)
              if (k == sweep) axis_decode<CH>(blk, k, s3[k], j, est);
            const int err = blk.weighted_err(est, j) * blk.mask[j];
            m = max(m, err);
            e = add_wrap(e, err >> blk.es);
          }
          pm[c][lane] = m;
          be[c][lane] = e;
        }
      });
#pragma unroll 1
      for (int c = 0; c < ncand; ++c) {
        const int pmw = __reduce_max_sync(kFull, pm[c][lane]);
        const int bew = __reduce_add_sync(kFull, be[c][lane]);
        if (lane == 0) {
          atomicMax(&S.cta_pm[c], pmw);
          if (lgs == 0) atomicAdd(&S.cta_be[c], bew >> blk_shift);
          else reinterpret_cast<int*>(S.slot[warp])[c] = bew;
        }
      }
    }, [&](int j0, int, int g, bool whole) {
      if (lane < ncand) {
        const int sum = sum_slots(j0, 1, g, lane);
        if (whole) atomicAdd(&S.cta_be[lane], sum >> blk_shift);
        else reinterpret_cast<int*>(S.slot[warp])[lane] = sum;
      }
    }, [&](int j0, int, int n, int rr, int nr) {
      if (lane < ncand) {
        int sum = sum_slots(j0, kCWarps, n, lane);
        if (kRounds && rr > 0) sum = add_wrap(be_rounds, sum);
        if (!kRounds || rr + 1 == nr) atomicAdd(&S.cta_be[lane], sum >> blk_shift);
        else be_rounds = sum;
      }
    });
    __syncthreads();
    for (int q = tid; q < ncand * cs; q += kCThreads) {
      const int c = q % ncand, rk = q / ncand;
      atomicMax(at_rank(&S.seg_pm[par][c], rk), S.cta_pm[c]);
      atomicAdd(at_rank(&S.seg_be[par][c], rk), S.cta_be[c]);
    }
    __syncthreads();
    if (tid < kBatch) {
      S.cta_pm[tid] = -2147483647 - 1;
      S.cta_be[tid] = 0;
    }
    cluster_sync();
    return par;
  }

  // The wrapping sum of int e of the slots of items j0, j0 + step, ... (cnt).
  __device__ int sum_slots(int j0, int step, int cnt, int e) const {
    int sum = 0;
#pragma unroll 1
    for (int u = 0; u < cnt; ++u)
      sum = add_wrap(sum, reinterpret_cast<const int*>(slot_of(j0 + u * step))[e]);
    return sum;
  }

  __device__ SegAdm adm(bool floors) const {
    return SegAdm{count, P.max_pix, P.max_blk, S.fpix, S.fblk, floors};
  }

  // Folds candidate c of the last batch (parity par) into the running best.
  __device__ void take(int par, int c, const int (&s)[3], const SegAdm& ad, bool ties_to_later) {
    int best[3];
    unpack3(S.best, best);
    take_if_better(ad, s, S.seg_pm[par][c], S.seg_be[par][c], ties_to_later, best, S.tot, S.err);
    S.best = pack3(best);
  }

  // The crush search (ops/crush.py cores, region values = segment totals):
  // one decision for the segment, kept by every CTA.
  __device__ void search() {
    if (tid == 0) {
      S.best = 0;
      S.tot = -1;
      S.err = 2147483647;
      S.fpix = S.fblk = 0;
    }
    __syncthreads();
    const bool floors = P.crush_mode != kNone && P.num_factors < 3;
    if (floors) {
      const int par = crush_batch(1, [](int, int (&s)[3]) { s[0] = s[1] = s[2] = 0; });
      if (tid == 0) {
        S.fpix = S.seg_pm[par][0];
        S.fblk = S.seg_be[par][0];
      }
      __syncthreads();
    }
    if (P.crush_mode == kExhaustive) {
      // all 729 triples in ascending lex order; ties to later
#pragma unroll 1
      for (int i0 = 0; i0 < 729; i0 += kBatch) {
        const auto triple = [i0](int c, int (&s)[3]) {
          s[0] = (i0 + c) / 81;
          s[1] = ((i0 + c) / 9) % 9;
          s[2] = (i0 + c) % 9;
        };
        const int par = crush_batch(kBatch, triple, 2);   // (s0, s1) shared, s2 = 0 .. 8
        if (tid == 0) {
          const SegAdm ad = adm(floors);
          for (int c = 0; c < kBatch; ++c) {
            int s[3];
            triple(c, s);
            take(par, c, s, ad, true);
          }
        }
        __syncthreads();
      }
    } else if (P.crush_mode == kGuess) {
      const int par = crush_batch(4, [](int c, int (&s)[3]) { guess_triple(c, s); });
      if (tid == 0) {
        const SegAdm ad = adm(floors);
        bool ok[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) ok[t] = ad(S.seg_pm[par][t], S.seg_be[par][t]);
        int best[3] = {0, 0, 0};
        const int pick = guess_pick(ok);
        if (pick >= 0) guess_triple(pick, best);
        S.best = pack3(best);
      }
      __syncthreads();
    } else if (P.crush_mode == kLadder) {
      // 27 per-axis sweeps, one axis a batch -> the ladder box
#pragma unroll 1
      for (int ax = 0; ax < 3; ++ax) {
        const int par = crush_batch(kBatch, [ax](int c, int (&s)[3]) {
          s[0] = s[1] = s[2] = 0;
          s[ax] = c;
        }, ax);
        if (tid == 0) {
          int pm_ax[9], be_ax[9];
#pragma unroll
          for (int s = 0; s < 9; ++s) {
            pm_ax[s] = S.seg_pm[par][s];
            be_ax[s] = S.seg_be[par][s];
          }
          ladder_axis(S.box, ax, pm_ax, be_ax, adm(floors));
        }
        __syncthreads();
      }
      // lattice keys and the K best candidates
      if (warp == 0) {
        const LadderBox box = S.box;
        int key[2];
        ladder_keys(box, adm(floors), lane, key);
        for (int r = 0; r < P.ladder_k; ++r) {
          int s[3];
          ladder_peel(key, box, lane, s);
          if (lane == 0) S.cand[r] = pack3(s);
        }
      }
      __syncthreads();
      // exact verification, best-ranked first
#pragma unroll 1
      for (int r0 = 0; r0 < P.ladder_k; r0 += kBatch) {
        const int nc = min(kBatch, P.ladder_k - r0);
        const auto cand = [this, r0](int c, int (&s)[3]) { unpack3(S.cand[r0 + c], s); };
        const int par = crush_batch(nc, cand);
        if (tid == 0) {
          const SegAdm ad = adm(floors);
          for (int c = 0; c < nc; ++c) {
            int s[3];
            cand(c, s);
            take(par, c, s, ad, false);
          }
        }
        __syncthreads();
      }
    }
  }

  // Dither, decode and the outputs.
  __device__ void finish() {
    int best[3];
    unpack3(S.best, best);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k >= P.num_factors) best[k] = max(best[k], 8);  // statically dropped axes
    const auto outputs = [&](int r, float dist, int cnt) {
      const size_t b = (size_t)(a + r);
#pragma unroll
      for (int k = 0; k < 3; ++k) P.shifts[(size_t)k * P.n + b] = best[k];
      P.dist_blk[b] = dist;
      P.count_blk[b] = cnt;
      P.count_mem[b] = count;
    };
    int cnt_rounds = 0;   // a region's earlier rounds' member pixels
    for_items([&](int rho, int r, int u) {
      const size_t b = (size_t)(a + r);
      Block<CH> blk;
      crush_block(r, blk);
      Fold<kDepth, 1> tree;
      float err[1][2];
      int cnt = 0;
      for_chunks(rho, r, u, true, [&](int t, int k, int s) {
        crush_chunk(s, blk);
        int q[3][2], dec[CH][2];
        dither_decode_chunk<CH>(blk, best, P.dither != 0, P.key, (uint32_t)P.blocks[b], k,
                                kP << logc, lane, q, dec, err[0]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const size_t at = first_pixel(r, k) + lane + 32 * j;
          if (P.q != nullptr) P.q[at] = q[0][j] | (q[1][j] << 8) | (q[2][j] << 16);
          P.dec[at] = pack_decoded<CH>(dec, j);
        }
        cnt += blk.mask[0] + blk.mask[1];
        tree.fold(t, lgper, err);
      });
      cnt = __reduce_add_sync(kFull, cnt);
      if (lgs == 0) {
        const float dist = tree_sum(err[0][0], err[0][1]);
        if (lane == 0) outputs(r, dist, cnt);
      } else {
        keep<1>(err);
        if (lane == 0) reinterpret_cast<int*>(S.slot[warp])[kP] = cnt;
      }
    }, [&](int j0, int r, int g, bool whole) {
      float v[1][2];
      const int cnt = sum_slots(j0, 1, g, kP);
      fold_slots<1>(j0, 1, g, v);
      if (whole) {
        const float dist = tree_sum(v[0][0], v[0][1]);
        if (lane == 0) outputs(r, dist, cnt);
      } else {
        keep<1>(v);
        if (lane == 0) reinterpret_cast<int*>(S.slot[warp])[kP] = cnt;
      }
    }, [&](int j0, int r, int n, int rr, int nr) {
      float v[1][2];
      int cnt = sum_slots(j0, kCWarps, n, kP);
      fold_slots<1>(j0, kCWarps, n, v);
      if (kRounds && nr > 1) {
        if (rr > 0) cnt += cnt_rounds;
        if (!fold_rounds<1>(rr, nr, v)) {
          cnt_rounds = cnt;
          return;
        }
      }
      const float dist = tree_sum(v[0][0], v[0][1]);
      if (lane == 0) outputs(r, dist, cnt);
    });
  }
};

template <int CH, int LOGC>
__global__ void __launch_bounds__(kCThreads, 1)
segment_cluster_kernel(const __grid_constant__ ClusterArgs A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ClusterShared& S = *reinterpret_cast<ClusterShared*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5;
  unsigned char* stage = smem_raw + (sizeof(ClusterShared) + 15) / 16 * 16;
  const size_t plane = (size_t)kCWarps * A.stage * kP;   // a stage plane's elements
  SegCluster<CH, LOGC> X{A.P, S,
                         reinterpret_cast<int*>(stage) + (size_t)warp * A.stage * kP,
                         reinterpret_cast<int*>(stage) + plane + (size_t)warp * A.stage * kP,
                         stage + 8 * plane + (size_t)warp * A.stage * kP};
  X.stage = A.stage;
  X.cs = (int)cg::this_cluster().num_blocks();
  X.rank = (int)cg::this_cluster().block_rank();
  X.W = X.cs * kCWarps;
  X.gw = X.rank * kCWarps + warp;
  X.warp = warp;
  X.lane = tid & 31;
  X.tid = tid;
  X.logc = LOGC < kBigLogc ? LOGC : A.P.logc;
#pragma unroll 1
  for (;;) {
    if (X.rank == 0 && tid == 0) {
      const int e = atomicAdd(&A.work[1], 1);
      for (int rk = 0; rk < X.cs; ++rk) *at_rank(&S.entry, rk) = e;
    }
    cluster_sync();
    const int e = S.entry;
    if (e >= A.work[0]) break;  // uniform over the cluster
    const int4 seg = A.list[e];
    X.begin(seg.x, seg.y, seg.z);
    X.fit();
    X.search();
    X.finish();
  }
}

// The launch plan: clusters of cluster_size(logc) CTAs, as many as are
// resident at once (each takes segments from the list until it is empty);
// each warp stages as many chunks as the CTA's opt-in shared memory leaves
// (an even count: two halves when streamed); a first-pass CTA takes the
// segments that start in n / 512 lanes (1-128). `scratch` is (4 n + 2)
// int32: the list, then the two counters, zeroed here.
template <int CH, int LOGC>
int launch_segment_cluster(const SegParams& P, int32_t* scratch, cudaStream_t st) {
  const int logc = LOGC < kBigLogc ? LOGC : P.logc;
  const int cs = cluster_size(logc);
  auto kernel = segment_cluster_kernel<CH, LOGC>;
  // the stage and the resident cluster count of the device this
  // instantiation last ran on
  static int last_device = -1, stage = 0, clusters = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cluster_config(config, attr, cs, kCThreads, st);
  if (device != last_device) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    const long long room = (long long)optin - (long long)cluster_smem(0);
    stage = (int)(room / ((long long)kCWarps * kChunkBytes) / 2 * 2);
    if (stage < 2) return (int)cudaErrorInvalidConfiguration;
    config.dynamicSmemBytes = cluster_smem(stage);
    err = allow_cluster(kernel, cs, config.dynamicSmemBytes);
    config.gridDim = dim3(cs, 1, 1);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    last_device = device;
  }
  config.dynamicSmemBytes = cluster_smem(stage);
  const ClusterArgs A{P, reinterpret_cast<int4*>(scratch), scratch + 4 * (size_t)P.n, stage,
                      max(1, min(kPrepTile, P.n / 512))};
  err = cudaMemsetAsync(A.work, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  segment_prep_kernel<CH, LOGC><<<(P.n + A.tile - 1) / A.tile, kCThreads, 0, st>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // no more clusters than there are lanes
  config.gridDim = dim3(min(clusters, P.n) * cs, 1, 1);
  err = cudaLaunchKernelEx(&config, kernel, A);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
