// Fused quadtree encode for NVIDIA Hopper (sm_90a): the two kernels'
// templates, built by encode_merged.cu (the Morton pair) and
// encode_natural.cu (the natural-layout pair).
//
// fit_levels replaces limg_tpu/pallas_kernels/encode_merged.py:
// fit_levels_pallas (:813, kernel :621) with emit_match=True: the fit of
// every quadtree level, the 27-probe merge test of each child region
// against its group's first child (_match_rows :376), the alive chain, the
// owner level, the owner select of factors / endpoints / avg, and the stats
// and reason rows. owner_crush replaces owner_crush_pallas (:902, kernel
// :744): the crush search, dither, decode and error once per pixel at each
// block's owner level, with per-region and per-block outputs.
//
// NAT = true makes them the natural-layout pair, fit_levels_natural and
// owner_crush_natural (limg_tpu/pallas_kernels/encode_natural.py:421,
// :528): the same functions with the pixel planes (f8_sel, q, dec) as
// natural (8 by0, 8 bx0) row-major planes instead of block-major (nb, 64)
// ones. Both pairs sum a block in the natural layout's order (a left fold
// over its 8 rows, then a pairwise tree over its 8 columns; ops/reduce.py
// nat_block_sum), so the two layouts give the same encode bit for bit, as
// the JAX package's do. Across blocks both pair a square's blocks alike:
// Morton order's pairwise tree is the natural kernels' x-then-y butterfly.
//
// What bounds them on the H100: a 4K image is 33 MB of words, read once by
// each kernel (~10 us each at 3.35 TB/s). The fit does levels full fits
// (about 25 float passes over the pixels each) plus one 27-probe match per
// child region; the crush does 35+ exact candidate decodes per block, as
// the fixed-grid kernel does. Both are bound by operations (chip_smoke.py
// kernel_bound), and in practice by how their region reductions wait.
//
// fit_levels' design: eight lanes a block, lane l holding column l % 8
// (pixels l % 8 + 8 k), four blocks a warp in Morton order (x in the even
// bits), so a warp is a level-1 region and a level-l region an aligned
// group of 4^(l-1) warps. A CTA holds one top-level square: 4 warps at 3
// levels, 16 at 4 (no cluster), 4 squares of one warp at 2. Then:
// - a block's sums are 7 in-lane adds and xor shuffles 1, 2, 4 (the natural
//   order's row fold and column tree), and a level-1 region's are xor 8,
//   16 (the Morton pairwise tree): levels 0 and 1 take no CTA barrier;
// - a level-l region (l >= 2) puts one value per warp in shared memory,
//   passes one barrier (two slot sets alternate) and combines the group's
//   values one to a lane by xor butterflies, the same pairwise tree; about
//   six exchanges a level;
// - the merge test, alive chain and owner select read the children's
//   region rows (endpoints, avg, count) from shared memory, 8 lanes a test
//   (limg_common.cuh match_rows<CH, 8>), and the owner level's rows stay in
//   shared memory until the block's lanes write them out;
// - only the pixels (as floats) and each pixel's selected factors live in
//   a lane's registers; the fit's per-pixel steps are recomputed from them
//   in each pass instead of kept.
// owner_crush's design is the fit's layout: eight lanes a block, 8 pixels a
// lane, four blocks a warp, one CTA a top-level square, with the search of
// crush_search.cuh (CrushLane), which the region encode
// (region_encode.cuh) shares. The search is 25 distinct per-axis sweeps
// and K = 8 peeled candidates at ladder K = 8, each an exact decode of
// every pixel: 86% of the device time of the earlier one-warp-a-block
// kernel at 4K RGB (H100 80GB HBM3, 700.00 W; PERF.md). So:
// - a warp is a level-1 region and the fit's owner level is uniform over
//   every region, so a warp whose region is one block or the warp itself
//   reduces a candidate's pixel max and error sum (integers: any order) by
//   xor 1, 2, 4 or one warp reduction, with no CTA barrier; only a CTA that
//   holds a level-2 or level-3 region passes barriers, one a batch;
// - candidates are reduced in batches: the 27 sweeps (one decode of
//   (0, 0, 0) for all three axes) in one, the K ladder candidates in
//   another (their peel order does not depend on their errors), then the
//   region's values stay in shared memory, one row a block or warp, so no
//   lane holds 54 sweep values in registers;
// - the sweeps of one axis share the decode of the other two axes (shift
//   0), summed once per pixel; the block's decode frame (normals, offsets)
//   sits in shared memory, read once per candidate, which keeps the kernel
//   at 128 registers without spills; a decoded channel's clamp to [0, 255]
//   is one DPX instruction (__vimin_s32_relu);
// - the ladder's 64 keys are 8 a lane over the block's 8 lanes; the peel is
//   an arg-max (lowest index on ties) by xor 1, 2, 4;
// - a block's error sum takes the natural order (in-lane row fold, xor 1,
//   2, 4), a region's dist the Morton pairwise tree (xor 8, 16, then the
//   warps' tree through one exchange).
//
// Both kernels read each block straight from the row-major (H, W) word
// image and mask pixels outside (h, w): no relayout, no mask plane. Blocks
// of a square outside the grid are empty; like the reference's padding
// lanes they count zero pixels and auto-match. Bit-exactness with the
// plain PyTorch versions (kernels/encode_merged.py, kernels/encode_natural.py)
// rests on the orders listed in limg_common.cuh, on the Morton order of the
// cross-block trees, and on the match predicate's fixed order
// (limg_common.cuh match_rows, shared with coalesce.cu).

#pragma once

#include "crush_search.cuh"

namespace {

using namespace limg;

__device__ __forceinline__ int header_bits(int ch) { return ch * 9 * 2 + ch * 8 + 2 * 16; }

// Where pixel pix of block (by, bx) of a grid bx0 blocks wide lies in a
// pixel plane: block-major (nb, 64), or the natural (8 by0, 8 bx0) plane.
template <bool NAT>
__device__ __forceinline__ size_t plane_at(int by, int bx, int bx0, int pix) {
  if constexpr (NAT) {
    return (size_t)(by * 8 + (pix >> 3)) * (size_t)(bx0 * 8) + (size_t)(bx * 8 + (pix & 7));
  } else {
    return ((size_t)by * bx0 + bx) * kP + pix;
  }
}

// Morton position w inside the square -> (y, x) offsets, x in the even bits.
template <int L>
__device__ __forceinline__ void morton_yx(int w, int& y, int& x) {
  y = x = 0;
#pragma unroll
  for (int b = 0; b < L; ++b) {
    x |= ((w >> (2 * b)) & 1) << b;
    y |= ((w >> (2 * b + 1)) & 1) << b;
  }
}

// ---------------------------------------------------------------------------
// fit_levels: eight lanes a block, four blocks a warp
// ---------------------------------------------------------------------------

// A top-level square of 4^L blocks for the fit. Lane l of a warp holds
// column l % 8 of block l / 8 of the warp, and a warp's 4 blocks are
// consecutive in Morton order, so a warp is a level-1 region and a level-l
// region (l >= 2) an aligned group of 4^(l-1) warps. A CTA holds one square
// (4 warps at L = 2, 16 at L = 3), or 4 squares of one warp each at L = 1.
template <int L>
struct FitSquare {
  static constexpr int kG = 1 << L;                // blocks per side
  static constexpr int kBlocks = 1 << (2 * L);     // blocks per square
  static constexpr int kW = kBlocks / 4;           // warps per square
  static constexpr int kSquares = L == 1 ? 4 : 1;  // squares per CTA
  static constexpr int kWarps = kW * kSquares;
};

constexpr int kFitPut = 8;   // values one exchange publishes per warp
constexpr int kRegion = 29;  // a region's row: 6 * 4 endpoints, 4 avg, count

template <class T>
__device__ __forceinline__ float to_bits(T x);
template <>
__device__ __forceinline__ float to_bits<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_bits<int>(int x) { return __int_as_float(x); }
template <class T>
__device__ __forceinline__ T from_bits(float x);
template <>
__device__ __forceinline__ float from_bits<float>(float x) { return x; }
template <>
__device__ __forceinline__ int from_bits<int>(float x) { return __float_as_int(x); }

struct IAnd {
  __device__ int operator()(int a, int b) const { return a & b; }
};
struct IOr {
  __device__ int operator()(int a, int b) const { return a | b; }
};

// Exchange between the W warps of a square: lane 0 of each warp puts its
// values, one barrier, and each aligned group of G warps combines them by
// the pairwise-adjacent tree in warp (Morton) order, one value per lane,
// xor butterflies. Two slot sets alternate, so one barrier per exchange
// suffices: a warp writes a set again only after the next exchange's
// barrier, which every warp reaches after its reads of this one.
template <int W>
struct SquareExchange {
  float* buf;  // [2][kFitPut][W]
  int warp, lane, set;

  __device__ float* slots() const { return buf + set * kFitPut * W; }
  template <int N, class T>
  __device__ void put(const T (&v)[N], int at) const {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) slots()[(at + i) * W + warp] = to_bits<T>(v[i]);
    }
  }
  template <int G, int N, class T, class Op>
  __device__ void tree(T (&v)[N], int at, Op op) const {
    constexpr int kPer = 32 / G;  // values one round combines
    const int base = warp & ~(G - 1);
#pragma unroll
    for (int r = 0; r < (N + kPer - 1) / kPer; ++r) {
      const int i = r * kPer + lane / G;
      T x = T(0);
      if (i < N) x = from_bits<T>(slots()[(at + i) * W + base + lane % G]);
      x = butterfly<1, G>(x, op);
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        if (r * kPer + q < N) v[r * kPer + q] = __shfl_sync(kFull, x, q * G);
    }
  }
};

// One lane's part of the fit of every level of its block: the block's
// column sub (pixels sub + 8 k, k = 0..7) in registers, the region values
// each step needs in every lane of the region, and the level loop's state.
// A block's float sums take the natural layout's order: the left fold over
// the column's 8 rows in the lane, then the pairwise tree over the 8 columns
// (xor 1, 2, 4; limg_common.cuh nat_sum, ops/reduce.py nat_block_sum).
template <int CH, int L>
struct FitLane {
  using Sq = FitSquare<L>;
  static constexpr int kCtaBlocks = Sq::kBlocks * Sq::kSquares;

  float pxf[CH][8];
  int nrows;    // rows of the block inside the image (<= 0 outside)
  bool colv;    // the column is inside the image
  int sub, bsq, blk;  // column; block's Morton index in its square; its smem row
  int num_factors;
  SquareExchange<Sq::kW> ex;
  int* rows;    // [2][kCtaBlocks][kRegion]: the last two levels' region rows
  int* sel;     // [kCtaBlocks][7 * CH]: endpoints and avg at the owner level
  int f8_sel[8];
  int owner, alive, nonempty, cnt0;
  int reason[L + 1];

  __device__ bool valid(int k) const { return colv && k < nrows; }
  __device__ float mf(int k) const { return valid(k) ? 1.0f : 0.0f; }
  __device__ int* row(int set, int b) const { return rows + (set * kCtaBlocks + b) * kRegion; }

  // region reduction of a block's values (every lane of the block holds
  // them): blocks of a warp by xor 8, 16; warps of a square by the exchange
  template <int LVL, int N, class T, class Op>
  __device__ void in_warp(T (&v)[N], Op op) const {
    if constexpr (LVL >= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = butterfly<8, 32>(v[i], op);
    }
  }
  template <int LVL, int N, class T, class Op>
  __device__ void region(T (&v)[N], Op op) {
    in_warp<LVL>(v, op);
    if constexpr (LVL >= 2) {
      ex.put(v, 0);
      __syncthreads();
      ex.template tree<1 << (2 * (LVL - 1))>(v, 0, op);
      ex.set ^= 1;
    }
  }
  template <int LVL, int N1, class T1, class Op1, int N2, class T2, class Op2>
  __device__ void region(T1 (&a)[N1], Op1 op1, T2 (&b)[N2], Op2 op2) {
    in_warp<LVL>(a, op1);
    in_warp<LVL>(b, op2);
    if constexpr (LVL >= 2) {
      ex.put(a, 0);
      ex.put(b, N1);
      __syncthreads();
      ex.template tree<1 << (2 * (LVL - 1))>(a, 0, op1);
      ex.template tree<1 << (2 * (LVL - 1))>(b, N1, op2);
      ex.set ^= 1;
    }
  }

  // Sign-corrected unit-vector mean of the region (ops/fit.py
  // _signed_unit_mean) of the per-pixel vectors vec(k, v), masked.
  template <int LVL, class Vec>
  __device__ void unit_mean(Vec vec, float inv_count, float (&dir)[CH]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float v[CH];
      vec(k, v);
      const float il = signed_inv_len<CH>(v, mf(k));
#pragma unroll
      for (int c = 0; c < CH; ++c) dir[c] = k == 0 ? v[c] * il : dir[c] + v[c] * il;
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) dir[c] = butterfly<1, 8>(dir[c], AddOp());
    region<LVL>(dir, AddOp());
#pragma unroll
    for (int c = 0; c < CH; ++c) dir[c] = dir[c] * inv_count;
  }

  // The fit's per-pixel steps (limg_common.cuh FitSteps, one pixel)
  __device__ void centred(int k, const float (&avg)[CH], float (&v)[CH]) const {
    const float m = mf(k);
#pragma unroll
    for (int c = 0; c < CH; ++c) v[c] = (pxf[c][k] - avg[c]) * m;
  }
  // resid_a and est of pixel k; returns fac_a
  __device__ float resid_a(int k, const float (&avg)[CH], const float (&dir_a)[CH], float inv_a,
                           float (&est)[CH], float (&r)[CH]) const {
    float cv[CH];
    centred(k, avg, cv);
    const float m = mf(k);
    float dot = cv[0] * dir_a[0];
#pragma unroll
    for (int c = 1; c < CH; ++c) dot = dot + cv[c] * dir_a[c];
    const float fa = (dot * inv_a) * m;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      est[c] = avg[c] + fa * dir_a[c];
      r[c] = (pxf[c][k] - est[c]) * m;
    }
    return fa;
  }
  // resid_ab of pixel k; sets fac_a and fac_b
  __device__ void resid_ab(int k, const float (&avg)[CH], const float (&dir_a)[CH], float inv_a,
                           const float (&dir_b)[CH], float inv_b, float (&r)[CH], float& fa,
                           float& fb) const {
    float est[CH], ra[CH];
    fa = resid_a(k, avg, dir_a, inv_a, est, ra);
    const float m = mf(k);
    float dot = ra[0] * dir_b[0];
#pragma unroll
    for (int c = 1; c < CH; ++c) dot = dot + ra[c] * dir_b[c];
    fb = (dot * inv_b) * m;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float est_b = est[c] + fb * dir_b[c];
      r[c] = (pxf[c][k] - est_b) * m;
    }
  }

  template <int LVL>
  __device__ void level() {
    // ---- pixel count and channel sums -> avg
    int cnt[1] = {0};
    float avg[CH];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float m = mf(k);
      cnt[0] += valid(k) ? 1 : 0;
#pragma unroll
      for (int c = 0; c < CH; ++c) avg[c] = k == 0 ? pxf[c][k] * m : avg[c] + pxf[c][k] * m;
    }
    cnt[0] = butterfly<1, 8>(cnt[0], IAdd());
#pragma unroll
    for (int c = 0; c < CH; ++c) avg[c] = butterfly<1, 8>(avg[c], AddOp());
    region<LVL>(avg, AddOp(), cnt, IAdd());
    const int count = cnt[0];
    const float inv_count = 1.0f / fmaxf((float)count, 1.0f);
#pragma unroll
    for (int c = 0; c < CH; ++c) avg[c] = avg[c] * inv_count;

    // ---- the three directions
    float dir_a[CH], dir_b[CH], dir_c[CH];
    unit_mean<LVL>([&](int k, float (&v)[CH]) { centred(k, avg, v); }, inv_count, dir_a);
    const float inv_a = inv_or_zero(dot_self<CH>(dir_a));
    unit_mean<LVL>([&](int k, float (&v)[CH]) {
      float est[CH];
      resid_a(k, avg, dir_a, inv_a, est, v);
    }, inv_count, dir_b);
    const float inv_b = inv_or_zero(dot_self<CH>(dir_b));
    if constexpr (CH == 3) {
      FitSteps<CH>::cross(dir_a, dir_b, dir_c);
    } else {
      unit_mean<LVL>([&](int k, float (&v)[CH]) {
        float fa, fb;
        resid_ab(k, avg, dir_a, inv_a, dir_b, inv_b, v, fa, fb);
      }, inv_count, dir_c);
    }
    const float inv_c = inv_or_zero(dot_self<CH>(dir_c));

    // ---- factor extremes over the region's valid pixels
    float mn[3], mx[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mn[i] = kBig;
      mx[i] = -kBig;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float r[CH], f[3];
      resid_ab(k, avg, dir_a, inv_a, dir_b, inv_b, r, f[0], f[1]);
      float dot = r[0] * dir_c[0];
#pragma unroll
      for (int c = 1; c < CH; ++c) dot = dot + r[c] * dir_c[c];
      f[2] = (dot * inv_c) * mf(k);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        mn[i] = fminf(mn[i], valid(k) ? f[i] : kBig);
        mx[i] = fmaxf(mx[i], valid(k) ? f[i] : -kBig);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mn[i] = butterfly<1, 8>(mn[i], MinOp());
      mx[i] = butterfly<1, 8>(mx[i], MaxOp());
    }
    region<LVL>(mn, MinOp(), mx, MaxOp());

    // ---- endpoints, the u8 factors, the reduced-factor drop
    int ep[6][CH];
    round_endpoints<CH>(count, avg, dir_a, dir_b, dir_c, mn, mx, ep);
    int f8[8];
    {
      FactorFrame<CH> fr;
      fr.set(ep);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float px[CH];
        int f[3];
#pragma unroll
        for (int c = 0; c < CH; ++c) px[c] = pxf[c][k];
        fr.f8_of(px, f);
        f8[k] = f[0] | (f[1] << 8) | (f[2] << 16);
      }
    }
    drop_axes<CH>(ep, num_factors);

    // ---- the merge test of each child against its region's first child,
    // on the previous level's region rows, then the alive chain
    bool take = LVL == 0;
    if constexpr (LVL == 0) {
      cnt0 = count;
    } else {
      constexpr int kChild = 1 << (2 * (LVL - 1)), kGroup = 1 << (2 * LVL);
      if constexpr (LVL == 1) __syncwarp();  // level 0's rows are this warp's
      float p_avg[CH], c0_avg[CH];
      int p_ep[6][CH], c0_ep[6][CH], p_count, c0_count;
      load_row(row((LVL - 1) & 1, blk), p_ep, p_avg, p_count);
      load_row(row((LVL - 1) & 1, blk & ~(kGroup - 1)), c0_ep, c0_avg, c0_count);
      bool m;
      const int reason_bits = match_rows<CH, 8>(p_avg, p_ep, c0_avg, c0_ep, sub, m);
      const bool is_child0 = (bsq & (kGroup - kChild)) == 0;
      const bool ok = is_child0 || m || p_count <= 0 || c0_count <= 0;
      int a[1] = {alive & (ok ? 1 : 0)}, r[1] = {is_child0 ? 0 : reason_bits};
      region<LVL>(a, IAnd(), r, IOr());
      alive = a[0];
      reason[LVL] = r[0];
      if (alive) {
        owner = LVL;
        take = true;
      }
    }
    if (take) {
#pragma unroll
      for (int k = 0; k < 8; ++k) f8_sel[k] = f8[k];
      if (sub == 0) store_row(sel + blk * 7 * CH, ep, avg, -1);
    }
    if (count > 0) nonempty |= 1 << LVL;
    if constexpr (LVL < L) {
      if (sub == 0) store_row(row(LVL & 1, blk), ep, avg, count);
      level<LVL + 1>();
    }
  }

  // a region row: 6 CH endpoints, CH avg (bits), then the count (if >= 0)
  static __device__ void store_row(int* r, const int (&ep)[6][CH], const float (&avg)[CH],
                                   int count) {
#pragma unroll
    for (int e = 0; e < 6; ++e) {
#pragma unroll
      for (int c = 0; c < CH; ++c) r[e * CH + c] = ep[e][c];
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) r[6 * CH + c] = __float_as_int(avg[c]);
    if (count >= 0) r[7 * CH] = count;
  }
  static __device__ void load_row(const int* r, int (&ep)[6][CH], float (&avg)[CH], int& count) {
#pragma unroll
    for (int e = 0; e < 6; ++e) {
#pragma unroll
      for (int c = 0; c < CH; ++c) ep[e][c] = r[e * CH + c];
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) avg[c] = __int_as_float(r[6 * CH + c]);
    count = r[7 * CH];
  }
};

template <int CH, int L, bool NAT>
__global__ void __launch_bounds__(FitSquare<L>::kWarps * 32, L == 3 ? 1 : 4)
fit_levels_kernel(const int32_t* __restrict__ words, int h, int w, int num_factors,
                  int32_t* __restrict__ cnt0_out, int32_t* __restrict__ f8_out,
                  int32_t* __restrict__ eps_out, float* __restrict__ avg_out,
                  int32_t* __restrict__ owner_out, int32_t* __restrict__ stats_out,
                  int32_t* __restrict__ reasons_out) {
  using Sq = FitSquare<L>;
  using Lane = FitLane<CH, L>;
  __shared__ float xbuf[2 * kFitPut * Sq::kW];
  __shared__ int rows[2 * Lane::kCtaBlocks * kRegion];
  __shared__ int sel[Lane::kCtaBlocks * 7 * CH];
  const int by0 = (h + 7) / 8, bx0 = (w + 7) / 8, nb = by0 * bx0;
  const int warp = (int)(threadIdx.x >> 5), lane = (int)(threadIdx.x & 31);
  const int squares_x = (bx0 + Sq::kG - 1) / Sq::kG;
  const int square = (int)blockIdx.x * Sq::kSquares + warp / Sq::kW;
  // whole warps of the last CTA at L = 1, which has no CTA barrier
  if (square >= squares_x * ((by0 + Sq::kG - 1) / Sq::kG)) return;

  Lane f;
  f.sub = lane & 7;
  f.bsq = (warp % Sq::kW) * 4 + (lane >> 3);
  f.blk = (warp / Sq::kW) * Sq::kBlocks + f.bsq;
  int oy, ox;
  morton_yx<L>(f.bsq, oy, ox);
  const int by = (square / squares_x) * Sq::kG + oy, bx = (square % squares_x) * Sq::kG + ox;
  const int col = bx * 8 + f.sub;
  f.colv = col < w;
  f.nrows = min(h - by * 8, 8);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t word = f.valid(k) ? (uint32_t)words[(size_t)(by * 8 + k) * w + col] : 0u;
#pragma unroll
    for (int c = 0; c < CH; ++c) f.pxf[c][k] = (float)((word >> (8 * c)) & 0xFFu);
  }
  f.num_factors = num_factors;
  f.ex = SquareExchange<Sq::kW>{xbuf, warp % Sq::kW, lane, 0};
  f.rows = rows;
  f.sel = sel;
  f.owner = 0;
  f.alive = 1;
  f.nonempty = 0;
#pragma unroll
  for (int l = 0; l <= L; ++l) f.reason[l] = 0;
  f.template level<0>();
  __syncwarp();  // the owner level's row, written by the block's lane 0

  if (by >= by0 || bx >= bx0) return;  // after the last barrier
  const size_t b = (size_t)by * bx0 + bx;
#pragma unroll
  for (int k = 0; k < 8; ++k) f8_out[plane_at<NAT>(by, bx, bx0, f.sub + 8 * k)] = f.f8_sel[k];
  if (f.sub == 0) {
    cnt0_out[b] = f.cnt0;
    owner_out[b] = f.owner;
    int stats = 0;
#pragma unroll
    for (int l = 0; l <= L; ++l) {
      const bool lead = (f.bsq & ((1 << (2 * l)) - 1)) == 0;
      const bool nonempty = (f.nonempty >> l) & 1;
      if (lead && f.owner >= l && nonempty) stats |= 1 << l;
      if (l >= 1) reasons_out[(size_t)(l - 1) * nb + b] = lead && nonempty ? f.reason[l] : 0;
    }
    stats_out[b] = stats;
  }
  if (f.sub < CH) {
    // lane c of the block writes channel c of the six endpoint rows and avg
    const int* r = sel + f.blk * 7 * CH;
#pragma unroll
    for (int e = 0; e < 6; ++e) eps_out[((size_t)e * CH + f.sub) * nb + b] = r[e * CH + f.sub];
    avg_out[(size_t)f.sub * nb + b] = __int_as_float(r[6 * CH + f.sub]);
  }
}

// ---------------------------------------------------------------------------
// owner_crush: eight lanes a block, four blocks a warp (the fit's layout)
// ---------------------------------------------------------------------------

// The owner crush's lanes: crush_search.cuh CrushLane over the CTA's
// warps, up to level L.
template <int CH, int L>
using OwnerLane = CrushLane<CH, FitSquare<L>::kWarps, L>;

// The region's float sum of its blocks' dist_blk: a warp's blocks by the
// pairwise tree (xor 8, 16), the warps of a larger region through one
// exchange by the same tree in warp (Morton) order.
template <int CH, int L>
__device__ float region_dist(OwnerLane<CH, L>& cl, float d) {
  constexpr int kW = FitSquare<L>::kWarps;
  if (cl.owner >= 1) d = butterfly<8, 32>(d, AddOp());
  if constexpr (L >= 2) {
    if (cl.xchg) {
      int* xs = cl.sh->xs + cl.set * kBatchVals * kW;
      if (cl.lane == 0) xs[cl.warp] = __float_as_int(d);
      __syncthreads();
      if (cl.owner >= 2) {
        const int g = cl.owner == 2 ? 4 : 16;
        const int base = cl.warp & ~(g - 1);
        float x = __int_as_float(xs[base + cl.lane % g]);
        x = x + __shfl_xor_sync(kFull, x, 1);
        x = x + __shfl_xor_sync(kFull, x, 2);
        if (g == 16) {
          x = x + __shfl_xor_sync(kFull, x, 4);
          x = x + __shfl_xor_sync(kFull, x, 8);
        }
        d = __shfl_sync(kFull, x, 0);
      }
    }
  }
  return d;
}

template <int CH, int L, bool NAT>
__global__ void __launch_bounds__(FitSquare<L>::kWarps * 32, L == 3 ? 1 : 4)
owner_crush_kernel(const int32_t* __restrict__ words, int h, int w, int crush_mode, int dither,
                   int ladder_k, int num_factors, int max_pix, int max_blk, uint32_t key,
                   const int32_t* __restrict__ owner_in, const int32_t* __restrict__ f8_in,
                   const int32_t* __restrict__ eps_in, int32_t* __restrict__ shifts_out,
                   int32_t* __restrict__ q_out, int32_t* __restrict__ dec_out,
                   float* __restrict__ dist_out, float* __restrict__ dist_blk_out,
                   int32_t* __restrict__ bpp_out) {
  using Sq = FitSquare<L>;
  __shared__ CrushShared<CH, Sq::kWarps, L> shared;
  const int by0 = (h + 7) / 8, bx0 = (w + 7) / 8, nb = by0 * bx0;
  const int warp = (int)(threadIdx.x >> 5), lane = (int)(threadIdx.x & 31);
  const int squares_x = (bx0 + Sq::kG - 1) / Sq::kG;
  const int square = (int)blockIdx.x * Sq::kSquares + warp / Sq::kW;
  // whole warps of the last CTA at L = 1, which has no CTA barrier
  if (square >= squares_x * ((by0 + Sq::kG - 1) / Sq::kG)) return;
  const int sy = (square / squares_x) * Sq::kG, sx = (square % squares_x) * Sq::kG;

  OwnerLane<CH, L> cl;
  cl.sub = lane & 7;
  cl.lane = lane;
  cl.warp = warp;
  cl.blk = warp * 4 + (lane >> 3);
  cl.sh = &shared;
  cl.set = 0;
  int oy, ox;
  morton_yx<L>((warp % Sq::kW) * 4 + (lane >> 3), oy, ox);
  const int by = sy + oy, bx = sx + ox;
  const bool in_grid = by < by0 && bx < bx0;
  const size_t b = in_grid ? (size_t)by * bx0 + bx : 0;
  const int col = bx * 8 + cl.sub, nrows = col < w ? min(max(h - by * 8, 0), 8) : 0;
  cl.vmask = (1 << nrows) - 1;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t word = k < nrows ? (uint32_t)words[(size_t)(by * 8 + k) * w + col] : 0u;
#pragma unroll
    for (int c = 0; c < CH; ++c) cl.px[c][k] = (int)((word >> (8 * c)) & 0xFFu);
    cl.f8w[k] = in_grid ? f8_in[plane_at<NAT>(by, bx, bx0, cl.sub + 8 * k)] : 0;
  }
  // the block's decode frame: lane k < 3 reads axis k's endpoint rows
  if (cl.sub < 3) {
    int* fr = shared.frames + cl.blk * 6 * CH;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int lo = in_grid ? eps_in[((size_t)(2 * cl.sub) * CH + c) * nb + b] : 0;
      const int hi = in_grid ? eps_in[((size_t)(2 * cl.sub + 1) * CH + c) * nb + b] : 0;
      fr[cl.sub * CH + c] = hi - lo;
      fr[(3 + cl.sub) * CH + c] = lo;
    }
  }
  __syncwarp();
  // The CTA exchanges if it holds a region of level 2 or 3, whose owner its
  // first block holds; blocks outside the grid take their region's owner
  // and add the identity (no pixel) to every reduction.
  cl.xchg = false;
  int region_owner = 0;  // this warp's level-2 or level-3 region's owner, or 0
  if constexpr (L >= 2) {
    const int mine = (warp % Sq::kW) / 4;  // this warp's level-2 sub-square
#pragma unroll
    for (int q = 0; q < (1 << (2 * (L - 2))); ++q) {
      int qy, qx;
      morton_yx<L>(16 * q, qy, qx);
      const int y = sy + qy, x = sx + qx;
      const int o = y < by0 && x < bx0 ? owner_in[(size_t)y * bx0 + x] : 0;
      if (o >= 2) cl.xchg = true;
      if (q == mine && o >= 2) region_owner = o;
      if (q == 0 && o == 3) region_owner = 3;
    }
  }
  cl.owner = __any_sync(kFull, in_grid) ? __reduce_max_sync(kFull, in_grid ? owner_in[b] : 0)
                                        : region_owner;
  cl.max_pix = max_pix;
  cl.max_blk = max_blk;
  cl.es = (kP << (2 * L)) >= 2048 ? 4 : 0;  // ops/crush.py err_scale_shift

  int best[3];
  cl.search(crush_mode, ladder_k, num_factors, nrows, best);

  // dither, crush, decode; the block's error in the natural order (the
  // column's 8 rows in order, then xor 1, 2, 4)
  int n_int[3][CH], m_int[3][CH];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      n_int[k][c] = cl.n_at(k, c);
      m_int[k][c] = cl.m_at(k, c);
    }
  }
  float dist_blk = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int q[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int s = best[a];
      int v = (cl.f8w[k] >> (8 * a)) & 0xFF;
      if (dither != 0 && s > 0 && s < 8)
        v = min(max(v + dither_noise(dither_bits(key, (uint32_t)b, a, cl.sub + 8 * k), s), 0),
                255);
      q[a] = v >> min(s, 8);
    }
    int est[CH];
    decode_est<CH>(q, best, n_int, m_int, est);
    const float err = (float)cl.pixel_err_of(est, k);
    dist_blk = k == 0 ? err : dist_blk + err;
    if (in_grid) {
      const size_t at = plane_at<NAT>(by, bx, bx0, cl.sub + 8 * k);
      if (q_out != nullptr) q_out[at] = q[0] | (q[1] << 8) | (q[2] << 16);
      uint32_t d = CH == 3 ? 0xFF000000u : 0u;
#pragma unroll
      for (int c = 0; c < CH; ++c) d |= (uint32_t)min(max(est[c], 0), 255) << (8 * c);
      dec_out[at] = (int32_t)d;
    }
  }
  dist_blk = butterfly<1, 8>(dist_blk, AddOp());
  const float dist = region_dist<CH, L>(cl, dist_blk);
  const int cnt_blk = butterfly<1, 8>(nrows, IAdd());

  if (!in_grid || cl.sub != 0) return;  // after the last barrier
  int fac_bits = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    shifts_out[(size_t)k * nb + b] = best[k];
    fac_bits = add_wrap(fac_bits, mul_wrap(8 - min(best[k], 8), cl.count));
  }
  const int bits = header_bits(CH) + fac_bits;
  const int bpp = min(0xFF, (bits + cl.count / 2) / max(cl.count, 1));
  bpp_out[b] = cnt_blk > 0 ? bpp : 0;
  dist_out[b] = dist;
  dist_blk_out[b] = dist_blk;
}

template <int CH, int L, bool NAT>
int launch_fit(const int32_t* words, int h, int w, int num_factors, int32_t* cnt0, int32_t* f8,
               int32_t* eps, float* avg, int32_t* owner, int32_t* stats, int32_t* reasons,
               cudaStream_t st) {
  using Sq = FitSquare<L>;
  const int side = 8 * Sq::kG;
  const int squares = ((h + side - 1) / side) * ((w + side - 1) / side);
  const int grid = (squares + Sq::kSquares - 1) / Sq::kSquares;
  fit_levels_kernel<CH, L, NAT><<<grid, Sq::kWarps * 32, 0, st>>>(
      words, h, w, num_factors, cnt0, f8, eps, avg, owner, stats, reasons);
  return (int)cudaGetLastError();
}

template <int CH, int L, bool NAT>
int launch_crush(const int32_t* words, int h, int w, int crush_mode, int dither, int ladder_k,
                 int num_factors, int max_pix, int max_blk, uint32_t key, const int32_t* owner,
                 const int32_t* f8, const int32_t* eps, int32_t* shifts, int32_t* q,
                 int32_t* dec, float* dist, float* dist_blk, int32_t* bpp, cudaStream_t st) {
  using Sq = FitSquare<L>;
  const int side = 8 * Sq::kG;
  const int squares = ((h + side - 1) / side) * ((w + side - 1) / side);
  const int grid = (squares + Sq::kSquares - 1) / Sq::kSquares;
  owner_crush_kernel<CH, L, NAT><<<grid, Sq::kWarps * 32, 0, st>>>(
      words, h, w, crush_mode, dither, ladder_k, num_factors, max_pix, max_blk, key, owner, f8,
      eps, shifts, q, dec, dist, dist_blk, bpp);
  return (int)cudaGetLastError();
}

// The C entry points' bodies (encode_merged.cu, encode_natural.cu): the
// kernel of the channel count and level count, or cudaErrorInvalidValue.
template <bool NAT>
int fit_levels_entry(const int32_t* words, int h, int w, int channels, int levels,
                     int num_factors, int32_t* cnt0, int32_t* f8, int32_t* eps, float* avg,
                     int32_t* owner, int32_t* stats, int32_t* reasons, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int which = (channels == 4 ? 10 : 0) + levels;
#define LIMG_FIT(CH, L)                                                                       \
  launch_fit<CH, L, NAT>(words, h, w, num_factors, cnt0, f8, eps, avg, owner, stats, reasons, st)
  switch (which) {
    case 2: return LIMG_FIT(3, 1);
    case 3: return LIMG_FIT(3, 2);
    case 12: return LIMG_FIT(4, 1);
    case 13: return LIMG_FIT(4, 2);
    case 4: return LIMG_FIT(3, 3);
    case 14: return LIMG_FIT(4, 3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LIMG_FIT
}

template <bool NAT>
int owner_crush_entry(const int32_t* words, int h, int w, int channels, int levels,
                      int crush_mode, int dither, int ladder_k, int num_factors, int max_pix,
                      int max_blk, uint32_t key, const int32_t* owner, const int32_t* f8,
                      const int32_t* eps, int32_t* shifts, int32_t* q, int32_t* dec, float* dist,
                      float* dist_blk, int32_t* bpp, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int which = (channels == 4 ? 10 : 0) + levels;
#define LIMG_CRUSH(CH, L)                                                                     \
  launch_crush<CH, L, NAT>(words, h, w, crush_mode, dither, ladder_k, num_factors, max_pix,  \
                           max_blk, key, owner, f8, eps, shifts, q, dec, dist, dist_blk, bpp, st)
  switch (which) {
    case 2: return LIMG_CRUSH(3, 1);
    case 3: return LIMG_CRUSH(3, 2);
    case 12: return LIMG_CRUSH(4, 1);
    case 13: return LIMG_CRUSH(4, 2);
    case 4: return LIMG_CRUSH(3, 3);
    case 14: return LIMG_CRUSH(4, 3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LIMG_CRUSH
}

}  // namespace
