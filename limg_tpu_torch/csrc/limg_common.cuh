// Device code shared by the encode kernels (encode_fixed.cu, encode_merged.cu).
//
// One warp holds one 8x8 block: lane l holds pixels l and l + 32. What a
// kernel reduces over is a *region*: one block (the fixed grid), or an
// aligned square of 4^l blocks whose warps sit in one CTA in Morton order
// (the quadtree levels). The region reduction is a policy class:
//
// - BlockReducer: the region is the block; the warp's own sums are final;
// - GroupReducer<Ex, GROUP>: aligned groups of GROUP warps of a square;
// - OwnerReducer<Ex, L>: each warp's group is 4^owner warps, owner per warp.
// A square of up to 16 blocks is one CTA; a square of 64 is a cluster of
// four CTAs (Exchange).
//
// Float sums follow one fixed order, which the plain PyTorch versions
// (limg_tpu_torch/ops/reduce.py, ops/fit.py) follow too, so kernel and
// plain version agree bit for bit:
// - over a block's 64 pixels, x[l] + x[l+32], then butterfly shuffles at
//   16, 8, 4, 2, 1: the values of the halving tree x[:n/2] + x[n/2:];
// - across a region's warps, a pairwise-adjacent tree in Morton order,
//   (w0 + w1) + (w2 + w3), ..., through shared memory;
// - channel sums and other short sums are left folds;
// - no contraction of a * b + c (build with --fmad=false) and exact
//   1.0f / sqrtf(x) (no --use_fast_math).
// Integer sums wrap in int32, and like min and max do not depend on order.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace limg {

constexpr int kP = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1e-38f;
constexpr float kBig = 3.4e38f;
constexpr int kSentinel = -2147483647;  // -(2^31) + 1: a peeled lattice key
constexpr int kMaxExchange = 27;        // candidates reduced in one exchange
constexpr int kMaxFloats = 8;           // floats reduced in one exchange

enum CrushMode { kNone = 0, kLadder = 1, kExhaustive = 2, kGuess = 3 };

__device__ __forceinline__ int mult_for(int s) {
  // (1 << s) + bit-replication bias for s = 0..7; 0 for a dropped axis
  switch (s) {
    case 0: return 1;
    case 1: return 2;
    case 2: return 4;
    case 3: return 8;
    case 4: return 17;
    case 5: return 36;
    case 6: return 85;
    case 7: return 255;
    default: return 0;
  }
}

// Sum of x over the block's 64 pixels in the reference's halving-tree order.
__device__ __forceinline__ float tree_sum(float lo, float hi) {
  float s = lo + hi;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = s + __shfl_xor_sync(kFull, s, off);
  return s;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float inv_or_zero(float x) {
  return x > 0.0f ? 1.0f / fmaxf(x, kTiny) : 0.0f;
}

__device__ __forceinline__ int round_half_up(float x) {
  return (int)floorf(x + 0.5f);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// ops/dither.py dither_bits: counter = block * 192 + axis * 64 + pixel, with
// block the row-major index of the 8x8 block in the image.
__device__ __forceinline__ uint32_t dither_bits(uint32_t key, uint32_t block,
                                                int axis, int pixel) {
  uint32_t ctr = block * 192u + (uint32_t)(axis * kP + pixel);
  return fmix32(fmix32(ctr ^ key) + key);
}

// int32 products with wrap-around, as in the reference's int32 tensors.
__device__ __forceinline__ int mul_wrap(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int sel9(const int (&v)[9], int s) {
  int out = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) out = (s == i) ? v[i] : out;
  return out;
}

__device__ __forceinline__ int sel4(const int (&v)[4], int o) {
  int out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) out = (o == i) ? v[i] : out;
  return out;
}

// ---------------------------------------------------------------------------
// Region reducers. Every member is called by all threads of the CTA with
// warp-uniform arguments; a block's own value goes in, its region's comes out.
// ---------------------------------------------------------------------------

struct BlockReducer {
  template <int N> __device__ void sum(float (&)[N]) const {}
  template <int N> __device__ void min(float (&)[N]) const {}
  template <int N> __device__ void max(float (&)[N]) const {}
  __device__ int sum_int(int v) const { return v; }
  template <int N> __device__ void crush(int (&)[N], int (&)[N]) const {}
};

// Shared-memory scratch of the warps of one square of blocks: W warps in
// each of CTAS CTAs (a thread block cluster when CTAS > 1, read through
// distributed shared memory), laid out [value][warp] in each CTA:
// 2 * kMaxExchange ints and kMaxFloats floats per warp. ``warp`` is the
// warp's index in the square, rank * W + the warp's index in its CTA.
template <int W, int CTAS>
struct Exchange {
  int* ibuf;
  float* fbuf;
  int warp, lane;

  __device__ void barrier() const {
    if constexpr (CTAS == 1) {
      __syncthreads();
    } else {
      cooperative_groups::this_cluster().sync();
    }
  }
  template <class T>
  __device__ T* slot(T* buf, int i, int g) const {
    if constexpr (CTAS == 1) {
      return buf + i * W + g;
    } else {
      return cooperative_groups::this_cluster().map_shared_rank(buf + i * W + g % W, g / W);
    }
  }
  // Offset of this warp's value i in its own CTA's buffers.
  __device__ int own(int i) const { return i * W + (CTAS == 1 ? warp : warp % W); }
  // Value i of square warp g, after a put.
  __device__ int iget(int i, int g) const { return *slot(ibuf, i, g); }
  __device__ float fget(int i, int g) const { return *slot(fbuf, i, g); }

  // Publish n values of this warp (lane 0 writes), then barrier.
  __device__ void put_ints(const int* v, int n) const {
    if (lane == 0)
      for (int i = 0; i < n; ++i) ibuf[own(i)] = v[i];
    barrier();
  }
  __device__ void put_floats(const float* v, int n) const {
    if (lane == 0)
      for (int i = 0; i < n; ++i) fbuf[own(i)] = v[i];
    barrier();
  }
  // Ends an exchange: no warp overwrites a slot that another still reads.
  __device__ void done() const { barrier(); }
};

// Pairwise-adjacent tree over the GROUP values get(0..GROUP).
template <int GROUP, class Get, class Op>
__device__ __forceinline__ float pair_tree(Get get, Op op) {
  float t[GROUP];
#pragma unroll
  for (int i = 0; i < GROUP; ++i) t[i] = get(i);
#pragma unroll
  for (int n = GROUP; n > 1; n >>= 1) {
#pragma unroll
    for (int i = 0; i < n / 2; ++i) t[i] = op(t[2 * i], t[2 * i + 1]);
  }
  return t[0];
}

struct AddOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct MinOp {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

template <class Ex, int GROUP>
struct GroupReducer {
  Ex ex;

  __device__ int base() const { return ex.warp & ~(GROUP - 1); }

  template <int N, class Op>
  __device__ void tree(float (&v)[N], Op op) const {
    if constexpr (GROUP > 1) {
      ex.put_floats(v, N);
      const int b = base();
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = pair_tree<GROUP>([&](int k) { return ex.fget(i, b + k); }, op);
      ex.done();
    }
  }
  template <int N> __device__ void sum(float (&v)[N]) const { tree(v, AddOp()); }
  template <int N> __device__ void min(float (&v)[N]) const { tree(v, MinOp()); }
  template <int N> __device__ void max(float (&v)[N]) const { tree(v, MaxOp()); }

  // op over the group: 0 = sum, 1 = and, 2 = or
  __device__ int fold_int(int v, int op) const {
    if constexpr (GROUP == 1) {
      return v;
    } else {
      ex.put_ints(&v, 1);
      const int b = base();
      int acc = ex.iget(0, b);
      for (int k = 1; k < GROUP; ++k) {
        const int x = ex.iget(0, b + k);
        acc = op == 0 ? add_wrap(acc, x) : (op == 1 ? (acc & x) : (acc | x));
      }
      ex.done();
      return acc;
    }
  }
  __device__ int sum_int(int v) const { return fold_int(v, 0); }
};

// Each warp's region is the aligned group of 4^owner warps holding it, in a
// square of 4^L warps.
template <class Ex, int L>
struct OwnerReducer {
  Ex ex;
  int owner;

  __device__ int group() const { return 1 << (2 * owner); }
  __device__ int base() const { return ex.warp & ~(group() - 1); }

  __device__ int sum_int(int v) const {
    ex.put_ints(&v, 1);
    int acc = 0;
    for (int k = 0; k < group(); ++k) acc = add_wrap(acc, ex.iget(0, base() + k));
    ex.done();
    return acc;
  }

  // Region float sum: the pairwise tree of the owner-level group.
  __device__ float sum_float(float v) const {
    ex.put_floats(&v, 1);
    const float out = level_sum<1>(v);
    ex.done();
    return out;
  }

  template <int LVL>
  __device__ float level_sum(float out) const {
    if constexpr (LVL > L) {
      return out;
    } else {
      constexpr int kGroup = 1 << (2 * LVL);
      if (owner == LVL) {
        const int b = ex.warp & ~(kGroup - 1);
        out = pair_tree<kGroup>([&](int k) { return ex.fget(0, b + k); }, AddOp());
      }
      return level_sum<LVL + 1>(out);
    }
  }

  // Region pixel max and block-error sum of N candidates.
  template <int N>
  __device__ void crush(int (&pm)[N], int (&be)[N]) const {
    if (ex.lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        ex.ibuf[ex.own(i)] = pm[i];
        ex.ibuf[ex.own(N + i)] = be[i];
      }
    }
    ex.barrier();
    const int g = group(), b = base();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int m = ex.iget(i, b), s = ex.iget(N + i, b);
      for (int k = 1; k < g; ++k) {
        m = max(m, ex.iget(i, b + k));
        s = add_wrap(s, ex.iget(N + i, b + k));
      }
      pm[i] = m;
      be[i] = s;
    }
    ex.done();
  }
};

// ---------------------------------------------------------------------------
// One block's pixels and crush state
// ---------------------------------------------------------------------------

template <int CH>
struct Pixels {
  int px[CH][2];
  float pxf[CH][2];
  int mask[2];
  float mf[2];

  // word: RGBA bytes, R lowest; valid: inside the image
  __device__ void set(int j, uint32_t word, bool valid) {
    mask[j] = valid ? 1 : 0;
    mf[j] = (float)mask[j];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      px[c][j] = valid ? (int)((word >> (8 * c)) & 0xFFu) : 0;
      pxf[c][j] = (float)px[c][j];
    }
  }
};

template <int CH>
struct Block {
  int px[CH][2];
  int mask[2];
  int f8[3][2];
  int n_int[3][CH];  // axis normals: max - min
  int m_int[3][CH];  // axis offsets: dirA_min, dirB_offset, dirC_offset
  int count;         // region pixel count
  int max_pix, max_blk;
  int es;            // block-error pre-scale (ops/crush.py err_scale_shift)
  bool floors;
  int floor_pix, floor_blk;

  // Sets the decode normals and offsets from the six endpoint rows.
  __device__ void set_endpoints(const int (&ep)[6][CH]) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        n_int[k][c] = ep[2 * k + 1][c] - ep[2 * k][c];
        m_int[k][c] = ep[2 * k][c];
      }
    }
  }

  // Exact per-block (pixel max, block error) of one shift triple;
  // warp-uniform. The block error sums err >> es.
  __device__ __forceinline__ void eval(const int s[3], int& pm, int& be) const {
    int err[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int est[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) est[c] = 0;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        int se = min(s[k], 8);
        int fdec = (f8[k][j] >> se) * mult_for(se);
        bool dropped = s[k] > 7;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          int n = dropped ? 0 : n_int[k][c];
          int m = (k == 0 || !dropped) ? m_int[k][c] : 0;
          est[c] += m + ((fdec * n + 128) >> 8);
        }
      }
      err[j] = weighted_err(est, j) * mask[j];
    }
    pm = __reduce_max_sync(kFull, max(err[0], err[1]));
    be = __reduce_add_sync(kFull, (err[0] >> es) + (err[1] >> es));
  }

  // Weighted error of clamped estimates against pixel j (limg_color_error).
  __device__ __forceinline__ int weighted_err(const int est[CH], int j) const {
    int d2[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      int d = min(max(est[c], 0), 255) - px[c][j];
      d2[c] = d * d;
    }
    bool lo = d2[0] < 0x4000;
    int e = d2[0] * (lo ? 2 : 3) + d2[1] * 4 + d2[2] * (lo ? 3 : 2);
    if (CH == 4) e += d2[CH - 1] * 3;
    return e;
  }

  __device__ __forceinline__ bool admissible(int pm, int be) const {
    const float scale = (float)(0x10 << es);
    if (!floors) {
      if (es == 0) return pm <= max_pix && mul_wrap(be, 0x10) < mul_wrap(max_blk, count);
      return pm <= max_pix && (float)be * scale < (float)count * (float)max_blk;
    }
    float lhs = (float)be * scale;
    float rhs = (float)count * (float)max_blk + (float)floor_blk * scale;
    return pm <= max_pix + floor_pix && lhs < rhs;
  }
};

// ---------------------------------------------------------------------------
// Fit + factor extraction (ops/fit.py fit_regions, ops/factors.py)
// ---------------------------------------------------------------------------

// Sign-corrected unit-vector mean (ops/fit.py _signed_unit_mean).
template <int CH, class Red>
__device__ __forceinline__ void signed_unit_mean(const float (&v)[CH][2], const float mf[2],
                                                 float inv_count, const Red& red,
                                                 float (&dir)[CH]) {
  float inv_len[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float len_sq = v[0][j] * v[0][j];
    float best = fabsf(v[0][j]);
    float lead = v[0][j];
#pragma unroll
    for (int c = 1; c < CH; ++c) {
      len_sq = len_sq + v[c][j] * v[c][j];
      float a = fabsf(v[c][j]);
      if (a > best) {
        best = a;
        lead = v[c][j];
      }
    }
    float il = len_sq > 0.0f ? 1.0f / sqrtf(fmaxf(len_sq, kTiny)) : 0.0f;
    il = lead < 0.0f ? -il : il;
    inv_len[j] = il * mf[j];
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) dir[c] = tree_sum(v[c][0] * inv_len[0], v[c][1] * inv_len[1]);
  red.sum(dir);
#pragma unroll
  for (int c = 0; c < CH; ++c) dir[c] = dir[c] * inv_count;
}

// Per-pixel projection factor dot(v, d) / |d|^2 (0 for a zero direction).
template <int CH>
__device__ __forceinline__ float project(const float (&v)[CH][2], int j, const float (&d)[CH],
                                         float inv_d2) {
  float dot = v[0][j] * d[0];
#pragma unroll
  for (int c = 1; c < CH; ++c) dot = dot + v[c][j] * d[c];
  return dot * inv_d2;
}

template <int CH>
__device__ __forceinline__ float dot_self(const float (&d)[CH]) {
  float s = d[0] * d[0];
#pragma unroll
  for (int c = 1; c < CH; ++c) s = s + d[c] * d[c];
  return s;
}

// Masked 3-axis fit of the reducer's region, then the u8 factors of this
// warp's pixels against the region's rounded endpoints. Outputs the region
// pixel count, avg, the six endpoint rows (dirA_min, dirA_max, dirB_offset,
// dirB_mag, dirC_offset, dirC_mag) and f8[axis][j].
template <int CH, class Red>
__device__ void fit_and_factors(const Pixels<CH>& p, const Red& red, int& count,
                                float (&avg)[CH], int (&ep)[6][CH], int (&f8)[3][2]) {
  count = red.sum_int(__reduce_add_sync(kFull, p.mask[0] + p.mask[1]));
  const float inv_count = 1.0f / fmaxf((float)count, 1.0f);

  float corrected[CH][2];
#pragma unroll
  for (int c = 0; c < CH; ++c) avg[c] = tree_sum(p.pxf[c][0] * p.mf[0], p.pxf[c][1] * p.mf[1]);
  red.sum(avg);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    avg[c] = avg[c] * inv_count;
#pragma unroll
    for (int j = 0; j < 2; ++j) corrected[c][j] = (p.pxf[c][j] - avg[c]) * p.mf[j];
  }
  float dir_a[CH];
  signed_unit_mean<CH>(corrected, p.mf, inv_count, red, dir_a);
  const float inv_a = inv_or_zero(dot_self<CH>(dir_a));

  float fac_a[2], est[CH][2], resid_a[CH][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    fac_a[j] = project<CH>(corrected, j, dir_a, inv_a) * p.mf[j];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      est[c][j] = avg[c] + fac_a[j] * dir_a[c];
      resid_a[c][j] = (p.pxf[c][j] - est[c][j]) * p.mf[j];
    }
  }
  float dir_b[CH];
  signed_unit_mean<CH>(resid_a, p.mf, inv_count, red, dir_b);
  const float inv_b = inv_or_zero(dot_self<CH>(dir_b));

  float fac_b[2], resid_ab[CH][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    fac_b[j] = project<CH>(resid_a, j, dir_b, inv_b) * p.mf[j];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float est_b = est[c][j] + fac_b[j] * dir_b[c];
      resid_ab[c][j] = (p.pxf[c][j] - est_b) * p.mf[j];
    }
  }
  float dir_c[CH];
  if (CH == 3) {
    dir_c[0] = dir_a[1] * dir_b[2] - dir_a[2] * dir_b[1];
    dir_c[1] = dir_a[2] * dir_b[0] - dir_a[0] * dir_b[2];
    dir_c[2] = dir_a[0] * dir_b[1] - dir_a[1] * dir_b[0];
  } else {
    signed_unit_mean<CH>(resid_ab, p.mf, inv_count, red, dir_c);
  }
  const float inv_c = inv_or_zero(dot_self<CH>(dir_c));

  float mn[3] = {kBig, kBig, kBig}, mx[3] = {-kBig, -kBig, -kBig};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float f[3];
    f[0] = fac_a[j];
    f[1] = fac_b[j];
    f[2] = project<CH>(resid_ab, j, dir_c, inv_c) * p.mf[j];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      mn[k] = fminf(mn[k], p.mask[j] ? f[k] : kBig);
      mx[k] = fmaxf(mx[k], p.mask[j] ? f[k] : -kBig);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mn[k] = warp_min(mn[k]);
    mx[k] = warp_max(mx[k]);
  }
  red.min(mn);
  red.max(mx);
  const bool flat = dot_self<CH>(dir_a) <= 0.0f;

#pragma unroll
  for (int c = 0; c < CH; ++c) {
    ep[0][c] = round_half_up(avg[c] + mn[0] * dir_a[c]);
    ep[1][c] = round_half_up(avg[c] + mx[0] * dir_a[c]);
    ep[2][c] = round_half_up(flat ? 0.0f : mn[1] * dir_b[c]);
    ep[3][c] = round_half_up(flat ? 0.0f : mx[1] * dir_b[c]);
    ep[4][c] = round_half_up(flat ? 0.0f : mn[2] * dir_c[c]);
    ep[5][c] = round_half_up(flat ? 0.0f : mx[2] * dir_c[c]);
  }

  // factor extraction on the rounded endpoints
  float na[CH], nbv[CH], nc[CH], min_a[CH], off_b[CH], off_c[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    na[c] = (float)(ep[1][c] - ep[0][c]);
    nbv[c] = (float)(ep[3][c] - ep[2][c]);
    nc[c] = (float)(ep[5][c] - ep[4][c]);
    min_a[c] = (float)ep[0][c];
    off_b[c] = (float)ep[2][c];
    off_c[c] = (float)ep[4][c];
  }
  const float ila = inv_or_zero(dot_self<CH>(na));
  const float ilb = inv_or_zero(dot_self<CH>(nbv));
  const float ilc = inv_or_zero(dot_self<CH>(nc));
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float dot = (p.pxf[0][j] - min_a[0]) * na[0];
#pragma unroll
    for (int c = 1; c < CH; ++c) dot = dot + (p.pxf[c][j] - min_a[c]) * na[c];
    const float fa = dot * ila;
    float ea[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) ea[c] = min_a[c] + fa * na[c];
    dot = (p.pxf[0][j] - ea[0] - off_b[0]) * nbv[0];
#pragma unroll
    for (int c = 1; c < CH; ++c) dot = dot + (p.pxf[c][j] - ea[c] - off_b[c]) * nbv[c];
    const float fb = dot * ilb;
    float eb[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) eb[c] = ea[c] + fb * nbv[c];
    dot = (p.pxf[0][j] - eb[0] - off_c[0]) * nc[0];
#pragma unroll
    for (int c = 1; c < CH; ++c) dot = dot + (p.pxf[c][j] - eb[c] - off_c[c]) * nc[c];
    const float fc = dot * ilc;
    const float f[3] = {fa, fb, fc};
#pragma unroll
    for (int k = 0; k < 3; ++k) f8[k][j] = (int)fminf(fmaxf(rintf(f[k] * 255.0f), 0.0f), 255.0f);
  }
}

// Reduced-factor modes: dropped axes' endpoints are zeroed before the search
// (ops/fit.py drop_decomposition_axes).
template <int CH>
__device__ __forceinline__ void drop_axes(int (&ep)[6][CH], int num_factors) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (num_factors < 3) ep[4][c] = ep[5][c] = 0;
    if (num_factors < 2) ep[2][c] = ep[3][c] = 0;
  }
}

// ---------------------------------------------------------------------------
// Crush search (ops/crush.py) on region values
// ---------------------------------------------------------------------------

// Folds one evaluated candidate into the running best (ops/crush.py _select).
template <int CH>
__device__ __forceinline__ void take_if_better(const Block<CH>& blk, const int s[3], int pm,
                                               int be, bool ties_to_later, int (&best)[3],
                                               int& b_tot, int& b_err) {
  const int tot = s[0] + s[1] + s[2];
  const bool better = ties_to_later ? be <= b_err : be < b_err;
  if (blk.admissible(pm, be) && (tot > b_tot || (tot == b_tot && better))) {
    best[0] = s[0];
    best[1] = s[1];
    best[2] = s[2];
    b_tot = tot;
    b_err = be;
  }
}

// The shift triple of this warp's region; statically dropped axes get 8.
template <int CH, class Red>
__device__ void crush_search(Block<CH>& blk, const Red& red, int crush_mode, int ladder_k,
                             int num_factors, int lane, int (&best)[3]) {
  best[0] = best[1] = best[2] = 0;
  blk.floors = false;
  blk.floor_pix = blk.floor_blk = 0;
  if (crush_mode != kNone && num_factors < 3) {
    const int zero[3] = {0, 0, 0};
    int pm[1], be[1];
    blk.eval(zero, pm[0], be[0]);
    red.crush(pm, be);
    blk.floor_pix = pm[0];
    blk.floor_blk = be[0];
    blk.floors = true;
  }

  if (crush_mode == kExhaustive) {
    // all 729 triples in ascending lex order, 9 per exchange; ties to later
    int b_tot = -1, b_err = 2147483647;
    for (int i0 = 0; i0 < 729; i0 += 9) {
      int pm[9], be[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const int s[3] = {(i0 + i) / 81, ((i0 + i) / 9) % 9, i};
        blk.eval(s, pm[i], be[i]);
      }
      red.crush(pm, be);
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const int s[3] = {(i0 + i) / 81, ((i0 + i) / 9) % 9, i};
        take_if_better(blk, s, pm[i], be[i], true, best, b_tot, b_err);
      }
    }
  } else if (crush_mode == kGuess) {
    const int g[4][3] = {{4, 5, 6}, {5, 8, 8}, {4, 6, 8}, {2, 4, 5}};
    int pm[4], be[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) blk.eval(g[t], pm[t], be[t]);
    red.crush(pm, be);
    bool ok[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) ok[t] = blk.admissible(pm[t], be[t]);
    const int pick = ok[0] ? (ok[1] ? 1 : (ok[2] ? 2 : 0)) : (ok[3] ? 3 : -1);
    if (pick >= 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) best[k] = g[pick][k];
    }
  } else if (crush_mode == kLadder) {
    // 27 per-axis sweeps: axis a at shift s, the other axes unquantized
    int pm27[27], be27[27];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        int t[3] = {0, 0, 0};
        t[a] = s;
        blk.eval(t, pm27[9 * a + s], be27[9 * a + s]);
      }
    }
    red.crush(pm27, be27);
    // per-axis base = largest axis-alone-admissible shift; 4^3 box below it
    int base[3], s_cand[3][4], d_blk[3][4], d_pix[3][4];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      int pm_ax[9], be_ax[9];
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        pm_ax[s] = pm27[9 * a + s];
        be_ax[s] = be27[9 * a + s];
      }
      base[a] = 0;
#pragma unroll
      for (int s = 0; s < 9; ++s)
        if (blk.admissible(pm_ax[s], be_ax[s])) base[a] = s;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int s = max(base[a] - o, 0);
        s_cand[a][o] = s;
        d_blk[a][o] = sel9(be_ax, s) - be_ax[0];
        d_pix[a][o] = sel9(pm_ax, s) - pm_ax[0];
      }
    }
    const int err0 = be27[0], pix0 = pm27[0];
    // lattice keys, index oa * 16 + ob * 4 + oc; this lane holds lane, lane + 32
    int key[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = lane + 32 * j;
      const int oa = idx / 16, ob = (idx / 4) % 4, oc = idx % 4;
      const int ablk = err0 + (sel4(d_blk[0], oa) + sel4(d_blk[1], ob) + sel4(d_blk[2], oc));
      const int apix = pix0 + (sel4(d_pix[0], oa) + sel4(d_pix[1], ob) + sel4(d_pix[2], oc));
      const int tot = sel4(s_cand[0], oa) + sel4(s_cand[1], ob) + sel4(s_cand[2], oc);
      const int adm = blk.admissible(apix, ablk) ? 1 : 0;
      const int err_pack = (33554431) - min(ablk >> 6, 33554431);
      key[j] = (int)(((uint32_t)adm << 30) + ((uint32_t)tot << 25) + (uint32_t)err_pack);
    }
    // peel the K best by argmax (min index on ties); verify best-ranked first
    int b_tot = -1, b_err = 2147483647;
    for (int r = 0; r < ladder_k; ++r) {
      const int m = __reduce_max_sync(kFull, max(key[0], key[1]));
      const int mine = key[0] == m ? lane : (key[1] == m ? lane + 32 : kP);
      const int idx = (int)__reduce_min_sync(kFull, (unsigned)mine);
      if (idx == lane) key[0] = kSentinel;
      if (idx == lane + 32) key[1] = kSentinel;
      const int s[3] = {max(base[0] - idx / 16, 0), max(base[1] - (idx / 4) % 4, 0),
                        max(base[2] - idx % 4, 0)};
      int pm[1], be[1];
      blk.eval(s, pm[0], be[0]);
      red.crush(pm, be);
      take_if_better(blk, s, pm[0], be[0], false, best, b_tot, b_err);
    }
  }
  // statically dropped axes always store shift 8
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (k >= num_factors) best[k] = max(best[k], 8);
}

// ---------------------------------------------------------------------------
// Dither + crush, integer decode, weighted error (ops/dither.py, decode.py)
// ---------------------------------------------------------------------------

template <int CH>
__device__ void dither_decode(const Block<CH>& blk, const int (&best)[3], bool dither,
                              uint32_t key, uint32_t block_id, int lane, int (&q)[3][2],
                              int (&dec)[CH][2], float (&err_f)[2]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int s = best[k];
    const int se = min(s, 8);
    const bool live = dither && s > 0 && s < 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int v = blk.f8[k][j];
      if (live) {
        const uint32_t bits = dither_bits(key, block_id, k, lane + 32 * j);
        const int noise = (int)(bits & ((1u << s) - 1u)) - (1 << max(s - 1, 0));
        v = min(max(v + noise, 0), 255);
      }
      q[k][j] = v >> se;
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    int e[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) e[c] = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int s = best[k];
      const int fdec = q[k][j] * mult_for(min(s, 8));
      const bool dropped = s > 7;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int n = dropped ? 0 : blk.n_int[k][c];
        const int m = (k == 0 || !dropped) ? blk.m_int[k][c] : 0;
        e[c] += m + ((fdec * n + 128) >> 8);
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) dec[c][j] = min(max(e[c], 0), 255);
    err_f[j] = (float)(blk.weighted_err(e, j) * blk.mask[j]);
  }
}

// Packed decoded word: R lowest, alpha 0xFF for RGB.
template <int CH>
__device__ __forceinline__ int32_t pack_decoded(const int (&dec)[CH][2], int j) {
  uint32_t w = (uint32_t)dec[0][j] | ((uint32_t)dec[1][j] << 8) | ((uint32_t)dec[2][j] << 16);
  w |= (CH == 4) ? ((uint32_t)dec[CH - 1][j] << 24) : 0xFF000000u;
  return (int32_t)w;
}

}  // namespace limg
