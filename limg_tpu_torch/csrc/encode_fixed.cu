// Fixed-grid block encode for NVIDIA Hopper (sm_90a), one 8x8 block per warp.
//
// Replaces the TPU kernel limg_tpu/pallas_kernels/encode_fixed.py:
// encode_blocks_pallas (:808) at P = 64, i.e. the mono kernel
// _make_mono_kernel (:739) with _fit_and_factors (:258) and
// _crush_dither_decode (:347). Per block it runs the masked 3-axis fit,
// the u8 factor extraction, the crush search (ladder / exhaustive / guess),
// the num_factors drops, dither, the integer decode and the weighted error.
//
// What bounds it on the H100: a 4K RGBA image is 33 MB of packed pixels
// read once, about 10 us of HBM time at 3.35 TB/s, while every block runs
// 35+ exact candidate decodes (27 sweeps + ladder_k verifications; 729 in
// exhaustive mode) of ~40 integer operations per pixel and channel. The
// kernel is compute-bound on those evaluations.
//
// What the design does about it: a block's 64 pixels live in the registers
// of one warp (lane l holds pixels l and l + 32), so no candidate
// evaluation touches memory; per-block reductions are warp shuffles, and
// the ladder's 64 lattice keys sit two per lane for the argmax peeling.
// The wrapper hands the kernel a block-major (NB, 64) copy so that each
// warp reads 256 contiguous bytes. No tensor cores, TMA or tuning yet.
//
// Bit-exactness with the plain PyTorch version (kernels/encode_fixed.py:
// encode_blocks_reference) rests on:
// - one fixed float summation order: x[l] + x[l+32], then butterfly
//   shuffles at 16, 8, 4, 2, 1, the same values as the reference's
//   halving tree x[:n/2] + x[n/2:]; channel sums are left folds;
// - no contraction of a * b + c (build with --fmad=false) and exact
//   1.0f / sqrtf(x) (no --use_fast_math);
// - integer arithmetic with int32 wrap-around everywhere else;
// - the counter hash of ops/dither.py for the dither noise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 64;
constexpr int kWarpsPerCta = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1e-38f;
constexpr float kBig = 3.4e38f;
constexpr int kSentinel = -2147483647;  // -(2^31) + 1: a peeled lattice key

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

// ops/dither.py dither_bits: counter = block * 192 + axis * 64 + pixel.
__device__ __forceinline__ uint32_t dither_bits(uint32_t key, uint32_t block,
                                                int axis, int pixel) {
  uint32_t ctr = block * 192u + (uint32_t)(axis * kP + pixel);
  return fmix32(fmix32(ctr ^ key) + key);
}

// int32 products with wrap-around, as in the reference's int32 tensors.
__device__ __forceinline__ int mul_wrap(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

template <int CH>
struct Block {
  // per-lane pixels j = 0 (pixel lane) and j = 1 (pixel lane + 32)
  int px[CH][2];
  int mask[2];
  int f8[3][2];
  int n_int[3][CH];  // axis normals: max - min
  int m_int[3][CH];  // axis offsets: dirA_min, dirB_offset, dirC_offset
  int count;
  int max_pix, max_blk;
  bool floors;
  int floor_pix, floor_blk;

  // Exact (pixel max, block error) of one shift triple; warp-uniform.
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
    be = __reduce_add_sync(kFull, err[0] + err[1]);
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
    if (!floors) {
      return pm <= max_pix && mul_wrap(be, 0x10) < mul_wrap(max_blk, count);
    }
    float lhs = (float)be * 16.0f;
    float rhs = (float)count * (float)max_blk + (float)floor_blk * 16.0f;
    return pm <= max_pix + floor_pix && lhs < rhs;
  }
};

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

// Sign-corrected unit-vector mean (ops/fit.py _signed_unit_mean).
template <int CH>
__device__ __forceinline__ void signed_unit_mean(const float (&v)[CH][2], const float mf[2],
                                                 float inv_count, float (&dir)[CH]) {
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
  for (int c = 0; c < CH; ++c)
    dir[c] = tree_sum(v[c][0] * inv_len[0], v[c][1] * inv_len[1]) * inv_count;
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

template <int CH>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
encode_fixed_p64_kernel(const int32_t* __restrict__ packed, const uint8_t* __restrict__ mask_in,
                        int nb, int crush_mode, int dither, int ladder_k, int num_factors,
                        int max_pix, int max_blk, uint32_t key, int32_t* __restrict__ shifts_out,
                        int32_t* __restrict__ q_out, int32_t* __restrict__ dec_out,
                        float* __restrict__ dist_out, int32_t* __restrict__ eps_out,
                        float* __restrict__ avg_out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (b >= nb) return;  // whole warps exit together

  Block<CH> blk;
  float pxf[CH][2], mf[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t at = (size_t)b * kP + lane + 32 * j;
    const uint32_t w = (uint32_t)packed[at];
    blk.mask[j] = mask_in[at] ? 1 : 0;
    mf[j] = (float)blk.mask[j];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      blk.px[c][j] = (int)((w >> (8 * c)) & 0xFFu);
      pxf[c][j] = (float)blk.px[c][j];
    }
  }
  blk.count = __reduce_add_sync(kFull, blk.mask[0] + blk.mask[1]);
  const float inv_count = 1.0f / fmaxf((float)blk.count, 1.0f);

  // ---- fit (ops/fit.py fit_blocks) -----------------------------------------
  float avg[CH], corrected[CH][2];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    avg[c] = tree_sum(pxf[c][0] * mf[0], pxf[c][1] * mf[1]) * inv_count;
#pragma unroll
    for (int j = 0; j < 2; ++j) corrected[c][j] = (pxf[c][j] - avg[c]) * mf[j];
  }
  float dir_a[CH];
  signed_unit_mean<CH>(corrected, mf, inv_count, dir_a);
  const float inv_a = inv_or_zero(dot_self<CH>(dir_a));

  float fac_a[2], est[CH][2], resid_a[CH][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    fac_a[j] = project<CH>(corrected, j, dir_a, inv_a) * mf[j];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      est[c][j] = avg[c] + fac_a[j] * dir_a[c];
      resid_a[c][j] = (pxf[c][j] - est[c][j]) * mf[j];
    }
  }
  float dir_b[CH];
  signed_unit_mean<CH>(resid_a, mf, inv_count, dir_b);
  const float inv_b = inv_or_zero(dot_self<CH>(dir_b));

  float fac_b[2], resid_ab[CH][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    fac_b[j] = project<CH>(resid_a, j, dir_b, inv_b) * mf[j];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float est_b = est[c][j] + fac_b[j] * dir_b[c];
      resid_ab[c][j] = (pxf[c][j] - est_b) * mf[j];
    }
  }
  float dir_c[CH];
  if (CH == 3) {
    dir_c[0] = dir_a[1] * dir_b[2] - dir_a[2] * dir_b[1];
    dir_c[1] = dir_a[2] * dir_b[0] - dir_a[0] * dir_b[2];
    dir_c[2] = dir_a[0] * dir_b[1] - dir_a[1] * dir_b[0];
  } else {
    signed_unit_mean<CH>(resid_ab, mf, inv_count, dir_c);
  }
  const float inv_c = inv_or_zero(dot_self<CH>(dir_c));

  float mn[3] = {kBig, kBig, kBig}, mx[3] = {-kBig, -kBig, -kBig};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float f[3];
    f[0] = fac_a[j];
    f[1] = fac_b[j];
    f[2] = project<CH>(resid_ab, j, dir_c, inv_c) * mf[j];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      mn[k] = fminf(mn[k], blk.mask[j] ? f[k] : kBig);
      mx[k] = fmaxf(mx[k], blk.mask[j] ? f[k] : -kBig);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mn[k] = warp_min(mn[k]);
    mx[k] = warp_max(mx[k]);
  }
  const bool flat = dot_self<CH>(dir_a) <= 0.0f;

  int ep[6][CH];  // dirA_min, dirA_max, dirB_offset, dirB_mag, dirC_offset, dirC_mag
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    ep[0][c] = round_half_up(avg[c] + mn[0] * dir_a[c]);
    ep[1][c] = round_half_up(avg[c] + mx[0] * dir_a[c]);
    ep[2][c] = round_half_up(flat ? 0.0f : mn[1] * dir_b[c]);
    ep[3][c] = round_half_up(flat ? 0.0f : mx[1] * dir_b[c]);
    ep[4][c] = round_half_up(flat ? 0.0f : mn[2] * dir_c[c]);
    ep[5][c] = round_half_up(flat ? 0.0f : mx[2] * dir_c[c]);
  }

  // ---- factor extraction (ops/factors.py) on the rounded endpoints --------
  {
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
      float dot = (pxf[0][j] - min_a[0]) * na[0];
#pragma unroll
      for (int c = 1; c < CH; ++c) dot = dot + (pxf[c][j] - min_a[c]) * na[c];
      const float fa = dot * ila;
      float ea[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) ea[c] = min_a[c] + fa * na[c];
      dot = (pxf[0][j] - ea[0] - off_b[0]) * nbv[0];
#pragma unroll
      for (int c = 1; c < CH; ++c) dot = dot + (pxf[c][j] - ea[c] - off_b[c]) * nbv[c];
      const float fb = dot * ilb;
      float eb[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) eb[c] = ea[c] + fb * nbv[c];
      dot = (pxf[0][j] - eb[0] - off_c[0]) * nc[0];
#pragma unroll
      for (int c = 1; c < CH; ++c) dot = dot + (pxf[c][j] - eb[c] - off_c[c]) * nc[c];
      const float fc = dot * ilc;
      const float f[3] = {fa, fb, fc};
#pragma unroll
      for (int k = 0; k < 3; ++k)
        blk.f8[k][j] = (int)fminf(fmaxf(rintf(f[k] * 255.0f), 0.0f), 255.0f);
    }
  }

  // reduced-factor modes: dropped axes' endpoints are zeroed before the search
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (num_factors < 3) ep[4][c] = ep[5][c] = 0;
    if (num_factors < 2) ep[2][c] = ep[3][c] = 0;
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      blk.n_int[k][c] = ep[2 * k + 1][c] - ep[2 * k][c];
      blk.m_int[k][c] = ep[2 * k][c];
    }
  }
  blk.max_pix = max_pix;
  blk.max_blk = max_blk;
  blk.floors = false;
  blk.floor_pix = blk.floor_blk = 0;
  if (crush_mode != kNone && num_factors < 3) {
    const int zero[3] = {0, 0, 0};
    blk.eval(zero, blk.floor_pix, blk.floor_blk);
    blk.floors = true;
  }

  // ---- crush search (ops/crush.py) ----------------------------------------
  int best[3] = {0, 0, 0};
  if (crush_mode == kExhaustive) {
    int b_tot = -1, b_err = 2147483647;
    for (int i = 0; i < 729; ++i) {
      const int s[3] = {i / 81, (i / 9) % 9, i % 9};
      int pm, be;
      blk.eval(s, pm, be);
      const int tot = s[0] + s[1] + s[2];
      if (blk.admissible(pm, be) && (tot > b_tot || (tot == b_tot && be <= b_err))) {
        best[0] = s[0];
        best[1] = s[1];
        best[2] = s[2];
        b_tot = tot;
        b_err = be;
      }
    }
  } else if (crush_mode == kGuess) {
    const int g[4][3] = {{4, 5, 6}, {5, 8, 8}, {4, 6, 8}, {2, 4, 5}};
    bool ok[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      int pm, be;
      blk.eval(g[t], pm, be);
      ok[t] = blk.admissible(pm, be);
    }
    const int pick = ok[0] ? (ok[1] ? 1 : (ok[2] ? 2 : 0)) : (ok[3] ? 3 : -1);
    if (pick >= 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) best[k] = g[pick][k];
    }
  } else if (crush_mode == kLadder) {
    // 27 per-axis sweeps: axis a at shift s, the other axes unquantized
    int pm_ax[3][9], be_ax[3][9];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        int t[3] = {0, 0, 0};
        t[a] = s;
        blk.eval(t, pm_ax[a][s], be_ax[a][s]);
      }
    }
    // per-axis base = largest axis-alone-admissible shift; 4^3 box below it
    int base[3], s_cand[3][4], d_blk[3][4], d_pix[3][4];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      base[a] = 0;
#pragma unroll
      for (int s = 0; s < 9; ++s)
        if (blk.admissible(pm_ax[a][s], be_ax[a][s])) base[a] = s;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int s = max(base[a] - o, 0);
        s_cand[a][o] = s;
        d_blk[a][o] = sel9(be_ax[a], s) - be_ax[a][0];
        d_pix[a][o] = sel9(pm_ax[a], s) - pm_ax[a][0];
      }
    }
    const int err0 = be_ax[0][0], pix0 = pm_ax[0][0];
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
      int pm, be;
      blk.eval(s, pm, be);
      const int tot = s[0] + s[1] + s[2];
      if (blk.admissible(pm, be) && (tot > b_tot || (tot == b_tot && be < b_err))) {
        best[0] = s[0];
        best[1] = s[1];
        best[2] = s[2];
        b_tot = tot;
        b_err = be;
      }
    }
  }
  // statically dropped axes always store shift 8
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (k >= num_factors) best[k] = max(best[k], 8);

  // ---- dither + crush, decode, weighted error ------------------------------
  int q[3][2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int s = best[k];
    const int se = min(s, 8);
    const bool live = dither && s > 0 && s < 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int v = blk.f8[k][j];
      if (live) {
        const uint32_t bits = dither_bits(key, (uint32_t)b, k, lane + 32 * j);
        const int noise = (int)(bits & ((1u << s) - 1u)) - (1 << max(s - 1, 0));
        v = min(max(v + noise, 0), 255);
      }
      q[k][j] = v >> se;
    }
  }
  float err_f[2];
  int dec[CH][2];
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
  const float dist = tree_sum(err_f[0], err_f[1]);

  // ---- outputs -------------------------------------------------------------
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t at = (size_t)b * kP + lane + 32 * j;
    q_out[at] = q[0][j] | (q[1][j] << 8) | (q[2][j] << 16);
    uint32_t w = (uint32_t)dec[0][j] | ((uint32_t)dec[1][j] << 8) | ((uint32_t)dec[2][j] << 16);
    w |= (CH == 4) ? ((uint32_t)dec[CH - 1][j] << 24) : 0xFF000000u;
    dec_out[at] = (int32_t)w;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) shifts_out[(size_t)k * nb + b] = best[k];
    dist_out[b] = dist;
  }
  if (eps_out != nullptr && lane < CH) {
    // lane c writes channel c of the six endpoint rows and avg
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (c != lane) continue;
#pragma unroll
      for (int e = 0; e < 6; ++e) eps_out[((size_t)e * CH + c) * nb + b] = ep[e][c];
      avg_out[(size_t)c * nb + b] = avg[c];
    }
  }
}

}  // namespace

extern "C" {

// Launches the encode of nb blocks on `stream`. packed / mask are
// block-major (nb, 64): int32 RGBA words and 0/1 bytes. Outputs: shifts
// (3, nb), q and dec block-major (nb, 64) packed words, dist (nb,), and,
// when eps is not null, eps (6, channels, nb) and avg (channels, nb).
// Returns cudaGetLastError() after the launch.
int limg_encode_fixed_p64(const int32_t* packed, const uint8_t* mask, int nb, int channels,
                          int crush_mode, int dither, int ladder_k, int num_factors, int max_pix,
                          int max_blk, uint32_t key, int32_t* shifts, int32_t* q, int32_t* dec,
                          float* dist, int32_t* eps, float* avg, void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((nb + kWarpsPerCta - 1) / kWarpsPerCta));
  const dim3 block(kWarpsPerCta * 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (channels == 4) {
    encode_fixed_p64_kernel<4><<<grid, block, 0, st>>>(packed, mask, nb, crush_mode, dither,
                                                       ladder_k, num_factors, max_pix, max_blk,
                                                       key, shifts, q, dec, dist, eps, avg);
  } else {
    encode_fixed_p64_kernel<3><<<grid, block, 0, st>>>(packed, mask, nb, crush_mode, dither,
                                                       ladder_k, num_factors, max_pix, max_blk,
                                                       key, shifts, q, dec, dist, eps, avg);
  }
  return (int)cudaGetLastError();
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
