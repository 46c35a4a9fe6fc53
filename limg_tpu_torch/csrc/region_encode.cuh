// Region encode for NVIDIA Hopper (sm_90a): the kernel template of
// encode_fixed.cu (P = 64: the fixed grid's 8x8 blocks, and the RD policy's
// level 0) and encode_region.cu (P = 256, 1024 and 4096: the RD and dense
// levels' 16x16, 32x32 and 64x64 pixel regions, limg_tpu_torch/regions.py
// _encode_level; and every larger P = 4096 * 4^m, the dense path's levels 4
// and up, by encode_region_cluster_kernel at the end of this file).
//
// Replaces the TPU kernel limg_tpu/pallas_kernels/encode_fixed.py:
// encode_blocks_pallas (:808) at every P: the mono kernel _make_mono_kernel
// (:739) with _fit_and_factors (:258) and _crush_dither_decode (:347) at P
// = 64, 256 and 1024, and both halves of its split at P = 4096
// (_make_fit_kernel :764 and _make_crush_kernel :781, split only for the
// TPU's VMEM; here one pass, the fit's factors kept in registers). Per
// region: the masked 3-axis fit, the u8 factors, the crush search (ladder /
// exhaustive / guess), the num_factors drops, dither, the integer decode and
// the weighted error.
//
// What bounds it on the H100: a 4K level reads 33 MB of packed pixels and
// writes 66 MB of factor and decode words, about 30 us of HBM time, while
// every pixel goes through 33 exact candidate decodes at ladder K = 8 (25
// distinct sweeps, 24 of them one axis's decode on a shared base, then K
// full ones; 729 in exhaustive mode): the kernel is bound by those integer
// operations (chip_smoke.py kernel_bound) and by how its region reductions
// wait.
//
// The design is the owner crush's lane layout (encode_merged.cuh), whose
// search (crush_search.cuh CrushLane) it shares: every thread holds 8
// pixels of one region in registers, pixel p = t + T j (j < 8) of the T = P
// / 8 threads of the region, eight lanes a "block" of the search and four
// blocks a warp. So a region is
//   P = 64:   8 lanes (4 regions a warp; level 0 of the search),
//   P = 256:  one warp (level 1),
//   P = 1024: 4 warps (level 2),
//   P = 4096: 16 warps (level 3),
// and a CTA holds 32 regions, 8, 2 or 1 (8 warps; 16 at P = 4096). Regions
// of a warp or less pass no CTA barrier at all; a region of several warps
// passes one barrier per batch of values (the fit's four or five sums and
// folds, the search's two or three batches, the dist).
//
// Float sums over a region's P pixels follow the plain version's halving
// tree x[:n/2] + x[n/2:] (kernels/encode_fixed.py encode_blocks_reference,
// ops/fit.py tree_sum) exactly: the tree's first three levels pair a
// thread's own pixels (j + 4, j + 2, j + 1), the levels between threads of
// different warps are one shared-memory exchange (each warp then folds the
// region's warps in the tree's order for its lane), and the last five or
// three levels are xor butterflies 16 ... 1 or 4, 2, 1. The mapping of
// pixels to threads changes only who holds pixel p, never p: the dither
// hash keeps its key (region, axis, p, P). Channel dots are left folds;
// nvcc runs with --fmad=false and exact 1 / sqrt, so kernel and plain
// version agree bit for bit. Integer totals (counts, the crush's pixel
// maxima and error sums) and float minima and maxima do not depend on
// order.

#pragma once

#include "cluster.cuh"
#include "crush_search.cuh"

namespace {

using namespace limg;

template <int P>
struct RegionGeo {
  static constexpr int kT = P / 8;                 // threads of a region, 8 pixels each
  static constexpr int kW = kT / 32;               // warps of a region (0: several a warp)
  static constexpr int kLanes = kT < 32 ? kT : 32; // a region's lanes in one warp
  static constexpr int kLevel = P == 64 ? 0 : (P == 256 ? 1 : (P == 1024 ? 2 : 3));
  static constexpr int kWarps = P == 4096 ? 16 : 8;    // warps a CTA
  static constexpr int kRegions = kWarps * 32 / kT;    // regions a CTA
  static constexpr int kEs = P >= 2048 ? 4 : 0;        // ops/crush.py err_scale_shift(P)
  // one exchange set: 4 values per lane of every warp, one int per warp
  static constexpr int kXSet = kW >= 2 ? 4 * kWarps * 32 + kWarps : 1;
};

// The halving tree's in-thread levels over the thread's pixels t + T j:
// f(j, v) gives the N values of pixel j; out = ((v0 + v4) + (v2 + v6)) +
// ((v1 + v5) + (v3 + v7)).
template <int N, class F>
__device__ __forceinline__ void lane_tree(F f, float (&out)[N]) {
  float h[4][N];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float lo[N], hi[N];
    f(j, lo);
    f(j + 4, hi);
#pragma unroll
    for (int i = 0; i < N; ++i) h[j][i] = lo[i] + hi[i];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < N; ++i) h[j][i] = h[j][i] + h[j + 2][i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = h[0][i] + h[1][i];
}

// A region's reductions across its threads. Two slot sets alternate, so one
// barrier per exchange suffices: a warp writes a set again only after the
// next exchange's barrier, which every warp reaches after its reads of this
// one.
template <int P>
struct RegionExchange {
  using G = RegionGeo<P>;
  float* buf;  // [2][G::kXSet]
  int warp, lane, set;

  // The halving tree's levels across the region's threads, of N <= 4 values
  // each thread summed over its own pixels; with cnt, also the region's
  // total of an int (order-free).
  template <int N>
  __device__ void sum(float (&v)[N], int* cnt = nullptr) {
    if constexpr (G::kW < 2) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int off = G::kLanes / 2; off > 0; off >>= 1)
          v[i] = v[i] + __shfl_xor_sync(kFull, v[i], off);
      }
      if (cnt != nullptr) *cnt = butterfly<1, G::kLanes>(*cnt, IAdd());
    } else {
      float* s = buf + set * G::kXSet;
#pragma unroll
      for (int i = 0; i < N; ++i) s[(i * G::kWarps + warp) * 32 + lane] = v[i];
      if (cnt != nullptr) {
        const int c = __reduce_add_sync(kFull, *cnt);
        if (lane == 0) s[4 * G::kWarps * 32 + warp] = __int_as_float(c);
      }
      __syncthreads();
      const int w0 = warp & ~(G::kW - 1);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float x[G::kW];
#pragma unroll
        for (int w = 0; w < G::kW; ++w) x[w] = s[(i * G::kWarps + w0 + w) * 32 + lane];
#pragma unroll
        for (int n = G::kW / 2; n > 0; n >>= 1) {
#pragma unroll
          for (int w = 0; w < n; ++w) x[w] = x[w] + x[w + n];
        }
        v[i] = x[0];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v[i] = v[i] + __shfl_xor_sync(kFull, v[i], off);
      }
      if (cnt != nullptr) {
        int c = 0;
#pragma unroll
        for (int w = 0; w < G::kW; ++w)
          c = add_wrap(c, __float_as_int(s[4 * G::kWarps * 32 + w0 + w]));
        *cnt = c;
      }
      set ^= 1;
    }
  }

  // The region's minima and maxima of three values each (order-free).
  __device__ void fold(float (&mn)[3], float (&mx)[3]) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mn[i] = butterfly<1, G::kLanes>(mn[i], MinOp());
      mx[i] = butterfly<1, G::kLanes>(mx[i], MaxOp());
    }
    if constexpr (G::kW >= 2) {
      float* s = buf + set * G::kXSet;
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          s[i * G::kWarps + warp] = mn[i];
          s[(3 + i) * G::kWarps + warp] = mx[i];
        }
      }
      __syncthreads();
      const int w0 = warp & ~(G::kW - 1);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        mn[i] = s[i * G::kWarps + w0];
        mx[i] = s[(3 + i) * G::kWarps + w0];
#pragma unroll
        for (int w = 1; w < G::kW; ++w) {
          mn[i] = fminf(mn[i], s[i * G::kWarps + w0 + w]);
          mx[i] = fmaxf(mx[i], s[(3 + i) * G::kWarps + w0 + w]);
        }
      }
      set ^= 1;
    }
  }
};

// The region's fit values and one pixel's steps of the masked 3-axis fit
// (ops/fit.py fit_regions): f the pixel's channels, m its mask (0 or 1).
// Each step repeats the earlier ones, which gives the same values.
template <int CH>
struct RegionFit {
  float avg[CH], dir_a[CH], dir_b[CH], dir_c[CH];
  float inv_a, inv_b, inv_c;

  static __device__ __forceinline__ float project(const float (&v)[CH], const float (&d)[CH],
                                                  float inv_d2) {
    float dot = v[0] * d[0];
#pragma unroll
    for (int c = 1; c < CH; ++c) dot = dot + v[c] * d[c];
    return dot * inv_d2;
  }
  __device__ __forceinline__ void corrected(const float (&f)[CH], float m, float (&v)[CH]) const {
#pragma unroll
    for (int c = 0; c < CH; ++c) v[c] = (f[c] - avg[c]) * m;
  }
  __device__ __forceinline__ void step_a(const float (&f)[CH], float m, float& fa,
                                         float (&est)[CH], float (&ra)[CH]) const {
    float cor[CH];
    corrected(f, m, cor);
    fa = project(cor, dir_a, inv_a) * m;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      est[c] = avg[c] + fa * dir_a[c];
      ra[c] = (f[c] - est[c]) * m;
    }
  }
  __device__ __forceinline__ void step_b(const float (&f)[CH], float m, float& fa, float& fb,
                                         float (&rab)[CH]) const {
    float est[CH], ra[CH];
    step_a(f, m, fa, est, ra);
    fb = project(ra, dir_b, inv_b) * m;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float eb = est[c] + fb * dir_b[c];
      rab[c] = (f[c] - eb) * m;
    }
  }
};

struct Args {
  const int32_t* packed;   // (nb, P) block-major words
  const uint8_t* mask;     // (nb, P)
  int nb, crush_mode, dither, ladder_k, num_factors, max_pix, max_blk;
  uint32_t key;
  int32_t* shifts;         // (3, nb)
  int32_t* q;              // (nb, P)
  int32_t* dec;            // (nb, P)
  float* dist;             // (nb,)
  int32_t* eps;            // (6, CH, nb) or null
  float* avg;              // (CH, nb) or null
};

template <int P, int CH>
__global__ void __launch_bounds__(RegionGeo<P>::kWarps * 32, P == 4096 ? 1 : 2)
encode_region_kernel(const Args a) {
  using G = RegionGeo<P>;
  __shared__ CrushShared<CH, G::kWarps, G::kLevel> shared;
  __shared__ float xbuf[2 * G::kXSet];
  const int warp = (int)(threadIdx.x >> 5), lane = (int)(threadIdx.x & 31);
  const int t = (int)threadIdx.x % G::kT;
  const int r = (int)blockIdx.x * G::kRegions + (int)threadIdx.x / G::kT;
  // the last CTA's regions past nb are empty and write nothing, but take
  // part in every shuffle and barrier
  const bool live = r < a.nb;
  const size_t base = (size_t)r * P;

  float pxf[CH][8];
  int vmask = 0;  // bit j: pixel t + T j lies inside the image
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = t + G::kT * j;
    uint32_t word = 0u;
    if (live) {
      word = (uint32_t)a.packed[base + p];
      vmask |= (a.mask[base + p] != 0 ? 1 : 0) << j;
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) pxf[c][j] = (float)((word >> (8 * c)) & 0xFFu);
  }
  auto mf = [&](int j) { return ((vmask >> j) & 1) ? 1.0f : 0.0f; };
  auto pix = [&](int j, float (&f)[CH]) {
#pragma unroll
    for (int c = 0; c < CH; ++c) f[c] = pxf[c][j];
  };
  RegionExchange<P> ex{xbuf, warp, lane, 0};

  // ---- fit ---------------------------------------------------------------
  RegionFit<CH> fit;
  int count = __popc(vmask);
  lane_tree<CH>([&](int j, float (&o)[CH]) {
    const float m = mf(j);
#pragma unroll
    for (int c = 0; c < CH; ++c) o[c] = pxf[c][j] * m;
  }, fit.avg);
  ex.sum(fit.avg, &count);
  const float inv_count = 1.0f / fmaxf((float)count, 1.0f);
#pragma unroll
  for (int c = 0; c < CH; ++c) fit.avg[c] = fit.avg[c] * inv_count;

  lane_tree<CH>([&](int j, float (&o)[CH]) {
    float f[CH], v[CH];
    pix(j, f);
    const float m = mf(j);
    fit.corrected(f, m, v);
    const float il = signed_inv_len<CH>(v, m);
#pragma unroll
    for (int c = 0; c < CH; ++c) o[c] = v[c] * il;
  }, fit.dir_a);
  ex.sum(fit.dir_a);
#pragma unroll
  for (int c = 0; c < CH; ++c) fit.dir_a[c] = fit.dir_a[c] * inv_count;
  fit.inv_a = inv_or_zero(dot_self<CH>(fit.dir_a));

  lane_tree<CH>([&](int j, float (&o)[CH]) {
    float f[CH], fa, est[CH], ra[CH];
    pix(j, f);
    const float m = mf(j);
    fit.step_a(f, m, fa, est, ra);
    const float il = signed_inv_len<CH>(ra, m);
#pragma unroll
    for (int c = 0; c < CH; ++c) o[c] = ra[c] * il;
  }, fit.dir_b);
  ex.sum(fit.dir_b);
#pragma unroll
  for (int c = 0; c < CH; ++c) fit.dir_b[c] = fit.dir_b[c] * inv_count;
  fit.inv_b = inv_or_zero(dot_self<CH>(fit.dir_b));

  if constexpr (CH == 3) {
    FitSteps<CH>::cross(fit.dir_a, fit.dir_b, fit.dir_c);
  } else {
    lane_tree<CH>([&](int j, float (&o)[CH]) {
      float f[CH], fa, fb, rab[CH];
      pix(j, f);
      const float m = mf(j);
      fit.step_b(f, m, fa, fb, rab);
      const float il = signed_inv_len<CH>(rab, m);
#pragma unroll
      for (int c = 0; c < CH; ++c) o[c] = rab[c] * il;
    }, fit.dir_c);
    ex.sum(fit.dir_c);
#pragma unroll
    for (int c = 0; c < CH; ++c) fit.dir_c[c] = fit.dir_c[c] * inv_count;
  }
  fit.inv_c = inv_or_zero(dot_self<CH>(fit.dir_c));

  float mn[3] = {kBig, kBig, kBig}, mx[3] = {-kBig, -kBig, -kBig};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float f[CH], fac[3], rab[CH];
    pix(j, f);
    const float m = mf(j);
    fit.step_b(f, m, fac[0], fac[1], rab);
    fac[2] = RegionFit<CH>::project(rab, fit.dir_c, fit.inv_c) * m;
    const bool in = (vmask >> j) & 1;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      mn[k] = fminf(mn[k], in ? fac[k] : kBig);
      mx[k] = fmaxf(mx[k], in ? fac[k] : -kBig);
    }
  }
  ex.fold(mn, mx);
  int ep[6][CH];
  round_endpoints<CH>(count, fit.avg, fit.dir_a, fit.dir_b, fit.dir_c, mn, mx, ep);

  // ---- the u8 factors, the drops, the decomposition's outputs ---------------
  int f8w[8];
  {
    FactorFrame<CH> fr;
    fr.set(ep);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f[CH];
      int f8[3];
      pix(j, f);
      fr.f8_of(f, f8);
      f8w[j] = f8[0] | (f8[1] << 8) | (f8[2] << 16);
    }
  }
  drop_axes<CH>(ep, a.num_factors);
  if (live && a.eps != nullptr && t == 0) {
    // static indices only: an index by thread would put ep and fit in local
    // memory
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int e = 0; e < 6; ++e) a.eps[((size_t)e * CH + c) * a.nb + r] = ep[e][c];
      a.avg[(size_t)c * a.nb + r] = fit.avg[c];
    }
  }

  // ---- the crush search (crush_search.cuh) --------------------------------
  CrushLane<CH, G::kWarps, G::kLevel> cl;
  cl.sub = lane & 7;
  cl.lane = lane;
  cl.warp = warp;
  cl.blk = warp * 4 + (lane >> 3);
  cl.owner = G::kLevel;
  cl.xchg = G::kLevel >= 2;
  cl.set = 0;
  cl.sh = &shared;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < CH; ++c) cl.px[c][j] = (int)pxf[c][j];
    cl.f8w[j] = f8w[j];
  }
  cl.vmask = vmask;
  cl.max_pix = a.max_pix;
  cl.max_blk = a.max_blk;
  cl.es = G::kEs;
  cl.set_frame(ep);
  __syncwarp();
  int best[3];
  cl.search(a.crush_mode, a.ladder_k, a.num_factors, __popc(vmask), best);

  // ---- dither, decode, weighted error -----------------------------------------
  int n_int[3][CH], m_int[3][CH];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      n_int[k][c] = cl.n_at(k, c);
      m_int[k][c] = cl.m_at(k, c);
    }
  }
  const bool dither = a.dither != 0;
  float dist[1];
  lane_tree<1>([&](int j, float (&o)[1]) {
    const int p = t + G::kT * j;
    int q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int s = best[k];
      int v = (cl.f8w[j] >> (8 * k)) & 0xFF;
      if (dither && s > 0 && s < 8)
        v = min(max(v + dither_noise(dither_bits_p(a.key, (uint32_t)r, k, p, P), s), 0), 255);
      q[k] = v >> min(s, 8);
    }
    int est[CH];
    decode_est<CH>(q, best, n_int, m_int, est);
    o[0] = (float)cl.pixel_err_of(est, j);
    if (live) {
      uint32_t w = CH == 4 ? 0u : 0xFF000000u;
#pragma unroll
      for (int c = 0; c < CH; ++c) w |= (uint32_t)__vimin_s32_relu(est[c], 255) << (8 * c);
      a.q[base + p] = q[0] | (q[1] << 8) | (q[2] << 16);
      a.dec[base + p] = (int32_t)w;
    }
  }, dist);
  ex.sum(dist);

  if (live && t == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.shifts[(size_t)k * a.nb + r] = best[k];
    a.dist[r] = dist[0];
  }
}

// Launches encode_region_kernel<P> for the channel count on `st`; returns
// cudaGetLastError().
template <int P>
int launch_region(const Args& a, int channels, cudaStream_t st) {
  using G = RegionGeo<P>;
  const int grid = (a.nb + G::kRegions - 1) / G::kRegions;
  if (channels == 4) {
    encode_region_kernel<P, 4><<<grid, G::kWarps * 32, 0, st>>>(a);
  } else {
    encode_region_kernel<P, 3><<<grid, G::kWarps * 32, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Regions of more than 4096 pixels (the dense path's levels 4 and up: 128x128
// pixels and larger, P = 4096 * C, C = 4^m chunks, m >= 1)
// ---------------------------------------------------------------------------
//
// 8 pixels a thread would need P / 8 threads, more than a CTA has from P =
// 16,384 on. So a thread-block cluster of cs CTAs takes one region, each
// CTA of the P = 4096 layout (16 warps, one CTA an SM), and CTA rank i
// takes the pixels p with p mod cs = i: a subtree of the plain version's
// halving tree x[:n/2] + x[n/2:], whose first log2(P / cs) levels pair p
// with p + P / 2, ..., p + cs, inside the subtree. The CTA sees its subtree
// (its share) as a region of P' = P / cs pixels, pixel p' = p / cs, walked
// as C' = P' / 4096 chunks: thread t holds pixels p' = k * 4096 + t + 512 j
// (j < 8) of chunk k. Each float sum keeps the subtree's tree: the chunks
// of a position folded in bit-reversed order as a binary counter
// (chunk_fold, as segment_encode.cuh's ChunkTree does; the partials in
// registers), then the P = 4096 region's tree over the 4096 positions
// (lane_tree, one exchange across the warps, butterflies). The tree's last
// log2(cs) levels pair the CTAs' sums, rank i with i + cs / 2 first: each
// CTA writes its sums into a slot of every CTA of the cluster (distributed
// shared memory), and after one cluster barrier each folds the cs slots in
// that order itself (ClusterExchange), so every CTA holds the region's
// values and takes the same decisions. Integer totals (counts, the crush
// search's pixel maxima and wrapping error sums) and the factor extremes go
// the same way, in any order. The crush search is CrushLane's at level 3 (a
// region of 16 warps): an axis's nine sweeps chunk by chunk (each chunk's
// sweep_base made once), the other candidates one at a time over the
// share's chunks; the ladder's box and keys, the peel and the choice are
// CrushLane's own.
//
// The share is 4 chunks (cs = C / 4, at most 16), copied once into shared
// memory (words, u8 factors and mask bytes: 36 KB a chunk) and read there
// by every pass. A CTA pays ~9 cluster barriers and a region's search
// decisions whatever its share; with shares of one chunk these, and code
// that each CTA ran once, cost more than the tail they removed (PERF.md).
// At 4K, levels 4-7 hold 510 / 135 / 40 / 12 regions of P = 16,384 /
// 65,536 / 262,144 / 1,048,576: clusters of 1 / 4 / 16 / 16 CTAs, 510 /
// 540 / 640 / 192 CTAs. From level 7 on a share of more than 4 chunks is
// read from device memory by every pass, its factors kept in the q output
// as scratch, which the decode pass then overwrites pixel by pixel in the
// same thread.

constexpr int kChunkPixels = 4096;
constexpr int kMaxLogChunks = 18;   // C <= 2^18: P <= 2^30, pixel indices in int32
constexpr int kMaxLogCluster = 4;   // clusters of at most 16 CTAs
constexpr int kStageLog = 2;        // a CTA's share: 4 chunks, staged (144 KB)
constexpr int kChunkInts = 9 * kChunkPixels / 4;   // a staged chunk: words, factors, mask bytes
// the cluster exchange's slots: two sets of kBatchVals ints for each CTA
constexpr int kSlots = 2 * kMaxCluster * kBatchVals;

template <int CH>
using ChunkLane = CrushLane<CH, 16, 3>;

// The halving tree's levels over the 2^logc chunks at one position (logc <=
// D): f(k, v) gives chunk k's N values there; out their tree sum. The
// chunks come in bit-reversed order and fold as a binary counter.
template <int D, int N, class F>
__device__ __forceinline__ void chunk_fold(int logc, F f, float (&out)[N]) {
  float part[D + 1][N];
#pragma unroll 1
  for (int t = 0; t < (1 << logc); ++t) {
    f(bit_rev(t, logc), out);
    bool open = true;
#pragma unroll
    for (int l = 0; l <= D; ++l) {
      if (open) {
        if (l < logc && ((t >> l) & 1)) {
#pragma unroll
          for (int i = 0; i < N; ++i) out[i] = part[l][i] + out[i];
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) part[l][i] = out[i];
          open = false;
        }
      }
    }
  }
}

// A CTA's share of the region as thread t reads it, pixel j (a compile-time
// index) of chunk k: from the stage in shared memory (STAGED) or from device
// memory.
template <int CH, bool STAGED>
struct Share {
  const int32_t* packed;
  const uint8_t* mask;
  int32_t* f8;        // in device memory: the fit's packed u8 factors (the q output as scratch)
  int* stage;         // staged: chunk k's words, factors and mask bytes at kChunkInts * k
  size_t base;        // the region's first word
  int t, logc, cs, rank;   // logc: log2 of the share's chunks

  // its index in the share, in the region, in the buffer
  __device__ __forceinline__ int local(int k, int j) const {
    return k * kChunkPixels + t + 512 * j;
  }
  __device__ __forceinline__ int pixel_index(int k, int j) const {
    return cs * local(k, j) + rank;
  }
  __device__ __forceinline__ size_t at(int k, int j) const {
    return base + (size_t)pixel_index(k, j);
  }
  __device__ __forceinline__ int* staged(int k) const { return stage + k * kChunkInts; }
  __device__ __forceinline__ uint8_t* staged_mask(int k) const {
    return reinterpret_cast<uint8_t*>(staged(k) + 2 * kChunkPixels);
  }
  __device__ __forceinline__ uint32_t word(int k, int j) const {
    return (uint32_t)(STAGED ? staged(k)[t + 512 * j] : packed[at(k, j)]);
  }
  __device__ __forceinline__ bool member(int k, int j) const {
    return (STAGED ? staged_mask(k)[t + 512 * j] : mask[at(k, j)]) != 0;
  }
  __device__ __forceinline__ int factors(int k, int j) const {
    return STAGED ? staged(k)[kChunkPixels + t + 512 * j] : f8[at(k, j)];
  }
  __device__ __forceinline__ void set_factors(int k, int j, int w) const {
    if (STAGED) staged(k)[kChunkPixels + t + 512 * j] = w;
    else f8[at(k, j)] = w;
  }
  template <int N>
  __device__ __forceinline__ void pixel(int k, int j, float (&f)[N], float& m) const {
    const uint32_t w = word(k, j);
#pragma unroll
    for (int c = 0; c < N; ++c) f[c] = (float)((w >> (8 * c)) & 0xFFu);
    m = member(k, j) ? 1.0f : 0.0f;
  }
  // the share's words and mask bytes into the stage (every thread of the
  // CTA, before a barrier)
  __device__ void fill() const {
    if constexpr (STAGED) {
#pragma unroll 1
      for (int k = 0; k < (1 << logc); ++k) {
        uint32_t w[8];
        uint8_t m[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          w[j] = (uint32_t)packed[at(k, j)];
          m[j] = mask[at(k, j)];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          staged(k)[t + 512 * j] = (int)w[j];
          staged_mask(k)[t + 512 * j] = m[j];
        }
      }
    }
  }
  // chunk k's 8 pixels of this thread into the search's lane state
  __device__ __forceinline__ void load(ChunkLane<CH>& cl, int k) const {
    int vm = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t w = word(k, j);
#pragma unroll
      for (int c = 0; c < CH; ++c) cl.px[c][j] = (int)((w >> (8 * c)) & 0xFFu);
      cl.f8w[j] = factors(k, j);
      vm |= (member(k, j) ? 1 : 0) << j;
    }
    cl.vmask = vm;
  }
};

// The tree's last levels across the cluster. Each CTA's values (the same in
// every thread of the CTA) go into slot `rank` of every CTA; after one
// cluster barrier every CTA folds the cs slots itself. Two slot sets
// alternate, as RegionExchange's do: a CTA writes into a set again only
// after the next exchange's barrier, which every CTA reaches after its reads
// of this one.
struct ClusterExchange {
  int* slots;   // [2][kMaxCluster][kBatchVals], this CTA's
  int cs, rank, warp, lane, set;

  __device__ int* mine() const { return slots + set * kMaxCluster * kBatchVals; }

  // The region's sums of N values: the CTAs' subtree sums folded by the
  // halving tree over the ranks; with cnt, also the region's total of an
  // int (order-free).
  template <int N>
  __device__ void sum(float (&v)[N], int* cnt = nullptr) {
    if (cs == 1) return;
    const int* s = mine();
    if (warp == 0 && lane < cs) {
      int* d = at_rank(mine(), lane) + rank * kBatchVals;
#pragma unroll
      for (int i = 0; i < N; ++i) d[i] = __float_as_int(v[i]);
      if (cnt != nullptr) d[N] = *cnt;
    }
    cluster_sync();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float x[kMaxCluster];
#pragma unroll
      for (int w = 0; w < kMaxCluster; ++w)
        x[w] = w < cs ? __int_as_float(s[w * kBatchVals + i]) : 0.0f;
#pragma unroll
      for (int n = kMaxCluster / 2; n > 0; n >>= 1) {
        if (n < cs) {
#pragma unroll
          for (int w = 0; w < n; ++w) x[w] = x[w] + x[w + n];
        }
      }
      v[i] = x[0];
    }
    if (cnt != nullptr) {
      int c = 0;
#pragma unroll 1
      for (int w = 0; w < cs; ++w) c = add_wrap(c, s[w * kBatchVals + N]);
      *cnt = c;
    }
    set ^= 1;
  }

  // The region's minima and maxima of three values each (order-free).
  __device__ void fold(float (&mn)[3], float (&mx)[3]) {
    if (cs == 1) return;
    const int* s = mine();
    if (warp == 0 && lane < cs) {
      int* d = at_rank(mine(), lane) + rank * kBatchVals;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        d[i] = __float_as_int(mn[i]);
        d[3 + i] = __float_as_int(mx[i]);
      }
    }
    cluster_sync();
#pragma unroll 1
    for (int w = 0; w < cs; ++w) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        mn[i] = fminf(mn[i], __int_as_float(s[w * kBatchVals + i]));
        mx[i] = fmaxf(mx[i], __int_as_float(s[w * kBatchVals + 3 + i]));
      }
    }
    set ^= 1;
  }

  // The region's totals of a crush batch: CrushLane's row after end_batch
  // (n value pairs, then 0 and the count) summed over the CTAs, the pixel
  // maxima by max and the rest by wrapping sums (order-free), into every
  // warp's row.
  template <class Lane>
  __device__ void crush(const Lane& cl, int n) {
    if (cs == 1) return;
    const int nv = 2 * n + 2;
    const int* s = mine();
    int* row = cl.my_row();
    if (warp == 0) {
#pragma unroll 1
      for (int q = lane; q < nv * cs; q += 32) {
        const int i = q % nv, rk = q / nv;
        at_rank(mine(), rk)[rank * kBatchVals + i] = row[i];
      }
    }
    cluster_sync();
#pragma unroll 1
    for (int i = lane; i < nv; i += 32) {
      const bool is_max = i < 2 * n && (i & 1) == 0;
      int x = s[i];
#pragma unroll 1
      for (int w = 1; w < cs; ++w) {
        const int y = s[w * kBatchVals + i];
        x = is_max ? max(x, y) : add_wrap(x, y);
      }
      row[i] = x;
    }
    __syncwarp();
    set ^= 1;
  }
};

// Ends a batch of n value pairs: the CTA's totals (CrushLane::end_batch),
// then the region's (the cluster's).
template <int CH>
__device__ __forceinline__ void end_batch(ChunkLane<CH>& cl, ClusterExchange& cx, int n, int cnt) {
  cl.end_batch(n, cnt);
  cx.crush(cl, n);
}

// Candidate i's (pixel max, error sum) over the share's chunks, as
// CrushLane's value pair i. One candidate at a time, each chunk read again:
// batches unrolled over their candidates spilled (PERF.md).
template <int CH, bool STAGED>
__device__ void share_eval(ChunkLane<CH>& cl, const Share<CH, STAGED>& sh, int i,
                           const int (&s)[3]) {
  int pm = 0, be = 0;
#pragma unroll 1
  for (int k = 0; k < (1 << sh.logc); ++k) {
    sh.load(cl, k);
    int p, e;
    cl.eval(s, p, e);
    pm = max(pm, p);
    be = add_wrap(be, e);
  }
  cl.put(i, pm, be);
}

// The sweeps of axis A (pairs 9 A + s, (A, 0) only as pair 0): each chunk
// read once and its sweep_base made once.
template <int CH, int A, bool STAGED>
__device__ void share_sweep(ChunkLane<CH>& cl, const Share<CH, STAGED>& sh) {
  int pm[9], be[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) pm[s] = be[s] = 0;
#pragma unroll 1
  for (int k = 0; k < (1 << sh.logc); ++k) {
    sh.load(cl, k);
    int base[CH][8];
    cl.template sweep_base<A>(base);
#pragma unroll
    for (int s = A == 0 ? 0 : 1; s < 9; ++s) {
      int p, e;
      cl.template eval_sweep<A>(base, s, p, e);
      pm[s] = max(pm[s], p);
      be[s] = add_wrap(be[s], e);
    }
  }
#pragma unroll
  for (int s = A == 0 ? 0 : 1; s < 9; ++s) cl.put(9 * A + s, pm[s], be[s]);
}

// CrushLane::search over the share's chunks and the cluster (the same
// batches, candidates and choice); cnt is the thread's count of member
// pixels.
template <int CH, bool STAGED>
__device__ void cluster_search(ChunkLane<CH>& cl, ClusterExchange& cx,
                               const Share<CH, STAGED>& sh, int crush_mode, int ladder_k,
                               int num_factors, int cnt, int (&best)[3]) {
  best[0] = best[1] = best[2] = 0;
  cl.floors = false;
  cl.floor_pix = cl.floor_blk = 0;
  if (crush_mode == kLadder) {
    share_sweep<CH, 0>(cl, sh);
    share_sweep<CH, 1>(cl, sh);
    share_sweep<CH, 2>(cl, sh);
    end_batch<CH>(cl, cx, kMaxCands, cnt);
    int key[8], base[3];
    cl.ladder_setup(num_factors, key, base);
    int* trips = cl.sh->trips + cl.blk * kCandBatch;
    int b_tot = -1, b_err = 2147483647;
#pragma unroll 1
    for (int r0 = 0; r0 < ladder_k; r0 += kCandBatch) {
      const int n = min(kCandBatch, ladder_k - r0);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        int s[3];
        cl.peel(key, base, s);
        if (cl.sub == 0) trips[i] = s[0] | (s[1] << 4) | (s[2] << 8);
        share_eval(cl, sh, i, s);
      }
      end_batch<CH>(cl, cx, n, cnt);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const int tr = trips[i];
        const int s[3] = {tr & 15, (tr >> 4) & 15, tr >> 8};
        take_if_better(cl, s, cl.pm_at(i), cl.be_at(i), false, best, b_tot, b_err);
      }
    }
  } else if (crush_mode == kExhaustive) {
    int b_tot = -1, b_err = 2147483647;
#pragma unroll 1
    for (int i0 = 0; i0 < 729; i0 += 9) {
      const auto triple = [i0](int i, int (&s)[3]) {
        s[0] = (i0 + i) / 81;
        s[1] = ((i0 + i) / 9) % 9;
        s[2] = i;
      };
#pragma unroll 1
      for (int i = 0; i < 9; ++i) {
        int s[3];
        triple(i, s);
        share_eval(cl, sh, i, s);
      }
      end_batch<CH>(cl, cx, 9, cnt);
      if (i0 == 0) {
        cl.count = cl.my_row()[2 * 9 + 1];
        cl.set_floors(num_factors, cl.pm_at(0), cl.be_at(0));
      }
#pragma unroll 1
      for (int i = 0; i < 9; ++i) {
        int s[3];
        triple(i, s);
        take_if_better(cl, s, cl.pm_at(i), cl.be_at(i), true, best, b_tot, b_err);
      }
    }
  } else if (crush_mode == kGuess) {
#pragma unroll 1
    for (int i = 0; i < 5; ++i) {
      int s[3] = {0, 0, 0};
      if (i > 0) guess_triple(i - 1, s);
      share_eval(cl, sh, i, s);
    }
    end_batch<CH>(cl, cx, 5, cnt);
    cl.count = cl.my_row()[2 * 5 + 1];
    cl.set_floors(num_factors, cl.pm_at(0), cl.be_at(0));
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ok[i] = cl.admissible(cl.pm_at(1 + i), cl.be_at(1 + i));
    const int pick = guess_pick(ok);
    if (pick >= 0) guess_triple(pick, best);
  } else {
    end_batch<CH>(cl, cx, 0, cnt);
    cl.count = cl.my_row()[1];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (k >= num_factors) best[k] = max(best[k], 8);
}

// One region a cluster of cs CTAs (see above); logc: log2 of the region's
// chunks.
template <int CH, bool STAGED>
__global__ void __launch_bounds__(512, 1)
encode_region_cluster_kernel(const Args a, int logc) {
  using G = RegionGeo<kChunkPixels>;
  // the counter's depth over the share's chunks
  constexpr int D = STAGED ? kStageLog : kMaxLogChunks - kMaxLogCluster;
  __shared__ CrushShared<CH, G::kWarps, G::kLevel> shared;
  __shared__ float xbuf[2 * G::kXSet];
  const int warp = (int)(threadIdx.x >> 5), lane = (int)(threadIdx.x & 31);
  const int t = (int)threadIdx.x;
  const int cs = (int)cg::this_cluster().num_blocks();
  const int rank = (int)cg::this_cluster().block_rank();
  const int r = (int)blockIdx.x / cs;   // one region a cluster
  const int lc = logc - (31 - __clz(cs));
  const int p_all = kChunkPixels << logc;
  extern __shared__ __align__(16) int dyn[];   // the cluster exchange's slots, then the stage
  const Share<CH, STAGED> sh{a.packed, a.mask, a.q, dyn + kSlots, (size_t)r * p_all, t, lc, cs,
                             rank};
  RegionExchange<kChunkPixels> ex{xbuf, warp, lane, 0};
  ClusterExchange cx{dyn, cs, rank, warp, lane, 0};
  sh.fill();
  // the stage is written, and every CTA of the cluster runs before any
  // writes into its slots
  cluster_sync();

  // ---- fit (the plain version's steps, each pass over the share) -----------
  RegionFit<CH> fit;
  int count = 0;
  lane_tree<CH>([&](int j, float (&o)[CH]) {
    chunk_fold<D, CH>(lc, [&](int k, float (&v)[CH]) {
      float f[CH], m;
      sh.pixel(k, j, f, m);
      count += (int)m;
#pragma unroll
      for (int c = 0; c < CH; ++c) v[c] = f[c] * m;
    }, o);
  }, fit.avg);
  const int cnt = count;
  ex.sum(fit.avg, &count);
  cx.sum(fit.avg, &count);
  const float inv_count = 1.0f / fmaxf((float)count, 1.0f);
#pragma unroll
  for (int c = 0; c < CH; ++c) fit.avg[c] = fit.avg[c] * inv_count;

  lane_tree<CH>([&](int j, float (&o)[CH]) {
    chunk_fold<D, CH>(lc, [&](int k, float (&v)[CH]) {
      float f[CH], m;
      sh.pixel(k, j, f, m);
      fit.corrected(f, m, v);
      const float il = signed_inv_len<CH>(v, m);
#pragma unroll
      for (int c = 0; c < CH; ++c) v[c] = v[c] * il;
    }, o);
  }, fit.dir_a);
  ex.sum(fit.dir_a);
  cx.sum(fit.dir_a);
#pragma unroll
  for (int c = 0; c < CH; ++c) fit.dir_a[c] = fit.dir_a[c] * inv_count;
  fit.inv_a = inv_or_zero(dot_self<CH>(fit.dir_a));

  lane_tree<CH>([&](int j, float (&o)[CH]) {
    chunk_fold<D, CH>(lc, [&](int k, float (&v)[CH]) {
      float f[CH], m, fa, est[CH], ra[CH];
      sh.pixel(k, j, f, m);
      fit.step_a(f, m, fa, est, ra);
      const float il = signed_inv_len<CH>(ra, m);
#pragma unroll
      for (int c = 0; c < CH; ++c) v[c] = ra[c] * il;
    }, o);
  }, fit.dir_b);
  ex.sum(fit.dir_b);
  cx.sum(fit.dir_b);
#pragma unroll
  for (int c = 0; c < CH; ++c) fit.dir_b[c] = fit.dir_b[c] * inv_count;
  fit.inv_b = inv_or_zero(dot_self<CH>(fit.dir_b));

  if constexpr (CH == 3) {
    FitSteps<CH>::cross(fit.dir_a, fit.dir_b, fit.dir_c);
  } else {
    lane_tree<CH>([&](int j, float (&o)[CH]) {
      chunk_fold<D, CH>(lc, [&](int k, float (&v)[CH]) {
        float f[CH], m, fa, fb, rab[CH];
        sh.pixel(k, j, f, m);
        fit.step_b(f, m, fa, fb, rab);
        const float il = signed_inv_len<CH>(rab, m);
#pragma unroll
        for (int c = 0; c < CH; ++c) v[c] = rab[c] * il;
      }, o);
    }, fit.dir_c);
    ex.sum(fit.dir_c);
    cx.sum(fit.dir_c);
#pragma unroll
    for (int c = 0; c < CH; ++c) fit.dir_c[c] = fit.dir_c[c] * inv_count;
  }
  fit.inv_c = inv_or_zero(dot_self<CH>(fit.dir_c));

  float mn[3] = {kBig, kBig, kBig}, mx[3] = {-kBig, -kBig, -kBig};
#pragma unroll 1
  for (int k = 0; k < (1 << lc); ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f[CH], m, fac[3], rab[CH];
      sh.pixel(k, j, f, m);
      fit.step_b(f, m, fac[0], fac[1], rab);
      fac[2] = RegionFit<CH>::project(rab, fit.dir_c, fit.inv_c) * m;
      const bool in = m != 0.0f;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        mn[e] = fminf(mn[e], in ? fac[e] : kBig);
        mx[e] = fmaxf(mx[e], in ? fac[e] : -kBig);
      }
    }
  }
  ex.fold(mn, mx);
  cx.fold(mn, mx);
  int ep[6][CH];
  round_endpoints<CH>(count, fit.avg, fit.dir_a, fit.dir_b, fit.dir_c, mn, mx, ep);

  // ---- the u8 factors, the drops, the outputs -------------------------------
  {
    FactorFrame<CH> fr;
    fr.set(ep);
#pragma unroll 1
    for (int k = 0; k < (1 << lc); ++k) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float f[CH], m;
        int f8[3];
        sh.pixel(k, j, f, m);
        fr.f8_of(f, f8);
        sh.set_factors(k, j, f8[0] | (f8[1] << 8) | (f8[2] << 16));
      }
    }
  }
  drop_axes<CH>(ep, a.num_factors);
  if (rank == 0 && t == 0 && a.eps != nullptr) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int e = 0; e < 6; ++e) a.eps[((size_t)e * CH + c) * a.nb + r] = ep[e][c];
      a.avg[(size_t)c * a.nb + r] = fit.avg[c];
    }
  }

  // ---- the crush search ----------------------------------------------------
  ChunkLane<CH> cl;
  cl.sub = lane & 7;
  cl.lane = lane;
  cl.warp = warp;
  cl.blk = warp * 4 + (lane >> 3);
  cl.owner = G::kLevel;
  cl.xchg = true;
  cl.set = 0;
  cl.sh = &shared;
  cl.max_pix = a.max_pix;
  cl.max_blk = a.max_blk;
  cl.es = G::kEs;
  cl.set_frame(ep);
  __syncwarp();
  int best[3];
  cluster_search<CH>(cl, cx, sh, a.crush_mode, a.ladder_k, a.num_factors, cnt, best);

  // ---- dither, decode, weighted error ---------------------------------------
  int n_int[3][CH], m_int[3][CH];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      n_int[k][c] = cl.n_at(k, c);
      m_int[k][c] = cl.m_at(k, c);
    }
  }
  const bool dither = a.dither != 0;
  float dist[1];
  lane_tree<1>([&](int j, float (&o)[1]) {
    chunk_fold<D, 1>(lc, [&](int k, float (&v)[1]) {
      const uint32_t word = sh.word(k, j);
      const int f8w = sh.factors(k, j);
      const int p = sh.pixel_index(k, j);
      int q[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int s = best[e];
        int val = (f8w >> (8 * e)) & 0xFF;
        if (dither && s > 0 && s < 8)
          val = min(max(val + dither_noise(dither_bits_p(a.key, (uint32_t)r, e, p, p_all), s),
                        0), 255);
        q[e] = val >> min(s, 8);
      }
      int est[CH], px[CH][1];
      decode_est<CH>(q, best, n_int, m_int, est);
#pragma unroll
      for (int c = 0; c < CH; ++c) px[c][0] = (int)((word >> (8 * c)) & 0xFFu);
      v[0] = sh.member(k, j) ? (float)clamped_pixel_err<CH>(est, px, 0) : 0.0f;
      uint32_t w = CH == 4 ? 0u : 0xFF000000u;
#pragma unroll
      for (int c = 0; c < CH; ++c) w |= (uint32_t)__vimin_s32_relu(est[c], 255) << (8 * c);
      const size_t i = sh.at(k, j);
      a.q[i] = q[0] | (q[1] << 8) | (q[2] << 16);
      a.dec[i] = (int32_t)w;
    }, o);
  }, dist);
  ex.sum(dist);
  cx.sum(dist);

  if (rank == 0 && t == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.shifts[(size_t)k * a.nb + r] = best[k];
    a.dist[r] = dist[0];
  }
}

// Launches encode_region_cluster_kernel<CH, STAGED> for nb regions of 4096
// << logc pixels in clusters of 2^logcs CTAs on `st`.
template <int CH, bool STAGED>
int launch_region_cluster(const Args& a, int logc, int logcs, cudaStream_t st) {
  auto kernel = encode_region_cluster_kernel<CH, STAGED>;
  const size_t smem = (kSlots + (STAGED ? kChunkInts << kStageLog : 0)) * sizeof(int);
  // the kernel's attributes, set once for the device it last ran on
  static int ready = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != ready) {
    err = allow_cluster(kernel, kMaxCluster, smem);
    if (err != cudaSuccess) return (int)err;
    ready = device;
  }
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cluster_config(config, attr, 1 << logcs, 512, st);
  config.gridDim = dim3((unsigned)a.nb << logcs, 1, 1);
  config.dynamicSmemBytes = smem;
  err = cudaLaunchKernelEx(&config, kernel, a, logc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The region encode at P = 4096 << logc (logc >= 1): clusters of C / 4 CTAs
// (1 to 16), each share of 4 chunks staged; past 16 CTAs the shares grow
// and stay in device memory.
template <int CH>
int launch_region_large(const Args& a, int logc, cudaStream_t st) {
  if (logc < 1 || logc > kMaxLogChunks) return (int)cudaErrorInvalidValue;
  const int logcs = min(max(logc - kStageLog, 0), kMaxLogCluster);
  return logc - logcs <= kStageLog ? launch_region_cluster<CH, true>(a, logc, logcs, st)
                                   : launch_region_cluster<CH, false>(a, logc, logcs, st);
}

}  // namespace
