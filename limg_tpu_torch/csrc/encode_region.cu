// Region encode for NVIDIA Hopper (sm_90a): one P-pixel region per CTA,
// P = 256, 1024 or 4096 (16x16, 32x32 or 64x64 pixels).
//
// Replaces the TPU kernel limg_tpu/pallas_kernels/encode_fixed.py:
// encode_blocks_pallas (:808) at P > 64: the mono kernel _make_mono_kernel
// (:739) at P = 256 and 1024 (the latter as 4 lane chunks, _GEOM_FOR_P :76)
// and, at P = 4096, both halves of its split (_make_fit_kernel :764 and
// _make_crush_kernel :781, split at _SPLIT_THRESHOLD_P :78 only for the
// TPU's VMEM; the factors round-trip HBM between them). Here the split is
// one pass: the fit's factors stay in shared memory. Per region it runs the
// masked 3-axis fit, the u8 factor extraction, the crush search (ladder /
// exhaustive / guess), the num_factors drops, dither, the integer decode and
// the weighted error. These are the per-level encodes of the RD merge
// policy (limg_tpu_torch/regions.py _encode_level).
//
// What bounds it on the H100: at 4K a level reads 33 MB of packed pixels
// and writes 66 MB of factor and decode words, about 30 us of HBM time,
// while every pixel goes through 35+ exact candidate decodes (27 ladder
// sweeps + ladder_k verifications; 729 in exhaustive mode) of ~20 integer
// operations per channel. The kernel is bound by those operations and by
// the CTA-wide barriers of its region reductions.
//
// What the design does about it: a CTA of 256 threads holds one region;
// thread t owns pixels t + 256 j (j < P / 256), whose words, mask and
// packed u8 factors sit in shared memory (42 KB at P = 4096, under the
// 48 KB static limit), so no candidate evaluation touches device memory.
// Integer crush totals (order-free) are warp reductions and then an
// 8-warp fold through shared memory, batched over the candidates of a
// step. Float sums follow the plain version's halving tree over the P
// pixels (kernels/encode_fixed.py encode_blocks_reference, ops/fit.py
// tree_sum): in-thread over j first (the tree's top levels), then a
// shared-memory tree across threads down to 32, then a butterfly within a
// warp; channel dots are left folds; built with --fmad=false and exact
// 1 / sqrt, so kernel and plain version agree bit for bit. The crush
// search (ladder with its top-K peel, every warp peeling the same 64
// region-wide keys), the drops, the dither hash and the integer decode are
// limg_common.cuh's. No tensor cores, cp.async or tuning yet.

#include "limg_common.cuh"

namespace {

using namespace limg;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFloatRows = 4;  // floats summed in one CTA tree (the channels)

// --- CTA-wide reductions ----------------------------------------------------

// Region sums of N per-thread partials: the halving tree across the 256
// threads (t + n folded into t) down to 32 values, then the butterfly.
template <int N>
__device__ void cta_tree_sum(float (&v)[N], float* fs) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < N; ++i) fs[i * kThreads + t] = v[i];
  __syncthreads();
#pragma unroll
  for (int n = kThreads / 2; n >= 32; n >>= 1) {
    if (t < n) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        fs[i * kThreads + t] = fs[i * kThreads + t] + fs[i * kThreads + t + n];
    }
    __syncthreads();
  }
  const int lane = t & 31;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = fs[i * kThreads + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = s + __shfl_xor_sync(kFull, s, off);
    v[i] = s;
  }
  __syncthreads();
}

// Order-free region fold (min or max) of N per-thread values.
template <int N, class Op>
__device__ void cta_fold(float (&v)[N], float* fs, Op op) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = op(x, __shfl_xor_sync(kFull, x, off));
    if (lane == 0) fs[i * kWarps + warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = fs[i * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x = op(x, fs[i * kWarps + w]);
    v[i] = x;
  }
  __syncthreads();
}

__device__ int cta_sum_int(int v, int* is) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) is[warp] = v;
  __syncthreads();
  int acc = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) acc = add_wrap(acc, is[w]);
  __syncthreads();
  return acc;
}

// The crush search's region reducer: each warp's candidate partials (pixel
// max, error sum) folded over the CTA's 8 warps.
struct CtaReducer {
  int* ibuf;  // [2 * kMaxExchange][kWarps]
  int warp, lane;

  template <int N>
  __device__ void crush(int (&pm)[N], int (&be)[N]) const {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        ibuf[i * kWarps + warp] = pm[i];
        ibuf[(N + i) * kWarps + warp] = be[i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int m = ibuf[i * kWarps], s = ibuf[(N + i) * kWarps];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        m = max(m, ibuf[i * kWarps + w]);
        s = add_wrap(s, ibuf[(N + i) * kWarps + w]);
      }
      pm[i] = m;
      be[i] = s;
    }
    __syncthreads();
  }
};

// The halving tree over this thread's J values f(0..J): its top levels.
template <int J, class F>
__device__ __forceinline__ float thread_tree(F f) {
  float v[J];
#pragma unroll
  for (int j = 0; j < J; ++j) v[j] = f(j);
#pragma unroll
  for (int n = J / 2; n > 0; n >>= 1) {
#pragma unroll
    for (int k = 0; k < n; ++k) v[k] = v[k] + v[k + n];
  }
  return v[0];
}

// Region sums of f(j, c) over the pixels, for c < N.
template <int N, int J, class F>
__device__ __forceinline__ void region_sum(F f, float (&out)[N], float* fs) {
#pragma unroll
  for (int c = 0; c < N; ++c) out[c] = thread_tree<J>([&](int j) { return f(j, c); });
  cta_tree_sum<N>(out, fs);
}

// --- one pixel -----------------------------------------------------------------

template <int CH>
struct Px {
  int v[CH];    // channels as they are (the plain version keeps pixels
  float f[CH];  // outside the mask: they get factors and a decode too)
  int mi;       // inside the image
  float m;
};

template <int CH>
__device__ __forceinline__ Px<CH> load_px(const int32_t* words, const uint8_t* mask, int p) {
  Px<CH> x;
  const uint32_t w = (uint32_t)words[p];
  x.mi = mask[p] != 0 ? 1 : 0;
  x.m = (float)x.mi;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    x.v[c] = (int)((w >> (8 * c)) & 0xFFu);
    x.f[c] = (float)x.v[c];
  }
  return x;
}

template <int CH>
__device__ __forceinline__ float project1(const float (&v)[CH], const float (&d)[CH], float inv_d2) {
  float dot = v[0] * d[0];
#pragma unroll
  for (int c = 1; c < CH; ++c) dot = dot + v[c] * d[c];
  return dot * inv_d2;
}

// The region's fit values and one pixel's steps of the masked 3-axis fit
// (ops/fit.py fit_regions; limg_common.cuh FitSteps for two pixels a lane).
// Each step repeats the earlier ones, which gives the same values.
template <int CH>
struct RegionFit {
  float avg[CH], dir_a[CH], dir_b[CH], dir_c[CH];
  float inv_a, inv_b, inv_c;

  __device__ __forceinline__ void corrected(const Px<CH>& x, float (&v)[CH]) const {
#pragma unroll
    for (int c = 0; c < CH; ++c) v[c] = (x.f[c] - avg[c]) * x.m;
  }
  __device__ __forceinline__ void step_a(const Px<CH>& x, float& fa, float (&est)[CH],
                                         float (&ra)[CH]) const {
    float cor[CH];
    corrected(x, cor);
    fa = project1<CH>(cor, dir_a, inv_a) * x.m;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      est[c] = avg[c] + fa * dir_a[c];
      ra[c] = (x.f[c] - est[c]) * x.m;
    }
  }
  __device__ __forceinline__ void step_b(const Px<CH>& x, float& fa, float& fb,
                                         float (&rab)[CH]) const {
    float est[CH], ra[CH];
    step_a(x, fa, est, ra);
    fb = project1<CH>(ra, dir_b, inv_b) * x.m;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float eb = est[c] + fb * dir_b[c];
      rab[c] = (x.f[c] - eb) * x.m;
    }
  }
};

// The crush search's view of a region (limg_common.cuh Block for one 8x8
// block): eval returns this warp's part of a candidate's pixel max and
// error sum; CtaReducer folds the warps.
template <int CH, int J>
struct RegionBlock {
  const int32_t* words;
  const int32_t* f8p;  // packed u8 factors: a | b << 8 | c << 16
  const uint8_t* mask;
  int t;
  int n_int[3][CH];
  int m_int[3][CH];
  int count;
  int max_pix, max_blk;
  int es;
  int seg_shift = 0;
  bool floors;
  int floor_pix, floor_blk;

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

  __device__ void eval(const int s[3], int& pm, int& be) const {
    const int sv[3] = {s[0], s[1], s[2]};
    int mx = 0, sum = 0;
#pragma unroll 4
    for (int j = 0; j < J; ++j) {
      const int p = j * kThreads + t;
      const uint32_t w = (uint32_t)words[p];
      const int f = f8p[p];
      int q[3], est[CH], px[CH];
#pragma unroll
      for (int k = 0; k < 3; ++k) q[k] = ((f >> (8 * k)) & 0xFF) >> min(sv[k], 8);
      decode_est<CH>(q, sv, n_int, m_int, est);
#pragma unroll
      for (int c = 0; c < CH; ++c) px[c] = (int)((w >> (8 * c)) & 0xFFu);
      const int err = mask[p] != 0 ? pixel_err<CH>(est, px) : 0;
      mx = max(mx, err);
      sum = add_wrap(sum, err >> es);
    }
    pm = __reduce_max_sync(kFull, mx);
    be = __reduce_add_sync(kFull, sum);
  }

  __device__ __forceinline__ bool admissible(int pm, int be) const {
    return limg::admissible(pm, be, count, max_pix, max_blk, es + seg_shift, floors, floor_pix,
                            floor_blk);
  }
  __device__ __forceinline__ bool operator()(int pm, int be) const { return admissible(pm, be); }
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
__global__ void __launch_bounds__(kThreads) encode_region_kernel(const Args a) {
  constexpr int J = P / kThreads;
  // the block-error pre-scale of ops/crush.py err_scale_shift(P)
  constexpr int kEs = P >= 2048 ? 4 : 0;
  __shared__ int32_t s_words[P];
  __shared__ int32_t s_f8[P];
  __shared__ uint8_t s_mask[P];
  __shared__ float s_f[kFloatRows * kThreads];
  __shared__ int s_i[2 * kMaxExchange * kWarps];

  const int t = threadIdx.x;
  const int r = blockIdx.x;
  const size_t base = (size_t)r * P;
  // each thread reads back only its own pixels: no barrier before use
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int p = j * kThreads + t;
    s_words[p] = a.packed[base + p];
    s_mask[p] = a.mask[base + p];
  }
  auto px = [&](int j) { return load_px<CH>(s_words, s_mask, j * kThreads + t); };

  int own = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) own += s_mask[j * kThreads + t] != 0 ? 1 : 0;
  const int count = cta_sum_int(own, s_i);
  const float inv_count = 1.0f / fmaxf((float)count, 1.0f);

  // ---- fit -------------------------------------------------------------
  RegionFit<CH> fit;
  region_sum<CH, J>([&](int j, int c) {
    const Px<CH> x = px(j);
    return x.f[c] * x.m;
  }, fit.avg, s_f);
#pragma unroll
  for (int c = 0; c < CH; ++c) fit.avg[c] = fit.avg[c] * inv_count;

  region_sum<CH, J>([&](int j, int c) {
    const Px<CH> x = px(j);
    float v[CH];
    fit.corrected(x, v);
    return v[c] * signed_inv_len<CH>(v, x.m);
  }, fit.dir_a, s_f);
#pragma unroll
  for (int c = 0; c < CH; ++c) fit.dir_a[c] = fit.dir_a[c] * inv_count;
  fit.inv_a = inv_or_zero(dot_self<CH>(fit.dir_a));

  region_sum<CH, J>([&](int j, int c) {
    const Px<CH> x = px(j);
    float fa, est[CH], ra[CH];
    fit.step_a(x, fa, est, ra);
    return ra[c] * signed_inv_len<CH>(ra, x.m);
  }, fit.dir_b, s_f);
#pragma unroll
  for (int c = 0; c < CH; ++c) fit.dir_b[c] = fit.dir_b[c] * inv_count;
  fit.inv_b = inv_or_zero(dot_self<CH>(fit.dir_b));

  if constexpr (CH == 3) {
    FitSteps<CH>::cross(fit.dir_a, fit.dir_b, fit.dir_c);
  } else {
    region_sum<CH, J>([&](int j, int c) {
      const Px<CH> x = px(j);
      float fa, fb, rab[CH];
      fit.step_b(x, fa, fb, rab);
      return rab[c] * signed_inv_len<CH>(rab, x.m);
    }, fit.dir_c, s_f);
#pragma unroll
    for (int c = 0; c < CH; ++c) fit.dir_c[c] = fit.dir_c[c] * inv_count;
  }
  fit.inv_c = inv_or_zero(dot_self<CH>(fit.dir_c));

  float mn[3] = {kBig, kBig, kBig}, mx[3] = {-kBig, -kBig, -kBig};
#pragma unroll 4
  for (int j = 0; j < J; ++j) {
    const Px<CH> x = px(j);
    float f[3], rab[CH];
    fit.step_b(x, f[0], f[1], rab);
    f[2] = project1<CH>(rab, fit.dir_c, fit.inv_c) * x.m;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      mn[k] = fminf(mn[k], x.mi ? f[k] : kBig);
      mx[k] = fmaxf(mx[k], x.mi ? f[k] : -kBig);
    }
  }
  cta_fold<3>(mn, s_f, MinOp());
  cta_fold<3>(mx, s_f, MaxOp());
  int ep[6][CH];
  round_endpoints<CH>(count, fit.avg, fit.dir_a, fit.dir_b, fit.dir_c, mn, mx, ep);

  // ---- u8 factors (into shared memory), drops, crush search ---------------
  {
    FactorFrame<CH> fr;
    fr.set(ep);
#pragma unroll 4
    for (int j = 0; j < J; ++j) {
      const Px<CH> x = px(j);
      int f[3];
      fr.f8_of(x.f, f);
      s_f8[j * kThreads + t] = f[0] | (f[1] << 8) | (f[2] << 16);
    }
  }
  drop_axes<CH>(ep, a.num_factors);
  RegionBlock<CH, J> blk;
  blk.words = s_words;
  blk.f8p = s_f8;
  blk.mask = s_mask;
  blk.t = t;
  blk.set_endpoints(ep);
  blk.count = count;
  blk.max_pix = a.max_pix;
  blk.max_blk = a.max_blk;
  blk.es = kEs;
  const CtaReducer red{s_i, t >> 5, t & 31};
  int best[3];
  crush_search<CH>(blk, red, a.crush_mode, a.ladder_k, a.num_factors, t & 31, best);

  // ---- dither, decode, weighted error --------------------------------------
  const bool dither = a.dither != 0;
  float dist[1] = {thread_tree<J>([&](int j) {
    const int p = j * kThreads + t;
    const Px<CH> x = px(j);
    const int f = s_f8[p];
    int q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int s = best[k];
      int v = (f >> (8 * k)) & 0xFF;
      if (dither && s > 0 && s < 8)
        v = min(max(v + dither_noise(dither_bits_p(a.key, (uint32_t)r, k, p, P), s), 0), 255);
      q[k] = v >> min(s, 8);
    }
    int e[CH];
    decode_est<CH>(q, best, blk.n_int, blk.m_int, e);
    uint32_t w = (CH == 4) ? 0u : 0xFF000000u;
#pragma unroll
    for (int c = 0; c < CH; ++c) w |= (uint32_t)min(max(e[c], 0), 255) << (8 * c);
    a.q[base + p] = q[0] | (q[1] << 8) | (q[2] << 16);
    a.dec[base + p] = (int32_t)w;
    return (float)(pixel_err<CH>(e, x.v) * x.mi);
  })};
  cta_tree_sum<1>(dist, s_f);

  if (t == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.shifts[(size_t)k * a.nb + r] = best[k];
    a.dist[r] = dist[0];
    if (a.eps != nullptr) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int e = 0; e < 6; ++e) a.eps[((size_t)e * CH + c) * a.nb + r] = ep[e][c];
        a.avg[(size_t)c * a.nb + r] = fit.avg[c];
      }
    }
  }
}

template <int P>
void launch(const Args& a, int channels, cudaStream_t st) {
  if (channels == 4) {
    encode_region_kernel<P, 4><<<a.nb, kThreads, 0, st>>>(a);
  } else {
    encode_region_kernel<P, 3><<<a.nb, kThreads, 0, st>>>(a);
  }
}

}  // namespace

extern "C" {

// Launches the encode of nb regions of p pixels (256, 1024 or 4096) on
// `stream`. packed / mask are block-major (nb, p): int32 RGBA words and 0/1
// bytes. Outputs: shifts (3, nb), q and dec block-major (nb, p) packed
// words, dist (nb,), and, when eps is not null, eps (6, channels, nb) and
// avg (channels, nb). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another p).
int limg_encode_region(const int32_t* packed, const uint8_t* mask, int nb, int p, int channels,
                       int crush_mode, int dither, int ladder_k, int num_factors, int max_pix,
                       int max_blk, uint32_t key, int32_t* shifts, int32_t* q, int32_t* dec,
                       float* dist, int32_t* eps, float* avg, void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  const Args a{packed, mask, nb, crush_mode, dither, ladder_k, num_factors, max_pix, max_blk,
               key, shifts, q, dec, dist, eps, avg};
  cudaStream_t st = (cudaStream_t)stream;
  switch (p) {
    case 256: launch<256>(a, channels, st); break;
    case 1024: launch<1024>(a, channels, st); break;
    case 4096: launch<4096>(a, channels, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
