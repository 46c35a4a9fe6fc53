// Fused quadtree encode for NVIDIA Hopper (sm_90a): two kernels.
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
// Geometry: one CTA per top-level square of G x G blocks (G = 2^(levels-1),
// 4x4 = 32x32 px at 3 levels), one warp per block, warps in Morton order
// (x in the even bits), so every level-l region is an aligned group of 4^l
// warps. At 4 levels a square of 64 blocks is a thread block cluster of four
// 16-warp CTAs that reduce through distributed shared memory. Each warp reads its block straight from the row-major (H, W) word
// image and masks pixels outside (h, w): no relayout, no mask plane. Blocks
// of the square outside the grid are empty warps; like the reference's
// padding lanes they count zero pixels and auto-match.
//
// What bounds them on the H100: a 4K image is 33 MB of words, read once by
// each kernel (~10 us each at 3.35 TB/s). The fit does levels full fits
// (about 25 float passes over the pixels each) plus one 27-probe match per
// child region; the crush does 35+ exact candidate decodes per block, as
// the fixed-grid kernel does. Both are compute- and barrier-bound: region
// reductions are shared-memory exchanges between the square's warps
// (limg_common.cuh GroupReducer / OwnerReducer), each a pair of
// __syncthreads. A simple first version: no tensor cores, TMA or tuning.
//
// Bit-exactness with the plain PyTorch versions (kernels/encode_merged.py)
// rests on the orders listed in limg_common.cuh, on the Morton warp order
// of the cross-block trees, and on the match predicate's fixed order
// (limg_common.cuh match_rows, shared with coalesce.cu).

#include "limg_common.cuh"

namespace {

using namespace limg;

__device__ __forceinline__ int header_bits(int ch) { return ch * 9 * 2 + ch * 8 + 2 * 16; }

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

// Loads this warp's block of the (h, w) word image.
template <int CH>
__device__ __forceinline__ void load_block(const int32_t* __restrict__ words, int h, int w,
                                           int by, int bx, int lane, Pixels<CH>& p) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int pix = lane + 32 * j;
    const int r = by * 8 + (pix >> 3), c = bx * 8 + (pix & 7);
    const bool valid = r < h && c < w;
    p.set(j, valid ? (uint32_t)words[(size_t)r * w + c] : 0u, valid);
  }
}

// Per-warp state of the level loop.
template <int CH>
struct FitState {
  Pixels<CH> px;
  int warp, lane;
  int num_factors;
  // owner-level selection (overwritten while the block's square stays alive)
  int f8_sel[2];
  int ep_sel[6][CH];
  float avg_sel[CH];
  int owner;
  int alive;
  // the previous level's region (endpoints after the num_factors drop)
  int p_ep[6][CH];
  float p_avg[CH];
  int p_count;
  int cnt0;
  int nonempty;   // bit l: the level-l region holds pixels
  int reason[4];  // group-ORed reason bits of the level-l merge decision
};

// A top-level square of 4^L blocks, one warp each: one CTA of up to 16
// warps, or (L = 3) a cluster of four CTAs of 16 warps that exchange through
// distributed shared memory. CTA rank r holds the level-2 sub-square r in
// Morton order.
template <int L>
struct Square {
  static constexpr int kG = 1 << L;            // blocks per side
  static constexpr int kWarps = 1 << (2 * L);  // blocks per square
  static constexpr int kCtas = kWarps > 16 ? kWarps / 16 : 1;
  static constexpr int kW = kWarps / kCtas;    // warps per CTA
  using Ex = Exchange<kW, kCtas>;

  // This warp's index in the square and its block's (by, bx) in the grid.
  __device__ static int locate(int bx0, int& by, int& bx) {
    int rank = 0;
    if constexpr (kCtas > 1) rank = (int)cooperative_groups::this_cluster().block_rank();
    const int warp = rank * kW + (int)(threadIdx.x >> 5);
    const int square = (int)blockIdx.x / kCtas, squares_x = (bx0 + kG - 1) / kG;
    int oy, ox;
    morton_yx<L>(warp, oy, ox);
    by = (square / squares_x) * kG + oy;
    bx = (square % squares_x) * kG + ox;
    return warp;
  }
};

template <int CH, class Ex, int LVL>
__device__ void fit_level(FitState<CH>& st, const Ex& ex) {
  constexpr int kGroup = 1 << (2 * LVL);
  const GroupReducer<Ex, kGroup> red{ex};
  int count, ep[6][CH], f8[3][2];
  float avg[CH];
  fit_and_factors<CH>(st.px, red, count, avg, ep, f8);
  drop_axes<CH>(ep, st.num_factors);
  int f8p[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) f8p[j] = f8[0][j] | (f8[1][j] << 8) | (f8[2][j] << 16);

  bool take = LVL == 0;
  if constexpr (LVL == 0) {
    st.cnt0 = count;
  } else {
    // the group's first child: its previous-level region values sit on the
    // group's first warp
    constexpr int kChild = 1 << (2 * (LVL - 1));
    constexpr int kN = 6 * CH + 1;
    int mine[kN];
#pragma unroll
    for (int e = 0; e < 6; ++e) {
#pragma unroll
      for (int c = 0; c < CH; ++c) mine[e * CH + c] = st.p_ep[e][c];
    }
    mine[6 * CH] = st.p_count;
    ex.put_ints(mine, kN);
    ex.put_floats(st.p_avg, CH);
    const int first = ex.warp & ~(kGroup - 1);
    int c0_ep[6][CH];
    float c0_avg[CH];
#pragma unroll
    for (int e = 0; e < 6; ++e) {
#pragma unroll
      for (int c = 0; c < CH; ++c) c0_ep[e][c] = ex.iget(e * CH + c, first);
    }
    const int c0_count = ex.iget(6 * CH, first);
#pragma unroll
    for (int c = 0; c < CH; ++c) c0_avg[c] = ex.fget(c, first);
    ex.done();

    bool m;
    const int reason = match_rows<CH>(st.p_avg, st.p_ep, c0_avg, c0_ep, st.lane, m);
    const bool is_child0 = (ex.warp & (kGroup - kChild)) == 0;
    const bool ok = is_child0 || m || st.p_count <= 0 || c0_count <= 0;
    st.alive = red.fold_int(st.alive & (ok ? 1 : 0), 1);
    st.reason[LVL] = red.fold_int(is_child0 ? 0 : reason, 2);
    if (st.alive) {
      st.owner = LVL;
      take = true;
    }
  }
  if (take) {
#pragma unroll
    for (int j = 0; j < 2; ++j) st.f8_sel[j] = f8p[j];
#pragma unroll
    for (int e = 0; e < 6; ++e) {
#pragma unroll
      for (int c = 0; c < CH; ++c) st.ep_sel[e][c] = ep[e][c];
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) st.avg_sel[c] = avg[c];
  }
  if (count > 0) st.nonempty |= 1 << LVL;
#pragma unroll
  for (int e = 0; e < 6; ++e) {
#pragma unroll
    for (int c = 0; c < CH; ++c) st.p_ep[e][c] = ep[e][c];
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) st.p_avg[c] = avg[c];
  st.p_count = count;
}

template <int CH, class Ex, int LVL, int L>
__device__ __forceinline__ void fit_levels_from(FitState<CH>& st, const Ex& ex) {
  fit_level<CH, Ex, LVL>(st, ex);
  if constexpr (LVL < L) fit_levels_from<CH, Ex, LVL + 1, L>(st, ex);
}

template <int CH, int L>
__global__ void __launch_bounds__(Square<L>::kW * 32, 1)
fit_levels_kernel(const int32_t* __restrict__ words, int h, int w, int num_factors,
                  int32_t* __restrict__ cnt0_out, int32_t* __restrict__ f8_out,
                  int32_t* __restrict__ eps_out, float* __restrict__ avg_out,
                  int32_t* __restrict__ owner_out, int32_t* __restrict__ stats_out,
                  int32_t* __restrict__ reasons_out) {
  using Sq = Square<L>;
  __shared__ int ibuf[2 * kMaxExchange * Sq::kW];
  __shared__ float fbuf[kMaxFloats * Sq::kW];
  const int by0 = (h + 7) / 8, bx0 = (w + 7) / 8, nb = by0 * bx0;
  FitState<CH> st;
  int by, bx;
  st.warp = Sq::locate(bx0, by, bx);
  st.lane = threadIdx.x & 31;
  st.num_factors = num_factors;
  load_block<CH>(words, h, w, by, bx, st.lane, st.px);
  st.owner = 0;
  st.alive = 1;
  st.nonempty = 0;
  const typename Sq::Ex ex{ibuf, fbuf, st.warp, st.lane};
  fit_levels_from<CH, typename Sq::Ex, 0, L>(st, ex);

  if (by >= by0 || bx >= bx0) return;  // after the last barrier
  const size_t b = (size_t)by * bx0 + bx;
#pragma unroll
  for (int j = 0; j < 2; ++j) f8_out[b * kP + st.lane + 32 * j] = st.f8_sel[j];
  if (st.lane == 0) {
    cnt0_out[b] = st.cnt0;
    owner_out[b] = st.owner;
    int stats = 0;
#pragma unroll
    for (int l = 0; l <= L; ++l) {
      const bool lead = (st.warp & ((1 << (2 * l)) - 1)) == 0;
      const bool nonempty = (st.nonempty >> l) & 1;
      if (lead && st.owner >= l && nonempty) stats |= 1 << l;
      if (l >= 1) reasons_out[(size_t)(l - 1) * nb + b] = lead && nonempty ? st.reason[l] : 0;
    }
    stats_out[b] = stats;
  }
  if (st.lane < CH) {
    // lane c writes channel c of the six endpoint rows and avg
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (c != st.lane) continue;
#pragma unroll
      for (int e = 0; e < 6; ++e) eps_out[((size_t)e * CH + c) * nb + b] = st.ep_sel[e][c];
      avg_out[(size_t)c * nb + b] = st.avg_sel[c];
    }
  }
}

template <int CH, int L>
__global__ void __launch_bounds__(Square<L>::kW * 32, 1)
owner_crush_kernel(const int32_t* __restrict__ words, int h, int w, int crush_mode, int dither,
                   int ladder_k, int num_factors, int max_pix, int max_blk, uint32_t key,
                   const int32_t* __restrict__ owner_in, const int32_t* __restrict__ f8_in,
                   const int32_t* __restrict__ eps_in, int32_t* __restrict__ shifts_out,
                   int32_t* __restrict__ q_out, int32_t* __restrict__ dec_out,
                   float* __restrict__ dist_out, float* __restrict__ dist_blk_out,
                   int32_t* __restrict__ bpp_out) {
  using Sq = Square<L>;
  __shared__ int ibuf[2 * kMaxExchange * Sq::kW];
  __shared__ float fbuf[kMaxFloats * Sq::kW];
  const int by0 = (h + 7) / 8, bx0 = (w + 7) / 8, nb = by0 * bx0;
  int by, bx;
  const int warp = Sq::locate(bx0, by, bx), lane = threadIdx.x & 31;
  const bool in_grid = by < by0 && bx < bx0;
  const size_t b = in_grid ? (size_t)by * bx0 + bx : 0;

  Pixels<CH> p;
  load_block<CH>(words, h, w, by, bx, lane, p);
  Block<CH> blk;
  int ep[6][CH];
#pragma unroll
  for (int e = 0; e < 6; ++e) {
#pragma unroll
    for (int c = 0; c < CH; ++c) ep[e][c] = in_grid ? eps_in[((size_t)e * CH + c) * nb + b] : 0;
  }
  blk.set_endpoints(ep);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f8w = in_grid ? f8_in[b * kP + lane + 32 * j] : 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) blk.f8[k][j] = (f8w >> (8 * k)) & 0xFF;
    blk.mask[j] = p.mask[j];
#pragma unroll
    for (int c = 0; c < CH; ++c) blk.px[c][j] = p.px[c][j];
  }
  // empty warps outside the grid contribute zeros to every region sum
  const OwnerReducer<typename Sq::Ex, L> red{typename Sq::Ex{ibuf, fbuf, warp, lane},
                                             in_grid ? owner_in[b] : 0};
  const int cnt_blk = __reduce_add_sync(kFull, p.mask[0] + p.mask[1]);
  blk.count = red.sum_int(cnt_blk);
  blk.max_pix = max_pix;
  blk.max_blk = max_blk;
  blk.es = (kP << (2 * L)) >= 2048 ? 4 : 0;  // ops/crush.py err_scale_shift

  int best[3];
  crush_search<CH>(blk, red, crush_mode, ladder_k, num_factors, lane, best);

  int q[3][2], dec[CH][2];
  float err_f[2];
  dither_decode<CH>(blk, best, dither != 0, key, (uint32_t)b, lane, q, dec, err_f);
  const float dist_blk = tree_sum(err_f[0], err_f[1]);
  const float dist = red.sum_float(dist_blk);

  if (!in_grid) return;  // after the last barrier
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t at = b * kP + lane + 32 * j;
    if (q_out != nullptr) q_out[at] = q[0][j] | (q[1][j] << 8) | (q[2][j] << 16);
    dec_out[at] = pack_decoded<CH>(dec, j);
  }
  if (lane == 0) {
    const int count = blk.count;
    int fac_bits = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      shifts_out[(size_t)k * nb + b] = best[k];
      fac_bits = add_wrap(fac_bits, mul_wrap(8 - min(best[k], 8), count));
    }
    const int bits = header_bits(CH) + fac_bits;
    const int bpp = min(0xFF, (bits + count / 2) / max(count, 1));
    bpp_out[b] = cnt_blk > 0 ? bpp : 0;
    dist_out[b] = dist;
    dist_blk_out[b] = dist_blk;
  }
}

// One CTA (or cluster of CTAs) per top-level square of an (h, w) image.
template <int L, class... Params, class... Args>
int launch(void (*kernel)(Params...), int h, int w, cudaStream_t st, Args... args) {
  using Sq = Square<L>;
  const int side = 8 * Sq::kG;
  const int squares = ((h + side - 1) / side) * ((w + side - 1) / side);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(squares * Sq::kCtas));
  cfg.blockDim = dim3(Sq::kW * 32);
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = Sq::kCtas;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = Sq::kCtas > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int CH, int L>
int launch_fit(const int32_t* words, int h, int w, int num_factors, int32_t* cnt0, int32_t* f8,
               int32_t* eps, float* avg, int32_t* owner, int32_t* stats, int32_t* reasons,
               cudaStream_t st) {
  return launch<L>(fit_levels_kernel<CH, L>, h, w, st, words, h, w, num_factors, cnt0, f8, eps,
                   avg, owner, stats, reasons);
}

template <int CH, int L>
int launch_crush(const int32_t* words, int h, int w, int crush_mode, int dither, int ladder_k,
                 int num_factors, int max_pix, int max_blk, uint32_t key, const int32_t* owner,
                 const int32_t* f8, const int32_t* eps, int32_t* shifts, int32_t* q,
                 int32_t* dec, float* dist, float* dist_blk, int32_t* bpp, cudaStream_t st) {
  return launch<L>(owner_crush_kernel<CH, L>, h, w, st, words, h, w, crush_mode, dither,
                   ladder_k, num_factors, max_pix, max_blk, key, owner, f8, eps, shifts, q, dec,
                   dist, dist_blk, bpp);
}

}  // namespace

extern "C" {

// Fit, merge test and owner select of every quadtree level of the (h, w)
// int32 word image (RGBA bytes, R lowest) on `stream`; levels 2 to 4.
// Outputs, row-major block order: cnt0 (nb,), f8_sel block-major (nb, 64)
// packed factors, eps (6, channels, nb), avg (channels, nb), owner (nb,),
// stats (nb,), reasons (levels - 1, nb). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for an unsupported shape.
int limg_fit_levels(const int32_t* words, int h, int w, int channels, int levels,
                    int num_factors, int32_t* cnt0, int32_t* f8, int32_t* eps, float* avg,
                    int32_t* owner, int32_t* stats, int32_t* reasons, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int key = (channels == 4 ? 10 : 0) + levels;
  switch (key) {
    case 2: return launch_fit<3, 1>(words, h, w, num_factors, cnt0, f8, eps, avg, owner, stats, reasons, st);
    case 3: return launch_fit<3, 2>(words, h, w, num_factors, cnt0, f8, eps, avg, owner, stats, reasons, st);
    case 12: return launch_fit<4, 1>(words, h, w, num_factors, cnt0, f8, eps, avg, owner, stats, reasons, st);
    case 13: return launch_fit<4, 2>(words, h, w, num_factors, cnt0, f8, eps, avg, owner, stats, reasons, st);
    case 4: return launch_fit<3, 3>(words, h, w, num_factors, cnt0, f8, eps, avg, owner, stats, reasons, st);
    case 14: return launch_fit<4, 3>(words, h, w, num_factors, cnt0, f8, eps, avg, owner, stats, reasons, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Crush, dither and decode at each block's owner level on `stream`.
// owner (nb,), f8 block-major (nb, 64), eps (6, channels, nb) as
// limg_fit_levels writes them. Outputs: shifts (3, nb), q (nullable) and
// dec block-major (nb, 64) packed words, dist (nb,) per region, dist_blk
// (nb,) per block, bpp (nb,). Returns cudaGetLastError() after the launch.
int limg_owner_crush(const int32_t* words, int h, int w, int channels, int levels,
                     int crush_mode, int dither, int ladder_k, int num_factors, int max_pix,
                     int max_blk, uint32_t key, const int32_t* owner, const int32_t* f8,
                     const int32_t* eps, int32_t* shifts, int32_t* q, int32_t* dec,
                     float* dist, float* dist_blk, int32_t* bpp, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int which = (channels == 4 ? 10 : 0) + levels;
#define LIMG_CRUSH(CH, L)                                                                     \
  launch_crush<CH, L>(words, h, w, crush_mode, dither, ladder_k, num_factors, max_pix,       \
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

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
