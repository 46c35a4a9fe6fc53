// Segment crush evaluation for NVIDIA Hopper (sm_90a): one kernel.
//
// crush_eval replaces limg_tpu/pallas_kernels/encode_fixed.py:
// crush_eval_rows_pallas (:1021) and crush_eval_rows_k_pallas (:1063), one
// kernel body (_make_eval_kernel :964): for each block and each of K
// candidate shift triples, the crushed factors' integer decode, the
// weighted error of every pixel, and the block's pixel maximum and error
// sum (ops/crush.py evaluate_batch at err-scale 0). The run-coalescing
// re-encode composed of plain ops calls it for every batch of candidates of
// its crush search (ops/crush.py find_shifts(use_kernel=True)).
//
// The candidates come in two forms. A table (the search's constant
// triples: the ladder's 27 axis sweeps, an exhaustive chunk of 81, the
// guess mode's 4, the floors' (0, 0, 0)) comes as a plan worked out on the
// host (kernels/crush_eval.py eval_plan), passed by value: each distinct
// triple once, in an order where consecutive triples differ in one axis,
// the inner one, and a map from output rows to evaluated triples. Per-block
// triples (the ladder's verified candidates) come as (K, 3, N) and are each
// evaluated in full.
//
// Geometry: a CTA of 8 warps takes 32 consecutive blocks, lane l block
// b0 + l; warp w holds 8 pixels of each block at a time (P / 64 chunks).
// The (P, N) inputs are read in their own layout, a row of 32 consecutive
// blocks per load, and each thread keeps its pixels' channels, factors and
// mask in registers for all candidates. Each thread also keeps, per pixel
// and channel, a base: the inner axis's offset and the decode of the two
// other axes (offsets and factor terms; an integer sum, so the order of its
// terms does not change its bits). A plan step that changes only the inner
// axis's shift decodes that axis alone, one multiply-add, shift and add
// onto the base a channel. Per candidate, the shifts' multiplier (without
// mult_for's branches), mask and the normals times the multiplier are set
// once, outside the pixel loop, and a channel's clamp to [0, 255] is one
// DPX instruction (crush_search.cuh clamped_pixel_err). Each thread's pixel
// max and error sum of a candidate go to the block's slot in shared memory
// by one atomicMax and one atomicAdd (integers: any order), so no barrier
// falls between candidates; after the last one, the CTA's warps write 32
// consecutive outputs a row.
//
// What bounds it on the H100: its integer operations (chip_smoke.py
// kernel_bound: one axis decode per distinct (axis, shift) and one channel
// sum and error per distinct triple of a block's candidates) against 12
// bytes of input per pixel read once: operation-bound from K = 1 up. At the
// 4K sweep it issues ~30 instructions a pixel and candidate, near the SMs'
// issue rate (PERF.md).

#include "crush_search.cuh"

namespace {

using namespace limg;

constexpr int kWarps = 8;
constexpr int kLanes = 32;                // blocks per CTA
constexpr int kPix = 8;                   // pixels a thread holds at a time
constexpr int kChunk = kWarps * kPix;     // pixels of each block a CTA holds at a time
constexpr int kMaxSteps = 128;            // evaluations per shared-memory tile

// A table's evaluation plan (kernels/crush_eval.py eval_plan, pack_plan).
struct Plan {
  int n_steps;                     // distinct triples, at most kMaxSteps
  int n_out;                       // output rows, at most kMaxSteps
  int step[kMaxSteps];             // s0 | s1 << 4 | s2 << 8 | inner << 12 | rebase << 14
  unsigned char out[kMaxSteps];    // output row r takes step out[r]
};

constexpr int kRebase = 1 << 14;

// One axis k at shift s of a lane's block: the factor's bit offset and mask,
// the normals times the dequantisation multiplier (0 for a dropped axis,
// whose multiplier is 0), and the offsets (a dropped B or C axis drops its
// offset too).
template <int CH>
struct Axis {
  int shr, qm, mn[CH], madd[CH];

  __device__ __forceinline__ Axis(int k, int s, const int (*frame)[kLanes], int lane) {
    // limg_common.cuh mult_for(se) without its switch's branches: 1 << se
    // below 4, then 17, 36, 85, 255, and 0 at 8
    const int se = min(s, 8);
    const int mul = se < 4 ? 1 << se : (int)((0xFF552411ull >> (8 * (se - 4))) & 0xFFull);
    shr = 8 * k + se;
    qm = 0xFF >> se;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      mn[c] = mul_wrap(mul, frame[k * CH + c][lane]);
      madd[c] = (k == 0 || s <= 7) ? frame[(3 + k) * CH + c][lane] : 0;
    }
  }
  // (f_dec * normal + 128) >> 8 of channel c, for the packed factors f8w
  // of one pixel (q * (mult * n) is f_dec * n in wrapping int32)
  __device__ __forceinline__ int factor(int f8w, int c) const {
    const int q = (int)(((uint32_t)f8w >> shr) & (uint32_t)qm);
    return (int)((uint32_t)q * (uint32_t)mn[c] + 128u) >> 8;
  }
  // the axis's decode of channel c: offset plus factor term
  __device__ __forceinline__ int term(int f8w, int c) const { return madd[c] + factor(f8w, c); }
};

template <int CH, int P, bool kTable>
__global__ void __launch_bounds__(kWarps * kLanes, 2)
crush_eval_kernel(const int32_t* __restrict__ packed, const int32_t* __restrict__ mask,
                  const int32_t* __restrict__ f8p, const int32_t* __restrict__ eps,
                  const int32_t* __restrict__ cands, int n, int k_count,
                  const __grid_constant__ Plan plan, int32_t* __restrict__ pm_out,
                  int32_t* __restrict__ be_out) {
  static_assert(P % kChunk == 0, "a block is whole chunks");
  extern __shared__ int acc[];                 // [2][tile][kLanes]: pixel maxima, error sums
  __shared__ int frame[6 * CH][kLanes];        // normals n[k][c], then offsets m[k][c]
  const int warp = (int)(threadIdx.x >> 5), lane = (int)(threadIdx.x & 31);
  const int b = (int)blockIdx.x * kLanes + lane;
  const bool valid = b < n;
  const size_t col = valid ? (size_t)b : 0;

  for (int r = warp; r < 3 * CH; r += kWarps) {
    const int k = r / CH, c = r % CH;
    const int lo = valid ? eps[(size_t)(2 * k * CH + c) * n + col] : 0;
    const int hi = valid ? eps[(size_t)((2 * k + 1) * CH + c) * n + col] : 0;
    frame[r][lane] = (int)((uint32_t)hi - (uint32_t)lo);
    frame[3 * CH + r][lane] = lo;
  }

  const int total = kTable ? plan.n_steps : k_count;
#pragma unroll 1
  for (int t0 = 0; t0 < total; t0 += kMaxSteps) {
    const int nt = min(kMaxSteps, total - t0);
    int* acc_pm = acc;
    int* acc_be = acc + nt * kLanes;
    for (int i = (int)threadIdx.x; i < 2 * nt * kLanes; i += kWarps * kLanes) acc[i] = 0;
    __syncthreads();
#pragma unroll 1
    for (int p0 = 0; p0 < P; p0 += kChunk) {
      int px[CH][kPix], f8w[kPix], live[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const size_t at = (size_t)(p0 + warp * kPix + j) * n + col;
        const uint32_t w = valid ? (uint32_t)packed[at] : 0u;
        f8w[j] = valid ? f8p[at] : 0;
        live[j] = (valid && mask[at] != 0) ? -1 : 0;
#pragma unroll
        for (int c = 0; c < CH; ++c) px[c][j] = (int)((w >> (8 * c)) & 0xFFu);
      }
      // per pixel and channel: the inner axis's offset and the two other
      // axes' decode
      int base[CH][kPix];
#pragma unroll 1
      for (int i = 0; i < nt; ++i) {
        int st;
        if constexpr (kTable) {
          st = plan.step[t0 + i];
        } else {
          // the search's shifts are 0..8; one above 8 decodes as 8
          int s[3];
#pragma unroll
          for (int a = 0; a < 3; ++a)
            s[a] = valid ? min(max(cands[((size_t)(t0 + i) * 3 + a) * n + col], 0), 8) : 0;
          st = s[0] | (s[1] << 4) | (s[2] << 8) | (2 << 12) | kRebase;
        }
        const int inner = (st >> 12) & 3, s_in = (st >> (4 * inner)) & 15;
        if (st & kRebase) {
          // the inner axis's offset: a table's as at a kept shift, per-block
          // triples' at their own
          const Axis<CH> off(inner, kTable ? 0 : s_in, frame, lane);
#pragma unroll
          for (int j = 0; j < kPix; ++j) {
#pragma unroll
            for (int c = 0; c < CH; ++c) base[c][j] = off.madd[c];
          }
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            if (k == inner) continue;
            const Axis<CH> ax(k, (st >> (4 * k)) & 15, frame, lane);
#pragma unroll
            for (int j = 0; j < kPix; ++j) {
#pragma unroll
              for (int c = 0; c < CH; ++c) base[c][j] += ax.term(f8w[j], c);
            }
          }
        }
        if (kTable && inner > 0 && s_in > 7) {
          // a dropped B or C inner axis (a group's last step: eval_plan
          // sorts a group's shifts) has no offset: out of the base
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            const int m = frame[(3 + inner) * CH + c][lane];
#pragma unroll
            for (int j = 0; j < kPix; ++j) base[c][j] -= m;
          }
        }
        const Axis<CH> ax(inner, s_in, frame, lane);
        int pm = 0, be = 0;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          int est[CH];
#pragma unroll
          for (int c = 0; c < CH; ++c) est[c] = base[c][j] + ax.factor(f8w[j], c);
          const int e = clamped_pixel_err<CH>(est, px, j) & live[j];
          pm = max(pm, e);
          be += e;
        }
        atomicMax(&acc_pm[i * kLanes + lane], pm);
        atomicAdd(&acc_be[i * kLanes + lane], be);
      }
    }
    __syncthreads();
    const int n_out = kTable ? plan.n_out : nt;
    if (valid) {
      for (int r = warp; r < n_out; r += kWarps) {
        const int i = kTable ? (int)plan.out[r] : r;
        pm_out[(size_t)(t0 + r) * n + b] = acc_pm[i * kLanes + lane];
        be_out[(size_t)(t0 + r) * n + b] = acc_be[i * kLanes + lane];
      }
    }
    __syncthreads();
  }
}

template <int CH, int P>
int launch(const int32_t* packed, const int32_t* mask, const int32_t* f8, const int32_t* eps,
           const int32_t* cands, const Plan* plan, int n, int k, int32_t* pm, int32_t* be,
           cudaStream_t st) {
  const unsigned grid = (unsigned)((n + kLanes - 1) / kLanes);
  const int tile = plan ? plan->n_steps : min(k, kMaxSteps);
  const size_t smem = (size_t)2 * tile * kLanes * sizeof(int);
  if (plan) {
    crush_eval_kernel<CH, P, true><<<grid, kWarps * kLanes, smem, st>>>(
        packed, mask, f8, eps, nullptr, n, k, *plan, pm, be);
  } else {
    crush_eval_kernel<CH, P, false><<<grid, kWarps * kLanes, smem, st>>>(
        packed, mask, f8, eps, cands, n, k, Plan{}, pm, be);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixel maxima and error sums pm, be (k, n) of k candidate shift triples of
// every block of the (p, n) packed words, 0/1 mask and packed u8 factors f8
// (byte a: axis a), with the endpoint rows eps (6, channels, n), on
// `stream`; p = 64 or 256. With plan = NULL the triples are cands (k, 3, n)
// on the device, one per block; otherwise plan, in host memory, is a
// table's evaluation plan: n_steps, n_out (= k), n_steps step words, then
// n_out step indices (kernels/crush_eval.py pack_plan), and cands is not
// read. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unsupported shape or a malformed plan.
int limg_crush_eval(const int32_t* packed, const int32_t* mask, const int32_t* f8,
                    const int32_t* eps, const int32_t* cands, const int32_t* plan, int p, int n,
                    int k, int channels, int32_t* pm, int32_t* be, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  Plan host_plan;
  const Plan* pl = nullptr;
  if (plan) {
    const int n_steps = plan[0], n_out = plan[1];
    if (n_steps < 1 || n_steps > kMaxSteps || n_out != k || n_out > kMaxSteps)
      return (int)cudaErrorInvalidValue;
    host_plan = Plan{};
    host_plan.n_steps = n_steps;
    host_plan.n_out = n_out;
    for (int i = 0; i < n_steps; ++i) host_plan.step[i] = plan[2 + i];
    for (int r = 0; r < n_out; ++r) {
      const int i = plan[2 + n_steps + r];
      if (i < 0 || i >= n_steps) return (int)cudaErrorInvalidValue;
      host_plan.out[r] = (unsigned char)i;
    }
    pl = &host_plan;
  }
  const int which = (channels == 4 ? 10000 : 0) + p;
  switch (which) {
    case 64: return launch<3, 64>(packed, mask, f8, eps, cands, pl, n, k, pm, be, st);
    case 256: return launch<3, 256>(packed, mask, f8, eps, cands, pl, n, k, pm, be, st);
    case 10064: return launch<4, 64>(packed, mask, f8, eps, cands, pl, n, k, pm, be, st);
    case 10256: return launch<4, 256>(packed, mask, f8, eps, cands, pl, n, k, pm, be, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
