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
// Geometry: a CTA of 8 warps takes 32 consecutive blocks, lane l block
// b0 + l; warp w holds pixels w * P/8 .. (w + 1) * P/8 - 1 of each. The
// (P, N) inputs are read in their own layout, a row of 32 consecutive
// blocks per load (no block-major copy), and each thread keeps its pixels'
// words, factors and mask in registers for all K candidates, as the TPU
// kernel keeps its pixel slab resident across its candidate-innermost grid
// (:1085-1094). Candidates go in groups of 8: every thread's partial maxima
// and sums go to shared memory, then warp g folds candidate g's 8 partials
// per block and writes 32 consecutive outputs.
//
// What bounds it on the H100: per candidate and pixel about eval_ops(ch)
// integer operations (chip_smoke.py; ~60 for RGB) against 12 bytes of input
// per pixel read once, so it is operation-bound from K = 1 up. The per-pixel
// math is limg_common.cuh's decode_est and pixel_err, shared with every
// encode kernel; the sums are of integers, so they equal the plain
// version's in any order. A simple first version: no tuning.

#include "limg_common.cuh"

namespace {

using namespace limg;

constexpr int kWarps = 8;
constexpr int kLanes = 32;  // blocks per CTA
constexpr int kGroup = 8;   // candidates per shared-memory exchange

template <int CH, int P>
__global__ void __launch_bounds__(kWarps * kLanes)
crush_eval_kernel(const int32_t* __restrict__ packed, const int32_t* __restrict__ mask,
                  const int32_t* __restrict__ f8p, const int32_t* __restrict__ eps,
                  const int32_t* __restrict__ cands, int n, int k_count,
                  int32_t* __restrict__ pm_out, int32_t* __restrict__ be_out) {
  constexpr int kPix = P / kWarps;  // pixels per thread
  static_assert(kPix <= 32, "the mask bits of a thread fit one int");
  __shared__ int s_pm[kGroup][kWarps][kLanes];
  __shared__ int s_be[kGroup][kWarps][kLanes];
  const int warp = (int)(threadIdx.x >> 5), lane = (int)(threadIdx.x & 31);
  const int b = (int)blockIdx.x * kLanes + lane;
  const bool valid = b < n;
  const size_t col = valid ? (size_t)b : 0;

  uint32_t words[kPix], f8w[kPix], live = 0;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const size_t at = (size_t)(warp * kPix + i) * n + col;
    words[i] = valid ? (uint32_t)packed[at] : 0u;
    f8w[i] = valid ? (uint32_t)f8p[at] : 0u;
    live |= (valid && mask[at] != 0) ? 1u << i : 0u;
  }
  int n_int[3][CH], m_int[3][CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int lo = valid ? eps[(size_t)(2 * a * CH + c) * n + col] : 0;
      const int hi = valid ? eps[(size_t)((2 * a + 1) * CH + c) * n + col] : 0;
      n_int[a][c] = hi - lo;
      m_int[a][c] = lo;
    }
  }

  for (int k0 = 0; k0 < k_count; k0 += kGroup) {
    const int group = min(kGroup, k_count - k0);
    for (int g = 0; g < group; ++g) {
      int s[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) s[a] = valid ? cands[((size_t)(k0 + g) * 3 + a) * n + col] : 0;
      int pm = 0;
      uint32_t be = 0;
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        int q[3], est[CH], px[CH];
#pragma unroll
        for (int a = 0; a < 3; ++a) q[a] = (int)((f8w[i] >> (8 * a)) & 0xFFu) >> min(s[a], 8);
        decode_est<CH>(q, s, n_int, m_int, est);
#pragma unroll
        for (int c = 0; c < CH; ++c) px[c] = (int)((words[i] >> (8 * c)) & 0xFFu);
        const int err = ((live >> i) & 1u) ? pixel_err<CH>(est, px) : 0;
        pm = max(pm, err);
        be += (uint32_t)err;
      }
      s_pm[g][warp][lane] = pm;
      s_be[g][warp][lane] = (int)be;
    }
    __syncthreads();
    if (warp < group && valid) {
      int pm = s_pm[warp][0][lane];
      uint32_t be = (uint32_t)s_be[warp][0][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        pm = max(pm, s_pm[warp][w][lane]);
        be += (uint32_t)s_be[warp][w][lane];
      }
      pm_out[(size_t)(k0 + warp) * n + b] = pm;
      be_out[(size_t)(k0 + warp) * n + b] = (int)be;
    }
    __syncthreads();
  }
}

template <int CH, int P>
int launch(const int32_t* packed, const int32_t* mask, const int32_t* f8, const int32_t* eps,
           const int32_t* cands, int n, int k, int32_t* pm, int32_t* be, cudaStream_t st) {
  const unsigned grid = (unsigned)((n + kLanes - 1) / kLanes);
  crush_eval_kernel<CH, P><<<grid, kWarps * kLanes, 0, st>>>(packed, mask, f8, eps, cands, n, k,
                                                             pm, be);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixel maxima and error sums pm, be (k, n) of the k candidate shift
// triples cands (k, 3, n) of every block of the (p, n) packed words, 0/1
// mask and packed u8 factors f8 (byte a: axis a), with the endpoint rows
// eps (6, channels, n), on `stream`; p = 64 or 256. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unsupported shape.
int limg_crush_eval(const int32_t* packed, const int32_t* mask, const int32_t* f8,
                    const int32_t* eps, const int32_t* cands, int p, int n, int k, int channels,
                    int32_t* pm, int32_t* be, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int which = (channels == 4 ? 10000 : 0) + p;
  switch (which) {
    case 64: return launch<3, 64>(packed, mask, f8, eps, cands, n, k, pm, be, st);
    case 256: return launch<3, 256>(packed, mask, f8, eps, cands, n, k, pm, be, st);
    case 10064: return launch<4, 64>(packed, mask, f8, eps, cands, n, k, pm, be, st);
    case 10256: return launch<4, 256>(packed, mask, f8, eps, cands, n, k, pm, be, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
