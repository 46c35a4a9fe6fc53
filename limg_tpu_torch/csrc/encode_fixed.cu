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
// The fit, crush search, dither and decode are the shared device code of
// limg_common.cuh with the BlockReducer policy (each block is its own
// region); it says what bit-exactness with the plain PyTorch version
// (kernels/encode_fixed.py: encode_blocks_reference) rests on.

#include "limg_common.cuh"

namespace {

using namespace limg;

constexpr int kWarpsPerCta = 8;

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
  if (b >= nb) return;  // whole warps exit together (BlockReducer has no barrier)

  Pixels<CH> p;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t at = (size_t)b * kP + lane + 32 * j;
    p.set(j, (uint32_t)packed[at], mask_in[at] != 0);
  }
  const BlockReducer red{};
  Block<CH> blk;
  float avg[CH];
  int ep[6][CH];
  fit_and_factors<CH>(p, red, blk.count, avg, ep, blk.f8);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    blk.mask[j] = p.mask[j];
#pragma unroll
    for (int c = 0; c < CH; ++c) blk.px[c][j] = p.px[c][j];
  }
  drop_axes<CH>(ep, num_factors);
  blk.set_endpoints(ep);
  blk.max_pix = max_pix;
  blk.max_blk = max_blk;
  blk.es = 0;  // 64-pixel regions need no pre-scale

  int best[3];
  crush_search<CH>(blk, red, crush_mode, ladder_k, num_factors, lane, best);

  int q[3][2], dec[CH][2];
  float err_f[2];
  dither_decode<CH>(blk, best, dither != 0, key, (uint32_t)b, lane, q, dec, err_f);
  const float dist = tree_sum(err_f[0], err_f[1]);

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t at = (size_t)b * kP + lane + 32 * j;
    q_out[at] = q[0][j] | (q[1][j] << 8) | (q[2][j] << 16);
    dec_out[at] = pack_decoded<CH>(dec, j);
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
