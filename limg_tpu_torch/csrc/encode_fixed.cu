// Fixed-grid block encode for NVIDIA Hopper (sm_90a): the region encode
// of region_encode.cuh at P = 64, one 8x8 block over 8 lanes, four blocks
// a warp, 32 blocks a CTA.
//
// Replaces the TPU kernel limg_tpu/pallas_kernels/encode_fixed.py:
// encode_blocks_pallas (:808) at P = 64, i.e. the mono kernel
// _make_mono_kernel (:739) with _fit_and_factors (:258) and
// _crush_dither_decode (:347). region_encode.cuh says what bounds it, what
// its design does about that, and what bit-exactness with the plain
// PyTorch version (kernels/encode_fixed.py encode_blocks_reference) rests
// on. A block is the search's level-0 region: every reduction is a shuffle
// within its 8 lanes, and no thread passes a CTA barrier.

#include "region_encode.cuh"

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
  const Args a{packed, mask, nb, crush_mode, dither, ladder_k, num_factors, max_pix, max_blk,
               key, shifts, q, dec, dist, eps, avg};
  return launch_region<64>(a, channels, (cudaStream_t)stream);
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
