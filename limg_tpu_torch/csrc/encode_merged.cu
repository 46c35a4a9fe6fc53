// Fused quadtree encode for NVIDIA Hopper (sm_90a), Morton pair: fit_levels
// and owner_crush (encode_merged.cuh with NAT = false), which replace
// limg_tpu/pallas_kernels/encode_merged.py: fit_levels_pallas (:813) and
// owner_crush_pallas (:902). Per-block outputs in row-major block order,
// pixel planes block-major (nb, 64).

#include "encode_merged.cuh"

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
  return fit_levels_entry<false>(words, h, w, channels, levels, num_factors, cnt0, f8, eps, avg,
                                 owner, stats, reasons, stream);
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
  return owner_crush_entry<false>(words, h, w, channels, levels, crush_mode, dither, ladder_k,
                                  num_factors, max_pix, max_blk, key, owner, f8, eps, shifts, q,
                                  dec, dist, dist_blk, bpp, stream);
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
