// Natural-layout quadtree encode for NVIDIA Hopper (sm_90a): two kernels,
// fit_levels_natural and owner_crush_natural, which replace
// limg_tpu/pallas_kernels/encode_natural.py: fit_levels_natural (:421,
// kernel :307) and owner_crush_natural (:528, kernel :463).
//
// They are encode_merged.cuh's kernels with NAT = true: f8_sel, q and dec
// as natural (8 by0, 8 bx0) row-major planes, the padded image's own
// layout. Each block's float sums take the natural layout's order (the JAX
// kernels' 8-row fold, then their lane butterflies at x^1, x^2, x^4), which
// the Morton pair takes too. Across a square's blocks the JAX kernels'
// alternating x / y butterflies (NatGroupReducer :152, NatOwnerReducer
// :179) pair the blocks as the Morton pair's pairwise tree does, so the
// region trees are the Morton kernels'. The TPU tiling ((64, 512) tiles,
// _C_W padding), the one-hot MXU compaction of lane-replicated rows
// (_compact / _expand :212-238) and rows_to_blocks (:248) have no
// counterpart: a block's lanes write its per-block rows in row-major block
// order directly. Dither draws the counter hash of the Morton pair, keyed
// by the global block and pixel (the JAX kernel keys its TPU PRNG by tile,
// :491).
//
// What bounds them on the H100, and the fit's design, are the Morton
// pair's (encode_merged.cuh).

#include "encode_merged.cuh"

extern "C" {

// limg_fit_levels of encode_merged.cu with the natural layout's sums; f8
// is the natural (8 by0, 8 bx0) plane of packed factors.
int limg_fit_levels_natural(const int32_t* words, int h, int w, int channels, int levels,
                            int num_factors, int32_t* cnt0, int32_t* f8, int32_t* eps,
                            float* avg, int32_t* owner, int32_t* stats, int32_t* reasons,
                            void* stream) {
  return fit_levels_entry<true>(words, h, w, channels, levels, num_factors, cnt0, f8, eps, avg,
                                owner, stats, reasons, stream);
}

// limg_owner_crush of encode_merged.cu with the natural layout's sums; f8
// (input), q (nullable) and dec are natural (8 by0, 8 bx0) planes.
int limg_owner_crush_natural(const int32_t* words, int h, int w, int channels, int levels,
                             int crush_mode, int dither, int ladder_k, int num_factors,
                             int max_pix, int max_blk, uint32_t key, const int32_t* owner,
                             const int32_t* f8, const int32_t* eps, int32_t* shifts, int32_t* q,
                             int32_t* dec, float* dist, float* dist_blk, int32_t* bpp,
                             void* stream) {
  return owner_crush_entry<true>(words, h, w, channels, levels, crush_mode, dither, ladder_k,
                                 num_factors, max_pix, max_blk, key, owner, f8, eps, shifts, q,
                                 dec, dist, dist_blk, bpp, stream);
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
