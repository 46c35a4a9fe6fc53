// segment_encode at P = 256, 1024 and 4096 for NVIDIA Hopper (sm_90a): the
// dense merged path's run buffers of levels 1-3, whose lanes are 16x16,
// 32x32 and 64x64 pixel regions, one warp a region; and at every larger P =
// 64 * 4^l (levels 4 and up, 128x128 pixels and larger: the TPU kernel's
// any-P buffer, limg_tpu/pallas_kernels/encode_segments.py:205) one
// instantiation whose chunk count is a run-time value and whose regions
// are spread over the CTA's warps. The template and its design are
// csrc/segment_encode.cuh (coalesce.cu instantiates it at P = 64); a
// library of its own, so that nvcc builds it beside coalesce.cu.

#include "segment_encode.cuh"

extern "C" {

// limg_segment_encode (coalesce.cu) for a run buffer of regions of `pixels`
// = 64 * 4^l pixels (l = 1 .. 12): packed / mask / f8 / q / dec are (n,
// pixels) block-major.
int limg_segment_encode_region(const int32_t* packed, const uint8_t* mask, const int32_t* seg,
                               const int32_t* blocks, int n, int pixels, int channels,
                               int crush_mode, int dither, int ladder_k, int num_factors,
                               int max_pix, int max_blk, uint32_t key, int32_t* f8,
                               int32_t* shifts, int32_t* q, int32_t* dec, float* dist_blk,
                               int32_t* count_blk, int32_t* count_mem, int32_t* eps, float* avg,
                               void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (crush_mode == kLadder && (ladder_k < 1 || ladder_k > kMaxK)) return (int)cudaErrorInvalidValue;
  int logc = 2;
  while (logc < kMaxSpreadLogc && (kP << logc) < pixels) logc += 2;
  if ((channels != 3 && channels != 4) || (kP << logc) != pixels) return (int)cudaErrorInvalidValue;
  const SegParams P{packed, mask, seg, blocks, n, crush_mode, dither, ladder_k, num_factors,
                    max_pix, max_blk, key, f8, shifts, q, dec, dist_blk, count_blk, count_mem,
                    eps, avg, logc};
  cudaStream_t st = (cudaStream_t)stream;
  if (logc >= kSpreadLogc) {
    return channels == 3 ? launch_segment_encode<3, kSpreadLogc>(P, st)
                         : launch_segment_encode<4, kSpreadLogc>(P, st);
  }
  switch (logc * 8 + channels) {
    case 2 * 8 + 3: return launch_segment_encode<3, 2>(P, st);
    case 2 * 8 + 4: return launch_segment_encode<4, 2>(P, st);
    case 4 * 8 + 3: return launch_segment_encode<3, 4>(P, st);
    case 4 * 8 + 4: return launch_segment_encode<4, 4>(P, st);
    case 6 * 8 + 3: return launch_segment_encode<3, 6>(P, st);
    default: return launch_segment_encode<4, 6>(P, st);
  }
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
