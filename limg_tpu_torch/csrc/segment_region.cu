// segment_encode at every P = 64 * 4^l > 64 for NVIDIA Hopper (sm_90a): the
// dense merged path's run buffers of levels 1 and up (16x16 px regions and
// larger; the TPU kernel's any-P buffer,
// limg_tpu/pallas_kernels/encode_segments.py:205). P = 256 runs
// csrc/segment_encode.cuh (one warp a region, as coalesce.cu's P = 64);
// from P = 1024 on csrc/segment_cluster.cuh (a thread-block cluster a
// segment), one instantiation each at P = 1024 and 4096 and one for every
// larger P, whose chunk count is a run-time value. A library of its own, so
// that nvcc builds it beside coalesce.cu.

#include "segment_cluster.cuh"

extern "C" {

// limg_segment_encode (coalesce.cu) for a run buffer of regions of `pixels`
// = 64 * 4^l pixels (l >= 1): packed / mask / f8 / q / dec are (n, pixels)
// block-major; from P = 1024 on, scratch ((4 n + 2) int32) holds the cluster
// design's list of segments and its counters (P = 256 ignores it).
int limg_segment_encode_region(const int32_t* packed, const uint8_t* mask, const int32_t* seg,
                               const int32_t* blocks, int n, int pixels, int channels,
                               int crush_mode, int dither, int ladder_k, int num_factors,
                               int max_pix, int max_blk, uint32_t key, int32_t* f8,
                               int32_t* shifts, int32_t* q, int32_t* dec, float* dist_blk,
                               int32_t* count_blk, int32_t* count_mem, int32_t* eps, float* avg,
                               int32_t* scratch, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (crush_mode == kLadder && (ladder_k < 1 || ladder_k > kMaxK))
    return (int)cudaErrorInvalidValue;
  int logc = 2;
  while (logc < kMaxLogc && (kP << logc) < pixels) logc += 2;
  if ((channels != 3 && channels != 4) || (kP << logc) != pixels) return (int)cudaErrorInvalidValue;
  const SegParams P{packed, mask, seg, blocks, n, crush_mode, dither, ladder_k, num_factors,
                    max_pix, max_blk, key, f8, shifts, q, dec, dist_blk, count_blk, count_mem,
                    eps, avg, logc};
  cudaStream_t st = (cudaStream_t)stream;
  if (logc == 2)
    return channels == 3 ? launch_segment_encode<3, 2>(P, st) : launch_segment_encode<4, 2>(P, st);
  if (logc >= kBigLogc) {
    return channels == 3 ? launch_segment_cluster<3, kBigLogc>(P, scratch, st)
                         : launch_segment_cluster<4, kBigLogc>(P, scratch, st);
  }
  switch (logc * 8 + channels) {
    case 4 * 8 + 3: return launch_segment_cluster<3, 4>(P, scratch, st);
    case 4 * 8 + 4: return launch_segment_cluster<4, 4>(P, scratch, st);
    case 6 * 8 + 3: return launch_segment_cluster<3, 6>(P, scratch, st);
    default: return launch_segment_cluster<4, 6>(P, scratch, st);
  }
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
