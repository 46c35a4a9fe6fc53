// Region encode for NVIDIA Hopper (sm_90a) at P = 256, 1024 and 4096
// (16x16, 32x32 and 64x64 pixels): the kernel template of
// region_encode.cuh, a region over one warp, 4 warps or 16; and at every
// larger P = 4096 * 4^m (128x128 pixels and up, the dense path's levels 4
// and up), a thread-block cluster of 1 to 16 CTAs a region, each CTA a
// share of 4 chunks of 4096 (encode_region_cluster_kernel).
//
// Replaces the TPU kernel limg_tpu/pallas_kernels/encode_fixed.py:
// encode_blocks_pallas (:808) at P > 64: the mono kernel _make_mono_kernel
// (:739) at P = 256 and 1024 (the latter as 4 lane chunks, _GEOM_FOR_P
// :76) and, at P = 4096, both halves of its split (_make_fit_kernel :764
// and _make_crush_kernel :781, split at _SPLIT_THRESHOLD_P :78 only for the
// TPU's VMEM), here one pass. These are the per-level encodes of the RD
// merge policy (limg_tpu_torch/regions.py _encode_level). Above P = 4096
// the TPU kernel has no geometry (_GEOM_FOR_P :76-77, looked up at :848):
// the JAX package encodes those levels in jnp (limg_tpu/regions.py:191,
// encode_blocks), whose function the cluster kernel computes.
// region_encode.cuh says what bounds them, what the design does about that,
// and what bit-exactness with the plain PyTorch version rests on.

#include "region_encode.cuh"

extern "C" {

// Launches the encode of nb regions of p = 64 * 4^l pixels (l = 1 .. 12) on
// `stream`. packed / mask are block-major (nb, p): int32 RGBA words and 0/1
// bytes. Outputs: shifts (3, nb), q and dec block-major (nb, p) packed
// words, dist (nb,), and, when eps is not null, eps (6, channels, nb) and
// avg (channels, nb); above p = 262,144 (a CTA's share of more than 4
// chunks, read from device memory pass by pass) q first holds the fit's
// factors.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another p).
int limg_encode_region(const int32_t* packed, const uint8_t* mask, int nb, int p, int channels,
                       int crush_mode, int dither, int ladder_k, int num_factors, int max_pix,
                       int max_blk, uint32_t key, int32_t* shifts, int32_t* q, int32_t* dec,
                       float* dist, int32_t* eps, float* avg, void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  const Args a{packed, mask, nb, crush_mode, dither, ladder_k, num_factors, max_pix, max_blk,
               key, shifts, q, dec, dist, eps, avg};
  cudaStream_t st = (cudaStream_t)stream;
  switch (p) {
    case 256: return launch_region<256>(a, channels, st);
    case 1024: return launch_region<1024>(a, channels, st);
    case 4096: return launch_region<4096>(a, channels, st);
    default: {
      int logc = 0;
      while (logc < kMaxLogChunks && (kChunkPixels << logc) < p) logc += 2;
      if ((kChunkPixels << logc) != p) return (int)cudaErrorInvalidValue;
      return channels == 4 ? launch_region_large<4>(a, logc, st)
                           : launch_region_large<3>(a, logc, st);
    }
  }
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
