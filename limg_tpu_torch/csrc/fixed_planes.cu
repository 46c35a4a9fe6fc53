// The fixed grid's output epilogue for NVIDIA Hopper (sm_90a): one kernel.
//
// fixed_planes replaces no Pallas kernel. The fixed-grid entry
// (encoder.encode_image_device) hands the block encode's packed words
// (encode_fixed_p64's q and dec, block-major (NB, 64) int32: a block's 64
// pixels contiguous) to its users as the factor planes (3, 64, NB), the
// decoded planes (ch, 64, NB) (one byte of the word each, as int32) and the
// decoded (H, W, 4) uint8 image. Composed of PyTorch operations that is an
// unpack (shift, mask) and a torch.stack per plane set, whose copies
// transpose the block-major words, and for the image a cast, a permute copy
// and a cat of the alpha plane: each pass a full read and write of the
// planes. This kernel reads each word once and writes each output once.
//
// What bounds it on the H100: bytes. Per block: 2 x 256 B read, (3 + ch) x
// 256 B of planes and 256 B of image written (8192 x 5464 RGB: 0.36 GB read,
// 1.25 GB written, 0.48 ms at 3.35 TB/s); no arithmetic to speak of.
//
// Design: a CTA takes a tile of kTile = 64 consecutive blocks. Its q and
// dec words are two contiguous 16 KB runs, read as int4 into shared
// memory. Each plane row (c, p) of the tile is then a run of 64
// consecutive int32 entries (256 B, two warps, one store each lane); each
// image row of a tile in one block row is 8 x 64 contiguous words (int4
// stores, 16 blocks a warp). The outputs (1.25 GB at 8192 x 5464) pass
// through L2 once, so they are stored streaming (evict first); tiles of 32
// blocks and plain stores took 6% longer on the H100 at that size, 512
// threads a CTA 3% longer. Blocks are numbered row-major over the block
// grid, so a tile lies in one block row wherever blocks_x is a multiple of
// kTile; a tile that spans two rows, a tail tile and edge blocks cut by
// the image are handled per store. Shared memory is XOR-swizzled so that both reads
// are free of bank conflicts: the plane pass reads one pixel of 32 blocks
// (a column), the image pass 4 pixels of a row of 4 blocks a quarter-warp.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // blocks a CTA; the plane pass's lanes
constexpr int kPixels = 64;    // an 8x8 block
constexpr int kChunks = kPixels / 4;   // int4 a block
constexpr int kThreads = 256;

// Word (j, p) of a tile lies at j * 64 + (p ^ swizzle(j)). swizzle(j) runs
// over 0..31 as j does over a warp's 32 blocks (a column's 32 words: 32
// banks); its bits 3-4 are j's low two bits (a quarter-warp's 4 blocks of
// an image row: 4 disjoint 8-bank groups). It keeps a 4-word chunk
// together, permuted within.
__device__ __forceinline__ int swizzle(int j) { return ((j & 3) << 3) | ((j >> 2) & 7); }

// o[k] = v[k ^ s]: a chunk's words in swizzled order, and back.
__device__ __forceinline__ int4 permute(int4 v, int s) {
  const int a = (s & 1) ? v.y : v.x, b = (s & 1) ? v.x : v.y;
  const int c = (s & 1) ? v.w : v.z, d = (s & 1) ? v.z : v.w;
  return (s & 2) ? make_int4(c, d, a, b) : make_int4(a, b, c, d);
}

__global__ void __launch_bounds__(kThreads)
fixed_planes_kernel(const int4* __restrict__ q_bm, const int4* __restrict__ dec_bm, int nb,
                    int channels, int blocks_x, int out_h, int out_w,
                    int32_t* __restrict__ factors, int32_t* __restrict__ decoded,
                    int32_t* __restrict__ image) {
  __shared__ int4 tile[2][kTile * kChunks];   // q, dec: 2 x 16 KB
  const int nb0 = blockIdx.x * kTile;
  const int n = min(kTile, nb - nb0);

  for (int i = threadIdx.x; i < 2 * kTile * kChunks; i += kThreads) {
    const int src = i / (kTile * kChunks), c = i % (kTile * kChunks), j = c / kChunks;
    if (j < n) {
      const int4 v = (src ? dec_bm : q_bm)[(size_t)nb0 * kChunks + c];
      const int s = swizzle(j);
      tile[src][j * kChunks + ((c % kChunks) ^ (s >> 2))] = permute(v, s & 3);
    }
  }
  __syncthreads();

  // plane rows: lane j reads word (j, p) once and writes its bytes to the
  // 3 factor or ch decoded planes
  const int j = threadIdx.x % kTile;
  const int s = swizzle(j);
  const size_t plane = (size_t)kPixels * nb;
  if (j < n) {
    for (int r = threadIdx.x / kTile; r < 2 * kPixels; r += kThreads / kTile) {
      const int src = r / kPixels, p = r % kPixels;
      const int w = reinterpret_cast<const int*>(tile[src])[j * kPixels + (p ^ s)];
      int32_t* out = (src ? decoded : factors) + (size_t)p * nb + nb0 + j;
      const int planes = src ? channels : 3;
      for (int c = 0; c < planes; ++c) __stcs(out + c * plane, (w >> (8 * c)) & 0xFF);
    }
  }
  if (image == nullptr) return;

  // image: unit u is 4 pixels (xq) of row yr of block j; 16 units a block
  // row of the tile. RGB words carry alpha 0xFF, as the plain assembly does.
  const int alpha = channels == 3 ? (int)0xFF000000u : 0;
  for (int u = threadIdx.x; u < kTile * 16; u += kThreads) {
    const int xq = u & 1, jb = (u >> 1) % kTile, yr = (u >> 1) / kTile;
    if (jb >= n) continue;
    const int b = nb0 + jb, by = b / blocks_x, bx = b - by * blocks_x;
    const int y = by * 8 + yr, x = bx * 8 + xq * 4;
    if (y >= out_h || x >= out_w) continue;
    const int sb = swizzle(jb);
    int4 v = permute(tile[1][jb * kChunks + ((yr * 2 + xq) ^ (sb >> 2))], sb & 3);
    v.x |= alpha; v.y |= alpha; v.z |= alpha; v.w |= alpha;
    int32_t* dst = image + (size_t)y * out_w + x;
    if (x + 4 <= out_w && (out_w & 3) == 0) {
      __stcs(reinterpret_cast<int4*>(dst), v);
    } else {
      const int vals[4] = {v.x, v.y, v.z, v.w};
      for (int k = 0; k < 4 && x + k < out_w; ++k) __stcs(dst + k, vals[k]);
    }
  }
}

}  // namespace

extern "C" {

// From the block-major words q_bm and dec_bm ((nb, 64) int32, contiguous,
// 16-byte aligned): factors (3, 64, nb) and decoded (channels, 64, nb) int32,
// each a byte of the word; and, where image is not null, the decoded image
// as (out_h, out_w) int32 words (the bytes of an (out_h, out_w, 4) uint8
// image, 16-byte aligned) of the grid of blocks_x blocks a row, cut at
// out_h and out_w, alpha 0xFF for channels = 3. On `stream`. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unsupported shape.
int limg_fixed_planes(const int32_t* q_bm, const int32_t* dec_bm, int nb, int channels,
                      int blocks_x, int out_h, int out_w, int32_t* factors,
                      int32_t* decoded, int32_t* image, void* stream) {
  if (nb < 0 || (channels != 3 && channels != 4) || blocks_x <= 0 || out_h < 0 || out_w < 0)
    return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  const long long ctas = ((long long)nb + kTile - 1) / kTile;
  if (ctas > INT_MAX) return (int)cudaErrorInvalidValue;
  fixed_planes_kernel<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(q_bm), reinterpret_cast<const int4*>(dec_bm), nb, channels,
      blocks_x, out_h, out_w, factors, decoded, image);
  return (int)cudaGetLastError();
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
