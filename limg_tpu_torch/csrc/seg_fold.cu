// Segment sum in block order for NVIDIA Hopper (sm_90a): one kernel.
//
// seg_sum_fold replaces no Pallas kernel. It is the card's route of the
// scatter-form segment sum of float32 rows (ops/segments.py seg_sum; the
// JAX package's scatter-add, limg_tpu/ops/segments.py:44), which the
// scatter refit (fit_segments(contiguous=False)) takes for each of its
// float sums: the channel sums and the direction means. On
// XLA:CPU, and in PyTorch's index_add_ on the CPU, that sum is a left fold
// over each segment's members in block order, starting from 0.0; on a card
// index_add_ adds with atomics, in an order that changes from run to run.
// This kernel folds in block order, so the card gives the CPU's sums bit
// for bit, every run.
//
// The host sorts the block indices by segment id, stably (a plan:
// kernels/seg_fold.py fold_plan): order (nb,) lists the blocks segment by
// segment, in ascending block order within a segment, and starts (s + 1,)
// gives each segment's first slot. One thread takes one (row, segment)
// pair, threads of a warp consecutive segments of one row, and folds the
// segment's members in order.
//
// What bounds it on the H100: bytes (chip_smoke.py kernel_bound: each row
// read once, the plan once, each output written once; one add a member).
// Its reads are gathers: a warp's 32 segments read their members' values at
// the positions the plan gives, one value a load, so it moves far more
// sectors than it needs wherever the members of neighbouring segments lie
// apart. A thread walks its segment alone, so one long segment's members
// are dependent adds in one thread.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void seg_sum_fold_kernel(const float* __restrict__ x, const int32_t* __restrict__ order,
                                    const int32_t* __restrict__ starts, long long nb, int s,
                                    long long total, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long r = t / s;
  const int seg = (int)(t - r * s);
  const float* row = x + r * nb;
  float acc = 0.0f;   // the JAX package's zeros, then each member in block order
  for (int i = starts[seg], end = starts[seg + 1]; i < end; ++i) acc += row[order[i]];
  out[t] = acc;
}

}  // namespace

extern "C" {

// out (rows, s) float32: each segment's sum of the (rows, nb) float32 rows x,
// a left fold over its members in block order; order (nb,) and starts
// (s + 1,) int32 as fold_plan builds them, on `stream`. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unsupported shape.
int limg_seg_sum_fold(const float* x, const int32_t* order, const int32_t* starts, int rows,
                      int nb, int s, float* out, void* stream) {
  if (rows < 0 || nb < 0 || s < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || s == 0) return (int)cudaSuccess;
  const long long total = (long long)rows * s;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  seg_sum_fold_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, order, starts, nb, s, total, out);
  return (int)cudaGetLastError();
}

const char* limg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
