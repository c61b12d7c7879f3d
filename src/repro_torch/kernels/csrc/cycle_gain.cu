// Dense cycle-gain tile, K3: for every column j of a dense [M, N] tile,
//
//   W[i, j] = ((A[i, j] + A2[i, j]) - u[i]) - v[j]
//
// where A[i, j] != 0 and A2[i, j] != 0 (0.0 marks an absent entry), else
// -inf; the output is the column max gain[j] and the smallest row[j]
// reaching it, or -inf and -1 where the column has no finite entry.
//
// Replaces the TPU kernel src/repro/kernels/cycle_gain/cycle_gain.py
// (cycle_gain, kernel body _kernel). a and a2 are [M, N] float32, row
// major; u is [M] and v [N] float32; gain is [N] float32 and row [N]
// int32. Any M and N are taken, with no padding (the TPU kernel needed
// tile multiples, and its wrapper padded with absent entries).
//
// What bounds it on an H100: bytes. Each entry of A and A2 is read once
// for three float operations, far below the card's ratio of operations to
// bytes; at 16,384 x 16,384 the two tiles are 2.15 GB, 0.64 ms at
// 3.35 TB/s. The TPU kept a (row tile, column tile) block in VMEM and
// carried the running column max across its sequential row tiles; here
// the rows are split among the warps of a block and the partial winners
// merge in shared memory.
//
// Design: one block per 32 consecutive columns, 8 warps. Lane l of every
// warp owns column blockIdx.x * 32 + l, so each row's 32 entries of A and
// of A2 are one coalesced 128-byte load per warp; warp k walks the k-th
// contiguous chunk of rows in increasing order, unrolled so that several
// rows' loads are in flight. A thread keeps its running max and its row
// in registers and moves only on a strictly greater gain, so its row is
// the smallest among its maxima; the 8 partial winners of a column merge
// in chunk order by (greater gain, else smaller row), K4's rule, which is
// the reference's (the max, then the smallest row) whatever the split.
//
// Rounding: the gain is summed in the reference's order, each step
// rounded to float32; there is no product to contract, and the build does
// not use --use_fast_math, so the kernel is bit-identical to its plain
// version. (A NaN input is outside the contract: the reference's max
// propagates it, the strict comparison here skips it.)

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kCols = 32;   // columns per block: one per lane
constexpr int kWarps = 8;   // row chunks per block
constexpr int kThreads = kCols * kWarps;

__global__ void __launch_bounds__(kThreads)
    cycle_gain_kernel(const float* __restrict__ a,
                      const float* __restrict__ a2,
                      const float* __restrict__ u,
                      const float* __restrict__ v, int M, int N,
                      float* __restrict__ gain, int* __restrict__ row) {
  __shared__ float red_g[kWarps][kCols];
  __shared__ int red_r[kWarps][kCols];
  const int lane = threadIdx.x % kCols;
  const int warp = threadIdx.x / kCols;
  const int j = blockIdx.x * kCols + lane;
  const bool col_ok = j < N;
  const int chunk = (M + kWarps - 1) / kWarps;
  const int i0 = min(M, warp * chunk);
  const int i1 = min(M, i0 + chunk);

  float best = -CUDART_INF_F;
  int part = -1;
  if (col_ok) {
    const float vj = v[j];
#pragma unroll 8
    for (int i = i0; i < i1; ++i) {
      const long long off = (long long)i * N + j;
      const float x = __ldg(a + off);
      const float y = __ldg(a2 + off);
      const float g = ((x + y) - __ldg(u + i)) - vj;
      if (x != 0.f && y != 0.f && g > best) {
        best = g;
        part = i;
      }
    }
  }
  red_g[warp][lane] = best;
  red_r[warp][lane] = part;
  __syncthreads();
  if (warp == 0 && col_ok) {
    for (int s = 1; s < kWarps; ++s) {
      const float g2 = red_g[s][lane];
      const int r2 = red_r[s][lane];
      // both -inf means both -1: nothing moves
      if (g2 > best || (g2 == best && r2 < part)) {
        best = g2;
        part = r2;
      }
    }
    gain[j] = best;
    row[j] = part;
  }
}

}  // namespace

// gain/row of every column of the [M, N] tile (see above). Launches on
// `stream`; returns the first CUDA error (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int cycle_gain(const void* a, const void* a2, const void* u,
                          const void* v, void* gain, void* row, int M, int N,
                          void* stream) {
  if (M < 0 || N <= 0) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + kCols - 1) / kCols);
  cycle_gain_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(a2),
      static_cast<const float*>(u), static_cast<const float*>(v), M, N,
      static_cast<float*>(gain), static_cast<int*>(row));
  return cudaGetLastError();
}
