// AWAC sweep: Steps A+B+C of one AWAC round for a batch of instances.
//
// Replaces the TPU kernel src/repro/kernels/cycle_gain/awac_sweep.py
// (awac_sweep_batched, kernel body _kernel).
//
// What bounds it on an H100: memory. Per edge it streams row, col and val
// (12 B) and gathers mate_row[col], mate_col[row], u[row], v[col], two
// row_ptr entries and a few col entries of the binary search; there are a
// handful of integer operations per byte. The O(n) state (16 B per column)
// and the 8 B key per column are small enough to stay in the 50 MB L2 at
// the sizes the solver sees (n = 2^20: about 24 MB), so the gathers are
// served mostly from L2 and the edge stream dominates device-memory
// traffic.
//
// Design: the TPU grid walked edge tiles in order and carried the winner
// blocks from one tile to the next in VMEM. Blocks of a CUDA grid run in
// no order, so nothing is carried: one thread per edge (grid-stride over
// B * cap) reduces its candidate into its column's 64-bit key (gain key,
// ~row) with one atomicMax, which gives the reference's winner (max gain,
// smallest row on a tie) whatever the order. A second pass over the edges
// lets the one edge whose row matches its column's winning key write w1
// and w2 ((row, col) pairs are unique, so exactly one edge writes), and a
// per-column pass decodes the keys. The binary search runs until lo == hi
// instead of a fixed window_steps rounds; the per-edge arrays never leave
// registers.

#include <cuda_runtime.h>

#include "awac_common.cuh"

namespace {

using awac::u64;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;  // grid-stride beyond this

__global__ void sweep_keys(const int* __restrict__ row,
                           const int* __restrict__ col,
                           const float* __restrict__ val,
                           const int* __restrict__ row_ptr,
                           const int* __restrict__ mate_row,
                           const int* __restrict__ mate_col,
                           const float* __restrict__ u,
                           const float* __restrict__ v, float min_gain, int B,
                           long long cap, int n, u64* __restrict__ keys) {
  const long long total = (long long)B * cap;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(e / cap);
    const long long s = (long long)b * (n + 1);
    float gain, w2;
    const int r = row[e], c = col[e];
    if (awac::sweep_edge(r, c, val[e], col + (long long)b * cap,
                         val + (long long)b * cap,
                         row_ptr + (long long)b * (n + 2), mate_row + s,
                         mate_col + s, u + s, v + s, min_gain, n, &gain,
                         &w2)) {
      awac::key_max(keys + (long long)b * n + c, awac::pack_key(gain, r));
    }
  }
}

__global__ void sweep_weights(const int* __restrict__ row,
                              const int* __restrict__ col,
                              const float* __restrict__ val,
                              const int* __restrict__ row_ptr,
                              const int* __restrict__ mate_row,
                              const int* __restrict__ mate_col,
                              const float* __restrict__ u,
                              const float* __restrict__ v, float min_gain,
                              int B, long long cap, int n,
                              const u64* __restrict__ keys,
                              float* __restrict__ cw1,
                              float* __restrict__ cw2) {
  const long long total = (long long)B * cap;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int r = row[e], c = col[e];
    if (r >= n || r < 0 || c >= n || c < 0) continue;
    const int b = (int)(e / cap);
    const long long k = (long long)b * n + c;
    const u64 key = keys[k];
    if (key == 0 || awac::key_low(key) != r) continue;
    // the column's winning edge: recompute its completion weight
    const long long s = (long long)b * (n + 1);
    float gain, w2;
    if (awac::sweep_edge(r, c, val[e], col + (long long)b * cap,
                         val + (long long)b * cap,
                         row_ptr + (long long)b * (n + 2), mate_row + s,
                         mate_col + s, u + s, v + s, min_gain, n, &gain,
                         &w2)) {
      cw1[k] = val[e];
      cw2[k] = w2;
    }
  }
}

__global__ void decode_keys(const u64* __restrict__ keys, long long total,
                            float* __restrict__ cgain,
                            int* __restrict__ crow) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < total; k += (long long)gridDim.x * blockDim.x) {
    const u64 key = keys[k];
    if (key == 0) {
      cgain[k] = __uint_as_float(0xff800000u);  // -inf
      crow[k] = 0x7fffffff;                   // INT32_MAX: no candidate
    } else {
      cgain[k] = awac::key_gain((unsigned int)(key >> 32));
      crow[k] = awac::key_low(key);
    }
  }
}

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// Per-column winners of one sweep. keys is scratch [B, n]; the outputs
// cgain/crow/cw1/cw2 are [B, n]: (-inf, INT32_MAX, 0, 0) for a column
// without a candidate. Launches on `stream`; returns cudaGetLastError().
extern "C" int awac_sweep(const int* row, const int* col, const float* val,
                          const int* row_ptr, const int* mate_row,
                          const int* mate_col, const float* u, const float* v,
                          float min_gain, int B, long long cap, int n,
                          unsigned long long* keys, float* cgain, int* crow,
                          float* cw1, float* cw2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long cols = (long long)B * n;
  const long long edges = (long long)B * cap;
  cudaError_t err;
  if ((err = cudaMemsetAsync(keys, 0, cols * sizeof(u64), st))) return err;
  if ((err = cudaMemsetAsync(cw1, 0, cols * sizeof(float), st))) return err;
  if ((err = cudaMemsetAsync(cw2, 0, cols * sizeof(float), st))) return err;
  if (edges > 0) {
    sweep_keys<<<grid_for(edges), kThreads, 0, st>>>(
        row, col, val, row_ptr, mate_row, mate_col, u, v, min_gain, B, cap,
        n, keys);
    if ((err = cudaGetLastError())) return err;
    sweep_weights<<<grid_for(edges), kThreads, 0, st>>>(
        row, col, val, row_ptr, mate_row, mate_col, u, v, min_gain, B, cap,
        n, keys, cw1, cw2);
    if ((err = cudaGetLastError())) return err;
  }
  if (cols > 0) {
    decode_keys<<<grid_for(cols), kThreads, 0, st>>>(keys, cols, cgain, crow);
  }
  return (int)cudaGetLastError();
}
