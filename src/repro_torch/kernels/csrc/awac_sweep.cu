// AWAC sweep: Steps A+B+C of one AWAC round for a batch of instances.
//
// Replaces the TPU kernel src/repro/kernels/cycle_gain/awac_sweep.py
// (awac_sweep_batched, kernel body _kernel).
//
// What bounds it on an H100: memory, but not the bytes of its inputs read
// once (12 B of edge stream per edge, row_ptr and the state). The
// completion lookups read 32-byte sectors of col and val at random rows,
// and at n = 2^20 those arrays (67 MB each) do not fit in the 50 MB L2;
// each edge's chain of dependent gathers adds latency (awac_common.cuh).
//
// Design: the TPU grid walked edge tiles in order and carried the winner
// blocks from one tile to the next in VMEM. Blocks of a CUDA grid run in
// no order, so nothing is carried. Up to three launches:
//   0. records, only when the caller's scratch does not hold them yet: one
//      thread per row builds the row's record (its segment and column
//      signature, awac_common.cuh) and clears one column's key. The
//      records depend on the edges alone, so the rounds of one AWAC loop
//      build them once, in the first round's call;
//   1. sweep: one block per chunk of kChunk edges of one instance (the
//      instance and the offset come from blockIdx with one 32-bit
//      division per block); each candidate reduces its column's 64-bit
//      key (gain, ~pos) with one atomicMax (awac_common.cuh), which gives
//      the reference's winner whatever the order. This is the only pass
//      over the edges;
//   2. decode: one thread per column turns its key into (gain, row, w1,
//      w2): the row and w1 are row[pos] and val[pos], and w2 is the
//      completion lookup redone for the winning edge alone. It clears the
//      key it read, so the scratch leaves every call with its keys zero
//      and the next call needs no memset.

#include <cuda_runtime.h>

#include "awac_common.cuh"

namespace {

using awac::kThreads;
using awac::u64;

// edges a thread keeps in flight, the resident blocks per SM that
// sweep_kernel's registers are sized for, and the longest row searched in
// one round trip: the fastest of 2, 4 or 8 edges, 4 or 8 blocks and rows
// of 16, 20 or 32 at n = 2^20 and at B = 16 (PERF.md)
constexpr int kEdgesPerThread = 4;
constexpr int kSweepBlocksPerSm = 4;
constexpr int kShortRow = 20;
constexpr int kChunk = kThreads * kEdgesPerThread;

struct Params {
  const int* row;        // [B, cap]
  const int* col;        // [B, cap]
  const float* val;      // [B, cap]
  const int* row_ptr;    // [B, n + 2]
  const int* mate_row;   // [B, n + 1]
  const int* mate_col;   // [B, n + 1]
  const float* u;        // [B, n + 1]
  const float* v;        // [B, n + 1]
  const float* min_gain; // scalar, on the card
  int cap;
  int n;
  int chunks;  // edge chunks per instance
  int4* rec;   // [B, n] row records
  u64* keys;   // [B, n]
  float* cgain;
  int* crow;
  float* cw1;
  float* cw2;
};

__device__ __forceinline__ awac::Inst inst(const Params& p, int b) {
  return awac::instance(p.row, p.col, p.val, p.row_ptr, p.mate_row,
                        p.mate_col, p.u, p.v, p.rec, p.keys, b, p.cap, p.n);
}

__global__ void __launch_bounds__(kThreads) record_kernel(Params p) {
  const int chunks = (p.n + kThreads - 1) / kThreads;
  const int b = blockIdx.x / chunks;
  const int r = (blockIdx.x - b * chunks) * kThreads + (int)threadIdx.x;
  if (r >= p.n) return;
  const size_t k = (size_t)b * p.n + r;
  const int* ptr = p.row_ptr + (size_t)b * (p.n + 2);
  p.rec[k] = awac::row_record(p.col + (size_t)b * p.cap, __ldg(ptr + r),
                              __ldg(ptr + r + 1));
  p.keys[k] = 0;
}

__global__ void __launch_bounds__(kThreads, kSweepBlocksPerSm)
    sweep_kernel(Params p) {
  const int b = blockIdx.x / p.chunks;
  const int begin = (blockIdx.x - b * p.chunks) * kChunk;
  awac::sweep_chunk<false, kEdgesPerThread, kShortRow>(inst(p, b), begin,
                                                      __ldg(p.min_gain));
}

__global__ void __launch_bounds__(kThreads) decode_kernel(Params p) {
  const int chunks = (p.n + kThreads - 1) / kThreads;
  const int b = blockIdx.x / chunks;
  const int j = (blockIdx.x - b * chunks) * kThreads + (int)threadIdx.x;
  if (j >= p.n) return;
  const awac::Inst in = inst(p, b);
  const size_t k = (size_t)b * p.n + j;
  const u64 key = in.keys[j];
  float gain = __uint_as_float(0xff800000u);  // -inf
  int row = 0x7fffffff;                       // INT32_MAX: no candidate
  float w1 = 0.0f, w2 = 0.0f;
  if (key != 0) {
    in.keys[j] = 0;  // for the next call on this scratch
    const int pos = awac::key_low(key);
    gain = awac::key_gain(key);
    row = __ldg(in.row + pos);
    w1 = __ldg(in.val + pos);
    awac::completion<kShortRow>(in, row, j, &w2);  // found: the sweep found it
  }
  p.cgain[k] = gain;
  p.crow[k] = row;
  p.cw1[k] = w1;
  p.cw2[k] = w2;
}

}  // namespace

// Per-column winners of one sweep. rec (16 B a column, 16-byte aligned)
// and keys (8 B a column) are scratch [B, n]: with build != 0 the call
// builds the row records and clears the keys first; with build == 0 they
// must hold what an earlier call on the same edges left (the records, and
// keys all zero). The outputs cgain/crow/cw1/cw2 are [B, n]: (-inf,
// INT32_MAX, 0, 0) for a column without a candidate. min_gain points to a
// float32 on the card. cap must be < 2^31. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int awac_sweep(const int* row, const int* col, const float* val,
                          const int* row_ptr, const int* mate_row,
                          const int* mate_col, const float* u, const float* v,
                          const float* min_gain, int B, long long cap, int n,
                          void* rec, unsigned long long* keys, int build,
                          float* cgain, int* crow, float* cw1, float* cw2,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cap >= (1ll << 31)) return cudaErrorInvalidValue;
  const int chunks = (int)((cap + kChunk - 1) / kChunk);
  const int col_chunks = (n + kThreads - 1) / kThreads;
  Params p{row, col, val, row_ptr, mate_row, mate_col, u, v, min_gain,
           (int)cap, n, chunks, (int4*)rec, keys, cgain, crow, cw1, cw2};
  cudaError_t err;
  if (build && (long long)B * col_chunks > 0) {
    record_kernel<<<B * col_chunks, kThreads, 0, st>>>(p);
    if ((err = cudaGetLastError())) return err;
  }
  if ((long long)B * chunks > 0) {
    sweep_kernel<<<B * chunks, kThreads, 0, st>>>(p);
    if ((err = cudaGetLastError())) return err;
  }
  if ((long long)B * col_chunks > 0) {
    decode_kernel<<<B * col_chunks, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
