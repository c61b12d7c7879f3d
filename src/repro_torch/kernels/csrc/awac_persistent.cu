// Persistent AWAC loop: every AWAC round of a batch of instances in one
// cooperative launch.
//
// Replaces the TPU kernel src/repro/kernels/cycle_gain/persistent.py
// (awac_persistent_batched, kernel body _kernel).
//
// What bounds it on an H100: memory, per round. Each round streams the
// edge list (row, col, val: 12 B per edge) through the sweep and touches
// the O(n) state a few times; the state, the two 64-bit key arrays and the
// survivor mask (about 40 B per column, 40 MB at n = 2^20) mostly stay in
// the 50 MB L2 across rounds. On top of that each round pays five grid
// syncs, a few microseconds each, which matters only for small instances.
//
// Design: the TPU kernel ran one instance per grid step with the state in
// VMEM. Here the whole grid (blocks per SM from the occupancy query times
// the SM count, so every block is resident) works on all instances at
// once, keeps the state in device memory, and separates the phases of a
// round with cooperative_groups grid syncs:
//   1. sweep: Steps A+B per edge, Step C as an atomicMax of the key
//      (gain, ~row) per column (awac_common.cuh, shared with the sweep
//      kernel);
//   2. Step D: each rooted column j reduces (gain, ~j) into its e2 column
//      mate_col[i] with an atomicMax (max gain, smallest j on a tie, as the
//      reference's scatter-max + scatter-min), and into one key per
//      instance for the single-best-cycle fallback (the first index of the
//      maximum, as argmax);
//   3. survivors: an unrooted e2 column marks its winner j;
//   4. augmentation: each surviving j (or the fallback j when no cycle
//      survived) reads its old r2 = mate_row[j] and c2 = mate_col[i],
//      looks up w1 = val(i, j) and w2 = val(r2, c2) in the CSR rows, and
//      does the reference's eight writes. Surviving cycles are vertex
//      disjoint, so no two threads touch the same slot and no thread reads
//      a slot another one writes in this phase;
//   5. bookkeeping: clear the keys, count the round, decide per instance
//      whether it goes on (a cycle survived and max_iter is not reached).
// Instances converge independently; the launch ends when none is active.
// State written inside the launch is read with volatile loads (awac::ld).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "awac_common.cuh"

namespace cg = cooperative_groups;

namespace {

using awac::u64;

constexpr int kThreads = 256;

struct Params {
  const int* row;      // [B, cap]
  const int* col;      // [B, cap]
  const float* val;    // [B, cap]
  const int* row_ptr;  // [B, n + 2]
  int* mate_row;       // [B, n + 1], updated in place
  int* mate_col;       // [B, n + 1]
  float* u;            // [B, n + 1]
  float* v;            // [B, n + 1]
  const int* go0;      // [B]: 0 skips the instance
  float min_gain;
  int max_iter;
  int B;
  long long cap;
  int n;
  u64* keys;   // [B, n] Step-C key per column, zero between rounds
  u64* dkeys;  // [B, n] Step-D key per e2 column, zero between rounds
  int* mask;   // [B, n] surviving root columns, zero between rounds
  u64* fb;     // [B] fallback key
  int* surv;   // [B] 1 when a cycle survived Step D
  int* active; // [2, B] per-instance flags, double-buffered by round
  int* nact;   // [2] active instances, double-buffered by round
  int* iters;  // [B] rounds run
};

__device__ void augment(const Params& p, int b, int j, u64 key) {
  const int n = p.n;
  const long long s = (long long)b * (n + 1);
  const int* colb = p.col + (long long)b * p.cap;
  const float* valb = p.val + (long long)b * p.cap;
  const int* ptrb = p.row_ptr + (long long)b * (n + 2);
  int* mr = p.mate_row + s;
  int* mc = p.mate_col + s;
  const int i = awac::key_low(key);
  const int r2 = awac::ld(mr + j);  // old mate row of column j
  const int c2 = awac::ld(mc + i);  // old mate col of row i
  const long long p1 = awac::window_find(colb, ptrb[i], ptrb[i + 1], j);
  float w1 = p1 >= 0 ? valb[p1] : 0.0f;
  float w2 = 0.0f;
  if (r2 >= 0 && r2 < n) {
    const long long p2 = awac::window_find(colb, ptrb[r2], ptrb[r2 + 1], c2);
    if (p2 >= 0) w2 = valb[p2];
  }
  // the reference's writes; a target of slot n is dropped, as the
  // reference resets slot n after writing it
  mr[j] = i;
  if (c2 >= 0 && c2 < n) mr[c2] = r2;
  mc[i] = j;
  if (r2 >= 0 && r2 < n) mc[r2] = c2;
  p.u[s + i] = w1;
  if (r2 >= 0 && r2 < n) p.u[s + r2] = w2;
  p.v[s + j] = w1;
  if (c2 >= 0 && c2 < n) p.v[s + c2] = w2;
}

__global__ void __launch_bounds__(kThreads) awac_loop_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int n = p.n, B = p.B;
  const long long cap = p.cap;
  const long long cols = (long long)B * n, edges = (long long)B * cap;

  for (long long b = tid; b < B; b += stride) {
    const int a = p.go0[b] != 0 && p.max_iter > 0;
    p.active[b] = a;
    p.active[B + b] = 0;
    p.iters[b] = 0;
    if (a) atomicAdd(p.nact, 1);
  }
  grid.sync();

  for (int round = 0;; ++round) {
    const int cur = round & 1;
    const int* act = p.active + (long long)cur * B;
    int* act_next = p.active + (long long)(cur ^ 1) * B;
    if (awac::ld(p.nact + cur) == 0) break;

    // 1. sweep: Steps A+B+C
    for (long long e = tid; e < edges; e += stride) {
      const int b = (int)(e / cap);
      if (!awac::ld(act + b)) continue;
      const long long s = (long long)b * (n + 1);
      const int r = p.row[e], c = p.col[e];
      float gain, w2;
      if (awac::sweep_edge(r, c, p.val[e], p.col + (long long)b * cap,
                           p.val + (long long)b * cap,
                           p.row_ptr + (long long)b * (n + 2),
                           p.mate_row + s, p.mate_col + s, p.u + s, p.v + s,
                           p.min_gain, n, &gain, &w2)) {
        awac::key_max(p.keys + (long long)b * n + c, awac::pack_key(gain, r));
      }
    }
    grid.sync();

    // 2. Step D and the fallback key
    for (long long k = tid; k < cols; k += stride) {
      const int b = (int)(k / n);
      if (!awac::ld(act + b)) continue;
      const u64 key = awac::ld(p.keys + k);
      if (key == 0) continue;
      const int j = (int)(k - (long long)b * n);
      const int i = awac::key_low(key);
      const u64 dk = (key & 0xffffffff00000000ull) | (u64)(unsigned int)(~j);
      const int e2 = awac::ld(p.mate_col + (long long)b * (n + 1) + i);
      if (e2 >= 0 && e2 < n) awac::key_max(p.dkeys + (long long)b * n + e2, dk);
      awac::key_max(p.fb + b, dk);
    }
    grid.sync();

    // 3. survivors: an unrooted e2 column keeps its winner
    for (long long k = tid; k < cols; k += stride) {
      const int b = (int)(k / n);
      if (!awac::ld(act + b)) continue;
      const u64 dk = awac::ld(p.dkeys + k);
      if (dk == 0 || awac::ld(p.keys + k) != 0) continue;
      p.mask[(long long)b * n + awac::key_low(dk)] = 1;
      p.surv[b] = 1;
    }
    grid.sync();

    // 4. augmentation
    for (long long k = tid; k < cols; k += stride) {
      const int b = (int)(k / n);
      if (!awac::ld(act + b)) continue;
      const int j = (int)(k - (long long)b * n);
      bool sel = awac::ld(p.mask + k) != 0;
      if (sel) {
        p.mask[k] = 0;
      } else if (awac::ld(p.surv + b) == 0) {
        const u64 f = awac::ld(p.fb + b);
        sel = f != 0 && awac::key_low(f) == j;
      }
      if (sel) augment(p, b, j, awac::ld(p.keys + k));
    }
    grid.sync();

    // 5. bookkeeping
    for (long long k = tid; k < cols; k += stride) {
      if (!awac::ld(act + k / n)) continue;
      p.keys[k] = 0;
      p.dkeys[k] = 0;
    }
    for (long long b = tid; b < B; b += stride) {
      int next = 0;
      if (awac::ld(act + b)) {
        const int it = awac::ld(p.iters + b) + 1;
        p.iters[b] = it;
        next = (awac::ld(p.surv + b) != 0 || awac::ld(p.fb + b) != 0) &&
               it < p.max_iter;
        const long long sn = b * (n + 1) + n;
        p.mate_row[sn] = n;
        p.mate_col[sn] = n;
        p.u[sn] = 0.0f;
        p.v[sn] = 0.0f;
      }
      act_next[b] = next;
      p.surv[b] = 0;
      p.fb[b] = 0;
      if (next) atomicAdd(p.nact + (cur ^ 1), 1);
    }
    if (tid == 0) p.nact[cur] = 0;
    grid.sync();
  }
}

}  // namespace

// Runs the AWAC loop in place on mate_row/mate_col/u/v [B, n + 1] and
// writes the rounds run per instance into iters [B]. Scratch keys, dkeys
// and mask [B, n], fb [B], surv [B] and nact [2] must be zero on entry;
// active is [2, B]. Launches on `stream`; returns cudaGetLastError() (or
// the error of a refused launch).
extern "C" int awac_persistent(const int* row, const int* col,
                               const float* val, const int* row_ptr,
                               int* mate_row, int* mate_col, float* u,
                               float* v, const int* go0, float min_gain,
                               int max_iter, int B, long long cap, int n,
                               unsigned long long* keys,
                               unsigned long long* dkeys, int* mask,
                               unsigned long long* fb, int* surv, int* active,
                               int* nact, int* iters, void* stream) {
  cudaError_t err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
    return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)))
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, awac_loop_kernel, kThreads, 0)))
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  Params p{row, col, val, row_ptr, mate_row, mate_col, u, v, go0, min_gain,
           max_iter, B, cap, n, keys, dkeys, mask, fb, surv, active, nact,
           iters};
  void* args[] = {&p};
  if ((err = cudaLaunchCooperativeKernel((void*)awac_loop_kernel,
                                         dim3(sms * per_sm), dim3(kThreads),
                                         args, 0, (cudaStream_t)stream)))
    return err;
  return (int)cudaGetLastError();
}
