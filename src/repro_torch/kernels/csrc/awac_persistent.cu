// Persistent AWAC loop: every AWAC round of a batch of instances in one
// cooperative launch.
//
// Replaces the TPU kernel src/repro/kernels/cycle_gain/persistent.py
// (awac_persistent_batched, kernel body _kernel).
//
// What bounds it on an H100: per round, the sweep (awac_common.cuh: the
// lookups' random sectors of col and val, and each edge's chain of
// gathers), which took 91% of a round at n = 2^20 before this design and
// 92% after it (PERF.md); then the passes over the O(B n) columns
// and the grid syncs between them.
//
// Design: the TPU kernel ran one instance per grid step with the state in
// VMEM. Here the whole grid (kLoopBlocksPerSm blocks of 256 per SM, all
// resident) works on all instances at once, keeps the state in device
// memory, and separates the phases of a round with four grid syncs. Work
// is handed out in chunks of one instance (kChunk edges or kColChunk
// columns), so the instance comes from one 32-bit division per chunk and
// a block whose instance has converged skips the chunk after one load:
//   1. sweep: Steps A+B per edge, Step C as an atomicMax of the key
//      (gain, ~pos) per column (awac_common.cuh, shared with the sweep
//      kernel);
//   2. Step D: each rooted column j reduces (gain, ~j) into its e2 column
//      mate_col[i] (i = row[pos]) with an atomicMax (max gain, smallest j
//      on a tie, as the reference's scatter-max + scatter-min), and, once
//      per warp, into one key per instance for the single-best-cycle
//      fallback (the first index of the maximum, as argmax);
//   3. survivors: an unrooted e2 column marks its winner j;
//   4. augmentation: each surviving j (or the fallback j when no cycle
//      survived) reads its old r2 = mate_row[j] and c2 = mate_col[i],
//      takes w1 = val[pos] from its key and looks up w2 = val(r2, c2) in
//      row r2, and does the reference's eight writes. Surviving cycles are
//      vertex disjoint, so no two threads touch the same slot and no
//      thread reads a slot another one writes in this phase. In the same
//      phase every column clears its own keys, dkeys and mask entries once
//      it has read them (no thread reads another column's entries here),
//      and one thread per instance counts the round, resets slot n and
//      decides whether the instance goes on. The survivor flag and the
//      fallback key are double-buffered by round parity, like the active
//      flags, so that decision reads this round's and clears the next
//      round's. The sync that ends the round stays: augmentation writes
//      state that the next sweep reads.
// Instances converge independently; the launch ends when none is active.
// Before the first round the kernel copies the input state to the outputs,
// builds every row's record (its segment and column signature,
// awac_common.cuh), which the edges fix for the whole launch, and clears
// its scratch, so the caller's scratch needs no fill. The sweep reads the
// state with plain loads (awac::ld_state); the column phases read what
// other threads wrote in the phase before with volatile loads (awac::ld).

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "awac_common.cuh"
#include "coop_grid.cuh"

namespace cg = cooperative_groups;

namespace {

using awac::kThreads;
using awac::u64;

constexpr int kLoopBlocksPerSm = 4;  // resident blocks of 256 per SM
// edges a thread keeps in flight and the longest row searched in one
// round trip, within the register budget of kLoopBlocksPerSm blocks: the
// fastest of 2 or 4 edges and rows of 16, 20 or 32 (PERF.md)
constexpr int kEdgesPerThread = 4;
constexpr int kShortRow = 20;
constexpr int kChunk = kThreads * kEdgesPerThread;
constexpr int kColsPerThread = 4;
constexpr int kColChunk = kThreads * kColsPerThread;

struct Params {
  const int* row;          // [B, cap]
  const int* col;          // [B, cap]
  const float* val;        // [B, cap]
  const int* row_ptr;      // [B, n + 2]
  const int* mate_row_in;  // [B, n + 1]
  const int* mate_col_in;
  const float* u_in;
  const float* v_in;
  const unsigned char* go0;  // [B] bool: 0 skips the instance
  const float* min_gain;     // scalar, on the card
  int max_iter;
  int B;
  int cap;
  int n;
  int edge_chunks;  // per instance
  int col_chunks;   // per instance
  int* mate_row;    // [B, n + 1] outputs, updated in place
  int* mate_col;
  float* u;
  float* v;
  int* iters;   // [B] rounds run
  // scratch, set before the first round
  int4* rec;    // [B, n] row records
  u64* keys;    // [B, n] Step-C key per column, zero between rounds
  u64* dkeys;   // [B, n] Step-D key per e2 column, zero between rounds
  u64* fb;      // [2, B] fallback key, by round parity
  int* mask;    // [B, n] surviving root columns, zero between rounds
  int* surv;    // [2, B] 1 when a cycle survived Step D, by round parity
  int* active;  // [2, B] per-instance flags, by round parity
  int* nact;    // [2] active instances, by round parity
};

__device__ __forceinline__ awac::Inst inst(const Params& p, int b) {
  return awac::instance(p.row, p.col, p.val, p.row_ptr, p.mate_row,
                        p.mate_col, p.u, p.v, p.rec, p.keys, b, p.cap, p.n);
}

__device__ __forceinline__ u64 warp_max(u64 x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  return x;
}

// dst[k] = src[k] for k < len over the whole grid, in 16-byte vectors
// when both arrays are 16-byte aligned.
__device__ __forceinline__ void copy_words(void* dst, const void* src,
                                           size_t len, int tid,
                                           int nthreads) {
  const int* s = static_cast<const int*>(src);
  int* d = static_cast<int*>(dst);
  size_t k0 = 0;
  if ((((uintptr_t)d | (uintptr_t)s) & 15) == 0) {
    const size_t n4 = len >> 2;
    for (size_t k = tid; k < n4; k += nthreads) {
      reinterpret_cast<int4*>(d)[k] = __ldg(reinterpret_cast<const int4*>(s) + k);
    }
    k0 = n4 << 2;
  }
  for (size_t k = k0 + tid; k < len; k += nthreads) d[k] = s[k];
}

__device__ void augment(const Params& p, const awac::Inst& in, int b, int j,
                        u64 key) {
  const int n = p.n;
  const size_t s = (size_t)b * (n + 1);
  int* mr = p.mate_row + s;
  int* mc = p.mate_col + s;
  const int pos = awac::key_low(key);
  const int i = __ldg(in.row + pos);
  const float w1 = __ldg(in.val + pos);
  const int r2 = awac::ld(mr + j);  // old mate row of column j
  const int c2 = awac::ld(mc + i);  // old mate col of row i
  float w2 = 0.0f;
  if (r2 >= 0 && r2 < n) {
    const int p2 = awac::find_col<kShortRow>(in.col, __ldg(in.ptr + r2),
                                             __ldg(in.ptr + r2 + 1), c2);
    if (p2 >= 0) w2 = __ldg(in.val + p2);
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

__global__ void __launch_bounds__(kThreads, kLoopBlocksPerSm)
    awac_loop_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * kThreads + (int)threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  const int lane = threadIdx.x & 31;
  const int n = p.n, B = p.B;
  const int edge_items = B * p.edge_chunks, col_items = B * p.col_chunks;
  const float min_gain = __ldg(p.min_gain);

  const size_t state_len = (size_t)B * (n + 1);
  copy_words(p.mate_row, p.mate_row_in, state_len, tid, nthreads);
  copy_words(p.mate_col, p.mate_col_in, state_len, tid, nthreads);
  copy_words(p.u, p.u_in, state_len, tid, nthreads);
  copy_words(p.v, p.v_in, state_len, tid, nthreads);
  for (int t = blockIdx.x; t < col_items; t += gridDim.x) {
    const int b = t / p.col_chunks;
    const int* colb = p.col + (size_t)b * p.cap;
    const int* ptr = p.row_ptr + (size_t)b * (n + 2);
    const int r0 = (t - b * p.col_chunks) * kColChunk + (int)threadIdx.x;
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int r = r0 + q * kThreads;
      if (r < n) {
        p.rec[(size_t)b * n + r] =
            awac::row_record(colb, __ldg(ptr + r), __ldg(ptr + r + 1));
      }
    }
  }
  for (size_t k = tid; k < (size_t)B * n; k += nthreads) {
    p.keys[k] = 0;
    p.dkeys[k] = 0;
    p.mask[k] = 0;
  }
  // the per-instance flags: block 0 alone, so that it counts the active
  // instances without an atomic on memory nobody has cleared
  if (blockIdx.x == 0) {
    __shared__ int count;
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    int mine = 0;
    for (int b = threadIdx.x; b < B; b += kThreads) {
      const int a = p.go0[b] != 0 && p.max_iter > 0;
      p.active[b] = a;
      p.iters[b] = 0;
      p.surv[b] = p.surv[B + b] = 0;
      p.fb[b] = p.fb[B + b] = 0;
      mine += a;
    }
    if (mine) atomicAdd(&count, mine);
    __syncthreads();
    if (threadIdx.x == 0) {
      p.nact[0] = count;
      p.nact[1] = 0;
    }
  }
  grid.sync();

  for (int round = 0;; ++round) {
    const int cur = round & 1;
    const int* act = p.active + cur * B;
    u64* fb = p.fb + cur * B;
    int* surv = p.surv + cur * B;
    if (awac::ld(p.nact + cur) == 0) break;

    // 1. sweep: Steps A+B+C
    for (int t = blockIdx.x; t < edge_items; t += gridDim.x) {
      const int b = t / p.edge_chunks;
      if (!awac::ld(act + b)) continue;
      awac::sweep_chunk<true, kEdgesPerThread, kShortRow>(
          inst(p, b), (t - b * p.edge_chunks) * kChunk, min_gain);
    }
    grid.sync();

    // 2. Step D and the fallback key
    for (int t = blockIdx.x; t < col_items; t += gridDim.x) {
      const int b = t / p.col_chunks;
      if (!awac::ld(act + b)) continue;
      const awac::Inst in = inst(p, b);
      u64* dkeys = p.dkeys + (size_t)b * n;
      const int j0 = (t - b * p.col_chunks) * kColChunk + (int)threadIdx.x;
      u64 best = 0;
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        const int j = j0 + q * kThreads;
        const u64 key = j < n ? awac::ld(in.keys + j) : 0;
        if (key == 0) continue;
        const int i = __ldg(in.row + awac::key_low(key));
        const u64 dk = (key & 0xffffffff00000000ull) | (u64)(unsigned int)(~j);
        const int e2 = awac::ld(in.mc + i);
        if (e2 >= 0 && e2 < n) awac::key_max(dkeys + e2, dk);
        best = dk > best ? dk : best;
      }
      best = warp_max(best);
      if (lane == 0 && best != 0) awac::key_max(fb + b, best);
    }
    grid.sync();

    // 3. survivors: an unrooted e2 column keeps its winner
    for (int t = blockIdx.x; t < col_items; t += gridDim.x) {
      const int b = t / p.col_chunks;
      if (!awac::ld(act + b)) continue;
      const size_t base = (size_t)b * n;
      const int j0 = (t - b * p.col_chunks) * kColChunk + (int)threadIdx.x;
      bool hit = false;
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        const int j = j0 + q * kThreads;
        const u64 dk = j < n ? awac::ld(p.dkeys + base + j) : 0;
        if (dk == 0 || awac::ld(p.keys + base + j) != 0) continue;
        p.mask[base + awac::key_low(dk)] = 1;
        hit = true;
      }
      if (__any_sync(0xffffffffu, hit) && lane == 0) surv[b] = 1;
    }
    grid.sync();

    // 4. augmentation, the keys cleared, and the round's bookkeeping
    for (int t = blockIdx.x; t < col_items; t += gridDim.x) {
      const int b = t / p.col_chunks;
      if (!awac::ld(act + b)) continue;
      const awac::Inst in = inst(p, b);
      const size_t base = (size_t)b * n;
      // the fallback cycle when none survived
      const u64 f = awac::ld(surv + b) ? 0 : awac::ld(fb + b);
      const int j0 = (t - b * p.col_chunks) * kColChunk + (int)threadIdx.x;
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        const int j = j0 + q * kThreads;
        if (j >= n) continue;
        if (awac::ld(p.dkeys + base + j) != 0) p.dkeys[base + j] = 0;
        const u64 key = awac::ld(p.keys + base + j);
        if (key == 0) continue;  // not rooted: never selected
        p.keys[base + j] = 0;
        bool sel = awac::ld(p.mask + base + j) != 0;
        if (sel) p.mask[base + j] = 0;
        else sel = f != 0 && awac::key_low(f) == j;
        if (sel) augment(p, in, b, j, key);
      }
    }
    int* act_next = p.active + (cur ^ 1) * B;
    for (int b = tid; b < B; b += nthreads) {
      int next = 0;
      if (awac::ld(act + b)) {
        const int it = p.iters[b] + 1;  // this thread's own counter
        p.iters[b] = it;
        next = (awac::ld(surv + b) != 0 || awac::ld(fb + b) != 0) &&
               it < p.max_iter;
        const size_t sn = (size_t)b * (n + 1) + n;
        p.mate_row[sn] = n;
        p.mate_col[sn] = n;
        p.u[sn] = 0.0f;
        p.v[sn] = 0.0f;
      }
      act_next[b] = next;
      p.surv[(cur ^ 1) * B + b] = 0;  // the next round's, unread since the
      p.fb[(cur ^ 1) * B + b] = 0;    // last round's augmentation
      if (next) atomicAdd(p.nact + (cur ^ 1), 1);
    }
    if (tid == 0) p.nact[cur] = 0;  // read by every thread before sync 1
    grid.sync();
  }
}

std::atomic<int> g_grid[coop::kMaxDevices];  // blocks per device

size_t align8(size_t x) { return (x + 7) & ~(size_t)7; }

}  // namespace

// Bytes of scratch that awac_persistent needs for B instances of n
// columns: rec [B, n] (16 B each), keys and dkeys [B, n] and fb [2, B]
// (8 B each), then mask [B, n], surv and active [2, B] and nact [2] (4 B
// each). The kernel sets all of it before it reads any.
extern "C" long long awac_persistent_scratch_bytes(int B, int n) {
  const size_t bn = (size_t)B * n;
  return (long long)align8(16 * bn + 8 * (2 * bn + 2 * (size_t)B) +
                           4 * (bn + 4 * (size_t)B + 2));
}

// Runs the AWAC loop of B instances from the state mate_row_in/
// mate_col_in/u_in/v_in [B, n + 1] and writes the final state into
// mate_row/mate_col/u/v [B, n + 1] and the rounds run per instance into
// iters [B]. go0 is [B] bool; min_gain points to a float32 on the card;
// scratch holds awac_persistent_scratch_bytes(B, n) bytes, 16-byte
// aligned, whatever their contents. cap must be < 2^31. Launches on `stream`; returns
// cudaGetLastError() (or the error of a refused launch).
extern "C" int awac_persistent(
    const int* row, const int* col, const float* val, const int* row_ptr,
    const int* mate_row_in, const int* mate_col_in, const float* u_in,
    const float* v_in, const unsigned char* go0, const float* min_gain,
    int max_iter, int B, long long cap, int n, int* mate_row, int* mate_col,
    float* u, float* v, int* iters, void* scratch, long long scratch_bytes,
    void* stream) {
  if (cap >= (1ll << 31) || scratch_bytes < awac_persistent_scratch_bytes(B, n))
    return cudaErrorInvalidValue;
  int blocks = 0;
  int err = coop::grid_blocks(awac_loop_kernel, kThreads, g_grid, &blocks);
  if (err) return err;
  const size_t bn = (size_t)B * n;
  int4* rec = (int4*)scratch;
  u64* keys = (u64*)(rec + bn);
  u64* dkeys = keys + bn;
  u64* fb = dkeys + bn;
  int* mask = (int*)(fb + 2 * (size_t)B);
  int* surv = mask + bn;
  int* active = surv + 2 * (size_t)B;
  int* nact = active + 2 * (size_t)B;
  Params p{row, col, val, row_ptr, mate_row_in, mate_col_in, u_in, v_in,
           go0, min_gain, max_iter, B, (int)cap, n,
           (int)((cap + kChunk - 1) / kChunk), (n + kColChunk - 1) / kColChunk,
           mate_row, mate_col, u, v, iters, rec, keys, dkeys, fb, mask, surv,
           active, nact};
  void* args[] = {&p};
  if ((err = cudaLaunchCooperativeKernel((void*)awac_loop_kernel,
                                         dim3(blocks), dim3(kThreads), args,
                                         0, (cudaStream_t)stream)))
    return err;
  return (int)cudaGetLastError();
}
