// Persistent MCM: every phase of one instance's maximum cardinality
// matching (a layered BFS from the free columns with weight-aware parents,
// then the lockstep trace of the augmenting paths it found and their flip)
// in one cooperative launch.
//
// Replaces no TPU kernel: the JAX package's MCM (src/repro/core/single.py,
// mcm and _mcm_bfs) is plain jnp under a host loop. Its port,
// repro_torch/core/single.py::mcm_plain, is this kernel's plain version;
// both give the same mates, phases and BFS layers, bit for bit.
//
// What bounds it on an H100: a BFS layer reads the columns of every row not
// yet visited in its phase (4 bytes an edge) and tests each against the
// frontier, plus row_ptr and the row's visit stamp (8 bytes a row): about
// 75 MB a layer at n = 2.7M, nnz 13.3M, 22 us at 3.35 TB/s. Measured there
// (PERF.md): about 50 us for a layer that visits few rows, up to 160 us in
// the middle of a phase's BFS, where many rows meet the frontier, 89 us on
// average; the trace steps take a tenth of the launch. The plain version
// spends about 25 times as long on the host: some fifteen launches over the
// whole edge list and four syncs of the host a layer. A first design kept
// the frontier as an int per column (10.8 MB, gathered from L2): 126 us a
// layer. A bitmap (338 KB) keeps its hot words in L1.
//
// Design (edges lex-sorted by (row, col), CSR row_ptr [n + 2]; mate arrays
// [n + 1] with sentinel n):
//   - BFS, row pull: one thread a row (grid-stride) scans its segment in
//     edge order, kEdgeGroup edges at a time (their column loads, then
//     their frontier bits, in flight together), and keeps the heaviest edge
//     into the frontier, the first in edge order on a tie (strict >). That
//     is the plain version's segment_max_with_payload (the max, then the
//     smallest edge index), without an atomic; an edge of value -inf never
//     beats the start value -inf, as the plain version leaves such entries
//     out, and -0.0 ties with +0.0 as there. A newly visited free row marks
//     the layer found; a matched one sets its column's bit in the next
//     frontier (atomicOr).
//   - Frontiers: a phase's first layer reads the bitmap of the free
//     columns, which the launch builds once and each flip keeps (the free
//     column that ends an augmenting path is matched, and no column is
//     ever freed), with their count, which decides whether a phase runs.
//     Later layers read one of three bitmaps by the layer's number over the
//     launch: layer g reads F[g % 3], sets F[(g + 1) % 3] and clears
//     F[(g + 2) % 3], which layer g - 1 read and layer g + 1 sets. A row's
//     visit is a stamp, the phase's number, never cleared.
//   - A layer's flags (a row found, a row visited) are ORed per block with
//     __syncthreads_or and set by one thread in one of three slots, used in
//     turn: the slot that the next layer writes is cleared in this one, two
//     grid syncs after every thread read it.
//   - Trace: the walkers are the free rows reached, named by their row. A
//     free row is reached only in the phase's last layer, so it claims its
//     first column in that layer. A claim is a 64-bit key, high word
//     ~phase, low word the walker, reduced with atomicMin: a claim of an
//     earlier phase always loses, so the claims are never cleared. Then one
//     grid sync a step: a walker reads its column's claim, stops if it
//     lost, else moves to the column's mate row and claims that row's
//     parent column at once. A column sits in one BFS layer, so two steps
//     never claim the same column, and the plain version's per-step
//     segment_min is the atomicMin over one step's claims.
//   - Flip: a walker that wins its last step flips its own path at once,
//     alone, in the same grid phase. Surviving paths share no column and so
//     no row, and a flip reads and writes its own path's slots only, so no
//     grid sync is needed between its steps.
//   - The host reads stats once: phases, BFS layers and whether a column is
//     still free.
// What other blocks wrote before the last grid sync is read with plain
// loads (the sync's fences make it visible, and the frontier's hot words
// then stay in L1); the claims, which other threads raise in the phase
// before, with volatile loads. col, val and row_ptr are read-only for the
// whole launch; the columns are loaded evict-first, so the edges passing
// through L2 once a layer do not evict the O(n) stamps, bitmaps and mates.

#include <atomic>
#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "coop_grid.cuh"

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
// resident blocks of kThreads per SM, and the edges of a row whose loads
// are in flight together (a layer took about the same time at 4 to 16
// edges and 4 to 8 blocks, PERF.md)
constexpr int kBlocksPerSm = 4;
constexpr int kEdgeGroup = 8;
constexpr int kSlots = 3;        // decision slots, used in turn
constexpr int kFound = 0, kVisited = 1, kSlotWords = 2;
constexpr int kCtlWords = kSlots * kSlotWords + 1;  // + the free count

struct Params {
  const int* col;          // [cap]
  const float* val;        // [cap]
  const int* row_ptr;      // [n + 2]
  const int* mate_row_in;  // [n + 1]
  const int* mate_col_in;  // [n + 1]
  int n;
  int words;         // words of a column bitmap: ceil(n / 32) rounded up
                     // to a multiple of 4, the tail zero
  int* mate_row;     // [n + 1] outputs, updated in place
  int* mate_col;     // [n + 1]
  long long* stats;  // [3]: phases, BFS layers, 1 when a column is free
  // scratch, set before it is read
  u64* claim;           // [n] best claim on the column: (~phase, walker)
  int* visit;           // [n] phase that visited the row (0: none yet)
  int* parent;          // [n] BFS parent column of a visited row
  int* wcur;            // [n] a walker's row after its last step
  unsigned int* free_bits;  // [words] the free columns
  unsigned int* front;      // [3, words] the frontiers, by layer number
  int* ctl;             // [kCtlWords] the layers' flags, the free count
  unsigned char* walk;  // [walk_len] 1 while the row's walker is alive
  int walk_len;         // n rounded up to 16
};

__device__ __forceinline__ u64 claim_key(int phase, int walker) {
  return ((u64)(0xffffffffu - (unsigned int)phase) << 32) |
         (u64)(unsigned int)walker;
}

__device__ __forceinline__ bool has(const unsigned int* bits, int c) {
  return (bits[c >> 5] >> (c & 31)) & 1u;
}

template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return *(const volatile T*)p;
}

// Flips the augmenting path of walker i (the plain version's flip loop for
// one surviving walker): at most `steps` column steps up to a free column,
// which leaves the free columns.
__device__ void flip(const Params& p, int i, int steps) {
  int cur = i;
  for (int s = 0; s < steps; ++s) {
    const int j = p.parent[cur];
    const int prev = p.mate_row[j];
    p.mate_row[j] = cur;
    p.mate_col[cur] = j;
    if (prev >= p.n) {
      atomicAnd(p.free_bits + (j >> 5), ~(1u << (j & 31)));
      atomicSub(p.ctl + kSlots * kSlotWords, 1);
      break;
    }
    cur = prev;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    mcm_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * kThreads + (int)threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  const int n = p.n, words = p.words;
  int* free_count = p.ctl + kSlots * kSlotWords;

  for (int k = tid; k <= n; k += nthreads) {
    p.mate_row[k] = p.mate_row_in[k];
    p.mate_col[k] = p.mate_col_in[k];
  }
  for (int k = tid; k < n; k += nthreads) {
    p.claim[k] = ~0ull;
    p.visit[k] = 0;
  }
  for (int k = tid; k < 3 * words; k += nthreads) p.front[k] = 0;
  for (int k = tid; k < p.walk_len; k += nthreads) p.walk[k] = 0;
  if (tid < kCtlWords) p.ctl[tid] = 0;
  grid.sync();
  // the free columns, a word a warp at a time, and their count
  {
    const int lane = threadIdx.x & 31;
    const int nwarps = nthreads >> 5;
    int mine = 0;
    for (int w = tid >> 5; w < words; w += nwarps) {
      const int j = w * 32 + lane;
      const unsigned int bits =
          __ballot_sync(0xffffffffu, j < n && p.mate_row_in[j] == n);
      if (lane == 0) {
        p.free_bits[w] = bits;
        mine += __popc(bits);
      }
    }
    if (mine) atomicAdd(free_count, mine);
  }
  grid.sync();

  int phases = 0, dec = 0, g = 0;
  long long layers = 0;
  // each phase but the last augments, so n + 1 phases bound the loop
  for (int phase = 1; phase <= n + 1 && ld(free_count) > 0; ++phase) {
    ++phases;
    // ---- the layered BFS of this phase
    int k = 0;
    bool found = false;
    for (;; ++k) {
      ++g;  // this layer's number over the launch
      const unsigned int* front =
          k == 0 ? p.free_bits : p.front + (g % 3) * words;
      unsigned int* next = p.front + ((g + 1) % 3) * words;
      unsigned int* stale = p.front + ((g + 2) % 3) * words;
      for (int w = tid; w < words; w += nthreads) stale[w] = 0;
      int* slot = p.ctl + (dec % kSlots) * kSlotWords;
      if (tid == 0) {
        int* later = p.ctl + ((dec + 1) % kSlots) * kSlotWords;
        later[kFound] = later[kVisited] = 0;
      }
      bool f_found = false, f_visited = false;
      for (int i = tid; i < n; i += nthreads) {
        if (p.visit[i] == phase) continue;
        const int lo = __ldg(p.row_ptr + i), hi = __ldg(p.row_ptr + i + 1);
        float best = -INFINITY;
        int bc = -1;
        for (int e0 = lo; e0 < hi; e0 += kEdgeGroup) {
          int c[kEdgeGroup];
          bool in[kEdgeGroup];
#pragma unroll
          for (int q = 0; q < kEdgeGroup; ++q)
            c[q] = e0 + q < hi ? __ldcs(p.col + e0 + q) : -1;
#pragma unroll
          for (int q = 0; q < kEdgeGroup; ++q)
            in[q] = c[q] >= 0 && has(front, c[q]);
#pragma unroll
          for (int q = 0; q < kEdgeGroup; ++q) {
            if (!in[q]) continue;
            const float v = __ldg(p.val + e0 + q);
            if (v > best) {
              best = v;
              bc = c[q];
            }
          }
        }
        if (bc < 0) continue;
        p.visit[i] = phase;
        p.parent[i] = bc;
        f_visited = true;
        const int m = p.mate_col[i];
        if (m == n) {  // a free row: this is the phase's last layer
          f_found = true;
          p.walk[i] = 1;
          atomicMin(p.claim + bc, claim_key(phase, i));
        } else {
          atomicOr(next + (m >> 5), 1u << (m & 31));
        }
      }
      if (__syncthreads_or(f_found) && threadIdx.x == 0) slot[kFound] = 1;
      if (__syncthreads_or(f_visited) && threadIdx.x == 0)
        slot[kVisited] = 1;
      grid.sync();
      ++dec;
      ++layers;
      found = ld(slot + kFound) != 0;
      if (found || !ld(slot + kVisited) || k + 1 > n) break;
    }
    if (!found) break;

    // ---- trace the walkers step by step; flip the survivors
    const int steps = k + 1;
    for (int t = 0; t < steps; ++t) {
      for (int q = tid; q < p.walk_len / 16; q += nthreads) {
        const uint4 w = reinterpret_cast<const uint4*>(p.walk)[q];
        if ((w.x | w.y | w.z | w.w) == 0) continue;
        const unsigned int quad[4] = {w.x, w.y, w.z, w.w};
#pragma unroll 1
        for (int b = 0; b < 16; ++b) {
          if (((quad[b >> 2] >> (8 * (b & 3))) & 0xffu) == 0) continue;
          const int i = q * 16 + b;
          const u64 key = claim_key(phase, i);
          int cur = t == 0 ? i : p.wcur[i];
          const int j = p.parent[cur];
          if (ld(p.claim + j) != key) {  // lost the column
            p.walk[i] = 0;
            continue;
          }
          if (t + 1 == steps) {
            flip(p, i, steps);
            p.walk[i] = 0;
            continue;
          }
          const int up = p.mate_row[j];
          if (up < n) cur = up;
          p.wcur[i] = cur;
          atomicMin(p.claim + p.parent[cur], key);
        }
      }
      grid.sync();
    }
  }
  if (tid == 0) {
    p.stats[0] = phases;
    p.stats[1] = layers;
    p.stats[2] = ld(free_count) > 0;
  }
}

std::atomic<int> g_grid[coop::kMaxDevices];  // blocks per device

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Words of one column bitmap: each bitmap 16-byte aligned.
size_t bitmap_words(size_t n) { return ((n + 31) / 32 + 3) & ~(size_t)3; }

}  // namespace

// Bytes of scratch that mcm_persistent needs for n columns: claim [n] (8 B
// each), visit, parent and wcur [n] (4 B each), four column bitmaps (the
// free columns, three frontiers; bitmap_words(n) words each), the flags and
// the free count (28 B) and walk [n rounded up to 16] (1 B each), each
// array 16-byte aligned. The kernel sets what it reads before it reads it.
extern "C" long long mcm_persistent_scratch_bytes(int n) {
  const size_t nn = n < 0 ? 0 : (size_t)n;
  return (long long)(align16(8 * nn) + 3 * align16(4 * nn) +
                     16 * bitmap_words(nn) + align16(4 * kCtlWords) +
                     align16(nn));
}

// Runs every MCM phase from the matching mate_row_in/mate_col_in [n + 1]
// (sentinel n) over the edges col/val, rows given by row_ptr [n + 2] of the
// lex-sorted padded edge list, and writes the final matching into
// mate_row/mate_col [n + 1] and phases, BFS layers and a word that is 1
// when a column is still free into stats [3]. scratch holds
// mcm_persistent_scratch_bytes(n) bytes, 16-byte aligned, whatever their
// contents. Launches on `stream`; returns cudaGetLastError() (or the error
// of a refused launch).
extern "C" int mcm_persistent(const int* col, const float* val,
                              const int* row_ptr, const int* mate_row_in,
                              const int* mate_col_in, int n, int* mate_row,
                              int* mate_col, long long* stats, void* scratch,
                              long long scratch_bytes, void* stream) {
  if (n < 0 || scratch_bytes < mcm_persistent_scratch_bytes(n) ||
      ((uintptr_t)scratch & 15) != 0)
    return cudaErrorInvalidValue;
  int blocks = 0;
  int err = coop::grid_blocks(mcm_kernel, kThreads, g_grid, &blocks);
  if (err) return err;
  const size_t nn = (size_t)n, words = bitmap_words(nn);
  char* at = static_cast<char*>(scratch);
  auto take = [&at](size_t bytes) {
    char* here = at;
    at += align16(bytes);
    return here;
  };
  u64* claim = reinterpret_cast<u64*>(take(8 * nn));
  int* visit = reinterpret_cast<int*>(take(4 * nn));
  int* parent = reinterpret_cast<int*>(take(4 * nn));
  int* wcur = reinterpret_cast<int*>(take(4 * nn));
  unsigned int* free_bits = reinterpret_cast<unsigned int*>(take(4 * words));
  unsigned int* front = reinterpret_cast<unsigned int*>(take(12 * words));
  int* ctl = reinterpret_cast<int*>(take(4 * kCtlWords));
  unsigned char* walk = reinterpret_cast<unsigned char*>(take(nn));
  Params p{col,    val,       row_ptr, mate_row_in, mate_col_in,
           n,      (int)words, mate_row, mate_col,  stats,
           claim,  visit,     parent,  wcur,        free_bits,
           front,  ctl,       walk,    (int)align16(nn)};
  void* args[] = {&p};
  if ((err = cudaLaunchCooperativeKernel((void*)mcm_kernel, dim3(blocks),
                                         dim3(kThreads), args, 0,
                                         (cudaStream_t)stream)))
    return err;
  return (int)cudaGetLastError();
}
