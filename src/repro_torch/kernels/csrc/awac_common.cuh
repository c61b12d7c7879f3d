// Device helpers shared by the AWAC sweep kernel (awac_sweep.cu) and the
// persistent AWAC loop kernel (awac_persistent.cu): the sweep of one chunk
// of an instance's edges (Steps A+B+C), the completion-edge lookup and the
// winner keys.
//
// Conventions: padded lex-sorted COO edges of B instances, row/col int32
// and val float32 [B, cap] (padding entries (n, n, 0), (row, col) pairs
// unique); CSR row_ptr int32 [B, n + 2]; matching state mate_row/mate_col
// int32 and u/v float32 [B, n + 1] with sentinel n. cap < 2^31, so an
// edge's position inside its instance is an int.
//
// A column's Step-C winner is kept as one 64-bit key,
//   high word: the gain mapped to an order-preserving uint32,
//   low word:  ~pos, the winning edge's position in its instance's edges,
// and reduced with atomicMax. The edges are sorted by (row, col) and the
// pairs are unique, so inside one column the position grows with the row:
// the largest key is the reference's winner (max gain, the smallest row
// on a tie), and row[pos] and val[pos] give its row and w1 without a
// search. Key 0 marks a column without a candidate: a candidate gain is >
// min_gain >= 0, so its high word is >= 0x80000000.
//
// What bounds a sweep on an H100 is the latency of each edge's chain of
// dependent loads: the stream (row, col, val), then mate_row[col] and
// mate_col[row], then row_ptr of row m_j, then row m_j's columns, then
// val, u and v. The design shortens and overlaps the chain:
//   - a thread owns K edges of a chunk (chosen per kernel) and issues each
//     level of loads for all of them before the next level, so their
//     chains overlap;
//   - a short row (at most kRow entries, chosen per kernel; 32 covers
//     nearly every row of the graphs the solver sees: 1 + Poisson(15) at
//     n = 2^20) is searched in one round trip of aligned 16-byte loads
//     instead of a binary search of 4 to 6 dependent loads;
//   - a row's record, built once from the edges, holds its CSR segment and
//     a 64-bit column signature (bit c & 63 set for each of its columns
//     c) in one 16-byte load, and the row's columns are read only when
//     the bit of m_i is set. The lookups' sectors of col, at random rows
//     of a 67 MB array at n = 2^20, are what took the sweep's time
//     (PERF.md); a row of 15 entries sets about 13 of the 64 bits,
//     so about four lookups in five stop at the record. A clear bit means
//     that (m_j, m_i) is no edge, so the filter changes no result;
//   - the stream is loaded evict-first (ld.global.cs), so the 200 MB of
//     edges that pass through L2 once per sweep do not evict the O(n)
//     state, records and keys (about 40 MB at n = 2^20) that the gathers
//     hit.
#pragma once

#include <cstdint>

namespace awac {

typedef unsigned long long u64;

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned int gain_key(float g) {
  unsigned int bits = __float_as_uint(g);
  return (bits & 0x80000000u) ? ~bits : (bits ^ 0x80000000u);
}

__device__ __forceinline__ float key_gain(u64 key) {
  const unsigned int k = (unsigned int)(key >> 32);
  unsigned int bits = (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
  return __uint_as_float(bits);
}

__device__ __forceinline__ u64 pack_key(float gain, int low) {
  return ((u64)gain_key(gain) << 32) | (u64)(unsigned int)(~low);
}

// The low word of a key: the winning edge's position (Step-C keys) or the
// winning column (Step-D keys).
__device__ __forceinline__ int key_low(u64 key) {
  return ~(int)(unsigned int)(key & 0xffffffffull);
}

// A volatile load, neither cached in L1 nor merged with an earlier load of
// the same address by the compiler: for a key that other threads may be
// raising with atomicMax in the same phase, and for the persistent
// kernel's column phases, which read once each what other blocks wrote
// in the phase before.
template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return *(const volatile T*)p;
}

// The state of an instance during a sweep. It does not change during the
// sweep, but in a persistent launch other blocks wrote it before the last
// grid sync (kLive): a plain load then, which may be cached in L1 (the
// sync's fences make other blocks' writes visible to it, and the hot
// columns of the zipf-like graphs hit there); the read-only path
// otherwise.
template <bool kLive, typename T>
__device__ __forceinline__ T ld_state(const T* p) {
  if constexpr (kLive) return *p;
  else return __ldg(p);
}

// atomicMax that skips the atomic when the stored key already wins: the
// read may be stale, which only costs an extra atomic, never a wrong max.
__device__ __forceinline__ void key_max(u64* slot, u64 key) {
  if (key > ld(slot)) atomicMax(slot, key);
}

// lower_bound of q in col[lo, hi); the position if col[pos] == q, else -1.
__device__ __forceinline__ int window_find(const int* __restrict__ col,
                                           int lo, int hi, int q) {
  const int hi0 = hi;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(col + mid) < q) lo = mid + 1; else hi = mid;
  }
  return (lo < hi0 && __ldg(col + lo) == q) ? lo : -1;
}

// Position of q among the sorted, distinct columns col[lo, hi) of one row,
// or -1: the position window_find gives. A row of at most kRow entries is
// read as the aligned 16-byte vectors that hold it, all issued before any
// is compared; the head and tail vectors may hold entries of the
// neighbouring rows, which are masked (an aligned vector that holds one
// entry of the array lies in the same page, so the load cannot fault).
// Longer rows binary-search. The vectors in flight cost kRow + 4
// registers.
template <int kRow>
__device__ __forceinline__ int find_col(const int* __restrict__ col, int lo,
                                        int hi, int q) {
  constexpr int kShortVecs = (kRow + 3 + 3) / 4;  // vectors a row spans
  const int len = hi - lo;
  if (len > kRow) return window_find(col, lo, hi, q);
  const int* first = col + lo;
  const int head = (int)(((uintptr_t)first >> 2) & 3);  // entries before lo
  const int4* vec = reinterpret_cast<const int4*>(first - head);
  const int nv = len > 0 ? (head + len + 3) >> 2 : 0;
  int4 w[kShortVecs];
#pragma unroll
  for (int t = 0; t < kShortVecs; ++t) {
    w[t] = t < nv ? __ldg(vec + t) : make_int4(-1, -1, -1, -1);
  }
  int found = -1;
#pragma unroll
  for (int t = 0; t < kShortVecs; ++t) {
    const int k = 4 * t - head;  // w[t].x's index relative to lo
    if (w[t].x == q && (unsigned)k < (unsigned)len) found = k;
    if (w[t].y == q && (unsigned)(k + 1) < (unsigned)len) found = k + 1;
    if (w[t].z == q && (unsigned)(k + 2) < (unsigned)len) found = k + 2;
    if (w[t].w == q && (unsigned)(k + 3) < (unsigned)len) found = k + 3;
  }
  return found < 0 ? -1 : lo + found;
}

// A row's record for the sweep's lookups: its CSR segment [lo, hi) and its
// column signature (bit c & 63 set for each of its columns c), as {lo, hi,
// signature low word, high word}. The row is read in aligned 16-byte
// vectors, as find_col reads it.
__device__ __forceinline__ int4 row_record(const int* __restrict__ col,
                                           int lo, int hi) {
  const int len = hi - lo;
  const int head = (int)(((uintptr_t)(col + lo) >> 2) & 3);
  const int4* vec = reinterpret_cast<const int4*>(col + lo - head);
  const int nv = len > 0 ? (head + len + 3) >> 2 : 0;
  u64 sig = 0;
#pragma unroll 4
  for (int t = 0; t < nv; ++t) {
    const int4 w = __ldg(vec + t);
    const int k = 4 * t - head;  // w.x's index relative to lo
    if ((unsigned)k < (unsigned)len) sig |= 1ull << (w.x & 63);
    if ((unsigned)(k + 1) < (unsigned)len) sig |= 1ull << (w.y & 63);
    if ((unsigned)(k + 2) < (unsigned)len) sig |= 1ull << (w.z & 63);
    if ((unsigned)(k + 3) < (unsigned)len) sig |= 1ull << (w.w & 63);
  }
  return make_int4(lo, hi, (int)(unsigned int)sig,
                   (int)(unsigned int)(sig >> 32));
}

// One instance's arrays, offset to the instance.
struct Inst {
  const int* row;    // [cap]
  const int* col;    // [cap]
  const float* val;  // [cap]
  const int* ptr;    // [n + 2]
  const int* mr;     // [n + 1]
  const int* mc;     // [n + 1]
  const float* u;    // [n + 1]
  const float* v;    // [n + 1]
  const int4* rec;   // [n] row records (row_record)
  u64* keys;         // [n]
  int cap;
  int n;
};

__device__ __forceinline__ Inst instance(const int* row, const int* col,
                                         const float* val, const int* ptr,
                                         const int* mr, const int* mc,
                                         const float* u, const float* v,
                                         const int4* rec, u64* keys, int b,
                                         int cap, int n) {
  const size_t e = (size_t)b * cap, s = (size_t)b * (n + 1);
  const size_t c = (size_t)b * n;
  return Inst{row + e, col + e, val + e, ptr + (size_t)b * (n + 2), mr + s,
              mc + s, u + s, v + s, rec + c, keys + c, cap, n};
}

// Completion weight w2 of the 4-cycle through edge (i, j): the weight of
// (m_j, m_i), or false when the cycle is not a candidate shape (padding,
// m_j unmatched, i <= m_j, no completion edge). For one edge alone: the
// sweep's winner decode, where the state is read-only.
template <int kRow>
__device__ __forceinline__ bool completion(const Inst& in, int r, int c,
                                           float* w2) {
  const int n = in.n;
  if (r >= n || r < 0 || c < 0 || c >= n) return false;
  const int qr = __ldg(in.mr + c);
  if (qr >= n || qr < 0 || r <= qr) return false;
  const int p = find_col<kRow>(in.col, __ldg(in.ptr + qr),
                               __ldg(in.ptr + qr + 1), __ldg(in.mc + r));
  if (p < 0) return false;
  *w2 = __ldg(in.val + p);
  return true;
}

// Steps A+B+C for the edges [begin, begin + K * kThreads) of one
// instance: per edge (i, j) = (row[e], col[e]) the completion edge
// (m_j, m_i), the gain ((w1 + w2) - u[i]) - v[j] in float32 (the
// reference's order), and for a candidate (found, i < n, i > m_j, gain >
// min_gain) the key (gain, ~e) into keys[j]. Thread t owns edges
// begin + t + s * kThreads, s < K; rows of up to kRow entries are
// searched in one round trip.
template <bool kLive, int K, int kRow>
__device__ __forceinline__ void sweep_chunk(const Inst& in, int begin,
                                            float min_gain) {
  const int n = in.n;
  int r[K], c[K], qr[K], qc[K], lo[K], hi[K], p[K];
  float w1[K];
  // the stream, evict-first; a slot past the end reads as padding
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int e = begin + s * kThreads + (int)threadIdx.x;
    const bool in_range = e < in.cap;
    r[s] = in_range ? __ldcs(in.row + e) : n;
    c[s] = in_range ? __ldcs(in.col + e) : n;
    w1[s] = in_range ? __ldcs(in.val + e) : 0.0f;
  }
  // m_j = mate_row[j] and m_i = mate_col[i], both levels' loads at once
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool edge = r[s] >= 0 && r[s] < n && c[s] >= 0 && c[s] < n;
    qr[s] = edge ? ld_state<kLive>(in.mr + c[s]) : n;
    qc[s] = edge ? ld_state<kLive>(in.mc + r[s]) : -1;
  }
  // row m_j's record: its segment of the edge list, left empty when the
  // shape is no candidate or the signature rules (m_j, m_i) out
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool shape = qr[s] >= 0 && qr[s] < n && r[s] > qr[s];
    const int4 rr = shape ? ld_state<kLive>(in.rec + qr[s])
                          : make_int4(0, 0, 0, 0);
    const unsigned int word = (qc[s] & 32) ? rr.w : rr.z;
    lo[s] = rr.x;
    hi[s] = rr.y;
    if (!((word >> (qc[s] & 31)) & 1)) hi[s] = lo[s] = 0;
  }
  // the completion edge (m_j, m_i)
#pragma unroll
  for (int s = 0; s < K; ++s) {
    p[s] = find_col<kRow>(in.col, lo[s], hi[s], qc[s]);
  }
  // w2, the duals, the gain; Step C
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (p[s] < 0) continue;
    const float x = __ldg(in.val + p[s]);
    const float g = ((w1[s] + x) - ld_state<kLive>(in.u + r[s])) -
                    ld_state<kLive>(in.v + c[s]);
    if (g > min_gain) {
      key_max(in.keys + c[s],
              pack_key(g, begin + s * kThreads + (int)threadIdx.x));
    }
  }
}

}  // namespace awac
