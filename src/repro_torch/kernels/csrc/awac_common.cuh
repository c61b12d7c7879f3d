// Device helpers shared by the AWAC sweep kernel (awac_sweep.cu) and the
// persistent AWAC loop kernel (awac_persistent.cu).
//
// Conventions: padded lex-sorted COO edges of B instances, row/col int32
// and val float32 [B, cap] (padding entries (n, n, 0)); CSR row_ptr int32
// [B, n + 2]; matching state mate_row/mate_col int32 and u/v float32
// [B, n + 1] with sentinel n.
//
// A column's Step-C winner is kept as one 64-bit key,
//   high word: the gain mapped to an order-preserving uint32,
//   low word:  ~row, so that on equal gains the smaller row is larger,
// and reduced with atomicMax. Key 0 marks a column without a candidate: a
// candidate gain is > min_gain >= 0, so its high word is >= 0x80000000.
#pragma once

#include <cstdint>

namespace awac {

typedef unsigned long long u64;

__device__ __forceinline__ unsigned int gain_key(float g) {
  unsigned int bits = __float_as_uint(g);
  return (bits & 0x80000000u) ? ~bits : (bits ^ 0x80000000u);
}

__device__ __forceinline__ float key_gain(unsigned int k) {
  unsigned int bits = (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
  return __uint_as_float(bits);
}

__device__ __forceinline__ u64 pack_key(float gain, int low) {
  return ((u64)gain_key(gain) << 32) | (u64)(unsigned int)(~low);
}

__device__ __forceinline__ int key_low(u64 key) {
  return ~(int)(unsigned int)(key & 0xffffffffull);
}

// Load of a value that other blocks of a persistent launch may have
// written before the last grid sync: a volatile load is neither cached in
// L1 nor merged with an earlier load of the same address by the compiler.
template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return *(const volatile T*)p;
}

// atomicMax that skips the atomic when the stored key already wins: the
// read may be stale, which only costs an extra atomic, never a wrong max.
__device__ __forceinline__ void key_max(u64* slot, u64 key) {
  if (key > ld(slot)) atomicMax(slot, key);
}

// lower_bound of q in col[lo, hi); the position if col[pos] == q, else -1.
// Runs until lo == hi, which gives the position that window_steps fixed
// rounds give whenever the value is present.
__device__ __forceinline__ long long window_find(const int* __restrict__ col,
                                                 long long lo, long long hi,
                                                 int q) {
  const long long hi0 = hi;
  while (lo < hi) {
    long long mid = lo + ((hi - lo) >> 1);
    if (col[mid] < q) lo = mid + 1; else hi = mid;
  }
  return (lo < hi0 && col[lo] == q) ? lo : -1;
}

// Steps A+B for edge e of one instance: the completion edge (m_j, m_i) of
// the 4-cycle through (i, j) = (row[e], col[e]) and the cycle's gain.
// Returns true when the edge is a candidate (found, i < n, i > m_j,
// gain > min_gain) and then sets *gain and *w2. The gain is computed as
// ((w1 + w2) - u[i]) - v[j] in float32, the reference's order.
// Pointers are offset to the instance; mr/mc/u/v may be written by other
// blocks of a persistent launch between grid syncs, so they are read
// with ld().
__device__ __forceinline__ bool sweep_edge(
    int r, int c, float w1, const int* __restrict__ colb,
    const float* __restrict__ valb, const int* __restrict__ ptrb,
    const int* mr, const int* mc, const float* u, const float* v,
    float min_gain, int n, float* gain, float* w2) {
  if (r >= n || r < 0 || c < 0) return false;  // padding edge
  const int cj = c < n ? c : n;
  const int qr = ld(mr + cj);     // m_j
  if (qr >= n || qr < 0 || r <= qr) return false;  // empty window / i <= m_j
  const int qc = ld(mc + r);      // m_i
  const long long pos = window_find(colb, ptrb[qr], ptrb[qr + 1], qc);
  if (pos < 0) return false;
  const float x = valb[pos];
  const float g = ((w1 + x) - ld(u + r)) - ld(v + cj);
  if (!(g > min_gain)) return false;
  *gain = g;
  *w2 = x;
  return true;
}

}  // namespace awac
