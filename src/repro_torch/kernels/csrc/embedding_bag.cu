// EmbeddingBag, K6: out[b] = sum_l w[b, l] * table[idx[b, l]] for every bag
// b, with index -1 (any index below 0) as padding.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/embedding_bag.py
// (embedding_bag, kernel body _kernel). idx is [B, L] int32, w [B, L]
// float32, table [V, D] float32 with D a multiple of 4; out is [B, D]
// float32. Any B, L and V are taken, with no padding. An index at or
// above V reads row V - 1: the plain version (ref.py) clips it so, as the
// JAX reference does; the TPU kernel instead gave it no row (it meets
// only the zero padding of the vocabulary tiles), a disagreement of the
// reference recorded in ROADMAP.md, Queue 3.
//
// What bounds it on an H100: bytes. A bag of L indices gathers L rows of
// D floats from anywhere in the table, so the traffic is the gathered
// rows (L2 keeps some of them when the table is small), plus idx and w
// read once and out written once; there are two float operations per
// gathered float. The TPU built a weighted multi-hot matrix per
// (bag tile, vocabulary tile) and multiplied it by the tile on the matrix
// unit, reading the whole table once per bag tile; here it is a plain
// gather-accumulate, and no TPU block is carried over.
//
// Design: a group of GS threads per bag (GS = D/4 rounded up to a power
// of two, at most 32; 256 threads a block), each thread owning float4
// columns of the bag's output. The group walks l = 0..L-1 in order, GS
// entries at a time: each lane loads one (idx, w) of the chunk, coalesced,
// and the group reads them by warp shuffles, so each entry is read once
// per group. Within a chunk the row loads of kUnroll entries are issued
// before their products, so that several gathers are in flight per
// thread. A padding entry is skipped (no load, nothing added). The sum is
// kept in float32 registers and may be contracted to FMAs, so the kernel
// is held to its plain version within 1e-5, not bit for bit; a bag of
// padding only gives exactly 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int GS>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const int* __restrict__ idx,
                         const float* __restrict__ w,
                         const float4* __restrict__ table, int B, int L,
                         int V, int D4, float4* __restrict__ out) {
  constexpr int kUnroll = GS < 8 ? GS : 8;
  const int lane = threadIdx.x % GS;
  const long long bag =
      (long long)blockIdx.x * (kThreads / GS) + threadIdx.x / GS;
  const bool live = bag < B;
  const int* ib = idx + bag * L;
  const float* wb = w + bag * L;

  for (int c0 = 0; c0 < D4; c0 += GS) {
    const int c = c0 + lane;
    const bool col = live && c < D4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int l0 = 0; l0 < L; l0 += GS) {
      // every lane of the warp takes part in the shuffles below: the loop
      // bounds are the same for every bag
      int my_i = -1;
      float my_w = 0.f;
      if (live && l0 + lane < L) {
        my_i = ib[l0 + lane];
        my_w = wb[l0 + lane];
      }
#pragma unroll
      for (int t0 = 0; t0 < GS; t0 += kUnroll) {
        float4 x[kUnroll];
        float wt[kUnroll];
#pragma unroll
        for (int t = 0; t < kUnroll; ++t) {
          const int id = __shfl_sync(0xffffffffu, my_i, t0 + t, GS);
          wt[t] = __shfl_sync(0xffffffffu, my_w, t0 + t, GS);
          x[t] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (col && id >= 0) {
            const int r = id < V ? id : V - 1;
            x[t] = __ldg(table + (long long)r * D4 + c);
          } else {
            wt[t] = 0.f;
          }
        }
#pragma unroll
        for (int t = 0; t < kUnroll; ++t) {
          acc.x = fmaf(wt[t], x[t].x, acc.x);
          acc.y = fmaf(wt[t], x[t].y, acc.y);
          acc.z = fmaf(wt[t], x[t].z, acc.z);
          acc.w = fmaf(wt[t], x[t].w, acc.w);
        }
      }
    }
    if (col) out[bag * D4 + c] = acc;
  }
}

template <int GS>
cudaError_t launch(const void* idx, const void* w, const void* table,
                   void* out, int B, int L, int V, int D4,
                   cudaStream_t stream) {
  constexpr int bags = kThreads / GS;
  const unsigned blocks = (unsigned)((B + bags - 1) / bags);
  embedding_bag_kernel<GS><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float4*>(table), B, L, V, D4,
      static_cast<float4*>(out));
  return cudaGetLastError();
}

}  // namespace

// out [B, D] for bags idx, w [B, L] over table [V, D] (see above). D must
// be a positive multiple of 4, and table and out 16-byte aligned.
// Launches on `stream`; returns the first CUDA error
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int embedding_bag(const void* idx, const void* w,
                             const void* table, void* out, int B, int L,
                             int V, int D, void* stream) {
  if (B <= 0 || L < 0 || V <= 0 || D <= 0 || D % 4) return cudaErrorInvalidValue;
  const int D4 = D / 4;
  cudaStream_t s = (cudaStream_t)stream;
  if (D4 <= 1) return launch<1>(idx, w, table, out, B, L, V, D4, s);
  if (D4 <= 2) return launch<2>(idx, w, table, out, B, L, V, D4, s);
  if (D4 <= 4) return launch<4>(idx, w, table, out, B, L, V, D4, s);
  if (D4 <= 8) return launch<8>(idx, w, table, out, B, L, V, D4, s);
  if (D4 <= 16) return launch<16>(idx, w, table, out, B, L, V, D4, s);
  return launch<32>(idx, w, table, out, B, L, V, D4, s);
}
