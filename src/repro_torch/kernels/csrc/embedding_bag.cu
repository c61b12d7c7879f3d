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
// What bounds it on an H100: bytes. idx and w are read once and out is
// written once; the table at most once. But a bag of L indices gathers L
// rows of D floats from anywhere in the table, and at serve_bulk (262,144
// bags of 200 over bert4rec's 256 MB table) the 47 M gathers (12.08 GB)
// fall about 47 times on each row. The L2 holds a fifth of that table, so
// a kernel that walks the bags in any order reads nearly every gathered
// row from device memory (3.7 ms, 3.3 TB/s). Gathering the same rows from
// a 32 MB window of the table takes 1.59 ms (tools/bag_l2.py, PERF.md).
// The TPU built a weighted multi-hot matrix per (bag tile, vocabulary
// tile) for its matrix unit; no TPU block is carried over.
//
// Two routes, chosen by the wrapper from (B, L, V, D) and the SM count
// (embedding_bag.py::plan_route):
//
// Route A, few bags (serve_p99, 512 x 200): fill the card. 512 bags alone
// give two warps an SM. Each bag's L entries are cut into S contiguous
// slices, one warp each, so that the grid holds at least 8 warps an SM. A
// bag's slices sit in one block and meet in shared memory, added in slice
// order.
//
// Route B, many bags (serve_bulk): make the L2 serve the reuse. One
// cooperatively launched block of 24 warps per SM keeps the float32 sums
// of up to 880 bags (D = 64) in shared memory and sweeps the table in W
// windows of a power of two of rows (32 MiB at D = 64: 8 windows), so
// that while the blocks work in window k its rows come from device memory
// about once and the other gathers hit the L2. Bags that do not fit take
// further passes (3 at serve_bulk). Before a pass, each warp sorts its
// bags' entries stably by window into a scratch of 8 bytes an entry (a
// counting sort per bag: counts in shared memory, a prefix over the
// lanes, a scatter ranked by ballots), so that each (bag, window) is one
// contiguous segment; padding is dropped and indices are clipped there.
// The blocks share no data; a counter of finished windows only keeps them
// in lockstep: a block starts window step s when the counter says that
// all have finished step s - 1, or after a bounded wait, since no result
// depends on it. Letting a block run one or two windows ahead was slower
// (two windows do not fit the L2's hot share; PERF.md, K6). With
// one window (a table that fits it), the sort is skipped and the bags'
// own entries are walked. Each warp walks its bags' segments of a window
// in turn, with the next bag's first chunk loaded before the current bag
// is walked.
//
// Both routes walk a list of entries with one warp: each lane loads one
// entry of a chunk of 32 (the idx and w stream, and the scratch, are read
// evict-first), the warp reads them by shuffles, GS lanes cover a row with
// 16-byte loads (GS = D/4 rounded up to a power of two, at most 32, with
// further column chunks when D > 128), 32 / GS rows at a time, 8 steps in
// flight. The sums are float32 in a fixed order (entries in order per
// lane, lanes combined by a fixed butterfly, slices and windows in order),
// so two calls on the same inputs give identical bits; the order differs
// from the plain version's, so the kernel is held to it within 1e-5. A bag
// of padding only gives exactly 0.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kSweepThreads = 768;   // route B: one block of 24 warps an SM
constexpr int kMaxWindows = 32;      // route B: a lane counts one window
constexpr int kSortChunks = 8;       // route B: 32-entry loads in flight
constexpr int kSliceThreads = 256;   // route A: blocks of 8 warps
constexpr int kMaxSlices = kSliceThreads / 32;  // route A: slices a bag
constexpr int kMaxSpins = 1 << 16;   // route B: polls of a window wait

__device__ __forceinline__ int ld_cs(const int* p) {
  int v;
  asm volatile("ld.global.cs.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_cs(const float* p) {
  float v;
  asm volatile("ld.global.cs.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int2 ld_cs(const int2* p) {
  int2 v;
  asm volatile("ld.global.cs.v2.s32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_cs(int2* p, int2 v) {
  asm volatile("st.global.cs.v2.s32 [%0], {%1, %2};" ::"l"(p), "r"(v.x),
               "r"(v.y));
}

// A bag's own entries: row clipped to V - 1, -1 for padding.
struct RawBag {
  const int* idx;
  const float* w;
  int V;
  __device__ __forceinline__ void get(int t, int& r, float& wt) const {
    const int i = ld_cs(idx + t);
    r = i < 0 ? -1 : (i < V ? i : V - 1);
    wt = ld_cs(w + t);
  }
};

// A segment of route B's scratch: (row, weight bits), already clipped.
struct Sorted {
  const int2* e;
  __device__ __forceinline__ void get(int t, int& r, float& wt) const {
    const int2 v = ld_cs(e + t);
    r = v.x;
    wt = __int_as_float(v.y);
  }
};

// One warp adds N steps (s0 .. s0 + N - 1) of a chunk of m <= 32 entries
// to acc, for column c of the row: lane j holds entry j (row r, -1 for
// none, and weight), and lane (sub, c) with sub = lane / GS takes entry
// s * RP + sub of step s. The N rows of a lane are loaded before they are
// added; a masked entry adds w = 0 times x = 0.
template <int GS, int N>
__device__ __forceinline__ void gather_steps(int my_r, float my_w, int m,
                                             int s0,
                                             const float4* __restrict__ tc,
                                             int D4, bool col, float4& acc) {
  constexpr int RP = kWarp / GS;  // rows a step
  const int sub = (threadIdx.x & (kWarp - 1)) / GS;
  float4 x[N];
  unsigned live = 0;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int t = (s0 + u) * RP + sub;
    const int r = __shfl_sync(kAll, my_r, t & (kWarp - 1));
    const bool ok = t < m && r >= 0 && col;
    x[u] = ok ? __ldg(tc + (long long)r * D4)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    live |= (unsigned)ok << u;
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int t = (s0 + u) * RP + sub;
    const float wt = __shfl_sync(kAll, my_w, t & (kWarp - 1));
    const float wu = (live >> u) & 1u ? wt : 0.f;
    acc.x = fmaf(wu, x[u].x, acc.x);
    acc.y = fmaf(wu, x[u].y, acc.y);
    acc.z = fmaf(wu, x[u].z, acc.z);
    acc.w = fmaf(wu, x[u].w, acc.w);
  }
}

// One chunk, N = min(U, GS) steps at a time. With kShortTail, the steps
// past the last full N go 2 at a time, so that a short chunk (a bag's
// segment of one window, in route B) loads few masked rows; without it
// (route A, whose chunks are full but the last), the loop is unrolled,
// which keeps more loads in flight. The warp's control flow is uniform.
template <int GS, int U, bool kShortTail>
__device__ __forceinline__ void gather_chunk(int my_r, float my_w, int m,
                                             const float4* __restrict__ tc,
                                             int D4, bool col, float4& acc) {
  constexpr int RP = kWarp / GS;
  constexpr int N = U < GS ? U : GS;
  constexpr int TAIL = N < 2 ? N : 2;
  const int steps = (m + RP - 1) / RP;
  if (kShortTail) {
    int s0 = 0;
    for (; s0 + N <= steps; s0 += N)
      gather_steps<GS, N>(my_r, my_w, m, s0, tc, D4, col, acc);
    for (; s0 < steps; s0 += TAIL)
      gather_steps<GS, TAIL>(my_r, my_w, m, s0, tc, D4, col, acc);
  } else {
#pragma unroll
    for (int s0 = 0; s0 < GS; s0 += N) {
      if (s0 >= steps) break;
      gather_steps<GS, N>(my_r, my_w, m, s0, tc, D4, col, acc);
    }
  }
}

// One warp adds entries [lo, hi) of `src` to acc (column c), 32 at a time;
// lane j's entry of the first chunk is given (r0, w0), so that its load
// can be issued before the walk.
template <int GS, int U, bool kShortTail, class Src>
__device__ __forceinline__ void walk(const Src& src, int lo, int hi, int r0,
                                     float w0, const float4* __restrict__ tc,
                                     int D4, bool col, float4& acc) {
  const int lane = threadIdx.x & (kWarp - 1);
  for (int t0 = lo; t0 < hi; t0 += kWarp) {
    int my_r = r0;
    float my_w = w0;
    if (t0 != lo) {
      my_r = -1;
      if (t0 + lane < hi) src.get(t0 + lane, my_r, my_w);
    }
    gather_chunk<GS, U, kShortTail>(my_r, my_w,
                                    hi - t0 < kWarp ? hi - t0 : kWarp, tc,
                        D4, col, acc);
  }
}

// Lane j's entry of the chunk at lo: (-1, 0) past hi.
template <class Src>
__device__ __forceinline__ void first_entry(const Src& src, int lo, int hi,
                                            int& r, float& wt) {
  const int t = lo + (threadIdx.x & (kWarp - 1));
  r = -1;
  wt = 0.f;
  if (t < hi) src.get(t, r, wt);
}

// The warp's RP partial sums of column c, combined by a fixed butterfly:
// every lane of the column ends with the same bits.
template <int GS>
__device__ __forceinline__ void combine_rows(float4& acc) {
#pragma unroll
  for (int off = kWarp / 2; off >= GS; off /= 2) {
    acc.x += __shfl_xor_sync(kAll, acc.x, off);
    acc.y += __shfl_xor_sync(kAll, acc.y, off);
    acc.z += __shfl_xor_sync(kAll, acc.z, off);
    acc.w += __shfl_xor_sync(kAll, acc.w, off);
  }
}

// ------------------------------- route A ----------------------------------

// Block: 8 warps, 8 / S bags; warp g takes slice g % S of bag g / S.
template <int GS>
__global__ void __launch_bounds__(kSliceThreads)
    bag_slices_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                      const float4* __restrict__ table, int B, int L, int V,
                      int D4, int S, float4* __restrict__ out) {
  __shared__ float4 part[kMaxSlices][GS];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int per_block = (blockDim.x / kWarp) / S;
  const int slice = warp % S;
  const long long bag = (long long)blockIdx.x * per_block + warp / S;
  const bool live = bag < B;
  const int len = (L + S - 1) / S;
  const int lo = min(slice * len, L);
  const int n = live ? min(lo + len, L) - lo : 0;
  const RawBag src{idx + bag * L + lo, w + bag * L + lo, V};
  int r0;
  float w0;
  first_entry(src, 0, n, r0, w0);
  for (int c0 = 0; c0 < D4; c0 += GS) {
    const int c = c0 + lane % GS;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    walk<GS, 8, false>(src, 0, n, r0, w0, table + c, D4, c < D4, acc);
    combine_rows<GS>(acc);
    if (lane < GS) part[warp][lane] = acc;
    __syncthreads();
    if (slice == 0 && live && lane < GS && c < D4) {
      float4 sum = part[warp][lane];
      for (int s = 1; s < S; ++s) {
        const float4 p = part[warp + s][lane];
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      out[bag * D4 + c] = sum;
    }
    __syncthreads();
  }
}

// ------------------------------- route B ----------------------------------

struct Sweep {
  const int* idx;
  const float* w;
  const float4* table;
  float4* out;
  int B, L, V, D4;
  int W;     // windows
  int shift;  // a window holds 1 << shift rows
  int P;     // passes
  int NB;    // bags a block holds in a pass
  unsigned* done;  // window steps finished, summed over blocks (zeroed)
  int* off;        // per block: (W + 1) * NB window offsets
  int2* ent;       // per block: NB * L entries
  unsigned long long* split;  // null, or per block: ns in each phase
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 adds the time since its last stamp to `phase`.
__device__ __forceinline__ void stamp(unsigned long long& phase,
                                      unsigned long long& last) {
  if (threadIdx.x == 0) {
    const unsigned long long t = now_ns();
    phase += t - last;
    last = t;
  }
}

// Sort the entries of this block's bags [b0, b0 + nb) by window, stably:
// bag i's non-padding entries go to its own L slots of `ent`, window by
// window in l order, and off[k * NB + i] (k = 0..W) is where window k
// starts within them. One warp a bag: it counts the bag's entries by
// window in shared memory, takes the exclusive prefix over the windows
// (lane k holds window k), then reads the entries again (from the L2) and
// writes each to its window's next slot plus its rank among the chunk's
// lanes of the same window (found from one ballot per bit of the window
// number). Holding a bag in registers between the two reads instead cost
// spills in the walk and was slower (PERF.md, K6).
__device__ void sort_bags(const Sweep& a, long long b0, int nb, int* off,
                          int2* ent) {
  __shared__ int next_s[kSweepThreads / kWarp][kMaxWindows + 1];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int nwarps = blockDim.x / kWarp;
  const int W = a.W;
  const int bits = 32 - __clz(W);  // the window numbers 0..W (W: none)
  const unsigned below = (1u << lane) - 1u;
  int* next = next_s[warp];
  for (int i = warp; i < nb; i += nwarps) {
    const int* ib = a.idx + (b0 + i) * a.L;
    const float* wb = a.w + (b0 + i) * a.L;
    if (lane <= W) next[lane] = 0;
    __syncwarp();
    for (int t0 = 0; t0 < a.L; t0 += kWarp * kSortChunks) {
      int win[kSortChunks];
#pragma unroll
      for (int j = 0; j < kSortChunks; ++j) {
        const int t = t0 + j * kWarp + lane;
        const int x = t < a.L ? ib[t] : -1;
        win[j] = x >= 0 ? (x < a.V ? x : a.V - 1) >> a.shift : W;
      }
#pragma unroll
      for (int j = 0; j < kSortChunks; ++j)
        if (win[j] < W) atomicAdd(next + win[j], 1);
    }
    __syncwarp();
    const int count = lane < W ? next[lane] : 0;
    int start = count;  // exclusive prefix over the windows (lanes)
#pragma unroll
    for (int o = 1; o < kWarp; o *= 2) {
      const int y = __shfl_up_sync(kAll, start, o);
      if (lane >= o) start += y;
    }
    const int total = __shfl_sync(kAll, start, kWarp - 1);
    start -= count;
    if (lane < W) {
      off[lane * a.NB + i] = start;
      next[lane] = start;
    }
    if (lane == 0) off[W * a.NB + i] = total;
    __syncwarp();
    int2* eb = ent + (long long)i * a.L;
    for (int t0 = 0; t0 < a.L; t0 += kWarp * kSortChunks) {
      int xs[kSortChunks];
      float ws[kSortChunks];
#pragma unroll
      for (int j = 0; j < kSortChunks; ++j) {
        const int t = t0 + j * kWarp + lane;
        xs[j] = t < a.L ? ld_cs(ib + t) : -1;
        ws[j] = t < a.L ? ld_cs(wb + t) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kSortChunks; ++j) {
        const int r = xs[j] < a.V ? xs[j] : a.V - 1;
        const int win = xs[j] >= 0 ? r >> a.shift : W;
        unsigned same = kAll;  // the lanes of this lane's window
        for (int b = 0; b < bits; ++b) {
          const unsigned set = __ballot_sync(kAll, (win >> b) & 1);
          same &= (win >> b) & 1 ? set : ~set;
        }
        const int base = win < W ? next[win] : 0;
        __syncwarp();
        const int rank = __popc(same & below);
        if (win < W) {
          st_cs(eb + base + rank, make_int2(r, __float_as_int(ws[j])));
          if ((same >> lane) == 1u) next[win] = base + rank + 1;  // the last
        }
        __syncwarp();
      }
    }
  }
}

// One window of route B in one block: warp w adds the segments of its bags
// i = w + q * nwarps to their sums in acc_s. Bag i's segment is
// [i * len + seg[i], i * len + seg[NB + i]) of `src`, or all of
// [i * len, (i + 1) * len) when seg is null. 32 bags at a time, lane q
// holds bag q's bounds, and the first chunk of the next bag's entries is
// loaded before the current bag is walked.
template <int GS, class Src>
__device__ __forceinline__ void sweep_window(const Src& src, const int* seg,
                                             int len, int nb, const Sweep& a,
                                             float4* acc_s) {
  constexpr int U = 8;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int nwarps = blockDim.x / kWarp;
  const int sub = lane / GS;
  for (int i0 = warp; i0 < nb; i0 += kWarp * nwarps) {
    const int mine = i0 + lane * nwarps;
    int seg_lo = 0, seg_hi = 0;
    if (mine < nb) {
      seg_lo = mine * len + (seg ? seg[mine] : 0);
      seg_hi = seg ? mine * len + seg[a.NB + mine] : (mine + 1) * len;
    }
    const int count = min(kWarp, (nb - i0 + nwarps - 1) / nwarps);
    int lo = __shfl_sync(kAll, seg_lo, 0), hi = __shfl_sync(kAll, seg_hi, 0);
    int r0;
    float w0;
    first_entry(src, lo, hi, r0, w0);
    for (int q = 0; q < count; ++q) {
      const int i = i0 + q * nwarps;
      int nlo = 0, nhi = 0, nr = -1;
      float nw = 0.f;
      if (q + 1 < count) {  // warp-uniform
        nlo = __shfl_sync(kAll, seg_lo, q + 1);
        nhi = __shfl_sync(kAll, seg_hi, q + 1);
        first_entry(src, nlo, nhi, nr, nw);
      }
      for (int c0 = 0; c0 < a.D4; c0 += GS) {
        const int c = c0 + lane % GS;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        if (sub == 0 && c < a.D4) acc = acc_s[i * a.D4 + c];
        walk<GS, U, true>(src, lo, hi, r0, w0, a.table + c, a.D4, c < a.D4,
                          acc);
        combine_rows<GS>(acc);
        if (sub == 0 && c < a.D4) acc_s[i * a.D4 + c] = acc;
      }
      lo = nlo;
      hi = nhi;
      r0 = nr;
      w0 = nw;
    }
  }
}

template <int GS>
__global__ void __launch_bounds__(kSweepThreads, 1)
    bag_sweep_kernel(const Sweep a) {
  extern __shared__ float4 acc_s[];  // [NB][D4]
  const int G = gridDim.x;
  int* off = a.off + (long long)blockIdx.x * a.NB * (a.W + 1);
  int2* ent = a.ent + (long long)blockIdx.x * a.NB * a.L;
  // thread 0's split: sort (and clearing the sums), wait, walk, write
  unsigned long long t_sort = 0, t_wait = 0, t_walk = 0, t_out = 0;
  unsigned long long last = threadIdx.x == 0 ? now_ns() : 0;
  for (int p = 0; p < a.P; ++p) {
    const long long b0 = ((long long)p * G + blockIdx.x) * a.NB;
    const int nb = (int)max(0LL, min((long long)a.NB, (long long)a.B - b0));
    if (a.W > 1) sort_bags(a, b0, nb, off, ent);
    for (int j = threadIdx.x; j < a.NB * a.D4; j += blockDim.x)
      acc_s[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    stamp(t_sort, last);
    for (int k = 0; k < a.W; ++k) {
      // start window step s once every block has finished s - 1; the wait
      // is bounded, as no result depends on it
      const long long need = (long long)G * (p * a.W + k);
      if (threadIdx.x == 0) {
        for (int spin = 0; spin < kMaxSpins &&
                           (long long)*(volatile unsigned*)a.done < need;
             ++spin)
          __nanosleep(64);
      }
      __syncthreads();
      stamp(t_wait, last);
      if (a.W > 1) {
        sweep_window<GS>(Sorted{ent}, off + k * a.NB, a.L, nb, a, acc_s);
      } else {
        sweep_window<GS>(RawBag{a.idx + b0 * a.L, a.w + b0 * a.L, a.V},
                         nullptr, a.L, nb, a, acc_s);
      }
      __syncthreads();
      stamp(t_walk, last);
      if (threadIdx.x == 0) atomicAdd(a.done, 1u);
    }
    float4* ob = a.out + b0 * a.D4;
    for (int j = threadIdx.x; j < nb * a.D4; j += blockDim.x) ob[j] = acc_s[j];
    __syncthreads();
    stamp(t_out, last);
  }
  if (a.split && threadIdx.x == 0) {
    unsigned long long* o = a.split + 4 * blockIdx.x;
    o[0] = t_sort;
    o[1] = t_wait;
    o[2] = t_walk;
    o[3] = t_out;
  }
}

template <int GS>
cudaError_t launch_slices(const void* idx, const void* w, const void* table,
                          void* out, int B, int L, int V, int D4, int S,
                          cudaStream_t stream) {
  const int per_block = kMaxSlices / S;
  const unsigned blocks = (unsigned)((B + per_block - 1) / per_block);
  bag_slices_kernel<GS><<<blocks, kSliceThreads, 0, stream>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float4*>(table), B, L, V, D4, S,
      static_cast<float4*>(out));
  return cudaGetLastError();
}

template <int GS>
cudaError_t launch_sweep(Sweep a, int blocks, int smem, cudaStream_t stream) {
  cudaError_t err;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)))
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
    return err;
  const void* fn = (const void*)bag_sweep_kernel<GS>;
  if ((err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kSweepThreads, smem)))
    return err;
  // the blocks wait on each other: every one must be resident
  if (!coop || blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(a.done, 0, sizeof(unsigned), stream))) return err;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kSweepThreads),
                                     args, (size_t)smem, stream);
}

}  // namespace

// out [B, D] for bags idx, w [B, L] over table [V, D] (see above). D must
// be a positive multiple of 4, and table and out 16-byte aligned. `route`
// is 0 (A: `slices` warps a bag, a power of two up to 8) or 1 (B:
// `windows` windows of `window_rows` rows, `passes` passes of
// `bags_per_block` bags over `blocks` blocks), with `scratch` of
// embedding_bag.py's BagPlan.scratch_bytes (16-byte aligned). `split`, if
// not null, takes route B's nanoseconds per block in its sort, wait, walk
// and write phases ([blocks][4] uint64). Launches on `stream`; returns the
// first CUDA error (cudaErrorInvalidValue for a shape or plan the kernels
// do not take).
extern "C" int embedding_bag(const void* idx, const void* w,
                             const void* table, void* out, int B, int L,
                             int V, int D, int route, int slices, int windows,
                             int window_rows, int passes, int bags_per_block,
                             int blocks, int smem, void* scratch,
                             void* split, void* stream) {
  if (B <= 0 || L < 0 || V <= 0 || D <= 0 || D % 4) return cudaErrorInvalidValue;
  const int D4 = D / 4;
  const int GS = D4 <= 1 ? 1 : D4 <= 2 ? 2 : D4 <= 4 ? 4 : D4 <= 8 ? 8
                 : D4 <= 16 ? 16 : 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 0) {
    if (slices < 1 || slices > kMaxSlices || (slices & (slices - 1)))
      return cudaErrorInvalidValue;
    switch (GS) {
      case 1: return launch_slices<1>(idx, w, table, out, B, L, V, D4, slices, s);
      case 2: return launch_slices<2>(idx, w, table, out, B, L, V, D4, slices, s);
      case 4: return launch_slices<4>(idx, w, table, out, B, L, V, D4, slices, s);
      case 8: return launch_slices<8>(idx, w, table, out, B, L, V, D4, slices, s);
      case 16: return launch_slices<16>(idx, w, table, out, B, L, V, D4, slices, s);
      default: return launch_slices<32>(idx, w, table, out, B, L, V, D4, slices, s);
    }
  }
  if (route != 1 || windows < 1 || windows > kMaxWindows || window_rows < 1 ||
      (window_rows & (window_rows - 1)) ||
      (long long)windows * window_rows < V || passes < 1 ||
      bags_per_block < 1 || blocks < 1 ||
      (long long)passes * blocks * bags_per_block < B || !scratch)
    return cudaErrorInvalidValue;
  char* sc = static_cast<char*>(scratch);
  const long long off_ints = (long long)blocks * bags_per_block * (windows + 1);
  Sweep a;
  a.idx = static_cast<const int*>(idx);
  a.w = static_cast<const float*>(w);
  a.table = static_cast<const float4*>(table);
  a.out = static_cast<float4*>(out);
  a.B = B; a.L = L; a.V = V; a.D4 = D4;
  a.W = windows; a.P = passes; a.NB = bags_per_block;
  for (a.shift = 0; (1 << a.shift) < window_rows; ++a.shift) {
  }
  a.done = reinterpret_cast<unsigned*>(sc);
  a.off = reinterpret_cast<int*>(sc + 16);
  a.ent = reinterpret_cast<int2*>(sc + 16 + ((off_ints * 4 + 15) / 16) * 16);
  a.split = static_cast<unsigned long long*>(split);
  switch (GS) {
    case 1: return launch_sweep<1>(a, blocks, smem, s);
    case 2: return launch_sweep<2>(a, blocks, smem, s);
    case 4: return launch_sweep<4>(a, blocks, smem, s);
    case 8: return launch_sweep<8>(a, blocks, smem, s);
    case 16: return launch_sweep<16>(a, blocks, smem, s);
    default: return launch_sweep<32>(a, blocks, smem, s);
  }
}
