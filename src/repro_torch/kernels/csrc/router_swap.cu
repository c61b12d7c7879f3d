// Router swap-gain search, K4: for every token j of every group, its best
// swap partner i for the AWPM MoE router's 4-cycle phase.
//
// Replaces the TPU kernel src/repro/kernels/router_swap/router_swap.py
// (router_swap, kernel body _kernel). Per group g, with e_t the expert of
// token t and cur[t] = aff[t, e_t]:
//
//   W[i, j] = ((aff[i, e_j] + aff[j, e_i]) - cur[i]) - cur[j]
//
// masked to -inf where e_i == e_j (which covers i == j); the output is the
// column max gain[j] and the smallest row partner[j] reaching it, -1 where
// the column has no finite entry. aff is [G, T, E] float32, assign [G, T]
// int32 or int64, cur [G, T] float32, all contiguous; gain [G, T] float32
// and partner [G, T] int32. Any T >= 1 and any E in [1, 256]: rows past T
// are not read and columns past T are not stored, so the caller pads
// nothing (the TPU kernel needed T and E padded to its tiles).
//
// What bounds it on an H100: neither bytes nor operations, but latency and
// how much of the card it fills. At the router's prefill shape (G = 4,
// T = 2,100, E = 60) it reads 2 MB and forms about 17.6 M gains of three
// float additions each: under a microsecond of memory traffic and a few
// microseconds of arithmetic on the CUDA cores. The TPU built aff[i, e_j]
// as a one-hot product on the matrix unit; here it is a plain gather from
// shared memory, about 15 instructions and 3 shared-memory reads a gain.
//
// Design:
//  - a thread-block cluster of `split` blocks per (group, tile of 128
//    columns; 64 where E > 215 leaves no room for 128), the blocks walking
//    every split-th row tile of 64 rows. `split` (at most 8) is chosen at
//    launch, from cudaOccupancyMaxActiveClusters, as the largest for which
//    the whole grid is resident at once: a cluster left for a second wave
//    doubles the time (at the prefill shape 5, so 340 blocks);
//  - 256 threads, 64 to a row slice: a thread owns two columns and walks 16
//    rows of every row tile in increasing order, its columns' gains formed
//    from one 16-byte record per row (expert id, offset of the expert's row
//    in the column tile, cur). The block stages its columns' affinity rows
//    once, transposed ([E + 1][129], the last row zeros, so that the 32
//    threads of a warp, which share the row i and so e_i, read 32
//    consecutive words);
//  - the row tiles ([64][E] affinities, contiguous in memory) arrive in a
//    double buffer by one cp.async.bulk each, completing on an mbarrier,
//    the next tile in flight while the current one's gains are formed; the
//    up to 3 + 3 floats outside its 16-byte aligned span are copied by
//    threads;
//  - a thread keeps its running max and its row in registers and moves only
//    on a strictly greater gain, so its row is the smallest among its
//    maxima; a column's four slice winners merge by (greater gain, else
//    smaller row), every block writes its winners into the first block's
//    shared memory (cluster.map_shared_rank), and after one cluster.sync()
//    that block merges them by the same rule. That is the reference's rule
//    (max, then the smallest row), whatever the split of the rows, so the
//    result does not depend on it; no atomics, one launch.
//
// Rounding: the gain is computed in the reference's order,
// ((a + a2) - cur_i) - cur_j, each step rounded to float32. There is no
// product, so no FMA contraction can change a bit, and the build does not
// use --use_fast_math; the kernel is bit-identical to the plain version.
// An expert id outside [0, E) gathers 0, as a one-hot row of the TPU's
// product does, so that no id can read outside the staged tiles; ids are
// compared at their own width.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// a block covers COLS columns (128, or 64 where E is too large for the
// shared memory of 128): 256 threads, 64 to a row slice, COLS / 64 columns
// to a thread
constexpr int kTile = 64;                   // rows per row tile
constexpr int kThreads = 256;
constexpr int kLanes = 64;                  // threads sharing a row slice
constexpr int kSlices = kThreads / kLanes;  // threads per column
constexpr int kRows = kTile / kSlices;      // rows of a tile per thread
constexpr int kMaxSplit = 8;               // blocks sharing a column tile
constexpr int kMaxE = 256;
constexpr size_t kMaxSmem = 227 * 1024;  // a block's shared memory on sm_90

// what a thread needs of one row i, in 16 bytes read at once: its expert
// id (two words, at the id's own width), the offset of its expert's row in
// the transposed column tile (the zero row for an id outside [0, E)) and
// cur[i]; a row past T has cur = +inf, which makes every gain of it -inf
// or NaN, so it never wins
template <typename Idx>
__device__ __forceinline__ uint4 pack_row(Idx e, int aoff, float cur) {
  const long long e64 = (long long)e;
  return make_uint4((uint32_t)e64, (uint32_t)(e64 >> 32), (uint32_t)aoff,
                    __float_as_uint(cur));
}
template <typename Idx>
__device__ __forceinline__ Idx row_id(uint4 x) {
  if constexpr (sizeof(Idx) == 8)
    return (Idx)(((unsigned long long)x.y << 32) | x.x);
  else
    return (Idx)x.x;
}

// floats of one row-tile buffer: kTile rows and 4 of slack, so that the
// 16-byte aligned part of a tile lands 16-byte aligned (see load_rows)
__host__ __device__ constexpr int buffer_floats(int E) {
  return (kTile * E + 4 + 3) / 4 * 4;
}

// the per-slice winners (after the loop) reuse the row-tile buffers
template <int COLS>
size_t smem_bytes(int E) {
  constexpr int kCols = COLS, kPitch = COLS + 1;
  return sizeof(uint4) * 2 * kTile + 8 * 2 +
         (sizeof(float) + sizeof(int)) * kMaxSplit * kCols +
         sizeof(float) * (4 + (size_t)(E + 1) * kPitch + 3) +
         sizeof(float) * 2 * (size_t)(buffer_floats(E) > kSlices * kCols
                                          ? buffer_floats(E)
                                          : kSlices * kCols);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

template <typename Idx, int COLS>
__global__ void __launch_bounds__(kThreads)
    router_swap_kernel(const float* __restrict__ aff,
                       const Idx* __restrict__ assign,
                       const float* __restrict__ cur, int T, int E,
                       float* __restrict__ gain, int* __restrict__ partner) {
  constexpr int kCols = COLS, kCPT = COLS / kLanes, kPitch = COLS + 1;
  extern __shared__ float4 smem4[];
  uint4* info = reinterpret_cast<uint4*>(smem4);             // [2][kTile]
  auto* bar = reinterpret_cast<uint64_t*>(info + 2 * kTile);  // [2]
  float* part_g = reinterpret_cast<float*>(bar + 2);  // [split][kCols]
  int* part_r = reinterpret_cast<int*>(part_g + kMaxSplit * kCols);
  float* zero = reinterpret_cast<float*>(part_r + kMaxSplit * kCols);  // [4]
  float* AjT = zero + 4;  // [E + 1][kPitch], the last row zeros
  float* Ai = AjT + (E + 1) * kPitch;
  Ai += (4 - (smem_u32(Ai) / 4) % 4) % 4;  // [2] buffers, 16-byte aligned
  float* red_g = Ai;  // [kSlices][kCols], once the row tiles are done
  int* red_r = reinterpret_cast<int*>(red_g + kSlices * kCols);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int split = (int)cluster.num_blocks();
  // a block writes into another's shared memory only once that one has
  // started: arrive here, wait before the writes
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int tid = threadIdx.x;
  const int jl = tid % kLanes;  // columns jl + kLanes c of the block's tile
  const int sl = tid / kLanes;  // row slice
  const long long gT = (long long)blockIdx.y * T;
  const float* A = aff + gT * E;
  const Idx* asg_g = assign + gT;
  const float* cur_g = cur + gT;
  const int j0 = (blockIdx.x / split) * kCols;
  const int ntiles = (T + kTile - 1) / kTile;
  const float INF = CUDART_INF_F;
  const int BF = buffer_floats(E);
  // a row tile starts at a float offset equal to the group's offset mod 4
  // (its first row is a multiple of 64); the tile is placed that far into
  // its buffer, so that its 16-byte aligned span goes in one bulk copy
  const int shift = (int)((gT * E) % 4);

  // row i0 + tid's record, read from device memory (tid < kTile)
  auto row_info = [&](int i0) {
    const int i = i0 + tid;
    if (i >= T) return pack_row(Idx(-1), E * kPitch, INF);
    const Idx e = asg_g[i];
    return pack_row(e, e >= 0 && e < E ? (int)e * kPitch : E * kPitch,
                    cur_g[i]);
  };
  // row tile i0 into buffer b: its aligned span by one bulk copy that
  // completes on bar[b], the up to 3 + 3 floats around it by plain copies
  auto load_rows = [&](int b, int i0) {
    const int n = min(kTile, T - i0) * E;
    const float* src = A + (long long)i0 * E;
    float* dst = Ai + b * BF + shift;
    const int head = min(n, (4 - shift) % 4);
    const int mid = (n - head) / 4 * 4;
    if (tid == 0) {
      // the buffer's last reads (generic proxy) come before the copy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              smem_u32(bar + b)),
          "r"(4 * mid)
          : "memory");
      if (mid)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst + head)),
            "l"(src + head), "r"(4 * mid), "r"(smem_u32(bar + b))
            : "memory");
    }
    const int rest = n - head - mid;
    if (tid >= 32 && tid < 32 + head) dst[tid - 32] = src[tid - 32];
    if (tid >= 64 && tid < 64 + rest)
      dst[head + mid + tid - 64] = src[head + mid + tid - 64];
  };

  if (tid == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(bar + b))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the first row tile goes out before the columns are staged
  int it = rank;
  if (it < ntiles) {
    load_rows(0, it * kTile);
    if (tid < kTile) info[tid] = row_info(it * kTile);
  }
  const int cols = min(kCols, T - j0);
  for (int x = tid; x < kCols * E; x += kThreads) {
    const int r = x / E, c = x - r * E;
    AjT[c * kPitch + r] = r < cols ? A[(long long)j0 * E + x] : 0.f;
  }
  for (int x = tid; x < kPitch; x += kThreads) AjT[E * kPitch + x] = 0.f;
  if (tid == 0) zero[0] = 0.f;
  Idx ej[kCPT];
  bool ej_ok[kCPT];
  float cj[kCPT], best[kCPT];
  int astride[kCPT], part[kCPT];
#pragma unroll
  for (int c = 0; c < kCPT; ++c) {
    const int j = j0 + jl + kLanes * c;
    const bool live = j < T;
    ej[c] = live ? asg_g[j] : Idx(-1);
    ej_ok[c] = live && ej[c] >= 0 && ej[c] < E;
    cj[c] = live ? cur_g[j] : 0.f;
    // aff[i, e_j] of row r of a tile is at[r * astride], at = the tile's
    // column e_j, or the zero word (astride 0) for an id outside [0, E)
    astride[c] = ej_ok[c] ? E : 0;
    best[c] = -INF;
    part[c] = -1;
  }
  __syncthreads();

  for (int n = 0; it < ntiles; it += split, ++n) {
    const int buf = n & 1, next = it + split;
    uint4 ri;
    if (next < ntiles) {
      load_rows(buf ^ 1, next * kTile);
      if (tid < kTile) ri = row_info(next * kTile);
    }
    mbar_wait(bar + buf, (n >> 1) & 1);  // this tile's bulk copy landed
    const float* at[kCPT];
#pragma unroll
    for (int c = 0; c < kCPT; ++c)
      at[c] = ej_ok[c] ? Ai + buf * BF + shift + (int)ej[c] : zero;
    const uint4* rt = info + buf * kTile;
    const int i0 = it * kTile;
    // rows in increasing order, a strictly greater gain moves the winner
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = sl * kRows + rr;
      const uint4 x = rt[r];
      const Idx ei = row_id<Idx>(x);
      const float ci = __uint_as_float(x.w);
#pragma unroll
      for (int c = 0; c < kCPT; ++c) {
        const float a = at[c][r * astride[c]];
        const float a2 = AjT[(int)x.z + jl + kLanes * c];
        const float w = ((a + a2) - ci) - cj[c];
        // the same expert, or the same token: masked
        const bool take = ei != ej[c] && w > best[c];
        best[c] = take ? w : best[c];
        part[c] = take ? i0 + r : part[c];
      }
    }
    if (next < ntiles && tid < kTile) info[(buf ^ 1) * kTile + tid] = ri;
    __syncthreads();  // the buffer is consumed before it is refilled
  }

  // the block's winner per column, then the cluster's: every block puts
  // its winners into the first block's shared memory, which merges them
  // (both -inf means both -1: nothing moves)
#pragma unroll
  for (int c = 0; c < kCPT; ++c) {
    red_g[sl * kCols + jl + kLanes * c] = best[c];
    red_r[sl * kCols + jl + kLanes * c] = part[c];
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  __syncthreads();
  if (sl == 0) {
#pragma unroll
    for (int c = 0; c < kCPT; ++c) {
      const int jc = jl + kLanes * c;
      for (int s = 1; s < kSlices; ++s) {
        const float g2 = red_g[s * kCols + jc];
        const int r2 = red_r[s * kCols + jc];
        if (g2 > best[c] || (g2 == best[c] && r2 < part[c])) {
          best[c] = g2;
          part[c] = r2;
        }
      }
      cluster.map_shared_rank(part_g, 0)[rank * kCols + jc] = best[c];
      cluster.map_shared_rank(part_r, 0)[rank * kCols + jc] = part[c];
    }
  }
  cluster.sync();
  if (rank == 0 && sl == 0) {
#pragma unroll
    for (int c = 0; c < kCPT; ++c) {
      const int jc = jl + kLanes * c;
      for (int s = 1; s < split; ++s) {
        const float g2 = part_g[s * kCols + jc];
        const int r2 = part_r[s * kCols + jc];
        if (g2 > best[c] || (g2 == best[c] && r2 < part[c])) {
          best[c] = g2;
          part[c] = r2;
        }
      }
      if (j0 + jc < T) {
        gain[gT + j0 + jc] = best[c];
        partner[gT + j0 + jc] = part[c];
      }
    }
  }
}

// the cluster size: the most blocks per column tile (at most kMaxSplit,
// at most one per row tile) for which the whole grid is resident at once,
// so that no cluster waits for a second wave; 1 if none is
template <typename Idx, int COLS>
int choose_split(int G, int T, int E, size_t bytes) {
  constexpr int kDevices = 16;
  // clusters resident at once, per card, E and cluster size; 0: not asked
  static int max_clusters[kDevices][kMaxE + 1][kMaxSplit + 1];
  int dev = 0, uncached = 0;
  if (cudaGetDevice(&dev) || dev >= kDevices) dev = -1;
  const int ncols = (T + COLS - 1) / COLS, ntiles = (T + kTile - 1) / kTile;
  int best = 1;
  for (int s = 2; s <= kMaxSplit && s <= ntiles; ++s) {
    int& n = dev < 0 ? uncached : max_clusters[dev][E][s];
    if (dev < 0) n = 0;
    if (n == 0) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(ncols * s, G);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = bytes;
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = s;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&n, router_swap_kernel<Idx, COLS>,
                                         &cfg) ||
          n <= 0)
        n = -1;
    }
    if ((long long)ncols * G <= n) best = s;
  }
  cudaGetLastError();  // a refused query is not the launch's error
  return best;
}

template <typename Idx, int COLS>
cudaError_t launch(const void* aff, const void* assign, const void* cur,
                   void* gain, void* partner, int G, int T, int E,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<COLS>(E);
  cudaError_t err = cudaFuncSetAttribute(
      router_swap_kernel<Idx, COLS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) return err;
  const int split = choose_split<Idx, COLS>(G, T, E, bytes);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + COLS - 1) / COLS * split, G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, router_swap_kernel<Idx, COLS>,
                            static_cast<const float*>(aff),
                            static_cast<const Idx*>(assign),
                            static_cast<const float*>(cur), T, E,
                            static_cast<float*>(gain),
                            static_cast<int*>(partner));
}

}  // namespace

// gain/partner of every token of G groups (see above); `assign` is int32
// (idx64 = 0) or int64 (idx64 = 1). T >= 1, E in [1, 256]. Launches on
// `stream`; returns the first CUDA error (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int router_swap(const void* aff, const void* assign,
                           const void* cur, void* gain, void* partner, int G,
                           int T, int E, int idx64, void* stream) {
  if (G <= 0 || G > 65535 || T <= 0 || E < 1 || E > kMaxE ||
      (T + 63) / 64 > 0x7fffffff / kMaxSplit)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (smem_bytes<128>(E) <= kMaxSmem)
    return idx64 ? launch<long long, 128>(aff, assign, cur, gain, partner, G,
                                          T, E, st)
                 : launch<int, 128>(aff, assign, cur, gain, partner, G, T, E,
                                    st);
  return idx64 ? launch<long long, 64>(aff, assign, cur, gain, partner, G, T,
                                       E, st)
               : launch<int, 64>(aff, assign, cur, gain, partner, G, T, E, st);
}
