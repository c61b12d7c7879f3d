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
// int32, cur [G, T] float32; gain [G, T] float32 and partner [G, T] int32.
// The wrapper (ops.py) pads T to a multiple of 64 and E to a multiple of 4
// with the TPU wrapper's rules (zero affinity, expert id E_real and
// cur = +inf for a padded token, so that every gain involving one is
// exactly -inf).
//
// What bounds it on an H100: neither bytes nor operations, but launch and
// occupancy. At the router's prefill shape (G = 4, T = 2,100, E = 60) it
// reads 2 MB and forms about 17 M gains of three float additions each:
// under a microsecond of memory traffic and a few microseconds of
// arithmetic on the CUDA cores. The TPU built aff[i, e_j] as a one-hot
// product on the matrix unit; here it is a plain gather from shared memory.
//
// Design: one block per (group, tile of 64 columns), 256 threads: four
// threads per column, each walking 16 of the 64 rows of every row tile in
// increasing order. The block stages its columns' affinity rows once,
// transposed ([E][65], so that the 32 threads of a warp, which share the
// row i and so e_i, read 32 consecutive words), and then each row tile's
// affinities ([64][E]), experts and cur in shared memory. A thread keeps
// its running max and its row in registers and moves only on a strictly
// greater gain, so its row is the smallest among its maxima; the four
// partial winners of a column merge by (greater gain, else smaller row).
// That is the reference's rule (max, then the smallest row), whatever the
// order of the rows among the threads.
//
// Rounding: the gain is computed in the reference's order,
// ((a + a2) - cur_i) - cur_j, each step rounded to float32. There is no
// product, so no FMA contraction can change a bit, and the build does not
// use --use_fast_math; the kernel is bit-identical to the plain version.
// An expert id outside [0, E) gathers 0, as a one-hot row of the TPU's
// product does, so that no id can read outside the staged tiles.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 64;                  // columns per block; rows per tile
constexpr int kSlices = 4;                 // threads per column
constexpr int kThreads = kTile * kSlices;  // 256
constexpr int kRows = kTile / kSlices;     // rows of a tile per thread
constexpr int kPitch = kTile + 1;          // row pitch of the transposed tile
constexpr int kMaxE = 256;

size_t smem_bytes(int E) {
  return sizeof(float) * ((size_t)kTile * E + (size_t)E * kPitch + kTile) +
         sizeof(int) * kTile + (sizeof(float) + sizeof(int)) * kThreads;
}

__global__ void __launch_bounds__(kThreads)
    router_swap_kernel(const float* __restrict__ aff,
                       const int* __restrict__ assign,
                       const float* __restrict__ cur, int T, int E,
                       float* __restrict__ gain, int* __restrict__ partner) {
  extern __shared__ float4 smem4[];
  float* Ai = reinterpret_cast<float*>(smem4);  // [kTile][E], row tile
  float* AjT = Ai + kTile * E;                   // [E][kPitch], own columns
  float* cur_s = AjT + E * kPitch;               // [kTile]
  int* asg_s = reinterpret_cast<int*>(cur_s + kTile);  // [kTile]
  float* red_g = reinterpret_cast<float*>(asg_s + kTile);  // [kThreads]
  int* red_r = reinterpret_cast<int*>(red_g + kThreads);   // [kThreads]

  const int tid = threadIdx.x;
  const int jl = tid % kTile;  // column within the tile
  const int sl = tid / kTile;  // row slice
  const long long gT = (long long)blockIdx.y * T;
  const float* A = aff + gT * E;
  const int j0 = blockIdx.x * kTile;
  const int j = j0 + jl;

  for (int x = tid; x < kTile * E; x += kThreads) {
    const int r = x / E, c = x - r * E;
    AjT[c * kPitch + r] = A[(long long)j0 * E + x];
  }
  const int ej = assign[gT + j];
  const bool ej_ok = (unsigned)ej < (unsigned)E;
  const float cj = cur[gT + j];

  float best = -CUDART_INF_F;
  int part = -1;
  const int quads = kTile * E / 4;  // E % 4 == 0: rows are 16-byte aligned
  for (int i0 = 0; i0 < T; i0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    const float4* src = reinterpret_cast<const float4*>(A + (long long)i0 * E);
    for (int x = tid; x < quads; x += kThreads)
      reinterpret_cast<float4*>(Ai)[x] = src[x];
    if (tid < kTile) {
      asg_s[tid] = assign[gT + i0 + tid];
      cur_s[tid] = cur[gT + i0 + tid];
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = sl * kRows + rr;
      const int ei = asg_s[r];
      if (ei == ej) continue;  // same expert, or the same token
      const float a = ej_ok ? Ai[r * E + ej] : 0.f;
      const float a2 = (unsigned)ei < (unsigned)E ? AjT[ei * kPitch + jl] : 0.f;
      const float w = ((a + a2) - cur_s[r]) - cj;
      if (w > best) {
        best = w;
        part = i0 + r;
      }
    }
  }
  red_g[tid] = best;
  red_r[tid] = part;
  __syncthreads();
  if (sl == 0) {
    for (int s = 1; s < kSlices; ++s) {
      const float g2 = red_g[s * kTile + jl];
      const int r2 = red_r[s * kTile + jl];
      // both -inf means both -1: nothing moves
      if (g2 > best || (g2 == best && r2 < part)) {
        best = g2;
        part = r2;
      }
    }
    gain[gT + j] = best;
    partner[gT + j] = part;
  }
}

}  // namespace

// gain/partner of every token of G groups (see above). T must be a
// multiple of 64 and E a multiple of 4 in [4, 256]. Launches on `stream`;
// returns the first CUDA error (cudaErrorInvalidValue for a shape the
// kernel does not take).
extern "C" int router_swap(const void* aff, const void* assign,
                           const void* cur, void* gain, void* partner, int G,
                           int T, int E, void* stream) {
  if (G <= 0 || G > 65535 || T <= 0 || T % kTile || E < 4 || E % 4 ||
      E > kMaxE)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(E);
  cudaError_t err = cudaFuncSetAttribute(
      router_swap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err) return err;
  const dim3 grid(T / kTile, G);
  router_swap_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(aff), static_cast<const int*>(assign),
      static_cast<const float*>(cur), T, E, static_cast<float*>(gain),
      static_cast<int*>(partner));
  return cudaGetLastError();
}
