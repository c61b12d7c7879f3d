// Flash attention forward on the tensor cores, bf16 (K5's bf16 path).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention, kernel body _kernel) for bfloat16 inputs: blockwise
// online-softmax attention, kv head h // (H / Hkv), causal or full, a
// float32 accumulator, output in bf16. q is [B, H, S, D] and k, v are
// [B, Hkv, Sk, D], each with its own strides (the last dimension
// contiguous, the others multiples of 8 elements), so the model's
// [B, S, H, D] projections come in as they are; o is written through its
// own strides. D is 16, 32, 64 or 128. Float32 inputs stay on the CUDA-core
// kernel of flash_attention.cu.
//
// What bounds it on an H100: operations. 4 * B * H * S * Sk * D
// floating-point operations (half under the causal mask) against q, k, v
// and o moved once: at qwen2-0.5b's prefill (B 4, H 14, S 2,048, D 64) 30
// GFLOP against 29 MB, about 1,000 operations per byte, far above the
// card's balance point of about 295. Both products therefore run on the
// tensor cores (989 TFLOP/s in bf16, against 67 TFLOP/s for float32 on the
// CUDA cores, where the first version of this kernel ran).
//
// Design (Hopper):
//  - one block per (b, h, 128 q rows), 288 threads: two consumer
//    warpgroups of 64 q rows each and one producer warp. The grid's y axis
//    walks the q tiles from the last (the longest under the causal mask)
//    to the first, so the longest blocks start first;
//  - the producer's first thread loads the q tile once and the k and v
//    tiles (128 rows) into a 2-stage ring of shared memory with TMA, each
//    tile announced on an mbarrier with its byte count; the consumers free
//    a stage with an arrival on its "empty" mbarrier. The 4-D tensor maps
//    (D, rows, heads, batch) carry the strides, so no operand is copied,
//    and TMA fills rows past S or Sk, and columns past D, with zeros; rows
//    of 64 values (128 bytes) in the 128-byte swizzle that wgmma reads;
//  - S = Q K^T per warpgroup by wgmma.mma_async m64n128k16, Q and K from
//    shared memory (K-major descriptors), float32 accumulators;
//  - the scores are scaled after the product, in float32, with log2(e)
//    folded into the scale; columns past Sk and, under the causal mask,
//    past the row are set to -inf; the online softmax runs on the
//    accumulator fragment in registers: a row's max and sum over the four
//    lanes of a quad by shuffles, exp2f;
//  - P is rounded to bf16 in registers and used as the A operand of the
//    second wgmma (m64nDk16), O += P V, with V from shared memory in its
//    natural [kv, D] layout (MN-major, the transpose bit bf16 allows);
//  - under the causal mask the loop stops at the diagonal tile;
//  - D < 64 is computed as D = 64 on the zeros TMA fills in; only the
//    first D output columns are stored.
// Shared memory: q 16 or 32 KB and 2 stages of k and v, 64 or 128 KB
// (D <= 64 or D = 128), under the 227 KB a block can have.
//
// Numerics: the masked-row rule of the TPU kernel and the reference
// (m_safe = m where m > -inf, else 0; exp(-inf) = 0; the output is
// acc / max(l, 1e-30)). Departure from the TPU kernel, which formed P V in
// float32: P is rounded to bf16 before the second product (l sums the
// unrounded P), one bf16 rounding (relative 2^-9) per probability, inside
// the JAX package's own bf16 bar of 2e-2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // q rows per block
constexpr int kBK = 128;  // kv rows per tile
constexpr int kStages = 2;
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kRowBytes = 128;              // one swizzled row: 64 bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (between 64-column blocks along M or N of an MN-major
// operand; unused for K-major), stride byte offset 1024 (between groups
// of 8 rows). Tiles are 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of the registers that an
// asynchronous wgmma uses across its wait (issue and wait are separate
// instructions, and the compiler sees only the issue)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int w = 0; w < 4; ++w) asm volatile("" : "+r"(r[i][w])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d = A B^T over k16 (d's old values are not read): A [64 x 16] and
// B [128 x 16], both K-major in shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d += A B^T over k16: A [64 x 16] and
// B [128 x 16], both K-major in shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d += A B over k16: A [64 x 16] bf16 in registers (four words a thread,
// in the accumulator's layout), B [16 x 64] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B over k16: A [64 x 16] bf16 in registers (four words a thread,
// in the accumulator's layout), B [16 x 128] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// output strides in elements: batch, head, row
struct OutStrides {
  long long b, h, s;
};

// DP: the head width computed (64 for D <= 64, else 128)
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, OutStrides os, int H, int Hkv,
                 int S, int Sk, int D, int causal, float scale_log2) {
  constexpr int NB = DP / 64;  // 128-byte column blocks of a row
  constexpr uint32_t kQBytes = kBM * DP * 2;
  constexpr uint32_t kTileBytes = kBK * DP * 2;  // one k or v tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + kQBytes;                // [kStages] tiles
  const uint32_t sV = sK + kStages * kTileBytes;   // [kStages] tiles
  const uint32_t bars = sV + kStages * kTileBytes;
  const uint32_t q_full = bars;            // then per stage, 8 bytes each:
  const uint32_t k_full = bars + 8;        // k landed
  const uint32_t v_full = k_full + 8 * kStages;   // v landed
  const uint32_t empty = v_full + 8 * kStages;    // both consumed

  const int nq = (S + kBM - 1) / kBM;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kBM;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int kend = causal ? min(Sk, q0 + kBM) : Sk;
  const int ntiles = (kend + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, kQBytes);
      for (int c = 0; c < NB; ++c)
        tma_load(sQ + c * kBM * kRowBytes, &tq, q_full, 64 * c, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty + 8 * s, (t / kStages - 1) & 1);
        const uint32_t kb = sK + s * kTileBytes, vb = sV + s * kTileBytes;
        mbar_expect_tx(k_full + 8 * s, kTileBytes);
        for (int c = 0; c < NB; ++c)
          tma_load(kb + c * kBK * kRowBytes, &tk, k_full + 8 * s, 64 * c,
                   t * kBK, hk, b);
        mbar_expect_tx(v_full + 8 * s, kTileBytes);
        for (int c = 0; c < NB; ++c)
          tma_load(vb + c * kBK * kRowBytes, &tv, v_full + 8 * s, 64 * c,
                   t * kBK, hk, b);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns q rows q0 + 64 wg .. + 63; this thread
  // holds rows r and r + 8 of them and, in every 8-column chunk of an
  // accumulator, columns c and c + 1
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;
  const int c = 2 * (lane % 4);
  const float NEG = __uint_as_float(0xff800000u);  // -inf

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's columns

  const uint32_t qa = sQ + wg * 64 * kRowBytes;
  mbar_wait(q_full, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const uint32_t par = (t / kStages) & 1;
    const uint32_t kb = sK + s * kTileBytes, vb = sV + s * kTileBytes;

    // S = Q K^T; a k16 step advances 32 bytes inside the swizzled rows
    float sc[kBK / 2];
    mbar_wait(k_full + 8 * s, par);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t off = (ks % 4) * 32;
      const uint64_t da = sw128_desc(qa + (ks / 4) * kBM * kRowBytes + off, 0);
      const uint64_t db = sw128_desc(kb + (ks / 4) * kBK * kRowBytes + off, 0);
      if (ks == 0)
        wgmma_ss_n128_first(sc, da, db);
      else
        wgmma_ss_n128(sc, da, db);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // scale, mask, online softmax on the fragment
    const int k0 = t * kBK;
    const bool mask = k0 + kBK > Sk ||
                      (causal && k0 + kBK - 1 > q0 + 64 * wg);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (mask) {
        const int col = k0 + 8 * (i / 4) + c + (i & 1);
        const int row = row0 + ((i & 2) ? 8 : 0);
        if (col >= Sk || (causal && col > row)) x = NEG;
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float ms[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      ms[r] = m_new > NEG ? m_new : 0.f;
      alpha[r] = exp2f(m[r] - ms[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2f(sc[i] - ms[r]);
      l[r] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        pa[kk][w] = pack_bf16(sc[8 * kk + 2 * w], sc[8 * kk + 2 * w + 1]);

    // O += P V
    mbar_wait(v_full + 8 * s, par);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv<DP>(acc, pa[kk],
                   sw128_desc(vb + kk * 16 * kRowBytes, kBK * kRowBytes));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    fence_regs(pa);  // P stays in its registers until the product is done
    mbar_arrive(empty + 8 * s);
  }

  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float den = fmaxf(lr, 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c;
      if (col >= D) break;
      *reinterpret_cast<__nv_bfloat162*>(ob + row * os.s + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / den,
                                acc[4 * j + 2 * r + 1] / den);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is not in the runtime library: its entry point is
// looked up at run time, so the library needs no link against libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [B, heads, rows, D] bf16 tensor with strides st = (b, head, row) in
// elements, read in boxes of 64 columns x `box_rows` rows, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int B, int heads, int rows,
              int D, const long long* st, int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, OutStrides os, int B,
                   int H, int Hkv, int S, int Sk, int D, int causal,
                   float scale_log2, cudaStream_t st) {
  constexpr int bytes =
      1024 + (kBM + 2 * kStages * kBK) * DP * 2 + 8 * (1 + 3 * kStages);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const dim3 grid(B * H, (S + kBM - 1) / kBM);
  flash_fwd_tc<DP><<<grid, kThreads, bytes, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), os, H, Hkv, S, Sk, D,
      causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// o = softmax(q k^T * scale [causal mask]) v per (b, h), kv head
// h / (H / Hkv), all bfloat16. `strides` holds 12 element strides, (batch,
// head, row) of q, k, v and o in turn; the last dimension is contiguous.
// Launches on `stream`; returns the first CUDA error
// (cudaErrorInvalidValue for a shape or layout the kernel does not take).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Hkv, int S, int Sk, int D,
                                    const long long* strides, int causal,
                                    float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || Sk <= 0 ||
      (long long)B * H > 0x7fffffffLL || (S + kBM - 1) / kBM > 65535 ||
      (D != 16 && D != 32 && D != 64 && D != 128))
    return cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, H, S, D, strides, kBM) ||
      !make_map(&tk, k, B, Hkv, Sk, D, strides + 3, kBK) ||
      !make_map(&tv, v, B, Hkv, Sk, D, strides + 6, kBK))
    return cudaErrorInvalidValue;
  const OutStrides os{strides[9], strides[10], strides[11]};
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch<128>(tq, tk, tv, o, os, B, H, Hkv, S, Sk, D, causal,
                       scale_log2, st);
  return launch<64>(tq, tk, tv, o, os, B, H, Hkv, S, Sk, D, causal,
                    scale_log2, st);
}
